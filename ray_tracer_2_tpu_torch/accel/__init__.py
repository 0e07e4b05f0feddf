"""Host-side acceleration structures: SAH BVH, wide rows, attribute rows."""
