"""Device compute: intersection, shading helpers, the persistent render."""
