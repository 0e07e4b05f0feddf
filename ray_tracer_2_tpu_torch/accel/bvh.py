"""SAH BVH builder (ref: src/core/bvh.rs).

The high-quality build of ``ray_tracer_2_tpu/accel/bvh.py`` (numpy only),
copied so the port never imports the JAX package;
``tests/test_torch_scene.py`` pins that both build byte-identical tables.

Binary tree, root at node 0, internal nodes store ``left``/``right`` child
indices, leaves store a ``[first, first+count)`` triangle range, split
accepted when ``SAH cost < half_area(parent) * count`` (bvh.rs:68-74,
352-370), max SAH depth 32 (bvh.rs:141). The splitter is a vectorized
binned SAH instead of the reference's per-triangle sweep of <= 50 planes per
axis (bvh.rs:323-347). Leaves are force-split down to ``max_leaf``
triangles so a leaf is one fixed-width chunk of the traversal's leaf test.

Meshes of 4096 triangles or more go to the C++ builder (accel/native), as
in the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np

MAX_DEPTH = 32          # bvh.rs:141
N_BINS = 32             # binned-SAH resolution (ref uses <=50 swept planes)
NATIVE_MIN_TRIS = 4096  # meshes at least this big use the C++ builder
_QUALITY_HIGH = 2       # the C++ builder's code for binned SAH


@dataclasses.dataclass
class BVH:
    """Flat SoA node arrays + the triangle permutation that sorts the caller's
    triangle soup into leaf order."""

    node_min: np.ndarray    # (N, 3) float32
    node_max: np.ndarray    # (N, 3) float32
    node_left: np.ndarray   # (N,) int32 — child index (local), internal only
    node_right: np.ndarray  # (N,) int32
    node_first: np.ndarray  # (N,) int32 — first triangle (local), leaf only
    node_count: np.ndarray  # (N,) int32 — 0 ⇒ internal
    node_axis: np.ndarray   # (N,) int32 — split axis (internal), 0 for leaves
    tri_order: np.ndarray   # (T,) int64 permutation of input triangles

    @property
    def n_nodes(self) -> int:
        return len(self.node_count)


def build_bvh(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
              max_leaf: int) -> BVH:
    """Build over a triangle soup given as three (T, 3) vertex arrays."""
    n = len(v0)
    if n >= NATIVE_MIN_TRIS:
        from ray_tracer_2_tpu_torch.accel import native
        arrs = native.build_native(v0, v1, v2, max_leaf, _QUALITY_HIGH)
        if arrs is not None:
            return BVH(**arrs)
    if n == 0:
        z3 = np.zeros((1, 3), np.float32)
        zi = np.zeros(1, np.int32)
        return BVH(z3, z3, zi, zi.copy(), zi.copy(), zi.copy(), zi.copy(),
                   np.zeros(0, np.int64))

    tri_min = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
    tri_max = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)
    centroid = ((v0 + v1 + v2) * (1.0 / 3.0)).astype(np.float32)
    return build_bvh_bounds(tri_min, tri_max, centroid, max_leaf)


def build_bvh_bounds(tri_min: np.ndarray, tri_max: np.ndarray,
                     centroid: np.ndarray, max_leaf: int) -> BVH:
    """Build over the boxes and centroids of any primitives (reference
    ``build_bvh_bounds``): the sphere BVH is built from the spheres' boxes
    with the triangle machinery. ``tri_order`` is the permutation of the
    primitives into leaf order."""
    n = len(tri_min)
    if n == 0:
        z3 = np.zeros((1, 3), np.float32)
        zi = np.zeros(1, np.int32)
        return BVH(z3, z3, zi, zi.copy(), zi.copy(), zi.copy(), zi.copy(),
                   np.zeros(0, np.int64))
    order = np.arange(n, dtype=np.int64)

    node_min: list = [tri_min.min(axis=0)]
    node_max: list = [tri_max.max(axis=0)]
    node_left = [0]
    node_right = [0]
    node_first = [0]
    node_count = [n]
    node_axis = [0]

    # Explicit stack of (node_idx, start, count, depth). Leaves are ALWAYS
    # forced down to <= max_leaf (the traversal's fixed chunk width).
    stack = [(0, 0, n, 0)]
    hard_depth = 2 * MAX_DEPTH  # forced median splits may exceed SAH depth
    while stack:
        node_idx, start, count, depth = stack.pop()
        sel = order[start:start + count]
        bb_min, bb_max = node_min[node_idx], node_max[node_idx]
        parent_cost = _half_area(bb_min, bb_max) * count

        # Leaves are exactly one traversal chunk: splitting below max_leaf
        # buys nothing (the leaf test covers the chunk regardless).
        if count <= max_leaf:
            continue

        split = None
        if depth < MAX_DEPTH:
            split = _best_binned_split(centroid[sel], tri_min[sel],
                                       tri_max[sel])

        must_split = depth < hard_depth
        good_split = (split is not None and split[0] < parent_cost
                      and split[1].any() and not split[1].all())
        if good_split or must_split:
            if good_split:
                _, mask, axis, lmin, lmax, rmin, rmax = split
            else:
                # Median index split: always valid, keeps the tree balanced.
                mask = np.zeros(count, bool)
                mask[:count // 2] = True
                axis = int(np.argmax(bb_max - bb_min))
                lmin = tri_min[sel[mask]].min(axis=0)
                lmax = tri_max[sel[mask]].max(axis=0)
                rmin = tri_min[sel[~mask]].min(axis=0)
                rmax = tri_max[sel[~mask]].max(axis=0)
            # Partition the permutation in place (bvh.rs:400-411).
            order[start:start + count] = np.concatenate([sel[mask],
                                                         sel[~mask]])
            left_count = int(mask.sum())

            left_idx = len(node_count)
            right_idx = left_idx + 1
            node_min.extend([lmin, rmin])
            node_max.extend([lmax, rmax])
            node_left.extend([0, 0])
            node_right.extend([0, 0])
            node_first.extend([start, start + left_count])
            node_count.extend([left_count, count - left_count])
            node_axis.extend([0, 0])
            node_left[node_idx] = left_idx
            node_right[node_idx] = right_idx
            node_count[node_idx] = 0
            node_axis[node_idx] = axis
            stack.append((left_idx, start, left_count, depth + 1))
            stack.append((right_idx, start + left_count, count - left_count,
                          depth + 1))

    return BVH(
        node_min=np.asarray(node_min, np.float32),
        node_max=np.asarray(node_max, np.float32),
        node_left=np.asarray(node_left, np.int32),
        node_right=np.asarray(node_right, np.int32),
        node_first=np.asarray(node_first, np.int32),
        node_count=np.asarray(node_count, np.int32),
        node_axis=np.asarray(node_axis, np.int32),
        tri_order=order,
    )


def _half_area(bmin, bmax) -> float:
    e = np.maximum(bmax - bmin, 0.0)
    return float(e[0] * e[1] + e[1] * e[2] + e[0] * e[2])


def _half_area_vec(bmin, bmax):
    e = np.maximum(bmax - bmin, 0.0)
    return e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2] + e[..., 0] * e[..., 2]


def _best_binned_split(c, tmin, tmax):
    """Binned SAH over all 3 axes at once. Returns
    (cost, left_mask, axis, lmin, lmax, rmin, rmax) or None."""
    # Bin by centroid over the *centroid* extent of each axis.
    c_lo = c.min(axis=0)
    c_hi = c.max(axis=0)
    extent = c_hi - c_lo
    best = None
    for axis in range(3):
        if extent[axis] <= 0.0:
            continue
        scale = N_BINS / extent[axis]
        bins = np.clip(((c[:, axis] - c_lo[axis]) * scale).astype(np.int32),
                       0, N_BINS - 1)
        # Per-bin counts and bounds.
        counts = np.bincount(bins, minlength=N_BINS)
        bmin = np.full((N_BINS, 3), np.inf, np.float32)
        bmax = np.full((N_BINS, 3), -np.inf, np.float32)
        np.minimum.at(bmin, bins, tmin)
        np.maximum.at(bmax, bins, tmax)
        # Prefix/suffix sweeps.
        lcnt = np.cumsum(counts)[:-1]
        rcnt = counts.sum() - lcnt
        lmin = np.minimum.accumulate(bmin, axis=0)[:-1]
        lmax = np.maximum.accumulate(bmax, axis=0)[:-1]
        rmin = np.minimum.accumulate(bmin[::-1], axis=0)[::-1][1:]
        rmax = np.maximum.accumulate(bmax[::-1], axis=0)[::-1][1:]
        cost = lcnt * _half_area_vec(lmin, lmax) \
            + rcnt * _half_area_vec(rmin, rmax)
        cost = np.where((lcnt == 0) | (rcnt == 0), np.inf, cost)
        k = int(np.argmin(cost))
        if not np.isfinite(cost[k]):
            continue
        if best is None or cost[k] < best[0]:
            mask = bins <= k
            best = (float(cost[k]), mask, axis, lmin[k].copy(),
                    lmax[k].copy(), rmin[k].copy(), rmax[k].copy())
    return best
