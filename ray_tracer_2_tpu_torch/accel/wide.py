"""COMPACT 32-ary (wide) BVH rows — one CANONICAL table, contiguous children.

The triangle-row and sphere-row packers of
``ray_tracer_2_tpu/accel/wide.py``, copied so the port never imports the JAX
package (its scalar test traversal is not copied: the port's tests walk the
rows with the plain megakernel). ``tests/test_torch_scene.py`` and
``tests/test_torch_sphere_bvh.py`` pin that both packages pack
byte-identical rows. The reference module's
docstring explains the layout and why it was chosen; in short:

  wide row  (COL_COUNT == 0)
    12      base: first child row id (children CONTIGUOUS)
    13      k: child count (<= 32)
    16..112 children AABBs: col 16 + 32*axis + c packs child c's min[axis]
            (low 16 bits) and max[axis] (high 16 bits) as f16, rounded
            outward; empty slots hold inverted boxes, excluded by c < k
  leaf row  (COL_COUNT > 0)
    0..8    matcull[j] = tri_mat * 2 + cull
    15/16   COL_COUNT / COL_FIRST
    17..113 12 components x 8 triangles, blocked:
            v0x*8 v0y*8 v0z*8 e1x*8 e1y*8 e1z*8 e2x*8 e2y*8 e2z*8 nx*8 ny*8 nz*8
  sphere leaf row  (COL_COUNT > 0, below the sphere BVH's root)
    0..8    the spheres' original ids as floats (exact below 2^24)
    15/16   COL_COUNT / COL_FIRST
    17..49  4 components x 8 spheres, blocked: cx*8 cy*8 cz*8 r2*8; an
            empty slot carries r2 = -1, so its discriminant
            b^2 - 4a(|oc|^2 + 1) is negative and it never hits
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ray_tracer_2_tpu_torch.accel.bvh import BVH
from ray_tracer_2_tpu_torch.accel.packed import (  # noqa: F401
    COL_COUNT, COL_FIRST, ROW_TRIS,
)

ROW_WIDTH = 128
COL_BASE = 12
COL_K = 13
COL_CHILD_AABB = 16   # wide rows only: 96 f32 cols of packed f16 pairs
N_AABB_COLS = 96
MAX_ARITY = 32

# leaf rows: component-blocked geometry with f32-precomputed edges and
# geometric normal (layout in the module docstring)
COL_MATCULL = 0
COL_LEAF_GEO = 17
N_LEAF_GEO_COLS = 96

# sphere leaf rows (layout in the module docstring)
COL_SPH_ID = 0
SPH_CHUNK = 8


_F16_MIN_NORMAL = np.float16(2.0 ** -14)


def _round_out_f16(lo: np.ndarray, hi: np.ndarray):
    """Conservative outward rounding of box bounds to f16: lo rounds toward
    -inf, hi toward +inf, so boxes only grow (pruning stays exact).

    Denormal f16 results are pushed outward to the nearest of {0, ±2^-14}:
    the kernel's integer unpack multiplies a reconstructed f32 denormal by
    2^112, and a denormal-flushing device would snap that toward zero — which
    for a NEGATIVE min (or positive max) would SHRINK the box. Clamping at
    pack time keeps every stored bound exactly representable post-unpack."""
    lo16 = lo.astype(np.float16)
    over = lo16.astype(np.float32) > lo
    lo16 = np.where(over, np.nextafter(lo16, np.float16(-np.inf)), lo16)
    den = (lo16 != 0) & (np.abs(lo16) < _F16_MIN_NORMAL)
    lo16 = np.where(den, np.where(lo16 > 0, np.float16(0), -_F16_MIN_NORMAL),
                    lo16)
    hi16 = hi.astype(np.float16)
    under = hi16.astype(np.float32) < hi
    hi16 = np.where(under, np.nextafter(hi16, np.float16(np.inf)), hi16)
    den = (hi16 != 0) & (np.abs(hi16) < _F16_MIN_NORMAL)
    hi16 = np.where(den, np.where(hi16 > 0, _F16_MIN_NORMAL, np.float16(0)),
                    hi16)
    return lo16.astype(np.float16), hi16.astype(np.float16)


def _pack_f16_pairs(vals: np.ndarray) -> np.ndarray:
    """(..., 2n) f16 -> (..., n) f32 with even indices in the LOW 16 bits
    (matches jax.lax.bitcast_convert_type(f32 -> f16)[..., 0])."""
    u16 = np.ascontiguousarray(vals).view(np.uint16)
    lo = u16[..., 0::2].astype(np.uint32)
    hi = u16[..., 1::2].astype(np.uint32) << 16
    return (lo | hi).view(np.float32)


@dataclasses.dataclass
class WideBVH:
    """Collapse result: wide nodes referencing binary node ids."""

    children: list          # wide id -> list of binary node ids
    wide_of: dict           # binary internal node id -> wide id
    root_is_leaf: bool
    depth: int              # max wide-tree depth (stack bound)


def collapse(bvh: BVH, arity: int = MAX_ARITY) -> WideBVH:
    """Collapse the binary BVH into <=arity-ary wide nodes by repeatedly
    expanding the frontier's largest-subtree internal node."""
    left, right = bvh.node_left, bvh.node_right
    count = bvh.node_count
    n = bvh.n_nodes
    if n == 0 or count[0] > 0:
        return WideBVH([], {}, True, 1)

    tris = np.zeros(n, np.int64)
    stack = [(0, False)]
    while stack:
        nd, done = stack.pop()
        if done:
            tris[nd] = (count[nd] if count[nd]
                        else tris[left[nd]] + tris[right[nd]])
            continue
        stack.append((nd, True))
        if count[nd] == 0:
            stack.append((int(left[nd]), False))
            stack.append((int(right[nd]), False))

    children: list[list[int]] = []
    wide_of: dict[int, int] = {}
    depth = 1
    pending = [(0, 1)]
    while pending:
        root, d = pending.pop()
        depth = max(depth, d)
        frontier = [int(left[root]), int(right[root])]
        while len(frontier) < arity:
            internals = [c for c in frontier if count[c] == 0]
            if not internals:
                break
            big = max(internals, key=lambda c: tris[c])
            frontier.remove(big)
            frontier += [int(left[big]), int(right[big])]
        wid = len(children)
        children.append(frontier)
        wide_of[root] = wid
        for c in frontier:
            if count[c] == 0:
                pending.append((c, d + 1))
    return WideBVH(children, wide_of, False, depth)


def pack_wide_rows(bvh: BVH, v0, v1, v2, tri_mat, tri_cull,
                   row_offset: int, tri_offset: int):
    """Build the CANONICAL (R, 128) wide row table for one group BVH.

    One table; the kernel enters the minimum-distance hit child per ray
    and resumes the remaining hit children positionally.

    v0/v1/v2/tri_mat/tri_cull are LEAF-ORDERED triangle arrays (permuted by
    bvh.tri_order). Returns (rows (R, 128) f32, n_rows, wide_depth)."""
    count = bvh.node_count

    # ---- leaf row payloads, one per binary leaf: blocked geometry with
    # precomputed f32 edges + geometric normal (see layout above) --------
    def leaf_row(nd: int) -> np.ndarray:
        r = np.zeros(ROW_WIDTH, np.float32)
        first, k = int(bvh.node_first[nd]), int(count[nd])
        r[COL_COUNT] = k
        r[COL_FIRST] = first + tri_offset
        n_tris = len(v0)
        for j in range(ROW_TRIS):
            tri = min(first + j, max(n_tris - 1, 0))
            valid = j < k
            r[COL_MATCULL + j] = ((tri_mat[tri] * 2 + tri_cull[tri])
                                  if valid else 1.0)
            if valid:
                a = np.asarray(v0[tri], np.float32)
                e1 = (np.asarray(v1[tri], np.float32) - a).astype(np.float32)
                e2 = (np.asarray(v2[tri], np.float32) - a).astype(np.float32)
                # same component expressions as jnp.cross in f32
                n = np.array([e1[1] * e2[2] - e1[2] * e2[1],
                              e1[2] * e2[0] - e1[0] * e2[2],
                              e1[0] * e2[1] - e1[1] * e2[0]], np.float32)
                comps = np.concatenate([a, e1, e2, n])
                for ci in range(12):
                    r[COL_LEAF_GEO + 8 * ci + j] = comps[ci]
            # invalid slots: zero geometry -> n = 0 -> det = 0 -> the
            # keep-gate rejects them (matcull odd => cull => det >= 1e-8)
        return r

    return _pack_rows(bvh, leaf_row, row_offset)


def _pack_rows(bvh: BVH, leaf_row, row_offset: int):
    """Shared internal-row packer: collapse the binary BVH and lay out wide
    rows (BFS, children contiguous) calling ``leaf_row(node)`` for leaf
    payloads. Returns (rows, n_rows, depth)."""
    wb = collapse(bvh)
    count = bvh.node_count

    if wb.root_is_leaf:
        rows = np.zeros((1, ROW_WIDTH), np.float32)
        rows[0] = leaf_row(0)
        return rows, 1, 1

    n_rows = 1 + sum(len(c) for c in wb.children)
    rows = np.zeros((n_rows, ROW_WIDTH), np.float32)

    # BFS numbering: children of each wide node contiguous
    next_id = 1
    queue = [(wb.wide_of[0], 0)]  # (wide id, its row id)
    while queue:
        wid, rid = queue.pop(0)
        kids = wb.children[wid]
        base = next_id
        next_id += len(kids)
        r = rows[rid]
        r[COL_BASE] = base
        r[COL_K] = len(kids)
        r[COL_COUNT] = 0.0
        aab = np.empty((MAX_ARITY, 6), np.float32)
        # empty slots: inverted boxes never hit
        aab[:, 0:3] = np.inf
        aab[:, 3:6] = -np.inf
        for slot, c in enumerate(kids):
            aab[slot, 0:3] = bvh.node_min[c]
            aab[slot, 3:6] = bvh.node_max[c]
            crow = base + slot
            if count[c] > 0:
                rows[crow] = leaf_row(c)
            else:
                queue.append((wb.wide_of[c], crow))
        lo16, hi16 = _round_out_f16(aab[:, 0:3], aab[:, 3:6])
        # col 32*axis + c = (min[axis] of child c in low half, max in high)
        inter = np.empty((N_AABB_COLS, 2), np.float16)
        inter[:, 0] = lo16.T.reshape(-1)   # blocked: x*32 | y*32 | z*32
        inter[:, 1] = hi16.T.reshape(-1)
        r[COL_CHILD_AABB:COL_CHILD_AABB + N_AABB_COLS] = \
            _pack_f16_pairs(inter.reshape(-1))

    # globalize base ids
    rows[:, COL_BASE] += np.where(rows[:, COL_COUNT] == 0.0, row_offset, 0.0)
    return rows, n_rows, wb.depth


def pack_sphere_wide_rows(bvh: BVH, pos, radius, row_offset: int):
    """Wide-row table of a sphere BVH, in world space (reference
    ``pack_sphere_wide_rows``). ``pos``/``radius`` are LEAF-ORDERED (permuted
    by bvh.tri_order); columns 0..8 of a leaf carry the ORIGINAL sphere ids,
    so the traversal can fetch centre, radius and material of its winner
    from the dense tables. Returns (rows (R, 128) f32, n_rows,
    wide_depth)."""
    orig_ids = np.asarray(bvh.tri_order, np.float32)  # leaf slot -> id
    n = len(pos)

    def leaf_row(nd: int) -> np.ndarray:
        r = np.zeros(ROW_WIDTH, np.float32)
        first, k = int(bvh.node_first[nd]), int(bvh.node_count[nd])
        r[COL_COUNT] = k
        r[COL_FIRST] = first
        for j in range(SPH_CHUNK):
            s = min(first + j, max(n - 1, 0))
            valid = j < k
            r[COL_SPH_ID + j] = orig_ids[s] if valid else 0.0
            c = np.asarray(pos[s], np.float32)
            rad = np.float32(radius[s])
            r[COL_LEAF_GEO + j] = c[0]
            r[COL_LEAF_GEO + 8 + j] = c[1]
            r[COL_LEAF_GEO + 16 + j] = c[2]
            # r2 with the float32 multiply of the dense test; an empty slot
            # gets -1 and can never reach disc >= 0
            r[COL_LEAF_GEO + 24 + j] = (rad * rad) if valid else -1.0
        return r

    return _pack_rows(bvh, leaf_row, row_offset)
