"""Per-triangle shading attributes and the shared leaf-row columns (the
parts of ``ray_tracer_2_tpu/accel/packed.py`` the main path reads, copied so
the port never imports the JAX package; the octant-packed binary rows wait
for the debug slice).
"""
from __future__ import annotations

import numpy as np

ROW_WIDTH = 128
#: leaf slots per row; must equal scene.LEAF_CHUNK
ROW_TRIS = 8
#: leaf-row columns shared with the wide rows (accel/wide.py)
COL_COUNT = 15
COL_FIRST = 16


def pack_tri_attributes(n0, n1, n2, uv0, uv1, uv2,
                        v0=None, v1=None, v2=None) -> np.ndarray:
    """(T, 20) shading-attribute rows: normals (0:9), uvs (9:15), tangent
    (15:18) + bitangent handedness (18) — one gather resolves the winning
    triangle's attributes after traversal.

    The tangent frame feeds normal-map shading — the reference stubbed this
    out (ray_tracer.wgsl:440-447); here it is implemented behind
    RenderParams.normal_maps."""
    t = len(n0)
    attr = np.zeros((t, 20), np.float32)
    attr[:, 0:3] = n0
    attr[:, 3:6] = n1
    attr[:, 6:9] = n2
    attr[:, 9:11] = uv0
    attr[:, 11:13] = uv1
    attr[:, 13:15] = uv2
    if v0 is not None and t:
        e1 = (v1 - v0).astype(np.float64)
        e2 = (v2 - v0).astype(np.float64)
        d1 = (uv1 - uv0).astype(np.float64)
        d2 = (uv2 - uv0).astype(np.float64)
        r = d1[:, 0] * d2[:, 1] - d2[:, 0] * d1[:, 1]
        safe = np.where(np.abs(r) > 1e-12, r, 1.0)[:, None]
        tan = (e1 * d2[:, 1:2] - e2 * d1[:, 1:2]) / safe
        # degenerate UVs: any unit tangent orthogonal-ish to the normal works
        bad = (np.abs(r) <= 1e-12) | (np.linalg.norm(tan, axis=1) < 1e-12)
        gn = np.cross(e1, e2)
        alt = np.cross(gn, np.where(np.abs(gn[:, 0:1]) < 0.9,
                                    [[1.0, 0, 0]], [[0, 1.0, 0]]))
        tan = np.where(bad[:, None], alt, tan)
        ln = np.linalg.norm(tan, axis=1, keepdims=True)
        tan = tan / np.where(ln > 0, ln, 1.0)
        bit = (e2 * d1[:, 0:1] - e1 * d2[:, 0:1]) / safe
        hand = np.sign(np.sum(np.cross(gn, tan) * bit, axis=1))
        attr[:, 15:18] = tan.astype(np.float32)
        attr[:, 18] = np.where(hand == 0, 1.0, hand).astype(np.float32)
    return attr


def pack_attr_quads(attr: np.ndarray) -> np.ndarray:
    """(T, 20) attribute rows -> (ceil(T/4), 128) quad-packed rows: triangle
    t lives in row t//4, cols 32*(t%4) .. 32*(t%4)+20; padding cols are
    zero."""
    t = attr.shape[0]
    t4 = (t + 3) // 4
    out = np.zeros((t4 * 4, 32), np.float32)
    out[:t, :attr.shape[1]] = attr
    return out.reshape(t4, 128)
