"""Procedural atrium in sponza's model units: a frozen copy of
``ray_tracer_2_tpu_torch/assets/sponza_builder.py`` (itself a statement for
statement copy of ``ray_tracer_2_tpu/assets/sponza_builder.py``), kept here
so that the benchmark's scene does not move when the program's builder does.

``sponza.obj`` (about 262k triangles) is not in the repository. At
``detail=10`` this builds 268,224 triangles in ten parts named after
sponza.mtl's materials, the real model's scale; every quad is emitted with
both windings, since the renderer culls the back faces of non-glass
triangles.
"""
from __future__ import annotations

import math

import numpy as np


class _SoupBuilder:
    def __init__(self):
        self.parts: dict[str, list] = {}

    def add(self, material: str, v0, v1, v2, n, uv0, uv1, uv2):
        self.parts.setdefault(material, []).append(
            (np.asarray(v0, np.float32), np.asarray(v1, np.float32),
             np.asarray(v2, np.float32), np.asarray(n, np.float32),
             np.asarray(uv0, np.float32), np.asarray(uv1, np.float32),
             np.asarray(uv2, np.float32)))

    def quad_grid(self, material: str, origin, edge_u, edge_v, nu: int,
                  nv: int, uv_scale=(1.0, 1.0), flip=False):
        """Tessellated parallelogram: origin + s*edge_u + t*edge_v.

        Emitted TWO-SIDED (both windings, each with its own facing normal):
        the path tracer backface-culls non-glass triangles like the
        reference (ray_tracer.wgsl:268), and an architectural substitute is
        far more robust with visible interiors from every side. ``flip``
        kept for signature compatibility (a two-sided quad ignores it).
        """
        del flip
        origin = np.asarray(origin, np.float64)
        eu = np.asarray(edge_u, np.float64)
        ev = np.asarray(edge_v, np.float64)
        n = np.cross(eu, ev)
        n = n / np.linalg.norm(n)
        for i in range(nu):
            for j in range(nv):
                s0, s1 = i / nu, (i + 1) / nu
                t0, t1 = j / nv, (j + 1) / nv
                p00 = origin + s0 * eu + t0 * ev
                p10 = origin + s1 * eu + t0 * ev
                p11 = origin + s1 * eu + t1 * ev
                p01 = origin + s0 * eu + t1 * ev
                u00 = (s0 * uv_scale[0], t0 * uv_scale[1])
                u10 = (s1 * uv_scale[0], t0 * uv_scale[1])
                u11 = (s1 * uv_scale[0], t1 * uv_scale[1])
                u01 = (s0 * uv_scale[0], t1 * uv_scale[1])
                # side A: winding (p00,p11,p01) has geometric normal
                # +cross(eu,ev) under the kernel convention
                self.add(material, p00, p11, p01, n, u00, u11, u01)
                self.add(material, p00, p10, p11, n, u00, u10, u11)
                # side B: reversed winding, normal -n
                self.add(material, p00, p01, p11, -n, u00, u01, u11)
                self.add(material, p00, p11, p10, -n, u00, u11, u10)

    def box(self, material: str, centre, size, nu=2, nv=2, uv_scale=(1, 1)):
        cx, cy, cz = np.asarray(centre, np.float64)
        sx, sy, sz = np.asarray(size, np.float64) / 2
        # 6 faces, outward normals
        self.quad_grid(material, (cx - sx, cy - sy, cz + sz), (2 * sx, 0, 0),
                       (0, 2 * sy, 0), nu, nv, uv_scale)            # +z
        self.quad_grid(material, (cx + sx, cy - sy, cz - sz), (-2 * sx, 0, 0),
                       (0, 2 * sy, 0), nu, nv, uv_scale)            # -z
        self.quad_grid(material, (cx - sx, cy - sy, cz - sz), (0, 0, 2 * sz),
                       (0, 2 * sy, 0), nu, nv, uv_scale)            # -x
        self.quad_grid(material, (cx + sx, cy - sy, cz + sz), (0, 0, -2 * sz),
                       (0, 2 * sy, 0), nu, nv, uv_scale)            # +x
        self.quad_grid(material, (cx - sx, cy + sy, cz - sz), (2 * sx, 0, 0),
                       (0, 0, 2 * sz), nu, nv, uv_scale)            # +y
        self.quad_grid(material, (cx - sx, cy - sy, cz + sz), (2 * sx, 0, 0),
                       (0, 0, -2 * sz), nu, nv, uv_scale)           # -y

    def cylinder(self, material: str, base, radius: float, height: float,
                 sides: int = 12, vsegs: int = 6, uv_scale=(2.0, 1.0)):
        bx, by, bz = np.asarray(base, np.float64)
        for k in range(sides):
            a0 = 2 * math.pi * k / sides
            a1 = 2 * math.pi * (k + 1) / sides
            for s in range(vsegs):
                y0 = by + height * s / vsegs
                y1 = by + height * (s + 1) / vsegs
                p00 = (bx + radius * math.cos(a0), y0, bz + radius * math.sin(a0))
                p10 = (bx + radius * math.cos(a1), y0, bz + radius * math.sin(a1))
                p11 = (bx + radius * math.cos(a1), y1, bz + radius * math.sin(a1))
                p01 = (bx + radius * math.cos(a0), y1, bz + radius * math.sin(a0))
                n0 = (math.cos(a0), 0, math.sin(a0))
                n1 = (math.cos(a1), 0, math.sin(a1))
                u0, u1 = k / sides * uv_scale[0], (k + 1) / sides * uv_scale[0]
                t0 = (y0 - by) / height * uv_scale[1]
                t1 = (y1 - by) / height * uv_scale[1]
                # outward winding (CCW seen from outside)
                self.add(material, p00, p01, p11, n0, (u0, t0), (u0, t1), (u1, t1))
                self.add(material, p00, p11, p10, n0, (u0, t0), (u1, t1), (u1, t0))

    def to_meshes(self):
        """→ list of (material_name, positions, normals, uvs) triangle soups."""
        out = []
        for mat, tris in self.parts.items():
            pos = np.empty((len(tris) * 3, 3), np.float32)
            nrm = np.empty((len(tris) * 3, 3), np.float32)
            uv = np.empty((len(tris) * 3, 2), np.float32)
            for t, (v0, v1, v2, n, u0, u1, u2) in enumerate(tris):
                pos[3 * t:3 * t + 3] = (v0, v1, v2)
                nrm[3 * t:3 * t + 3] = (n, n, n)
                uv[3 * t:3 * t + 3] = (u0, u1, u2)
            out.append((mat, pos, nrm, uv))
        return out


def build_atrium(detail: int = 3):
    """Build the atrium soup. ``detail`` scales tessellation (3 ⇒ 41,424
    tris). Returns list of (material_name, positions, normals, uvs)."""
    b = _SoupBuilder()
    d = detail
    # footprint (model units; ×0.05 world scale)
    X, Z, H = 800.0, 400.0, 320.0        # half-extents X/Z, total height
    FLOOR_T = 4

    # floor + upper walkway slabs
    b.quad_grid("floor", (-X, 0, -Z), (2 * X, 0, 0), (0, 0, 2 * Z),
                8 * d, 4 * d, uv_scale=(8, 4))
    # outer walls (bricks), inward normals
    b.quad_grid("bricks", (-X, 0, -Z), (2 * X, 0, 0), (0, H, 0), 8 * d, 3 * d,
                uv_scale=(10, 2))
    b.quad_grid("bricks", (-X, 0, Z), (2 * X, 0, 0), (0, H, 0), 8 * d, 3 * d,
                uv_scale=(10, 2), flip=True)
    b.quad_grid("bricks", (-X, 0, -Z), (0, 0, 2 * Z), (0, H, 0), 4 * d, 3 * d,
                uv_scale=(5, 2), flip=True)
    b.quad_grid("bricks", (X, 0, -Z), (0, 0, 2 * Z), (0, H, 0), 4 * d, 3 * d,
                uv_scale=(5, 2))

    # ceiling ring at y=H with open skylight in the center
    cw = 0.55  # covered fraction per side
    b.quad_grid("ceiling", (-X, H, -Z), (2 * X, 0, 0), (0, 0, Z * cw),
                8 * d, 2 * d, uv_scale=(8, 2), flip=True)
    b.quad_grid("ceiling", (-X, H, Z - Z * cw), (2 * X, 0, 0), (0, 0, Z * cw),
                8 * d, 2 * d, uv_scale=(8, 2), flip=True)

    # two-story colonnade along both long sides
    zs = (-Z * 0.55, Z * 0.55)
    n_cols = 8
    lvl_h = H / 2 - 20
    for zi, zc in enumerate(zs):
        for i in range(n_cols):
            xc = -X + (i + 0.5) * (2 * X / n_cols)
            for lvl, mat in ((0, "column_a"), (1, "column_b")):
                y0 = lvl * (H / 2) + FLOOR_T
                b.cylinder(mat, (xc, y0 + 18, zc), 16, lvl_h - 36,
                           sides=10 * d // 2 + 8, vsegs=3 * d)
                b.box("details", (xc, y0 + 9, zc), (44, 18, 44), 2, 2)
                b.box("details", (xc, y0 + lvl_h - 9, zc), (44, 18, 44), 2, 2)
            # arches (lintels) between columns at each level
            if i < n_cols - 1:
                xn = -X + (i + 1.0) * (2 * X / n_cols)
                for lvl in (0, 1):
                    y_l = (lvl + 1) * (H / 2) - 24
                    b.box("arch", ((xc + xn) / 2, y_l, zc),
                          (2 * X / n_cols, 28, 36), 3 * d, 2)

        # walkway slab over the ground-floor colonnade
        slab_z0 = zc - 60 if zi == 0 else zc - 60
        b.quad_grid("ceiling", (-X, H / 2, slab_z0), (2 * X, 0, 0),
                    (0, 0, 120), 8 * d, 2 * d, uv_scale=(8, 1), flip=True)
        b.quad_grid("floor", (-X, H / 2 + FLOOR_T, slab_z0), (2 * X, 0, 0),
                    (0, 0, 120), 8 * d, 2 * d, uv_scale=(8, 1))

    # lion plaques on the end walls
    b.quad_grid("Material__25", (-X + 1, H * 0.45, -60), (0, 0, 120),
                (0, 120, 0), 2 * d, 2 * d)
    b.quad_grid("Material__25", (X - 1, H * 0.45, 60), (0, 0, -120),
                (0, 120, 0), 2 * d, 2 * d)

    # hanging fabric banners from the upper level
    for i in range(3):
        xc = -X / 2 + i * (X / 2)
        for zc, flip in ((-Z * 0.35, False), (Z * 0.35, True)):
            b.quad_grid("fabric_a", (xc - 40, H * 0.72, zc), (80, 0, 0),
                        (0, -90, 12 if not flip else -12), 2 * d, 3 * d)

    # roof slopes above the walls
    b.quad_grid("roof", (-X, H, -Z - 30), (2 * X, 0, 0), (0, 60, Z * 0.4),
                8 * d, 2 * d, uv_scale=(8, 2))
    b.quad_grid("roof", (-X, H, Z + 30), (2 * X, 0, 0), (0, 60, -Z * 0.4),
                8 * d, 2 * d, uv_scale=(8, 2), flip=True)

    return b.to_meshes()
