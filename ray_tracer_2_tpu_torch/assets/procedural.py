"""Procedural substitutes for asset files the repository lacks (a copy of
``ray_tracer_2_tpu/assets/procedural.py``, which is pure numpy, kept
statement for statement so both build the same meshes and materials).

``Dragon_80K.obj``, ``sponza.obj`` and ``f1/f1.obj`` are not in the
repository. The asset manager builds a substitute for each when the file is
in no search directory (``SYNTHESIZERS``):

  * ``Dragon_80K.obj`` — built from the present ``dragon.obj`` (8,712 faces)
    by flat midpoint subdivision to exactly ~80k triangles. Midpoint
    subdivision leaves the *surface geometry identical* — only the triangle
    count (and hence BVH size/traversal load) changes, which is precisely
    what the Dragon_80K benchmark stresses. Without ``dragon.obj`` it raises
    ``AssetNotFound``, as the reference's does.
  * ``sponza.obj`` — the colonnaded atrium of ``assets/sponza_builder.py``
    (41,424 triangles in 10 parts), with the materials of ``sponza.mtl``
    where that file is found, else ``MaterialRecord()`` for every part.
  * ``f1/f1.obj`` — a stylized open-wheel car, 4,124 flat-shaded triangles
    in 5 parts.
"""
from __future__ import annotations

import numpy as np

DRAGON_TARGET_TRIS = 80_000


def subdivide_soup(v: np.ndarray, n: np.ndarray, uv: np.ndarray,
                   mask: np.ndarray):
    """Split masked triangles 1→4 at edge midpoints.

    v/n: (T, 3, 3); uv: (T, 3, 2); mask: (T,) bool. Normals/uvs are averaged
    at midpoints (normals re-normalized).
    """
    keep_v, keep_n, keep_uv = v[~mask], n[~mask], uv[~mask]
    sv, sn, suv = v[mask], n[mask], uv[mask]

    def mid(a, b):
        return 0.5 * (a + b)

    m01v, m12v, m20v = mid(sv[:, 0], sv[:, 1]), mid(sv[:, 1], sv[:, 2]), mid(sv[:, 2], sv[:, 0])
    m01n, m12n, m20n = mid(sn[:, 0], sn[:, 1]), mid(sn[:, 1], sn[:, 2]), mid(sn[:, 2], sn[:, 0])
    m01u, m12u, m20u = mid(suv[:, 0], suv[:, 1]), mid(suv[:, 1], suv[:, 2]), mid(suv[:, 2], suv[:, 0])

    def renorm(x):
        l = np.linalg.norm(x, axis=-1, keepdims=True)
        return x / np.where(l > 0, l, 1.0)

    m01n, m12n, m20n = renorm(m01n), renorm(m12n), renorm(m20n)

    def tri(a, b, c):
        return np.stack([a, b, c], axis=1)

    new_v = np.concatenate([
        keep_v,
        tri(sv[:, 0], m01v, m20v), tri(m01v, sv[:, 1], m12v),
        tri(m20v, m12v, sv[:, 2]), tri(m01v, m12v, m20v),
    ], axis=0)
    new_n = np.concatenate([
        keep_n,
        tri(sn[:, 0], m01n, m20n), tri(m01n, sn[:, 1], m12n),
        tri(m20n, m12n, sn[:, 2]), tri(m01n, m12n, m20n),
    ], axis=0)
    new_uv = np.concatenate([
        keep_uv,
        tri(suv[:, 0], m01u, m20u), tri(m01u, suv[:, 1], m12u),
        tri(m20u, m12u, suv[:, 2]), tri(m01u, m12u, m20u),
    ], axis=0)
    return new_v, new_n, new_uv


def densify_to(v, n, uv, target_tris: int):
    """Subdivide (largest-area first) until the soup has ~``target_tris``
    triangles (within +2: each split adds exactly 3)."""
    while len(v) < target_tris:
        deficit = target_tris - len(v)
        want_splits = max(deficit // 3, 1)
        area = 0.5 * np.linalg.norm(
            np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]), axis=-1)
        if want_splits >= len(v):
            mask = np.ones(len(v), bool)
        else:
            thresh = np.partition(area, len(v) - want_splits)[len(v) - want_splits]
            mask = area >= thresh
            # ties could over-select; trim to the exact count
            extra = int(mask.sum()) - want_splits
            if extra > 0:
                idx = np.flatnonzero(mask & (area == thresh))[:extra]
                mask[idx] = False
        v, n, uv = subdivide_soup(v, n, uv, mask)
    return v, n, uv


def synthesize_dragon_80k(assets) -> list:
    """Load dragon.obj and densify to DRAGON_TARGET_TRIS triangles.
    Returns the (MeshData, MaterialRecord, label) list shape of
    AssetManager.load_model."""
    from ray_tracer_2_tpu_torch.scene.definition import MeshData
    from ray_tracer_2_tpu_torch.scene.material import MaterialRecord

    parts = assets.load_model("dragon.obj", use_mtl=False)
    mesh, _, label = parts[0]
    t = mesh.triangle_count()
    idx = mesh.indices.reshape(-1, 3)
    v = mesh.positions[idx]
    n = mesh.normals[idx]
    uv = mesh.uvs[idx]
    v, n, uv = densify_to(v, n, uv, DRAGON_TARGET_TRIS)
    data = MeshData.from_vertices(v.reshape(-1, 3), n.reshape(-1, 3),
                                  uv.reshape(-1, 2))
    return [(data, MaterialRecord(), f"{label}_80k")]


def synthesize_sponza(assets) -> list:
    """Procedural colonnaded atrium with the sponza.mtl materials and
    textures where that file is found (assets/sponza_builder.py) — a
    41,424-triangle multi-material substitute for the absent sponza.obj."""
    from ray_tracer_2_tpu_torch.assets.manager import material_from_mtl
    from ray_tracer_2_tpu_torch.assets.obj import load_mtl
    from ray_tracer_2_tpu_torch.assets.sponza_builder import build_atrium
    from ray_tracer_2_tpu_torch.scene.definition import MeshData
    from ray_tracer_2_tpu_torch.scene.material import MaterialRecord

    try:
        mtl = load_mtl(assets.resolve("sponza.mtl"))
    except Exception:
        mtl = {}

    parts = []
    for mat_name, pos, nrm, uv in build_atrium():
        m = mtl.get(mat_name)
        if m is not None:
            diffuse_index = -1
            if m.map_kd:
                try:
                    diffuse_index = assets.load_texture(m.map_kd)
                except FileNotFoundError:
                    diffuse_index = -1
            rec = material_from_mtl(m, diffuse_index, -1)
        else:
            rec = MaterialRecord()
        parts.append((MeshData.from_vertices(pos, nrm, uv), rec,
                      f"sponza_{mat_name}"))
    return parts


def _soup_part(tris, color, label, smoothness=0.2, specular=0.0,
               specular_color=(0.0, 0.0, 0.0, 0.0)):
    from ray_tracer_2_tpu_torch.scene.definition import MeshData
    from ray_tracer_2_tpu_torch.scene.material import MaterialRecord

    v = np.asarray(tris, np.float32).reshape(-1, 3)
    # flat shading: per-face normals replicated to vertices
    f = v.reshape(-1, 3, 3)
    n = np.cross(f[:, 1] - f[:, 0], f[:, 2] - f[:, 0])
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
    n = np.repeat(n, 3, axis=0).astype(np.float32)
    rec = MaterialRecord(color=tuple(color), smoothness=smoothness,
                         specular=specular,
                         specular_color=tuple(specular_color))
    return (MeshData.from_vertices(v, n), rec, label)


def _ellipsoid_tris(center, radii, lat=14, lon=22):
    cx, cy, cz = center
    rx, ry, rz = radii
    th = np.linspace(0.0, np.pi, lat + 1)
    ph = np.linspace(0.0, 2 * np.pi, lon + 1)
    T, P = np.meshgrid(th, ph, indexing="ij")
    x = cx + rx * np.sin(T) * np.cos(P)
    y = cy + ry * np.cos(T)
    z = cz + rz * np.sin(T) * np.sin(P)
    pts = np.stack([x, y, z], axis=-1)
    out = []
    for i in range(lat):
        for j in range(lon):
            a, b = pts[i, j], pts[i + 1, j]
            c, d = pts[i + 1, j + 1], pts[i, j + 1]
            out += [[a, b, c], [a, c, d]]
    return out


def _box_tris(center, size):
    cx, cy, cz = center
    sx, sy, sz = (s / 2 for s in size)
    v = np.array([[cx - sx, cy - sy, cz - sz], [cx + sx, cy - sy, cz - sz],
                  [cx + sx, cy + sy, cz - sz], [cx - sx, cy + sy, cz - sz],
                  [cx - sx, cy - sy, cz + sz], [cx + sx, cy - sy, cz + sz],
                  [cx + sx, cy + sy, cz + sz], [cx - sx, cy + sy, cz + sz]],
                 np.float32)
    quads = [(0, 1, 2, 3), (5, 4, 7, 6), (4, 0, 3, 7),
             (1, 5, 6, 2), (3, 2, 6, 7), (4, 5, 1, 0)]
    out = []
    for a, b, c, d in quads:
        out += [[v[a], v[b], v[c]], [v[a], v[c], v[d]]]
    return out


def synthesize_f1(assets) -> list:
    """Stylized open-wheel car substitute for the absent ``f1/f1.obj``
    (scene.rs:934-983 bugatti scene; .MISSING_LARGE_BLOBS). Scaled to the
    real asset's ballpark extents so the scene's 0.05 transform + camera
    framing produce a sensible render: body ~90 units long on +x, wheels
    on z, sitting on y=0. 4,124 flat-shaded triangles across 5 materials
    (body / wheels / wings / cockpit / floor) — enough structure to
    exercise the multi-part OBJ path (per-part materials, BVH over a
    genuine asymmetric mesh) without pretending to be the real car."""
    body_col = (0.82, 0.06, 0.06, 1.0)
    wheel_col = (0.05, 0.05, 0.05, 1.0)
    wing_col = (0.15, 0.15, 0.18, 1.0)
    cockpit_col = (0.2, 0.2, 0.22, 1.0)
    parts = []
    body = []
    # fuselage: tapered chain of ellipsoids nose -> tail (x axis)
    for cx, r in ((8.0, (10.0, 4.0, 4.5)), (24.0, (14.0, 5.5, 6.0)),
                  (46.0, (16.0, 6.5, 7.5)), (68.0, (12.0, 6.0, 7.0))):
        body += _ellipsoid_tris((cx, 8.0, 0.0), r)
    parts.append(_soup_part(body, body_col, "f1_body", smoothness=0.85,
                            specular=0.25,
                            specular_color=(1.0, 1.0, 1.0, 1.0)))
    wheels = []
    for wx in (14.0, 66.0):
        for wz in (-11.0, 11.0):
            wheels += _ellipsoid_tris((wx, 6.5, wz), (6.5, 6.5, 3.2),
                                      lat=10, lon=16)
    parts.append(_soup_part(wheels, wheel_col, "f1_wheels"))
    wings = (_box_tris((0.0, 4.0, 0.0), (8.0, 1.2, 30.0))
             + _box_tris((82.0, 14.0, 0.0), (7.0, 1.2, 26.0))
             + _box_tris((82.0, 9.0, -12.0), (7.0, 9.0, 1.2))
             + _box_tris((82.0, 9.0, 12.0), (7.0, 9.0, 1.2)))
    parts.append(_soup_part(wings, wing_col, "f1_wings", smoothness=0.6))
    parts.append(_soup_part(_ellipsoid_tris((40.0, 14.0, 0.0),
                                            (7.0, 4.5, 4.0), lat=10, lon=16),
                            cockpit_col, "f1_cockpit", smoothness=0.5))
    parts.append(_soup_part(_box_tris((42.0, 2.0, 0.0), (70.0, 1.5, 22.0)),
                            (0.1, 0.1, 0.1, 1.0), "f1_floor"))
    # The real asset's model-space framing is unknowable (blob absent);
    # place the substitute so the scene's faithful camera (origin, +z,
    # scene.rs:934-983) sees the car side-on at world z ~ 7 after the 0.05
    # scene scale: centre the body and push it down +z in model units.
    offset = np.array([-42.0, -4.0, 70.0], np.float32)
    out = []
    for mesh, rec, label in parts:
        mesh.positions[:] = mesh.positions + offset
        out.append((mesh, rec, label))
    return out


#: rel_path -> synthesizer(assets) -> list[(MeshData, MaterialRecord, label)]
SYNTHESIZERS = {
    "Dragon_80K.obj": synthesize_dragon_80k,
    "sponza.obj": synthesize_sponza,
    "f1/f1.obj": synthesize_f1,
}
