"""TorchScene — the port's device scene, and scene instantiation (port of
``ray_tracer_2_tpu/scene/render_scene.py``).

The JAX package ships one immutable SoA pytree (``RenderScene``) to the
device once per scene. ``TorchScene`` holds the fields of it that the main
path reads, as tensors on one device, plus the static integers that shape
the traversal. The host tables are built by copies of the reference's
numpy builders (``accel/``: SAH BVH, 32-ary wide rows with f16 child boxes,
quad-packed triangle attributes), so a port scene and a reference scene of
the same definition are byte-identical (``tests/test_torch_scene.py``).

Scope of the ported slices: mesh instance groups from data or from OBJ
files (several, one per transform, sharing tables as the reference does;
files resolved by the asset manager, ``assets/manager.py``, or built by its
procedural substitutes), spheres (dense, and from ``SPHERE_BVH_MIN`` of
them or on request also as a world-space sphere BVH appended to the wide
rows), the static light table of next-event estimation (``lights``), the
texel atlas of the textures the scene's materials name (``tex_quads``, the
reference's ``tex_texels`` one texel a row; ``tex_meta``), no live edits (``HostScene``). The per-triangle model-space
tables (``tri_v0`` ... ``tri_mat``, in BVH leaf order with ``LEAF_CHUNK``
zero rows at the end) are what the small-scene path bakes to world space
(``kernels/spheres.py:pack_tables``).
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ray_tracer_2_tpu_torch.accel.bvh import build_bvh, build_bvh_bounds
from ray_tracer_2_tpu_torch.accel.packed import (
    ROW_TRIS, pack_attr_quads, pack_tri_attributes,
)
from ray_tracer_2_tpu_torch.accel.wide import (
    SPH_CHUNK, pack_sphere_wide_rows, pack_wide_rows,
)
from ray_tracer_2_tpu_torch.assets.textures import (
    TextureAtlas, downsample_images_to_budget, pack_texels_u8_quads,
)
from ray_tracer_2_tpu_torch.kernels.texture import (
    quads_from_rows, rows_from_quads,
)
from ray_tracer_2_tpu_torch.scene.definition import (
    MeshFromFile, SceneDefinition, SphereDef,
)
from ray_tracer_2_tpu_torch.scene.material import MaterialFlag, MaterialRecord

#: leaf triangle chunk width (== accel/packed.py ROW_TRIS)
LEAF_CHUNK = ROW_TRIS

#: sphere count from which a scene carries a sphere BVH, traversed instead
#: of the dense prepass (ray_tracer_2_tpu/scene/render_scene.py
#: SPHERE_BVH_MIN)
SPHERE_BVH_MIN = 2048

#: the RenderScene fields a TorchScene carries (``tex_texels`` in its
#: ``tex_quads`` layout)
FIELDS = ("sphere_pos", "sphere_radius", "sphere_mat",
          "inst_world_to_model", "inst_model_to_world",
          "wide_rows", "tri_attr", "mat_rows",
          "cam_to_world", "view_params", "defocus_strength",
          "diverge_strength",
          "tri_v0", "tri_v1", "tri_v2", "tri_n0", "tri_n1", "tri_n2",
          "tri_mat", "tex_texels", "tex_meta")
#: its tensor fields
TENSORS = tuple("tex_quads" if f == "tex_texels" else f for f in FIELDS)
#: the static (host) fields
STATICS = ("inst_spans", "wide_roots", "wide_depth", "shade_classes",
           "inst_mat_deltas", "sphere_bvh_root", "lights")

#: a scene with more emissive primitives than this gets an empty light
#: table, so next-event estimation is off for it (reference
#: ``MAX_NEE_LIGHTS``): never a truncated table that loses energy
MAX_NEE_LIGHTS = 64


@dataclasses.dataclass(frozen=True)
class TorchScene:
    sphere_pos: torch.Tensor           # (S, 3) f32
    sphere_radius: torch.Tensor        # (S,) f32
    sphere_mat: torch.Tensor           # (S,) i32
    inst_world_to_model: torch.Tensor  # (I, 4, 4) f32
    inst_model_to_world: torch.Tensor  # (I, 4, 4) f32
    wide_rows: torch.Tensor            # (R, 128) f32 — accel/wide.py rows
    tri_attr: torch.Tensor             # (ceil(T/4), 128) f32 attr quads
    mat_rows: torch.Tensor             # (K, 32) f32 packed materials
    cam_to_world: torch.Tensor         # (4, 4) f32
    view_params: torch.Tensor          # (3,) f32 plane w, plane h, focus
    defocus_strength: torch.Tensor     # () f32
    diverge_strength: torch.Tensor     # () f32
    tri_v0: torch.Tensor               # (T + LEAF_CHUNK, 3) f32, model space
    tri_v1: torch.Tensor
    tri_v2: torch.Tensor
    tri_n0: torch.Tensor               # per-corner normals, model space
    tri_n1: torch.Tensor
    tri_n2: torch.Tensor
    tri_mat: torch.Tensor              # (T + LEAF_CHUNK,) i32
    #: the texel atlas, (32 ceil(X/32), 4) i32: a texel's u8 RGBA word and
    #: its wrapped x, y and xy neighbours' side by side, the words of the
    #: reference's quad rows (``tex_texels``; assets/textures.py
    #: pack_texels_u8_quads); 64 one-texel black slots when no material is
    #: textured
    tex_quads: torch.Tensor
    tex_meta: torch.Tensor             # (64, 4) f32: offset, h, w, 0 a slot
    #: per-instance (node_offset, tri_offset, tri_count)
    inst_spans: tuple = ()
    #: per-instance root row in ``wide_rows`` (-1 for brute-force groups)
    wide_roots: tuple = ()
    #: max wide-tree depth; the traversal stack holds ``wide_depth + 2``
    wide_depth: int = 1
    #: material classes present ("glass", "texture", "normal_map", ...)
    shade_classes: tuple = ()
    #: per-instance material-id shift (0 for an instance that owns its
    #: triangles; the reference shares one mesh between instances with it)
    inst_mat_deltas: tuple = ()
    #: root row of the sphere BVH in ``wide_rows`` (world space, its leaves
    #: name the spheres by their ids in the dense tables); -1 when the
    #: scene has none and the dense sphere prepass runs
    sphere_bvh_root: int = -1
    #: emissive primitives for next-event estimation (``_extract_lights``),
    #: one 14-tuple each: kind (0 triangle, 1 sphere), v0, v1, v2 in world
    #: space (a sphere: centre, radius, zeros), radiance, area; () when the
    #: scene has none or more than ``MAX_NEE_LIGHTS``
    lights: tuple = ()
    #: host-side results derived from this scene once and kept with it
    #: (e.g. the small-scene path's packed tables); a scene made by ``to``
    #: starts with an empty one
    derived: dict = dataclasses.field(default_factory=dict, init=False,
                                      repr=False, compare=False)

    @property
    def n_spheres(self) -> int:
        return int(self.sphere_pos.shape[0])

    @property
    def n_instances(self) -> int:
        return len(self.inst_spans)

    @property
    def device(self) -> torch.device:
        return self.wide_rows.device

    @property
    def tex_texels(self) -> torch.Tensor:
        """The atlas as the reference's (ceil(X/32), 128) quad rows, its
        float32 rows byte for byte (a copy)."""
        return rows_from_quads(self.tex_quads)

    def to(self, device) -> "TorchScene":
        """The same scene with every tensor on ``device`` (``self`` when
        already there)."""
        device = torch.device(device)
        if self.device == device:
            return self
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(device) for f in TENSORS})

    @staticmethod
    def from_numpy(fields: dict, statics: dict) -> "TorchScene":
        """Build CPU tensors from numpy arrays — e.g. the reference
        ``RenderScene``'s fields through ``np.asarray`` — and its static
        fields."""
        arrays = {f: np.array(fields[f]) for f in FIELDS}
        # the reference keeps the texel words bit-cast to float32: take the
        # bytes as int32, never as floats
        rows = arrays.pop("tex_texels")
        arrays["tex_quads"] = quads_from_rows(
            rows.view(np.int32) if rows.dtype == np.float32 else rows)
        tensors = {f: torch.from_numpy(a) for f, a in arrays.items()}
        st = {k: statics[k] for k in STATICS}
        st["wide_depth"] = int(st["wide_depth"])
        st["inst_spans"] = tuple(tuple(int(v) for v in s)
                                 for s in st["inst_spans"])
        st["wide_roots"] = tuple(int(r) for r in st["wide_roots"])
        st["shade_classes"] = tuple(st["shade_classes"])
        st["inst_mat_deltas"] = tuple(int(d) for d in st["inst_mat_deltas"])
        st["sphere_bvh_root"] = int(st["sphere_bvh_root"])
        st["lights"] = tuple(tuple(row) for row in st["lights"])
        return TorchScene(**tensors, **st)


def _shade_classes(records) -> tuple:
    """Material-class summary (reference ``_shade_classes``): which
    shading branches can the scene ever take?"""
    classes = []
    if any(int(r.flag) == MaterialFlag.GLASS for r in records):
        classes.append("glass")
    textured = [int(r.flag) == MaterialFlag.TEXTURE and r.diffuse_index != -1
                for r in records]
    if any(textured):
        classes.append("texture")
        if sum(textured) * 2 >= len(records):
            classes.append("texture_dominant")
    if any(r.normal_index != -1 for r in records):
        classes.append("normal_map")
    return tuple(classes)


def _extract_lights(records, tri, inst_spans, inst_m2w, inst_mat_deltas,
                    spheres) -> tuple:
    """The static light table of next-event estimation (a copy of the
    reference's ``_extract_lights``, which is pure numpy, kept op for op so
    the tables are byte-identical). Emissive triangles of every instance,
    brute-force and wide-BVH alike, in world space (a mirrored transform
    swaps v1 and v2, so the front side stays the one rays can hit), then
    emissive spheres; each row carries the resolved radiance (emission
    colour times strength) and the world-space area. Emissive glass is no
    light: the glass branch never adds its emission. More than
    ``MAX_NEE_LIGHTS`` rows give ()."""

    def emissive(rec):
        return (rec.emission_strength > 0.0
                and max(rec.emission_color[:3]) > 0.0
                and int(rec.flag) != 1)

    def radiance(rec):
        return tuple(float(c) * float(rec.emission_strength)
                     for c in rec.emission_color[:3])

    emissive_ids = np.array([i for i, r in enumerate(records)
                             if emissive(r)], np.int64)
    if emissive_ids.size == 0 and not spheres:
        return ()
    lights = []
    tri_mat = np.asarray(tri["mat"], np.int64)
    for i, (_, tri_off, count) in enumerate(inst_spans):
        m = np.asarray(inst_m2w[i], np.float32)
        delta = inst_mat_deltas[i] if i < len(inst_mat_deltas) else 0
        if emissive_ids.size == 0:
            continue
        span = tri_mat[tri_off:tri_off + count] + delta
        mirrored = float(np.linalg.det(m[:3, :3].astype(np.float64))) < 0.0
        for t in (tri_off + np.nonzero(np.isin(span, emissive_ids))[0]):
            rec = records[int(tri_mat[t]) + delta]
            w = [tuple((m[:3, :3] @ v + m[:3, 3]).tolist())
                 for v in (tri["v0"][t], tri["v1"][t], tri["v2"][t])]
            if mirrored:
                w[1], w[2] = w[2], w[1]
            area = 0.5 * float(np.linalg.norm(
                np.cross(np.subtract(w[1], w[0]), np.subtract(w[2], w[0]))))
            if area <= 0.0:
                continue
            lights.append((0, *w[0], *w[1], *w[2], *radiance(rec), area))
    for centre, radius, mid in spheres:
        rec = records[mid]
        if not emissive(rec):
            continue
        area = float(4.0 * np.pi * radius * radius)
        lights.append((1, *(float(c) for c in np.asarray(centre)[:3]),
                       float(radius), 0.0, 0.0, 0.0, 0.0, 0.0,
                       *radiance(rec), area))
    if len(lights) > MAX_NEE_LIGHTS:
        return ()
    return tuple(lights)


def _pack_material_rows(records: list) -> np.ndarray:
    """Packed material rows: 0:4 color, 4:8 emission_color, 8:12
    specular_color, 12:16 absorption, 16 absorption_strength, 17
    emission_strength, 18 smoothness, 19 specular, 20 ior, 21 flag,
    22 diffuse_index, 23 normal_index, 24:32 pad."""
    if not records:
        records = [MaterialRecord()]
    rows = np.zeros((len(records), 32), np.float32)
    for i, r in enumerate(records):
        rows[i, 0:4] = r.color
        rows[i, 4:8] = r.emission_color
        rows[i, 8:12] = r.specular_color
        rows[i, 12:16] = r.absorption
        rows[i, 16] = r.absorption_strength
        rows[i, 17] = r.emission_strength
        rows[i, 18] = r.smoothness
        rows[i, 19] = r.specular
        rows[i, 20] = r.ior
        rows[i, 21] = float(r.flag)
        rows[i, 22] = float(r.diffuse_index)
        rows[i, 23] = float(r.normal_index)
    return rows


def _concat_soup(parts):
    """(MeshData, mat_id) parts -> per-corner SoA arrays."""
    cols = [[] for _ in range(10)]
    for mesh, mid in parts:
        idx = mesh.indices.reshape(-1, 3)
        if len(idx) == 0:
            continue
        p, n, uv = mesh.positions, mesh.normals, mesh.uvs
        for k, src in enumerate((p, p, p, n, n, n, uv, uv, uv)):
            cols[k].append(src[idx[:, k % 3]])
        cols[9].append(np.full(len(idx), mid, np.int32))
    if not cols[0]:
        return None
    return tuple(np.concatenate(c, axis=0) for c in cols)


def _tex_budget_mb() -> int:
    """Texel-atlas size budget in MB (``RT2_TEX_BUDGET_MB``, default 0 =
    off = full-resolution textures, the reference's in-kernel sampling,
    ray_tracer.wgsl:455-459): when set, an oversized texture set is
    downscaled at instantiation to fit (reference ``_tex_budget_mb``)."""
    try:
        return max(int(os.environ.get("RT2_TEX_BUDGET_MB", "0")), 0)
    except ValueError:
        return 0


def texture_tables(assets) -> tuple[np.ndarray, np.ndarray]:
    """The atlas of the textures ``assets`` holds (reference
    render_scene.py:761-774): (quad rows as int32, (64, 4) float32 slot
    table of offset, height, width, 0). A quad row stores 16 bytes a
    texel, which ``RT2_TEX_BUDGET_MB`` divides."""
    images = assets.texture_images()
    budget_mb = _tex_budget_mb()
    if budget_mb > 0:
        images = downsample_images_to_budget(images,
                                             budget_mb * (1 << 20) // 16)
    atlas = TextureAtlas.from_images(images)
    meta = np.stack([atlas.offsets, atlas.heights, atlas.widths,
                     np.zeros_like(atlas.offsets)], axis=1).astype(np.float32)
    return pack_texels_u8_quads(atlas.texels, atlas.offsets, atlas.heights,
                                atlas.widths), meta


def sphere_bvh_engaged(n_spheres: int, sphere_bvh: bool | None) -> bool:
    """Whether a scene of ``n_spheres`` gets a sphere BVH (reference
    ``_sphere_bvh_engaged``, which reads the choice from the environment):
    from ``SPHERE_BVH_MIN`` spheres unless ``sphere_bvh`` says otherwise;
    when asked for, only above one leaf's worth of spheres, since the
    traversal enters through an interior root row."""
    if sphere_bvh is None:
        return n_spheres >= SPHERE_BVH_MIN
    return bool(sphere_bvh) and n_spheres > SPH_CHUNK


def instantiate_scene(definition: SceneDefinition, assets=None,
                      sphere_bvh: bool | None = None) -> TorchScene:
    """Entities -> assets -> BVH -> tensors on the CPU (ref:
    Scene::instantiate_scene, scene.rs:179-271; reference
    ``instantiate_scene``). ``assets`` (an ``AssetManager``; a new one if
    None) resolves the materials' textures and the meshes named by file,
    and its textures make the atlas. ``sphere_bvh`` forces the sphere BVH
    on or off (``sphere_bvh_engaged``). Move the result to the card with
    ``.to("cuda")``."""
    if assets is None:
        from ray_tracer_2_tpu_torch.assets.manager import AssetManager
        assets = AssetManager()
    records: list[MaterialRecord] = []
    spheres = []
    groups: dict[bytes, dict] = {}

    def mat_id(rec: MaterialRecord) -> int:
        records.append(rec)
        return len(records) - 1

    for e in definition.entities:
        mat = e.material
        diffuse = -1 if mat.diffuse_texture is None \
            else assets.load_texture(mat.diffuse_texture)
        normal = -1 if mat.normal_texture is None \
            else assets.load_texture(mat.normal_texture)
        resolved = mat.resolve(diffuse_index=diffuse, normal_index=normal)
        if isinstance(e.primitive, SphereDef):
            spheres.append((e.primitive.centre, e.primitive.radius,
                            mat_id(resolved)))
            continue
        if isinstance(e.primitive, MeshFromFile):
            parts = [(mesh, mat_id(rec)) for mesh, rec, _ in
                     assets.load_model(e.primitive.path, e.primitive.use_mtl,
                                       override=resolved)]
        else:
            parts = [(e.primitive.resolved(), mat_id(resolved))]
        m = e.transform.to_matrix()
        g = groups.setdefault(m.tobytes(), {"matrix": m, "parts": []})
        g["parts"].extend(parts)

    mat_flags = np.array([r.flag for r in records] or [0], np.int32)
    tri = {k: [] for k in ("v0", "v1", "v2", "n0", "n1", "n2",
                           "uv0", "uv1", "uv2", "mat")}
    w2m, m2w, spans, roots, deltas = [], [], [], [], []
    wide_groups = []
    wide_cursor = tri_cursor = node_cursor = 0
    wide_depth = 1

    # Instanced-geometry sharing (reference render_scene.py:594-690): a
    # group whose parts are the SAME MeshData objects as an earlier group's,
    # with one material-id shift and the same flags, reuses that group's
    # tables and carries only the shift.
    built: dict[tuple, dict] = {}

    def share(key, group):
        canon = built.get(key)
        if canon is None:
            return None
        b_ids = [mid for _, mid in group["parts"]]
        shifts = {b - a for a, b in zip(canon["mat_ids"], b_ids)}
        if len(shifts) != 1 or any(records[a].flag != records[b].flag
                                   for a, b in zip(canon["mat_ids"], b_ids)):
            return None
        return canon, shifts.pop()

    def add_instance(matrix, node_off, tri_off, count, root, delta):
        m2w.append(matrix)
        w2m.append(np.linalg.inv(matrix.astype(np.float64))
                   .astype(np.float32))
        spans.append((node_off, tri_off, count))
        roots.append(root)
        deltas.append(delta)

    for g in groups.values():
        key = tuple(id(mesh) for mesh, _ in g["parts"])
        shared = share(key, g)
        if shared is not None:
            canon, delta = shared
            add_instance(g["matrix"], canon["node_off"], canon["tri_off"],
                         canon["count"], canon["root"], int(delta))
            continue
        soup = _concat_soup(g["parts"])
        if soup is None:
            continue
        v0, v1, v2, n0, n1, n2, uv0, uv1, uv2, mats = soup
        bvh = build_bvh(v0, v1, v2, max_leaf=LEAF_CHUNK)
        o = bvh.tri_order
        cull = (mat_flags[mats[o]] != MaterialFlag.GLASS).astype(np.float32)
        rows, n_rows, wd = pack_wide_rows(
            bvh, v0[o], v1[o], v2[o], mats[o], cull,
            row_offset=wide_cursor, tri_offset=tri_cursor)
        wide_groups.append(rows)
        wide_depth = max(wide_depth, wd)
        for k, arr in zip(tri, (v0, v1, v2, n0, n1, n2, uv0, uv1, uv2,
                                mats)):
            tri[k].append(arr[o])
        built[key] = dict(
            mat_ids=[mid for _, mid in g["parts"]], node_off=node_cursor,
            tri_off=tri_cursor, count=len(v0), root=wide_cursor)
        add_instance(g["matrix"], node_cursor, tri_cursor, len(v0),
                     wide_cursor, 0)
        wide_cursor += n_rows
        tri_cursor += len(v0)
        node_cursor += bvh.n_nodes

    def cat(parts, shape, dtype=np.float32):
        pad = np.zeros((LEAF_CHUNK, *shape), dtype)
        return np.concatenate(parts + [pad], axis=0)

    t = {k: cat(v, (2,) if k.startswith("uv") else (3,))
         for k, v in tri.items() if k != "mat"}
    t["mat"] = cat(tri["mat"], (), np.int32)
    tri_attr = pack_attr_quads(pack_tri_attributes(
        t["n0"], t["n1"], t["n2"], t["uv0"], t["uv1"], t["uv2"],
        t["v0"], t["v1"], t["v2"]))
    if spheres:
        sphere_pos = np.stack([s[0] for s in spheres]).astype(np.float32)
        sphere_radius = np.array([s[1] for s in spheres], np.float32)
        sphere_mat = np.array([s[2] for s in spheres], np.int32)
    else:
        sphere_pos = np.zeros((0, 3), np.float32)
        sphere_radius = np.zeros(0, np.float32)
        sphere_mat = np.zeros(0, np.int32)
    # the sphere BVH, in world space, appended to the same wide table
    # (reference render_scene.py:727-747)
    sphere_bvh_root = -1
    if sphere_bvh_engaged(len(spheres), sphere_bvh):
        sbvh = build_bvh_bounds(sphere_pos - sphere_radius[:, None],
                                sphere_pos + sphere_radius[:, None],
                                sphere_pos, max_leaf=SPH_CHUNK)
        o = sbvh.tri_order
        rows, n_rows, wd = pack_sphere_wide_rows(
            sbvh, sphere_pos[o], sphere_radius[o], row_offset=wide_cursor)
        wide_groups.append(rows)
        sphere_bvh_root = wide_cursor
        wide_depth = max(wide_depth, wd)
    wide = np.concatenate(wide_groups, axis=0) if wide_groups \
        else np.zeros((0, 128), np.float32)
    tex_texels, tex_meta = texture_tables(assets)
    cam = definition.camera.to_uniform()
    mat44 = lambda ms: (np.stack(ms) if ms
                        else np.zeros((0, 4, 4), np.float32))
    fields = dict(
        sphere_pos=sphere_pos, sphere_radius=sphere_radius,
        sphere_mat=sphere_mat,
        inst_world_to_model=mat44(w2m), inst_model_to_world=mat44(m2w),
        wide_rows=wide, tri_attr=tri_attr,
        mat_rows=_pack_material_rows(records),
        cam_to_world=cam.cam_to_world, view_params=cam.view_params,
        defocus_strength=np.float32(cam.defocus_strength),
        diverge_strength=np.float32(cam.diverge_strength),
        **{f"tri_{k}": t[k] for k in ("v0", "v1", "v2", "n0", "n1", "n2",
                                      "mat")},
        tex_texels=tex_texels, tex_meta=tex_meta)
    statics = dict(inst_spans=tuple(spans), wide_roots=tuple(roots),
                   wide_depth=wide_depth,
                   shade_classes=_shade_classes(records),
                   inst_mat_deltas=tuple(deltas),
                   sphere_bvh_root=sphere_bvh_root,
                   lights=_extract_lights(records, t, spans, m2w, deltas,
                                          spheres))
    return TorchScene.from_numpy(fields, statics)
