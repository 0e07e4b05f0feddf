"""TorchScene — the port's device scene, and scene instantiation (port of
``ray_tracer_2_tpu/scene/render_scene.py``).

The JAX package ships one immutable SoA pytree (``RenderScene``) to the
device once per scene. ``TorchScene`` holds the fields of it that the main
path reads, as tensors on one device, plus the static integers that shape
the traversal. The host tables are built by copies of the reference's
numpy builders (``accel/``: SAH BVH, 32-ary wide rows with f16 child boxes,
quad-packed triangle attributes), so a port scene and a reference scene of
the same definition are byte-identical (``tests/test_torch_scene.py``).

Scope of the ported slices: mesh instance groups from data (several, one
per transform, sharing tables as the reference does), dense spheres, no
texture atlas, no NEE light table, no live edits (``HostScene``). Meshes
from files, textured materials and the sphere BVH raise
``NotImplementedError`` naming their ROADMAP item. The per-triangle
model-space tables (``tri_v0`` ...
``tri_mat``, in BVH leaf order with ``LEAF_CHUNK`` zero rows at the end)
are what the small-scene path bakes to world space
(``kernels/spheres.py:pack_tables``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ray_tracer_2_tpu_torch.accel.bvh import build_bvh
from ray_tracer_2_tpu_torch.accel.packed import (
    ROW_TRIS, pack_attr_quads, pack_tri_attributes,
)
from ray_tracer_2_tpu_torch.accel.wide import pack_wide_rows
from ray_tracer_2_tpu_torch.scene.definition import (
    MeshFromData, SceneDefinition, SphereDef,
)
from ray_tracer_2_tpu_torch.scene.material import MaterialFlag, MaterialRecord

#: leaf triangle chunk width (== accel/packed.py ROW_TRIS)
LEAF_CHUNK = ROW_TRIS

#: sphere count at which the reference traverses a sphere BVH instead of
#: the dense prepass (ray_tracer_2_tpu/scene/render_scene.py SPHERE_BVH_MIN)
SPHERE_BVH_MIN = 2048

#: the tensor fields a TorchScene carries (all of them RenderScene fields)
FIELDS = ("sphere_pos", "sphere_radius", "sphere_mat",
          "inst_world_to_model", "inst_model_to_world",
          "wide_rows", "tri_attr", "mat_rows",
          "cam_to_world", "view_params", "defocus_strength",
          "diverge_strength",
          "tri_v0", "tri_v1", "tri_v2", "tri_n0", "tri_n1", "tri_n2",
          "tri_mat")
#: the static (host) fields
STATICS = ("inst_spans", "wide_roots", "wide_depth", "shade_classes",
           "inst_mat_deltas")


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

    def to(self, device) -> "TorchScene":
        """The same scene with every tensor on ``device`` (``self`` when
        already there)."""
        device = torch.device(device)
        if self.device == device:
            return self
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(device) for f in FIELDS})

    @staticmethod
    def from_numpy(fields: dict, statics: dict) -> "TorchScene":
        """Build CPU tensors from numpy arrays — e.g. the reference
        ``RenderScene``'s fields through ``np.asarray`` — and its static
        fields."""
        tensors = {f: torch.tensor(np.array(fields[f])) for f in FIELDS}
        st = {k: statics[k] for k in STATICS}
        st["wide_depth"] = int(st["wide_depth"])
        st["inst_spans"] = tuple(tuple(int(v) for v in s)
                                 for s in st["inst_spans"])
        st["wide_roots"] = tuple(int(r) for r in st["wide_roots"])
        st["shade_classes"] = tuple(st["shade_classes"])
        st["inst_mat_deltas"] = tuple(int(d) for d in st["inst_mat_deltas"])
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


def instantiate_scene(definition: SceneDefinition) -> TorchScene:
    """Entities -> BVH -> tensors on the CPU (ref: Scene::instantiate_scene,
    scene.rs:179-271; reference ``instantiate_scene``). Move the result to
    the card with ``.to("cuda")``."""
    records: list[MaterialRecord] = []
    spheres = []
    groups: dict[bytes, dict] = {}
    for e in definition.entities:
        if e.material.diffuse_texture is not None \
                or e.material.normal_texture is not None:
            raise NotImplementedError(
                "textured materials wait for the texture slice "
                "(ROADMAP Queue 1 item 8)")
        records.append(e.material.resolve())
        mid = len(records) - 1
        if isinstance(e.primitive, SphereDef):
            spheres.append((e.primitive.centre, e.primitive.radius, mid))
            continue
        if not isinstance(e.primitive, MeshFromData):
            raise NotImplementedError(
                "meshes from files wait for the assets slice "
                "(ROADMAP Queue 1 item 8)")
        m = e.transform.to_matrix()
        g = groups.setdefault(m.tobytes(), {"matrix": m, "parts": []})
        g["parts"].append((e.primitive.resolved(), mid))
    if len(spheres) >= SPHERE_BVH_MIN:
        raise NotImplementedError(
            "the sphere BVH waits for its slice (ROADMAP Queue 1 item 8)")

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
    wide = np.concatenate(wide_groups, axis=0) if wide_groups \
        else np.zeros((0, 128), np.float32)

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
                                      "mat")})
    statics = dict(inst_spans=tuple(spans), wide_roots=tuple(roots),
                   wide_depth=wide_depth,
                   shade_classes=_shade_classes(records),
                   inst_mat_deltas=tuple(deltas))
    return TorchScene.from_numpy(fields, statics)
