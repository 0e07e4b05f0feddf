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
reference's ``tex_texels`` one texel a row; ``tex_meta``). ``HostScene``
pairs a scene with its host camera, its counts and the host state of the
live edits; the camera moves in place (``TorchScene.set_camera``), and
spheres, materials and instances are edited in place or, where a shape or
a static field changes, by a new ``TorchScene`` (``HostScene.edit_*``).
Each write is noted in the scene's ``WriteLog``; the tables a kernel keeps
with a scene (``TorchScene.derive``) follow the log. The per-triangle
model-space
tables (``tri_v0`` ... ``tri_mat``, in BVH leaf order with ``LEAF_CHUNK``
zero rows at the end) are what the small-scene path bakes to world space
(``kernels/spheres.py:pack_tables``).
"""
from __future__ import annotations

import dataclasses
import os
import threading

import numpy as np
import torch

from ray_tracer_2_tpu_torch.accel.bvh import (
    BVHQuality, BVHStats, build_bvh, build_bvh_bounds, bvh_stats,
)
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
from ray_tracer_2_tpu_torch.scene.camera import Camera
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

#: the material fields whose edit is a ``material_form`` edit
FORM_FIELDS = ("flag", "diffuse_index", "normal_index", "emission_color",
               "emission_strength")


@dataclasses.dataclass
class WriteLog:
    """The in-place writes of a scene and of the scenes that edits made
    from it (``TorchScene.edited`` hands the log on). ``version`` counts
    the writes. ``last`` maps each tensor field written, and each kind of
    write, to the version of its last write. The kinds:

    * ``camera``: the four camera tensors (``TorchScene.set_camera``);
    * ``sphere``: a centre or a radius (and the sphere BVH's rows);
    * ``instance``: an instance's transform;
    * ``material``: colours, smoothness, specular, ior, absorption;
    * ``material_form``: a material's ``FORM_FIELDS`` (and the cull flags
      baked into the wide rows);
    * ``lights``: the light table (a new ``TorchScene``).

    A table a kernel keeps with the scene names the kinds it follows
    (``TorchScene.derive``). A copy of the scene on another device
    (``parallel/sharding.py``) copies the fields written since the version
    it has seen and notes them in its own log; it reads nothing back to the
    host."""

    version: int = 0
    last: dict = dataclasses.field(default_factory=dict)

    def note(self, kind: str, *fields: str) -> None:
        self.version += 1
        for key in (kind, *fields):
            self.last[key] = self.version

    def since(self, version: int) -> set:
        """The fields and kinds written after ``version``."""
        return {k for k, v in self.last.items() if v > version}


def write_in_place(dst: torch.Tensor, value) -> None:
    """Write ``value`` (array-like, as float32) into the float32 tensor
    ``dst`` on its device, in stream order and without waiting for the
    device: frames queued before read the old values, frames queued after
    the new ones. CUDA copies a pageable host array to a staging buffer
    before the copy call returns, so the array may go at once."""
    src = torch.from_numpy(np.ascontiguousarray(value, dtype=np.float32))
    dst.copy_(src.reshape(dst.shape), non_blocking=True)


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
    #: the tables kernels keep with this scene (``derive``), by key; a
    #: scene made by ``to`` starts with an empty one
    derived: dict = dataclasses.field(default_factory=dict, init=False,
                                      repr=False, compare=False)
    #: the write-log version each entry of ``derived`` was made or last
    #: refreshed at
    derived_at: dict = dataclasses.field(default_factory=dict, init=False,
                                         repr=False, compare=False)
    #: the in-place writes (``WriteLog``); a scene made by ``to`` starts a
    #: log of its own, one made by ``edited`` shares its source's
    writes: WriteLog = dataclasses.field(default_factory=WriteLog,
                                         init=False, repr=False,
                                         compare=False)

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

    def derive(self, key, build, stale_on=(), refresh=None):
        """The table ``key`` a kernel keeps with this scene: ``build()``,
        made at the first call and made again after a write of a kind in
        ``stale_on``. ``refresh`` maps kinds of write that only move values
        to a function that writes them into the table in place, in stream
        order and reading nothing back. A kind named in neither leaves the
        table as it is. A call after no write costs one comparison."""
        version = self.writes.version
        if key in self.derived:
            seen = self.derived_at[key]
            if seen == version:
                return self.derived[key]
            last = self.writes.last
            if all(last.get(k, 0) <= seen for k in stale_on):
                table = self.derived[key]
                for kind, write in (refresh or {}).items():
                    if last.get(kind, 0) > seen:
                        write(table)
                self.derived_at[key] = version
                return table
        table = self.derived[key] = build()
        self.derived_at[key] = version
        return table

    def set_camera(self, camera: Camera) -> None:
        """Point the scene at ``camera``, in place: its four camera tensors,
        written on the scene's device in stream order, so that frames queued
        before render the old view and later ones the new. In place because
        a ``dataclasses.replace`` drops ``derived``, and with it every table
        built for the scene."""
        u = camera.to_uniform()
        new = dict(cam_to_world=u.cam_to_world, view_params=u.view_params,
                   defocus_strength=u.defocus_strength,
                   diverge_strength=u.diverge_strength)
        for f, v in new.items():
            write_in_place(getattr(self, f), v)
        self.writes.note("camera", *new)

    def edited(self, **changes) -> "TorchScene":
        """The scene an edit puts in this one's place: ``changes`` applied,
        this scene's derived tables and write log carried, so each table
        follows the writes from where it stood."""
        new = dataclasses.replace(self, **changes)
        new.derived.update(self.derived)
        new.derived_at.update(self.derived_at)
        object.__setattr__(new, "writes", self.writes)  # frozen dataclass
        return new

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


@dataclasses.dataclass
class HostScene:
    """A scene with its host-side state (reference ``HostScene``; ref
    ``Scene``, scene.rs:148-156): the mutable camera, the ``TorchScene``
    it renders, the ``BVHStats`` of each tree built, its counts, and what
    the live edits need (the per-entity material records, each instance's
    host ``Transform`` and material ids, each built group's leaf-ordered
    tables). ``refresh_camera`` after moving ``camera`` points the scene at
    it; ``edit_sphere``, ``edit_material`` and ``edit_instance_transform``
    are the reference's live edits (egui.rs:156-365), with the same results
    table for table.

    An edit writes the scene's tensors whose shape holds in place, in
    stream order (``write_in_place``), and notes the write in the scene's
    ``WriteLog``, which the kernels' tables follow. One that changes a
    shape or a static field (the sphere BVH's rows, the light table, the
    material classes) puts a new ``TorchScene`` in ``scene``, carrying the
    derived tables and the log. ``lock`` serialises edits against each
    other and against a frame's dispatch: ``Engine.update`` holds it while
    it reads ``scene`` and queues the frame, so a frame never meets a
    half-made edit; since the writes are queued in stream order, it is
    not held while the card renders."""

    camera: Camera
    scene: TorchScene
    bvh_stats: list
    n_spheres: int
    n_instances: int
    n_triangles: int
    #: binary BVH nodes of every table built (shared tables once)
    n_nodes: int
    #: per-entity material records (one row per entity or submesh)
    records: list = dataclasses.field(default_factory=list)
    #: per-instance host ``Transform`` (partial edits keep the rest)
    inst_transforms: list = dataclasses.field(default_factory=list)
    #: per-instance material ids (one per submesh part)
    inst_material_ids: list = dataclasses.field(default_factory=list)
    #: per built group, for cull-flag repacks: (bvh, v0, v1, v2, mats,
    #: node_offset, tri_offset, deltas), leaf-ordered arrays, ``deltas`` the
    #: material-id shifts of every instance sharing the group
    _staging: list = dataclasses.field(default_factory=list)
    lock: threading.RLock = dataclasses.field(
        default_factory=threading.RLock, init=False, repr=False,
        compare=False)
    #: host copies of what edits read back (spheres, triangles), made once
    #: from the device and then kept in step by the edits
    _mirror: dict = dataclasses.field(default_factory=dict, init=False,
                                      repr=False, compare=False)

    def refresh_camera(self) -> None:
        with self.lock:
            self.scene.set_camera(self.camera)

    def to(self, device) -> "HostScene":
        """The same host state over the scene moved to ``device`` (``self``
        when already there); the copy has records and transforms of its
        own."""
        scene = self.scene.to(device)
        if scene is self.scene:
            return self
        return dataclasses.replace(
            self, scene=scene,
            records=[dataclasses.replace(r) for r in self.records],
            inst_transforms=[t.copy() for t in self.inst_transforms],
            inst_material_ids=[list(m) for m in self.inst_material_ids])

    # ------------------------------------------------------- live edits

    def _host(self) -> dict:
        """Host copies of the sphere and triangle tables (one readback)."""
        if not self._mirror:
            sc = self.scene
            self._mirror.update(
                {k: getattr(sc, k).cpu().numpy().copy() for k in (
                    "sphere_pos", "sphere_radius", "sphere_mat", "tri_v0",
                    "tri_v1", "tri_v2", "tri_mat")})
        return self._mirror

    def _replace(self, **changes) -> None:
        """Put a new ``TorchScene`` with ``changes`` in ``scene``, carrying
        the derived tables and the write log (``TorchScene.edited``)."""
        self.scene = self.scene.edited(**changes)

    def edit_sphere(self, index: int, centre=None, radius=None) -> None:
        """Move or resize a sphere (egui.rs:171-207). A scene with a sphere
        BVH rebuilds its rows at the end of ``wide_rows`` (in place when
        their count holds, else a new ``TorchScene``); a rebuilt tree
        deeper than the kernel's stack raises ``NotImplementedError`` and
        leaves the scene as it was."""
        with self.lock:
            host = self._host()
            pos, rad = host["sphere_pos"].copy(), host["sphere_radius"].copy()
            if centre is not None:
                pos[index] = np.asarray(centre, np.float32)
            if radius is not None:
                rad[index] = np.float32(radius)
            sc = self.scene
            rows = depth = None
            if sc.sphere_bvh_root >= 0:
                rows, depth = self._sphere_rows(pos, rad)
            host["sphere_pos"], host["sphere_radius"] = pos, rad
            write_in_place(sc.sphere_pos[index], pos[index])
            write_in_place(sc.sphere_radius[index], rad[index])
            sc.writes.note("sphere", "sphere_pos", "sphere_radius")
            if rows is not None:
                root = sc.sphere_bvh_root
                if len(rows) == sc.wide_rows.shape[0] - root:
                    write_in_place(sc.wide_rows[root:], rows)
                    sc.writes.note("sphere", "wide_rows")
                    if depth != sc.wide_depth:
                        self._replace(wide_depth=depth)
                else:
                    tail = torch.from_numpy(rows).to(sc.device,
                                                     non_blocking=True)
                    self._replace(wide_rows=torch.cat(
                        [sc.wide_rows[:root], tail]), wide_depth=depth)
            self._refresh_lights()

    def _sphere_rows(self, pos, rad):
        """The sphere BVH's rows from ``pos``/``rad`` (reference
        ``_rebuild_sphere_rows``) and the scene's wide depth with them."""
        # imported here: kernels/megakernel.py imports this module
        from ray_tracer_2_tpu_torch.kernels.megakernel import MAX_STACK
        sbvh = build_bvh_bounds(pos - rad[:, None], pos + rad[:, None], pos,
                                max_leaf=SPH_CHUNK)
        o = sbvh.tri_order
        rows, _, d = pack_sphere_wide_rows(sbvh, pos[o], rad[o],
                                           row_offset=self.scene
                                           .sphere_bvh_root)
        depth = max(self.scene.wide_depth, d)
        if depth + 2 > MAX_STACK:
            raise NotImplementedError(
                f"the edited sphere BVH is {d} levels deep: wide BVHs deeper "
                f"than {MAX_STACK - 2} levels are not in the ported slice")
        return rows, depth

    def edit_material(self, mat_id: int, **fields) -> None:
        """Edit one entity's material (egui.rs:209-365). A changed ``flag``
        (a glass toggle) also repacks the cull flags baked into the wide
        rows; the material classes and the light table follow."""
        with self.lock:
            rec = self.records[mat_id]
            before = {k: getattr(rec, k) for k in FORM_FIELDS}
            for k, v in fields.items():
                setattr(rec, k, tuple(v) if isinstance(v, (list, np.ndarray))
                        else v)
            sc = self.scene
            write_in_place(sc.mat_rows[mat_id],
                           _pack_material_rows([rec])[0])
            form = any(getattr(rec, k) != v for k, v in before.items())
            kind = "material_form" if form else "material"
            sc.writes.note(kind, "mat_rows")
            classes = _shade_classes(self.records)
            if classes != sc.shade_classes:
                self._replace(shade_classes=classes)
            if rec.flag != before["flag"]:
                self._repack_cull_flags()
            self._refresh_lights()

    def edit_instance_transform(self, index: int, transform=None, *,
                                pos=None, rot=None, scale=None) -> None:
        """Move, rotate or scale a whole instance group (egui.rs:280-330).
        Partial edits (only ``pos``/``rot``/``scale``) merge into the stored
        host transform, so editing one component keeps the others."""
        with self.lock:
            if transform is None:
                transform = self.inst_transforms[index].copy()
                if pos is not None:
                    transform.pos = np.asarray(pos, np.float32)
                if rot is not None:
                    transform.rot = np.asarray(rot, np.float32)
                if scale is not None:
                    transform.scale = (np.asarray(scale, np.float32)
                                       * np.ones(3, np.float32))
            self.inst_transforms[index] = transform.copy()
            m = transform.to_matrix()
            inv = np.linalg.inv(m.astype(np.float64)).astype(np.float32)
            sc = self.scene
            write_in_place(sc.inst_model_to_world[index], m)
            write_in_place(sc.inst_world_to_model[index], inv)
            sc.writes.note("instance", "inst_model_to_world",
                           "inst_world_to_model")
            self._refresh_lights()

    def _refresh_lights(self) -> None:
        """Re-derive the light table after an edit that can move or
        re-colour an emissive primitive (reference ``_refresh_lights``). A
        new ``TorchScene`` only when the table changed; nothing is read when
        nothing is emissive before or after the edit."""
        sc = self.scene
        if not sc.lights and not any(
                r.emission_strength > 0.0 and max(r.emission_color[:3]) > 0.0
                for r in self.records):
            return
        host = self._host()
        tri = {k: host[f"tri_{k}"] for k in ("v0", "v1", "v2", "mat")}
        # the instance matrices as the edits wrote them
        m2w = [t.to_matrix() for t in self.inst_transforms]
        spheres = [(p, float(r), int(m)) for p, r, m in zip(
            host["sphere_pos"], host["sphere_radius"], host["sphere_mat"])]
        lights = _extract_lights(self.records, tri, sc.inst_spans, m2w,
                                 list(sc.inst_mat_deltas), spheres)
        if lights != sc.lights:
            sc.writes.note("lights")
            self._replace(lights=lights)

    def _repack_cull_flags(self) -> None:
        """Re-pack the wide rows with the cull flags of the current
        materials (reference ``_repack_cull_flags``), in place: the trees
        are the same, so are the row counts. A triangle of a shared group
        keeps its cull only if no sharing instance made its material glass
        (conservative: less culling is always correct)."""
        flags = np.array([r.flag for r in self.records] or [0], np.int32)
        groups, cursor = [], 0
        for bvh, v0, v1, v2, mats, _, tri_off, deltas in self._staging:
            cull = np.ones(len(mats), np.float32)
            for d in deltas:
                cull *= (flags[mats + d] != MaterialFlag.GLASS).astype(
                    np.float32)
            rows, n, _ = pack_wide_rows(bvh, v0, v1, v2, mats, cull,
                                        row_offset=cursor, tri_offset=tri_off)
            groups.append(rows)
            cursor += n
        if groups:
            write_in_place(self.scene.wide_rows[:cursor],
                           np.concatenate(groups, axis=0))
            self.scene.writes.note("material_form", "wide_rows")


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
                      sphere_bvh: bool | None = None,
                      quality: BVHQuality = BVHQuality.HIGH) -> TorchScene:
    """Entities -> assets -> BVH -> tensors on the CPU (ref:
    Scene::instantiate_scene, scene.rs:179-271; reference
    ``instantiate_scene``). ``assets`` (an ``AssetManager``; a new one if
    None) resolves the materials' textures and the meshes named by file,
    and its textures make the atlas. ``sphere_bvh`` forces the sphere BVH
    on or off (``sphere_bvh_engaged``); ``quality`` is the BVH builds' (the
    reference's debug-panel tiers). Move the result to the card with
    ``.to("cuda")``; ``instantiate_host_scene`` also keeps the camera and
    the counts."""
    return instantiate_host_scene(definition, assets, sphere_bvh,
                                  quality).scene


def instantiate_host_scene(definition: SceneDefinition, assets=None,
                           sphere_bvh: bool | None = None,
                           quality: BVHQuality = BVHQuality.HIGH
                           ) -> HostScene:
    """``instantiate_scene`` as the reference returns it: a ``HostScene``
    whose camera is the definition's (the same object)."""
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
        g = groups.setdefault(m.tobytes(), {"matrix": m, "parts": [],
                                            "transform": e.transform})
        g["parts"].extend(parts)

    mat_flags = np.array([r.flag for r in records] or [0], np.int32)
    tri = {k: [] for k in ("v0", "v1", "v2", "n0", "n1", "n2",
                           "uv0", "uv1", "uv2", "mat")}
    w2m, m2w, spans, roots, deltas = [], [], [], [], []
    transforms, material_ids, staging = [], [], []
    wide_groups = []
    wide_cursor = tri_cursor = node_cursor = 0
    wide_depth = 1
    stats: list[BVHStats] = []

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

    def add_instance(g, node_off, tri_off, count, root, delta):
        matrix = g["matrix"]
        transforms.append(g["transform"].copy())
        material_ids.append(sorted({int(mid) for _, mid in g["parts"]}))
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
            add_instance(g, canon["node_off"], canon["tri_off"],
                         canon["count"], canon["root"], int(delta))
            canon["staging"][7].append(int(delta))
            continue
        soup = _concat_soup(g["parts"])
        if soup is None:
            continue
        v0, v1, v2, n0, n1, n2, uv0, uv1, uv2, mats = soup
        bvh = build_bvh(v0, v1, v2, max_leaf=LEAF_CHUNK, quality=quality)
        stats.append(bvh_stats(bvh))
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
        stage = (bvh, v0[o], v1[o], v2[o], mats[o], node_cursor, tri_cursor,
                 [0])
        staging.append(stage)
        built[key] = dict(
            mat_ids=[mid for _, mid in g["parts"]], node_off=node_cursor,
            tri_off=tri_cursor, count=len(v0), root=wide_cursor,
            staging=stage)
        add_instance(g, node_cursor, tri_cursor, len(v0), wide_cursor, 0)
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
                                sphere_pos, max_leaf=SPH_CHUNK,
                                quality=quality)
        stats.append(bvh_stats(sbvh))
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
    return HostScene(camera=definition.camera,
                     scene=TorchScene.from_numpy(fields, statics),
                     bvh_stats=stats, n_spheres=len(spheres),
                     n_instances=len(spans), n_triangles=tri_cursor,
                     n_nodes=node_cursor, records=records,
                     inst_transforms=transforms,
                     inst_material_ids=material_ids, _staging=staging)
