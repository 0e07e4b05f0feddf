"""Shared helpers of the port's tests (tests/test_torch_*.py): bring a scene
of the JAX package over to the PyTorch port through numpy, so both render
from identical tables."""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ray_tracer_2_tpu.kernels.megakernel import \
    render_persistent as _ref_render_persistent
from ray_tracer_2_tpu_torch.kernels.megakernel import render_persistent
from ray_tracer_2_tpu_torch.scene.render_scene import (
    FIELDS, STATICS, TorchScene,
)

#: the image size the render comparisons use
W, H = 32, 16
_JITS = {}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run PyTorch's CPU ops on the calling thread only. With JAX's CPU
    runtime in the same process, one of PyTorch's worker threads was seen
    to round differently now and then (a worker's share of the elements,
    up to 3e-3 relative after cancellation); the main thread never was.
    Import it into a test module to apply it there."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def ref_field(rs, f: str) -> np.ndarray:
    """Field ``f`` of a reference ``RenderScene`` as the port holds it: the
    texel words, which the reference keeps bit-cast to float32, as int32."""
    a = np.asarray(getattr(rs, f))
    return a.view(np.int32) if f == "tex_texels" else a


def torch_scene(rs) -> TorchScene:
    """The port's scene for a reference ``RenderScene`` (CPU tensors)."""
    return TorchScene.from_numpy({f: ref_field(rs, f) for f in FIELDS},
                                 {k: getattr(rs, k) for k in STATICS})


def ref_definition(port):
    """The JAX package's ``SceneDefinition`` for a port one: the same
    camera, entities, transforms and materials (texture names included). A
    ``MeshData`` that several port entities share maps to one reference
    ``MeshData``, so instances that share tables in the port share them in
    the reference too; a mesh named by its file stays named by it."""
    from ray_tracer_2_tpu.math.transform import Transform
    from ray_tracer_2_tpu.scene import definition as rd
    from ray_tracer_2_tpu.scene.material import MaterialDefinition, \
        MaterialFlag
    from ray_tracer_2_tpu_torch.scene.definition import MeshFromData, \
        MeshFromFile, SphereDef

    def transform(t):
        return Transform(pos=t.pos, rot=t.rot, scale=t.scale)

    def material(m):
        fields = dataclasses.asdict(m)
        fields["flag"] = MaterialFlag(int(m.flag))
        return MaterialDefinition(**fields)

    cam = port.camera
    s = rd.SceneDefinition()
    s.set_camera(rd.CameraDescriptor(
        transform=transform(cam.transform), fov=cam.fov, aspect=cam.aspect,
        near=cam.near, far=cam.far, focus_dist=cam.focus_dist,
        defocus_strength=cam.defocus_strength,
        diverge_strength=cam.diverge_strength))
    meshes = {}
    for e in port.entities:
        p = e.primitive
        if isinstance(p, SphereDef):
            s.add_sphere(p.centre, p.radius, material(e.material))
        elif isinstance(p, MeshFromData):
            if id(p.data) not in meshes:
                meshes[id(p.data)] = rd.MeshData(
                    p.data.positions, p.data.normals, p.data.uvs,
                    p.data.indices)
            s.add_mesh(transform(e.transform),
                       rd.MeshFromData(meshes[id(p.data)], p.indices),
                       material(e.material))
        elif isinstance(p, MeshFromFile):
            s.add_mesh(transform(e.transform),
                       rd.MeshFromFile(p.path, p.use_mtl),
                       material(e.material))
        else:
            raise TypeError(f"no reference counterpart for {p!r}")
    return s


def ref_assets(port_assets=None, search_dirs=None):
    """A reference ``AssetManager`` holding the images of a port one under
    the same names and slots (the two dicts both keep: ``loaded_textures``,
    ``cpu_textures``), so that both packages build one atlas from them."""
    from ray_tracer_2_tpu.assets.manager import AssetManager
    ref = AssetManager(search_dirs)
    if port_assets is not None:
        ref.loaded_textures.update(port_assets.loaded_textures)
        ref.cpu_textures.update(port_assets.cpu_textures)
    return ref


def ref_scene_pair(definition, assets=None, **port_kw):
    """(reference RenderScene, port TorchScene) of one port definition,
    each package instantiating it with its own asset manager (the
    reference's mirroring ``assets``' textures)."""
    from ray_tracer_2_tpu.scene.render_scene import \
        instantiate_scene as ref_instantiate
    from ray_tracer_2_tpu_torch.assets.manager import AssetManager
    from ray_tracer_2_tpu_torch.scene.render_scene import instantiate_scene
    assets = AssetManager() if assets is None else assets
    ts = instantiate_scene(definition, assets, **port_kw)
    rs = ref_instantiate(ref_definition(definition),
                         assets=ref_assets(assets)).render_scene
    return rs, ts


def host_scene_pair(definition, assets=None, **port_kw):
    """(reference ``HostScene``, port ``HostScene``) of one port definition,
    each package instantiating it with its own asset manager and its own
    camera (the reference's from ``ref_definition``), so that the two
    cameras can be moved side by side."""
    from ray_tracer_2_tpu.scene.render_scene import \
        instantiate_scene as ref_instantiate
    from ray_tracer_2_tpu_torch.assets.manager import AssetManager
    from ray_tracer_2_tpu_torch.scene.render_scene import \
        instantiate_host_scene
    assets = AssetManager() if assets is None else assets
    port = instantiate_host_scene(definition, assets, **port_kw)
    ref = ref_instantiate(ref_definition(definition),
                          assets=ref_assets(assets))
    return ref, port


def wide_bvh_render_scene():
    """The reference's asset-free wide-BVH scene (__graft_entry__)."""
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from __graft_entry__ import _wide_bvh_scene
    return _wide_bvh_scene()


def frac_within(a, b, tol: float = 1e-5) -> float:
    """Share of pixels whose four channels all agree within ``tol``."""
    err = np.abs(np.asarray(a) - np.asarray(b)).max(axis=-1)
    return float((err < tol).mean())


def ref_render(rs, frames, fused=True, **over):
    """JAX ``render_persistent`` at W x H (128 lanes, unroll 2; the fused
    boundary runs in the Pallas interpreter). Returns (image, segments)."""
    kw = dict(width=W, height=H, bounces=0, rays_per_pixel=1, skybox=True,
              lanes=128, unroll=2)
    kw.update(over)
    key = (fused, tuple(sorted(kw.items())))
    if key not in _JITS:
        _JITS[key] = jax.jit(lambda s, f: _ref_render_persistent(
            s, f, fused_boundary=fused, **kw))
    img, segs = _JITS[key](rs, frames)
    return np.asarray(img), int(float(segs))


def import_probe_scripts():
    """Put the TPU probe scripts (``scripts/probe_*.py``) on ``sys.path``
    and return the ``scripts`` directory."""
    scripts = str(Path(__file__).resolve().parents[1] / "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    return scripts


def to_torch(a) -> torch.Tensor:
    """A JAX or numpy array as a CPU tensor of the same type (bfloat16
    through float32, which holds every bfloat16 exactly)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


class BenchRecorder:
    """Stands in for a TPU probe script's ``bench`` / ``bench_varying``:
    calls ``fn`` once on its arguments, at once (the scripts' closures
    read their loop variables late), and keeps (arguments as numpy,
    output as numpy) in ``calls``. With ``keep``, only the calls whose
    index is in it run; the rest are skipped (their sizes are too large
    for the CPU)."""

    def __init__(self, keep=None):
        self.calls, self.keep, self.n = [], keep, 0

    def bench(self, fn, *args, **kw):
        i, self.n = self.n, self.n + 1
        if self.keep is None or i in self.keep:
            out = jax.tree.map(np.asarray, fn(*args))
            self.calls.append(([np.asarray(a) for a in args], out))
        return 1.0

    def bench_varying(self, fn, argiter, **kw):
        return self.bench(fn, next(argiter))


def port_render(ts, frames, **over):
    """The port's ``render_persistent`` at W x H. Returns (image, segments)."""
    kw = dict(width=W, height=H, bounces=0, rays_per_pixel=1, skybox=True)
    kw.update(over)
    img, segs = render_persistent(ts, frames, **kw)
    assert img.dtype == torch.float32 and segs.dtype == torch.int64
    return img.numpy(), int(segs)


# ---- the asset-free scenes of the reference's tests/test_nee.py, written
# against the port's API (the reference's definitions come from
# ``ref_definition``)
def _quad(y, s, down):
    """Two triangles of a square at height ``y``, facing down or up."""
    a, b, c, d = ([-s, y, -s], [s, y, -s], [s, y, s], [-s, y, s])
    tris = [[a, b, c], [a, c, d]] if down else [[a, c, b], [a, d, c]]
    return np.asarray(tris, np.float32)


def _uv_sphere():
    """The 1,080-triangle unit sphere of test_nee.py (18 x 30 quads): more
    than the brute-force size, so a wide-BVH instance."""
    lat, lon = 18, 30
    th = np.linspace(0.0, np.pi, lat + 1)
    ph = np.linspace(0.0, 2 * np.pi, lon + 1)
    p = np.stack(np.meshgrid(th, ph, indexing="ij"), axis=-1)
    xyz = np.stack([np.sin(p[..., 0]) * np.cos(p[..., 1]), np.cos(p[..., 0]),
                    np.sin(p[..., 0]) * np.sin(p[..., 1])], axis=-1)
    quads = []
    for i in range(lat):
        for j in range(lon):
            a, b, c, d = (xyz[i, j], xyz[i + 1, j], xyz[i + 1, j + 1],
                          xyz[i, j + 1])
            quads += [[a, b, c], [a, c, d]]
    return np.asarray(quads, np.float32)


def nee_definition(name: str):
    """A scene of the reference's tests/test_nee.py as a port
    ``SceneDefinition``: ``traversal`` (:159, a wide-BVH sphere, a floor and
    a single-sided ceiling light), ``view`` and ``view_far`` (:248, the
    floor and light alone, and with an instance far out of view),
    ``plain_light`` and ``mirrored_light`` (:446, the light under the
    identity and under a mirroring transform), ``emissive_glass`` (:414),
    ``light_in_instance`` (:499, the light's triangles in the sphere's
    wide-BVH instance) and ``cone`` (:305, a sphere light over a ground
    sphere)."""
    from ray_tracer_2_tpu_torch.math.transform import Transform
    from ray_tracer_2_tpu_torch.scene.camera import CameraDescriptor
    from ray_tracer_2_tpu_torch.scene.definition import (
        MeshData, MeshFromData, SceneDefinition,
    )
    from ray_tracer_2_tpu_torch.scene.material import MaterialDefinition
    new = MaterialDefinition.new
    light = new().emissive([1.0, 0.9, 0.7, 1.0], 14.0)

    def mesh(tris, normals):
        return MeshFromData(MeshData.from_vertices(
            tris.reshape(-1, 3), np.asarray(normals, np.float32)))

    def flat(tris, n):
        return mesh(tris, np.tile(n, (len(tris) * 3, 1)))

    s = SceneDefinition()
    look = ([0.0, 1.2, 4.0], [0.0, 0.8, 0.0])
    if name == "cone":
        s.set_camera(CameraDescriptor(
            transform=Transform.cam([0.0, 6.0, 1.5], [0.0, 0.0, 0.0]),
            fov=25.0, focus_dist=5.0))
        s.add_sphere([0.0, -100.0, 0.0], 100.0,
                     MaterialDefinition(color=(0.6, 0.55, 0.5, 1.0)))
        s.add_sphere([0.0, 2.0, 0.0], 0.5, MaterialDefinition(
            emission_color=(1.0, 0.9, 0.7, 1.0), emission_strength=10.0))
        return s
    if name == "emissive_glass":
        s.set_camera(CameraDescriptor(
            transform=Transform.cam([0.0, 1.0, 4.0], [0.0, 1.0, 0.0]),
            fov=45.0, focus_dist=4.0))
        glass_sun = new().emissive([1.0, 0.9, 0.7, 1.0], 10.0).glass(1.5)
        s.add_sphere([0.0, 3.0, 0.0], 0.5, glass_sun)
        s.add_mesh(Transform(), flat(_quad(2.0, 0.5, True), [0, -1, 0]),
                   glass_sun)
        return s
    s.set_camera(CameraDescriptor(transform=Transform.cam(*look), fov=45.0,
                                  focus_dist=4.0))
    soup = _uv_sphere()
    if name == "light_in_instance":
        soup = soup * 0.8 + np.array([0, 0.8, 0], np.float32)
        s.add_mesh(Transform(), mesh(soup, soup.reshape(-1, 3)),
                   new().with_color([0.75, 0.35, 0.25, 1.0]))
        lt = np.asarray([[[-0.8, 3, -0.8], [0.8, 3, -0.8], [0.8, 3, 0.8]],
                         [[-0.8, 3, -0.8], [0.8, 3, 0.8], [-0.8, 3, 0.8]]],
                        np.float32)
        s.add_mesh(Transform(), flat(lt, [0, -1, 0]), light)
        return s
    if name == "traversal":
        s.add_mesh(Transform(pos=[0.0, 0.8, 0.0], scale=[0.8] * 3),
                   mesh(soup, soup.reshape(-1, 3)),
                   new().with_color([0.75, 0.35, 0.25, 1.0]))
    elif name == "view_far":
        s.add_mesh(Transform(pos=[500.0, 0.0, 0.0]),
                   mesh(soup, soup.reshape(-1, 3)), new().with_color([0.5] * 4))
    s.add_mesh(Transform(), flat(_quad(0.0, 6.0, False), [0, 1, 0]),
               new().with_color([0.7, 0.7, 0.7, 1.0]))
    light_t = Transform(scale=[-1.0, 1.0, 1.0]) \
        if name == "mirrored_light" else Transform()
    s.add_mesh(light_t, flat(_quad(3.0, 0.8, True), [0, -1, 0]), light)
    if name not in ("traversal", "view", "view_far", "plain_light",
                    "mirrored_light"):
        raise KeyError(name)
    return s


# ---- a textured scene at unit scale, written against the port's API
def _grid(cells: int, size: float, uv_span: tuple):
    """A square floor at y = 0 facing +y, ``cells`` x ``cells`` quads of two
    triangles, its UVs from ``uv_span[0]`` to ``uv_span[1]`` (past [0, 1]:
    the sampler's wrap)."""
    from ray_tracer_2_tpu_torch.scene.definition import MeshData
    s = np.linspace(-size / 2, size / 2, cells + 1)
    t = np.linspace(uv_span[0], uv_span[1], cells + 1)
    tris, uvs = [], []
    for i in range(cells):
        for j in range(cells):
            p = [[s[i], 0.0, s[j]], [s[i + 1], 0.0, s[j]],
                 [s[i + 1], 0.0, s[j + 1]], [s[i], 0.0, s[j + 1]]]
            q = [[t[i], t[j]], [t[i + 1], t[j]], [t[i + 1], t[j + 1]],
                 [t[i], t[j + 1]]]
            for a, b, c in ((0, 2, 1), (0, 3, 2)):   # facing +y
                tris += [p[a], p[b], p[c]]
                uvs += [q[a], q[b], q[c]]
    pos = np.asarray(tris, np.float32)
    return MeshData.from_vertices(pos, np.tile([0.0, 1.0, 0.0], (len(pos), 1)),
                                  np.asarray(uvs, np.float32))


def textured_box(assets, textured=("floor", "wall", "sphere"), cells=12,
                 floor_normal_map=False) -> SceneDefinition:
    """A floor grid (``cells`` x ``cells`` quads; 288 triangles at 12, a
    wide BVH, with the light's 2 triangles in its group), a wall quad
    (``MeshData.quad``, a brute-force group), a sphere and a quad light;
    the parts named in ``textured`` sample seeded images, and with
    ``floor_normal_map`` the floor a seeded normal map."""
    from ray_tracer_2_tpu_torch.math.transform import Transform
    from ray_tracer_2_tpu_torch.scene import scenes
    from ray_tracer_2_tpu_torch.scene.camera import CameraDescriptor
    from ray_tracer_2_tpu_torch.scene.definition import (
        MeshData, MeshFromData, SceneDefinition,
    )
    from ray_tracer_2_tpu_torch.scene.material import MaterialDefinition
    images = {"floor": (64, 1, 64), "wall": (32, 2, 64), "sphere": (64, 3, 128)}
    mats = {}
    for part, base in (("floor", [0.7, 0.7, 0.7, 1.0]),
                       ("wall", [0.6, 0.6, 0.8, 1.0]),
                       ("sphere", [0.8, 0.5, 0.4, 1.0])):
        mat = MaterialDefinition.new().with_color(base)
        if part in textured:
            size, seed, width = images[part]
            assets.add_texture(f"box_{part}",
                               scenes.seeded_image(size, seed, width))
            mat = mat.textured(f"box_{part}")
        mats[part] = mat
    if floor_normal_map:
        rng = np.random.default_rng(9)
        n = rng.normal(size=(32, 32, 3)) * [0.35, 0.35, 0.0] + [0, 0, 1]
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        img = np.ones((32, 32, 4), np.float32)
        img[..., :3] = np.round((n * 0.5 + 0.5) * 255.0) / 255.0
        assets.add_texture("box_floor_nm", img)
        mats["floor"].normal_texture = "box_floor_nm"
    s = SceneDefinition()
    s.set_camera(CameraDescriptor(
        transform=Transform.cam([0.0, 1.5, 3.5], [0.0, 0.5, 0.0]),
        fov=50.0, focus_dist=3.5))
    s.add_mesh(Transform(), MeshFromData(_grid(cells, 4.0, (-0.5, 2.5))),
               mats["floor"])
    s.add_mesh(Transform(pos=[0.0, 1.0, -2.0], scale=[2.0, 1.0, 1.0]),
               MeshFromData(MeshData.quad(), indices=[0, 1, 2, 0, 2, 3]),
               mats["wall"])
    s.add_sphere([0.6, 0.5, 0.0], 0.5, mats["sphere"])
    light = MeshData.from_vertices(
        [[-0.6, 2.5, -0.6], [0.6, 2.5, 0.6], [0.6, 2.5, -0.6],
         [-0.6, 2.5, -0.6], [-0.6, 2.5, 0.6], [0.6, 2.5, 0.6]],
        [[0.0, -1.0, 0.0]] * 6)
    s.add_mesh(Transform(), MeshFromData(light),
               MaterialDefinition.new().emissive([1.0, 0.9, 0.8, 1.0], 6.0))
    return s


# ---- live edits (tests/test_torch_scene_edit*.py): a case is a scene, how
# the port instantiates it, and edits applied alike to the reference's
# ``HostScene`` and the port's
def quad_instance_scene():
    """The reference's partial-edit scene (tests/test_scene_edit.py:87): one
    rotated, stretched quad, in the port's API."""
    from ray_tracer_2_tpu_torch.math.transform import Transform, \
        quat_rotate_y
    from ray_tracer_2_tpu_torch.scene.camera import CameraDescriptor
    from ray_tracer_2_tpu_torch.scene.definition import (
        MeshData, MeshFromData, SceneDefinition,
    )
    from ray_tracer_2_tpu_torch.scene.material import MaterialDefinition
    s = SceneDefinition()
    s.set_camera(CameraDescriptor(
        transform=Transform.cam([0, 1, 4], [0, 0.5, 0]), fov=45.0,
        focus_dist=4.0))
    s.add_mesh(Transform(pos=[0, 0.5, 0], rot=quat_rotate_y(0.6),
                         scale=[2.0, 1.0, 1.0]),
               MeshFromData(MeshData.quad(), indices=[0, 1, 2, 0, 2, 3]),
               MaterialDefinition.new().with_color([0.9, 0.2, 0.2, 1.0]))
    return s


def _rot_y(angle):
    from ray_tracer_2_tpu_torch.math.transform import quat_rotate_y
    return quat_rotate_y(angle)


#: name -> (scene builder name in ``scenes`` or a function, port
#: instantiation options, edits (kind, index, arguments), render options).
#: Material ids of these asset-free scenes are entity indices.
EDIT_CASES = {
    "metal_sphere": ("metal", {}, [
        ("sphere", 1, dict(centre=[0.0, 5.0, -1.0])),
        ("sphere", 2, dict(radius=0.3))], {}),
    "random_balls_sphere_bvh": ("random_balls", dict(sphere_bvh=True), [
        ("sphere", 3, dict(centre=[0.2, 1.5, 0.4])),
        ("sphere", 40, dict(radius=0.6))], {}),
    "wide_colour": ("wide_bvh_scene", {}, [
        ("material", 0, dict(color=(0.1, 0.2, 0.9, 1.0), smoothness=0.2))],
        {}),
    "wide_glass": ("wide_bvh_scene", {}, [
        ("material", 0, dict(flag=1, ior=1.5))], {}),
    "wide_emitter": ("wide_bvh_scene", {}, [
        ("material", 1, dict(emission_color=(1.0, 0.9, 0.8, 1.0),
                             emission_strength=4.0))], dict(nee=True)),
    "quad_instance_partial": (quad_instance_scene, {}, [
        ("instance", 0, dict(pos=[0.3, 0.5, 0.0])),
        ("instance", 0, dict(rot=_rot_y(1.2))),
        ("instance", 0, dict(scale=[1.5, 1.0, 1.0])),
        ("instance", 0, dict(transform=dict(pos=[0.0, 0.4, 0.1])))], {}),
    # instances 2 and 3 share the tables of 0 and 1 (material-id delta 2)
    "shared_material": ("instances_scene", {}, [
        ("material", 2, dict(color=(0.1, 0.9, 0.1, 1.0))),
        ("material", 2, dict(flag=1, ior=1.4)),
        ("material", 3, dict(flag=1, ior=1.4))], {}),
    "balls_lights": ("balls", {}, [
        ("sphere", 1, dict(centre=[9.0, 9.0, 9.0])),
        ("sphere", 5, dict(centre=[1.0, 2.0, 3.0])),
        ("material", 5, dict(emission_strength=0.0))], dict(nee=True)),
    "room_lights": ("room", {}, [
        ("instance", 0, dict(pos=[0.0, 1.0, 0.0]))], dict(nee=True)),
}


def scene_builder(name_or_fn):
    from ray_tracer_2_tpu_torch.scene import scenes
    return getattr(scenes, name_or_fn) if isinstance(name_or_fn, str) \
        else name_or_fn


def apply_edits(host, edits) -> None:
    """Apply ``edits`` to a ``HostScene`` of either package (a whole
    transform given as ``Transform`` arguments of that package)."""
    for kind, index, kw in edits:
        if kind == "sphere":
            host.edit_sphere(index, **kw)
        elif kind == "material":
            host.edit_material(index, **kw)
        else:
            kw = dict(kw)
            if "transform" in kw:
                kw["transform"] = type(host.inst_transforms[0])(
                    **kw["transform"])
            host.edit_instance_transform(index, **kw)


def edit_pair(case: str, monkeypatch, edited: bool = True):
    """(reference ``HostScene``, port ``HostScene``) of ``EDIT_CASES[case]``,
    both edited (unless ``edited`` is False). The reference reads its
    sphere-BVH choice from ``RT2_SPHERE_BVH``, set here when the port's is
    forced."""
    build, port_kw, edits, _ = EDIT_CASES[case]
    if port_kw.get("sphere_bvh"):
        monkeypatch.setenv("RT2_SPHERE_BVH", "1")
    ref, port = host_scene_pair(scene_builder(build)(), **port_kw)
    monkeypatch.delenv("RT2_SPHERE_BVH", raising=False)
    if edited:
        apply_edits(ref, edits)
        apply_edits(port, edits)
    return ref, port


#: the edit cases whose renders tests/test_torch_scene_edit_render.py holds;
#: tests/test_torch_scene_edit_render_materials.py holds the rest
GEOMETRY_EDITS = ("metal_sphere", "random_balls_sphere_bvh",
                  "quad_instance_partial", "room_lights", "balls_lights")


def check_edited_render(case: str, monkeypatch) -> None:
    """The port's plain render of an edited scene against JAX's XLA
    boundary at W x H, frame 1: at bounces 0 class (b), segments exact and
    >= 99% of pixels within 1e-5; at bounces 2 class (c) as the XLA
    boundary holds it, segments within 0.5% and >= 99% of pixels."""
    ref, port = edit_pair(case, monkeypatch)
    options = EDIT_CASES[case][3]
    for bounces, seg_tol in ((0, 0.0), (2, 0.005)):
        a, sa = ref_render(ref.render_scene, 1, fused=False, bounces=bounces,
                           **options)
        b, sb = port_render(port.scene, 1, bounces=bounces, **options)
        assert np.isfinite(b).all()
        assert abs(sa - sb) <= seg_tol * sa, (bounces, sa, sb)
        assert frac_within(a, b) >= 0.99, (bounces, frac_within(a, b))
