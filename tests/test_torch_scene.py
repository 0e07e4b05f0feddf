"""The port's scene instantiation against the reference's, byte for byte.

Both packages turn the same scene definition into the same host tables
(SAH BVH, 32-ary wide rows with f16 child boxes, quad-packed attributes,
packed materials, camera, texel atlas): every slice field must be
``np.array_equal`` with the same dtype, and the static fields equal. The
atlas words, which the reference keeps bit-cast to float32 and the port as
int32, are compared as bytes. Scenes from asset files go through each
package's own asset manager: the procedural substitutes of sponza and
bugatti, an OBJ with an MTL and a ``map_Kd`` texture written to
``tmp_path``, two instances of one file (one table between them), and the
textured atrium.
"""
import dataclasses

import numpy as np
import pytest
import torch

import ray_tracer_2_tpu.assets.manager as ref_manager
import ray_tracer_2_tpu.math.transform as ref_transform
import ray_tracer_2_tpu.scene.camera as ref_camera
import ray_tracer_2_tpu.scene.definition as ref_definition
import ray_tracer_2_tpu.scene.material as ref_material
from ray_tracer_2_tpu.scene import scenes as ref_scenes
from ray_tracer_2_tpu.scene.render_scene import \
    instantiate_scene as ref_instantiate
import ray_tracer_2_tpu_torch.math.transform as port_transform
import ray_tracer_2_tpu_torch.scene.camera as port_camera
import ray_tracer_2_tpu_torch.scene.definition as port_definition
import ray_tracer_2_tpu_torch.scene.material as port_material
import ray_tracer_2_tpu_torch.assets.manager as port_manager
from ray_tracer_2_tpu_torch.accel.bvh import NATIVE_MIN_TRIS
from ray_tracer_2_tpu_torch.math.transform import Transform
from ray_tracer_2_tpu_torch.scene import scenes
from ray_tracer_2_tpu_torch.scene.definition import MeshFromFile
from ray_tracer_2_tpu_torch.scene.render_scene import (
    FIELDS, SPHERE_BVH_MIN, STATICS, TorchScene, instantiate_scene,
)
import torch_bridge
from torch_bridge import torch_scene, wide_bvh_render_scene

REF = (ref_transform, ref_camera, ref_definition, ref_material)
PORT = (port_transform, port_camera, port_definition, port_material)


def _dragon_bench_definition(api, positions, normals):
    """One mesh under bench.dragon_scene's camera, transform, material and
    ground sphere, written against either package's API."""
    transform, camera, definition, material = api
    s = definition.SceneDefinition()
    s.set_camera(camera.CameraDescriptor(
        transform=transform.Transform.cam([0.0, 1.0, 4.0], [0.0, 0.7, 0.0]),
        fov=40.0, focus_dist=4.0))
    s.add_mesh(transform.Transform(pos=[0.0, 0.6, 0.0],
                                   rot=transform.quat_rotate_y(-1.5708),
                                   scale=[3.0, 3.0, 3.0]),
               definition.MeshFromData(
                   definition.MeshData.from_vertices(positions, normals)),
               material.MaterialDefinition.new()
               .with_color([0.96078, 0.11372, 0.4039, 1.0])
               .smooth(0.8).specular_([1.0] * 4, 0.015))
    s.add_sphere([0.0, -1000.0, 0.0], 1000.0,
                 material.MaterialDefinition.new()
                 .with_color([0.5, 0.5, 0.5, 1.0]))
    return s


def _latlon(lat, lon):
    """The soup of __graft_entry__._wide_bvh_scene, quad by quad: unit
    positions, which are also the normals."""
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
    return np.asarray(quads, np.float32).reshape(-1, 3)


def _torus(nu, nv, big=0.3, small=0.12):
    """Torus soup, 2 * nu * nv triangles: non-convex, so the SAH splits
    see overlapping and nested boxes."""
    u = np.linspace(0.0, 2 * np.pi, nu + 1)
    v = np.linspace(0.0, 2 * np.pi, nv + 1)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    n = np.stack([np.cos(vv) * np.cos(uu), np.sin(vv),
                  np.cos(vv) * np.sin(uu)], axis=-1)
    ring = np.stack([np.cos(uu), np.zeros_like(uu), np.sin(uu)], axis=-1)
    pos = big * ring + small * n
    def tris(g):
        a, b, c, d = g[:-1, :-1], g[1:, :-1], g[1:, 1:], g[:-1, 1:]
        return np.stack([np.stack([a, b, c], -2), np.stack([a, c, d], -2)],
                        -3).reshape(-1, 3)
    return tris(pos).astype(np.float32), tris(n).astype(np.float32)


def _random_soup(n, seed):
    """n small triangles scattered through a box, with random unit normals:
    overlapping, unconnected geometry made from a seed."""
    rng = np.random.default_rng(seed)
    centre = rng.uniform(-0.3, 0.3, size=(n, 1, 3))
    pos = centre + rng.normal(scale=0.02, size=(n, 3, 3))
    nrm = rng.normal(size=(n, 3, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    return (pos.reshape(-1, 3).astype(np.float32),
            nrm.reshape(-1, 3).astype(np.float32))


def _fields(ts: TorchScene) -> dict:
    return {f: getattr(ts, f).numpy() for f in FIELDS}


def _assert_same(rs, ts: TorchScene):
    got = _fields(ts)
    for f in FIELDS:
        want = torch_bridge.ref_field(rs, f)
        assert got[f].dtype == want.dtype, f
        assert got[f].shape == want.shape, f
        assert np.array_equal(got[f], want), f
    assert ts.inst_spans == tuple(rs.inst_spans)
    assert ts.wide_roots == tuple(rs.wide_roots)
    assert ts.wide_depth == rs.wide_depth
    assert ts.shade_classes == tuple(rs.shade_classes)
    assert ts.inst_mat_deltas == tuple(rs.inst_mat_deltas)
    assert ts.sphere_bvh_root == rs.sphere_bvh_root
    assert ts.lights == tuple(rs.lights)


# Meshes below NATIVE_MIN_TRIS build their BVH in numpy, the others in the
# C++ builders of both packages.
MESHES = {
    "torus_3840": lambda: _torus(40, 48),
    "torus_10240": lambda: _torus(64, 80),
    "random_2000": lambda: _random_soup(2000, seed=0),
    "random_6000": lambda: _random_soup(6000, seed=1),
}


#: the reference's asset-free built-in scenes, which both packages define
BUILT_IN = ("balls", "metal", "random_balls", "room")


def _two_groups():
    """wide_bvh_scene plus a second instance group of its mesh under
    another transform and material: the tables are shared, the second
    instance carries a material-id delta."""
    s = scenes.wide_bvh_scene()
    s.add_mesh(Transform(pos=[-1.5, 0.4, 0.0], scale=[0.5, 0.5, 0.5]),
               s.entities[0].primitive,
               s.entities[0].material.with_color([0.2, 0.2, 0.9, 1.0]))
    return s


#: several instance groups, written once against the port's API; the
#: reference's definition is made from it (torch_bridge.ref_definition)
GROUPS = {
    "room2_12": lambda: scenes.room2_scene(12, 12),
    "room2_60": lambda: scenes.room2_scene(60, 60),
    "two_groups": _two_groups,
}


@pytest.mark.parametrize("which", ["wide_bvh", "main_path_40",
                                   "main_path_60", *MESHES, *BUILT_IN,
                                   *GROUPS])
def test_instantiate_matches_reference(which):
    """wide_bvh and main_path_n are the port's own scenes; the built-in
    scenes are each package's own copy of one definition; the other meshes
    go through the same definition in both packages. Every field compared,
    the per-triangle tables and ``inst_mat_deltas`` included: room2's two
    dragons share one table (7,200 triangles at 60x60, built by the C++
    builder) with deltas (0, 1, 0)."""
    if which in GROUPS:
        definition = GROUPS[which]()
        rs = ref_instantiate(torch_bridge.ref_definition(definition)) \
            .render_scene
        ts = instantiate_scene(definition)
        assert ts.n_instances >= 2
        assert ts.inst_spans[0] == ts.inst_spans[1]
        assert ts.inst_mat_deltas[0] == 0 < ts.inst_mat_deltas[1]
    elif which in BUILT_IN:
        rs = ref_instantiate(getattr(ref_scenes, which)()).render_scene
        ts = instantiate_scene(getattr(scenes, which)())
    elif which == "wide_bvh":
        rs = wide_bvh_render_scene()
        ts = instantiate_scene(scenes.wide_bvh_scene())
    elif which.startswith("main_path"):
        n = int(which.rsplit("_", 1)[1])
        unit = _latlon(n, n)
        rs = ref_instantiate(_dragon_bench_definition(
            REF, unit * np.float32(scenes.MAIN_PATH_RADIUS), unit)) \
            .render_scene
        ts = instantiate_scene(scenes.main_path_scene(lat=n, lon=n))
        assert rs.inst_spans[0][2] == 2 * n * n
    else:
        pos, nrm = MESHES[which]()
        rs = ref_instantiate(_dragon_bench_definition(REF, pos, nrm)) \
            .render_scene
        ts = instantiate_scene(_dragon_bench_definition(PORT, pos, nrm))
        count = int(which.rsplit("_", 1)[1])
        assert rs.inst_spans[0][2] == count
        assert (count >= NATIVE_MIN_TRIS) == (count > 5000)
    _assert_same(rs, ts)


def test_main_path_scene_size():
    mesh = scenes.main_path_scene().entities[0].primitive.resolved()
    assert mesh.triangle_count() == 80_000


def test_from_numpy_round_trip():
    rs = wide_bvh_render_scene()
    ts = torch_scene(rs)
    _assert_same(rs, ts)
    assert ts.device == torch.device("cpu")
    assert ts.to("cpu") is ts
    again = TorchScene.from_numpy(_fields(ts),
                                  {k: getattr(ts, k) for k in STATICS})
    _assert_same(rs, again)


def _from_file(s):
    s.add_mesh(Transform(pos=[5.0, 0.0, 0.0]), MeshFromFile("Dragon_80K.obj"),
               s.entities[0].material)


def _textured(s):
    s.add_sphere([0.0, 3.0, 0.0], 0.5, dataclasses.replace(
        s.entities[0].material, diffuse_texture="earthmap.png"))


#: ROADMAP Queue 1 item that lifted the refusal -> the file that is missing
_MISSING = {2: "dragon.obj", 3: "earthmap.png"}


@pytest.mark.parametrize("add,item", [(_from_file, 2), (_textured, 3)])
def test_outside_the_slice_raises(add, item):
    """A file the repository lacks raises ``AssetNotFound`` in the port where
    it raises in the reference: ``Dragon_80K.obj`` (its substitute needs
    ``dragon.obj``) and ``earthmap.png``. Meshes from files (item 2) and
    textured materials (item 3) raised ``NotImplementedError`` until they
    were ported; they instantiate (the tests below)."""
    name = _MISSING[item]
    s = scenes.wide_bvh_scene()
    add(s)
    with pytest.raises(port_manager.AssetNotFound, match=name):
        instantiate_scene(s)
    with pytest.raises(ref_manager.AssetNotFound, match=name):
        ref_instantiate(torch_bridge.ref_definition(s))


def test_random_balls_recipe_scales():
    """``random_balls(half=11)`` is the default scene, object for object;
    ``half=24`` the same recipe over a wider field: the same four large
    spheres first, about 2,300 in all, enough for the sphere BVH."""
    a, b = scenes.random_balls(), scenes.random_balls(half=11)
    assert len(a.entities) == len(b.entities) == 485
    for x, y in zip(a.entities, b.entities):
        assert np.array_equal(x.primitive.centre, y.primitive.centre)
        assert x.primitive.radius == y.primitive.radius
        assert x.material == y.material
    big = scenes.random_balls(half=24)
    assert len(big.entities) >= SPHERE_BVH_MIN
    for x, y in zip(a.entities[:4], big.entities[:4]):
        assert np.array_equal(x.primitive.centre, y.primitive.centre)
    ts = instantiate_scene(big)
    assert ts.sphere_bvh_root == 0 and ts.n_instances == 0
    assert ts.wide_rows.shape[0] > ts.n_spheres // 8


@pytest.mark.parametrize("name", ["sponza", "bugatti"])
def test_substitute_scenes_match_reference(name):
    """sponza and bugatti through the procedural substitutes of their OBJ
    files (no file in the repository): the atrium of 41,424 triangles in 10
    parts with ``MaterialRecord()`` (no ``sponza.mtl``), the car of 4,124 in
    5; each one wide-BVH instance beside the quad light's brute-force group
    and an emissive sphere, a 3-row light table."""
    rs = ref_instantiate(getattr(ref_scenes, name)()).render_scene
    ts = instantiate_scene(getattr(scenes, name)())
    _assert_same(rs, ts)
    tris = {"sponza": 41_424, "bugatti": 4_124}[name]
    assert ts.inst_spans[0][2] == tris and ts.inst_spans[1][2] == 2
    assert ts.n_spheres == 1 and len(ts.lights) == 3
    assert ts.shade_classes == ()


_CUBE = """
mtllib cube.mtl
v -1 -1 -1
v 1 -1 -1
v 1 1 -1
v -1 1 -1
v -1 -1 1
v 1 -1 1
v 1 1 1
v -1 1 1
vt 0 0
vt 2 0
vt 2 2
vt 0 2
o cube
usemtl checker
f 5/1 6/2 7/3 8/4
f 2/1 1/2 4/3 3/4
f 1/1 5/2 8/3 4/4
usemtl plain
f 6/1 2/2 3/3 7/4
f 8/1 7/2 3/3 4/4
f 1/1 2/2 6/3 5/4
"""


def _cube_files(tmp_path):
    from PIL import Image
    (tmp_path / "cube.obj").write_text(_CUBE)
    (tmp_path / "cube.mtl").write_text(
        "newmtl checker\nKd 0.9 0.9 0.9\nmap_Kd checker.png\n"
        "newmtl plain\nKd 0.2 0.5 0.3\nNs 100\n")
    rgb = np.random.default_rng(0).integers(0, 256, (16, 24, 3), np.uint8)
    Image.fromarray(rgb).save(tmp_path / "checker.png")


def test_obj_file_scene_matches_reference(tmp_path):
    """An OBJ with an MTL and a ``map_Kd`` texture, twice: the two
    instances share one table (the asset caches hand back the same meshes),
    the second with a material-id delta; the atlas holds the decoded,
    flipped image."""
    _cube_files(tmp_path)
    mat = port_material.MaterialDefinition.texture_from_obj()
    s = scenes.wide_bvh_scene()
    s.add_mesh(Transform(pos=[-1.0, 0.5, -1.0], scale=[0.3] * 3),
               MeshFromFile("cube.obj", use_mtl=True), mat)
    s.add_mesh(Transform(pos=[1.0, 0.5, -1.0], scale=[0.3] * 3),
               MeshFromFile("cube.obj", use_mtl=True), mat)
    ts = instantiate_scene(s, port_manager.AssetManager([tmp_path]))
    rs = ref_instantiate(torch_bridge.ref_definition(s),
                         assets=ref_manager.AssetManager([tmp_path])) \
        .render_scene
    _assert_same(rs, ts)
    assert ts.inst_spans[1] == ts.inst_spans[2] == (ts.inst_spans[1][0],
                                                    1496, 12)
    assert ts.inst_mat_deltas == (0, 0, 2)
    assert ts.shade_classes == ("texture",)
    assert ts.tex_meta[0].tolist() == [0.0, 16.0, 24.0, 0.0]


def test_textured_atrium_matches_reference():
    """``textured_atrium_scene(size=16)``: the ten parts textured from
    seeded images registered in the asset manager, mirrored into the
    reference's."""
    assets = port_manager.AssetManager()
    rs, ts = torch_bridge.ref_scene_pair(
        scenes.textured_atrium_scene(assets, size=16), assets)
    _assert_same(rs, ts)
    assert ts.shade_classes == ("texture", "texture_dominant")
    assert ts.tex_texels.shape == (10 * 16 * 16 // 32 + 2, 128)


def test_texture_budget_matches_reference(monkeypatch):
    """``RT2_TEX_BUDGET_MB`` read at instantiation in both packages: ten
    128 x 128 images (2.6 MB of quad rows) under a 1 MB budget are scaled
    down alike, atlas and slot table byte for byte."""
    monkeypatch.setenv("RT2_TEX_BUDGET_MB", "1")
    assets = port_manager.AssetManager()
    rs, ts = torch_bridge.ref_scene_pair(
        scenes.textured_atrium_scene(assets, size=128), assets)
    _assert_same(rs, ts)
    assert ts.tex_texels.numel() * 4 <= (1 << 20) * 1.05
    assert ts.tex_meta[0, 1:3].tolist() == [81.0, 81.0]
