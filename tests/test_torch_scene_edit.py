"""Live scene edits (``HostScene.edit_sphere``, ``edit_material``,
``edit_instance_transform``) against the reference's.

* **Tables.** Both packages instantiate one definition and take the same
  edits in the same order (``torch_bridge.EDIT_CASES``: sphere moves and
  radii, on ``metal`` and on ``random_balls`` with the sphere BVH, whose
  rows are rebuilt; a colour, a glass toggle (the cull flags repacked) and
  a new emitter on the asset-free wide-BVH scene; partial and whole
  instance transforms; material edits of an instance that shares its
  tables; the light table after sphere, material and instance edits).
  Every field of the port's ``TorchScene``, its statics and light table
  included, must equal the reference ``RenderScene``'s byte for byte, and
  the host state (records, transforms, material ids) must agree.
* **Derived tables.** The tables the kernels keep with a scene
  (``TorchScene.derive``: ``megakernel_tables``, ``nee_lights``, every
  brute-force table, ``small_tables``, ``small_scene``, ``debug_brute``),
  built before an edit, must equal after it what a scene freshly
  instantiated from the edited definition builds: after a sphere move in
  each sphere form, a glass toggle (cull flags and form flags), a new
  emitter (the light table and the NEE form), an instance move on a small
  scene and on a wide-BVH scene. Each kind of write makes again, writes in
  place or keeps each table as its builder declares.
* **Threads.** Edits from many threads while frames render through
  ``Engine`` lose no write.

The renders of the edited scenes are in tests/test_torch_scene_edit_render.py.
"""
import dataclasses
import os
import sys
import threading

import numpy as np
import pytest
import torch

from ray_tracer_2_tpu_torch.engine.engine import Engine
from ray_tracer_2_tpu_torch.engine.renderer import small_scene
from ray_tracer_2_tpu_torch.kernels import spheres
from ray_tracer_2_tpu_torch.kernels.brute import pack_brute_table
from ray_tracer_2_tpu_torch.kernels.debug import debug_brute_rows
from ray_tracer_2_tpu_torch.kernels.megakernel import (
    _brute_ranges, finite_boxes, kernel_tables, light_tables, nee_mode,
)
from ray_tracer_2_tpu_torch.scene import scenes
from ray_tracer_2_tpu_torch.scene.definition import SphereDef
from ray_tracer_2_tpu_torch.scene.render_scene import (
    FIELDS, MAX_NEE_LIGHTS, STATICS, TorchScene, instantiate_host_scene,
)
from torch_bridge import (  # noqa: F401
    EDIT_CASES, apply_edits, edit_pair, one_torch_thread, ref_field,
)


def _assert_tables_equal(rs, ts):
    for f in FIELDS:
        want = ref_field(rs, f)
        got = (ts.tex_texels if f == "tex_texels" else getattr(ts, f)).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, f
        assert np.array_equal(got, want), f
    for k in STATICS:
        want = getattr(rs, k)
        assert getattr(ts, k) == (tuple(want) if isinstance(want, tuple)
                                  else want), k


@pytest.mark.parametrize("case", sorted(EDIT_CASES))
def test_edited_tables_match_reference(case, monkeypatch):
    ref, port = edit_pair(case, monkeypatch)
    _assert_tables_equal(ref.render_scene, port.scene)
    assert [dataclasses.asdict(r) for r in port.records] == \
        [dataclasses.asdict(r) for r in ref.records]
    for a, b in zip(port.inst_transforms, ref.inst_transforms):
        for f in ("pos", "rot", "scale"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert port.inst_material_ids == ref.inst_material_ids
    # the host copies the edits keep agree with the device tables
    for k, v in port._mirror.items():
        assert np.array_equal(v, getattr(port.scene, k).numpy()), k


def test_unedited_host_state_matches_reference(monkeypatch):
    """What instantiation leaves for the edits: records, transforms,
    material ids and the staged groups (shared groups list every sharing
    instance's delta)."""
    ref, port = edit_pair("shared_material", monkeypatch, edited=False)
    assert [dataclasses.asdict(r) for r in port.records] == \
        [dataclasses.asdict(r) for r in ref.records]
    assert port.inst_material_ids == ref.inst_material_ids
    assert len(port._staging) == len(ref._staging) == 2
    for a, b in zip(port._staging, ref._staging):
        for x, y in zip(a[1:5], b[1:5]):
            assert np.array_equal(x, y)
        assert a[5:] == b[5:]


def test_partial_instance_edit_keeps_the_rest(monkeypatch):
    """Moving an instance keeps its rotation and scale (the reference's
    tests/test_scene_edit.py:87), and the matrix is rebuilt from the
    merged transform."""
    from ray_tracer_2_tpu_torch.math.transform import Transform, \
        quat_rotate_y
    _, port = edit_pair("quad_instance_partial", monkeypatch, edited=False)
    rot0 = quat_rotate_y(0.6)
    port.edit_instance_transform(0, pos=[0.3, 0.5, 0.0])
    t = port.inst_transforms[0]
    np.testing.assert_allclose(t.rot, rot0, atol=1e-6)
    np.testing.assert_allclose(t.scale, [2.0, 1.0, 1.0], atol=1e-6)
    want = Transform(pos=[0.3, 0.5, 0.0], rot=rot0,
                     scale=[2.0, 1.0, 1.0]).to_matrix()
    assert np.array_equal(port.scene.inst_model_to_world[0].numpy(), want)
    port.edit_instance_transform(0, rot=quat_rotate_y(1.2))
    np.testing.assert_allclose(port.inst_transforms[0].pos, [0.3, 0.5, 0.0])


def test_light_table_follows_edits(monkeypatch):
    """The reference's tests/test_nee.py:111: an edit of a non-emissive
    sphere leaves the table as it was (the same scene object: nothing
    recompiles, nothing is rebuilt), moving the sun moves its row, dimming
    it to zero empties the table."""
    _, host = edit_pair("balls_lights", monkeypatch, edited=False)
    base, scene0 = host.scene.lights, host.scene
    assert len(base) == 1 and base[0][0] == 1
    host.edit_sphere(1, centre=[9.0, 9.0, 9.0])
    assert host.scene is scene0 and host.scene.lights == base
    host.edit_sphere(5, centre=[1.0, 2.0, 3.0])
    assert host.scene.lights[0][1:4] == (1.0, 2.0, 3.0)
    host.edit_material(5, emission_strength=0.0)
    assert host.scene.lights == ()


def test_sphere_bvh_edit_past_the_stack_raises(monkeypatch):
    """A sphere edit whose rebuilt tree would pass the kernel's stack
    raises and leaves the scene as it was."""
    import ray_tracer_2_tpu_torch.kernels.megakernel as mk
    host = instantiate_host_scene(scenes.random_balls(), sphere_bvh=True)
    before = host.scene.sphere_pos.clone()
    monkeypatch.setattr(mk, "MAX_STACK", host.scene.wide_depth + 1)
    with pytest.raises(NotImplementedError, match="levels"):
        host.edit_sphere(3, centre=[0.0, 9.0, 0.0])
    assert torch.equal(host.scene.sphere_pos, before)


# --------------------------------------------------------- derived tables
def _plain(x):
    if isinstance(x, torch.Tensor):
        return x.numpy().copy()     # not a view: edits write in place
    if isinstance(x, spheres.SmallTables):
        return {f.name: getattr(x, f.name).numpy().copy()
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


def _tables(scene) -> dict:
    """Every table the next frame's kernels read, through the builders
    that keep them with the scene, by key (``debug_brute`` where the debug
    kernel stages its own rows)."""
    tab = kernel_tables(scene)
    out = {"megakernel_tables": tab, "small_scene": small_scene(scene),
           "finite_boxes": finite_boxes(scene)}
    if tab["staged"]:
        out["debug_brute"] = debug_brute_rows(scene, tab)
    if scene.lights:
        out["nee_lights"] = light_tables(scene)
    for off, cnt in _brute_ranges(scene):
        out[("brute_table", off, cnt)] = pack_brute_table(scene, off, cnt)
    if spheres.eligible(scene):
        out["small_tables"] = spheres.pack_tables(scene)
    return out


def _derived(scene) -> dict:
    """``_tables`` and the NEE form, as host copies."""
    return _plain({**_tables(scene), "nee_mode": nee_mode(scene, True)})


def _assert_same_tree(a, b, where=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same_tree(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b), where
    else:
        assert a == b, where


def _differs(a, b) -> bool:
    try:
        _assert_same_tree(a, b)
    except AssertionError:
        return True
    return False


def _edit_definition(definition, host, kind, index, kw) -> None:
    """Make ``definition`` the edited scene's (the material id of an
    entity of these scenes is its index); call after the edit."""
    ents = definition.entities
    if kind == "sphere":
        e = ents[int(host.scene.sphere_mat[index])]
        e.primitive = SphereDef(
            np.asarray(kw.get("centre", e.primitive.centre), np.float32),
            float(kw.get("radius", e.primitive.radius)))
    elif kind == "material":
        ents[index].material = dataclasses.replace(ents[index].material, **kw)
    else:   # every mesh entity of the instance's group (here: all of them)
        for e in ents:
            if not isinstance(e.primitive, SphereDef):
                e.transform = host.inst_transforms[index].copy()


DERIVED_CASES = {
    "metal_sphere_dense": ("metal", {}, ("sphere", 1, dict(
        centre=[0.2, 0.1, -1.2], radius=0.45))),
    "random_balls_sphere_shared_term": ("random_balls", {}, ("sphere", 7, dict(
        centre=[0.5, 0.3, 1.0], radius=0.25))),
    "random_balls_sphere_bvh": ("random_balls", dict(sphere_bvh=True), (
        "sphere", 7, dict(centre=[0.5, 0.3, 1.0], radius=0.25))),
    "room_glass_toggle": ("room", {}, ("material", 0, dict(flag=1, ior=1.5))),
    "room_new_emitter": ("room", {}, ("material", 1, dict(
        emission_color=(1.0, 1.0, 1.0, 1.0), emission_strength=2.0))),
    "room_instance_small_scene": ("room", {}, ("instance", 0, dict(
        pos=[0.1, 0.2, 0.0]))),
    "wide_instance": ("wide_bvh_scene", {}, ("instance", 0, dict(
        pos=[0.1, 0.6, 0.0]))),
    "wide_glass_toggle": ("wide_bvh_scene", {}, ("material", 0, dict(
        flag=1, ior=1.5))),
}


@pytest.mark.parametrize("case", sorted(DERIVED_CASES))
def test_derived_tables_match_a_fresh_scene(case):
    build, kw, (kind, index, args) = DERIVED_CASES[case]
    definition = getattr(scenes, build)()
    host = instantiate_host_scene(definition, **kw)
    before = _derived(host.scene)
    apply_edits(host, [(kind, index, args)])
    _edit_definition(definition, host, kind, index, args)
    got = _derived(host.scene)
    fresh = instantiate_host_scene(definition, **kw)
    _assert_same_tree(got, _derived(fresh.scene))
    if kind != "material" or "small_tables" in got or got["nee_mode"]:
        assert _differs(got, before)   # the edit reached what frames read


def test_glass_toggle_rederives_the_form():
    """A glass toggle flips the brute-force cull flags and compiles the
    glass branch in; an edit that changes nothing re-derives nothing."""
    host = instantiate_host_scene(scenes.room())
    tab = kernel_tables(host.scene)
    room_brute = pack_brute_table(host.scene, 0, 12)
    assert (room_brute[:, 10] == 1.0).all()
    host.edit_material(0, flag=0)      # the same flag: nothing re-derived
    assert kernel_tables(host.scene) is tab
    host.edit_material(0, flag=1, ior=1.5)
    tab2 = kernel_tables(host.scene)
    assert tab2 is not tab and tab2["glass"]
    cull = pack_brute_table(host.scene, 0, 12)[:, 10]
    mats = host.scene.tri_mat[:12]
    assert torch.equal(cull, (mats != 0).to(torch.float32))


#: what each kind of write does to the tables the kernels keep (by the
#: key's name): the kinds that make each again ...
STALE_ON = {
    "megakernel_tables": {"material_form"},
    "nee_lights": {"lights"},
    "small_tables": {"sphere", "instance", "material", "material_form"},
    "brute_table": {"material_form"},
    "debug_brute": {"material_form"},
    "small_scene": {"material_form"},
    # with a sphere BVH, whose rows a sphere edit rewrites; else none
    "finite_boxes": {"sphere"},
}
#: ... and the megakernel table's columns each writes in place
REFRESHED = {"scal": "camera", "spheres": "sphere", "inst": "instance"}
KINDS = ("camera", "sphere", "instance", "material", "material_form",
         "lights")
KIND_SCENES = {
    "room": ("room", {}),
    "random_balls_shared_term": ("random_balls", {}),
    "random_balls_sphere_bvh": ("random_balls", dict(sphere_bvh=True)),
    "wide": ("wide_bvh_scene", {}),
}
#: a small, non-emissive sphere of each scene
_SPHERE = {"room": 1, "random_balls": 7, "wide_bvh_scene": 0}


def _kind_edit(kind: str, build: str):
    """An edit (``apply_edits``' form) that writes ``kind`` on a scene of
    ``build``; None for a camera move. The light table moves with room's
    one instance, on random_balls with a new emitter (also a
    ``material_form`` write)."""
    if kind == "sphere":
        return ("sphere", _SPHERE[build], dict(centre=[0.5, 0.3, 1.0],
                                               radius=0.25))
    if kind == "instance" or (kind == "lights" and build == "room"):
        return ("instance", 0, dict(pos=[0.1, 0.2 + (kind == "lights"),
                                         0.0]))
    if kind == "material":
        return ("material", 0, dict(color=(0.1, 0.2, 0.9, 1.0)))
    if kind == "material_form":
        return ("material", 0, dict(flag=1, ior=1.5))
    if kind == "lights":    # a diffuse sphere: glass emits no light
        return ("material", 2, dict(emission_color=(1.0, 1.0, 1.0, 1.0),
                                    emission_strength=2.0))
    return None


#: random_balls has no instance; wide_bvh_scene's one emitter could be its
#: sphere, whose area an edit takes from the float32 radius and a fresh
#: scene from the definition's float (as in the reference)
@pytest.mark.parametrize("kind,scene", [
    (k, s) for k in KINDS for s in KIND_SCENES
    if (k, s[:6]) not in {("instance", "random"), ("lights", "wide")}])
def test_each_write_kind_rebuilds_refreshes_or_keeps(kind, scene,
                                                     monkeypatch):
    """After a write of ``kind`` (and of any kind the edit also makes), the
    next lookup of each kernel table makes it again (a new object) where
    its builder names the kind, writes the megakernel table's columns of
    that kind in place (the same tensors, the same storage) and keeps
    everything else as the same object with the same values; every table
    then equals a fresh scene's of the edited definition."""
    build, kw = KIND_SCENES[scene]
    definition = getattr(scenes, build)()
    host = instantiate_host_scene(definition, **kw)
    before = _tables(host.scene)
    tab0 = before["megakernel_tables"]
    cols = {c: (tab0[c], tab0[c].data_ptr(), tab0[c].clone())
            for c in REFRESHED}
    version = host.scene.writes.version
    built, derive = [], TorchScene.derive

    def counted(self, key, make, **kw):
        def made():
            built.append(key)
            return make()
        return derive(self, key, made, **kw)

    monkeypatch.setattr(TorchScene, "derive", counted)
    edit = _kind_edit(kind, build)
    if edit is None:
        host.camera.transform.pos = host.camera.transform.pos \
            + np.float32(0.05)
        host.refresh_camera()
    else:
        apply_edits(host, [edit])
        _edit_definition(definition, host, *edit)
    noted = host.scene.writes.since(version) & set(KINDS)
    assert kind in noted
    after = _tables(host.scene)
    for key, table in after.items():
        name = key[0] if isinstance(key, tuple) else key
        stale = STALE_ON[name] if name != "finite_boxes" \
            or host.scene.sphere_bvh_root >= 0 else set()
        if stale & noted:
            assert key in built, key
            if not isinstance(table, bool):
                assert table is not before.get(key), key
        else:
            assert key not in built and table is before[key], key
    if "material_form" not in noted:
        for col, (t, ptr, old) in cols.items():
            assert tab0[col] is t and t.data_ptr() == ptr, col
            if REFRESHED[col] not in noted:
                assert torch.equal(t, old), col
    fresh = instantiate_host_scene(definition, **kw)
    _assert_same_tree(_plain(after), _plain(_tables(fresh.scene)))


def test_too_many_lights_empty_the_table():
    """An edit that makes more than MAX_NEE_LIGHTS primitives emissive
    leaves the scene without a light table (NEE off), as the reference."""
    host = instantiate_host_scene(scenes.wide_bvh_scene())
    host.edit_material(0, emission_color=(1.0, 1.0, 1.0, 1.0),
                       emission_strength=1.0)
    assert host.n_triangles > MAX_NEE_LIGHTS and host.scene.lights == ()


def test_concurrent_edits_lose_no_write():
    """More editing threads than cores move spheres while the main thread
    renders frames through ``Engine``; the scene's lock must keep every
    last write: each sphere ends where its thread last put it, in the
    tensors, in the host copies and in the megakernel's sphere table."""
    eng = Engine(width=16, height=8, initial_scene=None, device="cpu")
    # with the sphere BVH, whose rows each edit rebuilds on the host (a
    # wide window between reading and writing the host copies)
    host = eng.scene_manager.scene = instantiate_host_scene(
        scenes.random_balls(half=4), sphere_bvh=True)
    kernel_tables(host.scene)
    n_threads, n_edits = (os.cpu_count() or 4) + 4, 20
    want = {}

    def mover(t):
        for k in range(n_edits):
            c = [float(t), 0.1 * k, 2.0]
            host.edit_sphere(10 + t, centre=c)
        want[10 + t] = c

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=mover, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        while any(th.is_alive() for th in threads):
            eng.update(dt=0.01)
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(prev)
        eng.scene_manager.shutdown()
    pos = host.scene.sphere_pos.numpy()
    table = kernel_tables(host.scene)["spheres"].numpy()
    for i, c in want.items():
        assert np.array_equal(pos[i], np.float32(c)), i
        assert np.array_equal(host._mirror["sphere_pos"][i], np.float32(c))
        assert np.array_equal(table[i, 0:3], np.float32(c)), i
    host.scene.derived.pop("megakernel_tables")
    assert np.array_equal(kernel_tables(host.scene)["spheres"].numpy(),
                          table)
