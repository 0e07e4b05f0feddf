"""The port's asset pipeline against the reference's, on the same inputs.

OBJ/MTL files written to ``tmp_path`` in the patterns of
``tests/test_assets.py`` (negative indices, faces without normals, several
groups and materials, fan triangulation, corners that lack a normal index)
go through both packages' ``load_obj``: every sub-mesh array equal, the MTL
records equal, through the port's C++ tokenizer and through its Python one
(the fallback where g++ cannot build the other). The two tokenizers are
also held against each other.
``material_from_mtl`` is compared field for field, the procedural
substitutes (``subdivide_soup``, ``densify_to``, ``synthesize_sponza``
without ``sponza.mtl``, ``synthesize_f1``) array for array, and the asset
managers' fallbacks, caches and refusals case for case.

The reference's ``load_obj`` runs with ``RT2_NATIVE_OBJ=0`` (its Python
tokenizer), so the reference package builds nothing next to its sources.
"""
import dataclasses

import numpy as np
import pytest
from PIL import Image

from ray_tracer_2_tpu.assets import manager as ref_manager
from ray_tracer_2_tpu.assets import obj as ref_obj
from ray_tracer_2_tpu.assets import procedural as ref_procedural
from ray_tracer_2_tpu_torch.assets import manager as port_manager
from ray_tracer_2_tpu_torch.assets import native as port_native
from ray_tracer_2_tpu_torch.assets import obj as port_obj
from ray_tracer_2_tpu_torch.assets import procedural as port_procedural

#: OBJ files (and the MTL file some of them name) as text
FILES = {
    "negative": """
v 0 0 0
v 1 0 0
v 0 1 0
f -3 -2 -1
v 0 0 1
v 1 0 1
v 0 1 1
f -3 -2 -1
""",
    "no_normals": """
# a pentagon fan and a quad sharing an edge: area-weighted normals
v 0 0 0
v 2 0 0
v 3 1 0
v 1 2 0.5
v -1 1 0
v 2 0 -1
f 1 2 3 4 5
f 1 6 2
""",
    "groups": """
mtllib groups.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0 0 1
v 1 0 1
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
vn 0 0 -1
o box
usemtl red
f 1/1/1 2/2/1 3/3/1 4/4/1
g lid   part two
usemtl glassy
f 1//2 5//2 6//2
usemtl red
f -3/-4/-1 -2/-3/-1 -1/-2/-1
o loose
f 2/2 6/3 3/4
usemtl lamp
f 4 3 6
""",
}
MTL = """
newmtl red   # a comment
Kd 0.8 0.1 0.1
Ks 0.2 0.2 0.2
Ns 25
map_Kd red.png
newmtl glassy
Ns 400.0
Ni 1.52
illum 4
Kd 0.2 0.3 0.4
Ks 0.5 0.6 0.7
newmtl lamp
Ke 2.0 1.0 0.5
map_Disp -bm 0.5 lamp_nm.png
"""


def _write(tmp_path, name: str):
    path = tmp_path / f"{name}.obj"
    path.write_text(FILES[name])
    (tmp_path / "groups.mtl").write_text(MTL)
    return path


def _assert_models_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.name, g.material) == (w.name, w.material)
        for field in ("positions", "normals", "uvs"):
            a, b = getattr(g, field), getattr(w, field)
            assert a.dtype == b.dtype == np.float32, field
            assert np.array_equal(a, b), field


@pytest.mark.parametrize("tokenizer", ["native", "python"])
@pytest.mark.parametrize("name", list(FILES))
def test_load_obj_matches_reference(tmp_path, monkeypatch, name, tokenizer):
    path = _write(tmp_path, name)
    monkeypatch.setenv("RT2_NATIVE_OBJ", "0")
    want_models, want_mtl = ref_obj.load_obj(path)
    if tokenizer == "native":
        assert port_native.get_lib() is not None, "g++ builds the tokenizer"
    else:   # the fallback where g++ cannot build the tokenizer
        monkeypatch.setattr(port_native, "get_lib", lambda: None)
    got_models, got_mtl = port_obj.load_obj(path)
    _assert_models_equal(got_models, want_models)
    assert {k: dataclasses.asdict(v) for k, v in got_mtl.items()} \
        == {k: dataclasses.asdict(v) for k, v in want_mtl.items()}
    if name == "groups":
        assert [m.material for m in got_models] == [
            "red", "glassy", "red", "red", "lamp"]
        assert got_mtl["lamp"].map_disp == "lamp_nm.png"


@pytest.mark.parametrize("name", list(FILES))
def test_native_tokenizer_matches_python(tmp_path, name):
    path = _write(tmp_path, name)
    pos, uv, nrm, groups, mtllibs = port_native.parse_obj_native(path)
    p_pos, p_uv, p_nrm, p_groups, p_mtl = port_obj._parse_obj_python(path)
    for a, b in ((pos, p_pos), (uv, p_uv), (nrm, p_nrm)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert list(groups) == list(p_groups)
    for key in groups:
        assert np.array_equal(groups[key], p_groups[key]), key
    assert mtllibs == (["groups.mtl"] if name == "groups" else [])
    assert set(p_mtl) == ({"red", "glassy", "lamp"} if name == "groups"
                          else set())


def test_material_from_mtl_field_for_field(tmp_path):
    (tmp_path / "m.mtl").write_text(MTL + """
newmtl bare
newmtl opaque_ke
Ke 0 0 0
illum 6
""")
    want = ref_obj.load_mtl(tmp_path / "m.mtl")
    got = port_obj.load_mtl(tmp_path / "m.mtl")
    assert list(got) == list(want)
    for name in want:
        for d, n in ((-1, -1), (3, -1), (-1, 7), (2, 5)):
            r = ref_manager.material_from_mtl(want[name], d, n)
            p = port_manager.material_from_mtl(got[name], d, n)
            assert dataclasses.asdict(p) == dataclasses.asdict(r), (name, d, n)
            assert type(p.flag) is int


def _seeded_soup(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3, 3)).astype(np.float32)
    uv = rng.random((n, 3, 2)).astype(np.float32)
    return v, nrm, uv


def test_subdivide_and_densify_match_reference():
    v, n, uv = _seeded_soup(300, 0)
    mask = np.random.default_rng(1).random(300) < 0.4
    for got, want in zip(port_procedural.subdivide_soup(v, n, uv, mask),
                         ref_procedural.subdivide_soup(v, n, uv, mask)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    for target in (301, 1000, 1234):
        got = port_procedural.densify_to(v, n, uv, target)
        want = ref_procedural.densify_to(v, n, uv, target)
        assert len(got[0]) == len(want[0]) >= target
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def _assert_parts_equal(got, want):
    assert [label for _, _, label in got] == [label for _, _, label in want]
    for (gm, gr, _), (wm, wr, _) in zip(got, want):
        for field in ("positions", "normals", "uvs", "indices"):
            a, b = getattr(gm, field), getattr(wm, field)
            assert a.dtype == b.dtype and np.array_equal(a, b), field
        assert dataclasses.asdict(gr) == dataclasses.asdict(wr)


@pytest.mark.parametrize("synth,tris", [("synthesize_sponza", 41_424),
                                        ("synthesize_f1", 4_124)])
def test_substitutes_match_reference(tmp_path, synth, tris):
    """Without ``sponza.mtl`` every sponza part gets ``MaterialRecord()``;
    the car's parts carry their own materials."""
    got = getattr(port_procedural, synth)(
        port_manager.AssetManager([tmp_path]))
    want = getattr(ref_procedural, synth)(
        ref_manager.AssetManager([tmp_path]))
    _assert_parts_equal(got, want)
    assert sum(m.triangle_count() for m, _, _ in got) == tris
    assert len(got) == (10 if synth == "synthesize_sponza" else 5)


def _png(path, rgb):
    Image.fromarray(np.asarray(rgb, np.uint8)).save(path)


def test_asset_managers_agree(tmp_path):
    """Fallback to the substitutes, the mesh cache (one object per load of
    a file or substitute), the texture slots and their 64-slot limit, and
    what raises ``AssetNotFound``: the same in both packages."""
    rng = np.random.default_rng(0)
    for k in range(65):
        _png(tmp_path / f"t{k}.png", rng.integers(0, 256, (4, 3, 3)))
    _png(tmp_path / "red.png", rng.integers(0, 256, (8, 8, 3)))
    (tmp_path / "m.obj").write_text(FILES["groups"])
    (tmp_path / "groups.mtl").write_text(MTL)
    port = port_manager.AssetManager([tmp_path])
    ref = ref_manager.AssetManager([tmp_path])

    # an OBJ with an MTL: the map_Kd texture loads, the map_Disp one
    # (absent) raises in both
    for mgr, mod in ((port, port_manager), (ref, ref_manager)):
        with pytest.raises(mod.AssetNotFound):
            mgr.load_model("m.obj", use_mtl=True)
    (tmp_path / "lamp_nm.png").write_bytes((tmp_path / "red.png")
                                           .read_bytes())
    port = port_manager.AssetManager([tmp_path])
    ref = ref_manager.AssetManager([tmp_path])
    got = port.load_model("m.obj", use_mtl=True)
    want = ref.load_model("m.obj", use_mtl=True)
    _assert_parts_equal(got, want)
    assert port.loaded_textures == ref.loaded_textures \
        == {"red.png": 0, "lamp_nm.png": 1}
    for slot in (0, 1):
        assert np.array_equal(port.cpu_textures[slot], ref.cpu_textures[slot])
    again = port.load_model("m.obj", use_mtl=False)
    assert [id(m) for m, _, _ in again] == [id(m) for m, _, _ in got]

    # substitutes: built once per manager, handed back as the same objects
    sponza = port.load_model("sponza.obj", use_mtl=True)
    assert [id(m) for m, _, _ in port.load_model("sponza.obj", True)] \
        == [id(m) for m, _, _ in sponza]
    _assert_parts_equal(port.load_model("f1/f1.obj", use_mtl=True),
                        ref.load_model("f1/f1.obj", use_mtl=True))

    # the slot limit: 64 in all, then -1, in both
    for k in range(63):
        assert port.load_texture(f"t{k}.png") == ref.load_texture(f"t{k}.png")
    assert port.load_texture("t63.png") == ref.load_texture("t63.png") == -1
    assert port.load_texture("t0.png") == ref.load_texture("t0.png") == 2
    assert len(port.texture_images()) == len(ref.texture_images()) == 64
    assert port.add_texture("in_memory", np.zeros((2, 2, 4))) == -1

    # what raises: a missing file without a substitute, the dragon without
    # dragon.obj
    for name in ("nothing.obj", "Dragon_80K.obj"):
        for mgr, mod in ((port, port_manager), (ref, ref_manager)):
            with pytest.raises(mod.AssetNotFound):
                mgr.load_model(name, use_mtl=False)
    fresh = (port_manager.AssetManager([tmp_path]),
             ref_manager.AssetManager([tmp_path]))
    for mgr, mod in zip(fresh, (port_manager, ref_manager)):
        with pytest.raises(mod.AssetNotFound):
            mgr.load_texture("missing.png")
        assert mgr.loaded_textures == {"missing.png": 0}


def test_add_texture_shares_the_slot_tables():
    """An image made in memory takes the next slot under its name, as a
    loaded file would; a second registration of the name keeps the first."""
    a = port_manager.AssetManager()
    img = np.full((3, 5, 4), 0.5, np.float32)
    assert a.add_texture("x", img) == 0
    assert a.add_texture("y", img) == 1
    assert a.add_texture("x", np.zeros((1, 1, 4))) == 0
    assert a.load_texture("x") == 0
    assert a.texture_images()[0] is a.cpu_textures[0]
    assert np.array_equal(a.cpu_textures[0], img)
