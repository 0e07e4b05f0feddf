"""What the persistent kernels rely on, held on the CPU.

The CUDA kernels (``csrc/megakernel.cu``, ``csrc/spheres.cu``) hand pixels
out to lanes in whatever order the lanes finish, so a pixel's value and its
segments must not depend on which pixels are rendered with it: the plain
versions render a frame as row windows in shuffled order and stitch it
with every pixel's segments exact and the visit counts adding up over the
windows. The images agree within ``STITCH_TOL``, not bit for bit: on the
CPU, PyTorch evaluates transcendentals (``log``, ``cos``, ``pow``) in SIMD
lanes and in scalar tails that differ by an ulp, so a pixel's value can
move by an ulp with its place in the batch (1 ulp, 6e-8, on a few pixels
of these frames even at bounces 0, on one thread or eight). The
wrappers' per-launch scratch and device counts are sized as the C entry
points read them (constants parsed from the sources), and ``Renderer``
takes the card unless asked for the CPU. The kernels themselves run only
on the card (``tests/test_torch_cuda.py``).
"""
import ctypes
import dataclasses
import re

import numpy as np
import pytest
import torch

from ray_tracer_2_tpu_torch.engine.renderer import Renderer
from ray_tracer_2_tpu_torch.kernels import megakernel, spheres
from ray_tracer_2_tpu_torch.kernels.cuda_build import (
    LAUNCH_SCRATCH, PKG, check_aligned, launch_scratch, source_bytes,
)
from ray_tracer_2_tpu_torch.scene import scenes
from ray_tracer_2_tpu_torch.scene.render_scene import instantiate_scene

CSRC = PKG / "csrc"
#: largest pixel difference between a frame and its stitched windows
STITCH_TOL = 1e-6


def _windows(height: int, seed: int):
    """Row windows covering ``height`` rows, of uneven sizes, in shuffled
    order."""
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.choice(np.arange(1, height), size=3, replace=False))
    bounds = [0, *cuts.tolist(), height]
    wins = list(zip(bounds[:-1], np.diff(bounds).tolist()))
    rng.shuffle(wins)
    return wins


def _stitched(render, scene, kw, height, seed):
    """The frame rendered as shuffled row windows and stitched: (image,
    per-pixel segments, summed counts of the windows)."""
    img = [None] * height
    pix = [None] * height
    total = {}
    for row_start, rows in _windows(height, seed):
        c = {}
        out, segs = render(scene, 3, row_start=row_start, rows=rows,
                           counts=c, **kw)
        assert int(segs) == int(c["pixel_segments"].sum())
        for r in range(rows):
            img[row_start + r] = out[r]
            pix[row_start + r] = c["pixel_segments"][r]
        for k, v in c.items():
            if k != "pixel_segments":
                total[k] = total.get(k, 0) + v
    return torch.stack(img), torch.stack(pix), total


def _check_stitched(render, scene, kw, height, seed):
    whole = {}
    img, segs = render(scene, 3, counts=whole, **kw)
    st, st_pix, st_counts = _stitched(render, scene, kw, height, seed)
    assert torch.equal(whole.pop("pixel_segments"), st_pix)
    assert int(segs) == int(st_pix.sum())
    assert whole == st_counts
    assert float((img - st).abs().max()) <= STITCH_TOL
    return whole


_MEGA_CASES = [
    ("wide_bvh_scene", (), dict(bounces=3)),
    ("room2_scene", (12, 12), dict(bounces=4)),
    ("room", (), dict(bounces=2, rays_per_pixel=2, antialias=True)),
]


@pytest.mark.parametrize("case", range(len(_MEGA_CASES)))
def test_megakernel_plain_row_windows_stitch(case):
    """``render_plain`` of a frame against the frame stitched from row
    windows rendered in shuffled order: every pixel's segments exact, row,
    leaf and child-box visits summing to the frame's, pixels within
    ``STITCH_TOL``."""
    name, args, over = _MEGA_CASES[case]
    scene = instantiate_scene(getattr(scenes, name)(*args))
    W, H = 23, 13
    kw = dict(dict(width=W, height=H, rays_per_pixel=1, skybox=True), **over)
    whole = _check_stitched(megakernel.render_plain, scene, kw, H, case)
    assert set(whole) == {"rows", "leaves", "boxes"}
    if name != "room":
        assert whole["rows"] > 0 and whole["leaves"] > 0
        assert whole["boxes"] >= whole["rows"]


@pytest.mark.parametrize("name,bounces,rpp",
                         [("random_balls", 4, 1), ("room", 3, 3)])
def test_spheres_plain_row_windows_stitch(name, bounces, rpp):
    """``render_spheres_plain`` of a frame against the frame stitched from
    row windows in shuffled order: every pixel's segments exact, pixels
    within ``STITCH_TOL``."""
    scene = instantiate_scene(getattr(scenes, name)())
    W, H = 21, 12
    kw = dict(width=W, height=H, bounces=bounces, rays_per_pixel=rpp,
              skybox=True)
    assert _check_stitched(spheres.render_spheres_plain, scene, kw, H,
                           bounces) == {}


def test_plain_visit_counts_are_deterministic():
    """Two renders of one frame count the same visits and per-pixel
    segments; another frame counts other ones."""
    scene = instantiate_scene(scenes.wide_bvh_scene())
    kw = dict(width=19, height=11, bounces=5, rays_per_pixel=1, skybox=True)
    a, b, c = {}, {}, {}
    megakernel.render_plain(scene, 2, counts=a, **kw)
    megakernel.render_plain(scene, 2, counts=b, **kw)
    megakernel.render_plain(scene, 7, counts=c, **kw)
    assert [a[k] for k in ("rows", "leaves", "boxes")] == \
        [b[k] for k in ("rows", "leaves", "boxes")]
    assert torch.equal(a["pixel_segments"], b["pixel_segments"])
    assert not torch.equal(a["pixel_segments"], c["pixel_segments"])


def _constants(path, prefix: str) -> dict:
    """``constexpr int`` constants of a C source and the headers it
    includes (``csrc/trace.cuh`` holds most of the megakernel's)."""
    src = source_bytes(path).decode()
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        rf"constexpr int {prefix}(\w+) = (\d+);", src)}


def _c_params(path, symbol: str) -> list:
    src = path.read_text()
    m = re.search(rf'extern "C" int {symbol}\((.*?)\)\s*{{', src, re.S)
    return [p.strip() for p in m.group(1).split(",")]


def _snake(name: str) -> str:
    return re.sub(r"(?<!^)(?=[A-Z])", "_", name).lower()


@pytest.mark.parametrize("mod,source", [(megakernel, "megakernel.cu"),
                                        (spheres, "spheres.cu")])
def test_counts_match_the_kernel_source(mod, source):
    """The wrapper's ``COUNTS`` name the C source's kCnt* words in order,
    and kCounts is their number."""
    cnt = _constants(CSRC / source, "kCnt")
    order = sorted(cnt, key=cnt.get)
    assert [cnt[k] for k in order] == list(range(len(order)))
    assert len(mod.COUNTS) == len(order) == \
        _constants(CSRC / source, "k")["Counts"]
    aliases = {"Active": "active_lanes"}
    assert [aliases.get(k, _snake(k)) for k in order] == list(mod.COUNTS)


def test_launch_scratch_matches_the_claim_header():
    """Per-launch scratch: as many zeroed int64 words as
    ``csrc/claim.cuh`` reads (segments, cursor, flag), word 0 the
    segment count."""
    words = _constants(CSRC / "claim.cuh", "kScratch")
    assert words == dict(Segments=0, Cursor=1, Flag=2, Words=LAUNCH_SCRATCH)
    s = launch_scratch(torch.device("cpu"))
    assert s.dtype == torch.int64 and tuple(s.shape) == (LAUNCH_SCRATCH,)
    assert s.is_contiguous() and not bool(s.any())


@pytest.mark.parametrize("cls,source", [
    (megakernel.CudaMegakernel, "megakernel.cu"),
    (spheres.CudaSpheres, "spheres.cu")])
def test_argtypes_match_the_entry_point(cls, source):
    """One ctypes type per C parameter: pointers (the tables, the image,
    the scratch and counts words, the stream) as ``c_void_p``, ints as
    ``c_int``, the frame seed as ``c_uint32``."""
    params = _c_params(CSRC / source, cls.symbol)
    assert len(params) == len(cls.argtypes)
    for p, t in zip(params, cls.argtypes):
        if "*" in p:
            assert t is ctypes.c_void_p, p
        elif p.startswith("unsigned int"):
            assert t is ctypes.c_uint32, p
        elif p.startswith("float"):
            assert t is ctypes.c_float, p
        else:
            assert p.startswith("int") and t is ctypes.c_int, p
    assert params[-3].endswith("* scratch")
    assert params[-2].endswith("* counts")


def test_nee_argtypes_match_the_entry_point():
    """The megakernel's next-event estimation entry point: the ordinary
    one's parameters without the form flags, then the light table, its cdf,
    the light count, the mode and the two float32 constants."""
    cls = megakernel.CudaMegakernel
    params = _c_params(CSRC / "megakernel.cu", cls.nee_symbol)
    assert len(params) == len(cls.nee_argtypes)
    for p, t in zip(params, cls.nee_argtypes):
        if "*" in p:
            assert t is ctypes.c_void_p, p
        elif p.startswith("unsigned int"):
            assert t is ctypes.c_uint32, p
        elif p.startswith("float"):
            assert t is ctypes.c_float, p
        else:
            assert p.startswith("int") and t is ctypes.c_int, p
    names = [p.split()[-1].lstrip("*") for p in params]
    assert names[-10:] == ["lights", "cdf", "n_lights", "nee_mode", "c_tri",
                           "c_area", "out", "scratch", "counts", "stream"]
    assert [n for n in names if n not in ("general", "glass")][:22] == \
        [p.split()[-1].lstrip("*") for p in _c_params(
            CSRC / "megakernel.cu", cls.symbol)
         if p.split()[-1] not in ("general", "glass")][:22]


@pytest.mark.parametrize("segments", [False, True])
def test_nee_plain_row_windows_stitch(segments):
    """With next-event estimation (``room``, mode 1 and forced mode 2), the
    frame stitched from shuffled row windows: segments and shadow rays
    exact, pixels within ``STITCH_TOL``."""
    scene = instantiate_scene(scenes.room())
    W, H = 23, 13
    kw = dict(width=W, height=H, rays_per_pixel=2, skybox=True, bounces=3,
              nee=True, nee_segments=segments)
    whole = _check_stitched(megakernel.render_plain, scene, kw, H, 5)
    assert whole["shadow_rays"] > 0


def test_brute_argtypes_match_the_entry_point():
    """The standalone brute-force kernel's entry point: three table and
    record pointers, two int counts, the stream."""
    from ray_tracer_2_tpu_torch.kernels.brute import CudaBrute
    params = _c_params(CSRC / "brute.cu", CudaBrute.symbol)
    assert len(params) == len(CudaBrute.argtypes)
    for p, t in zip(params, CudaBrute.argtypes):
        assert t is (ctypes.c_void_p if "*" in p else ctypes.c_int), p
    assert params[-1] == "void* stream"


@pytest.mark.parametrize("cls", [megakernel.CudaMegakernel,
                                 spheres.CudaSpheres])
def test_device_counts_accumulate_and_reset(cls):
    """The counts words the wrapper hands a launch: int64, one per name,
    zeroed at first use; ``read_counts`` sums them by name and
    ``reset_counts`` zeroes them with the launch count."""
    k = cls()
    cpu = torch.device("cpu")
    words = k.device_counts(cpu)
    assert words.dtype == torch.int64 and words.numel() == len(cls.counts)
    assert k.device_counts(cpu) is words
    words += torch.arange(1, words.numel() + 1)
    k.launches = 3
    assert k.read_counts() == {n: i + 1 for i, n in enumerate(cls.counts)}
    k.reset_counts()
    assert k.launches == 0 and set(k.read_counts().values()) == {0}


def test_wide_rows_must_be_16_byte_aligned():
    """The megakernel reads child boxes as 16-byte loads: its wrapper
    refuses wide rows at an unaligned offset."""
    rows = torch.zeros((4, 128), dtype=torch.float32)
    check_aligned("wide_rows", rows, 16)
    check_aligned("wide_rows", rows.view(-1)[4:], 16)
    with pytest.raises(ValueError, match="16-byte"):
        check_aligned("wide_rows", rows.view(-1)[1:], 16)


def test_renderer_defaults_to_the_card():
    """The port's entry points run on the card unless asked for the CPU;
    naming the device allocates nothing."""
    r = Renderer()
    assert r.device.type == "cuda"
    assert r.framebuffer is None and r.last_segments is None
    assert Renderer(device="cpu").device.type == "cpu"


# ------------------------------------------- the staged tables' budget --
def _groups_scene(n_groups: int):
    """``n_groups`` distinct brute-force groups of 256 triangles each."""
    return instantiate_scene(scenes.groups_scene(n_groups))


class _Word:
    """One 16-byte word of a packed row, by component, over all rows."""

    def __init__(self, cols):
        self.x, self.y, self.z, self.w = (cols[:, i] for i in range(4))


def _stage_row_model(packed: np.ndarray) -> np.ndarray:
    """``csrc/brute.cuh:stage_row`` read from its source and evaluated in
    numpy float32 (one rounding per operation, which is what the kernels'
    build without contraction gives): the ``const float`` definitions in
    order, then the four ``make_float4`` words."""
    src = (CSRC / "brute.cuh").read_text()
    body = src[src.index("void stage_row("):]
    body = body[:body.index("\n}\n")]
    env = {f"q{i}": _Word(packed[:, 4 * i:4 * i + 4]) for i in range(3)}
    for stmt in re.findall(r"const float ((?!4)[^;]+);", body):
        for name, expr in re.findall(r"(\w+) = ([^,;]+)", stmt):
            env[name] = eval(expr, {}, env).astype(np.float32)
    words = re.findall(r"row\[(\d)\] = make_float4\(([^;]+)\);", body)
    assert [int(i) for i, _ in words] == [0, 1, 2, 3]
    zero = np.zeros(len(packed), np.float32)
    cols = [eval(e.replace("0.0f", "zero"), {}, dict(env, zero=zero))
            for _, args in words for e in args.split(", ")]
    return np.stack(cols, axis=1)


def test_staged_row_matches_the_kernel_source():
    """A staged brute-force triangle is ``kRowWords`` 16-byte words, and
    the budget the wrapper polices is the one the C entry point does. The
    rows staged on the host for tables read from global memory
    (``stage_brute_rows``) are, bit for bit, what ``stage_row`` in the
    source computes."""
    words = _constants(CSRC / "brute.cuh", "k")["RowWords"]
    assert 4 * words == megakernel.BRUTE_STAGED == 16
    m = re.search(r"constexpr int kDynSmemBytes = (\d+) \* 1024;",
                  source_bytes(CSRC / "megakernel.cu").decode())
    assert int(m.group(1)) * 1024 == megakernel.SMEM_BYTES
    assert megakernel.SMEM_BYTES <= 227 * 1024 - 2048
    assert _constants(CSRC / "megakernel.cu", "k")["SphStride"] == \
        megakernel.SPHERE_COLS
    from ray_tracer_2_tpu_torch.kernels.brute import pack_brute_table, \
        stage_brute_rows
    scene = instantiate_scene(scenes.room2_scene(12, 12))
    (tri_off, count), = megakernel._brute_ranges(scene)
    packed = pack_brute_table(scene, tri_off, count)
    staged = stage_brute_rows(packed)
    assert tuple(staged.shape) == (count, 16) and staged.is_contiguous()
    model = _stage_row_model(packed.numpy())
    assert model.dtype == np.float32
    assert np.array_equal(staged.numpy().view(np.uint32),
                          model.view(np.uint32))
    assert np.abs(model[:, 12:15]).max() > 0 and model[:, 7].max() == 1.0


@pytest.mark.parametrize("name,args", [
    ("wide_bvh_scene", ()), ("main_path_scene", (12, 12)),
    ("room2_scene", (12, 12)), ("instances_scene", ()), ("balls", ()),
    ("metal", ()), ("room", ())])
def test_smem_budget_admits_the_scenes_that_render(name, args):
    """Every scene of ``scenes.py`` the megakernel took with its spheres in
    a static array still fits its shared-memory budget with triangles
    staged at 64 bytes and spheres at 20, and is staged."""
    scene = instantiate_scene(getattr(scenes, name)(*args))
    assert megakernel.ineligibility(scene) is None
    assert megakernel.smem_bytes(scene) <= megakernel.SMEM_BYTES
    n_brute = sum(c for _, c in megakernel._brute_ranges(scene))
    assert megakernel.smem_bytes(scene) == \
        128 * scene.n_instances + 64 * n_brute + 20 * scene.n_spheres
    tab = megakernel.kernel_tables(scene)
    assert tab["staged"] and tab["spheres_mode"] == 0


def test_smem_budget_keeps_what_fit_before_and_raises_past_it():
    """The budget is what measured faster staged than read from global
    memory: two groups of 256 triangles (33 KB) are staged, three and more
    are not. Nothing raises past it any more: five groups (what passed the
    earlier 66 KB) render, their tables marked for global memory with the
    triangles staged on the host."""
    two, three = _groups_scene(2), _groups_scene(3)
    four, five = _groups_scene(4), _groups_scene(5)
    assert megakernel.SMEM_BYTES == 36 * 1024
    assert megakernel.smem_bytes(two) == 128 * 2 + 64 * 512 \
        <= megakernel.SMEM_BYTES < megakernel.smem_bytes(three)
    assert megakernel.smem_bytes(four) == 128 * 4 + 64 * 1024
    assert megakernel.smem_bytes(five) == 128 * 5 + 64 * 1280 > 66 * 1024
    for scene in (two, three, four, five):
        assert megakernel.ineligibility(scene) is None
    assert [megakernel.kernel_tables(sc)["staged"]
            for sc in (two, three, four, five)] == [True, False, False, False]
    t5 = megakernel.kernel_tables(five)
    assert t5["general"] and t5["glass"] and t5["spheres_mode"] == 0
    from ray_tracer_2_tpu_torch.kernels.brute import pack_brute_table, \
        stage_brute_rows
    packed = torch.cat([pack_brute_table(five, *key)
                        for key in megakernel._brute_ranges(five)])
    assert tuple(t5["brute"].shape) == (1280, 16)
    assert torch.equal(t5["brute"], stage_brute_rows(packed))
    assert torch.equal(megakernel.kernel_tables(two)["brute"][:, :9],
                       torch.cat([pack_brute_table(two, *key) for key in
                                  megakernel._brute_ranges(two)])[:, :9])
    img, segs = megakernel.render_plain(five, 0, width=24, height=8,
                                        bounces=1, rays_per_pixel=1,
                                        skybox=True)
    assert bool(torch.isfinite(img).all()) and int(segs) > 24 * 8
    # six resident blocks fit an SM's 228 KB with their staged tables, the
    # 1 KB the system keeps per block and the kernel's static words
    assert 6 * (megakernel.SMEM_BYTES + 1024 + 256) <= 228 * 1024


def test_tables_in_global_memory_change_nothing(monkeypatch):
    """The five-group scene renders the same, pixel for pixel and visit for
    visit, whether its tables are marked staged (under a raised budget) or
    for global memory: the plain version has one code path, and the choice
    lives in ``kernel_tables`` alone, from ``smem_bytes`` against
    ``SMEM_BYTES``."""
    kw = dict(width=32, height=12, bounces=2, rays_per_pixel=1, skybox=True)
    five = _groups_scene(5)
    assert not megakernel.kernel_tables(five)["staged"]
    ca = {}
    a, sa = megakernel.render_plain(five, 2, counts=ca, **kw)
    monkeypatch.setattr(megakernel, "SMEM_BYTES", 128 * 1024)
    again = _groups_scene(5)
    assert megakernel.kernel_tables(again)["staged"]
    cb = {}
    b, sb = megakernel.render_plain(again, 2, counts=cb, **kw)
    assert torch.equal(a, b) and int(sa) == int(sb)
    assert torch.equal(ca.pop("pixel_segments"), cb.pop("pixel_segments"))
    assert ca == cb
    assert float((a[..., :3] - a[0, 0, :3]).abs().max()) > 0.05


@pytest.mark.parametrize("n,mode,staged", [
    (33, 0, True), (63, 0, True), (64, 1, True), (65, 1, True),
    (1843, 1, True), (1844, 1, False), (2047, 1, False), (3500, 1, False)])
def test_sphere_tables_pick_the_kernel_form(n, mode, staged):
    """The dense prepass takes the shared-term formula from
    ``SPHERE_FAST_MIN`` spheres, with ``|c|^2 - r^2`` in the table's fourth
    column instead of the radius; 1,843 spheres (36,860 bytes) are staged,
    and what passes the budget, as 2,047 do, is read from global memory."""
    rng = np.random.default_rng(n)
    pos = torch.from_numpy(rng.uniform(-3, 3, (n, 3)).astype(np.float32))
    rad = torch.from_numpy(rng.uniform(0.05, 0.3, n).astype(np.float32))
    base = instantiate_scene(scenes.balls())
    scene = dataclasses.replace(
        base, sphere_pos=pos, sphere_radius=rad,
        sphere_mat=torch.zeros(n, dtype=torch.int32))
    if n > megakernel.MAX_SPHERES:
        assert "dense spheres" in megakernel.ineligibility(scene)
        return
    tab = megakernel.kernel_tables(scene)
    assert (tab["spheres_mode"], tab["staged"]) == (mode, staged)
    # balls has no glass: only the forms past the exact staged one are
    # compiled with the glass branch alone
    assert tab["general"] and tab["glass"] == (mode != 0)
    assert megakernel.smem_bytes(scene) == 20 * n
    col = tab["spheres"][:, 3]
    k = ((pos[:, 0] * pos[:, 0] + pos[:, 1] * pos[:, 1])
         + pos[:, 2] * pos[:, 2]) - rad * rad
    assert torch.equal(col, k if mode == 1 else rad)
    assert torch.equal(tab["spheres"][:, :3], pos)
