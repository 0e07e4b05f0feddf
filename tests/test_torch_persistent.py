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
import re

import numpy as np
import pytest
import torch

from ray_tracer_2_tpu_torch.engine.renderer import Renderer
from ray_tracer_2_tpu_torch.kernels import megakernel, spheres
from ray_tracer_2_tpu_torch.kernels.cuda_build import (
    LAUNCH_SCRATCH, PKG, check_aligned, launch_scratch,
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
    src = path.read_text()
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
    from ray_tracer_2_tpu_torch.math.transform import Transform
    from ray_tracer_2_tpu_torch.scene.definition import (
        MeshFromData, SceneDefinition,
    )
    from ray_tracer_2_tpu_torch.scene.material import MaterialDefinition
    s = SceneDefinition()
    for i in range(n_groups):
        s.add_mesh(Transform(pos=[1.5 * i, 0.0, 0.0]),
                   MeshFromData(scenes.latlon_soup(8, 16, 0.5 + 0.01 * i)),
                   MaterialDefinition.new())
    return instantiate_scene(s)


def test_staged_row_matches_the_kernel_source():
    """A staged brute-force triangle is ``kRowWords`` 16-byte words, and
    the budget the wrapper polices is the one the C entry point does."""
    words = _constants(CSRC / "brute.cuh", "k")["RowWords"]
    assert 4 * words == megakernel.BRUTE_STAGED == 16
    m = re.search(r"constexpr int kDynSmemBytes = (\d+) \* 1024;",
                  (CSRC / "megakernel.cu").read_text())
    assert int(m.group(1)) * 1024 == megakernel.SMEM_BYTES
    assert megakernel.SMEM_BYTES <= 227 * 1024 - 2048


@pytest.mark.parametrize("name,args", [
    ("wide_bvh_scene", ()), ("main_path_scene", (12, 12)),
    ("room2_scene", (12, 12)), ("instances_scene", ()), ("balls", ()),
    ("metal", ()), ("room", ())])
def test_smem_budget_admits_the_scenes_that_render(name, args):
    """Every scene of ``scenes.py`` the megakernel takes still fits its
    shared-memory budget with triangles staged at 64 bytes."""
    scene = instantiate_scene(getattr(scenes, name)(*args))
    assert megakernel.ineligibility(scene) is None
    assert megakernel.smem_bytes(scene) <= megakernel.SMEM_BYTES
    n_brute = sum(c for _, c in megakernel._brute_ranges(scene))
    assert megakernel.smem_bytes(scene) == \
        128 * scene.n_instances + 64 * n_brute


def test_smem_budget_keeps_what_fit_before_and_raises_past_it():
    """Four groups of 256 triangles fit the earlier 45 KB at 44 bytes a
    triangle and fit the 66 KB at 64; a fifth group is past the limit, and
    the message names the budget and the ROADMAP item that lifts it."""
    four, five = _groups_scene(4), _groups_scene(5)
    assert 4 * (32 * 4 + 11 * 1024) <= 45 * 1024      # the earlier budget
    assert megakernel.smem_bytes(four) == 128 * 4 + 64 * 1024
    assert megakernel.ineligibility(four) is None
    assert megakernel.smem_bytes(five) == 128 * 5 + 64 * 1280 \
        > megakernel.SMEM_BYTES
    reason = megakernel.ineligibility(five)
    assert "82560 bytes" in reason and "67584-byte" in reason
    assert "ROADMAP Queue 1 item 1" in reason
    with pytest.raises(NotImplementedError, match="shared-memory budget"):
        megakernel.render_plain(five, 0, width=4, height=4, bounces=0,
                                rays_per_pixel=1, skybox=True)
    # any table that fit 45 KB at 44 bytes a triangle fits 66 KB at 64
    for inst in range(1, 300, 7):
        tris = (45 * 1024 - 128 * inst) // 44
        assert 128 * inst + 64 * tris <= megakernel.SMEM_BYTES
