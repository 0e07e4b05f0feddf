"""The wide rows' child-box test at its edges, held on the CPU.

``kernels/megakernel.py:_wide_eval`` is the plain version that the CUDA
kernel's slab test (``csrc/trace.cuh`` ``child_eval`` and ``wide_eval``)
is held to bit for bit on the card. These cases pin what it returns where
a zero direction component meets a box's plane (0 * inf), at signed-zero
and infinite bounds, on ties, for the second-least entry and past a row's
k children. Beside it, ``_kernel_model`` follows the kernel's
instructions in float32: each f16 bound through the hardware conversion
and its clamp, NaN-propagating min/max, the running nearest and second
child with a plain min, the children from k on left untested; every case
holds it equal to the plain version. The kernel's conversion is exact only
for what the packer (``accel/wide.py:_round_out_f16``) emits, and the last
tests pin that: no NaN pattern, and an infinity only as a lo of -inf or a
hi of +inf. ``slab_edges.slab_edges_scene`` is the scene the card test
(``tests/test_torch_cuda.py``) renders at these edges; here, what its
tables and camera rays hold.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ray_tracer_2_tpu_torch.accel.wide import (
    COL_CHILD_AABB, COL_COUNT, COL_K, COL_LEAF_GEO, MAX_ARITY, ROW_WIDTH,
    _pack_f16_pairs, _round_out_f16,
)
from ray_tracer_2_tpu_torch.kernels import megakernel
from ray_tracer_2_tpu_torch.kernels.intersect import INF
from ray_tracer_2_tpu_torch.scene import scenes
from ray_tracer_2_tpu_torch.scene.render_scene import instantiate_scene
from slab_edges import HEIGHT as H, VIEWS, WIDTH as W, instantiated

F32 = np.float32
INF32 = float(F32(INF))   # the kernel's kInf as float32
BIG = 65536.0   # what the integer rebias reads an f16 infinity as


def _row(boxes, k=None) -> np.ndarray:
    """A wide row of ``boxes`` ((lo xyz, hi xyz), f16-exact values) laid out
    as the packer lays them, slots past the boxes the packer's inverted
    empty box (lo +inf, hi -inf); ``k`` defaults to the number of boxes."""
    aab = np.empty((MAX_ARITY, 6), np.float32)
    aab[:, 0:3] = np.inf
    aab[:, 3:6] = -np.inf
    for slot, (lo, hi) in enumerate(boxes):
        aab[slot, 0:3], aab[slot, 3:6] = lo, hi
    lo16, hi16 = aab[:, 0:3].astype(np.float16), aab[:, 3:6].astype(np.float16)
    assert np.array_equal(lo16.astype(np.float32), aab[:, 0:3])
    assert np.array_equal(hi16.astype(np.float32), aab[:, 3:6])
    inter = np.empty((3 * MAX_ARITY, 2), np.float16)
    inter[:, 0] = lo16.T.reshape(-1)
    inter[:, 1] = hi16.T.reshape(-1)
    r = np.zeros(ROW_WIDTH, np.float32)
    r[COL_K] = len(boxes) if k is None else k
    r[COL_CHILD_AABB:COL_CHILD_AABB + 3 * MAX_ARITY] = \
        _pack_f16_pairs(inter.reshape(-1))
    return r


def _inv(d):
    with np.errstate(divide="ignore"):
        return F32(1.0) / np.asarray(d, np.float32)


def _plain(row, o, d, limit):
    """(mask, nearest child, second-least entry) from ``_wide_eval``."""
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)[None].copy())
    mask, c_min, dn2 = megakernel._wide_eval(t(row), t(o), t(_inv(d)),
                                             t(F32(limit)))
    return int(mask[0]), int(c_min[0]), float(dn2[0])


def _kernel_model(row, o, d, limit, valid=None, clamp=True):
    """The CUDA slab test's instructions in float32, child by child:
    ``cvt.f32.f16`` of each bound, with ``clamp`` (the loop of a scene whose
    bounds are not all finite) lo clamped by ``fmaxf(., -65536)`` and hi by
    ``fminf(., 65536)``, ``(b - o) * inv``, ``min.NaN`` / ``max.NaN``
    (numpy's minimum / maximum), the hit, dropped for a child from
    ``valid`` on (default the row's k), the nearest child (strict ``<``)
    and the second-least entry as ``fminf(m2, fmaxf(m1, dn))`` (numpy's
    fmin and fmax). Every child of the groups of four that hold the first
    k is tested, as the kernel tests them."""
    o, inv = np.asarray(o, np.float32), _inv(d)
    limit = F32(limit)
    k = min(int(row[COL_K]), MAX_ARITY)
    valid = k if valid is None else valid
    u = row[COL_CHILD_AABB:COL_CHILD_AABB + 3 * MAX_ARITY].view(np.uint32)
    lo = (u & 0xFFFF).astype(np.uint16).view(np.float16).astype(np.float32)
    hi = (u >> 16).astype(np.uint16).view(np.float16).astype(np.float32)
    if clamp:
        lo, hi = np.fmax(lo, F32(-BIG)), np.fmin(hi, F32(BIG))
    mask, c_min, m1, m2 = 0, 0, F32(INF), F32(INF)
    with np.errstate(invalid="ignore"):
        for c in range(-(-k // 4) * 4):
            t1 = [(lo[MAX_ARITY * a + c] - o[a]) * inv[a] for a in range(3)]
            t2 = [(hi[MAX_ARITY * a + c] - o[a]) * inv[a] for a in range(3)]
            mn = [np.minimum(p, q) for p, q in zip(t1, t2)]
            mx = [np.maximum(p, q) for p, q in zip(t1, t2)]
            tn = np.maximum(np.maximum(mn[0], mn[1]), mn[2])
            tf = np.minimum(np.minimum(mx[0], mx[1]), mx[2])
            hit = c < valid and bool(tf >= tn) and bool(tn < limit) \
                and bool(tf > 0)
            dn = tn if hit else F32(INF)
            c_min = c if dn < m1 else c_min
            m2 = np.fmin(m2, np.fmax(m1, dn))
            m1 = np.fmin(m1, dn)
            mask |= int(hit) << c
    return mask, c_min, float(m2)


def _finite(rows) -> bool:
    """``megakernel.finite_boxes``' decision over wide rows (n, 128)."""
    return megakernel._finite_boxes(
        SimpleNamespace(wide_rows=torch.from_numpy(np.atleast_2d(rows))))


UNIT = ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))
I_ = float(np.inf)

# name -> (boxes, k, origin, direction, limit, (mask, nearest, second))
CASES = {
    # a zero direction component: inv = +-inf, so (bound - o) * inv is
    # +-inf off the plane and 0 * inf = NaN on it, which fails tf >= tn
    "zero_dir_origin_on_lo_plane": (
        [((0.0, -1.0, 1.0), (1.0, 1.0, 2.0))], None,
        (0.0, 0.0, 0.0), (0.0, 0.0, 1.0), INF, (0, 0, INF32)),
    "zero_dir_origin_on_hi_plane": (
        [((-1.0, -1.0, 1.0), (0.0, 1.0, 2.0))], None,
        (0.0, 0.0, 0.0), (0.0, 0.0, 1.0), INF, (0, 0, INF32)),
    "negative_zero_dir_origin_on_plane": (
        [((0.0, -1.0, 1.0), (1.0, 1.0, 2.0))], None,
        (0.0, 0.0, 0.0), (-0.0, 0.0, 1.0), INF, (0, 0, INF32)),
    "zero_dir_origin_inside_slab": (
        [((-1.0, -1.0, 1.0), (1.0, 1.0, 2.0)),
         ((-1.0, -1.0, 3.0), (1.0, 1.0, 4.0))], None,
        (0.0, 0.0, 0.0), (0.0, 0.0, 1.0), INF, (0b11, 0, 3.0)),
    "zero_dir_origin_outside_slab": (
        [((0.5, -1.0, 1.0), (1.0, 1.0, 2.0)),
         ((-1.0, -1.0, 1.0), (-0.5, 1.0, 2.0))], None,
        (0.0, 0.0, 0.0), (0.0, 0.0, 1.0), INF, (0, 0, INF32)),
    # +-0 bounds: a box of no width at x = 0, whichever zero each side holds
    "signed_zero_bounds": (
        [((-0.0, -1.0, -1.0), (0.0, 1.0, 1.0)),
         ((0.0, -1.0, -1.0), (-0.0, 1.0, 1.0)),
         ((-0.0, -1.0, -1.0), (-0.0, 1.0, 1.0))], None,
        (-1.0, 0.0, 0.0), (1.0, 0.0, 0.0), INF, (0b111, 0, 1.0)),
    # f16 infinities within k: the rebias reads -inf as -65536 and +inf as
    # +65536, so a ray from x = -/+70,000 enters both boxes 4,464 away
    "lo_neg_inf_reads_minus_65536": (
        [((-I_, -1.0, -1.0), (1.0, 1.0, 1.0))] * 2, None,
        (-70000.0, 0.0, 0.0), (1.0, 0.0, 0.0), INF, (0b11, 0, 4464.0)),
    "hi_pos_inf_reads_plus_65536": (
        [((-1.0, -1.0, -1.0), (I_, 1.0, 1.0))] * 2, None,
        (70000.0, 0.0, 0.0), (-1.0, 0.0, 0.0), INF, (0b11, 0, 4464.0)),
    "lo_neg_inf_pruned_at_its_plane": (
        [((-I_, -1.0, -1.0), (1.0, 1.0, 1.0))], None,
        (-70000.0, 0.0, 0.0), (1.0, 0.0, 0.0), 4000.0, (0, 0, INF32)),
    "hi_pos_inf_pruned_at_its_plane": (
        [((-1.0, -1.0, -1.0), (I_, 1.0, 1.0))], None,
        (70000.0, 0.0, 0.0), (-1.0, 0.0, 0.0), 4000.0, (0, 0, INF32)),
    # ties keep the first index; the second is the least of the others
    "tie_takes_first_index": (
        [((5.0, -1.0, -1.0), (6.0, 1.0, 1.0)),
         ((2.0, -1.0, -1.0), (3.0, 1.0, 1.0)),
         ((2.0, -2.0, -2.0), (4.0, 2.0, 2.0))], None,
        (0.0, 0.0, 0.0), (1.0, 0.0, 0.0), INF, (0b111, 1, 2.0)),
    "second_none": (
        [((5.0, 5.0, 5.0), (6.0, 6.0, 6.0)), ((2.0, -1.0, -1.0),
                                              (3.0, 1.0, 1.0))], None,
        (0.0, 0.0, 0.0), (1.0, 0.0, 0.0), INF, (0b10, 1, INF32)),
    "second_one": (
        [((4.0, -1.0, -1.0), (6.0, 1.0, 1.0)), ((2.0, -1.0, -1.0),
                                                (3.0, 1.0, 1.0))], None,
        (0.0, 0.0, 0.0), (1.0, 0.0, 0.0), INF, (0b11, 1, 4.0)),
    "second_two": (
        [((3.0, -1.0, -1.0), (6.0, 1.0, 1.0)), ((1.0, -1.0, -1.0),
                                                (7.0, 1.0, 1.0)),
         ((2.0, -1.0, -1.0), (3.0, 1.0, 1.0))], None,
        (0.0, 0.0, 0.0), (1.0, 0.0, 0.0), INF, (0b111, 1, 2.0)),
    # the limit and the far side
    "entry_at_the_limit_misses": (
        [((2.0, -1.0, -1.0), (3.0, 1.0, 1.0))], None,
        (0.0, 0.0, 0.0), (1.0, 0.0, 0.0), 2.0, (0, 0, INF32)),
    "exit_at_the_origin_misses": (
        [((-2.0, -1.0, -1.0), (0.0, 1.0, 1.0))], None,
        (0.0, 0.0, 0.0), (1.0, 0.0, 0.0), INF, (0, 0, INF32)),
    # children from k on are not tested: the packer's inverted empty slot,
    # or any box there, never hits
    "past_k_partial_group": (
        [UNIT] * 6, 5, (0.0, 0.0, -5.0), (0.0, 0.0, 1.0), INF,
        (0b11111, 0, 4.0)),
    "past_k_box_ignored": (
        [((-1.0, -1.0, 2.0), (1.0, 1.0, 3.0))] * 2 + [UNIT], 2,
        (0.0, 0.0, -5.0), (0.0, 0.0, 1.0), INF, (0b11, 0, 7.0)),
    "k_one": (
        [UNIT], None, (0.0, 0.0, -5.0), (0.0, 0.0, 1.0), INF, (1, 0, INF32)),
    "k_full_row": (
        [UNIT] * MAX_ARITY, None, (0.0, 0.0, -5.0), (0.0, 0.0, 1.0), INF,
        ((1 << MAX_ARITY) - 1, 0, 4.0)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_slab_edge(name):
    """The plain version gives the pinned (mask, nearest child, second-least
    entry), and the model of the kernel's instructions gives the same; so
    does its loop without clamps wherever ``finite_boxes`` lets the kernel
    take it (every case but those of an infinite bound)."""
    boxes, k, o, d, limit, want = CASES[name]
    row = _row(boxes, k)
    got = _plain(row, o, d, limit)
    assert got == want
    assert _kernel_model(row, o, d, limit) == got
    assert _finite(row) == ("_inf_" not in name)
    if _finite(row):
        assert _kernel_model(row, o, d, limit, clamp=False) == got


def test_untested_empty_slot_would_hit():
    """Why the kernel drops the hit of a child from k on: the packer's empty
    slot, an inverted box of infinities, reads as a box around
    everything, with the clamps or without."""
    row = _row([UNIT], 1)
    o, d = (0.0, 0.0, -5.0), (0.0, 0.0, 1.0)
    for clamp in (True, False):
        assert _kernel_model(row, o, d, INF, clamp=clamp) == (1, 0, INF32)
        mask, _, _ = _kernel_model(row, o, d, INF, valid=MAX_ARITY,
                                   clamp=clamp)
        assert mask == (1 << 4) - 1


@pytest.mark.parametrize("seed", range(4))
def test_model_matches_plain_on_random_rows(seed):
    """Rows of random f16 boxes (k 1-32) under random rays, a third of
    them with a zero direction component and their origin on a box's
    plane; finite rows, so the loop without clamps holds too."""
    rng = np.random.default_rng(seed)
    for _ in range(64):
        n = int(rng.integers(1, MAX_ARITY + 1))
        a = rng.normal(0.0, 4.0, (n, 2, 3)).astype(np.float16)
        boxes = [(tuple(map(float, np.minimum(p, q))),
                  tuple(map(float, np.maximum(p, q)))) for p, q in a]
        row = _row(boxes)
        o = rng.normal(0.0, 8.0, 3).astype(np.float32)
        d = rng.normal(0.0, 1.0, 3).astype(np.float32)
        if rng.random() < 1 / 3:
            ax, c, side = rng.integers(3), rng.integers(n), rng.integers(2)
            d[ax] = 0.0
            o[ax] = boxes[c][side][ax]
        limit = float(rng.choice([INF, abs(rng.normal(0.0, 10.0))]))
        want = _plain(row, o, d, limit)
        assert _finite(row)
        for clamp in (True, False):
            assert _kernel_model(row, o, d, limit, clamp=clamp) == want


@pytest.mark.parametrize("role", ["lo", "hi"])
def test_conversion_equals_the_rebias(role):
    """For every f16 pattern the packer may put in a tested child's lo (a
    finite value or -inf) or hi (a finite value or +inf), the hardware
    conversion clamped as the kernel clamps it gives the integer rebias's
    float bit for bit, subnormals and both zeros included."""
    bits = np.arange(1 << 16, dtype=np.int64)
    h = bits.astype(np.uint16).view(np.float16)
    keep = np.isfinite(h) | (np.isneginf(h) if role == "lo"
                             else np.isposinf(h))
    conv = h.astype(np.float32)
    conv = np.fmax(conv, F32(-BIG)) if role == "lo" else np.fmin(conv,
                                                                 F32(BIG))
    rebias = megakernel._unpack_f16(torch.from_numpy(bits)).numpy()
    assert keep.sum() == 63489
    assert np.array_equal(conv[keep].view(np.int32),
                          rebias[keep].view(np.int32))


def _bounds(kind: str, rng) -> np.ndarray:
    if kind == "normal":
        return rng.normal(0.0, 100.0, (4096, 2, 3))
    if kind == "wide":
        return rng.normal(0.0, 1.0, (4096, 2, 3)) * 10.0 ** rng.integers(
            -12, 8, (4096, 2, 3))
    if kind == "tiny":
        return rng.normal(0.0, 1e-5, (4096, 2, 3))
    s = np.array([0.0, -0.0, 6e-8, 5.9e-8, 1e-7, 6.1e-5, 6.2e-5, 65504.0,
                  65519.0, 65520.0, 65536.0, 7e4, 1e6, 3e38])
    s = np.concatenate([s, -s])
    p = np.stack(np.meshgrid(s, s, indexing="ij"), axis=-1).reshape(-1, 2)
    return np.repeat(p[:, :, None], 3, axis=2)


@pytest.mark.parametrize("kind", ["normal", "wide", "tiny", "specials"])
def test_packer_emits_no_nan_and_infinities_only_outward(kind):
    """What the kernel's conversion relies on: for finite boxes the packer
    emits no NaN pattern and no f16 subnormal, an infinity only as a lo of
    -inf or a hi of +inf, and bounds that only grow the box."""
    p = _bounds(kind, np.random.default_rng(7)).astype(np.float32)
    lo, hi = np.minimum(p[:, 0], p[:, 1]), np.maximum(p[:, 0], p[:, 1])
    with np.errstate(over="ignore"):
        lo16, hi16 = _round_out_f16(lo, hi)
    for b in (lo16, hi16):
        assert not np.isnan(b).any()
        f = np.abs(b.astype(np.float32))
        assert not ((f > 0) & (f < 2.0 ** -14)).any()
    assert not np.isposinf(lo16).any() and not np.isneginf(hi16).any()
    assert (lo16.astype(np.float32) <= lo).all()
    assert (hi16.astype(np.float32) >= hi).all()
    if kind == "specials":
        assert np.isneginf(lo16).any() and np.isposinf(hi16).any()


@pytest.fixture(scope="module")
def edge_scenes():
    return {v: instantiated(v) for v in VIEWS}


def _children(scene):
    """(lo, hi) as float32 (rows, 3, 32) and the valid-slot mask of the
    scene's interior wide rows."""
    wr = scene.wide_rows.numpy()
    inter = wr[wr[:, COL_COUNT] == 0]
    u = inter[:, COL_CHILD_AABB:COL_CHILD_AABB + 96].view(np.uint32)
    f = lambda b: b.astype(np.uint16).view(np.float16).astype(
        np.float32).reshape(-1, 3, MAX_ARITY)
    k = inter[:, COL_K].astype(np.int64)
    return f(u & 0xFFFF), f(u >> 16), np.arange(MAX_ARITY) < k[:, None]


def test_edge_scene_tables_hold_the_edges(edge_scenes):
    """Tested children whose lo is -inf and whose hi is +inf, and many
    whose planes lie at x = 0 and y = 1, the planes camera's."""
    lo, hi, valid = _children(edge_scenes["planes"])
    assert (np.isneginf(lo[:, 0]) & valid).any()
    assert (np.isposinf(hi[:, 0]) & valid).any()
    for axis, plane in ((0, 0.0), (1, 1.0)):
        assert ((lo[:, axis] == plane) & valid).sum() >= 8
        assert ((hi[:, axis] == plane) & valid).sum() >= 8


@pytest.mark.parametrize("view", VIEWS)
def test_edge_scene_camera_rays(edge_scenes, view):
    """planes and planes_finite: the middle row's rays leave y = 1 with y
    exactly 0, the middle column's leave x = 0 with x exactly 0; the far
    views: the middle ray runs exactly along x from 100,000 out, inside the
    slivers' y and z extent, so it meets the infinite bound's plane."""
    t = megakernel._Tables(edge_scenes[view], W, H, 0, False)
    seed = torch.zeros(W + H, dtype=torch.int64)
    x = torch.cat([torch.arange(W), torch.full((H,), W // 2)])
    y = torch.cat([torch.full((W,), H // 2), torch.arange(H)])
    o, d, _ = megakernel._camera_ray(t, x, y, seed, False)
    row, col = slice(0, W), slice(W, W + H)
    if view.startswith("planes"):
        assert bool((d[row, 1] == 0).all()) and bool((o[row, 1] == 1).all())
        assert bool((d[col, 0] == 0).all()) and bool((o[col, 0] == 0).all())
    else:
        sign = 1.0 if view == "minus_x" else -1.0
        mid = W // 2
        assert d[mid].tolist() == [sign, 0.0, 0.0]
        assert o[mid].tolist() == [-sign * 1e5, 0.5, -5.25]


def test_edge_scene_renders_on_the_cpu(edge_scenes):
    """The plain version walks the planes views' tree (leaves visited) and
    the far views' roots, finite everywhere."""
    for view, scene in edge_scenes.items():
        c = {}
        img, segs = megakernel.render_plain(
            scene, 1, width=33, height=19, bounces=1, rays_per_pixel=1,
            skybox=True, counts=c)
        assert bool(torch.isfinite(img).all()) and int(segs) > 0
        assert (c["leaves"] > 0) == view.startswith("planes")


def _leaf_with_inf_patterns() -> np.ndarray:
    """A leaf row whose geometry words hold the f16 -inf in their low half
    and +inf in their high half, as no interior row of a finite scene
    may."""
    r = np.zeros(ROW_WIDTH, np.float32)
    r[COL_COUNT] = 8.0
    r.view(np.uint32)[COL_LEAF_GEO:COL_LEAF_GEO + 96] = 0x7C00FC00
    return r


def _as_interior(row: np.ndarray) -> np.ndarray:
    row[COL_COUNT] = 0.0
    return row


def _scene(build, **kw):
    return lambda: instantiate_scene(getattr(scenes, build)(), **kw)


def _rows(make):
    return lambda: SimpleNamespace(wide_rows=torch.from_numpy(make()))


# name -> (what finite_boxes looks at, what it decides)
FINITE_CASES = {
    "sponza": (_scene("sponza"), True),
    "room": (_scene("room"), True),
    "random_balls_sphere_bvh": (_scene("random_balls", sphere_bvh=True),
                                True),
    "wide_bvh_scene": (_scene("wide_bvh_scene"), True),
    "planes_finite": (lambda: instantiated("planes_finite"), True),
    "bound_past_plus_65504": (lambda: instantiated("planes",
                                                   slivers=(7e4,)), False),
    "bound_past_minus_65504": (lambda: instantiated("planes",
                                                    slivers=(-7e4,)), False),
    "empty_slots_only": (_rows(lambda: _row([UNIT], 1)[None]), True),
    "leaf_geometry_inf_patterns": (_rows(lambda: np.stack(
        [_row([UNIT] * 3), _leaf_with_inf_patterns()])), True),
    "interior_inf_patterns": (_rows(lambda: np.stack(
        [_row([UNIT] * 3), _as_interior(_leaf_with_inf_patterns())])),
        False),
}


@pytest.mark.parametrize("case", list(FINITE_CASES))
def test_finite_boxes(case):
    """Whether a scene's child bounds are all finite, so that the kernel may
    take its child-box loop without clamps: true on the scenes the kernel
    renders (the sphere BVH's world-space boxes included), false where one
    child bound lies past +65,504 or past -65,504 (the packer's f16 +inf
    or -inf), true where the only infinities are the empty slots' (lo +inf,
    hi -inf) and where only a leaf row's geometry words hold those bit
    patterns; the same words in an interior row clear it."""
    make, want = FINITE_CASES[case]
    scene = make()
    rows = scene.wide_rows.numpy()
    words = rows[rows[:, COL_COUNT] == 0.0,
                 COL_CHILD_AABB:COL_CHILD_AABB + 96].view(np.uint32)
    assert ((words & 0xFFFF) == 0x7C00).any()   # empty slots in every case
    if isinstance(scene, SimpleNamespace):
        assert megakernel._finite_boxes(scene) is want
    else:
        assert megakernel.finite_boxes(scene) is want
