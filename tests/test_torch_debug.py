"""The debug modes' plain version against the reference's
``debug_trace_pixels`` (``ray_tracer_2_tpu/kernels/trace.py:384``).

Both trace one unjittered primary ray a pixel to its closest hit and colour
it by mode, at 64x36. The reference's hit is ``compute_hit`` (binary BVH
traversal, XLA's float contraction), the port's the megakernel's segment
hit (``kernels/megakernel.py:_intersect``, the wide BVH), so modes 1-4 are
held to the primary class: >= 99% of pixels within 1e-5 (the rest are
silhouette flips of unjittered primaries, ROADMAP Queue 3). Modes 5-7 are
heat maps of the traversal's work, which the two packages count alike
where there is no tree: on ``room`` (brute-force groups) and ``metal``
(spheres) they must be equal, bit for bit. On the 1,496-triangle
``wide_bvh_scene`` the port counts child boxes of 32-ary rows where the
reference counts binary nodes, so there the heat maps are only held to
their definition: finite, and every pixel's counts those of its ray. The
normal-map quad (its material flagged TEXTURE, so mode 1 shows the map)
and the texture sphere (mode 3, spherical UVs) run with their images
mirrored into the reference's asset manager.
"""
import ctypes
import dataclasses
import re
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tracer_2_tpu.kernels.trace import debug_trace_pixels as ref_debug
from ray_tracer_2_tpu.scene import scenes as ref_scenes
from ray_tracer_2_tpu.scene.render_scene import \
    instantiate_scene as ref_instantiate
from ray_tracer_2_tpu_torch.assets.manager import AssetManager
from ray_tracer_2_tpu_torch.config import DebugMode, RenderParams
from ray_tracer_2_tpu_torch.engine.renderer import Renderer
from ray_tracer_2_tpu_torch.kernels.debug import CUDA_DEBUG, \
    render_debug_plain
from ray_tracer_2_tpu_torch.kernels.trace import debug_trace_pixels
from ray_tracer_2_tpu_torch.scene import scenes
from torch_bridge import (  # noqa: F401
    frac_within, one_torch_thread, ref_scene_pair, torch_scene,
    wide_bvh_render_scene,
)

DW, DH = 64, 36
NEED = 0.99
_Y, _X = np.meshgrid(np.arange(DH), np.arange(DW), indexing="ij")
X, Y = _X.reshape(-1).astype(np.int32), _Y.reshape(-1).astype(np.int32)


@partial(jax.jit, static_argnames="mode")
def _ref(rs, mode):
    return ref_debug(rs, jnp.asarray(X), jnp.asarray(Y), width=DW, height=DH,
                     debug_mode=mode, debug_scale=jnp.float32(100.0))


def _pair(name):
    if name == "metal":
        rs = ref_instantiate(ref_scenes.metal()).render_scene
    elif name == "room":
        rs = ref_instantiate(ref_scenes.room()).render_scene
    elif name == "wide_bvh":
        rs = wide_bvh_render_scene()
    else:
        assets = AssetManager()
        build = dict(normal_map=partial(scenes.normal_map_scene,
                                        mapped_flag=True),
                     texture_sphere=scenes.texture_sphere_scene)[name]
        return ref_scene_pair(build(assets), assets)
    return rs, torch_scene(rs)


@pytest.fixture(scope="module")
def pairs():
    return {}


def _scene(pairs, name):
    if name not in pairs:
        pairs[name] = _pair(name)
    return pairs[name]


CASES = [(s, m) for s in ("metal", "room") for m in range(1, 8)] \
    + [("wide_bvh", m) for m in range(1, 5)] \
    + [("normal_map", 1), ("texture_sphere", 3)]


@pytest.mark.parametrize("name,mode", CASES)
def test_plain_debug_matches_reference(pairs, name, mode):
    rs, ts = _scene(pairs, name)
    want = np.asarray(_ref(rs, mode))
    got = debug_trace_pixels(ts, torch.from_numpy(X), torch.from_numpy(Y),
                             width=DW, height=DH, debug_mode=mode,
                             debug_scale=100.0).numpy()
    assert got.shape == want.shape == (DW * DH, 4)
    if mode >= 5:
        assert np.array_equal(got, want)
    else:
        assert frac_within(got, want) >= NEED
    hit = want[:, 3] > 0.0
    if name in ("normal_map", "texture_sphere"):
        assert 0.05 < hit.mean() < 1.0, "the object fills part of the view"
    if name == "normal_map":
        # the map's two halves: flat (128, 128, 255) and tilted (255, 128,
        # 128), not the geometric normal (0, 0, 1) as n / 2 + 1 / 2
        rgb = np.round(got[hit, :3] * 255.0)
        assert (rgb[:, 0] > 200).any() and (rgb[:, 2] > 200).any()


def test_heat_maps_on_the_wide_bvh(pairs):
    """Where the reference walks a binary BVH, the port's heat maps count
    its own work: every pixel's node tests are the boxes of the rows its
    ray evaluated (at least the root row's), its triangle tests the
    triangles of the leaves it visited; mode 7 carries both."""
    _, ts = _scene(pairs, "wide_bvh")
    colours, counts = render_debug_plain(ts, width=DW, height=DH,
                                         debug_mode=5, debug_scale=100.0,
                                         modes=(5, 6, 7))
    boxes = counts[..., 0].to(torch.float32) / 100.0
    tris = counts[..., 1].to(torch.float32) / 100.0
    root_k = int(ts.wide_rows[ts.wide_roots[0], 13])
    assert int(counts[..., 0].min()) >= root_k
    assert int(counts[..., 1].max()) > 0
    assert torch.equal(colours[7][..., 0], tris)
    assert torch.equal(colours[7][..., 2], boxes)
    for m, v in ((5, boxes), (6, tris)):
        red = v > 1.0
        assert torch.equal(colours[m][..., 0][~red], v[~red])
        assert bool((colours[m][red] == torch.tensor([1.0, 0, 0, 1])).all())


def test_centre_pixel_normal():
    """The reference's check (``tests/test_render.py:96``): the centre pixel
    of ``metal`` looks at the red sphere head on, normal about +z, so the
    colour is about (0.5, 0.5, 1)."""
    ts = torch_scene(ref_instantiate(ref_scenes.metal()).render_scene)
    out = debug_trace_pixels(ts, torch.tensor([32]), torch.tensor([18]),
                             width=65, height=37, debug_mode=1,
                             debug_scale=100.0)
    np.testing.assert_allclose(out[0, :3].numpy(), [0.5, 0.5, 1.0],
                               atol=0.02)


def test_renderer_debug_frames(pairs):
    """Every debug mode through ``Renderer.render`` on the CPU: the plain
    debug path's colours blended with the frame weight 1/(frames+1) (a
    debug frame is deterministic, so frame 1 leaves frame 0's image), no
    segments, no kernel launched; an unknown mode is magenta."""
    _, ts = _scene(pairs, "room")
    launches = CUDA_DEBUG.launches
    for mode in range(1, 8):
        renderer = Renderer(device="cpu")
        p = RenderParams(width=DW, height=DH, debug_mode=DebugMode(mode))
        first = renderer.render(ts, p).clone()
        want, _ = render_debug_plain(ts, width=DW, height=DH,
                                     debug_mode=mode, debug_scale=100.0)
        assert torch.equal(first, want)
        again = renderer.render(ts, dataclasses.replace(p, frames=1))
        assert torch.allclose(again, first, atol=1e-6)
        assert int(renderer.last_segments) == 0
    assert CUDA_DEBUG.launches == launches
    magenta, _ = render_debug_plain(ts, width=4, height=2, debug_mode=9,
                                    debug_scale=100.0)
    assert bool((magenta == torch.tensor([1.0, 0.0, 1.0, 1.0])).all())


def test_debug_scale_scales_depth(pairs):
    """``debug_scale`` divides the depth (mode 2) and moves the focus
    threshold (mode 4), as a float32 division; the renderer clamps it to
    at least 1, as the reference does."""
    _, ts = _scene(pairs, "metal")
    d100, _ = render_debug_plain(ts, width=DW, height=DH, debug_mode=2,
                                 debug_scale=100.0)
    d10, _ = render_debug_plain(ts, width=DW, height=DH, debug_mode=2,
                                debug_scale=10.0)
    hit = d100[..., 3] > 0
    assert torch.allclose(d10[hit][:, 0], d100[hit][:, 0] * 10.0, rtol=1e-6)
    renderer = Renderer(device="cpu")
    out = renderer.render(ts, RenderParams(width=DW, height=DH,
                                           debug_mode=DebugMode.DEPTH,
                                           debug_scale=0))
    d1, _ = render_debug_plain(ts, width=DW, height=DH, debug_mode=2,
                               debug_scale=1.0)
    assert torch.equal(out, d1)


def test_argtypes_match_the_entry_point():
    """One ctypes type per parameter of ``rt2_render_debug``: pointers as
    ``c_void_p``, ints as ``c_int``, the scale as ``c_float``; the kernel
    is built from ``csrc/debug.cu`` over ``csrc/trace.cuh``, whose triangle
    count the debug translation unit switches on."""
    src = CUDA_DEBUG.source.read_text()
    m = re.search(r'extern "C" int rt2_render_debug\((.*?)\)\s*{', src,
                  re.S)
    params = [p.strip() for p in m.group(1).split(",")]
    assert len(params) == len(CUDA_DEBUG.argtypes)
    for p, t in zip(params, CUDA_DEBUG.argtypes):
        want = ctypes.c_void_p if "*" in p else \
            ctypes.c_float if p.startswith("float") else ctypes.c_int
        assert t is want, p
    assert params[-3].endswith("* out") and params[-2].endswith("* visits")
    define = src.index("#define RT2_TRACE_LEAF_TRIS")
    assert define < src.index('#include "trace.cuh"')
    header = (CUDA_DEBUG.source.parent / "trace.cuh").read_text()
    assert "#ifdef RT2_TRACE_LEAF_TRIS" in header
    assert "RT2_TRACE_LEAF_TRIS" not in \
        (CUDA_DEBUG.source.parent / "megakernel.cu").read_text()
