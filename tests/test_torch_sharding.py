"""Multi-card rendering on the CPU (``ray_tracer_2_tpu_torch/parallel``):
a twin of each test of ``tests/test_multidevice.py``, on meshes that name
the CPU n times.

Each twin holds the port's sharded frame against two things:

* **the port's single-device frame.** Row tiles, sample rounds and the 2-D
  mesh render through the same plain versions, so the segments are exact.
  The pixels are bit-equal at ``bounces=0`` and in the debug modes. At
  ``bounces>0`` they agree within ``ULP_TOL``: on the CPU PyTorch rounds a
  transcendental by an ulp with a pixel's place in a batch (SIMD lanes
  against scalar tails; PERF.md, section 6), and a row window moves that place.
  The card's kernels give every pixel its own path, and ``chip_smoke.py``
  holds the same frames bit-equal there.
* **the JAX function itself** (``render_frame_sharded``,
  ``render_frame_spp_sharded``, ``render_frame_hybrid_sharded``, the
  reference ``Renderer``'s auto mesh), on the conftest's 8 CPU devices,
  each call under ``jax.jit``. At ``bounces=0`` the pixels agree within
  ``PRIMARY_TOL`` (1e-6) and the segments are exact; above it, in the chaos
  class (c) of ROADMAP: segments within ``CHAOS_SEGS`` and at least
  ``CHAOS_FRAC`` of pixels within 1e-5 (XLA contracts into FMAs where the
  port does not, so a rare path flips). The debug frame agrees within the
  reference test's own 1e-5. Measured on the CPU: at bounces 0 every
  pixel within 6e-8 of JAX's; at bounces 1-2 segments exact on ``metal``
  (1 of 1,300 off on the wide-BVH scene) and 99.8-100% of pixels within
  1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tracer_2_tpu.config import DebugMode as RefDebugMode
from ray_tracer_2_tpu.config import RenderParams as RefParams
from ray_tracer_2_tpu.engine.renderer import Renderer as RefRenderer
from ray_tracer_2_tpu.parallel import sharding as ref
from ray_tracer_2_tpu.scene import scenes as ref_scenes
from ray_tracer_2_tpu.scene.render_scene import \
    instantiate_scene as ref_instantiate
from ray_tracer_2_tpu_torch.config import DebugMode, RenderParams
from ray_tracer_2_tpu_torch.engine.renderer import Renderer, render_frame, \
    render_sample
from ray_tracer_2_tpu_torch.kernels.megakernel import CUDA_MEGAKERNEL
from ray_tracer_2_tpu_torch.parallel import sharding
from ray_tracer_2_tpu_torch.parallel.sharding import (
    make_render_mesh, make_render_mesh2d, render_frame_hybrid_sharded,
    render_frame_sharded, render_frame_spp_sharded, replicate_scene,
    shard_framebuffer,
)
from torch_bridge import frac_within, torch_scene, wide_bvh_render_scene
from torch_bridge import one_torch_thread  # noqa: F401 (autouse)

ULP_TOL = 1e-6
PRIMARY_TOL = 1e-6
CHAOS_SEGS = 0.02
CHAOS_FRAC = 0.99
KW = dict(rays_per_pixel=1, skybox=True)


def cpu_mesh(n):
    return make_render_mesh(devices=["cpu"] * n)


@pytest.fixture(scope="module")
def metal():
    rs = ref_instantiate(ref_scenes.metal()).render_scene
    return rs, torch_scene(rs)


def _zeros(w, h):
    return torch.zeros((h, w, 4), dtype=torch.float32)


def _single(ts, w, h, bounces, frames, **opts):
    fb, segs = render_frame(ts, _zeros(w, h), frames, width=w, height=h,
                            bounces=bounces, **KW, **opts)
    return fb.numpy(), int(segs)


def _sharded(ts, mesh, w, h, bounces, frames, **opts):
    fb = shard_framebuffer(_zeros(w, h), mesh)
    out, segs = render_frame_sharded(ts, fb, frames, 1.0, mesh=mesh,
                                     width=w, height=h, bounces=bounces,
                                     **KW, **opts)
    assert segs.dtype == torch.int64 and out is fb
    return np.asarray(out), int(segs)


def _ref_sharded(rs, n, w, h, bounces, frames):
    mesh = ref.make_render_mesh(n)
    step = jax.jit(lambda s, fb, f: ref.render_frame_sharded(
        s, fb, f, 1.0, mesh=mesh, width=w, height=h, bounces=bounces,
        tile_rows=4, **KW))
    fb = ref.shard_framebuffer(jnp.zeros((h, w, 4), jnp.float32), mesh)
    out, segs = step(ref.replicate_scene(rs, mesh), fb, jnp.int32(frames))
    return np.asarray(out), int(float(segs))


def _against_single(got, want, bounces):
    """The port's sharded frame against its single-device frame."""
    (a, sa), (b, sb) = got, want
    assert sa == sb
    if bounces == 0:
        assert a.tobytes() == b.tobytes()
    else:
        np.testing.assert_allclose(a, b, rtol=0, atol=ULP_TOL)


def _against_jax(got, want, bounces):
    """The port's frame against the JAX function's."""
    (a, sa), (b, sb) = got, want
    assert np.isfinite(a).all()
    if bounces == 0:
        assert sa == sb
        np.testing.assert_allclose(a, b, rtol=0, atol=PRIMARY_TOL)
    else:
        assert abs(sa - sb) <= CHAOS_SEGS * sb, (sa, sb)
        assert frac_within(a, b, 1e-5) >= CHAOS_FRAC


def test_eight_repeated_devices():
    """The twin of the 8 fake devices: a mesh names the CPU 8 times (one
    distinct device, which is home); JAX has its 8. Without a card, a mesh
    of the host's cards raises, as does one that names ``cuda``."""
    assert len(jax.devices()) == 8
    mesh = cpu_mesh(8)
    assert mesh.size == 8 and mesh.shape == {"rows": 8}
    assert mesh.distinct == (torch.device("cpu"),)
    assert mesh.home == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_render_mesh()
        with pytest.raises(RuntimeError):
            make_render_mesh(devices=["cuda"] * 2)
        assert sharding.auto_mesh(64) is None


@pytest.mark.parametrize("bounces", [0, 2])
def test_row_sharded_matches_single_device(metal, bounces):
    """Row tiles of ``metal`` (the small-scene path, each tile a row window
    of ``render_spheres``) over 8 devices at 32x32, frame 2."""
    rs, ts = metal
    got = _sharded(ts, cpu_mesh(8), 32, 32, bounces, 2)
    _against_single(got, _single(ts, 32, 32, bounces, 2), bounces)
    _against_jax(got, _ref_sharded(rs, 8, 32, 32, bounces, 2), bounces)


def test_spp_sharded_converges(metal):
    """A round of 8 samples: the mean of the 8 single-device frames at
    RNG frames 0-7, summed in device order and divided by 8 (bit-equal),
    visibly smoother than one sample, and the JAX round in the chaos
    class."""
    rs, ts = metal
    w = h = 16
    mesh = cpu_mesh(8)
    fb = _zeros(w, h)
    out, segs = render_frame_spp_sharded(ts, fb, 0, mesh=mesh, width=w,
                                         height=h, bounces=2, **KW)
    out = out.numpy()
    samples = [render_sample(ts, f, width=w, height=h, bounces=2, **KW)
               for f in range(8)]
    acc = samples[0][0].numpy()
    for s, _ in samples[1:]:
        acc = acc + s.numpy()
    assert out.tobytes() == (acc / np.float32(8)).tobytes()
    assert int(segs) == sum(int(s) for _, s in samples)
    assert np.isfinite(out).all() and out[..., :3].max() > 0

    def tv(img):
        return np.abs(np.diff(img[..., :3], axis=0)).mean()

    assert tv(out) < tv(samples[0][0].numpy())
    mesh_r = ref.make_render_mesh()
    step = jax.jit(lambda s, b, f: ref.render_frame_spp_sharded(
        s, b, f, mesh=mesh_r, width=w, height=h, bounces=2, tile_rows=4,
        **KW))
    want, wsegs = step(ref.replicate_scene(rs, mesh_r),
                       jnp.zeros((h, w, 4), jnp.float32), jnp.int32(0))
    _against_jax((out, int(segs)), (np.asarray(want), int(float(wsegs))), 2)


def test_row_sharded_wide_bvh_matches_single_device():
    """The wide-BVH walk (a 1,496-triangle instance) row-sharded through
    the megakernel's plain version."""
    rs = wide_bvh_render_scene()
    ts = torch_scene(rs)
    assert any(c > 1024 for _, _, c in ts.inst_spans)
    got = _sharded(ts, cpu_mesh(8), 32, 32, 2, 1)
    _against_single(got, _single(ts, 32, 32, 2, 1), 2)
    _against_jax(got, _ref_sharded(rs, 8, 32, 32, 2, 1), 2)


def test_row_sharded_sphere_bvh_matches_single_device(monkeypatch):
    """The sphere BVH (``random_balls`` with it forced) row-sharded."""
    monkeypatch.setenv("RT2_SPHERE_BVH", "1")
    rs = ref_instantiate(ref_scenes.random_balls()).render_scene
    ts = torch_scene(rs)
    assert ts.sphere_bvh_root >= 0
    got = _sharded(ts, cpu_mesh(8), 32, 16, 2, 1)
    _against_single(got, _single(ts, 32, 16, 2, 1), 2)
    _against_jax(got, _ref_sharded(rs, 8, 32, 16, 2, 1), 2)


@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
def test_hybrid_mesh_matches_composed_single_device(metal, shape):
    """Rows x spp: round k's S samples of each block are the single-device
    frames at RNG frames k*S + j, their mean blended at 1/(k+1); segments
    exact over both axes."""
    rs, ts = metal
    w = h = 16
    R, S = shape
    frames = 2
    mesh = make_render_mesh2d(R, S, ["cpu"] * (R * S))
    samples, seg_sum = [], 0
    for j in range(S):
        smp, segs = render_sample(ts, frames * S + j, width=w, height=h,
                                  bounces=2, **KW)
        samples.append(smp.numpy())
        seg_sum += int(segs)
    acc = samples[0]
    for s in samples[1:]:
        acc = acc + s
    weight = np.float32(1.0) / np.float32(frames + 1)
    expected = (acc / np.float32(S)) * weight   # the prior buffer is zero
    fb = shard_framebuffer(_zeros(w, h), mesh)
    out, segs = render_frame_hybrid_sharded(ts, fb, frames, mesh=mesh,
                                            width=w, height=h, bounces=2,
                                            **KW)
    got = (np.asarray(out), int(segs))
    _against_single(got, (expected, seg_sum), 2)
    mesh_r = ref.make_render_mesh2d(R, S)
    step = jax.jit(lambda s, b, f: ref.render_frame_hybrid_sharded(
        s, b, f, mesh=mesh_r, width=w, height=h, bounces=2, tile_rows=4,
        **KW))
    want, wsegs = step(ref.replicate_scene(rs, mesh_r),
                       ref.shard_framebuffer(jnp.zeros((h, w, 4),
                                                       jnp.float32), mesh_r),
                       jnp.int32(frames))
    _against_jax(got, (np.asarray(want), int(float(wsegs))), 2)


def test_uneven_mesh_subset(metal):
    """A 4-device sub-mesh at frame -1 (an overwrite), one bounce."""
    rs, ts = metal
    got = _sharded(ts, make_render_mesh(4, ["cpu"] * 8), 16, 16, 1, -1)
    assert np.isfinite(got[0]).all()
    _against_single(got, _single(ts, 16, 16, 1, -1), 1)
    _against_jax(got, _ref_sharded(rs, 4, 16, 16, 1, -1), 1)


def test_renderer_auto_mesh_bitequal_with_flags(metal, monkeypatch):
    """``Renderer``'s default mesh with NEE and antialias on (the megakernel
    path): here ``auto`` finds no card and adopts nothing; with the host's
    cards stood in for by a CPU mesh of 8 it adopts that, and its frame is
    the single-device renderer's. The JAX ``Renderer`` adopts its 8
    devices."""
    rs, ts = metal
    w = h = 32
    p = RenderParams(width=w, height=h, bounces=2, rays_per_pixel=1,
                     skybox=True, frames=1, nee=True, antialias=True)
    plain = Renderer(device="cpu")
    plain.render(ts, p)
    assert plain.mesh is None and isinstance(plain.framebuffer,
                                             torch.Tensor)
    monkeypatch.setattr(sharding, "auto_mesh",
                        lambda height, device: cpu_mesh(8))
    auto = Renderer(device="cpu")
    single = Renderer(device="cpu", mesh=None)
    launches = CUDA_MEGAKERNEL.launches
    fb_a = auto.render(ts, p)
    fb_s = single.render(ts, p)
    assert auto.mesh is not None and auto.mesh.size == 8
    assert isinstance(fb_a, sharding.ShardedFramebuffer)
    assert auto.read_framebuffer().shape == (h, w, 4)
    got = (auto.read_framebuffer(), int(auto.last_segments))
    _against_single(got, (fb_s.numpy(), int(single.last_segments)), 2)
    assert CUDA_MEGAKERNEL.launches == launches
    rp = dataclasses.replace(RefParams(width=w, height=h, bounces=2,
                                       rays_per_pixel=1, skybox=True,
                                       frames=1), nee=True, antialias=True)
    jr = RefRenderer()
    want = np.asarray(jr.render(rs, rp))
    assert jr.mesh is not None
    _against_jax(got, (want, int(float(jr.last_segments))), 2)


def test_renderer_auto_mesh_debug_mode(metal):
    """Debug frames run row-sharded too, through the debug path's row
    window: bit-equal to the single-device frame."""
    rs, ts = metal
    w = h = 32
    p = RenderParams(width=w, height=h, bounces=1, rays_per_pixel=1,
                     skybox=True, frames=0, debug_mode=DebugMode.NORMALS)
    mesh = cpu_mesh(8)
    sharded = Renderer(device="cpu", mesh=mesh).render(ts, p)
    single = Renderer(device="cpu", mesh=None).render(ts, p)
    assert np.asarray(sharded).tobytes() == single.numpy().tobytes()
    rp = RefParams(width=w, height=h, bounces=1, rays_per_pixel=1,
                   skybox=True, frames=0, debug_mode=RefDebugMode.NORMALS)
    want = np.asarray(RefRenderer(tile_rows=4, tile_cols=16).render(rs, rp))
    np.testing.assert_allclose(np.asarray(sharded), want, atol=1e-5,
                               rtol=1e-5)
