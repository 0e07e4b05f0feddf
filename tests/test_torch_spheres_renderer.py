"""The small-scene path with bounces, and behind ``Renderer`` routing.

Bounced class (reference ``tests/test_pallas_spheres.py``, whose kernel and
XLA path differ the same way): at bounces=3, rpp=2 the plain PyTorch
``render_spheres`` is held against ``render_spheres_pallas(interpret=True)``
at 32x16 in frames 1 and 2. XLA on the CPU rounds ``rsqrt``, ``exp``,
``log`` and ``cos`` differently from PyTorch, so a rare path flips. Measured
(32x16, frames 1/2): balls and room segments exact, every pixel within
1e-3; random_balls segments off by 2 of 1881 in frame 1 (0.11%), 99.41% and
100% of pixels within 1e-3. Held to segments within 0.2% and >= 99% of
pixels within 1e-3 (the reference's own classes are 1-2% and 95%).

``Renderer.render`` routes small scenes to ``render_spheres`` and every
other scene to ``render_persistent``; over three progressive frames of
metal it equals a loop of the reference kernel plus the ``1/(frames+1)``
blend (primary class: >= 99.9% of pixels within 1e-5; measured all).
A small scene asked for antialias goes to ``render_persistent`` instead, as
in the reference: ``metal`` at bounces 3 then agrees with JAX
``render_persistent`` in the chaos class (segments within 2%, >= 99% of
pixels within 1e-5; measured: segments exact, one pixel of 512 off), and
``random_balls`` (485 spheres, the megakernel's dense fast loop) at bounces
0 in the primary class (segments exact, >= 99% of pixels within 1e-5;
measured: every pixel).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

import ray_tracer_2_tpu_torch.engine.renderer as renderer_mod
from ray_tracer_2_tpu.kernels.megakernel import \
    render_persistent as ref_render_persistent
from ray_tracer_2_tpu.kernels.pallas_spheres import render_spheres_pallas
from ray_tracer_2_tpu.scene import scenes as ref_scenes
from ray_tracer_2_tpu.scene.render_scene import \
    instantiate_scene as ref_instantiate
from ray_tracer_2_tpu_torch.config import RenderParams
from ray_tracer_2_tpu_torch.engine.renderer import Renderer, small_scene
from ray_tracer_2_tpu_torch.kernels.megakernel import CUDA_MEGAKERNEL
from ray_tracer_2_tpu_torch.kernels.spheres import CUDA_SPHERES, \
    render_spheres
from torch_bridge import H, W, frac_within, torch_scene, \
    wide_bvh_render_scene
from torch_bridge import one_torch_thread  # noqa: F401 (autouse)

PARAMS = RenderParams(width=W, height=H, bounces=0, rays_per_pixel=1,
                      skybox=True)


def _pair(name):
    rs = ref_instantiate(getattr(ref_scenes, name)()).render_scene
    return rs, torch_scene(rs)


@pytest.mark.parametrize("name", ["balls", "random_balls", "room"])
def test_bounced_class(name):
    rs, ts = _pair(name)
    kw = dict(width=W, height=H, bounces=3, rays_per_pixel=2, skybox=True)
    for f in (1, 2):
        a, sa = render_spheres_pallas(rs, jnp.int32(f), interpret=True, **kw)
        b, sb = render_spheres(ts, f, **kw)
        a, sa, b, sb = np.asarray(a), int(float(sa)), b.numpy(), int(sb)
        assert np.isfinite(b).all()
        assert abs(sa - sb) <= 0.002 * sa, (f, sa, sb)
        assert frac_within(a, b, 1e-3) >= 0.99, f


def test_progressive_frames_match_reference():
    rs, ts = _pair("metal")
    renderer = Renderer(device="cpu")
    launches = (CUDA_SPHERES.launches, CUDA_MEGAKERNEL.launches)
    fb = jnp.zeros((H, W, 4), jnp.float32)
    for f in range(3):
        sample, segs = render_spheres_pallas(
            rs, jnp.int32(f), width=W, height=H, bounces=0,
            rays_per_pixel=1, skybox=True, interpret=True)
        w = jnp.where(f >= 1, 1.0 / (jnp.float32(f) + 1.0), 1.0)
        fb = fb * (1.0 - w) + sample * w
        out = renderer.render(ts, dataclasses.replace(PARAMS, frames=f))
        assert out is renderer.framebuffer and tuple(out.shape) == (H, W, 4)
        assert int(renderer.last_segments) == int(float(segs)) == W * H
        assert frac_within(np.asarray(fb), renderer.read_framebuffer()) \
            >= 0.999
    assert (CUDA_SPHERES.launches, CUDA_MEGAKERNEL.launches) == launches


def test_routing(monkeypatch):
    """Small scenes take render_spheres, the wide-BVH scene
    render_persistent; the decision is kept with the scene."""
    calls = []

    def spy(module, name):
        real = getattr(module, name)

        def wrapped(*a, **k):
            calls.append(name)
            return real(*a, **k)
        monkeypatch.setattr(module, name, wrapped)

    spy(renderer_mod, "render_persistent")
    spy(renderer_mod.spheres, "render_spheres")
    wide = torch_scene(wide_bvh_render_scene())
    metal = _pair("metal")[1]
    for ts, route in ((wide, "render_persistent"), (metal, "render_spheres")):
        calls.clear()
        Renderer(device="cpu").render(ts, PARAMS)
        assert calls == [route]
        assert ts.derived["small_scene"] == (route == "render_spheres")
    assert small_scene(metal) and not small_scene(wide)


def test_antialias_on_a_small_scene_raises(monkeypatch):
    """random_balls with antialias goes to the megakernel, which raised at
    more than 32 dense spheres and now renders its 485 with the dense fast
    loop: through ``render_persistent``, not ``render_spheres``, and equal
    to JAX ``render_persistent`` (XLA boundary) at bounces 0."""
    rs, ts = _pair("random_balls")
    calls = []
    real = renderer_mod.render_persistent
    monkeypatch.setattr(renderer_mod, "render_persistent",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    renderer = Renderer(device="cpu")
    renderer.render(ts, dataclasses.replace(PARAMS, antialias=True))
    ref, segs = ref_render_persistent(
        rs, jnp.int32(0), width=W, height=H, bounces=0, rays_per_pixel=1,
        skybox=True, antialias=True, lanes=128, unroll=2,
        fused_boundary=False)
    assert calls == [1] and small_scene(ts)
    assert int(renderer.last_segments) == int(float(segs)) == W * H
    assert frac_within(np.asarray(ref), renderer.read_framebuffer()) >= 0.99


def test_antialias_on_a_small_scene_renders():
    """metal with antialias (bounces 3, rpp 2) renders through
    render_persistent and agrees with JAX render_persistent; no kernel is
    launched on the CPU."""
    rs, ts = _pair("metal")
    launches = (CUDA_SPHERES.launches, CUDA_MEGAKERNEL.launches)
    renderer = Renderer(device="cpu")
    renderer.render(ts, dataclasses.replace(PARAMS, bounces=3,
                                            rays_per_pixel=2,
                                            antialias=True))
    ref, segs = ref_render_persistent(
        rs, jnp.int32(0), width=W, height=H, bounces=3, rays_per_pixel=2,
        skybox=True, antialias=True, lanes=128, unroll=2,
        fused_boundary=False)
    assert abs(int(renderer.last_segments) - int(float(segs))) \
        <= 0.02 * int(float(segs))
    assert frac_within(np.asarray(ref), renderer.read_framebuffer()) >= 0.99
    assert (CUDA_SPHERES.launches, CUDA_MEGAKERNEL.launches) == launches
