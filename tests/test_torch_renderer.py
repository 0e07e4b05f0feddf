"""The port's Renderer against the reference's progressive render_frame.

Frames 0, 1 and 2 at bounces=0 on the wide-BVH scene accumulate with the
reference's weight 1/(frames+1); each frame's image must agree with JAX
``render_frame(fused_boundary=True)`` in the primary class (segments exact,
>= 99% of pixels within 1e-5). A 72-triangle mesh (brute force, bounces
0) and ``room`` with antialias (bounces 3) render through
``render_persistent`` and agree with JAX ``render_persistent`` (XLA
boundary) in the primary and the chaos class (measured: every pixel within
1e-5, segments exact, in both); so does ``room`` with next-event
estimation. On the CPU no kernel is launched. Textured scenes and normal
maps, which raised ``NotImplementedError`` until their slice, render
through the megakernel's path, small scenes included; so do the debug
modes now, through the plain debug path (``random_balls`` with antialias,
which raised too, renders: ``tests/test_torch_spheres_renderer.py``).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

import ray_tracer_2_tpu_torch.engine.renderer as renderer_mod
from ray_tracer_2_tpu.engine.export import \
    framebuffer_to_srgb as ref_framebuffer_to_srgb
from ray_tracer_2_tpu.engine.renderer import render_frame as ref_render_frame
from ray_tracer_2_tpu.kernels.megakernel import \
    render_persistent as ref_render_persistent
from ray_tracer_2_tpu.scene.render_scene import \
    instantiate_scene as ref_instantiate
from ray_tracer_2_tpu_torch.config import DebugMode, RenderParams
from ray_tracer_2_tpu_torch.engine.export import framebuffer_to_srgb
from ray_tracer_2_tpu_torch.engine.renderer import Renderer
from ray_tracer_2_tpu_torch.kernels.brute import CUDA_BRUTE
from ray_tracer_2_tpu_torch.kernels.debug import render_debug_plain
from ray_tracer_2_tpu_torch.kernels.megakernel import CUDA_MEGAKERNEL, \
    render_plain
from ray_tracer_2_tpu_torch.kernels.spheres import CUDA_SPHERES
from ray_tracer_2_tpu_torch.scene import scenes
from ray_tracer_2_tpu_torch.scene.material import MaterialFlag
from ray_tracer_2_tpu_torch.scene.render_scene import instantiate_scene
from torch_bridge import (
    H, W, frac_within, ref_definition, torch_scene, wide_bvh_render_scene,
)

PARAMS = RenderParams(width=W, height=H, bounces=0, rays_per_pixel=1,
                      skybox=True)


@pytest.fixture(scope="module")
def scenes_():
    rs = wide_bvh_render_scene()
    return rs, torch_scene(rs)


def test_progressive_frames_match_reference(scenes_):
    rs, ts = scenes_
    renderer = Renderer(device="cpu")
    launches = CUDA_MEGAKERNEL.launches
    fb = jnp.zeros((H, W, 4), jnp.float32)
    for f in range(3):
        fb, segs = ref_render_frame(
            rs, fb, jnp.int32(f), jnp.float32(100.0), width=W, height=H,
            bounces=0, rays_per_pixel=1, skybox=True, debug_mode=0,
            tile_rows=8, lanes=128, unroll=2, fused_boundary=True)
        out = renderer.render(ts, dataclasses.replace(PARAMS, frames=f))
        assert out is renderer.framebuffer and tuple(out.shape) == (H, W, 4)
        assert int(renderer.last_segments) == int(float(segs)) == W * H
        assert frac_within(np.asarray(fb), renderer.read_framebuffer()) \
            >= 0.99
    assert CUDA_MEGAKERNEL.launches == launches


def _textured(ts):
    """``ts`` with its first material textured, as a scene carrying a
    texture atlas would hold it."""
    rows = ts.mat_rows.clone()
    rows[0, 21] = float(MaterialFlag.TEXTURE)
    rows[0, 22] = 0.0
    return dataclasses.replace(ts, mat_rows=rows,
                               shade_classes=ts.shade_classes + ("texture",))


def test_outside_the_slice_raises(scenes_):
    """Nothing is outside the ported paths now. A debug frame (which raised,
    naming ROADMAP Queue 1 item 4, until its slice) renders as the plain
    debug path renders it, with no segments. A textured material, with and
    without antialias, renders as ``render_plain`` renders it, and normal
    maps on a scene without them render the image without them (both
    raised, naming item 3, until their slice)."""
    _, ts = scenes_
    renderer = Renderer(device="cpu")
    params = dataclasses.replace(PARAMS, bounces=2)
    kw = dict(width=W, height=H, bounces=2, rays_per_pixel=1, skybox=True)
    textured = _textured(ts)
    for aa in (False, True):
        out = renderer.render(textured, dataclasses.replace(
            params, antialias=aa)).numpy()
        want, _ = render_plain(textured, 0, antialias=aa, **kw)
        assert np.array_equal(out, want.numpy())
    plain, _ = render_plain(ts, 0, **kw)
    assert not np.array_equal(plain.numpy(), out)
    out = renderer.render(ts, dataclasses.replace(params, normal_maps=True))
    assert np.array_equal(out.numpy(), plain.numpy())
    out = renderer.render(ts, dataclasses.replace(
        PARAMS, debug_mode=DebugMode.NORMALS))
    want, _ = render_debug_plain(ts, width=W, height=H, debug_mode=1,
                                 debug_scale=100.0)
    assert np.array_equal(out.numpy(), want.numpy())
    assert int(renderer.last_segments) == 0


@pytest.mark.parametrize("which", ["textured", "normal_maps"])
def test_small_scene_with_textures_goes_through_the_megakernel(
        monkeypatch, which):
    """A small scene (spheres, <= 64 triangles) with a textured material,
    or rendered with normal maps, goes through ``render_persistent``: the
    small-scene kernel is untextured, as the reference's ``eligible`` and
    its routing keep it. The frame is the plain version's."""
    from ray_tracer_2_tpu_torch.assets.manager import AssetManager
    assets = AssetManager()
    if which == "textured":
        ts = instantiate_scene(scenes.textured_variant(scenes.metal(), assets,
                                                       every=2), assets)
        opts = {}
    else:
        ts = instantiate_scene(scenes.normal_map_scene(assets), assets)
        opts = dict(normal_maps=True)
    assert renderer_mod.small_scene(ts) == (which == "normal_maps")
    calls = []
    real = renderer_mod.render_persistent
    monkeypatch.setattr(renderer_mod, "render_persistent",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    monkeypatch.setattr(renderer_mod.spheres, "render_spheres", None)
    params = dataclasses.replace(PARAMS, bounces=2, **opts)
    out = Renderer(device="cpu").render(ts, params).numpy()
    want, _ = render_plain(ts, 0, width=W, height=H, bounces=2,
                           rays_per_pixel=1, skybox=True, **opts)
    assert len(calls) == 1 and calls[0]["normal_maps"] == bool(opts)
    assert np.array_equal(out, want.numpy())


def test_nee_goes_through_the_megakernel(monkeypatch):
    """Next-event estimation renders through ``render_persistent`` even on
    ``room``, which would otherwise take the small-scene path (the
    reference keeps NEE off its small-scene kernel): a lit, finite image,
    the plain version's with ``nee=True``, and no kernel launched."""
    ts = instantiate_scene(scenes.room())
    assert renderer_mod.small_scene(ts) and len(ts.lights) == 2
    calls = []
    real = renderer_mod.render_persistent
    monkeypatch.setattr(renderer_mod, "render_persistent",
                        lambda *a, **k: calls.append(k["nee"])
                        or real(*a, **k))
    monkeypatch.setattr(renderer_mod.spheres, "render_spheres", None)
    launches = (CUDA_MEGAKERNEL.launches, CUDA_SPHERES.launches)
    params = dataclasses.replace(PARAMS, bounces=3, skybox=False, nee=True)
    out = Renderer(device="cpu").render(ts, params).numpy()
    want, _ = render_plain(ts, 0, width=W, height=H, bounces=3,
                           rays_per_pixel=1, skybox=False, nee=True)
    assert calls == [True]
    assert np.isfinite(out).all() and (out[..., :3] > 0).any(-1).mean() > 0.1
    assert np.array_equal(out, want.numpy())
    assert (CUDA_MEGAKERNEL.launches, CUDA_SPHERES.launches) == launches


def test_brute_force_mesh_renders():
    """The 72-triangle mesh (too many triangles for the small-scene path,
    brute-force size for the megakernel) renders through
    ``render_persistent``: segments exact and every pixel within 1e-5 of
    JAX ``render_persistent`` at bounces 0."""
    rs = ref_instantiate(ref_definition(
        scenes.wide_bvh_scene(lat=4, lon=9))).render_scene
    ts = torch_scene(rs)
    renderer = Renderer(device="cpu")
    renderer.render(ts, dataclasses.replace(PARAMS, frames=0))
    ref, segs = ref_render_persistent(
        rs, jnp.int32(0), width=W, height=H, bounces=0, rays_per_pixel=1,
        skybox=True, lanes=128, unroll=2, fused_boundary=False)
    assert int(renderer.last_segments) == int(float(segs)) == W * H
    assert frac_within(np.asarray(ref), renderer.read_framebuffer()) == 1.0


@pytest.mark.parametrize("renderer_device,scene_device",
                         [("cuda", "cpu"), ("cpu", "meta")])
def test_scene_on_another_device_raises(scenes_, renderer_device,
                                        scene_device):
    """The renderer never moves a scene: a scene on another device than the
    renderer's raises before anything is allocated or rendered."""
    _, ts = scenes_
    renderer = Renderer(device=renderer_device)
    with pytest.raises(ValueError, match="scene.to"):
        renderer.render(ts.to(scene_device), PARAMS)
    assert renderer.framebuffer is None


def test_export_matches_reference():
    fb = np.random.default_rng(0).uniform(-0.2, 1.5, size=(H, W, 4)) \
        .astype(np.float32)
    assert np.array_equal(framebuffer_to_srgb(fb), ref_framebuffer_to_srgb(fb))


def test_room_antialias_goes_through_the_megakernel(monkeypatch):
    """``room`` is a small scene, but antialias sends it to
    ``render_persistent`` (reference ``_use_pallas_spheres``); two
    progressive frames agree with JAX ``render_persistent`` plus the blend
    (bounces 3, rpp 2: segments within 2%, >= 99% of pixels within 1e-5),
    and no kernel is launched."""
    rs = ref_instantiate(ref_definition(scenes.room())).render_scene
    ts = torch_scene(rs)
    W, H = 48, 27
    calls = []
    real = renderer_mod.render_persistent
    monkeypatch.setattr(renderer_mod, "render_persistent",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    launches = (CUDA_MEGAKERNEL.launches, CUDA_SPHERES.launches,
                CUDA_BRUTE.launches)
    params = RenderParams(width=W, height=H, bounces=3, rays_per_pixel=2,
                          skybox=True, antialias=True)
    renderer = Renderer(device="cpu")
    fb = jnp.zeros((H, W, 4), jnp.float32)
    for f in range(2):
        sample, segs = ref_render_persistent(
            rs, jnp.int32(f), width=W, height=H, bounces=3,
            rays_per_pixel=2, skybox=True, antialias=True, lanes=128,
            unroll=2, fused_boundary=False)
        w = 1.0 / (f + 1.0) if f >= 1 else 1.0
        fb = fb * (1.0 - w) + sample * w
        renderer.render(ts, dataclasses.replace(params, frames=f))
        assert abs(int(renderer.last_segments) - int(float(segs))) \
            <= 0.02 * int(float(segs))
        assert frac_within(np.asarray(fb), renderer.read_framebuffer()) \
            >= 0.99, f
    assert len(calls) == 2
    assert (CUDA_MEGAKERNEL.launches, CUDA_SPHERES.launches,
            CUDA_BRUTE.launches) == launches
