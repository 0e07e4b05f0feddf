"""The port's Renderer against the reference's progressive render_frame.

Frames 0, 1 and 2 at bounces=0 on the wide-BVH scene accumulate with the
reference's weight 1/(frames+1); each frame's image must agree with JAX
``render_frame(fused_boundary=True)`` in the primary class (segments exact,
>= 99% of pixels within 1e-5). On the CPU the kernel is never launched, and
scenes or options outside the ported slice raise ``NotImplementedError``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from ray_tracer_2_tpu.engine.export import \
    framebuffer_to_srgb as ref_framebuffer_to_srgb
from ray_tracer_2_tpu.engine.renderer import render_frame as ref_render_frame
from ray_tracer_2_tpu.scene import scenes as ref_scenes
from ray_tracer_2_tpu.scene.render_scene import \
    instantiate_scene as ref_instantiate
from ray_tracer_2_tpu_torch.config import DebugMode, RenderParams
from ray_tracer_2_tpu_torch.engine.export import framebuffer_to_srgb
from ray_tracer_2_tpu_torch.engine.renderer import Renderer
from ray_tracer_2_tpu_torch.kernels.megakernel import CUDA_MEGAKERNEL
from ray_tracer_2_tpu_torch.scene import scenes
from ray_tracer_2_tpu_torch.scene.render_scene import instantiate_scene
from torch_bridge import H, W, frac_within, torch_scene, wide_bvh_render_scene

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


def test_outside_the_slice_raises(scenes_):
    """Outside both ported paths: a 72-triangle mesh (too many triangles
    for the small-scene path, brute-force size for the main path), and the
    small scene room with antialias."""
    _, ts = scenes_
    mesh72 = instantiate_scene(scenes.wide_bvh_scene(lat=4, lon=9))
    room = torch_scene(ref_instantiate(ref_scenes.room()).render_scene)
    renderer = Renderer()
    for scene, over in ((mesh72, {}), (room, dict(antialias=True))):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            renderer.render(scene, dataclasses.replace(PARAMS, **over))
    for over in (dict(debug_mode=DebugMode.NORMALS), dict(nee=True),
                 dict(normal_maps=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            renderer.render(ts, dataclasses.replace(PARAMS, **over))


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
