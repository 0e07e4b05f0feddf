"""Batched frames (``Renderer.render_batch``) against sequential renders:
n frames queued with no host synchronisation between them must be
bit-identical to n calls of ``Renderer.render``, with ``last_segments``
the batch's total (the reference's ``tests/test_batched.py`` on the port);
a batch continues an accumulation as single frames do, and a debug batch
traces no segments."""
import dataclasses

import torch

from ray_tracer_2_tpu_torch.config import DebugMode, RenderParams
from ray_tracer_2_tpu_torch.engine.renderer import Renderer
from ray_tracer_2_tpu_torch.scene import scenes
from ray_tracer_2_tpu_torch.scene.render_scene import instantiate_scene
from torch_bridge import one_torch_thread  # noqa: F401

P = RenderParams(width=48, height=24, bounces=3, rays_per_pixel=1,
                 skybox=True, frames=0)


def test_batched_matches_sequential():
    ts = instantiate_scene(scenes.metal())
    seq = Renderer(device="cpu")
    segs = 0
    for f in range(4):
        fb = seq.render(ts, dataclasses.replace(P, frames=f))
        segs += int(seq.last_segments)
    bat = Renderer(device="cpu")
    out = bat.render_batch(ts, P, 4)
    assert out is bat.framebuffer
    assert torch.equal(fb, out)
    assert bat.last_segments.dtype == torch.int64
    assert int(bat.last_segments) == segs


def test_batch_continues_an_accumulation():
    """Frames 0-1 one by one, then frames 2-6 as one batch (the megakernel
    path: a wide-BVH scene) equal frames 0-6 one by one."""
    ts = instantiate_scene(scenes.wide_bvh_scene())
    p = dataclasses.replace(P, bounces=2)
    seq = Renderer(device="cpu")
    for f in range(7):
        want = seq.render(ts, dataclasses.replace(p, frames=f))
    mixed = Renderer(device="cpu")
    for f in range(2):
        mixed.render(ts, dataclasses.replace(p, frames=f))
    got = mixed.render_batch(ts, dataclasses.replace(p, frames=2), 5)
    assert torch.equal(want, got)


def test_debug_batch():
    ts = instantiate_scene(scenes.room())
    p = dataclasses.replace(P, debug_mode=DebugMode.NODES_AND_TRIANGLES)
    one = Renderer(device="cpu").render(ts, p).clone()
    bat = Renderer(device="cpu")
    out = bat.render_batch(ts, p, 3)
    assert torch.allclose(out, one, atol=1e-6)
    assert int(bat.last_segments) == 0
