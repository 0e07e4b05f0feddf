"""Progressive renderer (port of ``ray_tracer_2_tpu/engine/renderer.py``).

``render_frame`` renders one frame and blends it into the accumulation
buffer with the reference's progressive weight ``1/(frames+1)``
(ray_tracer.wgsl:154-161; ``frames <= 0`` overwrites). ``Renderer`` owns
that buffer on one device; the blend updates it in place.

Routing (reference ``render_sample`` and ``Renderer._use_pallas_spheres``):
a small scene (``kernels/spheres.eligible``: spheres plus at most 64
untextured triangles) renders through ``render_spheres``, unless it asks
for antialias, which that path does not take; every other frame goes
through ``render_persistent``, which raises for a scene outside the ported
megakernel (e.g. more than 32 spheres). The reference also capped the
small path at 128 spheres, a choice between two TPU implementations; the
port has no other path for large sphere scenes, so it has no such cap.
"""
from __future__ import annotations

import numpy as np
import torch

from ray_tracer_2_tpu_torch.config import DebugMode, RenderParams
from ray_tracer_2_tpu_torch.kernels import spheres
from ray_tracer_2_tpu_torch.kernels.megakernel import render_persistent
from ray_tracer_2_tpu_torch.scene.render_scene import TorchScene


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Device equality with ``cuda`` read as the current CUDA device
    (``torch.device('cuda') != torch.device('cuda:0')``)."""
    if a.type != b.type:
        return False
    if a.type == "cuda":
        cur = torch.cuda.current_device()
        return (cur if a.index is None else a.index) == \
            (cur if b.index is None else b.index)
    return a == b


def small_scene(scene: TorchScene) -> bool:
    """Whether ``scene`` takes the small-scene path; decided once per scene
    (kept in ``scene.derived``)."""
    route = scene.derived.get("small_scene")
    if route is None:
        route = scene.derived["small_scene"] = spheres.eligible(scene)
    return route


def render_frame(scene: TorchScene, framebuffer: torch.Tensor, frames: int,
                 *, width: int, height: int, bounces: int,
                 rays_per_pixel: int, skybox: bool, antialias: bool = False):
    """Render + accumulate one frame into ``framebuffer`` ((height, width, 4)
    float32, updated in place). Returns (framebuffer, segment count)."""
    kw = dict(width=width, height=height, bounces=bounces,
              rays_per_pixel=rays_per_pixel, skybox=skybox)
    if small_scene(scene) and not antialias:
        sample, segments = spheres.render_spheres(scene, frames, **kw)
    else:
        sample, segments = render_persistent(scene, frames,
                                             antialias=antialias, **kw)
    # the reference's float32 weight: 1 / (f + 1), and 1 - w, each rounded
    w = np.float32(1.0) / np.float32(frames + 1) if frames >= 1 \
        else np.float32(1.0)
    framebuffer.mul_(float(np.float32(1.0) - w))
    framebuffer.add_(sample * float(w))
    return framebuffer, segments


class Renderer:
    """Host-facing wrapper: owns the accumulation buffer on ``device`` and
    the last frame's exact traced-segment count (ref RayTracer,
    ray_tracer.rs:49-236)."""

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self.framebuffer: torch.Tensor | None = None
        self.last_segments: torch.Tensor | None = None

    def ensure_framebuffer(self, width: int, height: int) -> None:
        if self.framebuffer is None \
                or tuple(self.framebuffer.shape) != (height, width, 4):
            self.framebuffer = torch.zeros((height, width, 4),
                                           dtype=torch.float32,
                                           device=self.device)

    def render(self, scene: TorchScene, params: RenderParams) -> torch.Tensor:
        """Render one frame into the accumulation buffer; returns it. The
        scene must already lie on the renderer's device (``scene.to``):
        a scene elsewhere raises ``ValueError`` instead of being copied on
        every frame."""
        if not _same_device(scene.device, self.device):
            raise ValueError(
                f"scene is on {scene.device} but the renderer on "
                f"{self.device}; move it once with scene.to(device)")
        if params.debug_mode != DebugMode.OFF:
            raise NotImplementedError(
                "debug modes wait for their slice (ROADMAP Queue 1 item 8)")
        if params.nee:
            raise NotImplementedError(
                "next-event estimation waits for its slice "
                "(ROADMAP Queue 1 item 8)")
        if params.normal_maps:
            raise NotImplementedError(
                "normal maps wait for their slice (ROADMAP Queue 1 item 8)")
        self.ensure_framebuffer(params.width, params.height)
        self.framebuffer, self.last_segments = render_frame(
            scene, self.framebuffer, int(params.frames),
            width=params.width, height=params.height,
            bounces=int(params.bounces),
            rays_per_pixel=int(params.rays_per_pixel),
            skybox=bool(params.skybox), antialias=bool(params.antialias))
        return self.framebuffer

    def read_framebuffer(self) -> np.ndarray:
        """Device -> host copy of the accumulation buffer."""
        if self.framebuffer is None:
            raise RuntimeError("nothing rendered yet")
        return self.framebuffer.cpu().numpy()
