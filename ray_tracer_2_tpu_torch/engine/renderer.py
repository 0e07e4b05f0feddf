"""Progressive renderer (port of ``ray_tracer_2_tpu/engine/renderer.py``).

``render_frame`` renders one frame and blends it into the accumulation
buffer with the reference's progressive weight ``1/(frames+1)``
(ray_tracer.wgsl:154-161; ``frames <= 0`` overwrites). ``Renderer`` owns
that buffer on one device; the blend updates it in place.

Routing (reference ``render_sample`` and ``Renderer._use_pallas_spheres``):
a small scene (``kernels/spheres.eligible``: spheres plus at most 64
untextured triangles) renders through ``render_spheres``, unless it asks
for antialias, which that path does not take, or was instantiated with the
sphere BVH, which only the megakernel walks, or for next-event estimation
or normal maps, which the reference keeps off its small-scene kernel
(``ray_tracer_2_tpu/engine/renderer.py:278-281``); every other frame goes
through ``render_persistent`` (the megakernel), textured scenes included.
A frame with a debug mode goes to ``render_debug`` (``kernels/debug.py``:
one unjittered primary ray a pixel, ``csrc/debug.cu`` on the card) and
blends with the same weight; it traces no path segments, so its segment
count is 0, as the reference's. ``Renderer.render_batch`` renders several
frames with no host synchronisation between them. On a mesh of devices
(``parallel/sharding.py``) ``Renderer`` renders each frame row-sharded,
every device its block of rows through the same routing. The reference also
capped the small path at 128 spheres, a choice between two TPU
implementations; the port has no such cap. Both kernels now take every
small scene, and what each measured on the H100 is in PERF.md, section 6;
the routing waits for a benchmark to be changed against (ROADMAP, perf_opt
queue).
"""
from __future__ import annotations

import numpy as np
import torch

from ray_tracer_2_tpu_torch import spans
from ray_tracer_2_tpu_torch.config import DebugMode, RenderParams
from ray_tracer_2_tpu_torch.kernels import spheres
from ray_tracer_2_tpu_torch.kernels.debug import render_debug
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
    (``scene.derive``) and again after a material edit of a ``FORM_FIELDS``
    field (the route reads the texture flag and index). A scene
    instantiated with a sphere BVH does not: only the megakernel walks
    it."""
    return scene.derive(
        "small_scene",
        lambda: scene.sphere_bvh_root < 0 and spheres.eligible(scene),
        stale_on=("material_form",))


def render_sample(scene: TorchScene, frames: int, *, width: int,
                  height: int, bounces: int, rays_per_pixel: int,
                  skybox: bool, antialias: bool = False, nee: bool = False,
                  normal_maps: bool = False, debug_mode: int = 0,
                  debug_scale: float = 100.0, row_start: int = 0,
                  rows: int | None = None):
    """One frame's sample of the ``rows`` image rows from ``row_start``
    (all of them by default; ``width``/``height`` describe the full image),
    not blended (reference ``render_sample``). Returns ((rows, width, 4)
    float32 image, int64 0-d segment count) on the scene's device.
    ``nee`` (next-event estimation) and ``normal_maps`` send the frame to
    the megakernel whatever the scene; on a scene without lights or normal
    maps it renders there as without them. A ``debug_mode`` other than
    ``OFF`` renders that mode at ``debug_scale`` instead (segments 0)."""
    kw = dict(width=width, height=height, bounces=bounces,
              rays_per_pixel=rays_per_pixel, skybox=skybox,
              row_start=row_start, rows=rows)
    if debug_mode != DebugMode.OFF:
        sample, _ = render_debug(scene, width=width, height=height,
                                 debug_mode=int(debug_mode),
                                 debug_scale=debug_scale,
                                 row_start=row_start, rows=rows)
        segments = torch.zeros((), dtype=torch.int64, device=sample.device)
    elif small_scene(scene) and not (antialias or nee or normal_maps):
        sample, segments = spheres.render_spheres(scene, frames, **kw)
    else:
        sample, segments = render_persistent(scene, frames,
                                             antialias=antialias, nee=nee,
                                             normal_maps=normal_maps, **kw)
    return sample, segments


def blend_weight(frames: int) -> np.float32:
    """The reference's float32 accumulation weight of frame ``frames``:
    ``1 / (frames + 1)``, rounded, or 1 for ``frames <= 0``
    (ray_tracer.wgsl:154-161)."""
    return np.float32(1.0) / np.float32(frames + 1) if frames >= 1 \
        else np.float32(1.0)


def blend(framebuffer: torch.Tensor, sample: torch.Tensor,
          w: np.float32) -> None:
    """``framebuffer * (1 - w) + sample * w``, each product and the sum
    rounded to float32 as the reference's, in place."""
    framebuffer.mul_(float(np.float32(1.0) - w))
    framebuffer.add_(sample * float(w))


def render_frame(scene: TorchScene, framebuffer: torch.Tensor, frames: int,
                 *, width: int, height: int, bounces: int,
                 rays_per_pixel: int, skybox: bool, antialias: bool = False,
                 nee: bool = False, normal_maps: bool = False,
                 debug_mode: int = 0, debug_scale: float = 100.0):
    """Render + accumulate one frame into ``framebuffer`` ((height, width, 4)
    float32, updated in place). Returns (framebuffer, segment count). The
    options are ``render_sample``'s."""
    sample, segments = render_sample(
        scene, frames, width=width, height=height, bounces=bounces,
        rays_per_pixel=rays_per_pixel, skybox=skybox, antialias=antialias,
        nee=nee, normal_maps=normal_maps, debug_mode=debug_mode,
        debug_scale=debug_scale)
    with spans.span("renderer.blend"):
        blend(framebuffer, sample, blend_weight(frames))
    return framebuffer, segments


class Renderer:
    """Host-facing wrapper: owns the accumulation buffer on ``device`` (the
    CUDA card unless the caller asks for the CPU) and the last frame's
    exact traced-segment count (ref RayTracer, ray_tracer.rs:49-236).

    ``mesh`` (reference ``Renderer(mesh=)``): ``"auto"``, the default,
    adopts a rows mesh over the distinct CUDA cards at the first frame of
    each size (``parallel.sharding.auto_mesh``: none on one card or on the
    CPU); a ``RenderMesh`` of one ``rows`` axis whose first device is
    ``device`` pins one; ``None`` keeps one device. On a mesh each device
    renders its block of rows into its own block of the framebuffer, which
    is then a ``ShardedFramebuffer``, and the scene is copied to the other
    devices once and kept in step with its in-place writes
    (``SceneReplicas``)."""

    def __init__(self, device="cuda", mesh="auto"):
        self.device = torch.device(device)
        if not (mesh is None or mesh == "auto"):
            _check_mesh(mesh, self.device)
        self._mesh_arg = mesh
        self.mesh = None if mesh is None or mesh == "auto" else mesh
        self.framebuffer = None
        self.last_segments: torch.Tensor | None = None
        self._replicas = None

    def _resolve_mesh(self, height: int):
        if self._mesh_arg == "auto":
            from ray_tracer_2_tpu_torch.parallel.sharding import auto_mesh
            return auto_mesh(height, self.device)
        return self._mesh_arg

    def ensure_framebuffer(self, width: int, height: int) -> None:
        if self.framebuffer is None \
                or tuple(self.framebuffer.shape) != (height, width, 4):
            self.mesh = self._resolve_mesh(height)
            fb = torch.zeros((height, width, 4), dtype=torch.float32,
                             device=self.device)
            if self.mesh is not None:
                from ray_tracer_2_tpu_torch.parallel.sharding import \
                    shard_framebuffer
                fb = shard_framebuffer(fb, self.mesh)
            self.framebuffer = fb

    def _prepare(self, scene: TorchScene, params: RenderParams):
        """The framebuffer for ``params`` and the scene as the frame takes
        it: itself on one device; on a mesh, its replicas, made once for
        each device and brought up to date with its writes (a mesh that
        changes with the frame's height reuses them). A scene that does not
        lie on the renderer's device raises before anything is
        allocated."""
        if not _same_device(scene.device, self.device):
            raise ValueError(
                f"scene is on {scene.device} but the renderer on "
                f"{self.device}; move it once with scene.to(device)")
        self.ensure_framebuffer(params.width, params.height)
        if self.mesh is None:
            return scene
        from ray_tracer_2_tpu_torch.parallel.sharding import replicate_scene
        if self._replicas is None:
            self._replicas = replicate_scene(scene, self.mesh)
        return self._replicas.follow(scene).cover(self.mesh.distinct)

    def render(self, scene: TorchScene, params: RenderParams):
        """Render one frame into the accumulation buffer; returns it. The
        scene must already lie on the renderer's device (``scene.to``):
        a scene elsewhere raises ``ValueError`` instead of being copied on
        every frame. On a mesh the frame runs row-sharded
        (``parallel.sharding.render_frame_mesh``)."""
        with spans.span("renderer.render"):
            with spans.span("renderer.prepare"):
                scene = self._prepare(scene, params)
            if self.mesh is not None:
                from ray_tracer_2_tpu_torch.parallel.sharding import \
                    render_frame_mesh
                self.framebuffer, self.last_segments = render_frame_mesh(
                    scene, self.framebuffer, int(params.frames),
                    mesh=self.mesh, **self._frame_kw(params))
            else:
                self.framebuffer, self.last_segments = render_frame(
                    scene, self.framebuffer, int(params.frames),
                    **self._frame_kw(params))
            return self.framebuffer

    def render_batch(self, scene: TorchScene, params: RenderParams,
                     n_frames: int):
        """Render ``n_frames`` progressive frames, RNG frames
        ``params.frames .. params.frames + n_frames - 1``, with no host
        synchronisation between them (reference ``render_batch``): the same
        launches on the same streams as ``n_frames`` calls of ``render``,
        so the result is bit-identical. ``last_segments`` holds the batch's
        total as a device tensor."""
        scene = self._prepare(scene, params)
        kw = self._frame_kw(params)
        if self.mesh is not None:
            from ray_tracer_2_tpu_torch.parallel.sharding import \
                render_frames_batched_mesh
            self.framebuffer, self.last_segments = \
                render_frames_batched_mesh(
                    scene, self.framebuffer, int(params.frames),
                    mesh=self.mesh, n_frames=n_frames, **kw)
            return self.framebuffer
        total = torch.zeros((), dtype=torch.int64, device=self.device)
        for f in range(int(params.frames), int(params.frames) + n_frames):
            self.framebuffer, segs = render_frame(scene, self.framebuffer, f,
                                                  **kw)
            total = total + segs
        self.last_segments = total
        return self.framebuffer

    @staticmethod
    def _frame_kw(params: RenderParams) -> dict:
        """``render_frame``'s options from ``params`` (the debug scale at
        least 1, as the reference clamps it)."""
        return dict(width=params.width, height=params.height,
                    bounces=int(params.bounces),
                    rays_per_pixel=int(params.rays_per_pixel),
                    skybox=bool(params.skybox),
                    antialias=bool(params.antialias), nee=bool(params.nee),
                    normal_maps=bool(params.normal_maps),
                    debug_mode=int(params.debug_mode),
                    debug_scale=float(max(params.debug_scale, 1)))

    def synchronize(self) -> None:
        """Wait for every frame queued on the renderer's devices."""
        devices = self.mesh.distinct if self.mesh is not None \
            else (self.device,)
        for dev in devices:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def read_framebuffer(self) -> np.ndarray:
        """Device -> host copy of the accumulation buffer (gathered from
        its blocks on a mesh)."""
        if self.framebuffer is None:
            raise RuntimeError("nothing rendered yet")
        return self.framebuffer.cpu().numpy()


def _check_mesh(mesh, device: torch.device) -> None:
    """Raise unless ``mesh`` is a rows mesh whose home is ``device``."""
    from ray_tracer_2_tpu_torch.parallel.sharding import RenderMesh
    if not isinstance(mesh, RenderMesh):
        raise TypeError(f"mesh: 'auto', None or a RenderMesh, not {mesh!r}")
    if mesh.axes != ("rows",):
        raise ValueError(f"Renderer takes a mesh of one rows axis, not "
                         f"{mesh.axes}: sample rounds and the 2-D mesh are "
                         "parallel.sharding's render_frame_spp_sharded and "
                         "render_frame_hybrid_sharded")
    if not _same_device(mesh.home, device):
        raise ValueError(f"the mesh's first device {mesh.home} is not the "
                         f"renderer's {device}")
