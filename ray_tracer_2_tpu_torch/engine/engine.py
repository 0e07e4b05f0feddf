"""Engine: owns the subsystems and drives the frame loop (port of
``ray_tracer_2_tpu/engine/engine.py``; ref: src/core/engine.rs and the
per-frame orchestration of src/core/app.rs).

Headless: a front end feeds it input and reads the framebuffer.
``update()`` is App::update + handle_redraw (app.rs:128-163, 285-340): poll
the background scene loads, move the camera, advance the accumulation
protocol (``RenderParams.update``), render (``Renderer.render``), at half
the resolution with 1 bounce while the camera moves (``for_render``; with
``adaptive_motion`` the scale tracks ``motion_target_ms``).

Frames are dispatched without waiting by default: ``update`` returns once
the frame is queued on the card, so host work overlaps device work. CUDA
events recorded after the frame, one on each card the frame ran on (the
renderer's mesh, ``Renderer(mesh=)``, several cards by default on a host
that has them), settle it: the next ``update`` waits on them before
dispatching (``synchronize``), a stats read only asks (``query``), and the
frame's time and its exact segment count are read once it has settled.
``sync=True`` waits for the frame on every card (``Renderer.synchronize``)
and times it exactly. On the CPU every frame has settled when ``render``
returns.

Live edits (``HostScene.edit_*``, from the viewer's input threads) hold the
scene's lock; ``update`` holds it while it writes the camera and while it
dispatches the frame, so a frame reads one consistent scene. The edits'
writes are queued in stream order, so the lock is not held while the card
renders.
"""
from __future__ import annotations

import dataclasses
import logging
import threading
import time

import torch

from ray_tracer_2_tpu_torch.accel.bvh import BVHQuality
from ray_tracer_2_tpu_torch.assets.manager import AssetManager
from ray_tracer_2_tpu_torch.config import (
    RENDER_SIZE, DebugMode, RenderParams, pick_motion_scale,
)
from ray_tracer_2_tpu_torch.engine.export import save_png
from ray_tracer_2_tpu_torch.engine.renderer import Renderer
from ray_tracer_2_tpu_torch.scene.manager import SceneManager
from ray_tracer_2_tpu_torch.scene.scenes import SceneName

log = logging.getLogger(__name__)


class FrameTiming:
    """Half-life running average of the frame time (engine.rs:180-201)."""

    def __init__(self):
        self.delta = 0.0
        self.average_frame_time = 0.0
        self._last = time.perf_counter()

    def tick(self) -> float:
        now = time.perf_counter()
        self.delta = now - self._last
        self._last = now
        self.average_frame_time = (self.average_frame_time + self.delta) / 2.0
        return self.delta

    def reset(self) -> None:
        self.average_frame_time = 0.0

    @property
    def fps(self) -> float:
        return 1.0 / self.average_frame_time \
            if self.average_frame_time > 0 else 0.0


@dataclasses.dataclass
class FrameStats:
    """Live metrics (ref: egui Debug panel, egui.rs:383-402)."""

    frame: int = 0
    fps: float = 0.0
    frame_time_ms: float = 0.0
    #: exact traced segments of the frame over its time
    mrays_per_s: float = 0.0
    accumulated_frames: int = 0
    bvh_nodes: int = 0
    bvh_triangles: int = 0
    #: True when frame_time_ms/mrays_per_s come from a synchronous frame;
    #: an asynchronous frame reports the dispatch-to-settle time, an upper
    #: bound
    timing_exact: bool = True


class _Settled:
    """What a frame leaves to wait on: the events recorded after it, one
    on each card it ran on (none on the CPU)."""

    def __init__(self, events=()):
        self.events = list(events)

    def query(self) -> bool:
        return all(ev.query() for ev in self.events)

    def synchronize(self) -> None:
        for ev in self.events:
            ev.synchronize()


class Engine:
    """engine.rs:216-264: the subsystems, and the initial scene loaded in
    the background (CornellBox, skybox on, 5 bounces, 1 ray a pixel —
    engine.rs:241-251). Renders on ``device``, the card unless the caller
    asks for the CPU, over ``mesh`` (``Renderer``'s: ``"auto"`` adopts the
    host's cards, ``None`` keeps one device, a ``RenderMesh`` pins one)."""

    def __init__(self, width: int = RENDER_SIZE[0],
                 height: int = RENDER_SIZE[1],
                 assets: AssetManager | None = None,
                 initial_scene: SceneName | None = SceneName.CORNELL_BOX,
                 block_on_initial_scene: bool = False, device="cuda",
                 mesh="auto"):
        self.device = torch.device(device)
        self.params = RenderParams(width=width, height=height, bounces=5,
                                   rays_per_pixel=1, skybox=True, frames=0,
                                   accumulate=True)
        self._base_resolution = (width, height)
        self.assets = assets or AssetManager()
        self.scene_manager = SceneManager(self.assets, device=self.device)
        self.renderer = Renderer(device=self.device, mesh=mesh)
        self.timing = FrameTiming()
        self.stats = FrameStats()
        self._frame_counter = 0
        self._last_render_s = 0.0
        self._last_params = self.params
        self._scene_for_stats = None
        self._pending = None            # the event of a frame in flight
        self._pending_t0 = 0.0
        self._settle_lock = threading.Lock()
        self._timing_exact = True
        self._motion_scale = 2          # adaptive-motion ladder state
        self._last_move_scale: int | None = None
        self._moved_last_frame = False
        if initial_scene is not None:
            if block_on_initial_scene:
                self.scene_manager.load_blocking(initial_scene)
            else:
                self.scene_manager.request_scene(initial_scene)

    # ------------------------------------------------------------ frame

    def update(self, dt: float | None = None, is_moving: bool = False,
               sync: bool = False):
        """One frame: poll scene loads, camera, parameter protocol, render.
        Returns the framebuffer tensor (None while no scene is loaded).
        ``sync=True`` waits for the frame and times it exactly."""
        if dt is None:
            dt = self.timing.tick()
        else:
            self.timing.delta = dt
            self.timing.average_frame_time = (
                self.timing.average_frame_time + dt) / 2.0

        if self.scene_manager.poll_loaded() is not None:
            # a new scene: reset accumulation and timing (app.rs:135-142)
            self.params = self.params.reset_frame()
            self.timing.reset()

        host = self.scene_manager.scene
        if host is None:
            return None

        # the scene's lock keeps live edits (HostScene.edit_*, from another
        # thread) out of the camera write and the frame's dispatch, so that
        # a frame reads one scene and one set of its tables; it is let go
        # while the previous frame settles
        with host.lock:
            moved = host.camera.update_camera(dt) or is_moving
            if moved:
                host.refresh_camera()
            self.params, _ = self.params.update(moved)

        # settle the previous frame first (before for_render, so that the
        # adaptive ladder sees the last moving frame's time)
        self._settle_pending()

        with host.lock:
            motion_scale = 2  # the reference's fixed half resolution
            if self.params.adaptive_motion:
                if moved and self._moved_last_frame \
                        and self._last_move_scale is not None:
                    self._motion_scale = pick_motion_scale(
                        self._last_move_scale, self._last_render_s,
                        self.params.motion_target_ms / 1000.0)
                motion_scale = self._motion_scale
            render_params = self.params.for_render(moved,
                                                   motion_scale=motion_scale)
            self._moved_last_frame = moved
            if moved:
                self._last_move_scale = motion_scale

            t0 = time.perf_counter()
            fb = self.renderer.render(host.scene, render_params)
        if sync:
            self.renderer.synchronize()
            self._last_render_s = time.perf_counter() - t0
            self._timing_exact = True
        else:
            self._pending = self._frame_event()
            self._pending_t0 = t0
            self._timing_exact = False

        self._frame_counter += 1
        self._last_params = render_params
        self._scene_for_stats = host
        return fb

    def _frame_event(self) -> _Settled:
        """Events recorded after the frame just dispatched, one on each card
        of the renderer's mesh."""
        mesh = self.renderer.mesh
        events = []
        for dev in (mesh.distinct if mesh is not None else (self.device,)):
            if dev.type == "cuda":
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(dev))
                events.append(ev)
        return _Settled(events)

    def _settle_pending(self, block: bool = True) -> None:
        # called from the render loop (block=True) and from stats reads on
        # other threads (block=False); a non-blocking caller that finds
        # the lock taken returns, someone else is settling
        if not self._settle_lock.acquire(blocking=block):
            return
        try:
            ev = self._pending
            if ev is None:
                return
            if not block and not ev.query():
                return
            ev.synchronize()
            self._last_render_s = time.perf_counter() - self._pending_t0
            self._pending = None
            # snapshot now, while renderer.last_segments is the settled
            # frame's
            self._refresh_stats()
        finally:
            self._settle_lock.release()

    def _refresh_stats(self) -> None:
        host = self._scene_for_stats
        if host is None:
            return
        segs = self.renderer.last_segments
        p = self._last_params
        rays = (float(int(segs)) if segs is not None else
                p.width * p.height * max(p.rays_per_pixel, 1))
        render_s = max(self._last_render_s, 1e-9)
        self._stats = FrameStats(
            frame=self._frame_counter,
            fps=self.timing.fps,
            frame_time_ms=render_s * 1e3,
            mrays_per_s=rays / render_s / 1e6,
            accumulated_frames=max(self.params.frames, 0),
            bvh_nodes=host.n_nodes,
            bvh_triangles=host.n_triangles,
            timing_exact=self._timing_exact,
        )

    @property
    def stats(self) -> FrameStats:
        """Live metrics, never waiting: while a frame is in flight, the
        numbers of the last settled frame (``timing_exact=False``)."""
        if self._scene_for_stats is None:
            return self._stats
        self._settle_pending(block=False)
        if self._pending is None:
            self._refresh_stats()
        return self._stats

    @stats.setter
    def stats(self, value) -> None:
        self._stats = value

    # ------------------------------------------------------- UI actions
    # hotkeys (app.rs:172-272): Q next scene, E cycle debug mode, P save
    # PNG, 1 toggle skybox, 2 toggle accumulate, R low resolution

    def next_scene(self) -> None:
        cur = self.scene_manager.selected_scene or SceneName.CORNELL_BOX
        self.scene_manager.request_scene(cur.next())

    def cycle_debug_mode(self) -> None:
        mode = DebugMode((int(self.params.debug_mode) + 1) % 8)
        self.params = dataclasses.replace(self.params, debug_mode=mode,
                                          frames=-1)

    def toggle_low_res(self) -> None:
        """R key (app.rs:236-246): halve or restore the session's
        resolution."""
        w, h = self.params.width, self.params.height
        if (w, h) == self._base_resolution:
            w, h = w // 2, h // 2
        else:
            w, h = self._base_resolution
        self.params = dataclasses.replace(self.params, width=w, height=h,
                                          frames=-1)

    def set_resolution(self, width: int, height: int) -> None:
        """Debug-panel resolution drag (egui.rs:434-446)."""
        self.params = dataclasses.replace(
            self.params, width=max(int(width), 8), height=max(int(height), 8),
            frames=-1)

    def rebuild_bvh(self, quality) -> None:
        """Debug-panel BVH quality and rebuild (egui.rs:404-460):
        ``quality`` a ``BVHQuality`` or its value ("high", "low",
        "disabled")."""
        self.scene_manager.rebuild_bvh(BVHQuality(quality))

    def toggle_skybox(self) -> None:
        self.params = dataclasses.replace(
            self.params, skybox=not self.params.skybox, frames=-1)

    def toggle_accumulate(self) -> None:
        self.params = dataclasses.replace(
            self.params, accumulate=not self.params.accumulate)

    def save_render(self, path) -> None:
        """PNG export with gamma 1/2.2 (app.rs:341-465)."""
        save_png(self.renderer.read_framebuffer(), path)
        log.info("saved render to %s", path)
