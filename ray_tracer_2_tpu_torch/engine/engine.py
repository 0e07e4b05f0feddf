"""Engine: owns the subsystems and drives the frame loop (port of
``ray_tracer_2_tpu/engine/engine.py``; ref: src/core/engine.rs and the
per-frame orchestration of src/core/app.rs).

Headless: a front end feeds it input and reads the framebuffer.
``update()`` is App::update + handle_redraw (app.rs:128-163, 285-340): poll
the background scene loads, move the camera, advance the accumulation
protocol (``RenderParams.update``), render (``Renderer.render``), at half
the resolution with 1 bounce while the camera moves (``for_render``; with
``adaptive_motion`` the scale tracks ``motion_target_ms``).

Frames are dispatched without waiting by default: ``update`` queues the
frame, then waits for the one before, so the card holds the frame running
and the one queued behind it, and goes from one to the next while the host
wakes, reads the last frame's numbers and writes the next camera. CUDA
events recorded after each frame, one on each card the frame ran on (the
renderer's mesh, ``Renderer(mesh=)``, several cards by default on a host
that has them), settle it: ``update`` waits on the frame before the one it
queued (``synchronize``), a stats read only asks (``query``). Each frame in
flight keeps its own record (events, dispatch time, parameters, scene, and
its segment count copied to pinned host memory in stream order), read once
the frame has settled, so no ``update`` synchronises a stream.
``sync=True`` waits for the frame too and times it exactly. On the CPU
every frame has settled when ``render`` returns.

Live edits (``HostScene.edit_*``, from the viewer's input threads) hold the
scene's lock; ``update`` holds it while it writes the camera and while it
dispatches the frame, so a frame reads one consistent scene. The edits'
writes are queued in stream order, so the lock is not held while the card
renders.
"""
from __future__ import annotations

import collections
import dataclasses
import logging
import threading
import time

import torch

from ray_tracer_2_tpu_torch import spans
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
    #: an asynchronous frame reports the time from its dispatch, or from
    #: the settle of the frame before if that came later, to its own
    #: settle, an upper bound
    timing_exact: bool = True


class _Frame:
    """One frame dispatched by ``Engine.update``: the events recorded after
    it, one on each card it ran on (none on the CPU), its dispatch time,
    its segment count (``segs``: a pinned host copy filled in stream order
    before the events, or the tensor itself on the CPU), the parameters it
    rendered with, its scene, and whether it moved and at what scale.
    Settling it fills ``rays`` and ``render_s``. Under a profiler session
    the events time, and ``starts`` holds the timing event recorded before
    the frame's first launch call on each card
    (``spans.launch_started``)."""

    def __init__(self, events=(), devices=(), starts=None, timed=False, *,
                 number=0, t0=0.0, segs=None, params=None, host=None,
                 move_scale=None, exact=False):
        self.events = list(events)
        self.devices = list(devices)
        self.starts = starts or {}
        self.timed = timed
        self.number = number
        self.t0 = t0
        self.segs = segs
        self.params = params
        self.host = host
        self.move_scale = move_scale    # None for a still frame
        self.exact = exact
        self.rays = 0.0
        self.render_s = 0.0

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
        self._last_params = self.params     # the newest frame's
        self._pending = collections.deque()  # frames in flight, oldest first
        self._dispatched = None         # the newest frame, settled or not
        self._settled = None            # the newest settled frame
        self._settle_t = 0.0            # when it settled
        self._settle_lock = threading.Lock()
        self._segs_host = None          # pinned segment counts, a slot a
        #                                 frame in flight
        # the adaptive-motion ladder: its scale, and the newest settled
        # frame's time and, if it moved, its scale
        self._motion_scale = 2
        self._last_render_s = 0.0
        self._last_move_scale: int | None = None
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
        The frame is queued on the card, then ``update`` waits for the
        frame before it, so the card starts this one as soon as that one
        ends; ``sync=True`` waits for this frame too and times it exactly.
        Under a ``torch.profiler`` session each step is a span
        (``spans``)."""
        with spans.span("engine.update"):
            if dt is None:
                dt = self.timing.tick()
            else:
                self.timing.delta = dt
                self.timing.average_frame_time = (
                    self.timing.average_frame_time + dt) / 2.0

            with spans.span("engine.poll"):
                if self.scene_manager.poll_loaded() is not None:
                    # a new scene: reset accumulation and timing
                    # (app.rs:135-142)
                    self.params = self.params.reset_frame()
                    self.timing.reset()

            host = self.scene_manager.scene
            if host is None:
                return None

            # the scene's lock keeps live edits (HostScene.edit_*, from
            # another thread) out of the camera write and the frame's
            # dispatch, so that a frame reads one scene and one set of its
            # tables; it is let go while the frame before settles
            with spans.span("engine.camera"), host.lock:
                moved = host.camera.update_camera(dt) or is_moving
                if moved:
                    host.refresh_camera()
                self.params, _ = self.params.update(moved)

            with spans.span("engine.dispatch"), host.lock:
                motion_scale = 2  # the reference's fixed half resolution
                if self.params.adaptive_motion:
                    # the newest settled frame, if it moved: one frame
                    # older than the one still on the card
                    if moved and self._last_move_scale is not None:
                        self._motion_scale = pick_motion_scale(
                            self._last_move_scale, self._last_render_s,
                            self.params.motion_target_ms / 1000.0)
                    motion_scale = self._motion_scale
                render_params = self.params.for_render(
                    moved, motion_scale=motion_scale)
                t0 = time.perf_counter()
                fb = self.renderer.render(host.scene, render_params)

            self._frame_counter += 1
            with spans.span("engine.event"):
                self._queue_frame(
                    t0, render_params, host,
                    motion_scale if moved else None, sync)
            self._last_params = render_params

            # wait for the frame before (and with sync, this one)
            with spans.span("engine.settle"):
                self._settle_pending(newest=sync)
            return fb

    def _queue_frame(self, t0: float, params: RenderParams, host,
                     move_scale: int | None, exact: bool) -> None:
        """The record of the frame just dispatched: its segment count
        copied to a pinned host slot in stream order, then events recorded
        after it, one on each card of the renderer's mesh. Under a profiler
        session, counts ``engine.dispatches``, and
        ``engine.dispatches_queued`` when the frame before had not finished
        on the card by then (the card reached this frame with no gap)."""
        segs = self.renderer.last_segments
        if segs is not None and segs.device.type == "cuda":
            if self._segs_host is None:
                # one slot a frame in flight: frame n's is reused by frame
                # n + 2, dispatched once frame n has settled
                self._segs_host = torch.empty(2, dtype=torch.int64,
                                              pin_memory=True)
            slot = self._segs_host[self._frame_counter % 2]
            slot.copy_(segs, non_blocking=True)
            segs = slot
        mesh = self.renderer.mesh
        timing = spans.on()
        events, devices = [], []
        for dev in (mesh.distinct if mesh is not None else (self.device,)):
            if dev.type == "cuda":
                ev = torch.cuda.Event(enable_timing=timing)
                ev.record(torch.cuda.current_stream(dev))
                events.append(ev)
                devices.append(dev)
        frame = _Frame(events, devices,
                       spans.take_starts() if timing else None, timing,
                       number=self._frame_counter, t0=t0, segs=segs,
                       params=params, host=host, move_scale=move_scale,
                       exact=exact)
        if timing:
            before = self._dispatched
            spans.count("engine.dispatches")
            if before is not None and not before.query():
                spans.count("engine.dispatches_queued")
        self._dispatched = frame
        self._pending.append(frame)

    def _count_gap(self, last: _Frame | None, ev: _Frame) -> None:
        """Under a profiler session, add to ``device.interframe_gap_ms`` the
        card's own time from the end of the frame before ``ev`` (``last``)
        to ``ev``'s first launch call, the mean over the cards both
        timed."""
        if last is None or not last.timed or not ev.starts:
            return
        ends = {spans.card_of(d): e
                for d, e in zip(last.devices, last.events)}
        gaps = [ends[d].elapsed_time(start) for d, start in ev.starts.items()
                if d in ends]
        if gaps:
            spans.count("device.interframe_gap_ms", sum(gaps) / len(gaps))
            spans.count("device.interframe_gaps")

    def _settle_pending(self, block: bool = True,
                        newest: bool = False) -> None:
        """Settle the frames in flight, oldest first. From the render loop
        (``block=True``) wait for every frame but the newest, which stays
        queued on the card (``newest=True``: that one too; a CPU frame has
        no events and settles at once); from a stats read on another
        thread (``block=False``) settle only the frames that have finished,
        never waiting, and return at once if someone else is settling."""
        if not self._settle_lock.acquire(blocking=block):
            return
        try:
            pending = self._pending
            while pending:
                frame = pending[0]
                if not block:
                    if not frame.query():
                        return
                elif frame is pending[-1] and not newest and frame.events:
                    return
                with spans.span("engine.settle.wait"):
                    frame.synchronize()
                pending.popleft()
                self._settle(frame)
        finally:
            self._settle_lock.release()

    def _settle(self, frame: _Frame) -> None:
        """A frame whose events have completed: its time (from its start on
        the card, the later of its dispatch and the settle of the frame
        before, to now), its segment count read from the host, the ladder's
        state and the stats."""
        now = time.perf_counter()
        frame.render_s = now - max(frame.t0, self._settle_t)
        self._settle_t = now
        with spans.span("engine.stats"):
            p = frame.params
            frame.rays = (float(int(frame.segs)) if frame.segs is not None
                          else p.width * p.height * max(p.rays_per_pixel, 1))
            frame.segs = None
            self._stats = self._frame_stats(frame)
        self._count_gap(self._settled, frame)
        # a stats read on another thread takes the frame whole from here
        self._settled = frame
        self._last_render_s = frame.render_s
        self._last_move_scale = frame.move_scale

    def _frame_stats(self, frame: _Frame) -> FrameStats:
        host = frame.host
        render_s = max(frame.render_s, 1e-9)
        return FrameStats(
            frame=frame.number,
            fps=self.timing.fps,
            frame_time_ms=render_s * 1e3,
            mrays_per_s=frame.rays / render_s / 1e6,
            accumulated_frames=max(frame.params.frames, 0),
            bvh_nodes=host.n_nodes,
            bvh_triangles=host.n_triangles,
            timing_exact=frame.exact,
        )

    @property
    def stats(self) -> FrameStats:
        """Live metrics, never waiting: the numbers of the newest settled
        frame (while frames are in flight, ``timing_exact=False``)."""
        self._settle_pending(block=False)
        frame = self._settled
        if frame is not None:
            self._stats = self._frame_stats(frame)
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
