"""Render configuration (port of ``ray_tracer_2_tpu/config.py``; the Params
uniform of app.rs:27-91).

The same frozen dataclass as the reference, field for field (a checkpoint
stores ``dataclasses.fields(params)`` and rebuilds ``RenderParams(**p)``,
so one written by either package loads in the other), with the frame
protocol ``Engine`` runs on: ``update``, ``reset_frame``, ``for_render``
(motion degradation) and the adaptive ladder (``MOTION_LADDER``,
``pick_motion_scale``).
"""
from __future__ import annotations

import dataclasses
import enum

# Internal framebuffer (engine.rs:202): 1920x1080 RGBA float32.
RENDER_SIZE = (1920, 1080)

# Texture slots of the atlas (ray_tracer.rs:15-19): the asset manager loads
# at most this many textures, and the atlas has this many slot rows.
MAX_TEXTURES = 64


class DebugMode(enum.IntEnum):
    """Debug visualisations (ray_tracer.wgsl:136-142)."""

    OFF = 0
    NORMALS = 1
    DEPTH = 2
    TEX_COORDS = 3
    FOCUS_DST = 4
    NODES = 5
    TRIANGLES = 6
    NODES_AND_TRIANGLES = 7


@dataclasses.dataclass(frozen=True)
class RenderParams:
    """Per-frame render parameters (app.rs:27-41 ``Params``). ``frames``
    follows the reference accumulation protocol (ray_tracer.wgsl:154-161):
    ``-1``/``0`` overwrite the framebuffer, ``>= 1`` blend with weight
    ``1/(frames+1)``."""

    width: int = RENDER_SIZE[0]
    height: int = RENDER_SIZE[1]
    bounces: int = 5             # engine.rs:244-250 defaults
    rays_per_pixel: int = 1
    skybox: bool = True
    frames: int = 0
    accumulate: bool = True
    debug_mode: DebugMode = DebugMode.OFF
    debug_scale: int = 100
    #: tangent-frame normal mapping (off = reference parity)
    normal_maps: bool = False
    #: next-event estimation (off = reference parity)
    nee: bool = False
    #: box-filter sub-pixel jitter, two extra draws per sample (off =
    #: reference parity)
    antialias: bool = False
    #: adaptive motion degradation: the moving-frame downscale picked from
    #: MOTION_LADDER each frame so that a moving frame takes about
    #: ``motion_target_ms`` (off = the reference's fixed half resolution,
    #: app.rs:58-73)
    adaptive_motion: bool = False
    motion_target_ms: int = 33

    def update(self, is_moving: bool) -> tuple["RenderParams", bool]:
        """Advance the frame counter (app.rs:43-57). Returns
        ``(new_params, accumulation_was_reset)``."""
        if is_moving or not self.accumulate:
            return dataclasses.replace(self, frames=-1), True
        return dataclasses.replace(self, frames=self.frames + 1), False

    def reset_frame(self) -> "RenderParams":
        return dataclasses.replace(self, frames=-1)

    def for_render(self, is_moving: bool,
                   motion_scale: int = 2) -> "RenderParams":
        """Motion degradation (app.rs:58-73): while the camera moves, render
        at 1/``motion_scale`` of the session's resolution (at least 16
        pixels a side), 1 bounce, 1 ray a pixel. The reference always
        halves; a larger ``motion_scale`` comes from the adaptive ladder."""
        if not is_moving:
            return self
        scale = max(int(motion_scale), 2)
        return dataclasses.replace(
            self, bounces=1, rays_per_pixel=1,
            width=max(self.width // scale, 16),
            height=max(self.height // scale, 16))


#: the moving-frame downscales adaptive motion picks from: a short fixed
#: ladder bounds the framebuffer shapes a session allocates
MOTION_LADDER = (2, 3, 4, 6, 8)


def pick_motion_scale(last_scale: int, last_render_s: float | None,
                      target_s: float) -> int:
    """The moving-frame downscale from MOTION_LADDER (reference
    ``pick_motion_scale``). A moving frame's time is taken as pixel-bound
    (1 bounce), so at scale ``s`` it extrapolates from the last measured
    moving frame as ``last_render_s * (last_scale / s)**2``; the finest
    scale predicted to fit ``target_s`` wins, and a step to a finer scale
    than last time also needs 20% headroom, so that a borderline frame does
    not swing between two sizes."""
    if last_render_s is None or last_render_s <= 0.0:
        return last_scale if last_scale in MOTION_LADDER else MOTION_LADDER[0]
    best = MOTION_LADDER[-1]
    for s in MOTION_LADDER:
        if last_render_s * (last_scale / s) ** 2 <= target_s:
            best = s
            break
    if best < last_scale \
            and last_render_s * (last_scale / best) ** 2 > 0.8 * target_s:
        best = last_scale
    return best
