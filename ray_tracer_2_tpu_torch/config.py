"""Render configuration (port of ``ray_tracer_2_tpu/config.py``; the Params
uniform of app.rs:27-91).

The same frozen dataclass as the reference, with the fields the ported
slices read; motion degradation waits for the engine slice.
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
    debug_mode: DebugMode = DebugMode.OFF
    #: tangent-frame normal mapping (off = reference parity)
    normal_maps: bool = False
    #: next-event estimation (off = reference parity)
    nee: bool = False
    #: box-filter sub-pixel jitter, two extra draws per sample (off =
    #: reference parity)
    antialias: bool = False
