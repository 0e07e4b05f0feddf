"""Framebuffer export (ref: App::save_render_to_file, app.rs:341-465); a
jax-free copy of ``ray_tracer_2_tpu/engine/export.py`` (numpy + PIL).

The reference reads the Rgba32Float texture back, applies gamma 1/2.2 and
writes a PNG whose net orientation is a vertical flip of the raw buffer
(rows are written x-reversed, then flip_horizontal + flip_vertical —
app.rs:408-463). Our framebuffer uses the same convention (row 0 = bottom of
the view, because pixel v=0 maps to -plane_height/2 along camera up), so
export applies the same vertical flip.

Fixed relative to the reference: alpha is not gamma-encoded (app.rs:445 bug)
and the output path is an argument, not a hardcoded Windows path (app.rs:218).
"""
from __future__ import annotations

import numpy as np


def framebuffer_to_srgb(fb: np.ndarray, flip_vertical: bool = True) -> np.ndarray:
    """(H, W, 4) float32 linear → (H, W, 3) uint8 with gamma 1/2.2
    (app.rs:442-445) and the export pipeline's net vertical flip
    (app.rs:408-463)."""
    rgb = np.clip(np.asarray(fb)[..., :3], 0.0, 1.0)
    if flip_vertical:
        rgb = rgb[::-1]
    return (rgb ** (1.0 / 2.2) * 255.0 + 0.5).astype(np.uint8)


def save_png(fb: np.ndarray, path) -> None:
    from PIL import Image

    Image.fromarray(framebuffer_to_srgb(fb), mode="RGB").save(path)
