"""Framebuffer export (ref: App::save_render_to_file, app.rs:341-465); a
jax-free copy of ``ray_tracer_2_tpu/engine/export.py``. The PNG is written
with ``zlib`` (8-bit RGB, no filter), so that exporting needs no imaging
library.

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

import struct
import zlib

import numpy as np


def framebuffer_to_srgb(fb: np.ndarray, flip_vertical: bool = True) -> np.ndarray:
    """(H, W, 4) float32 linear → (H, W, 3) uint8 with gamma 1/2.2
    (app.rs:442-445) and the export pipeline's net vertical flip
    (app.rs:408-463)."""
    rgb = np.clip(np.asarray(fb)[..., :3], 0.0, 1.0)
    if flip_vertical:
        rgb = rgb[::-1]
    return (rgb ** (1.0 / 2.2) * 255.0 + 0.5).astype(np.uint8)


def png_bytes(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> the bytes of an 8-bit RGB PNG."""
    h, w, _ = rgb.shape

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(rgb, np.uint8).reshape(h, -1)],
                          axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def save_png(fb: np.ndarray, path) -> None:
    with open(path, "wb") as f:
        f.write(png_bytes(framebuffer_to_srgb(fb)))
