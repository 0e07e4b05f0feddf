"""Seeded texture images: a frozen copy of
``ray_tracer_2_tpu_torch/scene/scenes.py:seeded_image``, returning the u8
bytes the program's atlas stores instead of their float32 quotients."""
from __future__ import annotations

import numpy as np


def seeded_image_u8(size: int, seed: int, width: int | None = None) -> np.ndarray:
    """A (size, width or size, 4) uint8 RGBA image made from ``seed``: a
    16 x 16 grid of colour cells in [40, 216) with per-texel noise of up to
    24 over it, opaque. ``seeded_image`` of the program divides these bytes
    by 255."""
    w = size if width is None else width
    rng = np.random.default_rng(seed)
    cells = rng.integers(40, 216, (16, 16, 3))
    rgb = cells[(np.arange(size) * 16) // size][:, (np.arange(w) * 16) // w]
    rgb = np.clip(rgb + rng.integers(-24, 25, (size, w, 3)), 0, 255)
    img = np.full((size, w, 4), 255, np.uint8)
    img[..., :3] = rgb
    return img
