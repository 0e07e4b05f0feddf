"""Camera model (port of ``ray_tracer_2_tpu/scene/camera.py``; the FPS
controller waits for the viewer slice).

The device consumes four small arrays (``cam_to_world`` 4x4, ``view_params``
3-vector, defocus/diverge scalars) — the exact payload of the reference's
``CameraUniform`` (camera.rs:15-22). Everything else is host state.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from ray_tracer_2_tpu_torch.math.transform import Transform


@dataclasses.dataclass
class CameraDescriptor:
    """camera.rs:38-66 defaults."""

    transform: Transform = dataclasses.field(default_factory=Transform)
    fov: float = 90.0
    aspect: float = 16.0 / 9.0
    near: float = 0.01
    far: float = 1000.0
    focus_dist: float = 1.0
    defocus_strength: float = 0.0
    diverge_strength: float = 0.0


@dataclasses.dataclass
class CameraUniform:
    cam_to_world: np.ndarray      # (4, 4) float32
    view_params: np.ndarray       # (plane_w, plane_h, focus_dist)
    defocus_strength: float
    diverge_strength: float


class Camera:
    """camera.rs:24-91. ``focus_dist`` is clamped to >= 1 at construction
    (camera.rs:75), as the reference does."""

    def __init__(self, desc: CameraDescriptor):
        self.transform = desc.transform.copy()
        self.fov = desc.fov
        self.aspect = desc.aspect
        self.near = desc.near
        self.far = desc.far
        self.focus_dist = max(desc.focus_dist, 1.0)
        self.defocus_strength = desc.defocus_strength
        self.diverge_strength = desc.diverge_strength

    def to_uniform(self) -> CameraUniform:
        """Viewport plane from fov + focus distance (camera.rs:81-91)."""
        plane_height = (self.focus_dist
                        * math.tan(math.radians(self.fov * 0.5)) * 2.0)
        plane_width = plane_height * self.aspect
        return CameraUniform(
            cam_to_world=self.transform.to_matrix(),
            view_params=np.array([plane_width, plane_height, self.focus_dist],
                                 dtype=np.float32),
            defocus_strength=self.defocus_strength,
            diverge_strength=self.diverge_strength,
        )
