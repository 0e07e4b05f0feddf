"""Camera model and FPS controller (port of
``ray_tracer_2_tpu/scene/camera.py``; ref: src/scene/camera.rs).

The device consumes four small arrays (``cam_to_world`` 4x4, ``view_params``
3-vector, defocus/diverge scalars) — the exact payload of the reference's
``CameraUniform`` (camera.rs:15-22). Everything else is host state.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from ray_tracer_2_tpu_torch.math.transform import (
    Transform, quat_from_euler_yxz, quat_to_euler_yxz, quat_to_mat3,
)


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
    """camera.rs:24-137. ``focus_dist`` is clamped to >= 1 at construction
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
        self.controller = CameraController(speed=10.0, sensitivity=1.8)

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

    def update_camera(self, dt: float) -> bool:
        """Apply the controller's input over ``dt`` seconds; returns whether
        the camera moved (which resets accumulation) (camera.rs:92-137).
        Yaw and pitch turn through Euler angles (pitch held 0.1 rad short of
        straight up or down), then the keys move the camera in its own
        frame at ``speed`` and the wheel along its view axis."""
        c = self.controller
        moved = False
        scalar = c.sensitivity * dt

        if c.rotate_horizontal != 0.0 or c.rotate_vertical != 0.0:
            yaw, pitch, _ = quat_to_euler_yxz(self.transform.rot)
            yaw += c.rotate_horizontal * scalar
            pitch += c.rotate_vertical * scalar
            max_pitch = math.pi / 2 - 0.1
            pitch = min(max(pitch, -max_pitch), max_pitch)
            self.transform.rot = quat_from_euler_yxz(yaw, pitch, 0.0)
            c.rotate_horizontal = 0.0
            c.rotate_vertical = 0.0
            moved = True

        local_move = np.array([
            c.amount_right - c.amount_left,
            c.amount_up - c.amount_down,
            c.amount_forward - c.amount_backward,
        ], dtype=np.float64)
        if np.any(local_move != 0.0):
            rot = quat_to_mat3(self.transform.rot).astype(np.float64)
            world_move = rot @ (local_move / np.linalg.norm(local_move)
                                * c.speed * dt)
            self.transform.pos = (self.transform.pos
                                  + world_move).astype(np.float32)
            moved = True

        if c.scroll != 0.0:
            rot = quat_to_mat3(self.transform.rot).astype(np.float64)
            zoom = rot @ np.array([0.0, 0.0, 1.0]) * c.scroll * c.speed * dt
            self.transform.pos = (self.transform.pos + zoom).astype(np.float32)
            c.scroll = 0.0
            moved = True
        return moved


@dataclasses.dataclass
class CameraController:
    """camera.rs:139-218: the input amounts accumulated between frames (a
    front end maps its keys and mouse onto them)."""

    speed: float = 10.0
    sensitivity: float = 1.8
    amount_left: float = 0.0
    amount_right: float = 0.0
    amount_forward: float = 0.0
    amount_backward: float = 0.0
    amount_up: float = 0.0
    amount_down: float = 0.0
    rotate_horizontal: float = 0.0
    rotate_vertical: float = 0.0
    scroll: float = 0.0

    #: key -> attribute, as camera.rs:171-205 (WASD/arrows/space/shift)
    KEY_MAP = {
        "w": "amount_forward", "up": "amount_forward",
        "s": "amount_backward", "down": "amount_backward",
        "a": "amount_left", "left": "amount_left",
        "d": "amount_right", "right": "amount_right",
        "space": "amount_up", "shift": "amount_down",
    }

    def process_keyboard(self, key: str, pressed: bool) -> bool:
        attr = self.KEY_MAP.get(key.lower())
        if attr is None:
            return False
        # the reference sets 0.01 on a press (camera.rs:171-177)
        setattr(self, attr, 0.01 if pressed else 0.0)
        return True

    def process_mouse(self, dx: float, dy: float) -> None:
        self.rotate_horizontal = float(dx)
        self.rotate_vertical = float(dy)

    def process_scroll(self, delta_lines: float) -> None:
        self.scroll = -delta_lines * 0.1
