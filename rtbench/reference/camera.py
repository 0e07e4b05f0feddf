"""The camera, worked out from the configuration's numbers and the mouse
input alone: rotation quaternions held in float32 as the renderer's host
state holds them, the TRS matrix, the viewport plane, and the FPS
controller's yaw and pitch (upstream src/scene/camera.rs:81-137,
transform.rs:10-18). Plain numpy."""
from __future__ import annotations

import math

import numpy as np

#: degrees of sensitivity per pixel and second of the upstream controller
SENSITIVITY = 1.8


def quat_axis_angle(axis, angle: float) -> np.ndarray:
    """(x, y, z, w) of a rotation by ``angle`` about ``axis``, in float32."""
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    s = np.sin(angle / 2.0)
    return np.array([*(axis * s), np.cos(angle / 2.0)], np.float32)


def quat_product(a, b) -> np.ndarray:
    """Hamilton product ``a b`` of float32 quaternions, rounded to float32."""
    ax, ay, az, aw = np.asarray(a, np.float64)
    bx, by, bz, bw = np.asarray(b, np.float64)
    return np.array([aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx,
                     aw * bz + ax * by - ay * bx + az * bw,
                     aw * bw - ax * bx - ay * by - az * bz], np.float32)


def rotation(q) -> np.ndarray:
    """3x3 rotation of quaternion ``q`` (scaled by 2 / |q|^2), float32."""
    x, y, z, w = np.asarray(q, np.float64)
    n = x * x + y * y + z * z + w * w
    s = 0.0 if n == 0.0 else 2.0 / n
    xx, yy, zz = s * x * x, s * y * y, s * z * z
    xy, xz, yz = s * x * y, s * x * z, s * y * z
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    return np.array([[1.0 - (yy + zz), xy - wz, xz + wy],
                     [xy + wz, 1.0 - (xx + zz), yz - wx],
                     [xz - wy, yz + wx, 1.0 - (xx + yy)]], np.float32)


def quat_of_rotation(m) -> np.ndarray:
    """Quaternion of a rotation matrix (Shepperd's branches), float32."""
    m = np.asarray(m, np.float64)
    t = np.trace(m)
    if t > 0.0:
        s = np.sqrt(t + 1.0) * 2.0
        q = (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s, \
            (m[1, 0] - m[0, 1]) / s, 0.25 * s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2.0
        q = 0.25 * s, (m[0, 1] + m[1, 0]) / s, (m[0, 2] + m[2, 0]) / s, \
            (m[2, 1] - m[1, 2]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2.0
        q = (m[0, 1] + m[1, 0]) / s, 0.25 * s, (m[1, 2] + m[2, 1]) / s, \
            (m[0, 2] - m[2, 0]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2.0
        q = (m[0, 2] + m[2, 0]) / s, (m[1, 2] + m[2, 1]) / s, 0.25 * s, \
            (m[1, 0] - m[0, 1]) / s
    return np.array(q, np.float32)


def look_at(origin, target) -> np.ndarray:
    """The quaternion that turns camera-local +Z towards ``target`` with +Y
    kept up: columns right = up x forward, up = forward x right,
    forward."""
    f = np.asarray(target, np.float64) - np.asarray(origin, np.float64)
    f = f / np.linalg.norm(f)
    r = np.cross([0.0, 1.0, 0.0], f)
    rn = np.linalg.norm(r)
    r = np.array([1.0, 0.0, 0.0]) if rn < 1e-8 else r / rn
    return quat_of_rotation(np.stack([r, np.cross(f, r), f], axis=1))


def trs(pos, q, scale) -> np.ndarray:
    """4x4 float32 ``T R S``."""
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = rotation(q) * np.asarray(scale, np.float32)[None, :]
    m[:3, 3] = np.asarray(pos, np.float32)
    return m


def transform_matrix(t: dict) -> np.ndarray:
    """A configuration's transform (pos, rotation axis and angle, scale)."""
    return trs(t["pos"], quat_axis_angle(t["axis"], t["angle"]),
               np.asarray(t["scale"], np.float32) * np.ones(3, np.float32))


def euler_yxz(q) -> tuple[float, float]:
    """(yaw, pitch) of a quaternion composed as yaw about Y, then pitch
    about X."""
    m = rotation(q).astype(np.float64)
    return (float(np.arctan2(m[0, 2], m[2, 2])),
            float(np.arcsin(np.clip(-m[1, 2], -1.0, 1.0))))


def from_yaw_pitch(yaw: float, pitch: float) -> np.ndarray:
    return quat_product(quat_product(quat_axis_angle([0, 1, 0], yaw),
                                     quat_axis_angle([1, 0, 0], pitch)),
                        quat_axis_angle([0, 0, 1], 0.0))


class Camera:
    """The camera of a configuration, turned by mouse deltas."""

    def __init__(self, cam: dict):
        self.pos = np.asarray(cam["pos"], np.float32)
        self.q = look_at(cam["pos"], cam["target"])
        self.fov = float(cam["fov"])
        self.aspect = float(cam.get("aspect", 16.0 / 9.0))
        self.focus = max(float(cam["focus_dist"]), 1.0)
        self.defocus = float(cam.get("defocus_strength", 0.0))
        self.diverge = float(cam.get("diverge_strength", 0.0))

    def turn(self, dx: float, dy: float, dt: float) -> None:
        """One frame of mouse input: yaw and pitch advance by the delta
        times the sensitivity and ``dt``; pitch stays 0.1 rad short of
        straight up or down."""
        if dx == 0.0 and dy == 0.0:
            return
        yaw, pitch = euler_yxz(self.q)
        yaw += dx * (SENSITIVITY * dt)
        pitch += dy * (SENSITIVITY * dt)
        lim = math.pi / 2 - 0.1
        self.q = from_yaw_pitch(yaw, min(max(pitch, -lim), lim))

    def uniform(self) -> dict:
        """``cam_to_world`` (4x4), the viewport plane (width, height, focus
        distance) and the two jitter strengths, float32."""
        h = self.focus * math.tan(math.radians(self.fov * 0.5)) * 2.0
        return dict(cam_to_world=trs(self.pos, self.q, np.ones(3, np.float32)),
                    view=np.array([h * self.aspect, h, self.focus], np.float32),
                    defocus=np.float32(self.defocus),
                    diverge=np.float32(self.diverge))
