"""Host-side transforms: quaternions, TRS matrices, camera look-at.

A numpy copy of ``ray_tracer_2_tpu/math/transform.py``: that module is
jax-free itself, but its package ``__init__`` imports the jnp vector helpers,
so the port carries its own copy (identical arithmetic, so both packages
build byte-identical matrices).

Numpy (not jnp): transforms are scene-construction state mutated by the host
(camera controller, UI edits) each frame; only the final 4x4s are shipped to
the device. Mirrors the semantics of the reference's glam usage
(src/scene/components/transform.rs:3-30).

Quaternions are stored ``(x, y, z, w)``.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def quat_identity() -> np.ndarray:
    return np.array([0.0, 0.0, 0.0, 1.0], dtype=np.float32)


def quat_from_axis_angle(axis, angle: float) -> np.ndarray:
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    s = np.sin(angle / 2.0)
    return np.array([*(axis * s), np.cos(angle / 2.0)], dtype=np.float32)


def quat_mul(a, b) -> np.ndarray:
    ax, ay, az, aw = np.asarray(a, dtype=np.float64)
    bx, by, bz, bw = np.asarray(b, dtype=np.float64)
    return np.array(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dtype=np.float32,
    )


def quat_rotate_x(angle: float) -> np.ndarray:
    return quat_from_axis_angle([1.0, 0.0, 0.0], angle)


def quat_rotate_y(angle: float) -> np.ndarray:
    return quat_from_axis_angle([0.0, 1.0, 0.0], angle)


def quat_from_euler_yxz(yaw: float, pitch: float, roll: float) -> np.ndarray:
    """Intrinsic Y (yaw) then X (pitch) then Z (roll) — the FPS-camera
    composition used by the reference controller (camera.rs:99-109)."""
    return quat_mul(quat_mul(quat_rotate_y(yaw), quat_rotate_x(pitch)),
                    quat_from_axis_angle([0, 0, 1], roll))


def quat_to_euler_yxz(q) -> tuple[float, float, float]:
    """Inverse of :func:`quat_from_euler_yxz` (yaw, pitch, roll)."""
    m = quat_to_mat3(q).astype(np.float64)
    # R = Ry(yaw) @ Rx(pitch) @ Rz(roll); m[1,2] = -sin(pitch) ... derive from
    # the composed matrix: with roll==0 use forward column m[:,2].
    pitch = float(np.arcsin(np.clip(-m[1, 2], -1.0, 1.0)))
    yaw = float(np.arctan2(m[0, 2], m[2, 2]))
    roll = float(np.arctan2(m[1, 0], m[1, 1]))
    return yaw, pitch, roll


def quat_to_mat3(q) -> np.ndarray:
    x, y, z, w = np.asarray(q, dtype=np.float64)
    n = x * x + y * y + z * z + w * w
    s = 0.0 if n == 0.0 else 2.0 / n
    xx, yy, zz = s * x * x, s * y * y, s * z * z
    xy, xz, yz = s * x * y, s * x * z, s * y * z
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    return np.array(
        [
            [1.0 - (yy + zz), xy - wz, xz + wy],
            [xy + wz, 1.0 - (xx + zz), yz - wx],
            [xz - wy, yz + wx, 1.0 - (xx + yy)],
        ],
        dtype=np.float32,
    )


def mat3_to_quat(m) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    t = np.trace(m)
    if t > 0.0:
        s = np.sqrt(t + 1.0) * 2.0
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2.0
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2.0
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2.0
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    return np.array([x, y, z, w], dtype=np.float32)


def look_at_quat(origin, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """Rotation mapping +Z to ``normalize(target - origin)`` with +Y kept
    up-ish — the camera convention of the reference (transform.rs:13-18: the
    ray kernel treats camera-local +Z as the view direction,
    ray_tracer.wgsl:481)."""
    origin = np.asarray(origin, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    f = target - origin
    f = f / np.linalg.norm(f)
    r = np.cross(up, f)
    rn = np.linalg.norm(r)
    if rn < 1e-8:  # looking straight up/down: pick an arbitrary right axis
        r = np.array([1.0, 0.0, 0.0])
    else:
        r = r / rn
    u = np.cross(f, r)
    m = np.stack([r, u, f], axis=1)  # columns: right, up, forward
    return mat3_to_quat(m)


@dataclasses.dataclass
class Transform:
    """Position + rotation + scale; ``to_matrix`` builds T·R·S column-major
    4x4 exactly like ``Mat4::from_scale_rotation_translation``
    (transform.rs:10-12)."""

    pos: np.ndarray = None
    rot: np.ndarray = None
    scale: np.ndarray = None

    def __post_init__(self):
        self.pos = (np.zeros(3, np.float32) if self.pos is None
                    else np.asarray(self.pos, np.float32))
        self.rot = quat_identity() if self.rot is None else np.asarray(self.rot, np.float32)
        self.scale = (np.ones(3, np.float32) if self.scale is None
                      else np.asarray(self.scale, np.float32) * np.ones(3, np.float32))

    def to_matrix(self) -> np.ndarray:
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = quat_to_mat3(self.rot) * self.scale[None, :]
        m[:3, 3] = self.pos
        return m

    @staticmethod
    def cam(origin, look_at) -> "Transform":
        return Transform(pos=np.asarray(origin, np.float32),
                         rot=look_at_quat(origin, look_at))

    def copy(self) -> "Transform":
        return Transform(pos=self.pos.copy(), rot=self.rot.copy(), scale=self.scale.copy())
