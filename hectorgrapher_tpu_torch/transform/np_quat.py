"""Small numpy quaternion/SE(3) helpers for host-side streaming control.

The front-end's per-sample state machines (ImuTracker, PoseExtrapolator)
run on the host between device launches; dispatching a device op per IMU
sample would dominate latency, so they use these numpy helpers
(quaternions wxyz). A copy of hectorgrapher_tpu/transform/np_quat.py
without its JAX conversions.
"""

from __future__ import annotations

import numpy as np


def quat_identity():
    return np.array([1.0, 0.0, 0.0, 0.0])


def quat_normalize(q):
    return q / np.linalg.norm(q)


def quat_multiply(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ]
    )


def quat_conjugate(q):
    return np.array([q[0], -q[1], -q[2], -q[3]])


def quat_rotate(q, v):
    u = q[1:]
    w = q[0]
    uv = np.cross(u, v)
    return v + 2.0 * (w * uv + np.cross(u, uv))


def quat_from_axis_angle(aa):
    angle = np.linalg.norm(aa)
    if angle < 1e-12:
        return np.array([1.0, 0.5 * aa[0], 0.5 * aa[1], 0.5 * aa[2]])
    axis = aa / angle
    half = 0.5 * angle
    s = np.sin(half)
    return np.array([np.cos(half), s * axis[0], s * axis[1], s * axis[2]])


def quat_to_axis_angle(q):
    q = q if q[0] >= 0 else -q
    sin_half = np.linalg.norm(q[1:])
    if sin_half < 1e-12:
        return 2.0 * q[1:]
    angle = 2.0 * np.arctan2(sin_half, q[0])
    return q[1:] / sin_half * angle


def quat_angle(q):
    return 2.0 * np.arctan2(np.linalg.norm(q[1:]), abs(q[0]))


def quat_from_two_vectors(a, b):
    """Quaternion rotating a onto b (Eigen FromTwoVectors)."""
    a = a / max(np.linalg.norm(a), 1e-12)
    b = b / max(np.linalg.norm(b), 1e-12)
    c = np.cross(a, b)
    d = float(np.dot(a, b))
    if d < -1.0 + 1e-9:
        # Opposite: pick any orthogonal axis.
        axis = np.cross(a, np.array([1.0, 0.0, 0.0]))
        if np.linalg.norm(axis) < 1e-6:
            axis = np.cross(a, np.array([0.0, 1.0, 0.0]))
        axis = axis / np.linalg.norm(axis)
        return np.array([0.0, axis[0], axis[1], axis[2]])
    s = np.sqrt((1.0 + d) * 2.0)
    # Eigen FromTwoVectors: w = s/2, vec = c/s.
    return quat_normalize(np.concatenate([[0.5 * s], c / s]))


def quat_yaw(q):
    w, x, y, z = q
    return np.arctan2(2.0 * (x * y + w * z), 1.0 - 2.0 * (y * y + z * z))


def quat_slerp(a, b, t):
    dot = float(np.dot(a, b))
    if dot < 0:
        b = -b
        dot = -dot
    dot = min(1.0, max(-1.0, dot))
    theta = np.arccos(dot)
    if np.sin(theta) < 1e-6:
        return quat_normalize((1 - t) * a + t * b)
    return quat_normalize(
        (np.sin((1 - t) * theta) * a + np.sin(t * theta) * b) / np.sin(theta)
    )


class NpRigid3:
    """Host-side rigid transform (translation + quaternion wxyz)."""

    __slots__ = ("t", "q")

    def __init__(self, t=None, q=None):
        self.t = np.zeros(3) if t is None else np.asarray(t, dtype=np.float64)
        self.q = quat_identity() if q is None else np.asarray(q, dtype=np.float64)

    @staticmethod
    def identity():
        return NpRigid3()

    def compose(self, other: "NpRigid3") -> "NpRigid3":
        return NpRigid3(quat_rotate(self.q, other.t) + self.t, quat_normalize(quat_multiply(self.q, other.q)))

    def inverse(self) -> "NpRigid3":
        qi = quat_conjugate(self.q)
        return NpRigid3(-quat_rotate(qi, self.t), qi)

    def apply(self, v):
        return quat_rotate(self.q, np.asarray(v)) + self.t

    def __repr__(self):
        return f"NpRigid3(t={self.t}, q={self.q})"
