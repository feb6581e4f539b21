"""Quaternion helpers (wxyz, float64, numpy) for the generators.

The benchmark's own copies: the traffic it generates must not change when
the program's transform code does."""

from __future__ import annotations

import numpy as np


def conj(q):
    q = np.asarray(q, float)
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def rotate(q, v):
    """R(q) v for (..., 4) and (..., 3)."""
    q = np.asarray(q, float)
    u, w = q[..., 1:], q[..., :1]
    uv = np.cross(u, v)
    return np.asarray(v, float) + 2.0 * (w * uv + np.cross(u, uv))


def yaw(psi):
    """Rotation about +z by psi (array or scalar) as (..., 4)."""
    psi = np.asarray(psi, float)
    return np.stack([np.cos(psi / 2), np.zeros_like(psi), np.zeros_like(psi), np.sin(psi / 2)], axis=-1)
