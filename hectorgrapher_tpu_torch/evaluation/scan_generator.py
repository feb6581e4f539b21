"""Synthetic 2D scans for tests and chip_smoke.py (a numpy copy of
raycast_rect_room_2d from hectorgrapher_tpu/evaluation/scan_generator.py;
ref: cartographer/mapping/internal/testing/test_helpers.h
GenerateFakeRangeMeasurements)."""

from __future__ import annotations

import math
from typing import Optional

import numpy as np


def raycast_rect_room_2d(
    pose_t: np.ndarray,
    pose_yaw: float,
    half_width: float = 5.02,
    half_height: float = 3.93,
    num_rays: int = 360,
    max_range: float = 30.0,
    noise_std: float = 0.0,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Scan of an axis-aligned rectangular room from inside.

    Returns (num_rays, 3) points in the SENSOR frame (z=0); rays that
    would exceed max_range are dropped (marked nan).
    """
    angles = np.linspace(-math.pi, math.pi, num_rays, endpoint=False)
    world_angles = angles + pose_yaw
    dx = np.cos(world_angles)
    dy = np.sin(world_angles)
    x0, y0 = float(pose_t[0]), float(pose_t[1])

    ts = np.full(num_rays, np.inf)
    for wall_x in (-half_width, half_width):
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (wall_x - x0) / dx
        y_at = y0 + t * dy
        ok = (t > 1e-6) & (np.abs(y_at) <= half_height)
        ts = np.where(ok & (t < ts), t, ts)
    for wall_y in (-half_height, half_height):
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (wall_y - y0) / dy
        x_at = x0 + t * dx
        ok = (t > 1e-6) & (np.abs(x_at) <= half_width)
        ts = np.where(ok & (t < ts), t, ts)

    if rng is not None and noise_std > 0:
        ts = ts + rng.normal(0.0, noise_std, size=ts.shape)
    valid = np.isfinite(ts) & (ts <= max_range)
    sx = ts * np.cos(angles)
    sy = ts * np.sin(angles)
    pts = np.stack([sx, sy, np.zeros_like(sx)], axis=-1)
    pts[~valid] = np.nan
    return pts
