"""Synthetic scans for tests and chip_smoke.py (numpy copies of
raycast_rect_room_2d and raycast_box_room_3d from
hectorgrapher_tpu/evaluation/scan_generator.py; ref:
cartographer/mapping/internal/testing/test_helpers.h
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


def raycast_box_room_3d(
    pose_t: np.ndarray,
    pose_q: np.ndarray,
    half_extents=(4.03, 3.41, 1.52),
    num_azimuth: int = 64,
    num_elevation: int = 16,
    max_range: float = 30.0,
    noise_std: float = 0.0,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Organized 3D scan (num_elevation rows x num_azimuth cols) of the
    inside of an axis-aligned box room. Points in the SENSOR frame; invalid
    rays are nan. pose_q is wxyz.

    Default half-extents are deliberately not grid-aligned.
    """
    from hectorgrapher_tpu_torch.transform import np_quat as nq

    az = np.linspace(-math.pi, math.pi, num_azimuth, endpoint=False)
    el = np.linspace(-0.45 * math.pi, 0.45 * math.pi, num_elevation)
    azg, elg = np.meshgrid(az, el)  # (rows, cols)
    dirs_sensor = np.stack(
        [np.cos(elg) * np.cos(azg), np.cos(elg) * np.sin(azg), np.sin(elg)], axis=-1
    ).reshape(-1, 3)
    dirs_world = nq.quat_rotate(pose_q, dirs_sensor)
    p0 = np.asarray(pose_t, dtype=float)

    ts = np.full(len(dirs_world), np.inf)
    for axis in range(3):
        for sign in (-1.0, 1.0):
            wall = sign * half_extents[axis]
            d = dirs_world[:, axis]
            with np.errstate(divide="ignore", invalid="ignore"):
                t = (wall - p0[axis]) / d
                hit = p0[None, :] + t[:, None] * dirs_world
            ok = t > 1e-6
            for other in range(3):
                if other != axis:
                    ok &= np.abs(hit[:, other]) <= half_extents[other] + 1e-9
            ts = np.where(ok & (t < ts), t, ts)

    if rng is not None and noise_std > 0:
        ts = ts + rng.normal(0.0, noise_std, size=ts.shape)
    valid = np.isfinite(ts) & (ts <= max_range)
    pts = dirs_sensor * ts[:, None]
    pts[~valid] = np.nan
    return pts.astype(np.float32)
