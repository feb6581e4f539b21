"""Typed sensor data with fixed capacities (counterpart of
hectorgrapher_tpu/sensor/types.py; ref: cartographer/sensor/{point_cloud.h,
timed_point_cloud_data.h, range_data.h}).

Clouds are fixed-capacity tensors with validity masks. Timed clouds are
host-side numpy containers: the front end reads them on the host and
uploads what it matches and inserts.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class PointCloud(NamedTuple):
    """Padded point cloud: positions (..., N, 3) f32, mask (..., N) bool."""

    positions: torch.Tensor
    mask: torch.Tensor


class TimedPointCloud(NamedTuple):
    """Cloud with per-point relative times (<= 0, last point == 0). Its
    leaves are numpy arrays on the host, or tensors for the device-side
    timed voxel filters."""

    positions: np.ndarray  # (N, 3)
    times: np.ndarray  # (N,) relative seconds, <= 0
    mask: np.ndarray  # (N,)


class TimedPointCloudData(NamedTuple):
    """One rangefinder measurement. time: time of the LAST point;
    origin: (3,) sensor origin in the tracking frame."""

    time: float
    origin: np.ndarray
    ranges: TimedPointCloud
    width: int = 0


class RangeData(NamedTuple):
    """Returns + misses from one scan."""

    origin: torch.Tensor  # (3,)
    returns: PointCloud
    misses: PointCloud
    width: int = 0


def pad_cloud(points: np.ndarray, capacity: int, device) -> PointCloud:
    """Pad an (n, 3) numpy array to a fixed-capacity PointCloud on device."""
    n = min(len(points), capacity)
    positions = np.zeros((capacity, 3), dtype=np.float32)
    positions[:n] = points[:n]
    mask = np.zeros((capacity,), dtype=bool)
    mask[:n] = True
    return PointCloud(
        positions=torch.from_numpy(positions).to(device),
        mask=torch.from_numpy(mask).to(device),
    )


def pad_timed_cloud(points: np.ndarray, times: np.ndarray, capacity: int) -> TimedPointCloud:
    """Host-side padded container (numpy leaves)."""
    n = min(len(points), capacity)
    positions = np.zeros((capacity, 3), dtype=np.float32)
    positions[:n] = points[:n]
    t = np.zeros((capacity,), dtype=np.float32)
    t[:n] = times[:n]
    mask = np.zeros((capacity,), dtype=bool)
    mask[:n] = True
    return TimedPointCloud(positions=positions, times=t, mask=mask)


def crop_range_data_z(rd: RangeData, min_z: float, max_z: float) -> RangeData:
    """Mask out points outside [min_z, max_z] (ref: sensor/range_data.h
    CropRangeData used by local_trajectory_builder_2d.cc:51-63)."""

    def crop(c: PointCloud) -> PointCloud:
        z = c.positions[..., 2]
        return c._replace(mask=c.mask & (z >= min_z) & (z <= max_z))

    return rd._replace(returns=crop(rd.returns), misses=crop(rd.misses))
