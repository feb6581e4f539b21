"""Voxel filters on fixed-capacity clouds (counterpart of
hectorgrapher_tpu/sensor/voxel_filter.py; ref:
cartographer/sensor/internal/voxel_filter.h:34-49,
adaptive_voxel_filter.h:49-92).

Points are keyed by their integer cell coordinates, sorted
lexicographically by key, and the first point of each key run survives.
The sort must be STABLE with the JAX package's key order (x, then y, then
z, then input index), or a voxel keeps another of its points. The output
keeps the input capacity, in sorted order, with an updated mask.
"""

from __future__ import annotations

import torch

from hectorgrapher_tpu_torch.sensor.types import PointCloud, TimedPointCloud

_INVALID_CELL = 1 << 24


def _cell_coords(positions, mask, resolution):
    """Integer cell coordinates (N, 3) int32; invalid points get a sentinel
    so they sort to the end."""
    cells = torch.floor(positions / resolution).to(torch.int32)
    return torch.where(mask[..., None], cells, _INVALID_CELL)


def _dedup_order(cells):
    """Lexicographic (x, y, z) sort order plus first-occurrence mask per
    voxel: stable sorts from the least significant key up equal
    jnp.lexsort((z, y, x))."""
    order = torch.arange(cells.shape[0], device=cells.device)
    for axis in (2, 1, 0):
        idx = torch.sort(cells[order, axis], stable=True).indices
        order = order[idx]
    s = cells[order]
    first = torch.cat(
        [torch.ones(1, dtype=torch.bool, device=cells.device), torch.any(s[1:] != s[:-1], dim=-1)]
    )
    return order, first


def voxel_filter(cloud: PointCloud, resolution) -> PointCloud:
    """Keep one point per voxel of edge `resolution` (ref: voxel_filter.h)."""
    cells = _cell_coords(cloud.positions, cloud.mask, resolution)
    order, first = _dedup_order(cells)
    return PointCloud(positions=cloud.positions[order], mask=first & cloud.mask[order])


def voxel_filter_count(cloud: PointCloud, resolution):
    """Number of surviving points (a 0-d tensor; no host sync)."""
    cells = _cell_coords(cloud.positions, cloud.mask, resolution)
    order, first = _dedup_order(cells)
    return torch.sum(first & cloud.mask[order])


def adaptive_voxel_filter_length(
    cloud: PointCloud,
    max_length: float,
    min_num_points: int,
    max_range: float,
    num_bisections: int = 10,
):
    """Voxel edge length used by the adaptive filter (a 0-d f32 tensor).

    Restrict to points within max_range; if filtering at max_length keeps
    >= min_num_points, use max_length; otherwise halve until enough
    survive, then bisect between [length, 2*length] for the largest length
    that still keeps min_num_points. The halving loop reads its count on
    the host; the bisection stays on the device.
    """
    device = cloud.positions.device
    in_range = cloud.mask & (torch.linalg.norm(cloud.positions, dim=-1) <= max_range)
    ranged = PointCloud(cloud.positions, in_range)
    total = torch.sum(in_range)

    def count(length):
        return voxel_filter_count(ranged, length)

    max_len = torch.tensor(max_length, dtype=torch.float32, device=device)
    c0 = count(max_len)
    length, c = max_len, c0
    while int(c) < min_num_points and float(length) > 1e-3:
        length = length / 2.0
        c = count(length)

    low, high = length, 2.0 * length
    for _ in range(num_bisections):
        mid = 0.5 * (low + high)
        ok = count(mid) >= min_num_points
        low, high = torch.where(ok, mid, low), torch.where(ok, high, mid)
    use_max = (c0 >= min_num_points) | (total <= min_num_points)
    return torch.where(use_max, max_len, low)


def adaptive_voxel_filter(cloud: PointCloud, options) -> PointCloud:
    """(ref: adaptive_voxel_filter.h AdaptiveVoxelFilter::Filter)

    options: AdaptiveVoxelFilterOptions(max_length, min_num_points, max_range).
    """
    in_range = cloud.mask & (torch.linalg.norm(cloud.positions, dim=-1) <= options.max_range)
    ranged = PointCloud(cloud.positions, in_range)
    length = adaptive_voxel_filter_length(
        cloud, options.max_length, int(options.min_num_points), options.max_range
    )
    filtered = voxel_filter(ranged, length)
    # Already-sparse clouds pass through UNFILTERED (ref:
    # adaptive_voxel_filter.h:49-52).
    sparse = torch.sum(in_range) <= options.min_num_points
    return PointCloud(
        positions=torch.where(sparse, ranged.positions, filtered.positions),
        mask=torch.where(sparse, ranged.mask, filtered.mask),
    )


def voxel_filter_timed(cloud: TimedPointCloud, resolution) -> TimedPointCloud:
    """Voxel filter preserving per-point times; the cloud's leaves are
    tensors on one device."""
    cells = _cell_coords(cloud.positions, cloud.mask, resolution)
    order, first = _dedup_order(cells)
    return TimedPointCloud(
        positions=cloud.positions[order], times=cloud.times[order], mask=first & cloud.mask[order]
    )


def adaptive_voxel_filter_timed(cloud: TimedPointCloud, options) -> TimedPointCloud:
    """Adaptive voxel filter preserving per-point times (tensor leaves)."""
    in_range = cloud.mask & (torch.linalg.norm(cloud.positions, dim=-1) <= options.max_range)
    length = adaptive_voxel_filter_length(
        PointCloud(cloud.positions, in_range), options.max_length, int(options.min_num_points), options.max_range
    )
    filtered = voxel_filter_timed(TimedPointCloud(cloud.positions, cloud.times, in_range), length)
    # Already-sparse clouds pass through UNFILTERED, as in the untimed
    # variant (ref: adaptive_voxel_filter.h:49-52).
    sparse = torch.sum(in_range) <= options.min_num_points
    return TimedPointCloud(
        positions=torch.where(sparse, cloud.positions, filtered.positions),
        times=torch.where(sparse, cloud.times, filtered.times),
        mask=torch.where(sparse, in_range, filtered.mask),
    )


def _compaction(mask, capacity: int):
    """Indices that move the valid points to the front (stable), and the
    padding to reach `capacity` (0 when the cloud is cut to it)."""
    idx = torch.sort((~mask).to(torch.uint8), stable=True).indices[:capacity]
    return idx, max(capacity - mask.shape[0], 0)


def compact_cloud(cloud: PointCloud, capacity: int) -> PointCloud:
    """Move valid points to the front (stable) and truncate or pad to
    `capacity`: shrinks the adaptive filters' outputs to the fixed
    per-cloud budget."""
    idx, pad = _compaction(cloud.mask, capacity)
    return PointCloud(
        torch.nn.functional.pad(cloud.positions[idx], (0, 0, 0, pad)),
        torch.nn.functional.pad(cloud.mask[idx], (0, pad)),
    )


def compact_timed_cloud(cloud: TimedPointCloud, capacity: int) -> TimedPointCloud:
    """compact_cloud for timed clouds (tensor leaves)."""
    idx, pad = _compaction(cloud.mask, capacity)
    return TimedPointCloud(
        torch.nn.functional.pad(cloud.positions[idx], (0, 0, 0, pad)),
        torch.nn.functional.pad(cloud.times[idx], (0, pad)),
        torch.nn.functional.pad(cloud.mask[idx], (0, pad)),
    )
