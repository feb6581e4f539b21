"""2D range-data insertion as batched scatter updates (counterpart of the
probability part of hectorgrapher_tpu/mapping/inserters_2d.py; ref:
mapping/2d/probability_grid_range_data_inserter_2d.cc).

A scan is rasterized into per-cell hit/miss masks via scatter, and the
log-odds update is applied ONCE per cell as a masked elementwise op: the
reference's one-update-per-cell-per-scan semantics, with hits taking
priority over misses. Misses are rasterized by equidistant sampling along
each ray at sub-cell spacing (ref: internal/2d/ray_to_pixel_mask.cc).
"""

from __future__ import annotations

import math

import torch

from hectorgrapher_tpu_torch.mapping import probability_values as pv
from hectorgrapher_tpu_torch.mapping.grids import ProbabilityGrid, cell_index, flat_index
from hectorgrapher_tpu_torch.sensor.types import RangeData


def _scatter_mask(shape, flat_idx, valid):
    """Boolean grid with True at flat_idx positions where valid."""
    size = 1
    for s in shape:
        size *= s
    grid = torch.zeros((size + 1,), dtype=torch.bool, device=flat_idx.device)  # slot `size` absorbs drops
    grid[torch.where(valid, flat_idx, size)] = True
    return grid[:size].reshape(shape)


def _ray_sample_mask(meta, shape, origins, ends, valid, num_samples: int):
    """Rasterize segments origin->end (exclusive of the end cell) into a
    mask from `num_samples` equidistant samples strictly inside [0, 1)."""
    device = origins.device
    t = (torch.arange(num_samples, dtype=torch.float32, device=device) + 0.5) / num_samples
    pts = origins[:, None, :] + t[None, :, None] * (ends - origins)[:, None, :]  # (P, S, D)
    flat = flat_index(cell_index(meta, pts), shape)
    return _scatter_mask(shape, flat.reshape(-1), valid[:, None].expand(flat.shape).reshape(-1))


def insert_probability_2d(
    grid: ProbabilityGrid,
    range_data: RangeData,
    hit_log_odds: float,
    miss_log_odds: float,
    num_samples: int = 128,
    insert_free_space: bool = True,
) -> ProbabilityGrid:
    """Insert one scan into an occupancy grid; range_data must already be
    in the grid-local frame; z is ignored."""
    shape = grid.shape
    origin2 = range_data.origin[:2]

    hits = range_data.returns.positions[:, :2]
    hit_mask = _scatter_mask(shape, flat_index(cell_index(grid.meta, hits), shape), range_data.returns.mask)

    if insert_free_space:
        origins = origin2.expand(hits.shape)
        miss_mask = _ray_sample_mask(grid.meta, shape, origins, hits, range_data.returns.mask, num_samples)
        # Rays to "misses" (no return within range): whole segment is free.
        miss_pts = range_data.misses.positions[:, :2]
        if miss_pts.shape[0] > 0:
            miss_origins = origin2.expand(miss_pts.shape)
            end_mask = _scatter_mask(
                shape, flat_index(cell_index(grid.meta, miss_pts), shape), range_data.misses.mask
            )
            miss_mask = (
                miss_mask
                | _ray_sample_mask(grid.meta, shape, miss_origins, miss_pts, range_data.misses.mask, num_samples)
                | end_mask
            )
        miss_mask = miss_mask & ~hit_mask  # hits take priority
    else:
        miss_mask = torch.zeros(shape, dtype=torch.bool, device=hits.device)

    zero = torch.zeros((), dtype=torch.float32, device=hits.device)
    delta = torch.where(hit_mask, hit_log_odds, zero) + torch.where(miss_mask, miss_log_odds, zero)
    new_lo = pv.clamp_log_odds(grid.log_odds + delta)
    touched = hit_mask | miss_mask
    return grid._replace(
        log_odds=torch.where(touched, new_lo, grid.log_odds),
        known=grid.known | touched,
    )


def make_probability_inserter_2d(options, max_range: float, resolution: float):
    """Bind ProbabilityGridRangeDataInserterOptions2D into an inserter."""
    hit_lo = math.log(options.hit_probability / (1 - options.hit_probability))
    miss_lo = math.log(options.miss_probability / (1 - options.miss_probability))
    num_samples = max(8, int(max_range / (resolution * 0.7)))

    def insert(grid: ProbabilityGrid, range_data: RangeData) -> ProbabilityGrid:
        return insert_probability_2d(
            grid,
            range_data,
            hit_lo,
            miss_lo,
            num_samples=num_samples,
            insert_free_space=bool(options.insert_free_space),
        )

    return insert
