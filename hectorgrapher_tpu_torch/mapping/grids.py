"""Dense grids as tensors (counterpart of hectorgrapher_tpu/mapping/grids.py;
ref: mapping/2d/grid_2d.h, probability_grid.h, mapping/3d/hybrid_grid_tsdf.h).

Conventions, as in the JAX package:
  * A grid covers the square (cube) centered at the submap-local origin.
  * cell_index i = floor((p - min_corner) / resolution), per axis, in f32.
  * cell_center = min_corner + (i + 0.5) * resolution.
  * Arrays are indexed [ix, iy] or [ix, iy, iz].

TSDF grids store float32 only: the JAX package's uint16 codec and f16/bf16
storage options are not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from hectorgrapher_tpu_torch.mapping import probability_values as pv


class GridMeta(NamedTuple):
    """Geometry of a dense grid, as tensors on the grid's device."""

    resolution: torch.Tensor  # scalar f32
    min_corner: torch.Tensor  # (2,) f32: position of cell (0, 0)'s corner


def make_meta(resolution: float, size_cells: Tuple[int, ...], device, center=None) -> GridMeta:
    half = torch.tensor([s * resolution / 2.0 for s in size_cells], dtype=torch.float32, device=device)
    if center is None:
        c = torch.zeros(len(size_cells), dtype=torch.float32, device=device)
    else:
        c = torch.as_tensor(center, dtype=torch.float32, device=device)
    return GridMeta(
        resolution=torch.tensor(resolution, dtype=torch.float32, device=device),
        min_corner=c - half,
    )


def cell_index(meta: GridMeta, points):
    """Float position (..., D) -> integer cell index (..., D), in float32."""
    p = points.to(torch.float32)
    return torch.floor((p - meta.min_corner) / meta.resolution).to(torch.int32)


def cell_center(meta: GridMeta, indices):
    """World position of the cells' centers (..., D), in float32."""
    return meta.min_corner + (indices.to(torch.float32) + 0.5) * meta.resolution


def in_bounds(indices, shape):
    ok = torch.ones(indices.shape[:-1], dtype=torch.bool, device=indices.device)
    for d, s in enumerate(shape):
        ok &= (indices[..., d] >= 0) & (indices[..., d] < s)
    return ok


def flat_index(indices, shape):
    """Row-major linear index; out-of-bounds mapped to size (drop slot)."""
    ok = in_bounds(indices, shape)
    flat = torch.zeros(indices.shape[:-1], dtype=torch.int64, device=indices.device)
    for d, s in enumerate(shape):
        flat = flat * s + torch.clamp(indices[..., d], 0, s - 1)
    size = 1
    for s in shape:
        size *= s
    return torch.where(ok, flat, size)


class ProbabilityGrid(NamedTuple):
    """Occupancy grid: log-odds + known mask."""

    log_odds: torch.Tensor  # (nx, ny) f32
    known: torch.Tensor  # (nx, ny) bool
    meta: GridMeta

    @property
    def shape(self):
        return tuple(self.log_odds.shape)

    def probability(self):
        """Occupancy probability; unknown cells read MIN_PROBABILITY."""
        p = pv.probability_from_log_odds(self.log_odds)
        return torch.where(self.known, pv.clamp_probability(p), pv.MIN_PROBABILITY)


def make_probability_grid(resolution: float, size_cells: Tuple[int, ...], device, center=None) -> ProbabilityGrid:
    return ProbabilityGrid(
        log_odds=torch.zeros(size_cells, dtype=torch.float32, device=device),
        known=torch.zeros(size_cells, dtype=torch.bool, device=device),
        meta=make_meta(resolution, size_cells, device, center),
    )


class TSDFGrid(NamedTuple):
    """Truncated signed distance grid with per-cell weights (ref:
    mapping/3d/hybrid_grid_tsdf.h). weight == 0 marks an unknown cell,
    whose tsd reads +truncation_distance."""

    tsd: torch.Tensor  # (nx, ny[, nz]) f32
    weight: torch.Tensor  # same shape, f32
    truncation_distance: torch.Tensor  # scalar f32
    max_weight: torch.Tensor  # scalar f32
    meta: GridMeta

    @property
    def shape(self):
        return tuple(self.tsd.shape)


def make_tsdf_grid(
    resolution: float,
    size_cells: Tuple[int, ...],
    truncation_distance: float,
    max_weight: float,
    device,
    center=None,
) -> TSDFGrid:
    return TSDFGrid(
        tsd=torch.full(size_cells, truncation_distance, dtype=torch.float32, device=device),
        weight=torch.zeros(size_cells, dtype=torch.float32, device=device),
        truncation_distance=torch.tensor(truncation_distance, dtype=torch.float32, device=device),
        max_weight=torch.tensor(max_weight, dtype=torch.float32, device=device),
        meta=make_meta(resolution, size_cells, device, center),
    )
