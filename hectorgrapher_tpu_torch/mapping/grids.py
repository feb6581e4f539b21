"""Dense grids as tensors (counterpart of hectorgrapher_tpu/mapping/grids.py;
ref: mapping/2d/grid_2d.h, probability_grid.h, mapping/3d/hybrid_grid_tsdf.h).

Conventions, as in the JAX package:
  * A grid covers the square (cube) centered at the submap-local origin.
  * cell_index i = floor((p - min_corner) / resolution), per axis, in f32.
  * cell_center = min_corner + (i + 0.5) * resolution.
  * Arrays are indexed [ix, iy] or [ix, iy, iz].

Occupancy grids (2D and 3D) store float32 log-odds and a known mask; TSDF
grids (tsd, weight) in their storage dtype (STORAGE_DTYPES): float32, or
float16 / bfloat16 planes that every consumer upcasts to float32 after
reading, as the JAX package does. A finished 3D submap may hold either
grid type as the JAX package's uint16 codes (quantize_*_grid), which
ensure_f32_grid decodes before any consumer reads them.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
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
    """Occupancy grid, 2D or 3D: log-odds + known mask."""

    log_odds: torch.Tensor  # (nx, ny[, nz]) f32, or uint16 codes (quantize_probability_grid)
    known: torch.Tensor  # same shape, bool
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

    tsd: torch.Tensor  # (nx, ny[, nz]) f32, f16 or bf16 (or uint16 codes)
    weight: torch.Tensor  # same shape and dtype
    truncation_distance: torch.Tensor  # scalar f32
    max_weight: torch.Tensor  # scalar f32
    meta: GridMeta

    @property
    def shape(self):
        return tuple(self.tsd.shape)


# grid_storage_dtype names (grids.py STORAGE_DTYPES :146-156 of the JAX
# package). "uint16" grids compute in f32 and quantize when their submap
# finishes; "float16" and "bfloat16" TSDF planes are stored in half
# precision and upcast to f32 by every consumer after reading.
STORAGE_DTYPES = {
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "uint16": torch.uint16,
}


def make_tsdf_grid(
    resolution: float,
    size_cells: Tuple[int, ...],
    truncation_distance: float,
    max_weight: float,
    device,
    center=None,
    dtype=torch.float32,
) -> TSDFGrid:
    """(grids.py make_tsdf_grid :240-258.) dtype: the planes' storage
    precision; the truncation distance and the weight cap stay f32."""
    return TSDFGrid(
        tsd=torch.full(size_cells, truncation_distance, dtype=dtype, device=device),
        weight=torch.zeros(size_cells, dtype=dtype, device=device),
        truncation_distance=torch.tensor(truncation_distance, dtype=torch.float32, device=device),
        max_weight=torch.tensor(max_weight, dtype=torch.float32, device=device),
        meta=make_meta(resolution, size_cells, device, center),
    )


# ---------------------------------------------------------------------------
# uint16 storage (grids.py :169-233 of the JAX package): a bounded value
# range mapped linearly onto codes 1..65535, code 0 for "unknown". Codes
# are torch.uint16, which supports little arithmetic: every computation
# goes through int32 or float32.
# ---------------------------------------------------------------------------

_QUANT_LEVELS = 65534  # codes 1..65535 span the value range; 0 = unknown


def _encode_u16(values, lo, hi, known):
    """Linear [lo, hi] -> uint16 codes 1..65535; unknown -> 0. torch.round
    rounds half to even, as jnp.round does."""
    span = torch.clamp(torch.as_tensor(hi - lo, dtype=torch.float32), min=1e-12)
    t = torch.clamp((values - lo) / span, 0.0, 1.0)
    code = (torch.round(t * _QUANT_LEVELS) + 1.0).to(torch.int32)
    return torch.where(known, code, 0).to(torch.uint16)


def _decode_u16(codes, lo, hi, unknown_value):
    c = codes.to(torch.int32)
    t = (c.to(torch.float32) - 1.0) / _QUANT_LEVELS
    return torch.where(c > 0, lo + t * (hi - lo), unknown_value)


def quantize_tsdf_grid(grid: TSDFGrid) -> TSDFGrid:
    """f32 (tsd, weight) -> uint16 codes: tsd spans [-td, td], weight [0,
    max_weight]; weight code 0 keeps weight == 0 as the unknown mark."""
    if grid.tsd.dtype == torch.uint16:
        return grid
    td = grid.truncation_distance
    known = grid.weight > 0
    return grid._replace(
        tsd=_encode_u16(grid.tsd.to(torch.float32), -td, td, known),
        weight=_encode_u16(grid.weight.to(torch.float32), 0.0, grid.max_weight, known),
    )


def dequantize_tsdf_grid(grid: TSDFGrid) -> TSDFGrid:
    if grid.tsd.dtype != torch.uint16:
        return grid
    td = grid.truncation_distance
    return grid._replace(
        tsd=_decode_u16(grid.tsd, -td, td, td),
        weight=_decode_u16(grid.weight, 0.0, grid.max_weight, 0.0),
    )


def quantize_probability_grid(grid: ProbabilityGrid) -> ProbabilityGrid:
    """f32 log-odds -> one uint16 code plane in log_odds (the clamped
    probability in [MIN, MAX] on codes 1..65535, 0 = unknown); known stays."""
    if grid.log_odds.dtype == torch.uint16:
        return grid
    p = pv.clamp_probability(pv.probability_from_log_odds(grid.log_odds))
    return grid._replace(log_odds=_encode_u16(p, pv.MIN_PROBABILITY, pv.MAX_PROBABILITY, grid.known))


def dequantize_probability_grid(grid: ProbabilityGrid) -> ProbabilityGrid:
    if grid.log_odds.dtype != torch.uint16:
        return grid
    p = _decode_u16(grid.log_odds, pv.MIN_PROBABILITY, pv.MAX_PROBABILITY, 0.5)
    return grid._replace(log_odds=pv.log_odds(torch.clamp(p, 1e-6, 1 - 1e-6)))


def ensure_f32_grid(grid):
    """A uint16-coded grid decoded to float32; any other grid as it is, f16
    and bf16 planes included (grids.py :221-228: consumers upcast after
    reading)."""
    if isinstance(grid, TSDFGrid):
        return dequantize_tsdf_grid(grid)
    if isinstance(grid, ProbabilityGrid):
        return dequantize_probability_grid(grid)
    return grid


def volume_dtype(grid) -> torch.dtype:
    """The dtype in which consumers read a grid's planes: uint16 codes
    decode to f32; f32 and half planes as they are stored."""
    planes = grid.tsd if isinstance(grid, TSDFGrid) else grid.log_odds
    return torch.float32 if planes.dtype == torch.uint16 else planes.dtype


def grid_nbytes(grid) -> int:
    """Storage bytes of a grid's cell planes (grids.py :231-235)."""
    if isinstance(grid, TSDFGrid):
        return grid.tsd.numel() * grid.tsd.element_size() + grid.weight.numel() * grid.weight.element_size()
    return grid.log_odds.numel() * grid.log_odds.element_size() + grid.known.numel() * grid.known.element_size()


def plane_to_numpy(plane: torch.Tensor) -> np.ndarray:
    """A grid plane as uplink payloads and state files carry it (numpy):
    uint16 codes as they are, any float plane as float16, rounded on the
    plane's device to nearest even, as numpy's cast rounds."""
    if plane.dtype == torch.uint16:
        return plane.cpu().numpy()
    return plane.to(torch.float16).cpu().numpy()
