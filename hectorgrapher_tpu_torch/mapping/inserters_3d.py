"""3D range-data insertion (counterpart of hectorgrapher_tpu/mapping/
inserters_3d.py, its occupancy and ray-mode TSDF parts).

Occupancy (ref: mapping/3d/range_data_inserter_3d.cc Insert +
InsertMissesIntoGrid): one odds update per hit cell, misses only on the
last num_free_space_voxels samples before each hit, a hit winning over a
miss in the same cell. Both are set-scatters of a constant into a mask,
so the card's result is deterministic and equal to the JAX package's bit
for bit.

TSDF (ref: mapping/3d/tsdf_range_data_inserter_3d.cc — ray-directed updates
(InsertHit, :294) with exponential weight drop-off behind the surface
(:333-341), weighted-average cell update (UpdateCell, :725),
insertion_ratio subsampling).

The per-sample UpdateCell loop becomes a scatter-add of (sum w, sum w*d)
followed by one combined update: the running weighted mean is
order-independent, except that the weight cap applies once at scan end.
On the card index_add_ sums with atomics in no fixed order (ROADMAP C3),
so a map matches the JAX package's to a tolerance, not bit for bit.

Only the ray mode is ported. The builder hands over range data with
width 0, so the default CLOUD_STRUCTURE method falls through to it as in
the JAX package; the normal-directed modes (organized-cloud normals, KNN
PCA, triangle fill-in) raise NotImplementedError.
"""

from __future__ import annotations

import math

import torch

from hectorgrapher_tpu_torch.mapping import probability_values as pv
from hectorgrapher_tpu_torch.mapping.grids import ProbabilityGrid, TSDFGrid, cell_center, cell_index, flat_index
from hectorgrapher_tpu_torch.sensor.types import RangeData


def insertion_ratio_mask(valid, ratio: float):
    """Deterministic subsampling: keep a point while the running kept count
    stays <= ratio * processed count (ref: tsdf_range_data_inserter_3d.cc
    :503-519 insertion_ratio gate), over the valid sequence."""
    if ratio >= 1.0:
        return valid
    c = torch.cumsum(valid.to(torch.int32), dim=0)  # processed count including self
    kept_before = torch.floor(ratio * (c - 1).to(torch.float32))
    kept_incl = torch.floor(ratio * c.to(torch.float32))
    return valid & (kept_incl > kept_before)


def insert_probability_3d(
    grid: ProbabilityGrid,
    range_data: RangeData,
    hit_log_odds: float,
    miss_log_odds: float,
    num_free_space_voxels: int = 2,
) -> ProbabilityGrid:
    """(inserters_3d.py insert_probability_3d :59-111.) Hits: one odds
    update per hit cell. Misses: the cells origin + (delta * pos) // n of
    the last num_free_space_voxels sample positions pos < n before each
    hit, n the hit's Chebyshev cell distance from the origin's cell. Hits
    take priority over misses in the same scan."""
    shape = grid.shape
    hits = range_data.returns.positions
    valid = range_data.returns.mask
    hit_idx = cell_index(grid.meta, hits)
    hit_mask = _scatter_mask3(shape, flat_index(hit_idx, shape), valid)
    if num_free_space_voxels > 0:
        origin_cell = cell_index(grid.meta, range_data.origin[None, :])[0]
        delta = hit_idx - origin_cell[None, :]
        num_samples = torch.amax(torch.abs(delta), dim=-1)  # (P,)
        offsets = torch.arange(num_free_space_voxels, dtype=torch.int32, device=hits.device)
        pos = num_samples[:, None] - num_free_space_voxels + offsets[None, :]
        pos_valid = (pos >= 0) & (pos < num_samples[:, None]) & valid[:, None]
        n_safe = torch.clamp(num_samples, min=1)[:, None, None]
        # delta is negative behind the origin: floor division, as JAX's //.
        miss_cells = origin_cell + torch.div(delta[:, None, :] * pos[:, :, None], n_safe, rounding_mode="floor")
        miss_mask = _scatter_mask3(shape, flat_index(miss_cells, shape).reshape(-1), pos_valid.reshape(-1))
        miss_mask = miss_mask & ~hit_mask
    else:
        miss_mask = torch.zeros(shape, dtype=torch.bool, device=hits.device)
    f32 = dict(dtype=torch.float32, device=hits.device)
    delta_lo = torch.where(hit_mask, torch.tensor(hit_log_odds, **f32), 0.0) + torch.where(
        miss_mask, torch.tensor(miss_log_odds, **f32), 0.0)
    touched = hit_mask | miss_mask
    return grid._replace(
        log_odds=torch.where(touched, pv.clamp_log_odds(grid.log_odds + delta_lo), grid.log_odds),
        known=grid.known | touched,
    )


def _scatter_mask3(shape, flat_idx, valid):
    """A bool grid of `shape`, True at flat_idx where valid (flat_index
    sends out-of-grid cells to the drop slot at the end)."""
    size = math.prod(shape)
    mask = torch.zeros(size + 1, dtype=torch.bool, device=flat_idx.device)
    mask[torch.where(valid, flat_idx, size)] = True
    return mask[:size].reshape(shape)


def make_probability_inserter_3d(options):
    """Bind ProbabilityGridRangeDataInserterOptions3D: the hit and miss
    log-odds in Python float64, as the JAX package computes them."""
    hit_lo = math.log(options.hit_probability / (1 - options.hit_probability))
    miss_lo = math.log(options.miss_probability / (1 - options.miss_probability))
    k = int(options.num_free_space_voxels)

    def insert(grid: ProbabilityGrid, range_data: RangeData) -> ProbabilityGrid:
        return insert_probability_3d(grid, range_data, hit_lo, miss_lo, num_free_space_voxels=k)

    return insert


def insert_tsdf_3d(
    grid: TSDFGrid,
    hits,
    valid,
    origin,
    num_band_samples: int,
    weight_epsilon: float,
    weight_sigma: float,
) -> TSDFGrid:
    """Ray-mode TSDF integration (ref InsertHit :294): the truncation band
    is swept along the ray through each hit; the update distance is
    range - |cell_center - origin|, with an exponential weight drop-off
    behind the surface (:333-341)."""
    shape = grid.shape
    td = grid.truncation_distance
    ray = hits - origin[None, :]
    ranges = torch.linalg.vector_norm(ray, dim=-1)
    ray_dir = ray / torch.clamp(ranges[:, None], min=1e-9)
    valid = valid & (ranges > td)

    s = torch.linspace(-1.0, 1.0, num_band_samples, dtype=torch.float32, device=hits.device)
    band_pts = hits[:, None, :] + (s[None, :, None] * td) * ray_dir[:, None, :]
    idx = cell_index(grid.meta, band_pts)
    centers = cell_center(grid.meta, idx)
    d = ranges[:, None] - torch.linalg.vector_norm(centers - origin[None, None, :], dim=-1)
    d = torch.clamp(d, -td, td)
    nd_norm = d / td
    w = torch.where(
        nd_norm < -weight_epsilon,
        torch.exp(-weight_sigma * (-nd_norm - weight_epsilon) ** 2),
        torch.ones_like(nd_norm),
    )

    flat = flat_index(idx, shape)
    vmask = valid[:, None].expand(flat.shape)
    size = grid.tsd.numel()
    slot = torch.where(vmask, flat, size).reshape(-1)
    w_flat = torch.where(vmask, w, 0.0).reshape(-1)
    wd_flat = torch.where(vmask, w * d, 0.0).reshape(-1)
    w_sum = torch.zeros(size + 1, dtype=torch.float32, device=hits.device).index_add_(0, slot, w_flat)
    wd_sum = torch.zeros(size + 1, dtype=torch.float32, device=hits.device).index_add_(0, slot, wd_flat)
    w_sum = w_sum[:size].reshape(shape)
    wd_sum = wd_sum[:size].reshape(shape)

    # Half planes (f16, bf16) are read in f32 and the update rounded back
    # to their dtype to nearest even, as the JAX package's astype does. A
    # bf16 weight holds integers exactly only up to 256: above that it
    # stops growing, in the JAX package and here alike.
    tsd32 = grid.tsd.to(torch.float32)
    wgt32 = grid.weight.to(torch.float32)
    new_w_raw = wgt32 + w_sum
    new_tsd = torch.where(w_sum > 0, (tsd32 * wgt32 + wd_sum) / torch.clamp(new_w_raw, min=1e-9), tsd32)
    return grid._replace(tsd=new_tsd.to(grid.tsd.dtype),
                         weight=torch.minimum(new_w_raw, grid.max_weight).to(grid.weight.dtype))


def make_tsdf_inserter_3d(options, resolution: float):
    """Bind TSDFRangeDataInserterOptions3D into an insert function."""
    num_band_samples = max(4, int(2.0 * options.relative_truncation_distance / 0.5) + 1)
    method = options.normal_computation_method
    if method in ("KNN_PCA", "PCL", "OPEN3D"):
        raise NotImplementedError(f"normal_computation_method={method!r}: KNN PCA normals are not ported")

    def insert(grid: TSDFGrid, range_data: RangeData) -> TSDFGrid:
        if range_data.width > 0 and method in ("CLOUD_STRUCTURE", "TRIANGLE_FILL_IN"):
            raise NotImplementedError(
                f"normal_computation_method={method!r} on organized range data: not ported"
            )
        hits = range_data.returns.positions
        r = torch.linalg.vector_norm(hits - range_data.origin[None, :], dim=-1)
        valid = range_data.returns.mask & (r >= options.min_range) & (r <= options.max_range)
        valid = insertion_ratio_mask(valid, float(options.insertion_ratio))
        return insert_tsdf_3d(
            grid, hits, valid, range_data.origin,
            num_band_samples=num_band_samples,
            weight_epsilon=options.weight_function_epsilon,
            weight_sigma=options.weight_function_sigma,
        )

    return insert
