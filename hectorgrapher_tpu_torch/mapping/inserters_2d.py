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
from hectorgrapher_tpu_torch.mapping.grids import ProbabilityGrid, TSDFGrid, cell_center, cell_index, flat_index
from hectorgrapher_tpu_torch.mapping.inserters_3d import _update_cells
from hectorgrapher_tpu_torch.sensor.types import PointCloud, RangeData


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


def estimate_normals_2d(returns: PointCloud, origin, sample_radius: float, num_normal_samples: int = 4):
    """Unit normals (N, 2) of a 2D scan whose returns are sorted by scan
    angle (inserters_2d.py :143-182; ref: mapping/internal/2d/
    normal_estimation_2d.cc EstimateNormals): the tangent sums the
    differences to at most num_normal_samples // 2 neighbours on each side
    (the index wraps around, as jnp.roll does) that are valid and within
    sample_radius; the normal is its perpendicular, or toward the origin
    where the tangent is below 1e-9, and is turned toward the origin.
    Where the tangent is near 1e-9 the two packages may take different
    branches (ROADMAP C16)."""
    pts = returns.positions[:, :2]
    tangent = torch.zeros_like(pts)
    for k in range(1, max(1, num_normal_samples // 2) + 1):
        nxt = torch.roll(pts, -k, dims=0)
        prv = torch.roll(pts, k, dims=0)
        m_next = torch.roll(returns.mask, -k) & (torch.linalg.vector_norm(nxt - pts, dim=-1) < sample_radius)
        m_prev = torch.roll(returns.mask, k) & (torch.linalg.vector_norm(pts - prv, dim=-1) < sample_radius)
        tangent = tangent + torch.where(m_next[:, None], nxt - pts, 0.0)
        tangent = tangent + torch.where(m_prev[:, None], pts - prv, 0.0)
    normal = torch.stack([-tangent[:, 1], tangent[:, 0]], dim=-1)
    norm = torch.linalg.vector_norm(normal, dim=-1, keepdim=True)
    # Fallback for isolated points: toward the sensor.
    to_origin = origin[None, :2] - pts
    to_origin = to_origin / torch.clamp(torch.linalg.vector_norm(to_origin, dim=-1, keepdim=True), min=1e-9)
    normal = torch.where(norm > 1e-9, normal / torch.clamp(norm, min=1e-9), to_origin)
    flip = torch.sum(normal * to_origin, dim=-1, keepdim=True) < 0
    return torch.where(flip, -normal, normal)


def insert_tsdf_2d(
    grid: TSDFGrid,
    range_data: RangeData,
    normals,
    num_band_samples: int,
    project_to_normal: bool,
    range_exponent: int,
    angle_bandwidth: float,
    distance_bandwidth: float,
) -> TSDFGrid:
    """Insert one scan into a 2D TSDF (inserters_2d.py :185-256; ref:
    tsdf_range_data_inserter_2d.cc InsertHit:165 + UpdateCell:229): the
    cells of num_band_samples samples over [-td, td] along each hit's ray
    get the cell centre's signed distance to the surface, along the
    hit's normal with project_to_normal, else along the ray, clipped to
    +-td, with the weight 1 / range^range_exponent times the Gaussian
    kernels of the normal-to-ray angle and of the sample's distance to the
    hit. Returns in range_data.returns closer than td are skipped. The band
    is computed in f32 (the JAX package's linspace runs in f64 under x64,
    ROADMAP C1). The grid keeps its planes' dtype (C21, fixed)."""
    td = grid.truncation_distance
    origin2 = range_data.origin[:2]
    hits = range_data.returns.positions[:, :2]
    ray = hits - origin2
    ranges = torch.linalg.vector_norm(ray, dim=-1)
    ray_dir = ray / torch.clamp(ranges[:, None], min=1e-9)
    valid = range_data.returns.mask & (ranges > td)

    s = torch.linspace(-1.0, 1.0, num_band_samples, dtype=torch.float32, device=hits.device)
    band_pts = hits[:, None, :] + (s[None, :, None] * td) * ray_dir[:, None, :]  # (P, S, 2)
    idx = cell_index(grid.meta, band_pts)
    centers = cell_center(grid.meta, idx)
    if project_to_normal:
        # Signed distance of the cell centre to the surface along the
        # normal (ref: project_sdf_distance_to_scan_normal, :143-163).
        d = torch.sum((hits[:, None, :] - centers) * normals[:, None, :], dim=-1)
    else:
        d = ranges[:, None] - torch.linalg.vector_norm(centers - origin2[None, None, :], dim=-1)
    d = torch.clamp(d, -td, td)

    # Update weight (ref: ComputeRangeWeightFactor + angle/distance kernels).
    w = torch.ones_like(d)
    if range_exponent != 0:
        w = w / torch.clamp(ranges[:, None], min=1e-6) ** range_exponent
    cos_angle = torch.clamp(torch.abs(torch.sum(normals * ray_dir, dim=-1)), 0.0, 1.0)
    angle = torch.arccos(cos_angle)
    w = w * torch.exp(-(angle[:, None] ** 2) / max(2.0 * angle_bandwidth**2, 1e-9))
    w = w * torch.exp(-((s[None, :] * td) ** 2) / max(2.0 * distance_bandwidth**2, 1e-9))
    flat = flat_index(idx, grid.shape)
    return _update_cells(grid, flat, valid[:, None].expand(flat.shape), w, d)


def make_tsdf_inserter_2d(options, resolution: float):
    """Bind TSDFRangeDataInserterOptions2D into an inserter
    (inserters_2d.py :259-281): estimate_normals_2d, then insert_tsdf_2d
    over max(4, int(2 td / (0.5 resolution))) band samples."""
    num_band_samples = max(4, int(2.0 * options.truncation_distance / (resolution * 0.5)))
    normal_options = options.normal_estimation_options

    def insert(grid: TSDFGrid, range_data: RangeData) -> TSDFGrid:
        normals = estimate_normals_2d(range_data.returns, range_data.origin, normal_options.sample_radius,
                                      num_normal_samples=int(normal_options.num_normal_samples))
        return insert_tsdf_2d(
            grid,
            range_data,
            normals,
            num_band_samples=num_band_samples,
            project_to_normal=bool(options.project_sdf_distance_to_scan_normal),
            range_exponent=int(options.update_weight_range_exponent),
            angle_bandwidth=options.update_weight_angle_scan_normal_to_ray_kernel_bandwidth,
            distance_bandwidth=options.update_weight_distance_cell_to_hit_kernel_bandwidth,
        )

    return insert
