"""Loop-closure scan matching in 3D (counterpart of
hectorgrapher_tpu/mapping/scan_matching/fast_correlative_3d.py, its CPU
branch; ref: internal/3d/scan_matching/fast_correlative_scan_matcher_3d.cc).

A decimated admissible max pyramid per finished submap, yaw candidates
gated by the rotational histogram, an exhaustive coarse stage at the top
level, then a fixed top-k beam refined level by level (2 x 2 x 2 children
per survivor), and the final low-resolution gate. Every level's scores go
through kernel K4 (ops/fast_scores_3d.py).

Ties: jax.lax.top_k breaks them toward the lower index, torch.topk makes no
promise, so the beam takes the first k of a stable descending sort, on the
CPU and on the card (ROADMAP C10). The coarse levels plateau, so ties are
common.

match_fast_3d_batched searches the B candidates of a batched constraint
round in one K4 call per level over the submaps' stacked tables
(parallel/constraint_search.py); match_fast_3d is its one-candidate case.

Not ported: the TPU branch's X-paired rows and bf16 levels (levels stay
f32) and the HG_FM_CHUNK knob.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from hectorgrapher_tpu_torch.mapping.grids import ProbabilityGrid, ensure_f32_grid
from hectorgrapher_tpu_torch.mapping.scan_matching.rotational_histogram import match_histograms
from hectorgrapher_tpu_torch.ops.fast_scores_3d import fast_scores_3d
from hectorgrapher_tpu_torch.sensor.types import PointCloud
from hectorgrapher_tpu_torch.transform.rigid import Rigid3, quat_from_yaw, quat_multiply, quat_rotate


def grid_match_scores(grid):
    """Hit-likelihood field in [0.1, 0.9] (fast_correlative_3d.py :36-46),
    of a grid decoded to f32 first: an occupancy grid's probability
    (unknown cells 0.1); for a TSDF 0.9 (1 - |tsd| / truncation), clipped,
    where the weight is above 1e-6, else 0.1."""
    grid = ensure_f32_grid(grid)
    if isinstance(grid, ProbabilityGrid):
        return grid.probability()
    s = 0.9 * (1.0 - torch.abs(grid.tsd) / grid.truncation_distance)
    return torch.where(grid.weight > 1e-6, torch.clamp(s, 0.1, 0.9), 0.1)


_Y_MIN_LANES = 64  # y stops halving at this many lanes (the JAX layout)


def _y_shift(ny: int, level: int) -> int:
    """y decimation exponent at `level`: halve only while the lane count
    stays >= _Y_MIN_LANES (x and z always halve)."""
    m, cur = 0, ny
    while m < level and -(-cur // 2) >= _Y_MIN_LANES:
        cur = -(-cur // 2)
        m += 1
    return m


def precompute_pyramid_3d(values, depth: int):
    """Decimated admissible max pyramid: level 0 is the field; level l
    stores cells at stride 2^l in x and z and 2^m in y (m = _y_shift), each
    the max over the window that covers [q, q + 2^l) on every axis for any
    query q in the cell, so its value bounds every exact score there. Out
    of grid parts read the floor score 0.1."""
    out = [values]
    ny = values.shape[1]

    def pool2(m, axis):
        # Stride-2 aligned max; an odd extent pads with the floor.
        if m.shape[axis] % 2:
            pad_shape = list(m.shape)
            pad_shape[axis] = 1
            m = torch.cat([m, torch.full(pad_shape, 0.1, dtype=m.dtype, device=m.device)], dim=axis)
        lead = (slice(None),) * axis
        return torch.maximum(m[lead + (slice(0, None, 2),)], m[lead + (slice(1, None, 2),)])

    def widen(m, axis, window: int):
        # Running max over `window` adjacent cells, the high edge padded
        # with the floor: doubling shift-maxes, then one final shift.
        def shifted_by(x, s):
            s = min(s, x.shape[axis])
            pad_shape = list(x.shape)
            pad_shape[axis] = s
            return torch.cat(
                [x.narrow(axis, s, x.shape[axis] - s), torch.full(pad_shape, 0.1, dtype=x.dtype, device=x.device)],
                dim=axis,
            )

        cov, cur = 1, m
        while cov < window:
            s = min(cov, window - cov)
            cur = torch.maximum(cur, shifted_by(cur, s))
            cov += s
        return cur

    aligned = values
    prev_my = 0
    for level in range(1, depth):
        my = _y_shift(ny, level)
        aligned = pool2(aligned, 0)
        aligned = pool2(aligned, 2)
        if my > prev_my:
            aligned = pool2(aligned, 1)
            prev_my = my
        m = widen(aligned, 0, 2)
        m = widen(m, 2, 2)
        m = widen(m, 1, (1 << (level - my)) + 1)
        out.append(m)
    return out


def _level_flat_table(level_field):
    """One level (nx_l, ny_l, nz_l) -> its flat table: value - 0.1 as y
    rows in (z, x) order, then one zero row for out-of-grid cells."""
    rows = torch.permute(level_field - 0.1, (2, 0, 1)).reshape(-1, level_field.shape[1])
    return torch.cat([rows, torch.zeros((1, rows.shape[1]), dtype=rows.dtype, device=rows.device)]).contiguous()


class FastSearch3DConfig(NamedTuple):
    linear_xy_cells: int
    linear_z_cells: int
    depth: int
    top_k: int
    num_yaw: int  # yaw candidates span [-num_yaw, num_yaw] * yaw_step
    yaw_step: float
    min_rotational_score: float
    min_low_resolution_score: float


def make_fast_search_3d_config(
    options, resolution: float, max_scan_range: float, full_submap: bool = False, top_k: int = 2048,
    grid_cells: int = 0,
) -> FastSearch3DConfig:
    """options: FastCorrelativeScanMatcherOptions3D. A full-submap search
    (global localization) passes grid_cells: its linear window covers the
    whole submap."""
    yaw_step = math.acos(
        max(-1.0, min(1.0, 1.0 - resolution**2 / (2.0 * max(max_scan_range, resolution) ** 2)))
    )
    yaw_window = math.pi if full_submap else options.angular_search_window
    num_yaw = int(math.ceil(yaw_window / yaw_step))
    max_yaw_candidates = 128
    if num_yaw > max_yaw_candidates:
        yaw_step = yaw_window / max_yaw_candidates
        num_yaw = max_yaw_candidates
    xy_cells = int(math.ceil(options.linear_xy_search_window / resolution))
    z_cells = int(math.ceil(options.linear_z_search_window / resolution))
    if full_submap and grid_cells > 0:
        xy_cells = max(xy_cells, grid_cells // 2)
        z_cells = max(z_cells, grid_cells // 4)
    depth = max(1, min(options.branch_and_bound_depth, int(math.log2(max(2 * xy_cells, 2)))))
    return FastSearch3DConfig(xy_cells, z_cells, depth, top_k, num_yaw, yaw_step,
                              options.min_rotational_score, options.min_low_resolution_score)


def _top(cands, scores, k: int):
    """Along each row of scores (B, N), the k best candidates, ties to the
    lower index (jax.lax.top_k's order): the first k of a stable
    descending sort. cands: (B, N) each; returns (B, k) each."""
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices[:, : min(k, scores.shape[1])]
    return tuple(torch.gather(c, 1, order) for c in cands), torch.gather(scores, 1, order)


def match_fast_3d(tables, grid_shape, grid_meta, low_scores, low_meta, high_cloud, low_cloud,
                  initial_pose: Rigid3, yaw_scores, config: FastSearch3DConfig):
    """The search of one scan against one submap (_match_fast_3d_core, CPU
    branch): match_fast_3d_batched with one candidate. tables: the
    per-level flat tables; grid_shape: the level-0 (nx, ny, nz). Returns
    (score, low_res_score, rotational_score, pose) as tensors.

    initial_pose maps the scan's tracking frame into the grid frame; yaw
    candidates rotate about z through the initial pose's position. Each
    level's scoring is one K4 call; match_fast_3d.score_sums counts them."""
    score, low_score, rot_score, pose = match_fast_3d_batched(
        tables, None, grid_shape, grid_meta.resolution, grid_meta.min_corner[None], low_scores[None],
        torch.zeros(1, dtype=torch.long, device=low_scores.device), low_meta.resolution, low_meta.min_corner[None],
        PointCloud(high_cloud.positions[None], high_cloud.mask[None]),
        PointCloud(low_cloud.positions[None], low_cloud.mask[None]),
        Rigid3(initial_pose.translation[None], initial_pose.rotation[None]), yaw_scores[None], config)
    return score[0], low_score[0], rot_score[0], Rigid3(pose.translation[0], pose.rotation[0])


def match_fast_3d_batched(tables, row_bases, grid_shape, resolution, min_corners, low_fields, low_slots,
                          low_resolution, low_min_corners, high_clouds, low_clouds, initial_poses: Rigid3,
                          yaw_scores, config: FastSearch3DConfig):
    """The search of B scans, each against its own submap, in one K4 call
    per pyramid level (the single-device body of the JAX package's
    _sharded_scores_3d, parallel/constraint_search.py:429-532, over
    _match_fast_3d_core(tables, row_bases, ...)).

    tables: per level, the submaps' stacked flat tables (blocks of
    nz_l * nx_l + 1 rows), or one submap's table when row_bases is None;
    row_bases: per level, (B,) int64 first row of each candidate's block;
    grid_shape: the level-0 (nx, ny, nz) every submap shares; resolution:
    the shared high-res resolution; min_corners: (B, 3) each candidate's
    high-res grid corner; low_fields (S, lx, ly, lz) stacked low-res score
    fields, low_slots (B,) each candidate's field, low_resolution,
    low_min_corners (B, 3); high_clouds, low_clouds: PointClouds (B, P, 3)
    / (B, Pl, 3); initial_poses: (B, 3), (B, 4); yaw_scores (B, T).
    Returns (scores (B,), low scores (B,), rotational scores (B,), poses
    Rigid3 (B, 3), (B, 4)).

    Per candidate the same arithmetic as a search of its own: its own
    point cells (B * T rows of the K4 calls), valid flags and n_valid, its
    own yaw gate, its own top-k (a stable descending sort along its row,
    so ties never cross candidates) and its own low-resolution gate. K4
    sums each output in point order, so a candidate's scores do not depend
    on the others in the call."""
    nx, ny, nz = grid_shape
    device = tables[0].device
    depth = min(config.depth, len(tables))
    b = high_clouds.positions.shape[0]
    n_yaw = 2 * config.num_yaw + 1
    yaws = (torch.arange(n_yaw, dtype=torch.float32, device=device) - config.num_yaw) * config.yaw_step
    yaw_ok = yaw_scores >= config.min_rotational_score  # (B, T)

    valid = high_clouds.mask  # (B, P)
    n_valid = torch.clamp(torch.sum(valid, dim=1), min=1).to(torch.float32)  # (B,)
    t0, q0 = initial_poses.translation, initial_poses.rotation
    base = quat_rotate(q0[:, None, :], high_clouds.positions) + t0[:, None, :]
    rel = base - t0[:, None, :]
    rot = quat_rotate(quat_from_yaw(yaws)[None, :, None, :], rel[:, None, :, :]) + t0[:, None, None, :]
    cells = torch.floor((rot - min_corners[:, None, None, :]) / resolution).to(torch.int32)  # (B, T, P, 3)
    bx, by, bz = (cells[..., i].reshape(b * n_yaw, -1).contiguous() for i in range(3))
    # One flag row per point row; one scan's flags serve every row.
    valid_rows = valid[0] if b == 1 else valid[:, None, :].expand(b, n_yaw, valid.shape[1]).reshape(b * n_yaw, -1)
    yaw_ok_rows = yaw_ok.reshape(-1)
    n_valid_rows = torch.repeat_interleave(n_valid, n_yaw)  # (B * T,)

    def score(level, cand_t, ox, oy, oz):
        """Normalised scores of the candidates at point rows cand_t (C,)."""
        match_fast_3d.score_sums += 1
        cand_base = None if row_bases is None else row_bases[level][cand_t.long() // n_yaw]
        s = fast_scores_3d(tables[level], bx, by, bz, valid_rows, cand_t, ox, oy, oz, level, _y_shift(ny, level),
                           grid_shape, cand_base)
        rows = cand_t.long()
        return torch.where(yaw_ok_rows[rows][:, None, None, None], 0.1 + s / n_valid_rows[rows][:, None, None, None],
                           -1.0)

    k = config.top_k
    lxy, lz = config.linear_xy_cells, config.linear_z_cells
    stride = 2 ** (depth - 1)
    nbx = 2 * ((lxy + stride - 1) // stride) + 1
    nbz = 2 * ((lz + stride - 1) // stride) + 1
    i32 = dict(dtype=torch.int32, device=device)
    off_xy = (torch.arange(nbx, **i32) - nbx // 2) * stride - stride // 2
    off_z = (torch.arange(nbz, **i32) - nbz // 2) * stride - stride // 2
    rows = torch.arange(b * n_yaw, **i32)
    s0 = score(depth - 1, rows, off_xy.expand(b * n_yaw, nbx).contiguous(),
               off_xy.expand(b * n_yaw, nbx).contiguous(), off_z.expand(b * n_yaw, nbz).contiguous())
    tt, gx, gy, gz = torch.meshgrid(rows, off_xy, off_xy, off_z, indexing="ij")
    cand, scores = _top(tuple(c.reshape(b, -1) for c in (tt, gx, gy, gz)), s0.reshape(b, -1), k)

    for level in range(depth - 2, -1, -1):
        d = torch.arange(2, **i32) * 2**level  # [0, 2^level]
        ct, cox, coy, coz = (c.reshape(-1) for c in cand)  # (B * K,)
        cxs = torch.clamp(cox[:, None] + d, -lxy, lxy)  # (B * K, 2)
        cys = torch.clamp(coy[:, None] + d, -lxy, lxy)
        czs = torch.clamp(coz[:, None] + d, -lz, lz)
        s = score(level, ct, cxs.contiguous(), cys.contiguous(), czs.contiguous())  # (B * K, 2, 2, 2)
        kk = ct.shape[0]
        cand, scores = _top(tuple(c.reshape(b, -1) for c in (
            torch.repeat_interleave(ct, 8),
            cxs[:, :, None, None].expand(kk, 2, 2, 2).reshape(-1),
            cys[:, None, :, None].expand(kk, 2, 2, 2).reshape(-1),
            czs[:, None, None, :].expand(kk, 2, 2, 2).reshape(-1),
        )), s.reshape(b, -1), k)

    best = torch.argmax(scores, dim=1, keepdim=True)  # (B, 1)
    row_best, ox, oy, oz = (torch.gather(c, 1, best)[:, 0] for c in cand)
    t_best = row_best.long() - torch.arange(b, device=device) * n_yaw
    offset = torch.stack([ox, oy, oz], dim=-1).to(torch.float32) * resolution
    pose = Rigid3(translation=t0 + offset, rotation=quat_multiply(quat_from_yaw(yaws[t_best]), q0))

    # Final low-resolution gate (ref: low_resolution_matcher.cc): the mean
    # low-res score of the low-res cloud at the chosen pose, in the
    # candidate's own field (the stacked fields, each with a 0.1 cell last).
    low_pts = quat_rotate(pose.rotation[:, None, :], low_clouds.positions) + pose.translation[:, None, :]
    li = torch.floor((low_pts - low_min_corners[:, None, :]) / low_resolution).to(torch.int32).long()
    lxs, lys, lzs = low_fields.shape[1:]
    lmask = low_clouds.mask
    lok = ((li[..., 0] >= 0) & (li[..., 0] < lxs) & (li[..., 1] >= 0) & (li[..., 1] < lys) & (li[..., 2] >= 0)
           & (li[..., 2] < lzs) & lmask)
    n_low = lxs * lys * lzs + 1
    lflat = torch.where(lok, (li[..., 0] * lys + li[..., 1]) * lzs + li[..., 2], n_low - 1)
    low_flat = torch.cat([low_fields.reshape(low_fields.shape[0], -1),
                          torch.full((low_fields.shape[0], 1), 0.1, device=device)], dim=1).reshape(-1)
    lv = torch.where(lmask, low_flat[low_slots.long()[:, None] * n_low + lflat], 0.0)
    low_score = torch.sum(lv, dim=1) / torch.clamp(torch.sum(lmask, dim=1), min=1)
    return scores[:, 0], low_score, torch.gather(yaw_scores, 1, t_best[:, None])[:, 0], pose


match_fast_3d.score_sums = 0


def yaw_scores_3d(use_rotational: bool, submap_histogram, scan_histogram, config: FastSearch3DConfig,
                  initial_yaw: float):
    """The rotational scores of the search's yaw candidates (T,): the scan
    histogram rotated by each candidate, plus the scan's initial yaw in the
    grid frame (a float, or an f64 tensor on the histogram's device),
    against the submap's (FastCorrelativeScanMatcher3D._run); all ones
    without the rotational matcher, else, past 16 candidates, -1 below the
    16th best: the coarse max-pool levels plateau and cannot rank yaws. The
    angles are summed in f64, then rounded to f32."""
    n_yaw = 2 * config.num_yaw + 1
    device = submap_histogram.device
    yaws = (torch.arange(n_yaw, dtype=torch.float64, device=device) - config.num_yaw) * config.yaw_step
    if not isinstance(scan_histogram, torch.Tensor):
        scan_histogram = torch.from_numpy(np.array(scan_histogram, dtype=np.float32))  # a writable copy
    yaw_scores = match_histograms(
        submap_histogram, scan_histogram.to(device=device, dtype=torch.float32),
        (yaws + initial_yaw).to(torch.float32),
    )
    if not use_rotational:
        return torch.ones_like(yaw_scores)
    max_yaws = 16
    if yaw_scores.shape[0] > max_yaws:
        kth = torch.sort(yaw_scores).values[-max_yaws]
        yaw_scores = torch.where(yaw_scores >= kth, yaw_scores, -1.0)
    return yaw_scores


class FastCorrelativeScanMatcher3D:
    """Per finished submap: the pyramid tables and the low-res score field,
    built once, then searched per candidate node (ref:
    fast_correlative_scan_matcher_3d.h, built by the constraint builder)."""

    def __init__(self, options, high_grid, low_grid, submap_histogram, histogram_size=120):
        """high_grid, low_grid: a submap's grids of either type, f32 or
        uint16-coded; only their scores, geometry and shape are kept."""
        self._options = options
        self._high_grid = high_grid
        self._low_grid = low_grid
        self._device = high_grid.meta.min_corner.device
        scores = grid_match_scores(high_grid)
        # The full branch-and-bound depth, clamped only by the grid extent:
        # full-submap searches need deeper levels than a local window.
        depth = max(1, min(int(options.branch_and_bound_depth), int(math.log2(max(min(scores.shape), 2)))))
        self._pyramid_levels = tuple(_level_flat_table(level) for level in precompute_pyramid_3d(scores, depth))
        self._low_scores = grid_match_scores(low_grid)
        self._histogram = torch.as_tensor(np.asarray(submap_histogram, np.float32), device=scores.device)
        self._histogram_size = histogram_size
        self._resolution = float(high_grid.meta.resolution)

    @property
    def pyramid_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self._pyramid_levels)

    def to_host(self, pyramid_levels=None, low_scores=None, histogram=None):
        """Demote the search state (pyramid tables, low-res field,
        histogram) to CPU tensors, given or copied: the pose graph's pack
        is then the only device copy. A later match() uploads them again
        for its own search, as the JAX package's jit does with numpy
        arguments; the pose graph searches a packed submap through the
        pack instead."""
        self._pyramid_levels = tuple(pyramid_levels or (t.cpu() for t in self._pyramid_levels))
        self._low_scores = self._low_scores.cpu() if low_scores is None else low_scores
        self._histogram = self._histogram.cpu() if histogram is None else histogram

    def _run(self, high_cloud, low_cloud, initial_pose, config, scan_histogram, initial_yaw):
        dev = self._device
        yaw_scores = yaw_scores_3d(bool(self._options.use_rotational_scan_matcher), self._histogram.to(dev),
                                   scan_histogram, config, initial_yaw)
        return match_fast_3d(
            tuple(t.to(dev) for t in self._pyramid_levels), self._high_grid.shape, self._high_grid.meta,
            self._low_scores.to(dev), self._low_grid.meta, high_cloud, low_cloud, initial_pose, yaw_scores, config,
        )

    def search_config(self, max_scan_range: float, full_submap: bool, top_k: int = 256) -> FastSearch3DConfig:
        """The local window search's configuration, or with full_submap the
        full yaw range and a window that covers the submap."""
        return make_fast_search_3d_config(self._options, self._resolution, max_scan_range, full_submap, top_k,
                                          grid_cells=int(self._high_grid.shape[0]) if full_submap else 0)

    def match(self, initial_pose: Rigid3, high_cloud, low_cloud, scan_histogram, initial_yaw, max_scan_range=20.0,
              top_k=256):
        """(ref: Match :158, the local window search)"""
        config = self.search_config(max_scan_range, False, top_k)
        return self._run(high_cloud, low_cloud, initial_pose, config, scan_histogram, initial_yaw)

    def match_full_submap(self, initial_pose: Rigid3, high_cloud, low_cloud, scan_histogram, initial_yaw,
                          max_scan_range=20.0, top_k=256):
        """(ref: MatchFullSubmap :177)"""
        config = self.search_config(max_scan_range, True, top_k)
        return self._run(high_cloud, low_cloud, initial_pose, config, scan_histogram, initial_yaw)
