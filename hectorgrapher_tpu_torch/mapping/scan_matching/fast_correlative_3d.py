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

Not ported: the TPU branch's X-paired rows and bf16 levels (levels stay
f32), the HG_FM_CHUNK knob, and to_host (the batched search's pack).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from hectorgrapher_tpu_torch.mapping.grids import TSDFGrid, cell_index
from hectorgrapher_tpu_torch.mapping.scan_matching.rotational_histogram import match_histograms
from hectorgrapher_tpu_torch.ops.fast_scores_3d import fast_scores_3d
from hectorgrapher_tpu_torch.transform.rigid import Rigid3, quat_from_yaw, quat_multiply, quat_rotate


def grid_match_scores(grid: TSDFGrid):
    """Hit-likelihood field in [0.1, 0.9]: 0.9 (1 - |tsd| / truncation),
    clipped, where the weight is above 1e-6, else 0.1."""
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
    """The k best candidates, ties to the lower index (jax.lax.top_k's
    order): the first k of a stable descending sort."""
    order = torch.sort(scores, descending=True, stable=True).indices[: min(k, scores.shape[0])]
    return tuple(c[order] for c in cands), scores[order]


def match_fast_3d(tables, grid_shape, grid_meta, low_scores, low_meta, high_cloud, low_cloud,
                  initial_pose: Rigid3, yaw_scores, config: FastSearch3DConfig):
    """The search (_match_fast_3d_core, CPU branch). tables: the per-level
    flat tables; grid_shape: the level-0 (nx, ny, nz). Returns (score,
    low_res_score, rotational_score, pose) as tensors.

    initial_pose maps the scan's tracking frame into the grid frame; yaw
    candidates rotate about z through the initial pose's position. Each
    level's scoring is one K4 call; match_fast_3d.score_sums counts them."""
    nx, ny, nz = grid_shape
    device = tables[0].device
    depth = min(config.depth, len(tables))
    res = grid_meta.resolution

    n_yaw = 2 * config.num_yaw + 1
    yaws = (torch.arange(n_yaw, dtype=torch.float32, device=device) - config.num_yaw) * config.yaw_step
    yaw_ok = yaw_scores >= config.min_rotational_score

    valid = high_cloud.mask
    n_valid = torch.clamp(torch.sum(valid), min=1).to(torch.float32)
    t0 = initial_pose.translation
    base = quat_rotate(initial_pose.rotation[None, :], high_cloud.positions) + t0[None, :]
    rel = base - t0[None, :]
    rot = quat_rotate(quat_from_yaw(yaws)[:, None, :], rel[None, :, :]) + t0[None, None, :]
    cells = cell_index(grid_meta, rot)  # (T, P, 3) int32
    bx, by, bz = (cells[..., i].contiguous() for i in range(3))

    def score(level, cand_t, ox, oy, oz):
        match_fast_3d.score_sums += 1
        s = fast_scores_3d(tables[level], bx, by, bz, valid, cand_t, ox, oy, oz, level, _y_shift(ny, level),
                           grid_shape)
        return torch.where(yaw_ok[cand_t.long()][:, None, None, None], 0.1 + s / n_valid, -1.0)

    k = config.top_k
    lxy, lz = config.linear_xy_cells, config.linear_z_cells
    stride = 2 ** (depth - 1)
    nbx = 2 * ((lxy + stride - 1) // stride) + 1
    nbz = 2 * ((lz + stride - 1) // stride) + 1
    i32 = dict(dtype=torch.int32, device=device)
    off_xy = (torch.arange(nbx, **i32) - nbx // 2) * stride - stride // 2
    off_z = (torch.arange(nbz, **i32) - nbz // 2) * stride - stride // 2
    yaw_rows = torch.arange(n_yaw, **i32)
    s0 = score(depth - 1, yaw_rows, off_xy.expand(n_yaw, nbx).contiguous(), off_xy.expand(n_yaw, nbx).contiguous(),
               off_z.expand(n_yaw, nbz).contiguous())  # (T, JX, JY, JZ)
    tt, gx, gy, gz = torch.meshgrid(yaw_rows, off_xy, off_xy, off_z, indexing="ij")
    cand, scores = _top((tt.reshape(-1), gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)), s0.reshape(-1), k)

    for level in range(depth - 2, -1, -1):
        d = torch.tensor([0, 2**level], **i32)
        ct, cox, coy, coz = cand
        cxs = torch.clamp(cox[:, None] + d, -lxy, lxy)  # (K, 2)
        cys = torch.clamp(coy[:, None] + d, -lxy, lxy)
        czs = torch.clamp(coz[:, None] + d, -lz, lz)
        s = score(level, ct, cxs.contiguous(), cys.contiguous(), czs.contiguous())  # (K, 2, 2, 2)
        kk = ct.shape[0]
        cand, scores = _top((
            torch.repeat_interleave(ct, 8),
            cxs[:, :, None, None].expand(kk, 2, 2, 2).reshape(-1),
            cys[:, None, :, None].expand(kk, 2, 2, 2).reshape(-1),
            czs[:, None, None, :].expand(kk, 2, 2, 2).reshape(-1),
        ), s.reshape(-1), k)

    best = torch.argmax(scores)
    t_best, ox, oy, oz = (c[best] for c in cand)
    offset = torch.stack([ox, oy, oz]).to(torch.float32) * res
    pose = Rigid3(translation=t0 + offset, rotation=quat_multiply(quat_from_yaw(yaws[t_best]), initial_pose.rotation))

    # Final low-resolution gate (ref: low_resolution_matcher.cc): the mean
    # low-res score of the low-res cloud at the chosen pose.
    low_pts = quat_rotate(pose.rotation[None, :], low_cloud.positions) + pose.translation[None, :]
    li = cell_index(low_meta, low_pts).long()
    lxs, lys, lzs = low_scores.shape
    lok = ((li[:, 0] >= 0) & (li[:, 0] < lxs) & (li[:, 1] >= 0) & (li[:, 1] < lys) & (li[:, 2] >= 0)
           & (li[:, 2] < lzs) & low_cloud.mask)
    lflat = torch.where(lok, (li[:, 0] * lys + li[:, 1]) * lzs + li[:, 2], lxs * lys * lzs)
    low_flat = torch.cat([low_scores.reshape(-1), torch.full((1,), 0.1, device=device)])
    lv = torch.where(low_cloud.mask, low_flat[lflat], 0.0)
    low_score = torch.sum(lv) / torch.clamp(torch.sum(low_cloud.mask), min=1)
    return scores[best], low_score, yaw_scores[t_best], pose


match_fast_3d.score_sums = 0


class FastCorrelativeScanMatcher3D:
    """Per finished submap: the pyramid tables and the low-res score field,
    built once, then searched per candidate node (ref:
    fast_correlative_scan_matcher_3d.h, built by the constraint builder)."""

    def __init__(self, options, high_grid: TSDFGrid, low_grid: TSDFGrid, submap_histogram, histogram_size=120):
        self._options = options
        self._high_grid = high_grid
        self._low_grid = low_grid
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

    def _run(self, high_cloud, low_cloud, initial_pose, config, scan_histogram, initial_yaw):
        n_yaw = 2 * config.num_yaw + 1
        yaws = (np.arange(n_yaw) - config.num_yaw) * config.yaw_step
        device = self._histogram.device
        # Rotating the scan by a yaw rotates its histogram: score each
        # candidate, plus the scan's initial yaw in the grid frame.
        yaw_scores = match_histograms(
            self._histogram, torch.tensor(np.asarray(scan_histogram), dtype=torch.float32, device=device),
            torch.as_tensor(yaws + initial_yaw, dtype=torch.float32, device=device),
        )
        if not bool(self._options.use_rotational_scan_matcher):
            yaw_scores = torch.ones_like(yaw_scores)
        else:
            # Beam restriction: keep the 16 best-scoring yaws besides the
            # threshold gate; the coarse max-pool levels plateau and cannot
            # rank yaws.
            max_yaws = 16
            if yaw_scores.shape[0] > max_yaws:
                kth = torch.sort(yaw_scores).values[-max_yaws]
                yaw_scores = torch.where(yaw_scores >= kth, yaw_scores, -1.0)
        return match_fast_3d(
            self._pyramid_levels, self._high_grid.shape, self._high_grid.meta, self._low_scores,
            self._low_grid.meta, high_cloud, low_cloud, initial_pose, yaw_scores, config,
        )

    def match(self, initial_pose: Rigid3, high_cloud, low_cloud, scan_histogram, initial_yaw, max_scan_range=20.0,
              top_k=256):
        """(ref: Match :158, the local window search)"""
        config = make_fast_search_3d_config(self._options, self._resolution, max_scan_range, False, top_k)
        return self._run(high_cloud, low_cloud, initial_pose, config, scan_histogram, initial_yaw)

    def match_full_submap(self, initial_pose: Rigid3, high_cloud, low_cloud, scan_histogram, initial_yaw,
                          max_scan_range=20.0, top_k=256):
        """(ref: MatchFullSubmap :177: the full yaw range, a window that
        covers the submap)"""
        config = make_fast_search_3d_config(self._options, self._resolution, max_scan_range, True, top_k,
                                            grid_cells=int(self._high_grid.shape[0]))
        return self._run(high_cloud, low_cloud, initial_pose, config, scan_histogram, initial_yaw)
