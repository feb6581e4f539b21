"""Loop-closure scan matching in 2D: dense coarse-to-fine with top-k
(counterpart of hectorgrapher_tpu/mapping/scan_matching/
fast_correlative_2d.py, its CPU branch; ref: internal/2d/scan_matching/
fast_correlative_scan_matcher_2d.{h,cc}, PrecomputationGrid2D :49 and the
branch-and-bound search :112).

A max-pool pyramid per finished submap holds the admissible upper bounds;
each depth is evaluated densely for a fixed top-k beam: every angle against
the dense stride-2^(depth-1) offset grid at the top level, then the 2 x 2
children of each survivor level by level, then the best. Every level's
scores go through kernel K5 (ops/fast_scores_2d.py).

The levels store probability - 0.1 with one zero x-row at index nx, so an
out-of-grid lookup contributes exactly 0 and a score is 0.1 + sum /
n_valid. The levels are f32 (the JAX CPU branch's _level_dtype; the TPU's
bf16 levels are not ported, ROADMAP C5), and so are the scores.

Ties: jax.lax.top_k breaks them toward the lower index, torch.topk makes no
promise, so the beam takes the first k of a stable descending sort, on the
CPU and on the card (ROADMAP C10).

match_fast_2d_batched searches the B candidates of a batched constraint
round in one K5 call per level over the submaps' stacked levels
(parallel/constraint_search.py); match_fast_2d_prepared is its
one-candidate case.

Not ported: the TPU branch of score_sum (one-hot row contractions), its
_on_tpu() switch and the HG_FM_CHUNK knob.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from hectorgrapher_tpu_torch.mapping.grids import GridMeta, ProbabilityGrid, TSDFGrid, ensure_f32_grid
from hectorgrapher_tpu_torch.ops.fast_scores_2d import fast_scores_2d
from hectorgrapher_tpu_torch.sensor.types import PointCloud
from hectorgrapher_tpu_torch.transform.rigid import Rigid2, rot2


def precompute_pyramid_2d(values, depth: int):
    """Max-pool stack: level d holds the max over [x, x + 2^d) x [y, y +
    2^d), cells past the grid left out (ref: PrecomputationGrid2D). Returns
    a list of depth tensors, each of values' shape."""
    out = [values]
    current = values
    for d in range(1, depth):
        w = 2 ** (d - 1)
        ninf = dict(dtype=current.dtype, device=current.device)
        sx = torch.cat([current[w:], torch.full((w,) + tuple(current.shape[1:]), -math.inf, **ninf)], dim=0)
        m = torch.maximum(current, sx)
        sy = torch.cat([m[:, w:], torch.full((m.shape[0], w), -math.inf, **ninf)], dim=1)
        current = torch.maximum(m, sy)
        out.append(current)
    return out


class FastSearchConfig(NamedTuple):
    num_angles: int  # candidates span [-num_angles, num_angles] * angle_step
    angle_step: float
    linear_cells: int  # offsets in [-linear_cells, linear_cells]
    depth: int
    top_k: int


def make_fast_search_config(
    linear_search_window: float,
    angular_search_window: float,
    resolution: float,
    max_scan_range: float,
    branch_and_bound_depth: int = 7,
    top_k: int = 256,
) -> FastSearchConfig:
    angle_step = math.acos(
        max(-1.0, min(1.0, 1.0 - resolution**2 / (2.0 * max(max_scan_range, resolution) ** 2)))
    )
    num_angles = int(math.ceil(angular_search_window / angle_step))
    linear_cells = int(math.ceil(linear_search_window / resolution))
    depth = max(1, min(branch_and_bound_depth, int(math.log2(max(2 * linear_cells, 2)))))
    return FastSearchConfig(num_angles, angle_step, linear_cells, depth, top_k)


class PreparedFastMatcher2D(NamedTuple):
    """One finished submap's search state, built once and searched by every
    candidate against it (ref: constraint_builder_2d.cc
    DispatchScanMatcherConstruction)."""

    flat_levels: torch.Tensor  # (depth, nx + 1, ny) f32: prob - 0.1; row nx = 0
    meta: GridMeta
    dims: Tuple[int, int]


def prepare_fast_matcher_2d(grid: ProbabilityGrid, depth: int) -> PreparedFastMatcher2D:
    """The submap's pyramid levels, decoded to f32 first.

    A TSDFGrid raises TypeError (ROADMAP C20, mirrored): the reference
    reads grid.probability() of every submap here, which its TSDFGrid
    lacks, so the JAX 2D pose graph finds no INTER constraint against a
    TSDF submap; the pose graph's worker logs the error and goes on, in
    both packages."""
    if isinstance(grid, TSDFGrid):
        raise TypeError("prepare_fast_matcher_2d: a 2D TSDF submap cannot be searched (ROADMAP C20, mirrored: "
                        "hectorgrapher_tpu/mapping/scan_matching/fast_correlative_2d.py:98 calls "
                        "grid.probability(), which TSDFGrid lacks)")
    grid = ensure_f32_grid(grid)
    prob = grid.probability()
    stack = torch.stack(precompute_pyramid_2d(prob, depth)) - 0.1  # (depth, nx, ny)
    flat_levels = torch.cat([stack, torch.zeros((depth, 1, prob.shape[1]), dtype=stack.dtype, device=stack.device)],
                            dim=1).contiguous()
    return PreparedFastMatcher2D(flat_levels=flat_levels, meta=grid.meta, dims=(int(prob.shape[0]),
                                                                                 int(prob.shape[1])))


def match_fast_2d(grid: ProbabilityGrid, cloud: PointCloud, initial_pose: Rigid2, config: FastSearchConfig):
    """Search the window around initial_pose; returns (score, pose) as
    tensors. The score is the mean occupancy probability at the hit cells
    (the reference's CandidateScore scale)."""
    return match_fast_2d_prepared(prepare_fast_matcher_2d(grid, config.depth), cloud, initial_pose, config)


def match_fast_2d_prepared(prepared: PreparedFastMatcher2D, cloud: PointCloud, initial_pose: Rigid2,
                           config: FastSearchConfig):
    """The search of one scan against one prepared submap:
    match_fast_2d_batched with one candidate. Returns (score, pose)."""
    levels = prepared.flat_levels
    scores, poses = match_fast_2d_batched(
        levels.reshape(-1, levels.shape[2]), None, prepared.meta.resolution, prepared.meta.min_corner[None],
        prepared.dims, PointCloud(cloud.positions[None], cloud.mask[None]),
        Rigid2(initial_pose.translation.reshape(1, 2), initial_pose.angle.reshape(1)), config)
    return scores[0], Rigid2(poses.translation[0], poses.angle[0])


def _top(cands, scores, k: int):
    """Along each row of scores (B, N), the k best candidates, ties to the
    lower index (jax.lax.top_k's order): the first k of a stable
    descending sort. cands: (B, N) each; returns (B, k) each."""
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices[:, : min(k, scores.shape[1])]
    return tuple(torch.gather(c, 1, order) for c in cands), torch.gather(scores, 1, order)


def match_fast_2d_batched(flat_table, row_bases, resolution, min_corners, dims, clouds: PointCloud,
                          initial_poses: Rigid2, config: FastSearchConfig):
    """The search of B scans, each against its own submap, in one K5 call
    per pyramid level (the single-device body of the JAX package's
    _sharded_scores_2d, parallel/constraint_search.py:78-139, over
    _match_fast_2d_core(flat_table, row_base, ...)).

    flat_table: (rows, ny) f32, the submaps' levels stacked (one submap's
    when row_bases is None); row_bases: (B,) int64 first row of each
    candidate's submap block, or None; resolution: the shared resolution;
    min_corners: (B, 2) each candidate's grid corner; dims: the grids' (nx,
    ny); clouds: (B, P, 3) / (B, P); initial_poses: (B, 2) / (B,) in the
    grids' frame. Returns (scores (B,), poses Rigid2 (B, 2) / (B,)).

    Per candidate the same arithmetic as a search of its own: its own point
    cells (B * T rows of the K5 calls), valid flags and n_valid, and its own
    top-k (a stable descending sort along its row, so ties never cross
    candidates). K5 sums each output in an order of its own, so a
    candidate's scores do not depend on the others in the call."""
    nx, ny = dims
    device = flat_table.device
    b = clouds.positions.shape[0]
    n_th = 2 * config.num_angles + 1
    thetas = (torch.arange(n_th, dtype=torch.float32, device=device) - config.num_angles) * config.angle_step
    angles = initial_poses.angle[:, None] + thetas  # (B, T)

    valid = clouds.mask  # (B, P)
    n_valid = torch.clamp(torch.sum(valid, dim=1), min=1).to(torch.float32)  # (B,)
    pts = clouds.positions[..., :2]
    rotated = rot2(angles[:, :, None], pts[:, None, :, :]) + initial_poses.translation[:, None, None, :]
    cells = torch.floor((rotated - min_corners[:, None, None, :]) / resolution).to(torch.int32)  # (B, T, P, 2)
    bx, by = (cells[..., i].reshape(b * n_th, -1).contiguous() for i in range(2))
    # One flag row per point row; one scan's flags serve every row.
    valid_rows = (valid[0] if b == 1 else valid[:, None, :].expand(b, n_th, -1).reshape(b * n_th, -1)).contiguous()
    n_valid_rows = torch.repeat_interleave(n_valid, n_th)  # (B * T,)

    def score(level, cand_t, ox, oy):
        """Normalised scores (C, X, Y) of the candidates at point rows cand_t."""
        match_fast_2d_batched.score_sums += 1
        cand_base = None if row_bases is None else row_bases[cand_t.long() // n_th]
        s = fast_scores_2d(flat_table, bx, by, valid_rows, cand_t, ox, oy, level, dims, cand_base)
        return 0.1 + s / n_valid_rows[cand_t.long()][:, None, None]

    k = config.top_k
    lc = config.linear_cells
    stride = 2 ** (config.depth - 1)
    n_blocks = 2 * ((lc + stride - 1) // stride) + 1
    i32 = dict(dtype=torch.int32, device=device)
    block_off = (torch.arange(n_blocks, **i32) - n_blocks // 2) * stride - stride // 2
    rows = torch.arange(b * n_th, **i32)
    offs = block_off.expand(b * n_th, n_blocks).contiguous()
    s0 = score(config.depth - 1, rows, offs, offs)  # (B * T, J, J)
    tt, gx, gy = torch.meshgrid(rows, block_off, block_off, indexing="ij")
    cand, scores = _top(tuple(c.reshape(b, -1) for c in (tt, gx, gy)), s0.reshape(b, -1), k)

    for level in range(config.depth - 2, -1, -1):
        d = torch.arange(2, **i32) * 2**level  # [0, 2^level]
        ct, cox, coy = (c.reshape(-1) for c in cand)  # (B * K,)
        cxs = torch.clamp(cox[:, None] + d, -lc, lc)  # (B * K, 2)
        cys = torch.clamp(coy[:, None] + d, -lc, lc)
        s = score(level, ct, cxs.contiguous(), cys.contiguous())  # (B * K, 2, 2): [x0y0 x0y1; x1y0 x1y1]
        kk = ct.shape[0]
        cand, scores = _top(tuple(c.reshape(b, -1) for c in (
            torch.repeat_interleave(ct, 4),
            cxs[:, :, None].expand(kk, 2, 2).reshape(-1),
            cys[:, None, :].expand(kk, 2, 2).reshape(-1),
        )), s.reshape(b, -1), k)

    best = torch.argmax(scores, dim=1, keepdim=True)  # (B, 1)
    row_best, ox, oy = (torch.gather(c, 1, best)[:, 0] for c in cand)
    t_best = row_best.long() - torch.arange(b, device=device) * n_th
    offset = torch.stack([ox, oy], dim=-1).to(torch.float32) * resolution
    pose = Rigid2(translation=initial_poses.translation + offset,
                  angle=torch.gather(angles, 1, t_best[:, None])[:, 0])
    return torch.gather(scores, 1, best)[:, 0], pose


match_fast_2d_batched.score_sums = 0
