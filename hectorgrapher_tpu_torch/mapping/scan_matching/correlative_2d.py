"""Real-time correlative scan matching in 2D (counterpart of
hectorgrapher_tpu/mapping/scan_matching/correlative_2d.py; ref:
internal/2d/scan_matching/real_time_correlative_scan_matcher_2d.cc,
correlative_scan_matcher_2d.cc SearchParameters).

The full (theta, dx, dy) score volume is evaluated at once. Score of a
candidate = mean occupancy probability at the transformed hit cells,
down-weighted by exp(-(|t|*w_t + |theta|*w_r)^2) exactly as the
reference's candidate penalty. Out-of-map cells score the unknown-cell
probability 0.1 per CELL.

The angular step is chosen so the farthest scan point moves at most one
cell between adjacent angles, so the cell of any point differs by at most
+-HALF cells per axis between an angle and the middle angle of its group of
ANGLE_GROUP angles. One row of an 11x11 "wide patch" table, centered at the
middle angle's cell, serves the 7x7 score patches of all ANGLE_GROUP
angles. Every match goes through the two CUDA kernels of ops/:
correlative_prep_2d (K1: rotate, discretize, group deltas) and
correlative_scores_2d (K2: bucket the wide-patch rows by delta on the
tensor cores and sum the buckets into the score volume). Penalty and
argmax are plain torch.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from hectorgrapher_tpu_torch.mapping.grids import ProbabilityGrid, cell_index, ensure_f32_grid
from hectorgrapher_tpu_torch.ops.correlative_prep_2d import correlative_prep_2d
from hectorgrapher_tpu_torch.ops.correlative_scores_2d import correlative_scores_2d, row_stride
from hectorgrapher_tpu_torch.sensor.types import PointCloud
from hectorgrapher_tpu_torch.transform.rigid import Rigid2, rot2

# Number of adjacent angle candidates sharing one wide-patch row. Must be
# odd; HALF = ANGLE_GROUP // 2 is the max per-axis cell delta between a
# group member's cell and the group center's.
ANGLE_GROUP = 5

_UNKNOWN = 0.1  # probability reported for never-observed / out-of-map cells


class SearchWindow2D(NamedTuple):
    """Static search geometry."""

    num_angles: int
    angle_step: float
    num_linear: int  # cells per side: offsets in [-num_linear, num_linear]


def make_search_window(
    linear_search_window: float,
    angular_search_window: float,
    resolution: float,
    max_scan_range: float,
) -> SearchWindow2D:
    """(ref: correlative_scan_matcher_2d.cc SearchParameters ctor — angular
    step such that the farthest point moves at most one cell.)"""
    angle_step = math.acos(max(-1.0, min(1.0, 1.0 - resolution**2 / (2.0 * max(max_scan_range, resolution) ** 2))))
    num_angles = int(math.ceil(angular_search_window / angle_step))
    num_linear = int(math.ceil(linear_search_window / resolution))
    return SearchWindow2D(num_angles=num_angles, angle_step=angle_step, num_linear=num_linear)


def _wide_patch_table(prob, k: int, half: int, stride: int | None = None):
    """Shifted-copy table over the EXTENDED cell grid: (ex*ey + 1, stride)
    bf16, stride = pw*pw (the JAX package's layout) unless given.

    Row for extended cell e=(c+margin) holds the map value at every offset
    a in [-margin, margin]^2 from absolute cell c, lane (a_x+m)*pw + a_y+m,
    where margin m = k + half; cells outside the real grid read the
    unknown-cell probability. A final all-unknown row serves cells beyond
    the extended grid. Lanes past pw*pw are zero.
    """
    nx, ny = prob.shape
    m = k + half
    pw = 2 * m + 1
    stride = pw * pw if stride is None else stride
    padded = F.pad(prob, (2 * m, 2 * m, 2 * m, 2 * m), value=_UNKNOWN).to(torch.bfloat16)
    ex, ey = nx + 2 * m, ny + 2 * m
    table = torch.empty((ex * ey + 1, stride), dtype=torch.bfloat16, device=prob.device)
    # unfold gives [e_x, e_y, a, b] = padded[e_x + a, e_y + b] as a view.
    table[:-1, : pw * pw].view(ex, ey, pw, pw).copy_(padded.unfold(0, pw, 1).unfold(1, pw, 1))
    table[-1, : pw * pw] = _UNKNOWN
    table[:, pw * pw :] = 0
    return table


def _window_geometry(window: SearchWindow2D):
    """Static geometry shared by the per-match and batched matchers."""
    k = window.num_linear
    gsz = ANGLE_GROUP
    half = gsz // 2
    m = k + half
    pw = 2 * m + 1
    n_th = 2 * window.num_angles + 1
    n_groups = -(-n_th // gsz)
    return k, gsz, half, m, pw, n_th, n_groups


def _candidate_thetas(window: SearchWindow2D, device):
    """Angle offsets for all (padded) candidate slots. Padded slots repeat
    the last real angle, keeping every delta within the +-half bound."""
    _, gsz, _, _, _, n_th, n_groups = _window_geometry(window)
    slot = torch.clamp(torch.arange(n_groups * gsz, device=device), max=n_th - 1)
    return (slot.to(torch.float32) - window.num_angles) * window.angle_step


def prepare_correlative_table(grid: ProbabilityGrid, window: SearchWindow2D):
    """Wide-patch table for repeated matching against one grid version,
    its rows padded with zero lanes to row_stride(pw) (K2's layout, and at
    pw*pw <= 128 the 128-lane rows the TPU kernel gathers from). A uint16
    grid (a just-finished submap) is decoded first (correlative_2d.py
    :333-335)."""
    k, gsz, half, m, pw, *_ = _window_geometry(window)
    return _wide_patch_table(ensure_f32_grid(grid).probability(), k, half, row_stride(pw))


def prep_inputs(grid: ProbabilityGrid, clouds: PointCloud, initial_poses: Rigid2, window: SearchWindow2D):
    """K1's arguments for a batch of matches: (args, kwargs) such that
    correlative_prep_2d(*args, **kwargs) is the call the matcher makes."""
    k, gsz, half, m, pw, n_th, n_groups = _window_geometry(window)
    nx, ny = grid.shape
    b = clouds.mask.shape[0]
    thetas = _candidate_thetas(window, clouds.positions.device)
    angles = initial_poses.angle[:, None] + thetas[None, :]  # (B, T)
    params = torch.cat(
        [
            initial_poses.translation.to(torch.float32),
            grid.meta.min_corner.to(torch.float32)[None, :].expand(b, 2),
            grid.meta.resolution.to(torch.float32).reshape(1, 1).expand(b, 1),
            torch.zeros((b, 3), dtype=torch.float32, device=angles.device),
        ],
        dim=1,
    )
    pts = clouds.positions.to(torch.float32)
    args = (params, pts[..., 0].contiguous(), pts[..., 1].contiguous(), torch.cos(angles), torch.sin(angles))
    kwargs = dict(n_groups=n_groups, gsz=gsz, margin=m, ex=nx + 2 * m, ey=ny + 2 * m)
    return args, kwargs


def _penalty(window: SearchWindow2D, res, translation_delta_cost_weight, rotation_delta_cost_weight, device):
    """(dxy (d,), penalty (T, d, d)) (ref: real_time_correlative_scan_
    matcher_2d.cc:140-146)."""
    k = window.num_linear
    dxy = torch.arange(-k, k + 1, device=device).to(torch.float32) * res
    dist = torch.sqrt(dxy[:, None] ** 2 + dxy[None, :] ** 2)  # (Dx, Dy)
    thetas = _candidate_thetas(window, device)
    penalty = torch.exp(
        -(
            (dist[None, :, :] * translation_delta_cost_weight
             + torch.abs(thetas)[:, None, None] * rotation_delta_cost_weight)
            ** 2
        )
    )
    return dxy, penalty


def score_volume_batched(
    grid: ProbabilityGrid,
    clouds: PointCloud,
    initial_poses: Rigid2,
    window: SearchWindow2D,
    prepared_table=None,
):
    """Mean-probability score volume (B, T, d, d) of all (padded) candidate
    angles and offsets, without penalty, through the two kernels."""
    if prepared_table is None:
        prepared_table = prepare_correlative_table(grid, window)
    k, gsz, half, m, pw, n_th, n_groups = _window_geometry(window)
    args, kwargs = prep_inputs(grid, clouds, initial_poses, window)
    flat, delta_lin = correlative_prep_2d(*args, **kwargs)
    valid = clouds.mask
    n_valid = torch.clamp(torch.sum(valid, dim=1), min=1)
    return correlative_scores_2d(
        prepared_table, flat, delta_lin, valid.to(torch.float32).contiguous(), n_groups, gsz, pw, k
    ) / n_valid[:, None, None, None].to(torch.float32)


def match_correlative_2d_batched(
    grid: ProbabilityGrid,
    clouds: PointCloud,
    initial_poses: Rigid2,
    window: SearchWindow2D,
    translation_delta_cost_weight,
    rotation_delta_cost_weight,
    prepared_table=None,
):
    """Batched exhaustive search over B independent (cloud, pose) pairs.

    clouds: positions (B, N, 3), mask (B, N); initial_poses: (B, 2)/(B,).
    Returns (scores (B,), Rigid2 (B,)). Pass prepared_table (from
    prepare_correlative_table) to reuse it across calls on one grid."""
    k, gsz, half, m, pw, n_th, n_groups = _window_geometry(window)
    d = 2 * k + 1
    t_pad = n_groups * gsz
    device = clouds.positions.device
    b = clouds.mask.shape[0]
    scores = score_volume_batched(grid, clouds, initial_poses, window, prepared_table)

    dxy, penalty = _penalty(window, grid.meta.resolution, translation_delta_cost_weight, rotation_delta_cost_weight, device)
    scores = scores * penalty[None]
    # Padded angle slots duplicate real scores; exclude them from argmax.
    real = (torch.arange(t_pad, device=device) < n_th)[None, :, None, None]
    scores = torch.where(real, scores, -1.0)
    flat_scores = scores.reshape(b, -1)
    best = torch.argmax(flat_scores, dim=1)
    ti = torch.div(best, d * d, rounding_mode="floor")
    xi = torch.div(best % (d * d), d, rounding_mode="floor")
    yi = best % d
    angles = initial_poses.angle[:, None] + _candidate_thetas(window, device)[None, :]
    best_poses = Rigid2(
        translation=initial_poses.translation + torch.stack([dxy[xi], dxy[yi]], dim=-1),
        angle=torch.gather(angles, 1, ti[:, None])[:, 0],
    )
    return torch.gather(flat_scores, 1, best[:, None])[:, 0], best_poses


def match_correlative_2d(
    grid: ProbabilityGrid,
    cloud: PointCloud,
    initial_pose: Rigid2,
    window: SearchWindow2D,
    translation_delta_cost_weight,
    rotation_delta_cost_weight,
) -> Tuple[torch.Tensor, Rigid2]:
    """Exhaustive dense search around initial_pose: the B=1 call of
    match_correlative_2d_batched. cloud: points in the tracking frame (xy
    used). Returns (score, pose)."""
    clouds = PointCloud(positions=cloud.positions[None], mask=cloud.mask[None])
    poses = Rigid2(translation=initial_pose.translation[None], angle=initial_pose.angle.reshape(1))
    scores, best = match_correlative_2d_batched(
        grid, clouds, poses, window, translation_delta_cost_weight, rotation_delta_cost_weight
    )
    return scores[0], Rigid2(translation=best.translation[0], angle=best.angle[0])


def score_volume_dense(
    grid: ProbabilityGrid,
    cloud: PointCloud,
    initial_pose: Rigid2,
    window: SearchWindow2D,
):
    """Per-cell scoring of the full (theta, dx, dy) volume (no penalty),
    one candidate cell at a time: the oracle for the grouped matcher. A
    uint16 grid is decoded first (correlative_2d.py :272-274)."""
    grid = ensure_f32_grid(grid)
    prob = grid.probability()
    nx, ny = prob.shape
    device = prob.device
    n_th = 2 * window.num_angles + 1
    k = window.num_linear
    thetas = (torch.arange(n_th, device=device).to(torch.float32) - window.num_angles) * window.angle_step
    angles = initial_pose.angle + thetas
    pts = cloud.positions[:, :2]
    valid = cloud.mask
    n_valid = torch.clamp(torch.sum(valid), min=1)
    rotated = rot2(angles[:, None], pts[None, :, :]) + initial_pose.translation[None, None, :]
    base_idx = cell_index(grid.meta, rotated)  # (T, N, 2)
    out = torch.empty((n_th, 2 * k + 1, 2 * k + 1), dtype=torch.float32, device=device)
    for i, dx in enumerate(range(-k, k + 1)):
        for j, dy in enumerate(range(-k, k + 1)):
            cx = base_idx[..., 0] + dx
            cy = base_idx[..., 1] + dy
            ok = (cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny)
            v = prob[torch.clamp(cx, 0, nx - 1).long(), torch.clamp(cy, 0, ny - 1).long()]
            v = torch.where(ok, v, _UNKNOWN)
            out[:, i, j] = torch.sum(torch.where(valid[None, :], v, 0.0), dim=1) / n_valid
    return out  # (T, Dx, Dy)
