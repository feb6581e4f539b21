"""Real-time correlative scan matching in 3D (counterpart of
hectorgrapher_tpu/mapping/scan_matching/correlative_3d.py; ref:
mapping/internal/3d/scan_matching/real_time_correlative_scan_matcher_3d.cc).

An exhaustive search over discretized (yaw, x, y, z) around the initial
estimate: every yaw of the window rotates the cloud about the initial
translation, every offset of the (2k + 1)^3 cube moves it, and each
candidate scores the mean of grid_match_scores at its points' cells,
times the translation / rotation delta penalty. The first maximum wins
(jnp.argmax's and torch.argmax's rule).

The JAX package reads the points' cells through a shifted-field table:
one row of (2k + 1)^3 values for every cell of the grid extended by k,
(n + 2k)^3 x (2k + 1)^3 floats (8.8 GB at the default 256^3 grid and
k = 2), and a last row of 0.1 for bases beyond it. Row b, column o is the
score field at b + o where that lies in the grid, else 0.1. So this
module gathers that value directly, one lookup per candidate point:
T x N x (2k + 1)^3 of them, 2.9 M at 23 yaws and 1024 points, and builds
no table. Plain torch: the search is an XLA fusion in the JAX package,
not a Pallas kernel.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from hectorgrapher_tpu_torch.mapping.grids import cell_index
from hectorgrapher_tpu_torch.mapping.scan_matching.fast_correlative_3d import grid_match_scores
from hectorgrapher_tpu_torch.sensor.types import PointCloud
from hectorgrapher_tpu_torch.transform.rigid import Rigid3, quat_from_yaw, quat_multiply, quat_rotate

UNKNOWN_SCORE = 0.1  # the score of a cell outside the grid (the table's pad)


class SearchWindow3D(NamedTuple):
    num_angles: int
    angle_step: float
    num_linear: int  # cells per axis


def make_search_window_3d(
    linear_search_window: float,
    angular_search_window: float,
    resolution: float,
    max_scan_range: float,
) -> SearchWindow3D:
    angle_step = math.acos(
        max(-1.0, min(1.0, 1.0 - resolution**2 / (2.0 * max(max_scan_range, resolution) ** 2)))
    )
    num_angles = int(math.ceil(angular_search_window / angle_step))
    num_linear = int(math.ceil(linear_search_window / resolution))
    return SearchWindow3D(num_angles=num_angles, angle_step=angle_step, num_linear=num_linear)


def correlative_scores_3d(
    grid,
    cloud: PointCloud,
    initial_pose: Rigid3,
    window: SearchWindow3D,
    translation_delta_cost_weight: float,
    rotation_delta_cost_weight: float,
):
    """Every candidate's penalized score (T, d, d, d), d = 2k + 1, with the
    yaws (T,) and the per-axis offsets (d,) in metres, all float32."""
    field = grid_match_scores(grid)
    dims = field.shape
    device = field.device
    res = grid.meta.resolution
    n_th = 2 * window.num_angles + 1
    thetas = (torch.arange(n_th, dtype=torch.float32, device=device) - window.num_angles) * window.angle_step
    k = window.num_linear
    d = 2 * k + 1

    pts, valid = cloud.positions, cloud.mask
    n_valid = torch.clamp(torch.sum(valid), min=1).to(torch.float32)
    t0, q0 = initial_pose.translation, initial_pose.rotation
    base = quat_rotate(q0[None, :], pts) + t0[None, :]
    rel = base - t0[None, :]
    rot = quat_rotate(quat_from_yaw(thetas)[:, None, :], rel[None, :, :]) + t0[None, None, :]
    base_idx = cell_index(grid.meta, rot).to(torch.int64)  # (T, N, 3)

    # Per axis: the cell of each offset, in the grid or not; then one gather
    # of the (T, N, d, d, d) candidate cells.
    steps = torch.arange(-k, k + 1, device=device)
    cells = [base_idx[..., a, None] + steps for a in range(3)]  # 3 x (T, N, d)
    inside = [(c >= 0) & (c < n) for c, n in zip(cells, dims)]
    cells = [torch.clamp(c, 0, n - 1) for c, n in zip(cells, dims)]
    flat = ((cells[0][..., :, None, None] * dims[1] + cells[1][..., None, :, None]) * dims[2]
            + cells[2][..., None, None, :])
    ok = inside[0][..., :, None, None] & inside[1][..., None, :, None] & inside[2][..., None, None, :]
    values = torch.where(ok, field.reshape(-1)[flat], UNKNOWN_SCORE)
    values = torch.where(valid[None, :, None, None, None], values, 0.0)
    scores = torch.sum(values, dim=1) / n_valid  # (T, d, d, d)

    offs = (torch.arange(d, dtype=torch.float32, device=device) - k) * res
    dist = torch.sqrt(offs[:, None, None] ** 2 + offs[None, :, None] ** 2 + offs[None, None, :] ** 2)
    penalty = torch.exp(-((dist[None] * translation_delta_cost_weight
                           + torch.abs(thetas)[:, None, None, None] * rotation_delta_cost_weight) ** 2))
    return scores * penalty, thetas, offs


def match_correlative_3d(
    grid,
    cloud: PointCloud,
    initial_pose: Rigid3,
    window: SearchWindow3D,
    translation_delta_cost_weight: float,
    rotation_delta_cost_weight: float,
) -> Tuple[torch.Tensor, Rigid3]:
    """Exhaustive dense search over yaw and (x, y, z) offsets (the
    reference searches rotations about the gravity-aligned z axis).
    Returns (best score, best pose), both on the grid's device."""
    scores, thetas, offs = correlative_scores_3d(grid, cloud, initial_pose, window, translation_delta_cost_weight,
                                                 rotation_delta_cost_weight)
    d = offs.shape[0]
    best = torch.argmax(scores.reshape(-1))
    ti, xi, yi, zi = best // d**3, (best // d**2) % d, (best // d) % d, best % d
    pose = Rigid3(
        translation=initial_pose.translation + torch.stack([offs[xi], offs[yi], offs[zi]]),
        rotation=quat_multiply(quat_from_yaw(thetas[ti]), initial_pose.rotation),
    )
    return scores.reshape(-1)[best], pose
