"""Gauss-Newton 3D scan-match refinement (counterpart of match_gn_3d in
hectorgrapher_tpu/mapping/scan_matching/gn_3d.py :88-248, unbatched; ref:
internal/3d/scan_matching/ceres_scan_matcher_3d.cc).

Residuals: the match value of each high-res point against the high-res
grid (scaled by occupied_space_weight_0 / sqrt(n_hi)) and of each low-res
point against the low-res grid (weight_1 / sqrt(n_lo)), plus the
translation and rotation delta penalties. The match value is the
weight-gated TSDF value, or 1 - p over an occupancy grid's probability
field (gn_3d.py :55-68); the grids go through prepare_grid_3d first, as
in the JAX package, which decodes uint16 grids and turns an occupancy
grid into its field (a no-op on grids already prepared, as the pose graph
passes them from Submap3D.prepared_grids). The grid terms are one scan
block of the CT window solve: kernel K3 (ops/ct_scan_block.py) gives
J^T J, J^T r and the cost of both grids' points for a single cloud whose
pose moves along the 6-dim tangent [dt, dtheta] of the right-multiplied
boxplus (t + dt, q exp(dtheta)); its plain version reads the grids through
value_and_dfrac_3d, the same eight cells and arithmetic as the JAX
z-segment tables. The penalty's Jacobian is analytic where the JAX loop
takes jax.jacfwd: d log(q0^-1 q exp(d)) / dd = Jr^-1, the inverse right
Jacobian of SO(3). The LM loop is solvers/gauss_newton.py lm_drive with
stop_on_host, the JAX loop's rule (lam from 1e-4, cap 1e6, tolerances
1e-6 and 1e-7): each evaluation, K3's blocks plus the penalty's, is
carried to the next iteration on accept, as the JAX loop carries its
gathered rows, so a solve makes 1 + (iterations run) K3 calls.

match_gn_3d_packed refines the B lanes of one constraint round at once,
each a lane of the JAX package's vmapped while_loop (gn_3d.py :314-359):
per-lane pose, lambda, cost and carried blocks (lm_drive's lanes), one K3
launch per LM iteration for all lanes (ct_scan_block_slots: lane b
against the grids of its submap lane_d[b]), batched 6 x 6 solves, and a
per-lane accept; a lane that is done freezes, and the loop syncs the host
once per iteration, on "all lanes done". So a lane's result is the
serial match_gn_3d's, up to the order of the batched solves' sums.
prepare_gn_pack_3d is the counterpart of the JAX function of that name:
K3 reads the TSDF volumes or probability fields in place, so the pack
holds no z-segment tables, only the D distinct submaps' prepared grids as
K3's slot table (grid_slots); window_slots builds it from per-lane grid
pairs, for match_gn_3d_batched and the CT window solve's batch. All of a
pack's submaps have one grid type and, for TSDF grids, one storage dtype
(f32, f16 or bf16: K3 reads half volumes in place); grid_slots refuses a
mix, and the pose graph sends such a round to the serial path.
"""

from __future__ import annotations

import torch

from hectorgrapher_tpu_torch.mapping.scan_matching.interpolated_grid import prepare_grid_3d
from hectorgrapher_tpu_torch.ops.ct_scan_block import (
    GridSlots,
    ct_scan_block,
    ct_scan_block_slots,
    grid_params,
    grid_slots,
)
from hectorgrapher_tpu_torch.solvers.gauss_newton import lm_drive
from hectorgrapher_tpu_torch.transform.rigid import (
    Rigid3,
    inverse_right_jacobian,
    quat_conjugate,
    quat_from_axis_angle,
    quat_left_matrix,
    quat_multiply,
    quat_normalize,
    quat_to_axis_angle,
)


def _retract(pose: Rigid3, delta) -> Rigid3:
    """pose boxplus delta (..., 6), batched over leading dims."""
    return Rigid3(
        translation=pose.translation + delta[..., :3],
        rotation=quat_normalize(quat_multiply(pose.rotation, quat_from_axis_angle(delta[..., 3:6]))),
    )


def _pose_terms(pose: Rigid3, q0_inv, target, translation_weight: float, rotation_weight: float):
    """Over pose's leading dims (...): the delta penalty's J^T J (..., 6,
    6), J^T r (..., 6) and 0.5 |r|^2 (...), r = [translation_weight (t -
    target), rotation_weight log(q0^-1 q)], J = diag(translation_weight I,
    rotation_weight Jr^-1(phi)); and K3's pose tangent dpose7 (..., 7, 18),
    d (t + dt, q exp(dtheta)) / d (dt, dtheta) at 0."""
    lead, f32 = pose.translation.shape[:-1], dict(dtype=torch.float32, device=pose.translation.device)
    eye = torch.eye(3, **f32)
    phi = quat_to_axis_angle(quat_multiply(q0_inv, pose.rotation))
    r = torch.cat([translation_weight * (pose.translation - target), rotation_weight * phi], dim=-1)
    j = torch.zeros(lead + (6, 6), **f32)
    j[..., :3, :3] = translation_weight * eye
    j[..., 3:, 3:] = rotation_weight * inverse_right_jacobian(phi)
    jt = j.transpose(-1, -2)
    dpose7 = torch.zeros(lead + (7, 18), **f32)
    dpose7[..., :3, :3] = eye
    dpose7[..., 3:, 3:6] = 0.5 * quat_left_matrix(pose.rotation)[..., 1:]
    return jt @ j, (jt @ r[..., None])[..., 0], 0.5 * torch.sum(r * r, dim=-1), dpose7


def match_gn_3d(
    high_grid,
    low_grid,
    high_cloud,
    low_cloud,
    initial_pose: Rigid3,
    target_translation,
    occupied_space_weight_0: float,
    occupied_space_weight_1: float,
    translation_weight: float,
    rotation_weight: float,
    num_iterations: int = 10,
    only_optimize_yaw: bool = False,
):
    """Refine initial_pose against the high/low-resolution grid pair (TSDF
    or occupancy, raw or prepared). Returns (pose, final cost)."""
    device = high_cloud.positions.device
    high_grid, low_grid = prepare_grid_3d(high_grid), prepare_grid_3d(low_grid)
    f32 = dict(dtype=torch.float32, device=device)
    n_hi = torch.clamp(torch.sum(high_cloud.mask), min=1).to(torch.float32)
    n_lo = torch.clamp(torch.sum(low_cloud.mask), min=1).to(torch.float32)
    s_hi = occupied_space_weight_0 / torch.sqrt(n_hi)
    s_lo = occupied_space_weight_1 / torch.sqrt(n_lo)
    q0_inv = quat_conjugate(initial_pose.rotation)
    target = torch.as_tensor(target_translation, **f32)
    fixed = torch.zeros(6, dtype=torch.bool, device=device)
    if only_optimize_yaw:  # (ref: ceres_scan_matcher_3d yaw-only parameterization)
        fixed[3:5] = True
    free = (~fixed).to(torch.float32)
    clouds = (high_cloud.positions[None].contiguous(), high_cloud.mask[None].contiguous(),
              low_cloud.positions[None].contiguous(), low_cloud.mask[None].contiguous())
    gparams = grid_params(high_grid, low_grid)

    def eval_fn(pose):
        jtj, jtr, pen_cost, dpose7 = _pose_terms(pose, q0_inv, target, translation_weight, rotation_weight)
        S, g, cost = ct_scan_block(high_grid, low_grid, *clouds, torch.cat([pose.translation, pose.rotation])[None],
                                   dpose7[None], s_hi[None], s_lo[None], gparams=gparams)
        return (S[0, :6, :6] + jtj, g[0, :6] + jtr), cost[0] + pen_cost

    def delta_of(quant, lam):
        # Fixed coordinates are zero columns of J.
        jtj = quant[0] * free[:, None] * free[None, :]
        g = quant[1] * free
        damped = jtj + torch.diag(lam * torch.clamp(torch.diagonal(jtj), min=1e-12)) + 1e-12 * torch.eye(6, **f32)
        return torch.where(fixed, 0.0, -torch.linalg.solve(damped, g))

    pose, cost, _ = lm_drive(eval_fn, delta_of, _retract, initial_pose, num_iterations, init_lambda=1e-4,
                             max_lambda=1e6, stop_on_host=True)
    return pose, cost


def prepare_gn_pack_3d(high_grids, low_grids) -> GridSlots:
    """The D distinct submaps of a packed refinement (high_grids[d],
    low_grids[d], one shape and one grid type each) as K3's slot table."""
    return grid_slots([prepare_grid_3d(g) for g in high_grids], [prepare_grid_3d(g) for g in low_grids])


def window_slots(high_grids, low_grids):
    """(GridSlots of the distinct grid pairs, slot (B,) int32): lane b's
    grids are the table's entry slot[b]. A pair of grid objects that
    several lanes share is one entry, prepared once (prepare_gn_pack_3d)."""
    pairs, slot = [], []
    for h, lo in zip(high_grids, low_grids):
        key = next((i for i, (ph, pl) in enumerate(pairs) if ph is h and pl is lo), None)
        if key is None:
            key = len(pairs)
            pairs.append((h, lo))
        slot.append(key)
    slots = prepare_gn_pack_3d([p[0] for p in pairs], [p[1] for p in pairs])
    return slots, torch.tensor(slot, dtype=torch.int32).to(slots.ptrs.device)


def match_gn_3d_packed(
    pack: GridSlots,
    lane_d,
    high_clouds,
    low_clouds,
    initial_poses: Rigid3,
    target_translations,
    occupied_space_weight_0: float,
    occupied_space_weight_1: float,
    translation_weight: float,
    rotation_weight: float,
    num_iterations: int = 10,
):
    """Refine B lanes at once, lane b against the grids of pack slot
    lane_d[b] ((B,) int32): high_clouds, low_clouds PointClouds (B, P, 3);
    initial_poses Rigid3 (B, 3), (B, 4); target_translations (B, 3).
    Returns (poses Rigid3 (B, 3), (B, 4), final costs (B,))."""
    device = high_clouds.positions.device
    f32 = dict(dtype=torch.float32, device=device)
    n_hi = torch.clamp(torch.sum(high_clouds.mask, dim=1), min=1).to(torch.float32)
    n_lo = torch.clamp(torch.sum(low_clouds.mask, dim=1), min=1).to(torch.float32)
    s_hi = occupied_space_weight_0 / torch.sqrt(n_hi)
    s_lo = occupied_space_weight_1 / torch.sqrt(n_lo)
    q0_inv = quat_conjugate(initial_poses.rotation)
    target = torch.as_tensor(target_translations, **f32)
    clouds = (high_clouds.positions.contiguous(), high_clouds.mask.contiguous(), low_clouds.positions.contiguous(),
              low_clouds.mask.contiguous())
    lane_d = lane_d.to(device=device, dtype=torch.int32).contiguous()

    def eval_fn(pose):
        jtj, jtr, pen_cost, dpose7 = _pose_terms(pose, q0_inv, target, translation_weight, rotation_weight)
        S, g, cost = ct_scan_block_slots(pack, lane_d, *clouds, torch.cat([pose.translation, pose.rotation], dim=1),
                                         dpose7, s_hi, s_lo)
        return (S[:, :6, :6] + jtj, g[:, :6] + jtr), cost + pen_cost

    def delta_of(quant, lam):
        jtj, g = quant
        damped = (jtj + torch.diag_embed(lam[:, None] * torch.clamp(torch.diagonal(jtj, dim1=1, dim2=2), min=1e-12))
                  + 1e-12 * torch.eye(6, **f32))
        # solve_ex: linalg.solve's error check would read `info` back, a
        # second host sync per iteration; damped is positive definite.
        return -torch.linalg.solve_ex(damped, g)[0]

    pose0 = Rigid3(initial_poses.translation, initial_poses.rotation)
    pose, cost, _ = lm_drive(eval_fn, delta_of, _retract, pose0, num_iterations, init_lambda=1e-4, max_lambda=1e6,
                             stop_on_host=True)
    return pose, cost


def match_gn_3d_batched(
    high_grids,
    low_grids,
    high_clouds,
    low_clouds,
    initial_poses: Rigid3,
    target_translations,
    occupied_space_weight_0: float,
    occupied_space_weight_1: float,
    translation_weight: float,
    rotation_weight: float,
    num_iterations: int = 10,
):
    """match_gn_3d_packed with one grid pair per lane (high_grids[b],
    low_grids[b]); lanes that share a grid pair share its slot."""
    return match_gn_3d_packed(*window_slots(high_grids, low_grids), high_clouds, low_clouds, initial_poses,
                              target_translations, occupied_space_weight_0, occupied_space_weight_1,
                              translation_weight, rotation_weight, num_iterations)
