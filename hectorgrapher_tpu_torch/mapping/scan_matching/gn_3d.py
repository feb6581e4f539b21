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
z-segment tables. The evaluation at the accepted pose is carried to the
next iteration, as the JAX loop carries its gathered rows. The penalty's
Jacobian is analytic where the JAX loop takes jax.jacfwd:
d log(q0^-1 q exp(d)) / dd = Jr^-1, the inverse right Jacobian of SO(3).
Same LM rule as the JAX loop: accept a lower cost, lam *= 0.33 (floor
1e-10) else lam *= 4 (cap 1e6); stop once an accepted step gains at most
1e-6 of the cost or the step is at most 1e-7 (|x| + 1e-7).

match_gn_3d_packed refines the B lanes of one constraint round at once,
each a lane of the JAX package's vmapped while_loop (gn_3d.py :314-359):
per-lane pose, lambda, cost and carried blocks, one K3 launch per LM
iteration for all lanes (ct_scan_block_slots: lane b against the grids of
its submap lane_d[b]), batched 6 x 6 solves, and a per-lane accept; a lane
that is done freezes, and the loop syncs the host once per iteration, on
"all lanes done". So a lane's result is the serial match_gn_3d's, up to
the order of the batched solves' sums. prepare_gn_pack_3d is the
counterpart of the JAX function of that name: K3 reads the TSDF volumes
or probability fields in place, so the pack holds no z-segment tables,
only the D distinct submaps' prepared grids as K3's slot table
(grid_slots). All of a pack's submaps have one grid type and, for TSDF
grids, one storage dtype (f32, f16 or bf16: K3 reads half volumes in
place); grid_slots refuses a mix, and the pose graph sends such a round
to the serial path.
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
    clouds = (high_cloud.positions[None].contiguous(), high_cloud.mask[None].contiguous(),
              low_cloud.positions[None].contiguous(), low_cloud.mask[None].contiguous())
    eye = torch.eye(3, **f32)
    gparams = grid_params(high_grid, low_grid)

    def penalty(pose):
        trans = translation_weight * (pose.translation - target)
        return torch.cat([trans, rotation_weight * quat_to_axis_angle(quat_multiply(q0_inv, pose.rotation))])

    def grid_blocks(pose):
        """(J^T J (6, 6), J^T r (6,), cost) of both grids' residuals."""
        dpose7 = torch.zeros((1, 7, 18), **f32)
        dpose7[0, :3, :3] = eye
        dpose7[0, 3:, 3:6] = 0.5 * quat_left_matrix(pose.rotation)[:, 1:]  # d (q exp(d)) / dd at 0
        S, g, cost = ct_scan_block(high_grid, low_grid, *clouds, torch.cat([pose.translation, pose.rotation])[None],
                                   dpose7, s_hi[None], s_lo[None], gparams=gparams)
        return S[0, :6, :6], g[0, :6], cost[0]

    def cost_of(pose, blocks):
        pen = penalty(pose)
        return blocks[2] + 0.5 * torch.sum(pen * pen)

    pose = initial_pose
    blocks = grid_blocks(pose)
    cost = cost_of(pose, blocks)
    lam = torch.tensor(1e-4, **f32)
    free = (~fixed).to(torch.float32)
    for _ in range(num_iterations):
        r_pen = penalty(pose)
        j_pen = torch.zeros((6, 6), **f32)
        j_pen[:3, :3] = translation_weight * eye
        phi = quat_to_axis_angle(quat_multiply(q0_inv, pose.rotation))
        j_pen[3:, 3:] = rotation_weight * inverse_right_jacobian(phi)
        # Fixed coordinates are zero columns of J.
        jtj = (blocks[0] + j_pen.T @ j_pen) * free[:, None] * free[None, :]
        g = (blocks[1] + j_pen.T @ r_pen) * free
        damped = jtj + torch.diag(lam * torch.clamp(torch.diagonal(jtj), min=1e-12)) + 1e-12 * torch.eye(6, **f32)
        delta = torch.where(fixed, 0.0, -torch.linalg.solve(damped, g))
        pose_new = _retract(pose, delta)
        blocks_new = grid_blocks(pose_new)
        cost_new = cost_of(pose_new, blocks_new)
        accept = cost_new < cost
        lam = torch.where(accept, torch.clamp(lam * 0.33, min=1e-10), torch.clamp(lam * 4.0, max=1e6))
        x_norm = torch.sqrt(torch.sum(pose.translation**2) + 1.0)
        done = (accept & (cost - cost_new <= 1e-6 * cost)) | (
            torch.linalg.vector_norm(delta) <= 1e-7 * (x_norm + 1e-7))
        pose = Rigid3(*(torch.where(accept, b, a) for a, b in zip(pose, pose_new)))
        blocks = tuple(torch.where(accept, b, a) for a, b in zip(blocks, blocks_new))
        cost = torch.where(accept, cost_new, cost)
        if bool(done):  # the JAX while_loop's exit test; one host sync per iteration
            break
    return pose, cost


def prepare_gn_pack_3d(high_grids, low_grids) -> GridSlots:
    """The D distinct submaps of a packed refinement (high_grids[d],
    low_grids[d], one shape and one grid type each) as K3's slot table."""
    return grid_slots([prepare_grid_3d(g) for g in high_grids], [prepare_grid_3d(g) for g in low_grids])


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
    b = high_clouds.positions.shape[0]
    n_hi = torch.clamp(torch.sum(high_clouds.mask, dim=1), min=1).to(torch.float32)
    n_lo = torch.clamp(torch.sum(low_clouds.mask, dim=1), min=1).to(torch.float32)
    s_hi = occupied_space_weight_0 / torch.sqrt(n_hi)
    s_lo = occupied_space_weight_1 / torch.sqrt(n_lo)
    q0_inv = quat_conjugate(initial_poses.rotation)
    target = torch.as_tensor(target_translations, **f32)
    clouds = (high_clouds.positions.contiguous(), high_clouds.mask.contiguous(), low_clouds.positions.contiguous(),
              low_clouds.mask.contiguous())
    eye = torch.eye(3, **f32)
    lane_d = lane_d.to(device=device, dtype=torch.int32).contiguous()

    def penalty(pose):
        trans = translation_weight * (pose.translation - target)
        return torch.cat([trans, rotation_weight * quat_to_axis_angle(quat_multiply(q0_inv, pose.rotation))], dim=1)

    def grid_blocks(pose):
        """(J^T J (B, 6, 6), J^T r (B, 6), cost (B,)) of both grids' residuals."""
        dpose7 = torch.zeros((b, 7, 18), **f32)
        dpose7[:, :3, :3] = eye
        dpose7[:, 3:, 3:6] = 0.5 * quat_left_matrix(pose.rotation)[:, :, 1:]  # d (q exp(d)) / dd at 0
        S, g, cost = ct_scan_block_slots(pack, lane_d, *clouds, torch.cat([pose.translation, pose.rotation], dim=1),
                                         dpose7, s_hi, s_lo)
        return S[:, :6, :6], g[:, :6], cost

    def cost_of(pose, blocks):
        pen = penalty(pose)
        return blocks[2] + 0.5 * torch.sum(pen * pen, dim=1)

    def keep(accept, old, new):
        return tuple(torch.where(accept.reshape((b,) + (1,) * (a.dim() - 1)), n, a) for a, n in zip(old, new))

    pose = Rigid3(initial_poses.translation, initial_poses.rotation)
    blocks = grid_blocks(pose)
    cost = cost_of(pose, blocks)
    lam = torch.full((b,), 1e-4, **f32)
    done = torch.zeros(b, dtype=torch.bool, device=device)
    for _ in range(num_iterations):
        r_pen = penalty(pose)
        j_pen = torch.zeros((b, 6, 6), **f32)
        j_pen[:, :3, :3] = translation_weight * eye
        phi = quat_to_axis_angle(quat_multiply(q0_inv, pose.rotation))
        j_pen[:, 3:, 3:] = rotation_weight * inverse_right_jacobian(phi)
        j_pen_t = j_pen.transpose(1, 2)
        jtj = blocks[0] + j_pen_t @ j_pen
        g = blocks[1] + (j_pen_t @ r_pen[:, :, None])[:, :, 0]
        damped = (jtj + torch.diag_embed(lam[:, None] * torch.clamp(torch.diagonal(jtj, dim1=1, dim2=2), min=1e-12))
                  + 1e-12 * torch.eye(6, **f32))
        # solve_ex: linalg.solve's error check would read `info` back, a
        # second host sync per iteration; damped is positive definite.
        delta = -torch.linalg.solve_ex(damped, g)[0]
        pose_new = _retract(pose, delta)
        blocks_new = grid_blocks(pose_new)
        cost_new = cost_of(pose_new, blocks_new)
        accept = (cost_new < cost) & ~done  # a done lane freezes
        lam = torch.where(accept, torch.clamp(lam * 0.33, min=1e-10), torch.clamp(lam * 4.0, max=1e6))
        x_norm = torch.sqrt(torch.sum(pose.translation**2, dim=1) + 1.0)
        done = done | (accept & (cost - cost_new <= 1e-6 * cost)) | (
            torch.linalg.vector_norm(delta, dim=1) <= 1e-7 * (x_norm + 1e-7))
        pose = Rigid3(*keep(accept, pose, pose_new))
        blocks = keep(accept, blocks, blocks_new)
        cost = torch.where(accept, cost_new, cost)
        if bool(done.all()):  # one host sync per iteration
            break
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
    low_grids[b]); lanes that share a grid object share its slot."""
    slot_of, his, los, lane_d = {}, [], [], []
    for hg, lg in zip(high_grids, low_grids):
        key = (id(hg), id(lg))
        if key not in slot_of:
            slot_of[key] = len(his)
            his.append(hg)
            los.append(lg)
        lane_d.append(slot_of[key])
    lanes = torch.tensor(lane_d, dtype=torch.int32, device=high_clouds.positions.device)
    return match_gn_3d_packed(prepare_gn_pack_3d(his, los), lanes, high_clouds, low_clouds, initial_poses,
                              target_translations, occupied_space_weight_0, occupied_space_weight_1,
                              translation_weight, rotation_weight, num_iterations)
