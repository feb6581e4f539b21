"""Continuous-time sliding-window optimization (counterpart of
hectorgrapher_tpu/mapping/ct/window_solver.py; ref: mapping/internal/3d/
optimizing_local_trajectory_builder.cc MaybeOptimize:1114-1290 and the
cost functors under internal/3d/scan_matching/).

One LM solve of K control points (translation, rotation, velocity) against
the matching submap's hi- and lo-resolution grids, TSDF or occupancy
(is_tsdf; the JAX package picks prob_value_and_dfrac at is_tsdf=False):

  * scan-match residuals per cloud, the cloud pose slerp/lerp-interpolated
    between its two bracketing control points. The per-cloud blocks
    (S = J^T J, g = J^T r, cost) come from kernel K3
    (ops/ct_scan_block.py), one launch per assembly;
  * IMU residuals in the reference's live preintegration form, and
    odometry relative-pose residuals with adaptive weights, per control
    point pair;
  * every Jacobian of a cloud pose or a pair residual on the 18-dim pair
    tangent in closed form (the chain rule jax.jacfwd applies): on the
    card kernel K6 (ops/ct_pair_block.py), one launch each for the cloud
    poses and the pair residuals of an assembly; on the CPU, and for the
    DIRECT IMU term, their eager twins cloud_poses_plain and
    pair_residuals_plain;
  * the first control point frozen; the quaternion manifold through the
    retraction.

Every block touches two control points, so its Jacobian lives on an
18-dim local tangent; a one-hot projection E assembles the K*9-dim normal
equations with matmuls, in a fixed order (no scatter-add atomics: the LM
accept test compares costs).

The grids are prepared once per solve (prepare_grid_3d, window_solver.py
:667-668): an occupancy grid becomes its probability field, which K3's
probability mode reads; a TSDF grid stays as it is stored, f32 or half
(grid_storage_dtype "float16" / "bfloat16"), and K3 reads its volumes
in place, so no solve makes an f32 copy of them. A caller that holds
prepared grids (Submap3D.prepared_grids) passes them as they are.

Per-point unwarping (per_point=True, window_solver.py :366-462): every
point is a scalar residual on its own control-point pair at its own time;
the point bracket comes from per_point_brackets once per solve, and K3's
per-point mode (ct_scan_block_points) turns the state into the K - 1 pair
blocks, one launch per assembly. The DIRECT IMU term (direct=
DirectImuData, :109-138, :529-537) re-integrates the raw IMU samples from
the start state inside the pair residual, its Jacobian in closed form
through the M sub-steps.

solve_ct_window_batched solves B windows at once (:729-764, the
multi-robot server's operating point): one slotted K3 launch per LM
iteration for all B windows (grid_slots: each window's own grid pair),
the pair blocks of all B * (K - 1) pairs at once, one batched solve of the
B damped systems, and per-window LM state (lm_drive with a (B,) cost:
each window keeps its own damping, accept and done flags, as jax.vmap of
the JAX package's while_loop does). unwarp_and_accumulate (:767-788) carries
marginalized clouds into the optimized pose's frame.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hectorgrapher_tpu_torch.mapping.scan_matching.gn_3d import window_slots
from hectorgrapher_tpu_torch.mapping.scan_matching.interpolated_grid import PreparedProb3D, prepare_grid_3d
from hectorgrapher_tpu_torch.ops.ct_pair_block import ct_cloud_poses, ct_pair_residuals
from hectorgrapher_tpu_torch.ops.ct_scan_block import (
    ct_scan_block,
    ct_scan_block_points,
    ct_scan_block_points_slots,
    ct_scan_block_slots,
    grid_params,
    point_plan,
)
from hectorgrapher_tpu_torch.solvers.gauss_newton import lm_drive
from hectorgrapher_tpu_torch.transform.rigid import (
    Rigid3,
    cross,
    quat_conjugate,
    quat_from_axis_angle,
    quat_multiply,
    quat_normalize,
    quat_rotate,
    quat_slerp,
)


class CtState(NamedTuple):
    """Batched control-point states (ref: internal/3d/state.h State)."""

    translation: torch.Tensor  # (K, 3)
    rotation: torch.Tensor  # (K, 4) wxyz
    velocity: torch.Tensor  # (K, 3)


class CtProblem(NamedTuple):
    """Static-shape window problem; tensors on one device, masks for validity."""

    # Control points
    cp_mask: torch.Tensor  # (K,) bool
    cp_times: torch.Tensor  # (K,) f32, window-relative
    # Clouds
    cloud_mask: torch.Tensor  # (C,) bool
    cloud_prev: torch.Tensor  # (C,) int — bracketing CP indices
    cloud_next: torch.Tensor  # (C,)
    cloud_factor: torch.Tensor  # (C,) f32 interpolation factor in [0, 1]
    cloud_time: torch.Tensor  # (C,) f32, window-relative scan end times
    hi_points: torch.Tensor  # (C, P, 3) tracking-frame points
    hi_mask: torch.Tensor  # (C, P)
    hi_times: torch.Tensor  # (C, P) per-point relative times (<= 0)
    lo_points: torch.Tensor  # (C, Pl, 3)
    lo_mask: torch.Tensor  # (C, Pl)
    lo_times: torch.Tensor  # (C, Pl)
    # IMU per consecutive CP pair i-1 -> i (index i-1 in (K-1,) tensors)
    pair_mask: torch.Tensor  # (K-1,) bool
    pair_dt: torch.Tensor  # (K-1,)
    imu_delta_rotation: torch.Tensor  # (K-1, 4) gyro-preintegrated
    imu_delta_velocity: torch.Tensor  # (K-1, 3) (full form; unused by the live form)
    imu_delta_translation: torch.Tensor  # (K-1, 3)
    # Odometry per pair
    odom_mask: torch.Tensor  # (K-1,) bool
    odom_delta_translation: torch.Tensor  # (K-1, 3), prev^-1 * cur
    odom_delta_rotation: torch.Tensor  # (K-1, 4)
    odom_translation_weight: torch.Tensor  # (K-1,)
    odom_rotation_weight: torch.Tensor  # (K-1,)


class CtWeights(NamedTuple):
    high_resolution_grid_weight: torch.Tensor
    low_resolution_grid_weight: torch.Tensor
    translation_weight: torch.Tensor
    velocity_weight: torch.Tensor
    rotation_weight: torch.Tensor


class DirectImuData(NamedTuple):
    """Raw (calibrated) IMU samples per control point pair for the DIRECT
    cost term (ref: prediction_direct_imu_integration_cost_functor.h),
    resampled on the host onto M uniform sub-steps (zero-order hold);
    masked pairs carry dt == 0. A batched solve gives each leaf a leading
    window axis."""

    dt: torch.Tensor  # (K-1, M) sub-step durations, 0 where inactive
    gyro: torch.Tensor  # (K-1, M, 3) calibrated angular velocity
    accel: torch.Tensor  # (K-1, M, 3) calibrated linear acceleration
    gravity: torch.Tensor  # () m/s^2 (a batch: (B,))


def interpolate_pose(state: CtState, prev_idx, next_idx, factor) -> Rigid3:
    """Pose at `factor` between two control points, batched."""
    t0 = state.translation[prev_idx]
    t1 = state.translation[next_idx]
    return Rigid3(
        translation=t0 + factor[..., None] * (t1 - t0),
        rotation=quat_slerp(state.rotation[prev_idx], state.rotation[next_idx], factor),
    )


def _rpy_of_quat(q):
    """Roll/pitch/yaw residual components (ref: transform.h GetRoll/
    GetPitch/GetYaw applied to the error pose)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    roll = torch.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    pitch = torch.arcsin(torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return torch.stack([roll, pitch, yaw], dim=-1)


def ct_retract(state: CtState, delta) -> CtState:
    """Tangent (K*9,) -> state: [dt(3), dtheta(3), dv(3)] per control point
    (a batch of windows: (B, K*9) -> (B, K, ...))."""
    d = delta.reshape(state.translation.shape[:-1] + (9,))
    return CtState(
        translation=state.translation + d[..., 0:3],
        rotation=quat_normalize(quat_multiply(state.rotation, quat_from_axis_angle(d[..., 3:6]))),
        velocity=state.velocity + d[..., 6:9],
    )


def _pair_index(prev_idx, next_idx):
    """(B, 18) tangent indices of each block's two control points."""
    nine = torch.arange(9, device=prev_idx.device)
    return torch.cat([prev_idx[:, None] * 9 + nine, next_idx[:, None] * 9 + nine], dim=1)


def per_point_brackets(problem: CtProblem, times):
    """(prev, next, factor) of every point: times (C, P) relative point
    times, absolute = cloud_time + relative; the bracket from a search over
    the control-point times, masked ones at +inf, clipped to [1, K-1]; the
    factor clipped to [0, 1] and 0 where it is not finite
    (window_solver.py :164-183). A batch of windows: (B, C, P)."""
    k = problem.cp_times.shape[-1]
    cp_t = torch.where(problem.cp_mask.to(torch.bool), problem.cp_times, torch.inf)
    abs_t = problem.cloud_time[..., None] + times
    lead = cp_t.shape[:-1]
    nxt = torch.searchsorted(cp_t.contiguous(), abs_t.reshape(lead + (-1,)).contiguous(), right=True)
    nxt = torch.clamp(nxt, 1, k - 1).reshape(abs_t.shape)
    prv = nxt - 1
    flat = cp_t.reshape(lead + (1, -1)).expand(abs_t.shape[:-1] + (k,))
    t0, t1 = torch.gather(flat, -1, prv), torch.gather(flat, -1, nxt)
    factor = torch.clamp((abs_t - t0) / torch.clamp(t1 - t0, min=1e-9), 0.0, 1.0)
    return prv, nxt, torch.where(torch.isfinite(factor), factor, 0.0)


def _take(x, idx):
    """Rows idx of x per window: x (K, n), idx (C,) -> (C, n); a batch x (B,
    K, n), idx (B, C) -> (B, C, n)."""
    if idx.dim() == 1:
        return x[idx]
    off = torch.arange(idx.shape[0], device=idx.device)[:, None] * x.shape[-2]
    return x.reshape(-1, x.shape[-1])[idx + off]


# ---------------------------------------------------------------------------
# Forward-mode Jacobians on the 18-dim pair tangent, in closed form
# ---------------------------------------------------------------------------
#
# The JAX package takes these Jacobians with jax.jacfwd (window_solver.py
# :488 and :566). Here each value carries its tangent, a (..., 18, n)
# tensor for an (..., n) value: the same chain rule jacfwd applies, op by
# op, as batched tensor ops (torch.func.jacfwd costs ~100x more host time
# per assembly, and the solve is host-bound). Values are computed as the
# JAX source computes them at a zero tangent. These eager chains are the
# CPU path and kernel K6's twins: on the card, cloud_poses and
# pair_residuals launch K6 (csrc/ct_pair_block.cu) instead.


def _unit_tangent(like, col: int, n: int = 3):
    """(..., 18, n) tangent of an (..., n) value that moves one for one
    with the pair tangent's columns col..col+n."""
    t = torch.zeros(like.shape[:-1] + (18, n), dtype=like.dtype, device=like.device)
    t[..., col:col + n, :] = torch.eye(n, dtype=like.dtype, device=like.device)
    return t


def _jsum(x, tx):
    """Tangent of sum(x * y) pieces: (..., n) x (..., 18, n) -> (..., 18)."""
    return torch.sum(x[..., None, :] * tx, dim=-1)


def _jnormalize(x, tx):
    """x / |x| and its tangent: (dx - y (y . dx)) / |x|."""
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    y = x / n
    return y, (tx - y[..., None, :] * _jsum(y, tx)[..., None]) / n[..., None]


def _jconj(q, tq):
    return quat_conjugate(q), quat_conjugate(tq)


def _jmul(a, ta, b, tb):
    """Hamilton product with its tangent; a None tangent is a constant."""
    t = 0.0
    if ta is not None:
        t = quat_multiply(ta, b[..., None, :])
    if tb is not None:
        t = t + quat_multiply(a[..., None, :], tb)
    return quat_multiply(a, b), t


def _jrotate(q, tq, v, tv):
    """quat_rotate (the 15-mul form) with its tangent."""
    u, w = q[..., 1:], q[..., :1]
    du, dw = tq[..., 1:], tq[..., :1]
    uv = cross(u, v)
    duv = cross(du, v[..., None, :]) + cross(u[..., None, :], tv)
    uuv = cross(u, uv)
    duuv = cross(du, uv[..., None, :]) + cross(u[..., None, :], duv)
    value = v + 2.0 * (w * uv + uuv)
    return value, tv + 2.0 * (dw * uv[..., None, :] + w[..., None, :] * duv + duuv)


def _retract_rotation(q, col: int):
    """normalize(q * exp(d)) at d = 0 with its tangent on the pair
    tangent's columns col..col+3: exp(d) moves as [0, d / 2] there (the
    Taylor branch of quat_from_axis_angle)."""
    x = quat_multiply(q, quat_from_axis_angle(torch.zeros_like(q[..., 1:])))
    half = torch.nn.functional.pad(0.5 * _unit_tangent(q[..., 1:], col), (1, 0))  # d exp(d)/dd = [0, I/2]
    return _jnormalize(x, quat_multiply(q[..., None, :], half))


def _jslerp(a, ta, b, tb, f):
    """quat_slerp with its tangent (f constant). In the linear branch the
    weights are constants; in the slerp branch theta > 0, so both clamps
    of the cosine pass its tangent."""
    f = f[..., None]
    dot = torch.sum(a * b, dim=-1, keepdim=True)
    tdot = _jsum(a, tb) + _jsum(b, ta)
    neg = dot < 0
    b = torch.where(neg, -b, b)
    tb = torch.where(neg[..., None], -tb, tb)
    tdot = torch.where(neg, -tdot, tdot)
    c = torch.clamp(torch.clamp(torch.abs(dot), -1.0, 1.0), 0.0, 1.0)
    theta = torch.arccos(c)
    s = torch.sin(theta)
    lerp = s < 1e-6
    one = torch.ones_like(s)
    denom = torch.where(lerp, one, s)
    dtheta = torch.where(lerp, 0.0, -tdot / torch.sqrt(torch.where(lerp, one, 1.0 - c * c)))
    ds = torch.cos(theta) * dtheta
    ua, ub = (1.0 - f) * theta, f * theta
    wa = torch.where(lerp, 1.0 - f, torch.sin(ua) / denom)
    wb = torch.where(lerp, f, torch.sin(ub) / denom)
    dwa = torch.where(lerp, 0.0, torch.cos(ua) * ((1.0 - f) * dtheta) / denom - torch.sin(ua) * ds / (denom * denom))
    dwb = torch.where(lerp, 0.0, torch.cos(ub) * (f * dtheta) / denom - torch.sin(ub) * ds / (denom * denom))
    x = wa * a + wb * b
    tx = dwa[..., None] * a[..., None, :] + wa[..., None] * ta + dwb[..., None] * b[..., None, :] + wb[..., None] * tb
    return _jnormalize(x, tx)


def _datan2(y, ty, x, tx):
    """Tangent of atan2(y, x)."""
    return (x * ty - y * tx) / (x * x + y * y)


def _jrpy(q, tq):
    """_rpy_of_quat with its tangent (the pitch clamp passes it inside
    [-1, 1])."""
    w, x, y, z = q[..., 0:1], q[..., 1:2], q[..., 2:3], q[..., 3:4]
    dw, dx, dy, dz = tq[..., 0], tq[..., 1], tq[..., 2], tq[..., 3]
    d_roll = _datan2(2.0 * (w * x + y * z), 2.0 * (dw * x + w * dx + dy * z + y * dz),
                     1.0 - 2.0 * (x * x + y * y), -2.0 * (2.0 * x * dx + 2.0 * y * dy))
    sp = 2.0 * (w * y - z * x)
    d_pitch = 2.0 * (dw * y + w * dy - dz * x - z * dx) / torch.sqrt(torch.clamp(1.0 - sp * sp, min=1e-30))
    d_yaw = _datan2(2.0 * (w * z + x * y), 2.0 * (dw * z + w * dz + dx * y + x * dy),
                    1.0 - 2.0 * (y * y + z * z), -2.0 * (2.0 * y * dy + 2.0 * z * dz))
    return _rpy_of_quat(q), torch.stack([d_roll, d_pitch, d_yaw], dim=-1)


def cloud_poses_plain(state: CtState, problem: CtProblem):
    """(pose7 (C, 7), dpose7 (C, 7, 18)): each cloud's interpolated pose
    [t, q] after retracting its two control points by a zero pair tangent
    (window_solver.py scan_block pose_of, :479-488), and its Jacobian. A
    batch of windows gives (B, C, 7) and (B, C, 7, 18). The eager twin of
    kernel K6 (ops/ct_pair_block.py ct_cloud_poses)."""
    p, n, f = problem.cloud_prev, problem.cloud_next, problem.cloud_factor
    tp, tn = _take(state.translation, p), _take(state.translation, n)
    q0, tq0 = _retract_rotation(_take(state.rotation, p), 3)
    q1, tq1 = _retract_rotation(_take(state.rotation, n), 12)
    pose_t = tp + f[..., None] * (tn - tp)
    dpose_t = (1.0 - f)[..., None, None] * _unit_tangent(tp, 0) + f[..., None, None] * _unit_tangent(tn, 9)
    pose_q, dpose_q = _jnormalize(*_jslerp(q0, tq0, q1, tq1, f))
    return torch.cat([pose_t, pose_q], dim=-1), torch.cat([dpose_t, dpose_q], dim=-1).transpose(-1, -2)


def _integrate_direct(t, tt, q, tq, v, tv, direct: DirectImuData):
    """_integrate_direct (window_solver.py :123-138) with tangents: Euler /
    zero-order hold through the M sub-steps, q renormalized after every
    step (a padding step, dt == 0, only renormalizes q), gravity along +z."""
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32, device=t.device)
    g_vec = direct.gravity.reshape(direct.gravity.shape + (1, 1)) * ez
    steps = quat_from_axis_angle(direct.gyro * direct.dt[..., None])  # (..., K-1, M, 4), state-free
    still = torch.zeros_like(tt)
    for m in range(direct.dt.shape[-1]):
        dt = direct.dt[..., m, None]
        q, tq = _jnormalize(*_jmul(q, tq, steps[..., m, :], None))
        rot, trot = _jrotate(q, tq, direct.accel[..., m, :], still)
        v = v + (rot - g_vec) * dt
        tv = tv + trot * dt[..., None]
        t = t + v * dt
        tt = tt + tv * dt[..., None]
    return t, tt, q, tq, v, tv


def pair_residuals_plain(state: CtState, problem: CtProblem, weights: CtWeights, direct=None):
    """(r (K-1, 15), J (K-1, 15, 18)): the IMU (live preintegration form,
    or with `direct` the DIRECT term) and odometry residuals of each
    control point pair and their Jacobian on the pair tangent
    (window_solver.py pair_block :515-577). A batch of windows gives (B,
    K-1, 15) and (B, K-1, 15, 18). Without `direct`, the eager twin of
    kernel K6 (ops/ct_pair_block.py ct_pair_residuals)."""
    ta, tb = state.translation[..., :-1, :], state.translation[..., 1:, :]
    va, vb = state.velocity[..., :-1, :], state.velocity[..., 1:, :]
    dt = problem.pair_dt[..., None]
    m_imu = problem.pair_mask.to(torch.float32)[..., None]
    m_odom = problem.odom_mask.to(torch.float32)[..., None]
    q0, tq0 = _retract_rotation(state.rotation[..., :-1, :], 3)
    q1, tq1 = _retract_rotation(state.rotation[..., 1:, :], 12)
    dt0, dt1 = _unit_tangent(ta, 0), _unit_tangent(tb, 9)
    dv0, dv1 = _unit_tangent(va, 6), _unit_tangent(vb, 15)

    if direct is not None:
        # DIRECT: the prediction integrates the raw IMU from the START
        # state, so its Jacobian runs through every sub-step.
        pt, d_pt, pq, d_pq, pv, d_pv = _integrate_direct(ta, dt0, q0, tq0, va, dv0, direct)
        translation_error, d_translation = tb - pt, dt1 - d_pt
        velocity_error, d_velocity = vb - pv, dv1 - d_pv
        err_q, d_err_q = _jmul(*_jconj(q1, tq1), pq, d_pq)
    else:
        translation_error = tb - ta - dt * va
        d_translation = dt1 - dt0 - dt[..., None] * dv0
        velocity_error, d_velocity = vb - va, dv1 - dv0
        err_q, d_err_q = _jmul(*_jmul(*_jconj(q1, tq1), q0, tq0), problem.imu_delta_rotation, None)
    imu_r = torch.cat([weights.translation_weight * translation_error, weights.velocity_weight * velocity_error,
                       weights.rotation_weight * err_q[..., 1:]], dim=-1) * m_imu
    imu_j = torch.cat([weights.translation_weight * d_translation, weights.velocity_weight * d_velocity,
                       weights.rotation_weight * d_err_q[..., 1:]], dim=-1) * m_imu[..., None]

    rel_q, d_rel_q = _jmul(*_jconj(q0, tq0), q1, tq1)
    rel_t, d_rel_t = _jrotate(*_jconj(q0, tq0), tb - ta, dt1 - dt0)
    oerr_q, d_oerr_q = _jmul(*_jconj(rel_q, d_rel_q), problem.odom_delta_rotation, None)
    oerr_t, d_oerr_t = _jrotate(*_jconj(rel_q, d_rel_q), problem.odom_delta_translation - rel_t, -d_rel_t)
    rpy, d_rpy = _jrpy(oerr_q, d_oerr_q)
    wt = problem.odom_translation_weight[..., None]
    wr = problem.odom_rotation_weight[..., None]
    odom_r = torch.cat([wt * oerr_t, wr * rpy], dim=-1) * m_odom
    odom_j = torch.cat([wt[..., None] * d_oerr_t, wr[..., None] * d_rpy], dim=-1) * m_odom[..., None]
    return torch.cat([imu_r, odom_r], dim=-1), torch.cat([imu_j, odom_j], dim=-1).transpose(-1, -2)


def cloud_poses(state: CtState, problem: CtProblem):
    """cloud_poses_plain's (pose7, dpose7): CUDA tensors launch kernel K6
    (counted in cloud_poses.launches), CPU tensors run the eager twin."""
    device = state.translation.device
    if device.type == "cuda":
        out = ct_cloud_poses(state, problem)
        cloud_poses.launches += 1
        return out
    if device.type != "cpu":
        raise ValueError(f"cloud_poses: unsupported device {device}")
    return cloud_poses_plain(state, problem)


cloud_poses.launches = 0


def pair_residuals(state: CtState, problem: CtProblem, weights: CtWeights, direct=None):
    """pair_residuals_plain's (r, J): CUDA tensors launch kernel K6 in the
    preintegration form (counted in pair_residuals.launches); the DIRECT
    term (`direct` given) runs the eager twin, on the card too (counted in
    pair_residuals.eager_on_card), as CPU tensors do."""
    device = state.translation.device
    if device.type == "cuda":
        if direct is None:
            out = ct_pair_residuals(state, problem, weights)
            pair_residuals.launches += 1
            return out
        pair_residuals.eager_on_card += 1
    elif device.type != "cpu":
        raise ValueError(f"pair_residuals: unsupported device {device}")
    return pair_residuals_plain(state, problem, weights, direct)


pair_residuals.launches = pair_residuals.eager_on_card = 0


def _scan_scales(problem: CtProblem, weights: CtWeights):
    """Per-cloud residual scales (hi, lo): grid weight / sqrt(points), 0 for
    masked clouds (window_solver.py :419-420)."""
    n_hi = torch.clamp(torch.sum(problem.hi_mask, dim=-1), min=1).to(torch.float32)
    n_lo = torch.clamp(torch.sum(problem.lo_mask, dim=-1), min=1).to(torch.float32)
    cloud_mask = problem.cloud_mask.to(torch.float32)
    return ((weights.high_resolution_grid_weight / torch.sqrt(n_hi) * cloud_mask).contiguous(),
            (weights.low_resolution_grid_weight / torch.sqrt(n_lo) * cloud_mask).contiguous())


def problem_plan(problem: CtProblem, weights: CtWeights):
    """K3's per-point plan of a window (or, with a leading window axis, of
    a batch): every point's bracket and factor (per_point_brackets) and its
    scale where masked in, sorted by pair. Once per solve."""
    k = problem.cp_times.shape[-1]
    b = problem.cp_times.shape[0] if problem.cp_times.dim() == 2 else 1
    hi_scale, lo_scale = _scan_scales(problem, weights)
    parts = []
    for pts, mask, times, scale in ((problem.hi_points, problem.hi_mask, problem.hi_times, hi_scale),
                                    (problem.lo_points, problem.lo_mask, problem.lo_times, lo_scale)):
        prv, _, f = per_point_brackets(problem, times)
        sm = torch.where(mask.to(torch.bool), scale[..., None], 0.0)
        parts += [pts.reshape(b, -1, 3), prv.reshape(b, -1), f.reshape(b, -1), sm.reshape(b, -1)]
    return point_plan(*parts, k)


def make_ct_block_families(high_grid, low_grid, problem: CtProblem, weights: CtWeights, is_tsdf: bool,
                           direct=None, per_point: bool = False, slots=None):
    """(scan_block, pair_block): state -> a block family.

    scan_block returns pre-reduced blocks from kernel K3: per cloud (S (C,
    18, 18), g (C, 18), cost, idx (C, 18)), or with per_point per control
    point pair (S (K-1, 18, 18), g (K-1, 18), cost, idx (K-1, 18)) from
    K3's per-point mode; pair_block returns raw blocks (J (K-1, 15, 18), r
    (K-1, 15), idx (K-1, 18)).

    B windows: slots = window_slots(...) in place of the grid pair (then
    None, None), and every leaf of problem, direct and the state with a
    leading window axis; one slotted K3 launch serves all B windows, and
    every output gains the leading B (the cost is then (B,))."""
    lead = problem.cp_mask.shape[:-1]
    k = problem.cp_mask.shape[-1]
    pairs = torch.arange(k - 1, device=problem.pair_mask.device)
    pair_idx = _pair_index(pairs, pairs + 1).expand(lead + (k - 1, 18))
    if slots is None:
        high_grid, low_grid = prepare_grid_3d(high_grid), prepare_grid_3d(low_grid)
        if is_tsdf == isinstance(high_grid, PreparedProb3D):
            raise ValueError(f"is_tsdf={is_tsdf} with a {type(high_grid).__name__} grid")
        gparams = grid_params(high_grid, low_grid)
    else:
        table, slot = slots
        if is_tsdf == table.prob:
            raise ValueError(f"is_tsdf={is_tsdf} with {'occupancy' if table.prob else 'TSDF'} grids")

    def blocks(S, g, cost, idx):
        """The kernel's flat outputs with the windows' leading axis."""
        return (S.reshape(lead + (-1, 18, 18)), g.reshape(lead + (-1, 18)),
                torch.sum(cost.reshape(lead + (-1,)), dim=-1), idx)

    if per_point:
        plan = problem_plan(problem, weights)  # brackets and factors once per solve

        def scan_block(state: CtState):
            cp7 = torch.cat([state.translation, state.rotation], dim=-1).reshape(-1, 7)
            if slots is None:
                out = ct_scan_block_points(high_grid, low_grid, plan, cp7, gparams=gparams)
            else:
                out = ct_scan_block_points_slots(table, slot, plan, cp7)
            return blocks(*out, pair_idx)
    else:
        def flat(x):
            """(..., C, ...) -> (B*C, ...), contiguous."""
            return x.reshape((-1,) + x.shape[len(lead) + 1:]).contiguous()

        hi_scale, lo_scale = _scan_scales(problem, weights)
        clouds = (flat(problem.hi_points), flat(problem.hi_mask.to(torch.bool)), flat(problem.lo_points),
                  flat(problem.lo_mask.to(torch.bool)))
        scales = (flat(hi_scale), flat(lo_scale))
        scan_idx = _pair_index(problem.cloud_prev.long().reshape(-1),
                               problem.cloud_next.long().reshape(-1)).reshape(lead + (-1, 18))
        if slots is not None:
            cloud_slot = torch.repeat_interleave(slot, problem.cloud_mask.shape[-1])

        def scan_block(state: CtState):
            pose7, dpose7 = cloud_poses(state, problem)
            pose7, dpose7 = flat(pose7), flat(dpose7)
            if slots is None:
                out = ct_scan_block(high_grid, low_grid, *clouds, pose7, dpose7, *scales, gparams=gparams)
            else:
                out = ct_scan_block_slots(table, cloud_slot, *clouds, pose7, dpose7, *scales)
            return blocks(*out, scan_idx)

    def pair_block(state: CtState):
        r, J = pair_residuals(state, problem, weights, direct)
        return J, r, pair_idx

    return scan_block, pair_block


def _make_ct_assemble(high_grid, low_grid, problem: CtProblem, weights: CtWeights, is_tsdf: bool, D: int,
                      direct=None, per_point: bool = False, slots=None):
    """state -> (JtJ (D, D), g (D,), cost): the window's dense normal
    equations (window_solver.py _make_ct_assemble :582-620); with slots,
    B windows' (JtJ (B, D, D), g (B, D), cost (B,)) (make_ct_block_families)."""
    scan_block, pair_block = make_ct_block_families(
        high_grid, low_grid, problem, weights, is_tsdf, direct=direct, per_point=per_point, slots=slots
    )
    dims = torch.arange(D, device=problem.cp_mask.device)
    E = None  # (..., blocks*18, D) one-hot of every block's tangent indices, scan blocks then pair blocks

    def assemble(state: CtState):
        nonlocal E
        S_scan, g_scan, cost_scan, scan_idx = scan_block(state)
        J, r, pair_idx = pair_block(state)
        S = torch.cat([S_scan, torch.einsum("...cri,...crj->...cij", J, J)], dim=-3)
        gb = torch.cat([g_scan, torch.einsum("...cri,...cr->...ci", J, r)], dim=-2)
        if E is None:
            idx = torch.cat([scan_idx, pair_idx], dim=-2)
            E = (idx[..., None] == dims).to(torch.float32).flatten(-3, -2)
        # E^T S E and E^T g as matmuls: a fixed-order sum, no atomics.
        Et = E.transpose(-1, -2)
        JtJ = Et @ (S @ E.unflatten(-2, S.shape[-3:-1])).flatten(-3, -2)
        g = (Et @ gb.flatten(-2)[..., None])[..., 0]
        return JtJ, g, cost_scan + 0.5 * torch.sum(r * r, dim=(-2, -1))

    return assemble


def ct_normal_equations(high_grid, low_grid, problem: CtProblem, state: CtState, weights: CtWeights,
                        is_tsdf: bool, per_point: bool = False, direct=None):
    """(JtJ, g, cost) of the window at `state` on the K*9 tangent."""
    D = 9 * state.translation.shape[0]
    return _make_ct_assemble(high_grid, low_grid, problem, weights, is_tsdf, D, direct=direct,
                             per_point=per_point)(state)


def _fixed(cp_mask):
    """Tangent entries the solve freezes: those of masked control points
    and of the first one, (..., K*9) bool."""
    per_cp_fixed = ~cp_mask.to(torch.bool)
    per_cp_fixed[..., 0] = True
    return torch.repeat_interleave(per_cp_fixed, 9, dim=-1)


def _solve_lm(assemble, cp_mask, state0: CtState, num_iterations: int, counter):
    """lm_drive over the assembled normal equations of one window, or of
    B windows at once (every shape with a leading B; per-window LM state);
    counter.assemblies counts the assemblies."""
    fixed = _fixed(cp_mask)
    fixed_f = fixed.to(torch.float32)
    fixed_2d = fixed[..., :, None] | fixed[..., None, :]

    def eval_fn(state):
        counter.assemblies += 1
        JtJ, g, cost = assemble(state)
        return (torch.where(fixed_2d, 0.0, JtJ), torch.where(fixed, 0.0, g)), cost

    def delta_of(quant, lam):
        JtJ, g = quant
        diag = torch.diagonal(JtJ, dim1=-2, dim2=-1)
        damp = lam[..., None] * torch.clamp(diag, min=1e-12) + 1e-12
        damped = JtJ + torch.diag_embed(damp) + torch.diag_embed(fixed_f)
        return torch.where(fixed, 0.0, -torch.linalg.solve(damped, g))

    return lm_drive(eval_fn, delta_of, ct_retract, state0, num_iterations, init_lambda=1e-4, max_lambda=1e6)


def solve_ct_window(high_grid, low_grid, problem: CtProblem, state0: CtState, weights: CtWeights,
                    is_tsdf: bool, num_iterations: int = 12, per_point: bool = False, direct=None):
    """Block-assembled LM solve of the window: (CtState, final_cost,
    initial_cost). Every call runs 1 + num_iterations assemblies, each
    one K3 launch (per-cloud, or per-point with per_point);
    solve_ct_window.assemblies counts them."""
    D = 9 * state0.translation.shape[0]
    assemble = _make_ct_assemble(high_grid, low_grid, problem, weights, is_tsdf, D, direct=direct,
                                 per_point=per_point)
    return _solve_lm(assemble, problem.cp_mask, state0, num_iterations, solve_ct_window)


solve_ct_window.assemblies = 0


# ---------------------------------------------------------------------------
# B windows in one solve
# ---------------------------------------------------------------------------


def solve_ct_window_batched(high_grids, low_grids, problems: CtProblem, states0: CtState, weights: CtWeights,
                            is_tsdf: bool, num_iterations: int = 12, per_point: bool = False, directs=None):
    """B windows in one solve (window_solver.py solve_ct_window_batched
    :729-764): (states (B, K, ...), final costs (B,), initial costs (B,)).

    high_grids, low_grids: B grids each, window b against (high_grids[b],
    low_grids[b]), all of one type, storage dtype and pair of shapes (a
    grid object several windows share is read once); problems, states0
    and directs (DirectImuData, or None) carry a leading window axis on
    every leaf; the weights are shared. Each LM iteration makes one
    slotted K3 launch for all B windows; every window keeps its own LM
    state (damping, accept, done), so each follows its own solve's steps,
    up to the rounding of the batched linear solve.
    solve_ct_window_batched.assemblies counts the batched assemblies."""
    D = 9 * states0.translation.shape[-2]
    assemble = _make_ct_assemble(None, None, problems, weights, is_tsdf, D, direct=directs, per_point=per_point,
                                 slots=window_slots(high_grids, low_grids))
    return _solve_lm(assemble, problems.cp_mask, states0, num_iterations, solve_ct_window_batched)


solve_ct_window_batched.assemblies = 0


def unwarp_and_accumulate(state: CtState, optimized_pose_t, optimized_pose_q, points, mask, prev_idx, next_idx,
                          factor):
    """Marginalized clouds in the frame of the optimized pose
    (window_solver.py :767-788; ref: MaybeOptimize :1383-1407): each cloud
    (C, P, 3) posed between its bracketing control points, then
    optimized_pose^-1 applied; masked points are 0."""
    poses = interpolate_pose(state, prev_idx, next_idx, factor)
    inv_q = quat_conjugate(optimized_pose_q)
    world = quat_rotate(poses.rotation[:, None, :], points) + poses.translation[:, None, :]
    out = quat_rotate(inv_q[None, None, :], world - optimized_pose_t[None, None, :])
    return torch.where(mask[..., None].to(torch.bool), out, 0.0)
