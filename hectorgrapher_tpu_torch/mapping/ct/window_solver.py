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
    tangent in closed form (the chain rule jax.jacfwd applies);
  * the first control point frozen; the quaternion manifold through the
    retraction.

Every block touches two control points, so its Jacobian lives on an
18-dim local tangent; a one-hot projection E assembles the K*9-dim normal
equations with matmuls, in a fixed order (no scatter-add atomics: the LM
accept test compares costs).

The grids are prepared once per solve (prepare_grid_3d, window_solver.py
:667-668): an occupancy grid becomes its probability field, which K3's
probability mode reads; a caller that holds prepared grids
(Submap3D.prepared_grids) passes them as they are.

Per-scan mode only. Per-point unwarping, the DIRECT IMU term, the batched
multi-window solve and unwarp_and_accumulate are not ported; the solver
raises NotImplementedError on the first two.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hectorgrapher_tpu_torch.mapping.pose_graph.optimization import _lm_drive
from hectorgrapher_tpu_torch.mapping.scan_matching.interpolated_grid import PreparedProb3D, prepare_grid_3d
from hectorgrapher_tpu_torch.ops.ct_scan_block import ct_scan_block, grid_params
from hectorgrapher_tpu_torch.transform.rigid import (
    Rigid3,
    cross,
    quat_conjugate,
    quat_from_axis_angle,
    quat_multiply,
    quat_normalize,
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
    """Tangent (K*9,) -> state: [dt(3), dtheta(3), dv(3)] per control point."""
    d = delta.reshape(state.translation.shape[0], 9)
    return CtState(
        translation=state.translation + d[:, 0:3],
        rotation=quat_normalize(quat_multiply(state.rotation, quat_from_axis_angle(d[:, 3:6]))),
        velocity=state.velocity + d[:, 6:9],
    )


def _pair_index(prev_idx, next_idx):
    """(B, 18) tangent indices of each block's two control points."""
    nine = torch.arange(9, device=prev_idx.device)
    return torch.cat([prev_idx[:, None] * 9 + nine, next_idx[:, None] * 9 + nine], dim=1)


# ---------------------------------------------------------------------------
# Forward-mode Jacobians on the 18-dim pair tangent, in closed form
# ---------------------------------------------------------------------------
#
# The JAX package takes these Jacobians with jax.jacfwd (window_solver.py
# :488 and :566). Here each value carries its tangent, a (..., 18, n)
# tensor for an (..., n) value: the same chain rule jacfwd applies, op by
# op, as batched tensor ops (torch.func.jacfwd costs ~100x more host time
# per assembly, and the solve is host-bound). Values are computed as the
# JAX source computes them at a zero tangent.


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


def cloud_poses(state: CtState, problem: CtProblem):
    """(pose7 (C, 7), dpose7 (C, 7, 18)): each cloud's interpolated pose
    [t, q] after retracting its two control points by a zero pair tangent
    (window_solver.py scan_block pose_of, :479-488), and its Jacobian."""
    p, n, f = problem.cloud_prev, problem.cloud_next, problem.cloud_factor
    tp, tn = state.translation[p], state.translation[n]
    q0, tq0 = _retract_rotation(state.rotation[p], 3)
    q1, tq1 = _retract_rotation(state.rotation[n], 12)
    pose_t = tp + f[:, None] * (tn - tp)
    dpose_t = (1.0 - f)[:, None, None] * _unit_tangent(tp, 0) + f[:, None, None] * _unit_tangent(tn, 9)
    pose_q, dpose_q = _jnormalize(*_jslerp(q0, tq0, q1, tq1, f))
    return torch.cat([pose_t, pose_q], dim=-1), torch.cat([dpose_t, dpose_q], dim=-1).transpose(1, 2)


def pair_residuals(state: CtState, problem: CtProblem, weights: CtWeights):
    """(r (K-1, 15), J (K-1, 15, 18)): the IMU (live preintegration form)
    and odometry residuals of each control point pair and their Jacobian
    on the pair tangent (window_solver.py pair_block :515-577)."""
    ta, tb = state.translation[:-1], state.translation[1:]
    va, vb = state.velocity[:-1], state.velocity[1:]
    dt = problem.pair_dt[:, None]
    m_imu = problem.pair_mask.to(torch.float32)[:, None]
    m_odom = problem.odom_mask.to(torch.float32)[:, None]
    q0, tq0 = _retract_rotation(state.rotation[:-1], 3)
    q1, tq1 = _retract_rotation(state.rotation[1:], 12)
    dt0, dt1 = _unit_tangent(ta, 0), _unit_tangent(tb, 9)
    dv0, dv1 = _unit_tangent(va, 6), _unit_tangent(vb, 15)

    translation_error = tb - ta - dt * va
    d_translation = dt1 - dt0 - dt[..., None] * dv0
    err_q, d_err_q = _jmul(*_jmul(*_jconj(q1, tq1), q0, tq0), problem.imu_delta_rotation, None)
    imu_r = torch.cat([weights.translation_weight * translation_error, weights.velocity_weight * (vb - va),
                       weights.rotation_weight * err_q[..., 1:]], dim=-1) * m_imu
    imu_j = torch.cat([weights.translation_weight * d_translation, weights.velocity_weight * (dv1 - dv0),
                       weights.rotation_weight * d_err_q[..., 1:]], dim=-1) * m_imu[..., None]

    rel_q, d_rel_q = _jmul(*_jconj(q0, tq0), q1, tq1)
    rel_t, d_rel_t = _jrotate(*_jconj(q0, tq0), tb - ta, dt1 - dt0)
    oerr_q, d_oerr_q = _jmul(*_jconj(rel_q, d_rel_q), problem.odom_delta_rotation, None)
    oerr_t, d_oerr_t = _jrotate(*_jconj(rel_q, d_rel_q), problem.odom_delta_translation - rel_t, -d_rel_t)
    rpy, d_rpy = _jrpy(oerr_q, d_oerr_q)
    wt = problem.odom_translation_weight[:, None]
    wr = problem.odom_rotation_weight[:, None]
    odom_r = torch.cat([wt * oerr_t, wr * rpy], dim=-1) * m_odom
    odom_j = torch.cat([wt[..., None] * d_oerr_t, wr[..., None] * d_rpy], dim=-1) * m_odom[..., None]
    return torch.cat([imu_r, odom_r], dim=-1), torch.cat([imu_j, odom_j], dim=-1).transpose(1, 2)


def make_ct_block_families(high_grid, low_grid, problem: CtProblem, weights: CtWeights, is_tsdf: bool,
                           direct=None, per_point: bool = False):
    """(scan_block, pair_block): state -> a block family.

    scan_block returns pre-reduced blocks (S (C, 18, 18), g (C, 18), cost,
    idx (C, 18)) from kernel K3; pair_block returns raw blocks (J (K-1, 15,
    18), r (K-1, 15), idx (K-1, 18))."""
    if per_point:
        raise NotImplementedError("per-point unwarping is not ported")
    if direct is not None:
        raise NotImplementedError("the DIRECT IMU cost term is not ported")
    n_hi = torch.clamp(torch.sum(problem.hi_mask, dim=1), min=1).to(torch.float32)
    n_lo = torch.clamp(torch.sum(problem.lo_mask, dim=1), min=1).to(torch.float32)
    cloud_mask = problem.cloud_mask.to(torch.float32)
    hi_scale = (weights.high_resolution_grid_weight / torch.sqrt(n_hi) * cloud_mask).contiguous()
    lo_scale = (weights.low_resolution_grid_weight / torch.sqrt(n_lo) * cloud_mask).contiguous()
    hi_points = problem.hi_points.contiguous()
    lo_points = problem.lo_points.contiguous()
    hi_mask = problem.hi_mask.to(torch.bool).contiguous()
    lo_mask = problem.lo_mask.to(torch.bool).contiguous()
    scan_idx = _pair_index(problem.cloud_prev.long(), problem.cloud_next.long())
    pairs = torch.arange(problem.pair_mask.shape[0], device=problem.pair_mask.device)
    pair_idx = _pair_index(pairs, pairs + 1)
    high_grid, low_grid = prepare_grid_3d(high_grid), prepare_grid_3d(low_grid)
    if is_tsdf == isinstance(high_grid, PreparedProb3D):
        raise ValueError(f"is_tsdf={is_tsdf} with a {type(high_grid).__name__} grid")
    gparams = grid_params(high_grid, low_grid)

    def scan_block(state: CtState):
        pose7, dpose7 = cloud_poses(state, problem)
        S, g, cost = ct_scan_block(
            high_grid, low_grid, hi_points, hi_mask, lo_points, lo_mask,
            pose7.contiguous(), dpose7.contiguous(), hi_scale, lo_scale, gparams=gparams,
        )
        return S, g, torch.sum(cost), scan_idx

    def pair_block(state: CtState):
        r, J = pair_residuals(state, problem, weights)
        return J, r, pair_idx

    return scan_block, pair_block


def _make_ct_assemble(high_grid, low_grid, problem: CtProblem, weights: CtWeights, is_tsdf: bool, D: int,
                      direct=None, per_point: bool = False):
    """state -> (JtJ (D, D), g (D,), cost): the window's dense normal
    equations (window_solver.py _make_ct_assemble :582-620)."""
    scan_block, pair_block = make_ct_block_families(
        high_grid, low_grid, problem, weights, is_tsdf, direct=direct, per_point=per_point
    )
    dims = torch.arange(D, device=problem.cp_mask.device)
    E = None  # (B*18, D) one-hot of every block's tangent indices, scan blocks then pair blocks

    def assemble(state: CtState):
        nonlocal E
        S_scan, g_scan, cost_scan, scan_idx = scan_block(state)
        J, r, pair_idx = pair_block(state)
        S = torch.cat([S_scan, torch.einsum("cri,crj->cij", J, J)])
        gb = torch.cat([g_scan, torch.einsum("cri,cr->ci", J, r)])
        if E is None:
            idx = torch.cat([scan_idx, pair_idx])
            E = (idx[:, :, None] == dims[None, None, :]).to(torch.float32).reshape(-1, D)
        # E^T S E and E^T g as matmuls: a fixed-order sum, no atomics.
        JtJ = E.T @ torch.bmm(S, E.reshape(S.shape[0], 18, D)).reshape(-1, D)
        return JtJ, E.T @ gb.reshape(-1), cost_scan + 0.5 * torch.sum(r * r)

    return assemble


def ct_normal_equations(high_grid, low_grid, problem: CtProblem, state: CtState, weights: CtWeights,
                        is_tsdf: bool, per_point: bool = False, direct=None):
    """(JtJ, g, cost) of the window at `state` on the K*9 tangent."""
    D = 9 * state.translation.shape[0]
    return _make_ct_assemble(high_grid, low_grid, problem, weights, is_tsdf, D, direct=direct,
                             per_point=per_point)(state)


def solve_ct_window_block(high_grid, low_grid, problem: CtProblem, state0: CtState, weights: CtWeights,
                          is_tsdf: bool, num_iterations: int = 12, direct=None, per_point: bool = False):
    """Block-assembled LM solve of the window: (state, final_cost,
    initial_cost). Every call runs 1 + num_iterations assemblies, each
    one K3 launch; solve_ct_window_block.assemblies counts them."""
    D = 9 * state0.translation.shape[0]
    assemble = _make_ct_assemble(high_grid, low_grid, problem, weights, is_tsdf, D, direct=direct,
                                 per_point=per_point)
    per_cp_fixed = ~problem.cp_mask.to(torch.bool)
    per_cp_fixed[0] = True
    fixed = torch.repeat_interleave(per_cp_fixed, 9)
    fixed_f = fixed.to(torch.float32)
    fixed_2d = fixed[:, None] | fixed[None, :]

    def eval_fn(state):
        solve_ct_window_block.assemblies += 1
        JtJ, g, cost = assemble(state)
        return (torch.where(fixed_2d, 0.0, JtJ), torch.where(fixed, 0.0, g)), cost

    def delta_of(quant, lam):
        JtJ, g = quant
        diag = torch.diagonal(JtJ)
        damped = JtJ + torch.diag(lam * torch.clamp(diag, min=1e-12) + 1e-12) + torch.diag(fixed_f)
        return torch.where(fixed, 0.0, -torch.linalg.solve(damped, g))

    return _lm_drive(eval_fn, delta_of, ct_retract, state0, num_iterations, init_lambda=1e-4, max_lambda=1e6)


solve_ct_window_block.assemblies = 0


def solve_ct_window(high_grid, low_grid, problem: CtProblem, state0: CtState, weights: CtWeights,
                    is_tsdf: bool, num_iterations: int = 12, per_point: bool = False, direct=None):
    """Solve the window; returns (CtState, final_cost, initial_cost)."""
    return solve_ct_window_block(high_grid, low_grid, problem, state0, weights, is_tsdf=is_tsdf,
                                 num_iterations=num_iterations, direct=direct, per_point=per_point)
