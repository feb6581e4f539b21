"""Levenberg-Marquardt loop and 3D sparse pose adjustment (counterpart of
hectorgrapher_tpu/mapping/pose_graph/optimization.py: _lm_drive :75-144,
the block-Schur SPA :47-72, :167-186, :285-330, solve_spa_3d :335-472 and
solve_spa_3d_full :480-883; ref: internal/optimization/
optimization_problem_3d.cc, cost_functions/spa_cost_function_3d.h).

The CT window solve (mapping/ct/window_solver.py) runs its LM loop through
_lm_drive too.

Jacobians: the JAX solve takes each residual family's per-block Jacobian
with a vmapped jax.jacfwd; here each family's is a closed form over the
whole batch of blocks (the same derivatives; torch.func.jacfwd issued ~8k
small ops per family and evaluation). Assembly is in a fixed order:
one-hot matmuls for the Schur blocks, a dense row-stacked Jacobian and one
matmul for the full system (no entry is summed twice, so no atomic order
can change the cost the LM accept test compares). Not ported: the
matrix-free PCG path (_spa_cg_solve, chosen when S*N > 1e6) and the 2D
solvers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hectorgrapher_tpu_torch.transform.rigid import (
    inverse_right_jacobian,
    quat_conjugate,
    quat_from_axis_angle,
    quat_left_matrix,
    quat_multiply,
    quat_normalize,
    quat_right_matrix,
    quat_rotate,
    quat_to_axis_angle,
    quat_to_rotation_matrix,
    skew,
)


def _leaves(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


def _select(take, old, new):
    if isinstance(old, tuple):
        leaves = [torch.where(take, b, a) for a, b in zip(old, new)]
        return type(old)(*leaves) if hasattr(old, "_fields") else tuple(leaves)
    return torch.where(take, new, old)


def _lm_drive(
    eval_fn,
    delta_of,
    retract,
    params0,
    num_iterations: int,
    init_lambda: float,
    max_lambda: float = 1e8,
    function_tolerance: float = 1e-6,
    parameter_tolerance: float = 1e-7,
    stop_on_host: bool = False,
):
    """Carried-evaluation LM: (params, cost, initial cost).

    eval_fn(params) -> (quantities, cost), one normal-equation assembly
    per iteration (the trial's evaluation becomes the incumbent's on
    accept); delta_of(quantities, lam) -> tangent step; retract(params,
    delta) -> params. params and quantities are tensors or tuples
    (NamedTuples included) of tensors.

    Same rule as the JAX version: accept a step when it lowers the cost,
    then lam *= 0.33 (floor 1e-10), else lam *= 4 (cap max_lambda); stop
    once an accepted step improves the cost by at most
    function_tolerance * cost, or the step shrinks to at most
    parameter_tolerance * (|x| + parameter_tolerance), |x| over every
    leaf of params. The JAX version is a while_loop. Here a `done` flag on
    the device freezes the state for the remaining iterations, so the loop
    never waits on the host and runs 1 + num_iterations evaluations; with
    stop_on_host the host reads `done` after every iteration and leaves
    the loop there (one sync per iteration, for solvers whose evaluation
    costs more than a sync). The result is the same either way. The
    initial cost is returned too, so the caller needs no extra evaluation
    for it.
    """
    quant, cost = eval_fn(params0)
    cost0 = cost
    params = params0
    done = torch.zeros((), dtype=torch.bool, device=cost.device)
    lam = torch.tensor(init_lambda, dtype=torch.float32, device=cost.device)
    for _ in range(num_iterations):
        delta = delta_of(quant, lam)
        new_params = retract(params, delta)
        new_quant, new_cost = eval_fn(new_params)
        accept = new_cost < cost
        lam_next = torch.where(accept, torch.clamp(lam * 0.33, min=1e-10), torch.clamp(lam * 4.0, max=max_lambda))
        done_next = done | (accept & (cost - new_cost <= function_tolerance * cost))
        if parameter_tolerance > 0.0:
            step_norm = torch.sqrt(sum(torch.sum(d * d) for d in _leaves(delta)))
            x_norm = torch.sqrt(sum(torch.sum(p * p) for p in _leaves(params)))
            done_next = done_next | (step_norm <= parameter_tolerance * (x_norm + parameter_tolerance))
        live = ~done
        take = live & accept
        params = _select(take, params, new_params)
        quant = _select(take, quant, new_quant)
        cost = torch.where(take, new_cost, cost)
        lam = torch.where(live, lam_next, lam)
        done = done_next
        if stop_on_host and bool(done):
            break
    return params, cost, cost0


# ---------------------------------------------------------------------------
# Block-Schur solver of the plain SPA system
# ---------------------------------------------------------------------------


def _chol_solve(a, b):
    """Solve SPD a @ x = b through Cholesky. The damped normal matrix is SPD
    in exact arithmetic, but in f32 a stiff system (weights of 1e5) can
    fail to factor; jnp.linalg.cholesky then returns NaN, whose step the
    LM loop rejects and damps harder. So does this one, without raising or
    reading the status on the host."""
    lo, info = torch.linalg.cholesky_ex(a)
    y = torch.linalg.solve_triangular(lo, b[:, None], upper=False)
    x = torch.linalg.solve_triangular(lo.T, y, upper=True)[:, 0]
    return torch.where(info == 0, x, torch.nan)


def _spa_partial_blocks(j_s, j_n, r, c_submap, c_node, s_count: int, n_count: int):
    """Block normal-equation operands summed over the constraints: submap
    blocks (S, P, P), node blocks (N, P, P), couplings (S, N, P, P) and the
    gradients (S, P), (N, P). j_s, j_n: (C, R, P) masked Jacobian halves;
    r: (C, R). The per-constraint products are summed by one-hot matmuls."""
    p = j_s.shape[-1]
    oh_s = torch.nn.functional.one_hot(c_submap, s_count).to(torch.float32)  # (C, S)
    oh_n = torch.nn.functional.one_hot(c_node, n_count).to(torch.float32)
    oh_sn = torch.nn.functional.one_hot(c_submap * n_count + c_node, s_count * n_count).to(torch.float32)
    a_blocks = (oh_s.T @ torch.einsum("cri,crj->cij", j_s, j_s).reshape(-1, p * p)).reshape(s_count, p, p)
    c_blocks = (oh_n.T @ torch.einsum("cri,crj->cij", j_n, j_n).reshape(-1, p * p)).reshape(n_count, p, p)
    b_blocks = (oh_sn.T @ torch.einsum("cri,crj->cij", j_s, j_n).reshape(-1, p * p)).reshape(s_count, n_count, p, p)
    g_s = oh_s.T @ torch.einsum("cri,cr->ci", j_s, r)
    g_n = oh_n.T @ torch.einsum("cri,cr->ci", j_n, r)
    return a_blocks, c_blocks, b_blocks, g_s, g_n


# b_blocks coupling tensors above this element count take the CG path,
# which is not ported.
_SCHUR_COUPLING_BUDGET = 1_000_000


def _spa_schur_solve(blocks, fixed_s, fixed_n, lam):
    """The damped block system solved by Schur elimination of the nodes:
    fixed coordinates get zero couplings and gradient and a unit diagonal.
    Returns the step (S*P + N*P,)."""
    a_blocks, c_blocks, b_blocks, g_s, g_n = blocks
    s_count, n_count, p = a_blocks.shape[0], c_blocks.shape[0], a_blocks.shape[-1]
    fs = fixed_s[:, None, None]
    fn = fixed_n[:, None, None]
    a_blocks = torch.where(fs, 0.0, a_blocks)
    c_blocks = torch.where(fn, 0.0, c_blocks)
    b_blocks = torch.where(fs[:, None] | fn[None], 0.0, b_blocks)
    g_s = torch.where(fixed_s[:, None], 0.0, g_s)
    g_n = torch.where(fixed_n[:, None], 0.0, g_n)
    eye = torch.eye(p, dtype=torch.float32, device=a_blocks.device)

    def damp(blk, fixed):
        diag = torch.diagonal(blk, dim1=-2, dim2=-1)
        add = lam * torch.clamp(diag, min=1e-8) + 1e-8 + fixed[:, None].to(torch.float32)
        return blk + add[:, :, None] * eye

    a_d = damp(a_blocks, fixed_s)
    c_inv, info = torch.linalg.inv_ex(damp(c_blocks, fixed_n))  # (N, P, P); singular blocks give NaN, as in JAX
    c_inv = torch.where((info == 0)[:, None, None], c_inv, torch.nan)
    bc = torch.einsum("snik,nkj->snij", b_blocks, c_inv)
    b_flat = b_blocks.permute(0, 2, 1, 3).reshape(s_count * p, n_count * p)
    bc_flat = bc.permute(0, 2, 1, 3).reshape(s_count * p, n_count * p)
    a_dense = torch.zeros((s_count, p, s_count, p), dtype=torch.float32, device=a_blocks.device)
    idx = torch.arange(s_count, device=a_blocks.device)
    a_dense[idx, :, idx, :] = a_d
    schur = a_dense.reshape(s_count * p, s_count * p) - bc_flat @ b_flat.T
    rhs = g_s.reshape(-1) - bc_flat @ g_n.reshape(-1)
    x_s = _chol_solve(schur, rhs)
    x_n = torch.einsum("nij,nj->ni", c_inv, g_n - (b_flat.T @ x_s).reshape(n_count, p)).reshape(-1)
    delta = -torch.cat([x_s, x_n])
    fixed_coord = torch.cat([torch.repeat_interleave(fixed_s, p), torch.repeat_interleave(fixed_n, p)])
    return torch.where(fixed_coord, 0.0, delta)


# ---------------------------------------------------------------------------
# 3D
# ---------------------------------------------------------------------------


class SpaProblem3D(NamedTuple):
    """Static-capacity pose graph tensors (S submaps, N nodes, C constraints)."""

    submap_translation: torch.Tensor  # (S, 3)
    submap_rotation: torch.Tensor  # (S, 4)
    node_translation: torch.Tensor  # (N, 3)
    node_rotation: torch.Tensor  # (N, 4)
    submap_fixed: torch.Tensor  # (S,) bool: fixed or padding
    node_fixed: torch.Tensor  # (N,) bool
    c_submap: torch.Tensor  # (C,) int64
    c_node: torch.Tensor  # (C,) int64
    c_mask: torch.Tensor  # (C,) bool
    c_rel_translation: torch.Tensor  # (C, 3) zbar
    c_rel_rotation: torch.Tensor  # (C, 4)
    c_translation_weight: torch.Tensor  # (C,)
    c_rotation_weight: torch.Tensor  # (C,)
    c_huber_scale: torch.Tensor  # (C,): a large value disables the loss


def _relative_residual_3d(a_t, a_q, b_t, b_q, rel_t, rel_q, wt, wr):
    """Error of a^-1 b against rel, 6-vector (ref: spa_cost_function_3d.h
    ComputeUnscaledError); also the submap-node constraint residual, the
    JAX package's _constraint_residual_3d."""
    inv_q = quat_conjugate(a_q)
    h_t = quat_rotate(inv_q, b_t - a_t)
    h_q = quat_multiply(inv_q, b_q)
    rel_inv = quat_conjugate(rel_q)
    err_q = quat_multiply(rel_inv, h_q)
    err_t = quat_rotate(rel_inv, h_t - rel_t)
    return torch.cat([wt[..., None] * err_t, wr[..., None] * quat_to_axis_angle(err_q)], dim=-1)


def _pair_blocks(a_t, a_q, b_t, b_q, rel_t, rel_q, wt, wr):
    """Residuals r (B, 6) of relative poses a^-1 b against rel and their
    Jacobians J (B, 6, 12) over [t_a, theta_a, t_b, theta_b], each pose
    moved by the right-multiplied boxplus (t + dt, q exp(dtheta)); the
    derivatives jax.jacfwd takes in the JAX solve, in closed form:
      d err_t = Rrel^T Ra^T (dt_b - dt_a) + Rrel^T [h_t]x dtheta_a
      d log(E) = Jr^-1(log E) (dtheta_b - (Ra^T Rb)^T dtheta_a),
    with h_t = Ra^T (t_b - t_a) and E = rel^-1 a^-1 b."""
    r = _relative_residual_3d(a_t, a_q, b_t, b_q, rel_t, rel_q, wt, wr)
    a_inv = quat_conjugate(a_q)
    h_t = quat_rotate(a_inv, b_t - a_t)
    rel_inv = quat_conjugate(rel_q)
    rt = quat_to_rotation_matrix(rel_inv)
    rta = rt @ quat_to_rotation_matrix(a_inv)
    jinv = inverse_right_jacobian(quat_to_axis_angle(quat_multiply(rel_inv, quat_multiply(a_inv, b_q))))
    m_t = quat_to_rotation_matrix(quat_multiply(quat_conjugate(b_q), a_q))
    zero = torch.zeros_like(rta)
    wt, wr = wt[:, None, None], wr[:, None, None]
    j_t = torch.cat([-rta, rt @ skew(h_t), rta, zero], dim=-1) * wt
    j_r = torch.cat([zero, -(jinv @ m_t), zero, jinv], dim=-1) * wr
    return torch.cat([j_t, j_r], dim=-2), r


def _huber_weights(r, scale):
    """Huber IRLS square-root weight per residual block."""
    norm = torch.linalg.vector_norm(r, dim=-1)
    return torch.where(norm <= scale, 1.0, torch.sqrt(scale / torch.clamp(norm, min=1e-12)))


def _retract_poses(t, q, d):
    """Each pose moved by its 6-vector of d: (t + dt, q exp(dtheta))."""
    d6 = d.reshape(-1, 6)
    return t + d6[:, :3], quat_normalize(quat_multiply(q, quat_from_axis_angle(d6[:, 3:])))


def solve_spa_3d(problem: SpaProblem3D, num_iterations: int = 20, init_lambda: float = 1e-4,
                 linear_solver: str = "auto"):
    """Plain SPA (submap-node constraints only), Schur path. Returns
    (submap_translation, submap_rotation, node_translation, node_rotation,
    final_cost)."""
    S = problem.submap_translation.shape[0]
    N = problem.node_translation.shape[0]
    if linear_solver == "auto":
        linear_solver = "schur" if S * N <= _SCHUR_COUPLING_BUDGET else "cg"
    if linear_solver != "schur":
        raise NotImplementedError(f"linear_solver={linear_solver!r}: only the Schur path is ported")
    cs, cn, m = problem.c_submap, problem.c_node, problem.c_mask

    def retract(params, delta):
        st, sq, nt, nq = params
        return (*_retract_poses(st, sq, delta[: 6 * S]), *_retract_poses(nt, nq, delta[6 * S:]))

    def eval_fn(params):
        st, sq, nt, nq = params
        args = (st[cs], sq[cs], nt[cn], nq[cn], problem.c_rel_translation, problem.c_rel_rotation,
                problem.c_translation_weight, problem.c_rotation_weight)
        J, r = _pair_blocks(*args)  # (C, 6, 12), (C, 6)
        r = torch.where(m[:, None], r, 0.0)
        w = _huber_weights(r, problem.c_huber_scale)[:, None]
        J = torch.where(m[:, None, None], J * w[:, :, None], 0.0)
        r = r * w
        cost = 0.5 * torch.sum(r * r)
        return _spa_partial_blocks(J[:, :, :6], J[:, :, 6:], r, cs, cn, S, N), cost

    def delta_of(blocks, lam):
        return _spa_schur_solve(blocks, problem.submap_fixed, problem.node_fixed, lam)

    params0 = (problem.submap_translation, problem.submap_rotation, problem.node_translation,
               problem.node_rotation)
    params, cost, _ = _lm_drive(eval_fn, delta_of, retract, params0, num_iterations, init_lambda,
                                stop_on_host=True)
    return params + (cost,)


# ---------------------------------------------------------------------------
# 3D extras: odometry / local-pose, fixed-frame, landmarks, IMU
# ---------------------------------------------------------------------------


class SpaExtras3D(NamedTuple):
    """The further residual families of OptimizationProblem3D (ref:
    optimization_problem_3d.cc Solve:353-530; landmark_cost_function_3d.h,
    rotation_cost_function_3d.h, acceleration_cost_function_3d.h), all
    static-capacity with masks. Landmarks add L free 6-dof poses; each IMU
    trajectory adds a free extrinsic rotation and gravity constant."""

    nn_a: torch.Tensor  # (P,) earlier node
    nn_b: torch.Tensor  # (P,) later node
    nn_mask: torch.Tensor
    nn_rel_translation: torch.Tensor  # (P, 3): b in a's frame
    nn_rel_rotation: torch.Tensor  # (P, 4)
    nn_translation_weight: torch.Tensor
    nn_rotation_weight: torch.Tensor
    ff_mask: torch.Tensor  # (N,) fixed-frame translation priors
    ff_translation: torch.Tensor  # (N, 3)
    ff_translation_weight: torch.Tensor  # (N,)
    landmark_translation: torch.Tensor  # (L, 3) initial landmark poses
    landmark_rotation: torch.Tensor  # (L, 4)
    landmark_mask: torch.Tensor  # (L,)
    lm_node: torch.Tensor  # (O,) observing node
    lm_index: torch.Tensor  # (O,) landmark
    lm_mask: torch.Tensor
    lm_rel_translation: torch.Tensor  # (O, 3): landmark in the tracking frame
    lm_rel_rotation: torch.Tensor  # (O, 4)
    lm_translation_weight: torch.Tensor
    lm_rotation_weight: torch.Tensor
    ir_a: torch.Tensor  # (R,) IMU rotation residuals between node pairs
    ir_b: torch.Tensor
    ir_traj: torch.Tensor  # (R,) trajectory slot of the calibration
    ir_mask: torch.Tensor
    ir_delta_rotation: torch.Tensor  # (R, 4) gyro preintegration, IMU frame
    ir_weight: torch.Tensor
    ia_a: torch.Tensor  # (A,) IMU acceleration residuals over node triples
    ia_b: torch.Tensor
    ia_c: torch.Tensor
    ia_traj: torch.Tensor
    ia_mask: torch.Tensor
    ia_delta_velocity: torch.Tensor  # (A, 3) IMU frame at the middle node
    ia_dt1: torch.Tensor
    ia_dt2: torch.Tensor
    ia_weight: torch.Tensor
    traj_calibration: torch.Tensor  # (Tj, 4) extrinsic rotation, initial
    traj_gravity: torch.Tensor  # (Tj,) gravity constant, initial
    traj_mask: torch.Tensor  # (Tj,)
    calibration_fixed: torch.Tensor  # () bool: extrinsics held constant


def empty_extras_3d(num_nodes: int, p: int = 1, l: int = 1, o: int = 1, r: int = 1, a: int = 1, tj: int = 1, *,
                    device) -> SpaExtras3D:
    """Every family at its capacity, all masked out."""
    f32 = dict(dtype=torch.float32, device=device)

    def ints(n):
        return torch.zeros(n, dtype=torch.int64, device=device)

    def off(n):
        return torch.zeros(n, dtype=torch.bool, device=device)

    def ident(n):
        return torch.tensor([[1.0, 0.0, 0.0, 0.0]], **f32).repeat(n, 1)

    return SpaExtras3D(
        nn_a=ints(p), nn_b=ints(p), nn_mask=off(p), nn_rel_translation=torch.zeros((p, 3), **f32),
        nn_rel_rotation=ident(p), nn_translation_weight=torch.zeros(p, **f32),
        nn_rotation_weight=torch.zeros(p, **f32),
        ff_mask=off(num_nodes), ff_translation=torch.zeros((num_nodes, 3), **f32),
        ff_translation_weight=torch.zeros(num_nodes, **f32),
        landmark_translation=torch.zeros((l, 3), **f32), landmark_rotation=ident(l), landmark_mask=off(l),
        lm_node=ints(o), lm_index=ints(o), lm_mask=off(o), lm_rel_translation=torch.zeros((o, 3), **f32),
        lm_rel_rotation=ident(o), lm_translation_weight=torch.zeros(o, **f32),
        lm_rotation_weight=torch.zeros(o, **f32),
        ir_a=ints(r), ir_b=ints(r), ir_traj=ints(r), ir_mask=off(r), ir_delta_rotation=ident(r),
        ir_weight=torch.zeros(r, **f32),
        ia_a=ints(a), ia_b=ints(a), ia_c=ints(a), ia_traj=ints(a), ia_mask=off(a),
        ia_delta_velocity=torch.zeros((a, 3), **f32), ia_dt1=torch.ones(a, **f32), ia_dt2=torch.ones(a, **f32),
        ia_weight=torch.zeros(a, **f32),
        traj_calibration=ident(tj), traj_gravity=torch.full((tj,), 9.80665, **f32), traj_mask=off(tj),
        calibration_fixed=torch.ones((), dtype=torch.bool, device=device),
    )


def _imu_rotation_blocks(qa, qb, cal, delta_rotation, weight):
    """(ref: rotation_cost_function_3d.h) err = qb^-1 qa C dR C^-1 with the
    extrinsic C free; the residual (B, 3) is its vector part, the Jacobian
    (B, 3, 9) is over [theta_a, theta_b, theta_C], each quaternion moved
    by q exp(dtheta), whose first-order change is q (0, dtheta / 2)."""
    cal_inv = quat_conjugate(cal)
    a = quat_multiply(quat_conjugate(qb), qa)
    b = quat_multiply(quat_multiply(cal, delta_rotation), cal_inv)
    err = quat_multiply(a, b)
    la = quat_left_matrix(a)
    d_a = la @ quat_right_matrix(b)
    d_b = -quat_right_matrix(err)
    d_c = la @ (quat_left_matrix(cal) @ quat_right_matrix(quat_multiply(delta_rotation, cal_inv))
                - quat_left_matrix(quat_multiply(cal, delta_rotation)) @ quat_right_matrix(cal_inv))
    J = 0.5 * torch.cat([d_a[..., 1:, 1:], d_b[..., 1:, 1:], d_c[..., 1:, 1:]], dim=-1)
    return J * weight[:, None, None], weight[:, None] * err[:, 1:]


def _imu_acceleration_blocks(qb, ta, tb, tc, grav, cal, delta_velocity, dt1, dt2, weight):
    """(ref: acceleration_cost_function_3d.h) the IMU velocity change
    against the finite-difference one, gravity constant free: residual
    (B, 3) and Jacobian (B, 3, 16) over [theta_b, t_a, t_b, t_c, g,
    theta_C]."""
    up = torch.zeros(3, dtype=ta.dtype, device=ta.device)
    up[2] = 1.0
    half_dt = 0.5 * (dt1 + dt2)
    v_cal = quat_rotate(cal, delta_velocity)
    imu_dv = quat_rotate(qb, v_cal) - (grav * half_dt)[:, None] * up
    fd_dv = (tc - tb) / dt2[:, None] - (tb - ta) / dt1[:, None]
    rb = quat_to_rotation_matrix(qb)
    eye = torch.eye(3, dtype=ta.dtype, device=ta.device)
    inv1, inv2 = (1.0 / dt1)[:, None, None], (1.0 / dt2)[:, None, None]
    J = torch.cat([
        -(rb @ skew(v_cal)), -inv1 * eye, (inv1 + inv2) * eye, -inv2 * eye,
        -half_dt[:, None, None] * up[:, None],
        -(rb @ quat_to_rotation_matrix(cal) @ skew(delta_velocity)),
    ], dim=-1)
    return J * weight[:, None, None], weight[:, None] * (imu_dv - fd_dv)


def _block_columns(starts, width: int):
    """(B, k*width) column indices: block i of row b spans starts[b, i] + 0..width-1."""
    cols = starts[:, :, None] + torch.arange(width, device=starts.device)
    return cols.reshape(starts.shape[0], -1)


def solve_spa_3d_full(problem: SpaProblem3D, extras: SpaExtras3D, num_iterations: int = 20,
                      init_lambda: float = 1e-4):
    """3D SPA with every residual family. Returns (submap_t, submap_q,
    node_t, node_q, landmark_t, landmark_q, calibration, gravity,
    final_cost).

    The tangent is [submaps 6S | nodes 6N | landmarks 6L | per trajectory
    (calibration rotation 3, gravity 1)]; the damped dense normal matrix is
    solved by Cholesky. A family whose mask is all false adds exact zeros
    in the JAX version; here it is skipped."""
    S = problem.submap_translation.shape[0]
    N = problem.node_translation.shape[0]
    L = extras.landmark_translation.shape[0]
    Tj = extras.traj_calibration.shape[0]
    base_g = 6 * (S + N + L)
    D = base_g + 4 * Tj
    dev = problem.submap_translation.device
    ex = extras

    calib_fixed = ex.calibration_fixed | ~ex.traj_mask
    fixed = torch.cat([
        torch.repeat_interleave(problem.submap_fixed, 6),
        torch.repeat_interleave(problem.node_fixed, 6),
        torch.repeat_interleave(~ex.landmark_mask, 6),
        torch.stack([calib_fixed, calib_fixed, calib_fixed, ~ex.traj_mask], dim=1).reshape(-1),
    ])
    active = torch.stack([problem.c_mask.any(), ex.nn_mask.any(), ex.ff_mask.any(), ex.lm_mask.any(),
                          ex.ir_mask.any(), ex.ia_mask.any()]).tolist()

    def retract(params, delta):
        st, sq, nt, nq, lt, lq, cq, grav = params
        dg = delta[base_g:].reshape(Tj, 4)
        return (
            *_retract_poses(st, sq, delta[: 6 * S]),
            *_retract_poses(nt, nq, delta[6 * S: 6 * (S + N)]),
            *_retract_poses(lt, lq, delta[6 * (S + N): base_g]),
            quat_normalize(quat_multiply(cq, quat_from_axis_angle(dg[:, :3]))),
            grav + dg[:, 3],
        )

    def families(params):
        """[(J (B, R, n), r (B, R), columns (B, n))] of the active families."""
        st, sq, nt, nq, lt, lq, cq, grav = params
        node0 = 6 * S
        out = []
        if active[0]:  # submap-node constraints, with Huber IRLS
            cs, cn, m = problem.c_submap, problem.c_node, problem.c_mask
            J, r = _pair_blocks(st[cs], sq[cs], nt[cn], nq[cn], problem.c_rel_translation, problem.c_rel_rotation,
                                problem.c_translation_weight, problem.c_rotation_weight)
            w = _huber_weights(r, problem.c_huber_scale)[:, None]
            out.append((torch.where(m[:, None, None], J * w[:, :, None], 0.0), torch.where(m[:, None], r * w, 0.0),
                        _block_columns(torch.stack([6 * cs, node0 + 6 * cn], dim=1), 6)))
        if active[1]:  # node-node relative poses
            a, b, m = ex.nn_a, ex.nn_b, ex.nn_mask
            J, r = _pair_blocks(nt[a], nq[a], nt[b], nq[b], ex.nn_rel_translation, ex.nn_rel_rotation,
                                ex.nn_translation_weight, ex.nn_rotation_weight)
            out.append((torch.where(m[:, None, None], J, 0.0), torch.where(m[:, None], r, 0.0),
                        _block_columns(torch.stack([node0 + 6 * a, node0 + 6 * b], dim=1), 6)))
        if active[2]:  # fixed-frame translation priors: w (t - prior) on the node translation
            m = ex.ff_mask
            w = ex.ff_translation_weight
            eye = torch.eye(3, 6, device=dev)
            out.append((torch.where(m[:, None, None], w[:, None, None] * eye, 0.0),
                        torch.where(m[:, None], w[:, None] * (nt - ex.ff_translation), 0.0),
                        _block_columns((node0 + 6 * torch.arange(N, device=dev))[:, None], 6)))
        if active[3]:  # landmark observations: landmark against node * rel
            ni, li, m = ex.lm_node, ex.lm_index, ex.lm_mask
            J, r = _pair_blocks(nt[ni], nq[ni], lt[li], lq[li], ex.lm_rel_translation, ex.lm_rel_rotation,
                                ex.lm_translation_weight, ex.lm_rotation_weight)
            out.append((torch.where(m[:, None, None], J, 0.0), torch.where(m[:, None], r, 0.0),
                        _block_columns(torch.stack([node0 + 6 * ni, 6 * (S + N) + 6 * li], dim=1), 6)))
        if active[4]:  # IMU rotations
            a, b, tj, m = ex.ir_a, ex.ir_b, ex.ir_traj, ex.ir_mask
            J, r = _imu_rotation_blocks(nq[a], nq[b], cq[tj], ex.ir_delta_rotation, ex.ir_weight)
            out.append((torch.where(m[:, None, None], J, 0.0), torch.where(m[:, None], r, 0.0),
                        _block_columns(torch.stack([node0 + 6 * a + 3, node0 + 6 * b + 3, base_g + 4 * tj], dim=1),
                                       3)))
        if active[5]:  # IMU accelerations
            a, b, c, tj, m = ex.ia_a, ex.ia_b, ex.ia_c, ex.ia_traj, ex.ia_mask
            J, r = _imu_acceleration_blocks(nq[b], nt[a], nt[b], nt[c], grav[tj], cq[tj], ex.ia_delta_velocity,
                                            ex.ia_dt1, ex.ia_dt2, ex.ia_weight)
            cols = torch.cat([
                _block_columns(torch.stack([node0 + 6 * b + 3, node0 + 6 * a, node0 + 6 * b, node0 + 6 * c], dim=1), 3),
                (base_g + 4 * tj + 3)[:, None],
                _block_columns((base_g + 4 * tj)[:, None], 3),
            ], dim=1)
            out.append((torch.where(m[:, None, None], J, 0.0), torch.where(m[:, None], r, 0.0), cols))
        return out

    def eval_fn(params):
        fams = families(params)
        rows = sum(J.shape[0] * J.shape[1] for J, _, _ in fams)
        jfull = torch.zeros((rows, D), dtype=torch.float32, device=dev)
        row0 = 0
        for J, _, cols in fams:
            b, nr, n = J.shape
            ridx = row0 + torch.arange(b * nr, device=dev).reshape(b, nr, 1).expand(b, nr, n)
            # Columns are distinct within a block row (masked blocks add
            # exact zeros), so the accumulation's order cannot matter.
            jfull.index_put_((ridx, cols[:, None, :].expand(b, nr, n)), J, accumulate=True)
            row0 += b * nr
        r = torch.cat([r.reshape(-1) for _, r, _ in fams])
        jfull = torch.where(fixed[None, :], 0.0, jfull)
        cost = 0.5 * torch.sum(r * r)
        return (jfull.T @ jfull, jfull.T @ r), cost

    def delta_of(quant, lam):
        jtj, g = quant
        diag = torch.diagonal(jtj)
        damped = jtj + torch.diag(lam * torch.clamp(diag, min=1e-8) + 1e-8 + fixed.to(torch.float32))
        return torch.where(fixed, 0.0, -_chol_solve(damped, g))

    params0 = (problem.submap_translation, problem.submap_rotation, problem.node_translation,
               problem.node_rotation, ex.landmark_translation, ex.landmark_rotation, ex.traj_calibration,
               ex.traj_gravity)
    params, cost, _ = _lm_drive(eval_fn, delta_of, retract, params0, num_iterations, init_lambda,
                                stop_on_host=True)
    return params + (cost,)
