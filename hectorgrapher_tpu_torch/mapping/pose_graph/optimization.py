"""Sparse pose adjustment in 3D and 2D (counterpart of
hectorgrapher_tpu/mapping/pose_graph/optimization.py: the block-Schur SPA
:47-72, :167-186, :285-330, the matrix-free PCG SPA :147-166, :189-279,
solve_spa_3d :335-472, solve_spa_3d_full :480-883, solve_spa_2d :891-998
and solve_spa_2d_full :1001-1212; ref: internal/optimization/
optimization_problem_{2d,3d}.cc, cost_functions/spa_cost_function_{2d,3d}.h).

Every solve runs its LM loop through solvers/gauss_newton.py lm_drive
(the JAX file's LM loop :75-144), which the CT window solve and the GN3D
refinements share.

Jacobians: the JAX solve takes each residual family's per-block Jacobian
with a vmapped jax.jacfwd; here each family's is a closed form over the
whole batch of blocks (the same derivatives; torch.func.jacfwd issued ~8k
small ops per family and evaluation). Assembly is in a fixed order, with
no atomics, so a step does not change from run to run: the plain SPA's
sums over constraints (Schur blocks and the PCG path's) gather each
submap's, node's and submap-node pair's rows through a padded index
table built once per solve (_segment_table) and add them in constraint
order; the full system is a dense row-stacked Jacobian and one matmul. The
Schur, PCG and dense solvers take blocks of any width: 6 (t, theta) a pose
in 3D, 3 (x, y, theta) in 2D.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hectorgrapher_tpu_torch.common.math import normalize_angle_difference
from hectorgrapher_tpu_torch.solvers.gauss_newton import lm_drive
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


def _segment_table(index, mask, count: int):
    """(count, width) int64: row k lists, in constraint order, the
    constraints c with index[c] == k and mask[c], padded with C (the index
    of an appended zero row); width is the largest such count. One host
    sync (the width)."""
    c = index.shape[0]
    seg = torch.where(mask, index, count)  # masked-out constraints go to a dropped segment
    order = torch.argsort(seg, stable=True)
    counts = torch.bincount(seg, minlength=count + 1)
    width = max(int(counts[:count].max()), 1)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(c, device=index.device) - starts[seg[order]]
    table = torch.full((count + 1, width), c, dtype=torch.int64, device=index.device)
    keep = seg[order] < count
    table[seg[order][keep], rank[keep]] = order[keep]
    return table[:count]


def _segment_sum(rows, table):
    """Per-segment sums of rows (C, ...) over table's members, in a fixed
    order: (count, ...)."""
    padded = torch.cat([rows, torch.zeros_like(rows[:1])])
    return padded[table].sum(dim=1)


def _spa_tables(c_submap, c_node, mask, s_count: int, n_count: int, coupling: bool):
    """The segment tables of a solve, built once: the submaps' and the
    nodes' (_segment_table) and, with coupling, the distinct submap-node
    pairs (S*N flat indices, and S*N for masked constraints) and their
    table. Two host syncs, four with coupling."""
    t_s, t_n = _segment_table(c_submap, mask, s_count), _segment_table(c_node, mask, n_count)
    if not coupling:
        return t_s, t_n, None, None
    pairs, inverse = torch.unique(torch.where(mask, c_submap * n_count + c_node, s_count * n_count),
                                  return_inverse=True)
    return t_s, t_n, pairs, _segment_table(inverse, mask, pairs.shape[0])


def _spa_diag_blocks(j_s, j_n, r, tables):
    """Block-diagonal normal-equation operands (no submap-node coupling),
    summed over the constraints (optimization.py _spa_diag_blocks
    :147-166): (a_blocks (S, P, P), c_blocks (N, P, P), g_s (S, P), g_n (N,
    P)). tables: the submap and node _segment_tables."""
    t_s, t_n = tables[:2]
    return (
        _segment_sum(torch.einsum("cri,crj->cij", j_s, j_s), t_s),
        _segment_sum(torch.einsum("cri,crj->cij", j_n, j_n), t_n),
        _segment_sum(torch.einsum("cri,cr->ci", j_s, r), t_s),
        _segment_sum(torch.einsum("cri,cr->ci", j_n, r), t_n),
    )


def _spa_partial_blocks(j_s, j_n, r, tables, s_count: int, n_count: int):
    """Block normal-equation operands summed over the constraints: submap
    blocks (S, P, P), node blocks (N, P, P), couplings (S, N, P, P) and the
    gradients (S, P), (N, P). j_s, j_n: (C, R, P) masked Jacobian halves;
    r: (C, R); tables: _spa_tables with coupling. Each pair's products are
    summed over its constraints, then written to its one coupling block."""
    p = j_s.shape[-1]
    a_blocks, c_blocks, g_s, g_n = _spa_diag_blocks(j_s, j_n, r, tables)
    pairs, t_p = tables[2], tables[3]
    b_flat = torch.zeros((s_count * n_count + 1, p * p), dtype=torch.float32, device=j_s.device)
    b_flat[pairs] = _segment_sum(torch.einsum("cri,crj->cij", j_s, j_n).reshape(-1, p * p), t_p)
    b_blocks = b_flat[:-1].reshape(s_count, n_count, p, p)
    return a_blocks, c_blocks, b_blocks, g_s, g_n


# b_blocks coupling tensors above this element count take the CG path.
_SCHUR_COUPLING_BUDGET = 1_000_000

# What the last SPA solve did: its linear solver ("schur", "cg" or "dense"
# for the _full solves), LM iterations, PCG iterations per LM step, the
# host syncs it made, and its initial and final cost (device scalars).
LAST_SOLVE_STATS: dict = {}


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
# Matrix-free block-Jacobi PCG solver of the plain SPA system
# ---------------------------------------------------------------------------


def _spa_cg_solve(j_s, j_n, blocks, c_submap, c_node, tables, fixed_s, fixed_n, lam, max_iters: int = 200,
                  tol: float = 1e-6, check_every: int = 10):
    """LM step of the SPA system by block-Jacobi preconditioned CG
    (optimization.py _spa_cg_solve :189-279): the damped normal matrix is
    applied as v -> J^T (J v) + damping * v, never formed, so memory stays
    O(C + S + N) with no (S, N) coupling tensor. The damped, fixed-masked
    system is _spa_schur_solve's.

    The JAX loop is a while_loop: at most max_iters iterations while
    r.r > tol^2 b.b. Here an iteration whose stop test holds leaves the
    state as it is (torch.where), so running on past the stop changes
    nothing, and the host reads the stop test back every check_every
    iterations: the result is an early stop's, bit for bit. Returns (the
    step (S*P + N*P,), the iterations taken (a device scalar), the host
    syncs made)."""
    a_blocks, c_blocks, g_s, g_n = blocks
    p = a_blocks.shape[-1]
    t_s, t_n = tables[:2]
    j_s = torch.where(fixed_s[c_submap][:, None, None], 0.0, j_s)
    j_n = torch.where(fixed_n[c_node][:, None, None], 0.0, j_n)
    a_blocks = torch.where(fixed_s[:, None, None], 0.0, a_blocks)
    c_blocks = torch.where(fixed_n[:, None, None], 0.0, c_blocks)
    g_s = torch.where(fixed_s[:, None], 0.0, g_s)
    g_n = torch.where(fixed_n[:, None], 0.0, g_n)
    eye = torch.eye(p, dtype=torch.float32, device=a_blocks.device)

    def damp(blk, fixed):
        add = lam * torch.clamp(torch.diagonal(blk, dim1=-2, dim2=-1), min=1e-8) + 1e-8 + fixed[:, None].float()
        return blk + add[:, :, None] * eye, add

    a_d, add_s = damp(a_blocks, fixed_s)
    c_d, add_n = damp(c_blocks, fixed_n)
    a_inv, c_inv = torch.linalg.inv_ex(a_d)[0], torch.linalg.inv_ex(c_d)[0]

    def matvec(v_s, v_n):
        t = torch.einsum("crp,cp->cr", j_s, v_s[c_submap]) + torch.einsum("crp,cp->cr", j_n, v_n[c_node])
        y_s = _segment_sum(torch.einsum("crp,cr->cp", j_s, t), t_s)
        y_n = _segment_sum(torch.einsum("crp,cr->cp", j_n, t), t_n)
        return y_s + add_s * v_s, y_n + add_n * v_n

    def precond(r_s, r_n):
        return torch.einsum("sij,sj->si", a_inv, r_s), torch.einsum("nij,nj->ni", c_inv, r_n)

    def vdot(a_s, a_n, b_s, b_n):
        return torch.sum(a_s * b_s) + torch.sum(a_n * b_n)

    limit = tol * tol * vdot(g_s, g_n, g_s, g_n)
    x_s, x_n = torch.zeros_like(g_s), torch.zeros_like(g_n)
    r_s, r_n = g_s, g_n
    z_s, z_n = precond(r_s, r_n)
    d_s, d_n = z_s, z_n
    rz = vdot(r_s, r_n, z_s, z_n)
    iters = torch.zeros((), dtype=torch.int32, device=g_s.device)
    syncs = 0
    for it in range(max_iters):
        live = vdot(r_s, r_n, r_s, r_n) > limit
        if it % check_every == 0 and it > 0:
            syncs += 1
            if not bool(live):
                break
        ap_s, ap_n = matvec(d_s, d_n)
        alpha = rz / torch.clamp(vdot(d_s, d_n, ap_s, ap_n), min=1e-30)
        nx_s, nx_n = x_s + alpha * d_s, x_n + alpha * d_n
        nr_s, nr_n = r_s - alpha * ap_s, r_n - alpha * ap_n
        nz_s, nz_n = precond(nr_s, nr_n)
        rz_new = vdot(nr_s, nr_n, nz_s, nz_n)
        beta = rz_new / torch.clamp(rz, min=1e-30)
        nd_s, nd_n = nz_s + beta * d_s, nz_n + beta * d_n
        x_s, x_n, r_s, r_n, d_s, d_n, rz = (
            torch.where(live, new, old) for old, new in
            ((x_s, nx_s), (x_n, nx_n), (r_s, nr_s), (r_n, nr_n), (d_s, nd_s), (d_n, nd_n), (rz, rz_new)))
        iters = iters + live.to(torch.int32)
    delta = -torch.cat([x_s.reshape(-1), x_n.reshape(-1)])
    fixed_coord = torch.cat([torch.repeat_interleave(fixed_s, p), torch.repeat_interleave(fixed_n, p)])
    return torch.where(fixed_coord, 0.0, delta), iters, syncs


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


def _weighted_blocks(J, r, mask, huber_scale):
    """Constraint blocks (J (C, R, 2P), r (C, R)) masked and scaled by
    their Huber weights: what the SPA's normal equations sum, whichever
    shards computed them (parallel/sharded.py)."""
    r = torch.where(mask[:, None], r, 0.0)
    w = _huber_weights(r, huber_scale)[:, None]
    return torch.where(mask[:, None, None], J * w[:, :, None], 0.0), r * w


def _retract_poses(t, q, d):
    """Each pose moved by its 6-vector of d: (t + dt, q exp(dtheta))."""
    d6 = d.reshape(-1, 6)
    return t + d6[:, :3], quat_normalize(quat_multiply(q, quat_from_axis_angle(d6[:, 3:])))


def _solve_spa(problem, weighted_blocks, retract, params0, p: int, num_iterations: int, init_lambda: float,
               linear_solver: str):
    """The plain SPA's LM solve over poses of tangent width p, shared by
    solve_spa_3d and solve_spa_2d and their sharded forms.
    weighted_blocks(params) -> (J (C, R, 2p), r (C, R)): each constraint's
    residual and Jacobian over [submap, node] tangents, through
    _weighted_blocks. Returns (params, final cost) and records
    LAST_SOLVE_STATS."""
    S, N = problem.submap_fixed.shape[0], problem.node_fixed.shape[0]
    if linear_solver == "auto":
        linear_solver = "schur" if S * N <= _SCHUR_COUPLING_BUDGET else "cg"
    if linear_solver not in ("schur", "cg"):
        raise ValueError(f"linear_solver={linear_solver!r}: 'auto', 'schur' or 'cg'")
    cs, cn, m = problem.c_submap, problem.c_node, problem.c_mask
    tables = _spa_tables(cs, cn, m, S, N, coupling=linear_solver == "schur")
    stats = {"linear_solver": linear_solver, "lm_iterations": 0, "cg_iterations": [],
             "host_syncs": 2 if linear_solver == "cg" else 4}

    def eval_fn(params):
        J, r = weighted_blocks(params)
        cost = 0.5 * torch.sum(r * r)
        j_s, j_n = J[:, :, :p], J[:, :, p:]
        if linear_solver == "cg":  # the diagonal blocks only: no (S, N) coupling tensor
            return (j_s, j_n, *_spa_diag_blocks(j_s, j_n, r, tables)), cost
        return _spa_partial_blocks(j_s, j_n, r, tables, S, N), cost

    def delta_of(quant, lam):
        stats["lm_iterations"] += 1
        stats["host_syncs"] += 1  # lm_drive's stop test
        if linear_solver == "cg":
            j_s, j_n, *diag = quant
            delta, iters, syncs = _spa_cg_solve(j_s, j_n, diag, cs, cn, tables, problem.submap_fixed,
                                                problem.node_fixed, lam)
            stats["cg_iterations"].append(iters)
            stats["host_syncs"] += syncs
            return delta
        return _spa_schur_solve(quant, problem.submap_fixed, problem.node_fixed, lam)

    params, cost, cost0 = lm_drive(eval_fn, delta_of, retract, params0, num_iterations, init_lambda,
                                   stop_on_host=True)
    if stats["cg_iterations"]:  # one readback for the record
        stats["cg_iterations"] = torch.stack(stats["cg_iterations"]).tolist()
        stats["host_syncs"] += 1
    LAST_SOLVE_STATS.clear()
    LAST_SOLVE_STATS.update(stats, initial_cost=cost0, final_cost=cost)
    return params, cost


def solve_spa_3d(problem: SpaProblem3D, num_iterations: int = 20, init_lambda: float = 1e-4,
                 linear_solver: str = "auto"):
    """Plain SPA (submap-node constraints only). Returns
    (submap_translation, submap_rotation, node_translation, node_rotation,
    final_cost).

    linear_solver: "schur" (exact block-Schur elimination, O(S*N)
    memory), "cg" (matrix-free block-Jacobi PCG, O(C + S + N) memory), or
    "auto" (schur up to _SCHUR_COUPLING_BUDGET submap-node products).
    LAST_SOLVE_STATS records the solve."""
    S = problem.submap_translation.shape[0]
    cs, cn = problem.c_submap, problem.c_node

    def retract(params, delta):
        st, sq, nt, nq = params
        return (*_retract_poses(st, sq, delta[: 6 * S]), *_retract_poses(nt, nq, delta[6 * S:]))

    def weighted_blocks(params):
        st, sq, nt, nq = params
        return _weighted_blocks(*_pair_blocks(st[cs], sq[cs], nt[cn], nq[cn], problem.c_rel_translation,
                                              problem.c_rel_rotation, problem.c_translation_weight,
                                              problem.c_rotation_weight),  # (C, 6, 12), (C, 6)
                                problem.c_mask, problem.c_huber_scale)

    params0 = (problem.submap_translation, problem.submap_rotation, problem.node_translation,
               problem.node_rotation)
    params, cost = _solve_spa(problem, weighted_blocks, retract, params0, 6, num_iterations, init_lambda,
                              linear_solver)
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

    params0 = (problem.submap_translation, problem.submap_rotation, problem.node_translation,
               problem.node_rotation, ex.landmark_translation, ex.landmark_rotation, ex.traj_calibration,
               ex.traj_gravity)
    params, cost = _solve_dense(families, fixed, D, retract, params0, num_iterations, init_lambda)
    return params + (cost,)


def _solve_dense(families, fixed, D: int, retract, params0, num_iterations: int, init_lambda: float):
    """The LM solve of a full SPA system, shared by solve_spa_3d_full and
    solve_spa_2d_full: families(params) -> [(J (B, R, n), r (B, R), columns
    (B, n))] of the active residual families, stacked into one dense
    Jacobian of D columns (fixed columns zeroed); the damped normal matrix
    is solved by Cholesky. Returns (params, final cost) and records
    LAST_SOLVE_STATS."""
    dev = fixed.device
    stats = {"linear_solver": "dense", "lm_iterations": 0, "cg_iterations": [], "host_syncs": 1}

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
        stats["lm_iterations"] += 1
        stats["host_syncs"] += 1  # lm_drive's stop test
        jtj, g = quant
        diag = torch.diagonal(jtj)
        damped = jtj + torch.diag(lam * torch.clamp(diag, min=1e-8) + 1e-8 + fixed.to(torch.float32))
        return torch.where(fixed, 0.0, -_chol_solve(damped, g))

    params, cost, cost0 = lm_drive(eval_fn, delta_of, retract, params0, num_iterations, init_lambda,
                                   stop_on_host=True)
    LAST_SOLVE_STATS.clear()
    LAST_SOLVE_STATS.update(stats, initial_cost=cost0, final_cost=cost)
    return params, cost


# ---------------------------------------------------------------------------
# 2D
# ---------------------------------------------------------------------------


class SpaProblem2D(NamedTuple):
    """Static-capacity 2D pose graph tensors; poses are (x, y, theta)."""

    submap_pose: torch.Tensor  # (S, 3)
    node_pose: torch.Tensor  # (N, 3)
    submap_fixed: torch.Tensor  # (S,) bool: fixed or padding
    node_fixed: torch.Tensor  # (N,) bool
    c_submap: torch.Tensor  # (C,) int64
    c_node: torch.Tensor  # (C,) int64
    c_mask: torch.Tensor  # (C,) bool
    c_rel_pose: torch.Tensor  # (C, 3) zbar
    c_translation_weight: torch.Tensor  # (C,)
    c_rotation_weight: torch.Tensor  # (C,)
    c_huber_scale: torch.Tensor  # (C,): a large value disables the loss


def _relative_residual_2d(a, b, rel, wt, wr):
    """Error of a^-1 b against rel, (B, 3) (ref: spa_cost_function_2d.h
    ComputeUnscaledError); also the submap-node constraint residual, the
    JAX package's _constraint_residual_2d. The angle error is wrapped to
    (-pi, pi]."""
    c, s = torch.cos(a[:, 2]), torch.sin(a[:, 2])
    d0, d1 = b[:, 0] - a[:, 0], b[:, 1] - a[:, 1]
    h0, h1 = c * d0 + s * d1, -s * d0 + c * d1
    err_a = normalize_angle_difference(rel[:, 2] - (b[:, 2] - a[:, 2]))
    return torch.stack([wt * (rel[:, 0] - h0), wt * (rel[:, 1] - h1), wr * err_a], dim=-1)


def _pair_blocks_2d(a, b, rel, wt, wr):
    """Residuals r (B, 3) of relative poses a^-1 b against rel and their
    Jacobians J (B, 3, 6) over [a, b], each pose moved additively; the
    derivatives jax.jacfwd takes in the JAX solve, in closed form. With
    h = R(a_theta)^T (b_xy - a_xy):
      d h / d a_xy = -R^T, d h / d b_xy = R^T, d h / d a_theta = (h1, -h0);
    the angle error moves by +1 with a_theta and -1 with b_theta (the wrap's
    floor has zero derivative, as under jacfwd)."""
    r = _relative_residual_2d(a, b, rel, wt, wr)
    c, s = torch.cos(a[:, 2]), torch.sin(a[:, 2])
    d0, d1 = b[:, 0] - a[:, 0], b[:, 1] - a[:, 1]
    h0, h1 = c * d0 + s * d1, -s * d0 + c * d1
    zero = torch.zeros_like(c)
    J = torch.stack([
        torch.stack([wt * c, wt * s, -wt * h1, -wt * c, -wt * s, zero], dim=-1),
        torch.stack([-wt * s, wt * c, wt * h0, wt * s, -wt * c, zero], dim=-1),
        torch.stack([zero, zero, wr + zero, zero, zero, -wr + zero], dim=-1),
    ], dim=-2)
    return J, r


def solve_spa_2d(problem: SpaProblem2D, num_iterations: int = 20, init_lambda: float = 1e-4,
                 linear_solver: str = "auto"):
    """Plain 2D SPA (submap-node constraints only). Returns (submap_pose,
    node_pose, final_cost); linear_solver as solve_spa_3d's.
    LAST_SOLVE_STATS records the solve."""
    S = problem.submap_pose.shape[0]
    cs, cn = problem.c_submap, problem.c_node

    def retract(params, delta):
        sp, np_ = params
        return sp + delta[: 3 * S].reshape(-1, 3), np_ + delta[3 * S:].reshape(-1, 3)

    def weighted_blocks(params):
        sp, np_ = params
        return _weighted_blocks(*_pair_blocks_2d(sp[cs], np_[cn], problem.c_rel_pose, problem.c_translation_weight,
                                                 problem.c_rotation_weight), problem.c_mask, problem.c_huber_scale)

    params, cost = _solve_spa(problem, weighted_blocks, retract, (problem.submap_pose, problem.node_pose), 3,
                              num_iterations, init_lambda, linear_solver)
    return params + (cost,)


class SpaExtras2D(NamedTuple):
    """The further residual families of OptimizationProblem2D (ref:
    optimization_problem_2d.cc): odometry and consecutive-node relative
    poses, fixed-frame poses, landmark observations with 2D landmark poses
    free, all static-capacity with masks."""

    nn_a: torch.Tensor  # (P,) earlier node
    nn_b: torch.Tensor  # (P,) later node
    nn_mask: torch.Tensor
    nn_rel_pose: torch.Tensor  # (P, 3): b in a's frame
    nn_translation_weight: torch.Tensor
    nn_rotation_weight: torch.Tensor
    ff_mask: torch.Tensor  # (N,)
    ff_pose: torch.Tensor  # (N, 3); its translation is the prior
    ff_translation_weight: torch.Tensor  # (N,)
    landmark_pose: torch.Tensor  # (L, 3) initial landmark poses
    landmark_mask: torch.Tensor  # (L,)
    lm_node: torch.Tensor  # (O,) observing node
    lm_index: torch.Tensor  # (O,) landmark
    lm_mask: torch.Tensor
    lm_rel_pose: torch.Tensor  # (O, 3): landmark in the tracking frame
    lm_translation_weight: torch.Tensor
    lm_rotation_weight: torch.Tensor


def empty_extras_2d(num_nodes: int, p: int = 1, l: int = 1, o: int = 1, *, device) -> SpaExtras2D:
    """Every family at its capacity, all masked out."""
    f32 = dict(dtype=torch.float32, device=device)

    def ints(n):
        return torch.zeros(n, dtype=torch.int64, device=device)

    def off(n):
        return torch.zeros(n, dtype=torch.bool, device=device)

    return SpaExtras2D(
        nn_a=ints(p), nn_b=ints(p), nn_mask=off(p), nn_rel_pose=torch.zeros((p, 3), **f32),
        nn_translation_weight=torch.zeros(p, **f32), nn_rotation_weight=torch.zeros(p, **f32),
        ff_mask=off(num_nodes), ff_pose=torch.zeros((num_nodes, 3), **f32),
        ff_translation_weight=torch.zeros(num_nodes, **f32),
        landmark_pose=torch.zeros((l, 3), **f32), landmark_mask=off(l),
        lm_node=ints(o), lm_index=ints(o), lm_mask=off(o), lm_rel_pose=torch.zeros((o, 3), **f32),
        lm_translation_weight=torch.zeros(o, **f32), lm_rotation_weight=torch.zeros(o, **f32),
    )


def solve_spa_2d_full(problem: SpaProblem2D, extras: SpaExtras2D, num_iterations: int = 20,
                      init_lambda: float = 1e-4):
    """2D SPA with every residual family. Returns (submap_pose, node_pose,
    landmark_pose, final_cost).

    The tangent is [submaps 3S | nodes 3N | landmarks 3L]; the damped dense
    normal matrix is solved by Cholesky (_solve_dense). The submap-node
    constraints carry the Huber weights, the other families none. A family
    whose mask is all false adds exact zeros in the JAX version; here it is
    skipped."""
    S = problem.submap_pose.shape[0]
    N = problem.node_pose.shape[0]
    L = extras.landmark_pose.shape[0]
    dev = problem.submap_pose.device
    ex = extras
    fixed = torch.cat([torch.repeat_interleave(problem.submap_fixed, 3), torch.repeat_interleave(problem.node_fixed, 3),
                       torch.repeat_interleave(~ex.landmark_mask, 3)])
    active = torch.stack([problem.c_mask.any(), ex.nn_mask.any(), ex.ff_mask.any(), ex.lm_mask.any()]).tolist()

    def retract(params, delta):
        sp, np_, lp = params
        return (sp + delta[: 3 * S].reshape(-1, 3), np_ + delta[3 * S: 3 * (S + N)].reshape(-1, 3),
                lp + delta[3 * (S + N):].reshape(-1, 3))

    def families(params):
        """[(J (B, R, n), r (B, R), columns (B, n))] of the active families."""
        sp, np_, lp = params
        node0 = 3 * S
        out = []
        if active[0]:  # submap-node constraints, with Huber IRLS
            cs, cn, m = problem.c_submap, problem.c_node, problem.c_mask
            J, r = _pair_blocks_2d(sp[cs], np_[cn], problem.c_rel_pose, problem.c_translation_weight,
                                   problem.c_rotation_weight)
            w = _huber_weights(r, problem.c_huber_scale)[:, None]
            out.append((torch.where(m[:, None, None], J * w[:, :, None], 0.0), torch.where(m[:, None], r * w, 0.0),
                        _block_columns(torch.stack([3 * cs, node0 + 3 * cn], dim=1), 3)))
        if active[1]:  # odometry and local-SLAM relative poses between nodes
            a, b, m = ex.nn_a, ex.nn_b, ex.nn_mask
            J, r = _pair_blocks_2d(np_[a], np_[b], ex.nn_rel_pose, ex.nn_translation_weight, ex.nn_rotation_weight)
            out.append((torch.where(m[:, None, None], J, 0.0), torch.where(m[:, None], r, 0.0),
                        _block_columns(torch.stack([node0 + 3 * a, node0 + 3 * b], dim=1), 3)))
        if active[2]:  # fixed-frame priors: w (xy - prior) on the node position
            m, w = ex.ff_mask, ex.ff_translation_weight
            eye = torch.eye(2, 3, device=dev)
            out.append((torch.where(m[:, None, None], w[:, None, None] * eye, 0.0),
                        torch.where(m[:, None], w[:, None] * (np_[:, :2] - ex.ff_pose[:, :2]), 0.0),
                        _block_columns((node0 + 3 * torch.arange(N, device=dev))[:, None], 3)))
        if active[3]:  # landmark observations: landmark against node * rel
            ni, li, m = ex.lm_node, ex.lm_index, ex.lm_mask
            J, r = _pair_blocks_2d(np_[ni], lp[li], ex.lm_rel_pose, ex.lm_translation_weight, ex.lm_rotation_weight)
            out.append((torch.where(m[:, None, None], J, 0.0), torch.where(m[:, None], r, 0.0),
                        _block_columns(torch.stack([node0 + 3 * ni, 3 * (S + N) + 3 * li], dim=1), 3)))
        return out

    params, cost = _solve_dense(families, fixed, 3 * (S + N + L), retract,
                                (problem.submap_pose, problem.node_pose, ex.landmark_pose), num_iterations, init_lambda)
    return params + (cost,)
