"""Damped Gauss-Newton / Levenberg-Marquardt on manifolds (counterpart of
hectorgrapher_tpu/solvers/gauss_newton.py and of the LM loop in
hectorgrapher_tpu/mapping/pose_graph/optimization.py :75-144; the
reference solves with ceres::Solver).

lm_drive is the port's one LM loop. Its caller gives the evaluation
(eval_fn: the normal-equation quantities and the cost at a point), the
damped step (delta_of) and the retraction; the loop keeps the rule:
multiplicative lambda (x 0.33 on accept, floor min_lambda; x 4 on reject,
cap max_lambda) and Ceres-style termination once an accepted step gains
at most function_tolerance of the cost or the step is at most
parameter_tolerance (|x| + parameter_tolerance). The CT window solve
(mapping/ct/window_solver.py), the SPAs (mapping/pose_graph/
optimization.py), both GN3D refinements (mapping/scan_matching/gn_3d.py)
and levenberg_marquardt below run it.

levenberg_marquardt is a generic dense LM for small problems: the caller
gives residual_fn(x) over x (a tensor, or a tuple or NamedTuple of them)
and a retraction retract(x, delta) that maps a flat tangent vector into
the manifold (Ceres's LocalParameterization). The Jacobian is
torch.func.jacfwd of delta -> residual(retract(x, delta)) at delta = 0,
as the JAX solver takes jax.jacfwd; the normal equations J^T J are dense
(tangent_dim x tangent_dim). It follows the JAX while_loop step for step,
after at most num_iterations steps; zero tolerances force the full count.
num_iterations in the result counts the steps taken, the one that ended
the loop included. The stop test reads one flag to the host per step: no
path of the port solves through this function (the JAX package only
imports it, ct/window_solver.py:48), so it stays thin.

fixed_mask (tangent_dim,) bool freezes coordinates (Ceres's
SetParameterBlockConstant / SubsetParameterization). huber_weights gives
the square roots of Huber IRLS weights for residual blocks.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from hectorgrapher_tpu_torch.transform.rigid import (
    Rigid2,
    Rigid3,
    quat_from_axis_angle,
    quat_multiply,
    quat_normalize,
)


class SolveResult(NamedTuple):
    x: object  # the solution, shaped as x0
    final_cost: torch.Tensor
    initial_cost: torch.Tensor
    num_iterations: int


def _leaves(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


def _select(take, old, new):
    """new's leaves where take, else old's; take (lanes) broadcasts over
    each leaf's trailing axes."""
    def one(a, b):
        return torch.where(take.reshape(take.shape + (1,) * (a.dim() - take.dim())), b, a)
    if isinstance(old, tuple):
        leaves = [one(a, b) for a, b in zip(old, new)]
        return type(old)(*leaves) if hasattr(old, "_fields") else tuple(leaves)
    return one(old, new)


def _lane_norm(leaves, lanes: int):
    """Euclidean norm over every leaf, per lane: over all but a leaf's
    leading `lanes` axes."""
    def sq(x):
        return torch.sum(x * x) if lanes == 0 else torch.sum((x * x).reshape(x.shape[:lanes] + (-1,)), dim=-1)
    return torch.sqrt(sum(sq(x) for x in leaves))


def lm_drive(
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
    min_lambda: float = 1e-10,
):
    """Carried-evaluation LM: (params, cost, initial cost).

    eval_fn(params) -> (quantities, cost), one normal-equation assembly
    per iteration (the trial's evaluation becomes the incumbent's on
    accept); delta_of(quantities, lam) -> tangent step; retract(params,
    delta) -> params. params and quantities are tensors or tuples
    (NamedTuples included) of tensors.

    Same rule as the JAX version: accept a step when it lowers the cost,
    then lam *= 0.33 (floor min_lambda), else lam *= 4 (cap max_lambda);
    stop once an accepted step improves the cost by at most
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

    B independent problems solve at once when the cost is (B,) and every
    leaf of params, quantities and the step has a leading lane axis: lam,
    accept and done are then per lane, and a lane whose loop has ended is
    frozen while the others go on, as jax.vmap of the JAX package's
    while_loop does; each lane follows the steps of its own solve.
    """
    quant, cost = eval_fn(params0)
    cost0 = cost
    params = params0
    lanes = cost.dim()
    done = torch.zeros_like(cost, dtype=torch.bool)
    lam = torch.full_like(cost, init_lambda)
    for _ in range(num_iterations):
        delta = delta_of(quant, lam)
        new_params = retract(params, delta)
        new_quant, new_cost = eval_fn(new_params)
        accept = new_cost < cost
        lam_next = torch.where(accept, torch.clamp(lam * 0.33, min=min_lambda),
                               torch.clamp(lam * 4.0, max=max_lambda))
        done_next = done | (accept & (cost - new_cost <= function_tolerance * cost))
        if parameter_tolerance > 0.0:
            step_norm = _lane_norm(_leaves(delta), lanes)
            x_norm = _lane_norm(_leaves(params), lanes)
            done_next = done_next | (step_norm <= parameter_tolerance * (x_norm + parameter_tolerance))
        live = ~done
        take = live & accept
        params = _select(take, params, new_params)
        quant = _select(take, quant, new_quant)
        cost = torch.where(take, new_cost, cost)
        lam = torch.where(live, lam_next, lam)
        done = done_next
        if stop_on_host and bool(done.all()):
            break
    return params, cost, cost0


def huber_weights(r, scale):
    """sqrt of the Huber IRLS weight for residual magnitudes."""
    a = torch.abs(r)
    return torch.where(a <= scale, 1.0, torch.sqrt(scale / torch.clamp(a, min=1e-12)))


def levenberg_marquardt(
    residual_fn: Callable,
    x0,
    retract: Callable,
    tangent_dim: int,
    num_iterations: int = 20,
    init_lambda: float = 1e-4,
    min_lambda: float = 1e-10,
    max_lambda: float = 1e6,
    fixed_mask: Optional[torch.Tensor] = None,
    dtype=torch.float32,
    function_tolerance: float = 1e-6,
    parameter_tolerance: float = 1e-7,
) -> SolveResult:
    """Minimize 0.5 ||residual_fn(x)||^2 over the manifold (see the module
    docstring) on lm_drive. x0's tensors fix the device."""
    device = _leaves(x0)[0].device
    zero = torch.zeros((tangent_dim,), dtype=dtype, device=device)
    eye = torch.eye(tangent_dim, dtype=dtype, device=device)
    if fixed_mask is not None:
        fixed_mask = torch.as_tensor(fixed_mask, dtype=torch.bool, device=device)
    steps = 0

    def eval_fn(x):
        def f(delta):
            return torch.cat([leaf.reshape(-1) for leaf in _leaves(residual_fn(retract(x, delta)))])

        # (R, D); forward mode can widen a tangent to float64 (a Python
        # float times a 0-dim tensor under vmap), so cast back.
        J = torch.func.jacfwd(f)(zero).to(dtype)
        if fixed_mask is not None:
            J = torch.where(fixed_mask[None, :], 0.0, J)
        r = f(zero)
        return (J.T @ J, J.T @ r), 0.5 * torch.sum(r * r)

    def delta_of(quant, lam):
        nonlocal steps
        steps += 1
        JtJ, g = quant
        damped = JtJ + lam * torch.diag(torch.clamp(torch.diagonal(JtJ), min=1e-12)) + 1e-12 * eye
        delta = -torch.linalg.solve(damped, g)
        return delta if fixed_mask is None else torch.where(fixed_mask, 0.0, delta)

    x, cost, initial_cost = lm_drive(eval_fn, delta_of, retract, x0, num_iterations, init_lambda,
                                     max_lambda=max_lambda, function_tolerance=function_tolerance,
                                     parameter_tolerance=parameter_tolerance, stop_on_host=True,
                                     min_lambda=min_lambda)
    return SolveResult(x=x, final_cost=cost, initial_cost=initial_cost, num_iterations=steps)


# ---------------------------------------------------------------------------
# Common retractions
# ---------------------------------------------------------------------------


def retract_euclidean(x, delta):
    """Plain vector retraction for flat tensors."""
    return x + delta.reshape(x.shape)


def make_pose2_retract():
    """Retraction for Rigid2 (translation (2,), angle ())."""

    def retract(x: Rigid2, delta):
        return Rigid2(translation=x.translation + delta[:2], angle=x.angle + delta[2])

    return retract


def make_pose3_retract():
    """Retraction for Rigid3: translation += dt; q := q exp(dtheta), the
    right-multiplied boxplus of Ceres's quaternion parameterization (ref:
    ceres_scan_matcher_3d.cc)."""

    def retract(x: Rigid3, delta):
        return Rigid3(
            translation=x.translation + delta[:3],
            rotation=quat_normalize(quat_multiply(x.rotation, quat_from_axis_angle(delta[3:6]))),
        )

    return retract
