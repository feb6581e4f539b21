"""Damped Gauss-Newton / Levenberg-Marquardt on manifolds (counterpart of
hectorgrapher_tpu/solvers/gauss_newton.py; the reference solves with
ceres::Solver).

A generic dense LM for small problems: the caller gives residual_fn(x)
over x (a tensor, or a tuple or NamedTuple of them) and a
retraction retract(x, delta) that maps a flat tangent vector into the
manifold (Ceres's LocalParameterization). The Jacobian is
torch.func.jacfwd of delta -> residual(retract(x, delta)) at delta = 0,
as the JAX solver takes jax.jacfwd; the normal equations J^T J are dense
(tangent_dim x tangent_dim).

The loop is the JAX while_loop's, step for step: multiplicative lambda
(x 0.33 on accept, floor min_lambda; x 4 on reject, cap max_lambda), and
Ceres-style termination after at most num_iterations steps, once an
accepted step gains at most function_tolerance of the cost or the step
is at most parameter_tolerance (|x| + parameter_tolerance). Zero
tolerances force the full count. num_iterations in the result counts the
steps taken, the one that ended the loop included. The stop test reads
one flag to the host per step: no path of the port solves through this
function (the JAX package only imports it, ct/window_solver.py:48), so it
stays thin; the port's hot LM loops are _lm_drive
(mapping/pose_graph/optimization.py) and the GN3D matcher's.

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
    return [x] if isinstance(x, torch.Tensor) else [leaf for v in x for leaf in _leaves(v)]


def _flat_residual(residual_fn, retract, x):
    def f(delta):
        return torch.cat([leaf.reshape(-1) for leaf in _leaves(residual_fn(retract(x, delta)))])

    return f


def _select(accept, new, old):
    """new where accept, else old, leaf by leaf over x's structure."""
    if isinstance(old, torch.Tensor):
        return torch.where(accept, new, old)
    parts = [_select(accept, n, o) for n, o in zip(new, old)]
    return type(old)(*parts) if hasattr(old, "_fields") else type(old)(parts)


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
    docstring). x0's tensors fix the device."""
    device = _leaves(x0)[0].device
    zero = torch.zeros((tangent_dim,), dtype=dtype, device=device)
    eye = torch.eye(tangent_dim, dtype=dtype, device=device)
    if fixed_mask is not None:
        fixed_mask = torch.as_tensor(fixed_mask, dtype=torch.bool, device=device)

    def cost_of(r):
        return 0.5 * torch.sum(r * r)

    x = x0
    cost = initial_cost = cost_of(_flat_residual(residual_fn, retract, x0)(zero))
    lam = torch.tensor(init_lambda, dtype=dtype, device=device)
    it = 0
    while it < num_iterations:
        f = _flat_residual(residual_fn, retract, x)
        r = f(zero)
        # (R, D); forward mode can widen a tangent to float64 (a Python
        # float times a 0-dim tensor under vmap), so cast back.
        J = torch.func.jacfwd(f)(zero).to(dtype)
        if fixed_mask is not None:
            J = torch.where(fixed_mask[None, :], 0.0, J)
        JtJ = J.T @ J
        g = J.T @ r
        cost = cost_of(r)
        damped = JtJ + lam * torch.diag(torch.clamp(torch.diagonal(JtJ), min=1e-12)) + 1e-12 * eye
        delta = -torch.linalg.solve(damped, g)
        if fixed_mask is not None:
            delta = torch.where(fixed_mask, 0.0, delta)
        x_new = retract(x, delta)
        cost_new = cost_of(_flat_residual(residual_fn, retract, x_new)(zero))
        accept = cost_new < cost
        lam = torch.where(accept, torch.clamp(lam * 0.33, min=min_lambda), torch.clamp(lam * 4.0, max=max_lambda))
        done = accept & (cost - cost_new <= function_tolerance * cost)
        if parameter_tolerance > 0.0:
            x_norm = torch.sqrt(sum(torch.sum(q * q) for q in _leaves(x)))
            done = done | (torch.linalg.vector_norm(delta) <= parameter_tolerance * (x_norm + parameter_tolerance))
        x = _select(accept, x_new, x)
        cost = torch.where(accept, cost_new, cost)
        it += 1
        if bool(done):  # the while_loop's exit test: one host read a step
            break
    return SolveResult(x=x, final_cost=cost, initial_cost=initial_cost, num_iterations=it)


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
