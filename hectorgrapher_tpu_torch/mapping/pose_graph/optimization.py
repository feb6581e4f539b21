"""Levenberg-Marquardt loop (counterpart of _lm_drive in
hectorgrapher_tpu/mapping/pose_graph/optimization.py :75-144).

The SPA solvers of that module are not ported yet; the CT window solve
(mapping/ct/window_solver.py) runs its LM loop through it.
"""

from __future__ import annotations

import torch


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
    leaf of params. The JAX version is a while_loop; here a `done` flag on
    the device freezes the state for the remaining iterations, so the
    loop never waits on the host and every call runs 1 + num_iterations
    evaluations. The result is the same. The initial cost is returned too,
    so the caller needs no extra evaluation for it.
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
    return params, cost, cost0
