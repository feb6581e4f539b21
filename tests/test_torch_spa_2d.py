"""Parity of the port's 2D SPA (hectorgrapher_tpu_torch/mapping/pose_graph/
optimization.py) with the JAX package's, on the CPU with the same inputs:
solve_spa_2d on the square loop of tests/test_spa.py through the Schur and
the PCG paths, with and without the Huber loss, solve_spa_2d_full with
odometry, fixed-frame and landmark extras (2D versions of the scenes of
tests/test_spa_extras.py) and with all of them at once, and a medium
generated 2D graph through both linear solvers.

Tolerances: final poses within 1e-4 m / rad and the final cost within 1e-4
of the JAX cost (relative) or 1e-7 (absolute, for costs near zero). Both
run the same LM steps in f32; the Jacobians are the same forward-mode
derivatives, summed in another order (and under the tests' x64 mode,
ROADMAP C1, the JAX solve computes some residuals in float64).

The port's Jacobian is a closed form where the JAX solve takes
jax.jacfwd; test_pair_jacobian_matches_jax_jacfwd holds it against
jax.jacfwd of the JAX residual within 1e-5 * max(1, max |J|), angles
across the +-pi wrap included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hectorgrapher_tpu.mapping.pose_graph.optimization import (
    SpaProblem2D,
    _relative_residual_2d,
    empty_extras_2d,
    solve_spa_2d,
    solve_spa_2d_full,
)
from hectorgrapher_tpu_torch import convert
from hectorgrapher_tpu_torch.evaluation.graph_generator import make_scale_spa_problem_2d, odometry_extras_2d
from hectorgrapher_tpu_torch.mapping.pose_graph import optimization as topt
from torch_parity import CPU

torch.set_num_threads(1)


def _assert_close(got, want):
    *got_params, got_cost = got
    *want_params, want_cost = want
    for g, w in zip(got_params, want_params):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)
    assert abs(float(got_cost) - float(want_cost)) <= max(1e-4 * abs(float(want_cost)), 1e-7)


def _rel_pose(sub, node):
    c, s = np.cos(sub[2]), np.sin(sub[2])
    d = node[:2] - sub[:2]
    return [c * d[0] + s * d[1], -s * d[0] + c * d[1], node[2] - sub[2]]


def _square_problem(huber=1e6):
    """tests/test_spa.py test_spa_2d_square_loop's problem: 8 nodes on a
    square with drift, one submap a side, each node tied to its side's
    submap and the next one."""
    S, N, C = 4, 8, 32
    rng = np.random.default_rng(0)
    gt = []
    for i in range(8):
        side, frac = i // 2, (i % 2) / 2.0
        gt.append([[2 * frac, 0.0, 0.0], [2.0, 2 * frac, np.pi / 2], [2.0 - 2 * frac, 2.0, np.pi],
                   [0.0, 2.0 - 2 * frac, -np.pi / 2]][side])
    gt = np.asarray(gt, np.float32)
    submap_gt = gt[::2].copy()
    drift = np.cumsum(rng.normal(0, 0.05, size=(8, 3)), axis=0).astype(np.float32)
    node_init = gt + drift
    submap_init = submap_gt + drift[::2]
    submap_init[0] = submap_gt[0]
    cs, cn, crel = [], [], []
    for i in range(8):
        for si in (i // 2, ((i + 1) // 2) % 4):
            cs.append(si)
            cn.append(i)
            crel.append(_rel_pose(submap_gt[si], gt[i]))
    pad = C - len(cs)
    return SpaProblem2D(
        submap_pose=jnp.asarray(submap_init),
        node_pose=jnp.asarray(node_init),
        submap_fixed=jnp.asarray([True, False, False, False]),
        node_fixed=jnp.zeros(N, bool),
        c_submap=jnp.asarray(np.pad(cs, (0, pad)).astype(np.int32)),
        c_node=jnp.asarray(np.pad(cn, (0, pad)).astype(np.int32)),
        c_mask=jnp.asarray(np.pad(np.ones(len(cs), bool), (0, pad))),
        c_rel_pose=jnp.asarray(np.pad(np.asarray(crel, np.float32), ((0, pad), (0, 0)))),
        c_translation_weight=jnp.asarray(np.pad(np.full(len(cs), 30.0), (0, pad)).astype(np.float32)),
        c_rotation_weight=jnp.asarray(np.pad(np.full(len(cs), 30.0), (0, pad)).astype(np.float32)),
        c_huber_scale=jnp.full(C, huber, jnp.float32),
    ), gt


@pytest.mark.parametrize("solver", ["schur", "cg"])
@pytest.mark.parametrize("huber", [1e6, 0.05])
def test_solve_spa_2d_matches_jax(solver, huber):
    problem, gt = _square_problem(huber)
    want = solve_spa_2d(problem, num_iterations=25, linear_solver=solver)
    got = topt.solve_spa_2d(convert.spa_problem_2d(problem, CPU), num_iterations=25, linear_solver=solver)
    _assert_close(got, want)
    assert topt.LAST_SOLVE_STATS["linear_solver"] == solver
    if huber > 1:  # the test_spa.py bounds
        np.testing.assert_allclose(got[1].numpy()[:8, :2], gt[:, :2], atol=0.02)
        assert float(got[2]) < 1e-3 and float(topt.LAST_SOLVE_STATS["final_cost"]) < float(
            topt.LAST_SOLVE_STATS["initial_cost"])


def test_auto_picks_cg_above_budget(monkeypatch):
    problem = convert.spa_problem_2d(_square_problem()[0], CPU)  # S * N = 32
    for budget, solver in ((32, "schur"), (31, "cg")):
        monkeypatch.setattr(topt, "_SCHUR_COUPLING_BUDGET", budget)
        topt.solve_spa_2d(problem, num_iterations=3)
        assert topt.LAST_SOLVE_STATS["linear_solver"] == solver


def _jax_problem(tproblem):
    """A port SpaProblem2D as the JAX package's (int32 indices)."""
    return SpaProblem2D(*(jnp.asarray(a.numpy().astype(np.int32) if a.dtype == torch.int64 else a.numpy())
                          for a in tproblem))


def test_medium_graph_schur_and_cg_match_jax_and_the_truth():
    """A generated 2D graph of 200 nodes, 24 submaps and 800 constraints:
    each of the port's linear solvers within 1e-4 of the JAX package's on
    the same problem, both within 0.01 m of the truth, and the PCG within
    5e-3 m of the Schur path (tests/test_spa_cg.py's bounds)."""
    tproblem, gt, s_gt = make_scale_spa_problem_2d(200, 24, 800, noise=0.3, seed=3, device=CPU)
    problem = _jax_problem(tproblem)
    out = {}
    for solver in ("schur", "cg"):
        want = solve_spa_2d(problem, num_iterations=15, linear_solver=solver)
        out[solver] = topt.solve_spa_2d(tproblem, num_iterations=15, linear_solver=solver)
        for g, w in zip(out[solver][:2], want[:2]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)
        assert np.linalg.norm(out[solver][1].numpy()[:, :2] - gt[:, :2], axis=1).max() < 0.01
        assert np.linalg.norm(out[solver][0].numpy()[:, :2] - s_gt[:, :2], axis=1).max() < 0.01
    assert np.abs(out["cg"][1].numpy() - out["schur"][1].numpy()).max() < 5e-3


def _chain_extras(case):
    """A 2D scene for solve_spa_2d_full and its extras (JAX): a 5-node chain
    anchored on node 0, with the odometry chain ("nn"), fixed-frame priors
    ("ff"), two landmark observations ("lm"), or all of them ("all")."""
    S, N, C = 1, 5, 8
    rng = np.random.default_rng(0)
    gt = np.array([[0.3 * i, 0.1 * i, 0.1 * i] for i in range(N)], np.float32)
    node = gt + np.concatenate([[np.zeros(3)], rng.normal(0, 0.05, (N - 1, 3))]).astype(np.float32)
    cs, cn, crel = [0], [0], [_rel_pose(np.zeros(3), gt[0])]
    if case == "lm":  # the landmark scene ties both observing nodes to the submap
        cs, cn, crel = [0, 0], [0, 1], [_rel_pose(np.zeros(3), gt[0]), _rel_pose(np.zeros(3), gt[1])]
    pad = C - len(cs)
    problem = SpaProblem2D(
        submap_pose=jnp.zeros((S, 3), jnp.float32), node_pose=jnp.asarray(node),
        submap_fixed=jnp.asarray([True]), node_fixed=jnp.zeros(N, bool),
        c_submap=jnp.asarray(np.pad(cs, (0, pad)).astype(np.int32)),
        c_node=jnp.asarray(np.pad(cn, (0, pad)).astype(np.int32)),
        c_mask=jnp.asarray(np.pad(np.ones(len(cs), bool), (0, pad))),
        c_rel_pose=jnp.asarray(np.pad(np.asarray(crel, np.float32), ((0, pad), (0, 0)))),
        c_translation_weight=jnp.asarray(np.pad(np.full(len(cs), 20.0), (0, pad)).astype(np.float32)),
        c_rotation_weight=jnp.asarray(np.pad(np.full(len(cs), 20.0), (0, pad)).astype(np.float32)),
        c_huber_scale=jnp.full(C, 0.5, jnp.float32),
    )
    P, L, O = 8, 2, 4
    extras = empty_extras_2d(N, p=P, l=L, o=O)
    if case in ("nn", "all"):
        nn_a, nn_b = np.zeros(P, np.int32), np.zeros(P, np.int32)
        nn_rel, nn_mask = np.zeros((P, 3), np.float32), np.zeros(P, bool)
        for i in range(N - 1):
            nn_a[i], nn_b[i], nn_rel[i], nn_mask[i] = i, i + 1, _rel_pose(gt[i], gt[i + 1]), True
        extras = extras._replace(nn_a=jnp.asarray(nn_a), nn_b=jnp.asarray(nn_b), nn_mask=jnp.asarray(nn_mask),
                                 nn_rel_pose=jnp.asarray(nn_rel), nn_translation_weight=jnp.full(P, 10.0, jnp.float32),
                                 nn_rotation_weight=jnp.full(P, 10.0, jnp.float32))
    if case in ("ff", "all"):
        extras = extras._replace(ff_mask=jnp.asarray([False, True, True, False, True]), ff_pose=jnp.asarray(gt),
                                 ff_translation_weight=jnp.full(N, 50.0, jnp.float32))
    if case in ("lm", "all"):
        lm_gt = np.array([0.5, 1.0, 0.3], np.float32)
        lm_node, lm_index = np.array([0, 1, 0, 0], np.int32), np.zeros(O, np.int32)
        lm_rel = np.zeros((O, 3), np.float32)
        for i in range(2):
            lm_rel[i] = _rel_pose(gt[i], lm_gt)
        extras = extras._replace(
            landmark_pose=jnp.asarray(np.array([[0.3, 0.7, 0.0], [0.0, 0.0, 0.0]], np.float32)),
            landmark_mask=jnp.asarray([True, False]), lm_node=jnp.asarray(lm_node), lm_index=jnp.asarray(lm_index),
            lm_mask=jnp.asarray([True, True, False, False]), lm_rel_pose=jnp.asarray(lm_rel),
            lm_translation_weight=jnp.full(O, 10.0, jnp.float32), lm_rotation_weight=jnp.full(O, 10.0, jnp.float32))
    return problem, extras, gt


@pytest.mark.parametrize("case", ["nn", "ff", "lm", "all"])
def test_solve_spa_2d_full_matches_jax(case):
    problem, extras, gt = _chain_extras(case)
    want = solve_spa_2d_full(problem, extras, num_iterations=25)
    got = topt.solve_spa_2d_full(convert.spa_problem_2d(problem, CPU), convert.spa_extras_2d(extras, CPU),
                                 num_iterations=25)
    _assert_close(got, want)
    assert topt.LAST_SOLVE_STATS["linear_solver"] == "dense"
    if case == "nn":
        np.testing.assert_allclose(got[1].numpy(), gt, atol=0.02)


def test_solve_spa_2d_full_odometry_chain_at_the_truth():
    """odometry_extras_2d's chain on a generated graph (phase 21's full
    solve, small): the JAX package's solve from the same inputs within
    1e-4, both within 0.01 m of the truth."""
    tproblem, gt, _ = make_scale_spa_problem_2d(60, 6, 150, noise=0.2, seed=5, device=CPU)
    textras = odometry_extras_2d(gt, device=CPU)
    jextras = type(empty_extras_2d(1))(*(jnp.asarray(a.numpy().astype(np.int32) if a.dtype == torch.int64
                                                     else a.numpy()) for a in textras))
    want = solve_spa_2d_full(_jax_problem(tproblem), jextras, num_iterations=10)
    got = topt.solve_spa_2d_full(tproblem, textras, num_iterations=10)
    _assert_close(got, want)
    assert np.linalg.norm(got[1].numpy()[:, :2] - gt[:, :2], axis=1).max() < 0.01


@pytest.mark.parametrize("angle", [0.3, np.pi - 0.01, -np.pi + 0.01])
def test_pair_jacobian_matches_jax_jacfwd(angle):
    """_pair_blocks_2d against jax.jacfwd of the JAX package's residual at
    random poses, with relative angles that cross the +-pi wrap."""
    rng = np.random.default_rng(7)
    b = 16
    a = rng.normal(0, 1.0, (b, 3)).astype(np.float32)
    bb = rng.normal(0, 1.0, (b, 3)).astype(np.float32)
    bb[:, 2] = a[:, 2] + angle + rng.normal(0, 0.005, b).astype(np.float32)
    rel = rng.normal(0, 0.5, (b, 3)).astype(np.float32)
    rel[:, 2] = -angle
    wt, wr = rng.uniform(1, 30, b).astype(np.float32), rng.uniform(1, 30, b).astype(np.float32)

    def one(ai, bi, reli, wti, wri):
        f = lambda d: _relative_residual_2d(ai + d[:3], bi + d[3:], reli, wti, wri)
        return jax.jacfwd(f)(jnp.zeros(6, jnp.float32)), f(jnp.zeros(6, jnp.float32))

    want_j, want_r = jax.vmap(one)(*(jnp.asarray(x) for x in (a, bb, rel, wt, wr)))
    got_j, got_r = topt._pair_blocks_2d(*(torch.from_numpy(x) for x in (a, bb, rel, wt, wr)))
    scale = max(1.0, float(np.abs(want_j).max()))
    np.testing.assert_allclose(got_j.numpy(), np.asarray(want_j), atol=1e-5 * scale, rtol=0)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), atol=1e-5 * scale, rtol=0)
