"""Parity of the port's 3D SPA (hectorgrapher_tpu_torch/mapping/pose_graph/
optimization.py) with the JAX package's, on the CPU with the same inputs:
solve_spa_3d on the chain of tests/test_spa.py, solve_spa_3d_full with each
extras family of tests/test_spa_extras.py and with all of them at once
(IMU accelerations and a free calibration included).

Tolerances: final poses within 1e-4 and the final cost within 1e-4 of the
JAX cost (relative) or 1e-7 (absolute, for costs near zero). Both run the
same LM steps in f32; the Jacobians are the same forward-mode derivatives,
summed in another order, and under the tests' x64 mode (ROADMAP C1) the
JAX solve computes some residuals in float64. A free IMU calibration and
gravity constant are held to 1e-3: the acceleration family observes them
weakly, so the cost is flat along them (with the calibration fixed, the
same case agrees to 1e-7; free, both land on costs equal to 1e-6 that far
apart).

The port's per-family Jacobians are closed forms where the JAX solve takes
jax.jacfwd; test_family_jacobians_match_jax_jacfwd holds each against
jax.jacfwd of the JAX residual within 1e-4 * max(1, max |J|) (f32 closed
forms against f32 forward mode).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hectorgrapher_tpu.mapping.pose_graph.optimization import (
    SpaProblem3D,
    empty_extras_3d,
    solve_spa_3d,
    solve_spa_3d_full,
)
from hectorgrapher_tpu.transform import np_quat as nq
from hectorgrapher_tpu_torch import convert
from hectorgrapher_tpu_torch.mapping.pose_graph import optimization as topt
from test_spa_extras import QI, base_problem
from torch_parity import CPU

torch.set_num_threads(1)


def _assert_close(got, want):
    *got_params, got_cost = got
    *want_params, want_cost = want
    for i, (g, w) in enumerate(zip(got_params, want_params)):
        imu_global = i >= 6  # solve_spa_3d_full's calibration and gravity
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3 if imu_global else 1e-4, rtol=0)
    assert abs(float(got_cost) - float(want_cost)) <= max(1e-4 * abs(float(want_cost)), 1e-7)


def _chain_problem():
    """tests/test_spa.py test_spa_3d_chain_with_loop's problem."""
    S, N, C = 3, 6, 16
    rng = np.random.default_rng(1)
    gt_t = np.array([[i * 0.5, 0, 0] for i in range(6)], np.float32)
    sub_gt_t = gt_t[::2].copy()
    drift = np.cumsum(rng.normal(0, 0.04, size=(6, 3)), axis=0).astype(np.float32)
    node_t = gt_t + drift
    sub_t = sub_gt_t + drift[::2]
    sub_t[0] = sub_gt_t[0]
    cs, cn, crel_t = [], [], []
    for i in range(6):
        cs.append(i // 2)
        cn.append(i)
        crel_t.append(gt_t[i] - sub_gt_t[i // 2])
    for i in range(6):
        si = min(2, (i + 1) // 2)
        cs.append(si)
        cn.append(i)
        crel_t.append(gt_t[i] - sub_gt_t[si])
    pad = C - len(cs)
    return SpaProblem3D(
        submap_translation=jnp.asarray(sub_t),
        submap_rotation=jnp.asarray(np.tile(QI, (S, 1))),
        node_translation=jnp.asarray(node_t),
        node_rotation=jnp.asarray(np.tile(QI, (N, 1))),
        submap_fixed=jnp.asarray([True, False, False]),
        node_fixed=jnp.zeros(N, bool),
        c_submap=jnp.asarray(np.pad(cs, (0, pad)).astype(np.int32)),
        c_node=jnp.asarray(np.pad(cn, (0, pad)).astype(np.int32)),
        c_mask=jnp.asarray(np.pad(np.ones(len(cs), bool), (0, pad))),
        c_rel_translation=jnp.asarray(np.pad(np.asarray(crel_t, np.float32), ((0, pad), (0, 0)))),
        c_rel_rotation=jnp.asarray(np.tile(QI, (C, 1))),
        c_translation_weight=jnp.asarray(np.pad(np.full(len(cs), 20.0), (0, pad)).astype(np.float32)),
        c_rotation_weight=jnp.asarray(np.pad(np.full(len(cs), 20.0), (0, pad)).astype(np.float32)),
        c_huber_scale=jnp.asarray(np.full(C, 1e6, np.float32)),
    )


@pytest.mark.parametrize("huber", [1e6, 0.05])
def test_solve_spa_3d_matches_jax(huber):
    problem = _chain_problem()
    problem = problem._replace(c_huber_scale=jnp.full(16, huber, jnp.float32))
    want = solve_spa_3d(problem, num_iterations=25)
    got = topt.solve_spa_3d(convert.spa_problem_3d(problem, CPU), num_iterations=25)
    _assert_close(got, want)


def test_solve_spa_3d_refuses_cg():
    with pytest.raises(NotImplementedError):
        topt.solve_spa_3d(convert.spa_problem_3d(_chain_problem(), CPU), linear_solver="cg")


def _nn_case():
    S, N, C, P = 1, 5, 8, 8
    rng = np.random.default_rng(0)
    gt = np.array([[0.2 * i, 0, 0] for i in range(N)], np.float32)
    node_t = gt + np.concatenate([[np.zeros(3)], rng.normal(0, 0.1, (N - 1, 3))]).astype(np.float32)
    problem = base_problem(S, N, C, np.zeros((S, 3), np.float32), node_t, [0], [0], [[0, 0, 0]])
    nn_a, nn_b = np.zeros(P, np.int32), np.zeros(P, np.int32)
    nn_rel, nn_mask = np.zeros((P, 3), np.float32), np.zeros(P, bool)
    for i in range(N - 1):
        nn_a[i], nn_b[i], nn_rel[i], nn_mask[i] = i, i + 1, [0.2, 0, 0], True
    extras = empty_extras_3d(N, p=P)._replace(
        nn_a=jnp.asarray(nn_a), nn_b=jnp.asarray(nn_b), nn_mask=jnp.asarray(nn_mask),
        nn_rel_translation=jnp.asarray(nn_rel), nn_translation_weight=jnp.full(P, 10.0, jnp.float32),
        nn_rotation_weight=jnp.full(P, 10.0, jnp.float32),
    )
    return problem, extras, 25


def _ff_case():
    S, N, C = 1, 4, 8
    gt = np.array([[0.5 * i, 0.2, 0] for i in range(N)], np.float32)
    problem = base_problem(S, N, C, np.zeros((S, 3), np.float32), np.zeros((N, 3), np.float32), [0], [0],
                           [[0, 0.2, 0]], w=1.0)
    extras = empty_extras_3d(N)._replace(
        ff_mask=jnp.ones(N, bool), ff_translation=jnp.asarray(gt), ff_translation_weight=jnp.full(N, 50.0, jnp.float32))
    return problem, extras, 20


def _lm_case():
    S, N, C, O = 1, 2, 4, 4
    node_gt = np.array([[0, 0, 0], [1.0, 0, 0]], np.float32)
    lm_gt = np.array([0.5, 1.0, 0.3], np.float32)
    problem = base_problem(S, N, C, np.zeros((S, 3), np.float32), node_gt, [0, 0], [0, 1],
                           [node_gt[0].tolist(), node_gt[1].tolist()], w=100.0)
    lm_node, lm_index = np.zeros(O, np.int32), np.zeros(O, np.int32)
    lm_rel, lm_mask = np.zeros((O, 3), np.float32), np.zeros(O, bool)
    for i in range(2):
        lm_node[i], lm_rel[i], lm_mask[i] = i, lm_gt - node_gt[i], True
    extras = empty_extras_3d(N, l=2, o=O)._replace(
        landmark_translation=jnp.zeros((2, 3), jnp.float32), landmark_mask=jnp.asarray([True, False]),
        lm_node=jnp.asarray(lm_node), lm_index=jnp.asarray(lm_index), lm_mask=jnp.asarray(lm_mask),
        lm_rel_translation=jnp.asarray(lm_rel), lm_translation_weight=jnp.full(O, 10.0, jnp.float32),
        lm_rotation_weight=jnp.full(O, 10.0, jnp.float32),
    )
    return problem, extras, 25


def _imu_rotation_delta(gt_q, n):
    dq = np.tile(QI, (n, 1))
    for i in range(len(gt_q) - 1):
        dq[i] = nq.quat_multiply(nq.quat_conjugate(gt_q[i]), gt_q[i + 1])
    return dq


def _ir_case():
    S, N, C, R = 1, 4, 8, 4
    gt_t = np.array([[0.3 * i, 0, 0] for i in range(N)], np.float32)
    gt_q = np.stack([nq.quat_from_axis_angle(np.array([0, 0, 0.1 * i])) for i in range(N)]).astype(np.float32)
    rng = np.random.default_rng(0)
    init_q = gt_q.copy()
    for i in range(1, N):
        init_q[i] = nq.quat_multiply(gt_q[i], nq.quat_from_axis_angle(rng.normal(0, 0.05, 3))).astype(np.float32)
    problem = base_problem(S, N, C, np.zeros((S, 3), np.float32), gt_t, [0], [0], [[0, 0, 0]], w=100.0)
    problem = problem._replace(node_rotation=jnp.asarray(init_q))
    mask = np.arange(R) < N - 1
    extras = empty_extras_3d(N, r=R)._replace(
        ir_a=jnp.asarray(np.where(mask, np.arange(R), 0).astype(np.int32)),
        ir_b=jnp.asarray(np.where(mask, np.arange(R) + 1, 0).astype(np.int32)),
        ir_mask=jnp.asarray(mask), ir_delta_rotation=jnp.asarray(_imu_rotation_delta(gt_q, R)),
        ir_weight=jnp.full(R, 50.0, jnp.float32), traj_mask=jnp.asarray([True]), calibration_fixed=jnp.asarray(True),
    )
    return problem, extras, 30


def _all_case():
    """Every family at once: submap-node, node-node, fixed-frame, landmark,
    IMU rotation and acceleration, with the calibration free."""
    S, N, C = 2, 6, 8
    rng = np.random.default_rng(5)
    dt = 0.1
    gt_t = np.array([[0.05 * i * i, 0.02 * i, 0.0] for i in range(N)], np.float32)
    gt_q = np.stack([nq.quat_from_axis_angle(np.array([0, 0, 0.05 * i])) for i in range(N)]).astype(np.float32)
    node_t = gt_t + rng.normal(0, 0.02, (N, 3)).astype(np.float32)
    problem = base_problem(S, N, C, np.array([[0, 0, 0], [0.5, 0, 0]], np.float32), node_t, [0, 0, 1, 1],
                           [0, 1, 4, 5], [gt_t[0], gt_t[1], gt_t[4] - [0.5, 0, 0], gt_t[5] - [0.5, 0, 0]], w=50.0)
    problem = problem._replace(node_rotation=jnp.asarray(gt_q))
    ex = {k: np.array(v) for k, v in empty_extras_3d(N, p=8, l=1, o=4, r=8, a=8, tj=1)._asdict().items()}
    for i in range(N - 1):
        rel = nq.quat_multiply(nq.quat_conjugate(gt_q[i]), gt_q[i + 1])
        ex["nn_a"][i], ex["nn_b"][i], ex["nn_mask"][i] = i, i + 1, True
        ex["nn_rel_translation"][i] = nq.quat_rotate(nq.quat_conjugate(gt_q[i]), gt_t[i + 1] - gt_t[i])
        ex["nn_rel_rotation"][i] = rel
        ex["nn_translation_weight"][i] = ex["nn_rotation_weight"][i] = 5.0
        ex["ir_a"][i], ex["ir_b"][i], ex["ir_mask"][i] = i, i + 1, True
        ex["ir_delta_rotation"][i] = rel
        ex["ir_weight"][i] = 20.0
    for i in range(N - 2):
        # Constant acceleration along x: the IMU measures gravity plus it.
        dv_world = (gt_t[i + 2] - gt_t[i + 1]) / dt - (gt_t[i + 1] - gt_t[i]) / dt + [0, 0, 9.80665 * dt]
        ex["ia_a"][i], ex["ia_b"][i], ex["ia_c"][i], ex["ia_mask"][i] = i, i + 1, i + 2, True
        ex["ia_delta_velocity"][i] = nq.quat_rotate(nq.quat_conjugate(gt_q[i + 1]), dv_world)
        ex["ia_dt1"][i] = ex["ia_dt2"][i] = dt
        ex["ia_weight"][i] = 2.0
    ex["ff_mask"][2], ex["ff_translation"][2], ex["ff_translation_weight"][2] = True, gt_t[2], 10.0
    lm_gt = np.array([0.5, 1.0, 0.3], np.float32)
    for i in range(2):
        ex["lm_node"][i], ex["lm_mask"][i] = 2 * i, True
        ex["lm_rel_translation"][i] = nq.quat_rotate(nq.quat_conjugate(gt_q[2 * i]), lm_gt - gt_t[2 * i])
        ex["lm_rel_rotation"][i] = nq.quat_conjugate(gt_q[2 * i])
        ex["lm_translation_weight"][i] = ex["lm_rotation_weight"][i] = 10.0
    ex["landmark_mask"][0] = True
    ex["traj_mask"][0] = True
    ex["traj_calibration"][0] = nq.quat_from_axis_angle(np.array([0.01, -0.02, 0.0]))
    ex["traj_gravity"][0] = 9.7
    ex["calibration_fixed"] = np.asarray(False)
    extras = type(empty_extras_3d(1))(**{k: jnp.asarray(v) for k, v in ex.items()})
    return problem, extras, 30


@pytest.mark.parametrize("case", ["nn", "ff", "lm", "ir", "all"])
def test_solve_spa_3d_full_matches_jax(case):
    problem, extras, iterations = {"nn": _nn_case, "ff": _ff_case, "lm": _lm_case, "ir": _ir_case,
                                   "all": _all_case}[case]()
    want = solve_spa_3d_full(problem, extras, num_iterations=iterations)
    got = topt.solve_spa_3d_full(convert.spa_problem_3d(problem, CPU), convert.spa_extras_3d(extras, CPU),
                                 num_iterations=iterations)
    assert all(g.dtype == torch.float32 for g in got)
    _assert_close(got, want)


def _random_quats(rng, n, scale):
    return np.stack([nq.quat_from_axis_angle(rng.normal(0, scale, 3)) for _ in range(n)]).astype(np.float32)


def _jax_family_jacobians(inputs):
    """jax.jacfwd of the residuals of solve_spa_3d_full's family_blocks
    (optimization.py :659-668, :768-778, :804-815), transcribed per block
    and vmapped over the batch."""
    import jax

    from hectorgrapher_tpu.mapping.pose_graph.optimization import _relative_residual_3d
    from hectorgrapher_tpu.transform.rigid import (quat_conjugate, quat_from_axis_angle, quat_multiply,
                                                   quat_normalize, quat_rotate)

    def boxplus_q(q, d):
        return quat_normalize(quat_multiply(q, quat_from_axis_angle(d)))

    def pair(a_t, a_q, b_t, b_q, rel_t, rel_q, wt, wr):
        local = lambda d: _relative_residual_3d(a_t + d[:3], boxplus_q(a_q, d[3:6]), b_t + d[6:9],
                                                boxplus_q(b_q, d[9:12]), rel_t, rel_q, wt, wr)
        return jax.jacfwd(local)(jnp.zeros(12, jnp.float32)), local(jnp.zeros(12, jnp.float32))

    def rot(qa, qb, c, dr, w):
        def local(d):
            a, b, cc = boxplus_q(qa, d[:3]), boxplus_q(qb, d[3:6]), boxplus_q(c, d[6:9])
            err = quat_multiply(quat_multiply(quat_conjugate(b), a), quat_multiply(quat_multiply(cc, dr),
                                                                                  quat_conjugate(cc)))
            return w * err[1:]
        return jax.jacfwd(local)(jnp.zeros(9, jnp.float32)), local(jnp.zeros(9, jnp.float32))

    def acc(qb, ta, tb, tc, g, c, dv, dt1, dt2, w):
        def local(d):
            b, cal = boxplus_q(qb, d[:3]), boxplus_q(c, d[13:16])
            imu_dv = quat_rotate(b, quat_rotate(cal, dv)) - (g + d[12]) * (0.5 * (dt1 + dt2)) * jnp.asarray(
                [0.0, 0.0, 1.0])
            fd_dv = (tc + d[9:12] - tb - d[6:9]) / dt2 - (tb + d[6:9] - ta - d[3:6]) / dt1
            return w * (imu_dv - fd_dv)
        return jax.jacfwd(local)(jnp.zeros(16, jnp.float32)), local(jnp.zeros(16, jnp.float32))

    fns = {"pair": pair, "rot": rot, "acc": acc}
    return {k: jax.vmap(fns[k])(*(jnp.asarray(a) for a in args)) for k, args in inputs.items()}


@pytest.mark.parametrize("angle", [0.02, 0.8])  # the Taylor and the closed branch of Jr^-1
def test_family_jacobians_match_jax_jacfwd(angle):
    """The closed-form Jacobians of the pair (submap-node, node-node,
    landmark), IMU rotation and IMU acceleration families against JAX's
    forward-mode ones at random states, within 1e-4 * max(1, max |J|)."""
    rng = np.random.default_rng(7)
    b = 16
    vec = lambda s=1.0: rng.normal(0, s, (b, 3)).astype(np.float32)
    pos = lambda lo, hi: rng.uniform(lo, hi, b).astype(np.float32)
    inputs = {
        "pair": (vec(), _random_quats(rng, b, 1.0), vec(), _random_quats(rng, b, 1.0), vec(),
                 _random_quats(rng, b, angle), pos(1, 100), pos(1, 100)),
        "rot": (_random_quats(rng, b, 1.0), _random_quats(rng, b, 1.0), _random_quats(rng, b, 0.05),
                _random_quats(rng, b, angle), pos(1, 50)),
        "acc": (_random_quats(rng, b, 1.0), vec(), vec(), vec(), pos(9.7, 9.9), _random_quats(rng, b, 0.05),
                vec(), pos(0.05, 0.2), pos(0.05, 0.2), pos(1, 10)),
    }
    # The pair family's rotation error at the requested angle: b = a rel exp(angle).
    a_q, rel_q = inputs["pair"][1], inputs["pair"][5]
    inputs["pair"] = inputs["pair"][:3] + (np.stack([nq.quat_multiply(nq.quat_multiply(a, r), e) for a, r, e in zip(
        a_q, rel_q, _random_quats(rng, b, angle))]).astype(np.float32),) + inputs["pair"][4:]
    want = _jax_family_jacobians(inputs)
    fns = {"pair": topt._pair_blocks, "rot": topt._imu_rotation_blocks, "acc": topt._imu_acceleration_blocks}
    for name, args in inputs.items():
        J, r = fns[name](*(torch.from_numpy(np.asarray(a)) for a in args))
        wJ, wr = (np.asarray(x) for x in want[name])
        assert J.dtype == torch.float32 and J.shape == wJ.shape
        np.testing.assert_allclose(r.numpy(), wr, rtol=0, atol=1e-5 * max(1.0, float(np.abs(wr).max())))
        np.testing.assert_allclose(J.numpy(), wJ, rtol=0, atol=1e-4 * max(1.0, float(np.abs(wJ).max())))
