"""The port's generic LM solver (hectorgrapher_tpu_torch/solvers/
gauss_newton.py) against the JAX package's, on the CPU: the cases of
tests/test_solvers.py through both packages, huber_weights and the three
retractions.

Tolerances: solutions within 1e-5 of JAX's (both solve in float32, the
Jacobians by forward mode), iteration counts equal, and each case's own
bounds from tests/test_solvers.py on the port's result. One count is not
compared: in the fixed-mask case the second step's accept test is a tie
to one ulp of the cost (2.42 against 2.42 + 1e-7), which XLA-CPU's fused
multiply-add in 0.5 * sum(r * r) breaks one way and the port's separate
roundings the other (ROADMAP C0): JAX takes one more step of 4.4e-5, so
there the solutions are held within 1e-4 and both meet the case's bounds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hectorgrapher_tpu.solvers import gauss_newton as jgn
from hectorgrapher_tpu.transform.rigid import Rigid2 as JRigid2
from hectorgrapher_tpu.transform.rigid import Rigid3 as JRigid3
from hectorgrapher_tpu_torch.solvers import gauss_newton as tgn
from hectorgrapher_tpu_torch.transform.rigid import Rigid2, Rigid3

TOL = 1e-5


def _rosenbrock(xp):
    def residual(x):
        return xp.stack([10.0 * (x[1] - x[0] ** 2), 1.0 - x[0]])

    return residual


def _inconsistent(xp):
    def residual(x):
        return xp.stack([x[0] - 1.0, x[1] - 2.0, x[0] + x[1] - 3.5])

    return residual


# (name, residual maker, x0, keyword arguments, port-side checks of tests/test_solvers.py)
CASES = {
    "converges": (_rosenbrock, [-1.2, 1.0], dict(num_iterations=200),
                  lambda r: np.testing.assert_allclose(r.x.numpy(), [1.0, 1.0], atol=1e-3)
                  or float(r.final_cost) < 1e-8),
    "stops_early_at_nonzero_optimum": (_inconsistent, [0.0, 0.0], dict(num_iterations=200),
                                       lambda r: np.testing.assert_allclose(r.x.numpy(), [1.1667, 2.1667], atol=1e-3)
                                       or r.num_iterations < 50),
    "zero_tolerance_runs_full_count": (_rosenbrock, [-1.2, 1.0],
                                       dict(num_iterations=30, function_tolerance=0.0, parameter_tolerance=0.0),
                                       lambda r: r.num_iterations == 30),
    "fixed_mask_freezes_coordinates": (_rosenbrock, [-1.2, 1.0], dict(num_iterations=100, fixed_mask=[True, False]),
                                       lambda r: abs(float(r.x[0]) + 1.2) < 1e-6 and abs(float(r.x[1]) - 1.44) < 1e-3),
}


COST_TIES = {"fixed_mask_freezes_coordinates"}  # see the module docstring


@pytest.mark.parametrize("case", sorted(CASES))
def test_levenberg_marquardt_matches_jax(case):
    make, x0, kw, check = CASES[case]
    jkw = dict(kw, fixed_mask=jnp.asarray(kw["fixed_mask"])) if "fixed_mask" in kw else kw
    tkw = dict(kw, fixed_mask=torch.tensor(kw["fixed_mask"])) if "fixed_mask" in kw else kw
    want = jgn.levenberg_marquardt(make(jnp), jnp.asarray(x0, jnp.float32), jgn.retract_euclidean, tangent_dim=2,
                                   **jkw)
    got = tgn.levenberg_marquardt(make(torch), torch.tensor(x0, dtype=torch.float32), tgn.retract_euclidean,
                                  tangent_dim=2, **tkw)
    assert got.x.dtype == torch.float32
    if case not in COST_TIES:
        assert got.num_iterations == int(want.num_iterations)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=1e-4 if case in COST_TIES else TOL)
    np.testing.assert_allclose(float(got.final_cost), float(want.final_cost), rtol=1e-4, atol=1e-9)
    np.testing.assert_allclose(float(got.initial_cost), float(want.initial_cost), rtol=1e-6)
    assert check(got)


def test_huber_weights_match_jax():
    r = np.random.default_rng(0).normal(0.0, 2.0, 64).astype(np.float32)
    r[:3] = (0.0, 1.0, -1.0)  # zero and the threshold itself
    want = np.asarray(jgn.huber_weights(jnp.asarray(r), 1.0))
    got = tgn.huber_weights(torch.from_numpy(r), 1.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_retractions_match_jax():
    rng = np.random.default_rng(1)
    delta = rng.normal(0.0, 0.3, 6).astype(np.float32)
    x = rng.normal(size=4).astype(np.float32)
    np.testing.assert_allclose(tgn.retract_euclidean(torch.from_numpy(x), torch.from_numpy(delta[:4])).numpy(),
                               np.asarray(jgn.retract_euclidean(jnp.asarray(x), jnp.asarray(delta[:4]))), rtol=1e-7)

    t2, a2 = rng.normal(size=2).astype(np.float32), np.float32(0.4)
    got2 = tgn.make_pose2_retract()(Rigid2(torch.from_numpy(t2), torch.tensor(a2)), torch.from_numpy(delta[:3]))
    want2 = jgn.make_pose2_retract()(JRigid2(jnp.asarray(t2), jnp.asarray(a2)), jnp.asarray(delta[:3]))
    np.testing.assert_allclose(got2.translation.numpy(), np.asarray(want2.translation), rtol=1e-7)
    np.testing.assert_allclose(float(got2.angle), float(want2.angle), rtol=1e-7)

    q = rng.normal(size=4).astype(np.float32)
    q /= np.linalg.norm(q)
    t3 = rng.normal(size=3).astype(np.float32)
    for d in (delta, np.zeros(6, np.float32), np.full(6, 1e-7, np.float32)):  # the Taylor branch near zero too
        got3 = tgn.make_pose3_retract()(Rigid3(torch.from_numpy(t3), torch.from_numpy(q)), torch.from_numpy(d))
        want3 = jgn.make_pose3_retract()(JRigid3(jnp.asarray(t3), jnp.asarray(q)), jnp.asarray(d))
        np.testing.assert_allclose(got3.translation.numpy(), np.asarray(want3.translation), rtol=1e-7)
        np.testing.assert_allclose(got3.rotation.numpy(), np.asarray(want3.rotation), atol=1e-7)


def test_pose3_solve_matches_jax():
    """A pose fitted to point pairs through the Rigid3 retraction: jacfwd
    over a NamedTuple, a 6-dim tangent, a Huber-weighted residual."""
    rng = np.random.default_rng(2)
    src = rng.normal(size=(20, 3)).astype(np.float32)
    angle = 0.3
    rot = np.array([[np.cos(angle), -np.sin(angle), 0], [np.sin(angle), np.cos(angle), 0], [0, 0, 1]])
    dst = (src @ rot.T + np.array([0.5, -0.2, 0.1]) + rng.normal(0, 0.01, (20, 3))).astype(np.float32)
    dst[0] += 3.0  # an outlier for the Huber weights

    from hectorgrapher_tpu.transform.rigid import quat_rotate as jrot
    from hectorgrapher_tpu_torch.transform.rigid import quat_rotate as trot

    def residual(xp, rotate, huber, s, d):
        def f(x):
            r = rotate(x.rotation[None, :], s) + x.translation[None, :] - d
            return r * huber(r, 0.1)

        return f

    x0 = (np.zeros(3, np.float32), np.array([1.0, 0.0, 0.0, 0.0], np.float32))
    want = jgn.levenberg_marquardt(residual(jnp, jrot, jgn.huber_weights, jnp.asarray(src), jnp.asarray(dst)),
                                   JRigid3(*map(jnp.asarray, x0)), jgn.make_pose3_retract(), tangent_dim=6,
                                   num_iterations=100)
    got = tgn.levenberg_marquardt(residual(torch, trot, tgn.huber_weights, torch.from_numpy(src),
                                           torch.from_numpy(dst)),
                                  Rigid3(*map(torch.from_numpy, x0)), tgn.make_pose3_retract(), tangent_dim=6,
                                  num_iterations=100)
    assert isinstance(got.x, Rigid3)
    assert got.num_iterations == int(want.num_iterations)
    np.testing.assert_allclose(got.x.translation.numpy(), np.asarray(want.x.translation), atol=TOL)
    np.testing.assert_allclose(got.x.rotation.numpy(), np.asarray(want.x.rotation), atol=TOL)
    np.testing.assert_allclose(got.x.translation.numpy(), [0.5, -0.2, 0.1], atol=0.02)
