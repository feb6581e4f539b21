"""Parity of the port's per-point CT window family, DIRECT IMU term,
batched window solve and unwarp_and_accumulate (hectorgrapher_tpu_torch
mapping/ct/window_solver.py, K3's per-point mode in ops/ct_scan_block.py)
with the JAX package's, on the CPU with the same seeded inputs; the port's
kernel wrappers take their plain versions on CPU tensors.

Tolerances, each with its reason:
  * brackets: exact (the same search over the same f32 times); factors
    within 1e-6 (the same f32 divide);
  * per-point poses: the pose within 1e-6 (the same slerp; acos, sin and
    cos in f64 rounded once, where JAX evaluates them in f32), its 4 x 6
    Jacobian within 1e-5 of jax.jacfwd;
  * normal equations: 1e-5 * max(1, max|JtJ|), as the per-scan family —
    sums over the points in another order;
  * solves: state within 1e-5 and cost within 1e-5 relative, as
    tests/test_torch_ct_window.py test_solve_matches_jax;
  * batched solve: each lane within 1e-5 of the JAX batched solve's lane
    and of the port's single solve of that window (one batched LU rounds
    like another);
  * unwarp_and_accumulate: 1e-5 m (the same f32 slerp and rotations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hectorgrapher_tpu.mapping.ct import window_solver as jws
from hectorgrapher_tpu.transform import rigid as jr
from hectorgrapher_tpu_torch import convert
from hectorgrapher_tpu_torch.mapping.ct import window_solver as tws
from hectorgrapher_tpu_torch.mapping.scan_matching import interpolated_grid as tig
from hectorgrapher_tpu_torch.ops import ct_scan_block as k3
from hectorgrapher_tpu_torch.solvers.gauss_newton import lm_drive
from torch_parity import CPU, ct_example, direct_payload, rotated_state

torch.set_num_threads(1)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=tol)


def _port(hi, lo, problem, state, weights):
    grids = tuple(tig.prepare_grid_3d(convert.grid_3d(g, CPU)) for g in (hi, lo))
    return grids, convert.ct_problem(problem, CPU), convert.ct_state(state, CPU), convert.ct_weights(weights, CPU)


@pytest.fixture(scope="module", params=["TSDF", "PROBABILITY_GRID", "TSDF_F16"])
def example(request):
    """The CT fixture (grid 32, K=8, C=8, P=256, per-point sweep times over
    [-0.05, 0.049] s) on TSDF, occupancy and float16 TSDF grids."""
    grid_type = "TSDF" if request.param == "TSDF_F16" else request.param
    hi, lo, problem, state, weights = ct_example(grid=32, grid_type=grid_type)
    if request.param == "TSDF_F16":
        hi, lo = (g._replace(tsd=g.tsd.astype(jnp.float16), weight=g.weight.astype(jnp.float16)) for g in (hi, lo))
    return (hi, lo, problem, state, weights), _port(hi, lo, problem, state, weights), grid_type == "TSDF"


def _edge_problem(problem):
    """The fixture's problem with control points 6 and 7 masked and cloud
    times shifted so that points fall before control point 0 and after the
    last valid one."""
    cp_mask = np.ones(8, bool)
    cp_mask[6:] = False
    return problem._replace(cp_mask=jnp.asarray(cp_mask), cloud_time=problem.cloud_time - 0.08)


@pytest.mark.parametrize("case", ["fixture", "edges"])
def test_per_point_brackets_match_jax(case):
    _, _, problem, _, _ = ct_example(grid=32)
    if case == "edges":
        problem = _edge_problem(problem)
    tproblem = convert.ct_problem(problem, CPU)
    for times, ttimes in ((problem.hi_times, tproblem.hi_times), (problem.lo_times, tproblem.lo_times)):
        want = jws.per_point_brackets(problem, times)
        got = tws.per_point_brackets(tproblem, ttimes)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        _close(got[2], want[2], 1e-6)
    if case == "edges":
        prv, nxt, f = (x.numpy() for x in tws.per_point_brackets(tproblem, tproblem.hi_times))
        abs_t = (tproblem.cloud_time[:, None] + tproblem.hi_times).numpy()
        assert (abs_t < 0).any() and (f[abs_t < 0] == 0).all()  # before control point 0: clipped to 0
        assert (nxt == 6).any() and f[nxt == 6].max() == 0.0  # after the last valid one: its masked neighbour


@pytest.mark.parametrize("rotated", [False, True], ids=["entry", "rotated"])
def test_point_poses_match_jacfwd(rotated):
    """K3 per-point mode's pose and 4 x 6 rotation Jacobian
    (point_poses_from_terms of pair_terms)
    against window_solver.py point_scan_block's _quat_of and its jacfwd,
    on the lerp branch (identity rotations) and the slerp branch."""
    _, _, problem, state, _ = ct_example(grid=32)
    if rotated:
        state = rotated_state(state, 21)
    prv, _, f = jws.per_point_brackets(problem, problem.hi_times)
    prv, f = prv.reshape(-1), f.reshape(-1)
    nxt = prv + 1

    def quat_of(qp, qn, f_, d6):
        q0 = jr.quat_multiply(qp, jr.quat_from_axis_angle(d6[:3]))
        q1 = jr.quat_multiply(qn, jr.quat_from_axis_angle(d6[3:6]))
        return jr.quat_normalize(jr.quat_slerp(q0, q1, f_))

    z6 = jnp.zeros(6, jnp.float32)
    args = (state.rotation[prv], state.rotation[nxt], f)
    want_q = np.asarray(jax.vmap(quat_of, in_axes=(0, 0, 0, None))(*args, z6))
    want_dq = np.asarray(jax.vmap(jax.jacfwd(quat_of, argnums=3), in_axes=(0, 0, 0, None))(*args, z6))
    cp7 = torch.from_numpy(np.concatenate([np.asarray(state.translation), np.asarray(state.rotation)], axis=1))
    terms = k3.pair_terms(cp7[torch.from_numpy(np.array(prv))], cp7[torch.from_numpy(np.array(nxt))])
    t, q, dq = k3.point_poses_from_terms(terms, torch.from_numpy(np.array(f)))
    tp, tn = np.asarray(state.translation)[np.asarray(prv)], np.asarray(state.translation)[np.asarray(nxt)]
    _close(t, tp + np.asarray(f)[:, None] * (tn - tp), 1e-6)
    _close(q, want_q, 1e-6)
    _close(dq.transpose(1, 2), want_dq, 1e-5)


def _direct(direct, state):
    return direct_payload(state.translation.shape[0]) if direct else (None, None)


@pytest.mark.parametrize("direct", [False, True], ids=["preint", "direct"])
@pytest.mark.parametrize("rotated", [False, True], ids=["entry", "rotated"])
def test_normal_equations_per_point_match_jax(example, rotated, direct):
    (hi, lo, problem, state, weights), (grids, tproblem, tstate, tweights), is_tsdf = example
    if rotated:  # the slerp branch
        state = rotated_state(state, 13)
        tstate = convert.ct_state(state, CPU)
    jdirect, tdirect = _direct(direct, state)
    want = [np.asarray(x) for x in jws.ct_normal_equations(hi, lo, problem, state, weights, is_tsdf=is_tsdf,
                                                           per_point=True, direct=jdirect)]
    got = [x.numpy() for x in tws.ct_normal_equations(*grids, tproblem, tstate, tweights, is_tsdf=is_tsdf,
                                                      per_point=True, direct=tdirect)]
    tol = 1e-5 * max(1.0, float(np.abs(want[0]).max()))
    _close(got[0], want[0], tol)
    _close(got[1], want[1], tol)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5)


def test_normal_equations_direct_per_scan_match_jax():
    """The DIRECT term beside the per-cloud family, over the edge problem
    (masked control points: their pairs carry no samples)."""
    hi, lo, problem, state, weights = ct_example(grid=32)
    problem = _edge_problem(problem)
    state = rotated_state(state, 14)
    grids, tproblem, tstate, tweights = _port(hi, lo, problem, state, weights)
    jdirect, tdirect = direct_payload(8)
    want = [np.asarray(x) for x in jws.ct_normal_equations(hi, lo, problem, state, weights, is_tsdf=True,
                                                           direct=jdirect)]
    got = [x.numpy() for x in tws.ct_normal_equations(*grids, tproblem, tstate, tweights, is_tsdf=True,
                                                      direct=tdirect)]
    tol = 1e-5 * max(1.0, float(np.abs(want[0]).max()))
    _close(got[0], want[0], tol)
    _close(got[1], want[1], tol)


@pytest.mark.parametrize("per_point,direct", [(True, False), (False, True), (True, True)],
                         ids=["per_point", "direct", "per_point_direct"])
def test_solve_per_point_and_direct_match_jax(per_point, direct):
    hi, lo, problem, state, weights = ct_example(grid=32)
    _, tproblem, tstate, tweights = _port(hi, lo, problem, state, weights)
    jdirect, tdirect = _direct(direct, state)
    js, jf, ji = jws.solve_ct_window(hi, lo, problem, state, weights, is_tsdf=True, num_iterations=8,
                                     per_point=per_point, direct=jdirect)
    raw = tuple(convert.grid_3d(g, CPU) for g in (hi, lo))
    before = tws.solve_ct_window.assemblies
    ts, tf, ti = tws.solve_ct_window(*raw, tproblem, tstate, tweights, is_tsdf=True, num_iterations=8,
                                     per_point=per_point, direct=tdirect)
    assert tws.solve_ct_window.assemblies - before == 9
    assert float(tf) < float(ti)
    np.testing.assert_allclose(float(ti), float(ji), rtol=1e-5)
    np.testing.assert_allclose(float(tf), float(jf), rtol=1e-5)
    for got, want in zip(ts, js):
        _close(got, want, 1e-5)


def _lanes(state):
    """Three windows: the fixture's state, rotated, and shifted 3 cm."""
    return [state, rotated_state(state, 5, 0.02), state._replace(translation=state.translation + 0.03)]


@pytest.mark.parametrize("per_point,direct", [(False, False), (True, False), (True, True)],
                         ids=["per_scan", "per_point", "per_point_direct"])
def test_solve_batched_matches_jax_and_single(per_point, direct):
    """solve_ct_window_batched at B = 3 against the JAX package's batched
    solve and against the port's single solve of each window; every lane
    keeps its own LM state. The slotted K3 (here its plain version) runs
    once per batched assembly."""
    hi, lo, problem, state, weights = ct_example(grid=32)
    b = 3
    states = _lanes(state)
    stack = lambda *x: jnp.stack(x)
    jdirect, tdirect = _direct(direct, state)
    js, jf, ji = jws.solve_ct_window_batched(
        jax.tree.map(lambda x: stack(*[x] * b), hi), jax.tree.map(lambda x: stack(*[x] * b), lo),
        jax.tree.map(lambda x: stack(*[x] * b), problem), jax.tree.map(stack, *states), weights, is_tsdf=True,
        num_iterations=8, per_point=per_point,
        directs=None if jdirect is None else jax.tree.map(lambda x: stack(*[x] * b), jdirect))
    raw = tuple(convert.grid_3d(g, CPU) for g in (hi, lo))
    _, tproblem, _, tweights = _port(hi, lo, problem, state, weights)
    tstates = [convert.ct_state(s, CPU) for s in states]
    batch = lambda items, cls: cls(*(torch.stack(list(v)) for v in zip(*items)))
    tdirects = None if tdirect is None else batch([tdirect] * b, tws.DirectImuData)
    before = tws.solve_ct_window_batched.assemblies
    gs, gf, gi = tws.solve_ct_window_batched([raw[0]] * b, [raw[1]] * b, batch([tproblem] * b, tws.CtProblem),
                                             batch(tstates, tws.CtState), tweights, is_tsdf=True, num_iterations=8,
                                             per_point=per_point, directs=tdirects)
    assert tws.solve_ct_window_batched.assemblies - before == 9
    np.testing.assert_allclose(gf.numpy(), np.asarray(jf), rtol=1e-5)
    np.testing.assert_allclose(gi.numpy(), np.asarray(ji), rtol=1e-5)
    for got, want in zip(gs, js):
        _close(got, want, 1e-5)
    for lane in range(b):
        s1, f1, _ = tws.solve_ct_window(*raw, tproblem, tstates[lane], tweights, is_tsdf=True, num_iterations=8,
                                        per_point=per_point, direct=tdirect)
        np.testing.assert_allclose(float(gf[lane]), float(f1), rtol=1e-5)
        for got, want in zip(gs, s1):
            _close(got[lane], want, 1e-5)


@pytest.mark.parametrize("stop_on_host", [False, True])
def test_lm_drive_batched_freezes_finished_lanes(stop_on_host):
    """lm_drive with a (3,) cost over three independent quadratic problems with
    different curvatures (one converges in a step, one never accepts a
    step at a huge damping, one takes several) equals lm_drive run on
    each alone: per-lane damping, accept and done flags, with the stop
    test on the device or on the host."""
    targets = torch.tensor([[1.0, -2.0], [0.5, 0.25], [3.0, 1.0]])
    curv = torch.tensor([1.0, 1e-3, 10.0])

    def eval_one(x, target, c):
        r = torch.sqrt(c) * (x - target)
        return (c * torch.eye(2), c * (x - target)), 0.5 * torch.sum(r * r)

    def delta_of(quant, lam):
        jtj, g = quant
        return -torch.linalg.solve(jtj + lam[..., None, None] * torch.eye(2), g)

    def eval_batched(x):
        jtj = curv[:, None, None] * torch.eye(2)
        g = curv[:, None] * (x - targets)
        return (jtj, g), 0.5 * torch.sum(curv[:, None] * (x - targets) ** 2, dim=1)

    x0 = torch.zeros(3, 2)
    xs, costs, costs0 = lm_drive(eval_batched, delta_of, lambda x, d: x + d, x0, 6, init_lambda=1e-4,
                                 stop_on_host=stop_on_host)
    for lane in range(3):
        x1, c1, c01 = lm_drive(lambda x: eval_one(x, targets[lane], curv[lane]),
                               lambda q, lam: delta_of(q, lam.reshape(())), lambda x, d: x + d, x0[lane], 6,
                               init_lambda=1e-4, stop_on_host=stop_on_host)
        torch.testing.assert_close(xs[lane], x1, rtol=0, atol=1e-6)
        torch.testing.assert_close(costs[lane], c1, rtol=1e-6, atol=0)
        torch.testing.assert_close(costs0[lane], c01)


def test_unwarp_and_accumulate_matches_jax():
    hi, lo, problem, state, weights = ct_example(grid=32)
    state = rotated_state(state, 9)
    _, tproblem, tstate, _ = _port(hi, lo, problem, state, weights)
    rng = np.random.default_rng(4)
    mask = rng.uniform(size=problem.hi_mask.shape) < 0.8
    pose_t = np.array([0.2, -0.1, 0.05], np.float32)
    pose_q = np.asarray(jr.quat_from_axis_angle(jnp.asarray([0.01, -0.02, 0.3], jnp.float32)))
    want = jws.unwarp_and_accumulate(state, jnp.asarray(pose_t), jnp.asarray(pose_q), problem.hi_points,
                                     jnp.asarray(mask), problem.cloud_prev, problem.cloud_next, problem.cloud_factor)
    got = tws.unwarp_and_accumulate(tstate, torch.tensor(pose_t), torch.tensor(pose_q), tproblem.hi_points,
                                    torch.from_numpy(mask), tproblem.cloud_prev, tproblem.cloud_next,
                                    tproblem.cloud_factor)
    _close(got, want, 1e-5)
    assert not got.numpy()[~mask].any()


def test_point_plan_segments():
    """point_plan sorts a window's kept points by pair: contiguous
    segments, the dropped (zero-scale) points past every segment, an empty
    pair an empty segment; a batch's windows keep their own segments, and
    window_plan cuts one window's plan back out of it."""
    _, _, problem, state, weights = ct_example(grid=32)
    problem = _edge_problem(problem)
    tproblem, tweights = convert.ct_problem(problem, CPU), convert.ct_weights(weights, CPU)
    hi_mask = tproblem.hi_mask.clone()
    hi_mask[:, ::3] = False
    tproblem = tproblem._replace(hi_mask=hi_mask)
    plan = tws.problem_plan(tproblem, tweights)
    k1 = plan.k - 1
    m = int(plan.starts[-1])
    assert m == int(hi_mask.sum() + tproblem.lo_mask.sum())
    assert bool((plan.scale[:m] != 0).all()) and bool((plan.scale[m:] == 0).all())
    assert bool((plan.pair[:m] == torch.repeat_interleave(torch.arange(k1), torch.diff(plan.starts))).all())
    assert int(torch.diff(plan.starts)[6]) == 0  # the pair of two masked control points
    batch = tws.CtProblem(*(torch.stack([x, x]) for x in tproblem))
    plan2 = tws.problem_plan(batch, tweights)
    assert plan2.segments == 2 * k1
    for b in range(2):
        one = k3.window_plan(plan2, b)
        for got, want in zip(one[:6], plan[:6]):
            assert torch.equal(got[:m] if got.dim() and got.shape[0] > k1 + 1 else got,
                               want[:m] if want.dim() and want.shape[0] > k1 + 1 else want)


def test_scan_block_points_slots_plain_is_per_window(example):
    """The slotted plain version over two windows and two grid pairs is
    the single plain version of each window against its own pair."""
    (hi, lo, problem, state, weights), (grids, tproblem, tstate, tweights), _ = example
    tstate2 = convert.ct_state(rotated_state(state, 15), CPU)
    batch = tws.CtProblem(*(torch.stack([x, x]) for x in tproblem))
    plan = tws.problem_plan(batch, tweights)
    cp7 = torch.cat([torch.cat([s.translation, s.rotation], dim=-1) for s in (tstate, tstate2)])
    other = tuple(g._replace(**{f: getattr(g, f) * 0.5 for f in ("tsd", "prob") if hasattr(g, f)}) for g in grids)
    slots = k3.grid_slots([grids[0], other[0]], [grids[1], other[1]])
    got = k3.ct_scan_block_points_slots(slots, torch.tensor([0, 1], dtype=torch.int32), plan, cp7)
    for b, (g_hi, g_lo) in enumerate((grids, other)):
        want = k3.ct_scan_block_points(g_hi, g_lo, k3.window_plan(plan, b), cp7[8 * b:8 * (b + 1)])
        for x, y in zip(got, want):
            assert torch.equal(x[7 * b:7 * (b + 1)], y)


def test_scan_block_points_refuses_other_devices(example):
    _, (grids, tproblem, tstate, tweights), _ = example
    plan = tws.problem_plan(tproblem, tweights)
    meta = torch.device("meta")
    moved = k3.PointPlan(*(x.to(meta) if torch.is_tensor(x) else x for x in plan))
    with pytest.raises(ValueError, match="unsupported device"):
        k3.ct_scan_block_points(*grids, moved, torch.zeros((8, 7), device=meta))


def _pair_case_cp7(case, k=6, seed=3):
    """Control points [t, q] (k, 7) for the pair-term tests: "slerp",
    rotations within 0.3 rad; "dot_negative", the same with every other
    rotation negated (the pair's dot below 0, the sign flip taken);
    "lerp", every rotation exactly [0, 0, 1, 0] (theta = 0, the lerp
    branch)."""
    rng = np.random.default_rng(seed)
    trans = torch.from_numpy(rng.uniform(-1.0, 1.0, (k, 3)).astype(np.float32))
    if case == "lerp":
        q = torch.tensor([[0.0, 0.0, 1.0, 0.0]]).expand(k, 4)
    else:
        q = _quat_of_aa(rng.uniform(-0.3, 0.3, (k, 3)).astype(np.float32))
        if case == "dot_negative":
            q = torch.where((torch.arange(k) % 2 == 1)[:, None], -q, q)
    return torch.cat([trans, q], dim=1).contiguous()


def _quat_of_aa(aa):
    return torch.from_numpy(np.array(jr.quat_from_axis_angle(jnp.asarray(aa))))


@pytest.mark.parametrize("case", ["slerp", "dot_negative", "lerp"])
def test_pair_terms_hoisted_match_per_point(case):
    """The plain twin computes a pair's terms once a pair and gathers them
    (plan_poses), as the kernel computes them once a block: the same bits
    as pair terms computed once a point, on both branches of
    the sign flip and on the lerp branch; and the pose still matches
    window_solver.py's _quat_of."""
    k, n = 6, 300
    cp7 = _pair_case_cp7(case, k)
    rng = np.random.default_rng(7)
    pts = lambda: torch.from_numpy(rng.uniform(-5.0, 5.0, (1, n, 3)).astype(np.float32))
    pair = lambda: torch.from_numpy(rng.integers(0, k - 1, (1, n)))
    fac = lambda: torch.from_numpy(rng.random((1, n)).astype(np.float32))
    scale = lambda: torch.from_numpy(np.where(rng.random((1, n)) < 0.1, 0.0, 1.0).astype(np.float32))
    plan = k3.point_plan(pts(), pair(), fac(), scale(), pts(), pair(), fac(), scale(), k)
    terms = k3.pair_terms(cp7[:-1], cp7[1:])
    dot = k3._dot4(cp7[:-1, 3:], cp7[1:, 3:])
    assert bool(terms.lerp.all()) if case == "lerp" else not bool(terms.lerp.any())
    assert bool((dot < 0).all()) if case == "dot_negative" else bool((dot > 0).all())
    m = int(plan.starts[-1])
    pair_m = plan.pair[:m]
    hoisted = k3.plan_poses(plan, cp7, m)
    per_point = k3.point_poses_from_terms(k3.pair_terms(cp7[pair_m], cp7[pair_m + 1]), plan.factor[:m])
    for got, want in zip(hoisted, per_point):
        assert torch.equal(got, want)
    q0, q1, f = (np.asarray(x) for x in (cp7[pair_m, 3:], cp7[pair_m + 1, 3:], plan.factor[:m]))
    want_q = np.asarray(jax.vmap(lambda a, b, t: jr.quat_normalize(jr.quat_slerp(a, b, t)))(q0, q1, f))
    _close(hoisted[1], want_q, 1e-6)


@pytest.mark.parametrize("case", ["long", "skewed"])
def test_chip_segment_plans(case):
    """chip_smoke.py's uneven per-point plans (phase 7's long and skewed
    segments): the long pair holds more than 4,000 kept points (32 tiles
    and more), the skewed pair holds most of the window beside
    pairs of one to three points, the empty pair is an empty segment and
    its plain block zero, the dropped points lie past every segment, and
    the plain twin's pair blocks are finite and symmetric."""
    import chip_smoke as cs
    from hectorgrapher_tpu_torch.mapping.grids import make_tsdf_grid

    hi = make_tsdf_grid(0.5, (24, 24, 24), 1.25, 1000.0, CPU)
    hi = hi._replace(meta=hi.meta._replace(min_corner=torch.full((3,), -6.0)))
    hi = hi._replace(weight=torch.ones_like(hi.weight), tsd=torch.linspace(-1, 1, hi.tsd.numel()).reshape(hi.shape))
    lo = hi
    scan = np.random.default_rng(2).uniform(-4.0, 4.0, (500, 3)).astype(np.float32)
    hi_, lo_, plan, cp7, gparams, empty = cs.ct_point_segment_inputs(CPU, hi, lo, scan, case)
    sizes = torch.diff(plan.starts)
    m = int(plan.starts[-1])
    assert int(sizes[empty]) == 0 and bool((plan.scale[:m] != 0).all()) and bool((plan.scale[m:] == 0).all())
    if case == "long":
        assert plan.k == 4 and int(sizes[0]) > 4000
    else:
        big = int(sizes.argmax())
        assert plan.k == 32 and int(sizes[big]) > 0.9 * m
        assert 1 <= int(torch.cat([sizes[:big], sizes[big + 1:]]).max()) <= 3
    S, g, cost = k3.ct_scan_block_points(hi_, lo_, plan, cp7, gparams=gparams)
    assert all(bool(torch.isfinite(x).all()) for x in (S, g, cost))
    assert float(S[empty].abs().max()) == 0.0 and float(cost[empty]) == 0.0
    assert float(S.abs().max()) > 0.0 and torch.equal(S, S.transpose(1, 2))


@pytest.mark.parametrize("sizes", [[480, 0, 482, 1486, 128, 129, 1], [4600, 0, 100], [0, 0, 0]],
                         ids=["front_end", "long", "empty"])
def test_point_plan_blocks_cover_every_segment(sizes):
    """point_plan's segment starts and zero tickets, and the kernel's block
    count: every segment cut into tiles of up to POINT_TILE points (an
    empty segment one tile, csrc/ct_scan_block.cu) fits in _blocks of the
    plan, dropped points included, with at most a block a segment
    spare."""
    k, tile = len(sizes) + 1, k3.POINT_TILE
    pair = torch.repeat_interleave(torch.arange(k - 1), torch.tensor(sizes))[None]
    n = pair.shape[1]
    rng = np.random.default_rng(5)
    pts = torch.from_numpy(rng.uniform(-1.0, 1.0, (1, n + 40, 3)).astype(np.float32))
    pair = torch.cat([pair, torch.zeros((1, 40), dtype=torch.int64)], dim=1)
    scale = torch.cat([torch.ones(1, n), torch.zeros(1, 40)], dim=1)  # 40 dropped points
    fac = torch.full((1, n + 40), 0.5)
    plan = k3.point_plan(pts, pair, fac, scale, pts[:, :0], pair[:, :0], fac[:, :0], scale[:, :0], k)
    starts = plan.starts.tolist()
    assert starts == np.concatenate([[0], np.cumsum(sizes)]).tolist() and plan.points.shape[0] == n + 40
    assert plan.counters.dtype == torch.int32 and plan.counters.tolist() == [0] * (k - 1)
    tiles = sum(max(1, -(-size // tile)) for size in sizes)
    assert tiles <= k3._blocks(plan) == (k - 1) + (n + 40) // tile <= tiles + (k - 1) + 40 // tile


def test_window_plan_is_the_single_plan():
    """window_plan's part of a batched plan is that window's own plan:
    the same points, factors, scales, grid flags, pairs and starts, and
    zero tickets of its own."""
    _, _, problem, _, weights = ct_example(grid=32)
    tproblem, tweights = convert.ct_problem(problem, CPU), convert.ct_weights(weights, CPU)
    batch = tws.CtProblem(*(torch.stack([x, x]) for x in tproblem))
    plan = tws.problem_plan(batch, tweights)
    single = tws.problem_plan(tws.CtProblem(*(x[None] for x in tproblem)), tweights)
    m = int(single.starts[-1])
    for b in range(2):
        one = k3.window_plan(plan, b)
        assert one.k == single.k and torch.equal(one.starts, single.starts)
        for name in ("points", "factor", "scale", "lo", "pair"):
            assert torch.equal(getattr(one, name)[:m], getattr(single, name)[:m]), name
        assert one.counters.tolist() == [0] * single.segments
        assert one.counters.data_ptr() != plan.counters.data_ptr()
