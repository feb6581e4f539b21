"""Parity of the port's CT window solve (hectorgrapher_tpu_torch) with the JAX
package's: 3D quaternion ops, the TSDF and occupancy stencils, the
scan-block assembly (the plain version of kernel K3), the normal equations
and the LM solve, over TSDF and occupancy grids (is_tsdf=False), on the
CPU with the same inputs.

Tolerances, each with its reason:
  * quaternion ops: 1e-6 — f32 ops in the same order; XLA on the CPU may
    contract a product and a sum into one FMA (ROADMAP C0);
  * slerp Jacobian (dpose7): exact on the entry fixture, whose rotations
    are all identity (the lerp branch); 1e-5 with rotations;
  * stencil value and d/dfrac: 1e-5 absolute (values of at most the
    truncation distance, d/dfrac of at most a few of it) — the same eight
    cells, another rounding of the blends; the occupancy stencil's value
    (1 - p, in [0.1, 0.9]) within 1e-6, its d/dfrac within 1e-5;
  * scan blocks and normal equations: 1e-5 * max(1, max|S|) — sums over
    512 points per cloud in another order;
  * solve: cost within 1e-5 relative, state within 1e-5 — the same LM
    steps, each rounding like the normal equations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hectorgrapher_tpu.mapping.ct import window_solver as jws
from hectorgrapher_tpu.mapping.scan_matching.interpolated_grid import (
    gather_rows_3d,
    prepare_grid_3d,
    prob_value_and_dfrac,
    tsdf_value_and_dfrac,
)
from hectorgrapher_tpu.transform import rigid as jr
from hectorgrapher_tpu_torch import convert
from hectorgrapher_tpu_torch.mapping.ct import window_solver as tws
from hectorgrapher_tpu_torch.mapping.scan_matching import interpolated_grid as tig
from hectorgrapher_tpu_torch.mapping.scan_matching.interpolated_grid import tsdf_value_and_dfrac_3d
from hectorgrapher_tpu_torch.ops.ct_scan_block import ct_scan_block, ct_scan_block_plain
from hectorgrapher_tpu_torch.transform import rigid as tr
from torch_parity import CPU, ct_example, direct_payload, rotated_state

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _quats(seed, n=64):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# 3D quaternion ops and Rigid3
# ---------------------------------------------------------------------------


def test_quat_multiply_rotate_conjugate():
    a, b = _quats(0), _quats(1)
    v = np.random.default_rng(2).normal(size=(64, 3)).astype(np.float32)
    _close(tr.quat_multiply(_t(a), _t(b)), jr.quat_multiply(jnp.asarray(a), jnp.asarray(b)), 1e-6)
    _close(tr.quat_rotate(_t(a), _t(v)), jr.quat_rotate(jnp.asarray(a), jnp.asarray(v)), 1e-5)
    _close(tr.quat_conjugate(_t(a)), jr.quat_conjugate(jnp.asarray(a)), 0)
    _close(tr.quat_normalize(_t(3 * a)), jr.quat_normalize(jnp.asarray(3 * a)), 1e-6)
    _close(tr.quat_angle(_t(a)), jr.quat_angle(jnp.asarray(a)), 1e-6)


@pytest.mark.parametrize("scale", [1e-8, 1e-3, 0.5, 2.0], ids=["taylor", "small", "mid", "large"])
def test_quat_from_axis_angle(scale):
    aa = (np.random.default_rng(3).normal(size=(32, 3)) * scale).astype(np.float32)
    _close(tr.quat_from_axis_angle(_t(aa)), jr.quat_from_axis_angle(jnp.asarray(aa)), 1e-6)


@pytest.mark.parametrize("case", ["random", "identical", "opposite_sign", "near"])
def test_quat_slerp(case):
    a = _quats(4)
    b = {
        "random": _quats(5),
        "identical": a,
        "opposite_sign": -a,
        "near": np.asarray(jr.quat_normalize(jnp.asarray(a) + 1e-4)),
    }[case]
    t = np.random.default_rng(6).uniform(0, 1, 64).astype(np.float32)
    _close(tr.quat_slerp(_t(a), _t(b), _t(t)), jr.quat_slerp(jnp.asarray(a), jnp.asarray(b), jnp.asarray(t)), 1e-5)


def test_rigid3_compose_inverse_apply():
    rng = np.random.default_rng(7)
    ta, tb = rng.normal(size=(2, 16, 3)).astype(np.float32)
    qa, qb = _quats(8, 16), _quats(9, 16)
    pts = rng.normal(size=(16, 5, 3)).astype(np.float32)
    ja, jb = jr.Rigid3(jnp.asarray(ta), jnp.asarray(qa)), jr.Rigid3(jnp.asarray(tb), jnp.asarray(qb))
    pa, pb = tr.Rigid3(_t(ta), _t(qa)), tr.Rigid3(_t(tb), _t(qb))
    for got, want in zip(tr.compose(pa, pb), jr.compose(ja, jb)):
        _close(got, want, 1e-5)
    for got, want in zip(tr.inverse(pa), jr.inverse(ja)):
        _close(got, want, 1e-5)
    _close(tr.apply(pa, _t(pts)), jr.apply(ja, jnp.asarray(pts)), 1e-5)


# ---------------------------------------------------------------------------
# The CT fixture, its JAX reference computed once
# ---------------------------------------------------------------------------


GRID_TYPES = ["TSDF", "PROBABILITY_GRID"]


def _with_port(hi, lo, problem, state, weights):
    """The JAX example and its port: TSDF grids as they are, occupancy
    grids prepared (their probability fields), as K3 reads them."""
    grids = [convert.grid_3d(g, CPU) for g in (hi, lo)]
    port = (*map(tig.prepare_grid_3d, grids), convert.ct_problem(problem, CPU), convert.ct_state(state, CPU),
            convert.ct_weights(weights, CPU))
    return (hi, lo, problem, state, weights), port


@pytest.fixture(scope="module")
def example():
    return _with_port(*ct_example(grid=32))


@pytest.fixture(scope="module")
def example_probability():
    return _with_port(*ct_example(grid=32, grid_type="PROBABILITY_GRID"))


def _example(request, grid_type, lo_filtered=False):
    name = "example" + ("_lo_filtered" if lo_filtered else "") + ("_probability" if grid_type != "TSDF" else "")
    return request.getfixturevalue(name)


def _jax_cloud_poses(problem, state):
    """pose7 and dpose7 as window_solver.py scan_block computes them (:479-488)."""

    def one(ci):
        p, n = problem.cloud_prev[ci], problem.cloud_next[ci]
        f = problem.cloud_factor[ci]

        def pose_of(d18):
            t0, q0, _ = jws._retract_one(state.translation[p], state.rotation[p], state.velocity[p], d18[:9])
            t1, q1, _ = jws._retract_one(state.translation[n], state.rotation[n], state.velocity[n], d18[9:])
            return jnp.concatenate([t0 + f * (t1 - t0), jr.quat_normalize(jr.quat_slerp(q0, q1, f))])

        z = jnp.zeros(18, jnp.float32)
        return pose_of(z), jax.jacfwd(pose_of)(z)

    return jax.vmap(one)(jnp.arange(problem.cloud_prev.shape[0]))


@pytest.mark.parametrize("rotated", [False, True], ids=["entry", "rotated"])
def test_cloud_poses_match_jacfwd(example, rotated):
    (_, _, problem, state, _), (_, _, tproblem, tstate, _) = example
    if rotated:
        state = rotated_state(state, 10)
        tstate = convert.ct_state(state, CPU)
    want_p, want_d = _jax_cloud_poses(problem, state)
    got_p, got_d = tws.cloud_poses(tstate, tproblem)
    tol = 1e-5 if rotated else 0.0
    assert np.isfinite(got_d.numpy()).all()
    _close(got_p, want_p, tol)
    _close(got_d, want_d, tol)


def _small_room_grid():
    """A 32^3 TSDF grid at 0.1 m holding one scan of a 2.5 x 2 x 1.4 m room
    (the fixture's hi-res grid is smaller than its room and sees nothing),
    and the scan's points."""
    from hectorgrapher_tpu.common.config import TSDFRangeDataInserterOptions3D
    from hectorgrapher_tpu.evaluation.scan_generator import raycast_box_room_3d
    from hectorgrapher_tpu.mapping.grids import make_tsdf_grid
    from hectorgrapher_tpu.mapping.inserters_3d import make_tsdf_inserter_3d
    from hectorgrapher_tpu.sensor.types import RangeData, pad_cloud

    pts = raycast_box_room_3d(np.zeros(3), np.array([1.0, 0, 0, 0]), half_extents=(1.23, 1.01, 0.72))
    pts = pts[~np.isnan(pts[:, 0])]
    opts = TSDFRangeDataInserterOptions3D(normal_computation_method="NONE", min_range=0.1, max_range=30.0)
    rd = RangeData(jnp.zeros(3, jnp.float32), pad_cloud(pts, 1024), pad_cloud(np.zeros((0, 3), np.float32), 4))
    grid = make_tsdf_inserter_3d(opts, 0.1)(make_tsdf_grid(0.1, (32, 32, 32), 0.25, 1000.0), rd)
    return grid, pts


def test_interpolate_pose_matches_jax(example):
    (_, _, problem, state, _), (_, _, tproblem, _, _) = example
    state = rotated_state(state, 14)
    want = jws.interpolate_pose(state, problem.cloud_prev, problem.cloud_next, problem.cloud_factor)
    got = tws.interpolate_pose(convert.ct_state(state, CPU), tproblem.cloud_prev, tproblem.cloud_next,
                               tproblem.cloud_factor)
    for g, w in zip(got, want):
        _close(g, w, 1e-6)


@pytest.mark.parametrize("which", ["room", "lo"])
def test_tsdf_stencil_interior_boundary_outside(example, which):
    if which == "room":
        grid, surface = _small_room_grid()
        tgrid = convert.tsdf_grid(grid, CPU)
    else:
        (_, grid, problem, _, _), (_, tgrid, _, _, _) = example
        surface = np.asarray(problem.hi_points).reshape(-1, 3)
    rng = np.random.default_rng(11)
    res = float(grid.meta.resolution)
    lo_c = np.asarray(grid.meta.min_corner)
    ext = np.asarray(grid.tsd.shape) * res
    # Near the observed surfaces: scan points, jittered.
    near = surface[rng.choice(len(surface), 768)] + rng.normal(0, 0.5 * res, (768, 3))
    # Cells whose stencil touches the last row/column (boundary: unknown),
    # and points outside the grid on every side.
    boundary = lo_c + ext - rng.uniform(0.0, 0.1, (64, 3)) * res
    outside = lo_c + rng.choice([-0.2, 1.2], (64, 3)) * ext
    pts = np.concatenate([near, boundary, outside]).astype(np.float32)
    prepared = prepare_grid_3d(grid)
    want_v, want_d = tsdf_value_and_dfrac(prepared, gather_rows_3d(prepared, jnp.asarray(pts)), jnp.asarray(pts))
    got_v, got_d = tsdf_value_and_dfrac_3d(tgrid, _t(pts))
    assert np.count_nonzero(np.asarray(want_v)[:768]) > 50  # observed cells are read
    assert not np.asarray(want_v)[768:].any()
    _close(got_v, want_v, 1e-5)
    _close(got_d, want_d, 1e-5)


def _small_room_probability_grid():
    """_small_room_grid's scan in a 32^3 occupancy grid at 0.1 m (the
    default high-resolution occupancy inserter)."""
    from hectorgrapher_tpu.common.config import SubmapsOptions3D
    from hectorgrapher_tpu.evaluation.scan_generator import raycast_box_room_3d
    from hectorgrapher_tpu.mapping.grids import make_probability_grid
    from hectorgrapher_tpu.mapping.inserters_3d import make_probability_inserter_3d
    from hectorgrapher_tpu.sensor.types import RangeData, pad_cloud

    pts = raycast_box_room_3d(np.zeros(3), np.array([1.0, 0, 0, 0]), half_extents=(1.23, 1.01, 0.72))
    pts = pts[~np.isnan(pts[:, 0])]
    opts = SubmapsOptions3D().high_resolution_range_data_inserter.probability_grid_range_data_inserter
    rd = RangeData(jnp.zeros(3, jnp.float32), pad_cloud(pts, 1024), pad_cloud(np.zeros((0, 3), np.float32), 4))
    insert = make_probability_inserter_3d(opts)
    grid = insert(insert(make_probability_grid(0.1, (32, 32, 32)), rd), rd)
    return grid, pts


@pytest.mark.parametrize("which", ["room", "lo"])
def test_prob_stencil_interior_boundary_outside(example_probability, which):
    """The occupancy stencil against JAX's prob_value_and_dfrac: near the
    surfaces, on the boundary and outside, where JAX reads its pad row of
    MIN_PROBABILITY taps (value ~0.9, derivative 0)."""
    if which == "room":
        grid, surface = _small_room_probability_grid()
    else:
        (_, grid, problem, _, _), _ = example_probability
        surface = np.asarray(problem.hi_points).reshape(-1, 3)
    prepared_t = tig.prepare_grid_3d(convert.probability_grid(grid, CPU))
    rng = np.random.default_rng(15)
    res = float(grid.meta.resolution)
    lo_c = np.asarray(grid.meta.min_corner)
    ext = np.asarray(grid.log_odds.shape) * res
    near = surface[rng.choice(len(surface), 768)] + rng.normal(0, 0.5 * res, (768, 3))
    boundary = lo_c + ext - rng.uniform(0.0, 0.1, (64, 3)) * res
    outside = lo_c + rng.choice([-0.2, 1.2], (64, 3)) * ext
    pts = np.concatenate([near, boundary, outside]).astype(np.float32)
    prepared = prepare_grid_3d(grid)
    want_v, want_d = prob_value_and_dfrac(prepared, gather_rows_3d(prepared, jnp.asarray(pts)), jnp.asarray(pts))
    got_v, got_d = tig.prob_value_and_dfrac_3d(prepared_t, _t(pts))
    want_v, want_d = np.asarray(want_v), np.asarray(want_d)
    assert np.count_nonzero(np.abs(want_d[:768]).sum(-1)) > 50  # observed cells are read
    assert np.allclose(want_v[768:], 0.9, atol=1e-6) and not want_d[768:].any()  # the pad taps
    _close(got_v, want_v, 1e-6)
    _close(got_d, want_d, 1e-5)


@pytest.mark.parametrize("grid_type", GRID_TYPES)
@pytest.mark.parametrize("rotated", [False, True], ids=["entry", "rotated"])
def test_scan_block_plain_matches_jax(request, rotated, grid_type):
    (hi, lo, problem, state, weights), (thi, tlo, tproblem, tstate, tweights) = _example(request, grid_type)
    if rotated:
        state = rotated_state(state, 12)
        tstate = convert.ct_state(state, CPU)
    scan_block, _ = jws.make_ct_block_families(prepare_grid_3d(hi), prepare_grid_3d(lo), problem, weights,
                                               grid_type == "TSDF")
    J, r, _ = scan_block(state)
    hp = jax.lax.Precision.HIGHEST
    want_S = np.asarray(jnp.einsum("cri,crj->cij", J, J, precision=hp))
    want_g = np.asarray(jnp.einsum("cri,cr->ci", J, r, precision=hp))
    want_cost = 0.5 * np.sum(np.asarray(r, np.float64) ** 2, axis=1)

    pose7, dpose7 = tws.cloud_poses(tstate, tproblem)
    n_hi = tproblem.hi_mask.sum(1).clamp(min=1).float()
    n_lo = tproblem.lo_mask.sum(1).clamp(min=1).float()
    cm = tproblem.cloud_mask.float()
    args = (thi, tlo, tproblem.hi_points, tproblem.hi_mask, tproblem.lo_points, tproblem.lo_mask, pose7, dpose7,
            tweights.high_resolution_grid_weight / n_hi.sqrt() * cm, tweights.low_resolution_grid_weight / n_lo.sqrt() * cm)
    S, g, cost = ct_scan_block_plain(*args)
    tol = 1e-5 * max(1.0, float(np.abs(want_S).max()))
    _close(S, want_S, tol)
    _close(g, want_g, tol)
    _close(cost, want_cost, tol)
    # On CPU tensors the wrapper takes the plain version.
    for got, want in zip(ct_scan_block(*args), (S, g, cost)):
        assert torch.equal(got, want)


def test_scan_block_refuses_other_devices(example):
    _, (thi, tlo, tproblem, tstate, _) = example
    meta = torch.device("meta")
    pts = tproblem.hi_points.to(meta)
    with pytest.raises(ValueError, match="unsupported device"):
        ct_scan_block(thi, tlo, pts, tproblem.hi_mask.to(meta), pts, tproblem.lo_mask.to(meta),
                      None, None, None, None)


@pytest.fixture(scope="module")
def example_lo_filtered():
    return _with_port(*ct_example(grid=32, lo_filtered=True))


@pytest.fixture(scope="module")
def example_lo_filtered_probability():
    return _with_port(*ct_example(grid=32, lo_filtered=True, grid_type="PROBABILITY_GRID"))


@pytest.mark.parametrize("grid_type", GRID_TYPES)
@pytest.mark.parametrize("case", ["entry", "lo_filtered", "rotated"])
def test_normal_equations_match_jax(request, case, grid_type):
    (hi, lo, problem, state, weights), port = _example(request, grid_type, lo_filtered=case == "lo_filtered")
    is_tsdf = grid_type == "TSDF"
    if case == "lo_filtered":  # the lo-res clouds differ from the hi-res ones (ROADMAP C4)
        assert int(np.asarray(problem.lo_mask).sum()) < int(np.asarray(problem.hi_mask).sum())
    if case == "rotated":  # the slerp branch, and odometry errors off the identity
        state = rotated_state(state, 13)
        port = port[:3] + (convert.ct_state(state, CPU),) + port[4:]
    want = [np.asarray(x) for x in jws.ct_normal_equations(hi, lo, problem, state, weights, is_tsdf=is_tsdf)]
    got = [x.numpy() for x in tws.ct_normal_equations(*port[:2], port[2], port[3], port[4], is_tsdf=is_tsdf)]
    tol = 1e-5 * max(1.0, float(np.abs(want[0]).max()))
    _close(got[0], want[0], tol)
    _close(got[1], want[1], tol)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5)


@pytest.mark.parametrize("grid_type", GRID_TYPES)
def test_solve_matches_jax(request, grid_type):
    (hi, lo, problem, state, weights), port = _example(request, grid_type)
    is_tsdf = grid_type == "TSDF"
    js, jf, ji = jws.solve_ct_window(hi, lo, problem, state, weights, is_tsdf=is_tsdf, num_iterations=8)
    before = tws.solve_ct_window.assemblies
    # The raw grids: the solve prepares them itself, once.
    raw = tuple(convert.grid_3d(g, CPU) for g in (hi, lo))
    ts, tf, ti = tws.solve_ct_window(*raw, *port[2:], is_tsdf=is_tsdf, num_iterations=8)
    assert tws.solve_ct_window.assemblies - before == 9  # 1 + num_iterations
    assert float(tf) < float(ti)
    np.testing.assert_allclose(float(ti), float(ji), rtol=1e-5)
    np.testing.assert_allclose(float(tf), float(jf), rtol=1e-5)
    for got, want in zip(ts, js):
        _close(got, want, 1e-5)


def test_chip_smoke_fixture_matches_graft_entry(example):
    """chip_smoke.py rebuilds __graft_entry__._build_ct_example from the
    port's modules (the card has no JAX): the same problem and state, and
    grids within the inserter's tolerance (test_torch_ct_builder.py)."""
    import chip_smoke

    (hi, lo, problem, state, weights), _ = example
    thi, tlo, tproblem, tstate, tweights = chip_smoke.build_ct_example(CPU, grid=32, cube=False)
    for name in CtProblemFields:
        np.testing.assert_array_equal(getattr(tproblem, name).numpy(), np.asarray(getattr(problem, name)), err_msg=name)
    for got, want in zip(tstate, state):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in ((thi, hi), (tlo, lo)):
        np.testing.assert_array_equal(got.meta.min_corner.numpy(), np.asarray(want.meta.min_corner))
        assert got.shape == want.shape
        bad = np.abs(got.weight.numpy() - np.asarray(want.weight)) > 1e-5
        assert bad.sum() <= max(1, 1e-4 * bad.size)


CtProblemFields = tws.CtProblem._fields


def test_unported_modes_raise(example):
    """Per-point unwarping and the DIRECT IMU term, once refused, now run:
    the solve in each mode matches the JAX package's within the solve's
    tolerance (tests/test_torch_ct_per_point.py holds them in depth)."""
    (hi, lo, problem, state, weights), (thi, tlo, tproblem, tstate, tweights) = example
    jdirect, tdirect = direct_payload(state.translation.shape[0])
    for kw, jkw in (({"per_point": True}, {"per_point": True}), ({"direct": tdirect}, {"direct": jdirect})):
        ts, tf, ti = tws.solve_ct_window(thi, tlo, tproblem, tstate, tweights, is_tsdf=True, num_iterations=4, **kw)
        js, jf, ji = jws.solve_ct_window(hi, lo, problem, state, weights, is_tsdf=True, num_iterations=4, **jkw)
        np.testing.assert_allclose(float(tf), float(jf), rtol=1e-5)
        for got, want in zip(ts, js):
            _close(got, want, 1e-5)


def test_grid_type_mismatch_and_unprepared_grids_raise(example, example_probability):
    """is_tsdf must name the grids' type; K3's wrapper and its plain
    version take an occupancy grid only as its prepared field."""
    (hi, lo, *_), (thi, tlo, tproblem, tstate, tweights) = example
    (phi, plo, *_), (pthi, ptlo, *_) = example_probability
    with pytest.raises(ValueError, match="is_tsdf"):
        tws.solve_ct_window(thi, tlo, tproblem, tstate, tweights, is_tsdf=False)
    with pytest.raises(ValueError, match="is_tsdf"):
        tws.solve_ct_window(pthi, ptlo, tproblem, tstate, tweights, is_tsdf=True)
    pose7, dpose7 = tws.cloud_poses(tstate, tproblem)
    c = pose7.shape[0]
    clouds = (tproblem.hi_points, tproblem.hi_mask, tproblem.lo_points, tproblem.lo_mask, pose7, dpose7,
              torch.ones(c), torch.ones(c))
    with pytest.raises(TypeError, match="prepare_grid_3d"):
        ct_scan_block(convert.probability_grid(phi, CPU), convert.probability_grid(plo, CPU), *clouds)
