"""Parity of the rest of the port's CT front end (hectorgrapher_tpu_torch)
with the JAX package's, on the CPU with the same seeded inputs: the
normal-directed TSDF insertion (k-NN PCA and organized-cloud normals, the
normal-mode and triangle inserters), FrontEndMetrics and RateTimer, the
sampled clip counter, the Rigid3 extras, the collators, and the CT
builder's window_solve_fn hook.

Tolerances, each with its reason:
  * k-NN PCA normals: 1e-4 on planar patches (eigh of f32 covariances
    summed in another order; an eigenvector is defined there, unlike on a
    row of a sparse scan); the validity flags exactly;
  * organized-cloud normals: the flags exactly, normals within 1e-5 (the
    same neighbours, f32 cross products);
  * inserters: 1e-5 in all but 1e-4 of the cells (ROADMAP C3: band
    samples on a cell boundary can land one cell over);
  * metrics, clip counts, collators: exact (the same host arithmetic and
    dispatch order);
  * Rigid3 extras: 1e-6 (the same f32 formulas);
  * the window_solve_fn hook: a builder whose solves go through
    solve_ct_window_batched (B = 1) gives the inline builder's poses
    within 1e-5 m / 1e-5 rad.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hectorgrapher_tpu.common import config as jcfg
from hectorgrapher_tpu.mapping import inserters_3d as jins
from hectorgrapher_tpu.mapping.grids import make_tsdf_grid
from hectorgrapher_tpu.transform import rigid as jr
from hectorgrapher_tpu_torch import convert
from hectorgrapher_tpu_torch.mapping import inserters_3d as tins
from hectorgrapher_tpu_torch.transform import rigid as tr
from torch_parity import CPU, organized_room_range_data, wall_range_data

torch.set_num_threads(1)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=tol)


def _assert_grids_close(got, want):
    w, tsd = np.asarray(want.weight), np.asarray(want.tsd)
    assert (w > 0).sum() > 300
    bad = (np.abs(got.weight.numpy() - w) > 1e-5) | (np.abs(got.tsd.numpy() - tsd) > 1e-5)
    assert bad.sum() <= max(1, 1e-4 * w.size), f"{bad.sum()} of {w.size} cells differ"


# ---------------------------------------------------------------------------
# Normals and the normal-directed inserters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,noise", [(1, 0.0), (2, 0.002)], ids=["exact", "noisy"])
def test_knn_pca_normals_match_jax(seed, noise):
    """A wall patch (planar neighbourhoods), with masked points: the
    normals within 1e-4 of the JAX package's, turned toward the sensor
    (-x); the flags equal."""
    rd, _ = wall_range_data(seed, noise=noise)
    mask = np.ones(rd.returns.mask.shape[0], bool)
    mask[::7] = False
    rd = rd._replace(returns=rd.returns._replace(mask=jnp.asarray(mask)))
    trd = convert.range_data(rd, CPU)
    want_n, want_ok = jins.knn_pca_normals(rd.returns.positions, rd.returns.mask, rd.origin, k=16, radius=0.2)
    got_n, got_ok = tins.knn_pca_normals(trd.returns.positions, trd.returns.mask, trd.origin, k=16, radius=0.2)
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    ok = np.asarray(want_ok)
    assert ok.sum() > 400 and not ok[~mask].any()
    _close(got_n.numpy()[ok], np.asarray(want_n)[ok], 1e-4)
    assert (got_n.numpy()[ok, 0] < -0.99).all()


def test_knn_pca_normals_degenerate():
    """Fewer than three neighbours in the radius: no normal, as in JAX."""
    pts = np.zeros((64, 3), np.float32)
    pts[0], pts[1] = [1.0, 0.0, 0.0], [1.01, 0.0, 0.0]
    valid = np.zeros(64, bool)
    valid[:2] = True
    want = np.asarray(jins.knn_pca_normals(jnp.asarray(pts), jnp.asarray(valid), jnp.zeros(3), k=8, radius=0.5)[1])
    got = tins.knn_pca_normals(torch.from_numpy(pts), torch.from_numpy(valid), torch.zeros(3), k=8, radius=0.5)[1]
    np.testing.assert_array_equal(got.numpy(), want)
    assert not want.any()


@pytest.mark.parametrize("strides", [(1, 5), (2, 1)], ids=["default", "vertical2"])
def test_structured_cloud_normals_match_jax(strides):
    rd, width = organized_room_range_data(4)
    trd = convert.range_data(rd, CPU)
    v, h = strides
    want_n, want_ok = jins.structured_cloud_normals(rd.returns, rd.origin, width=width, vertical_stride=v,
                                                    horizontal_stride=h, resolution=0.1)
    got_n, got_ok = tins.structured_cloud_normals(trd.returns, trd.origin, width=width, vertical_stride=v,
                                                  horizontal_stride=h, resolution=0.1)
    ok = np.asarray(want_ok)
    np.testing.assert_array_equal(got_ok.numpy(), ok)
    assert ok.sum() > 1000
    _close(got_n.numpy()[ok], np.asarray(want_n)[ok], 1e-5)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float16], ids=["f32", "f16"])
def test_insert_tsdf_3d_with_normals_matches_jax(dtype):
    """insert_tsdf_3d's normal-directed branch (use_normals) with the
    organized scan's normals, twice into the same grid."""
    rd, width = organized_room_range_data(5)
    normals, ok = jins.structured_cloud_normals(rd.returns, rd.origin, width=width)
    grid = make_tsdf_grid(0.1, (80, 72, 32), 0.3, 1000.0, dtype=dtype)
    tgrid = convert.tsdf_grid(grid, CPU)
    valid = rd.returns.mask & ok
    tn, tvalid = torch.from_numpy(np.array(normals)), torch.from_numpy(np.array(valid))
    pts, origin = torch.from_numpy(np.array(rd.returns.positions)), torch.from_numpy(np.array(rd.origin))
    for _ in range(2):
        grid = jins.insert_tsdf_3d(grid, rd.returns.positions, valid, rd.origin, normals, num_band_samples=5,
                                   use_normals=True, weight_epsilon=0.1, weight_sigma=4.0)
        tgrid = tins.insert_tsdf_3d(tgrid, pts, tvalid, origin, num_band_samples=5, weight_epsilon=0.1,
                                    weight_sigma=4.0, normals=tn)
    assert tgrid.tsd.dtype == convert.tsdf_grid(grid, CPU).tsd.dtype
    got = tgrid._replace(tsd=tgrid.tsd.float(), weight=tgrid.weight.float())
    _assert_grids_close(got, grid._replace(tsd=grid.tsd.astype(jnp.float32), weight=grid.weight.astype(jnp.float32)))


@pytest.mark.parametrize("layers", [3, 5])
def test_insert_tsdf_3d_triangles_matches_jax(layers):
    rd, width = organized_room_range_data(6)
    grid = make_tsdf_grid(0.1, (80, 72, 32), 0.3, 1000.0)
    want = jins.insert_tsdf_3d_triangles(grid, rd.returns, rd.origin, width=width, num_layers=layers)
    trd = convert.range_data(rd, CPU)
    got = tins.insert_tsdf_3d_triangles(convert.tsdf_grid(grid, CPU), trd.returns, trd.origin, width=width,
                                        num_layers=layers)
    _assert_grids_close(got, want)


@pytest.mark.parametrize("method", ["CLOUD_STRUCTURE", "TRIANGLE_FILL_IN", "NONE"])
def test_tsdf_inserter_width_zero_takes_the_ray_mode(method):
    """Range data of width 0 (the CT builder's) takes the ray mode under
    the organized-cloud methods, as in the JAX package."""
    rd, _ = organized_room_range_data(7)
    rd = rd._replace(width=0)
    opts = jcfg.TSDFRangeDataInserterOptions3D(normal_computation_method=method, min_range=0.4, max_range=30.0)
    grid = make_tsdf_grid(0.1, (80, 72, 32), 0.3, 1000.0)
    want = jins.make_tsdf_inserter_3d(opts, 0.1)(grid, rd)
    got = tins.make_tsdf_inserter_3d(convert.options(opts), 0.1)(convert.tsdf_grid(grid, CPU),
                                                                 convert.range_data(rd, CPU))
    _assert_grids_close(got, want)


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------


def test_frontend_metrics_match_jax():
    """The same steps (sensor time, wall and CPU seconds) through both
    packages' FrontEndMetrics: equal latency buckets and real-time ratios,
    over more steps than the sliding window holds."""
    from hectorgrapher_tpu.mapping.frontend_metrics import FrontEndMetrics as JMetrics
    from hectorgrapher_tpu_torch.mapping.frontend_metrics import FrontEndMetrics as TMetrics

    jm, tm = JMetrics("parity_test"), TMetrics("parity_test")
    jlat = jm._latency
    before_j, before_t = jlat.counts_by_bucket, tm.latency.counts_by_bucket
    rng = np.random.default_rng(0)
    for k in range(40):
        step = (0.1 * k, float(rng.uniform(1e-4, 2.0)), float(rng.uniform(1e-4, 1.0)))
        jm.observe_step(*step)
        tm.observe_step(*step)
        assert tm.real_time_ratio == jm._rtr.value and tm.cpu_real_time_ratio == jm._cpu_rtr.value
    got = [a - b for a, b in zip(tm.latency.counts_by_bucket, before_t)]
    want = [a - b for a, b in zip(jlat.counts_by_bucket, before_j)]
    assert got == want and sum(got) == 40
    assert tm.real_time_ratio > 0


def test_ct_builder_observes_every_step():
    """The CT builder's add_range_data feeds its FrontEndMetrics, also on
    the steps that return no result."""
    from hectorgrapher_tpu_torch.mapping.ct import builder as tbuilder
    from hectorgrapher_tpu_torch.sensor import types as ttypes
    from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3 as TNpRigid3
    from test_ct_builder import make_options
    from torch_parity import ct_drive

    builder = tbuilder.OptimizingLocalTrajectoryBuilder(convert.options(make_options()), CPU)
    before = sum(builder.frontend_metrics.latency.counts_by_bucket)
    ct_drive(builder, TNpRigid3, ttypes.TimedPointCloudData, ttypes.pad_timed_cloud, duration=0.45)
    assert sum(builder.frontend_metrics.latency.counts_by_bucket) - before == 5  # scans at 0.05, 0.15, ..., 0.45
    assert builder.frontend_metrics.real_time_ratio > 0


def test_rate_timer_matches_jax():
    from hectorgrapher_tpu.metrics.metrics import RateTimer as JRateTimer
    from hectorgrapher_tpu_torch.metrics.metrics import RateTimer as TRateTimer

    j, t = JRateTimer(1.5), TRateTimer(1.5)
    assert t.compute_rate() == j.compute_rate() == 0.0
    times = np.cumsum(np.random.default_rng(1).uniform(0.01, 0.2, 60))
    for x in times:
        j.pulse(float(x))
        t.pulse(float(x))
        assert t.compute_rate() == j.compute_rate()


def test_count_clipped_matches_jax():
    """Both packages count the same out-of-extent returns, on a 2D
    occupancy grid and a 3D TSDF grid."""
    from hectorgrapher_tpu.mapping import submap_2d as jsub
    from hectorgrapher_tpu.mapping.grids import make_probability_grid
    from hectorgrapher_tpu.sensor.types import PointCloud, RangeData, pad_cloud
    from hectorgrapher_tpu_torch.mapping import submap_2d as tsub

    rng = np.random.default_rng(3)
    pts = rng.uniform(-6, 6, (300, 3)).astype(np.float32)
    mask = rng.uniform(size=300) < 0.9
    rd = RangeData(jnp.zeros(3, jnp.float32), PointCloud(jnp.asarray(pts), jnp.asarray(mask)),
                   pad_cloud(np.zeros((0, 3), np.float32), 4))
    for grid in (make_probability_grid(0.05, (100, 120)), make_tsdf_grid(0.1, (64, 48, 32), 0.3, 1000.0)):
        jc, tc = jsub._clipped_points_counter(), tsub.clipped_points_counter()
        j0, t0 = jc.value, tc.value
        jsub.count_clipped(grid, rd)
        tsub.count_clipped(convert.grid_3d(grid, CPU) if hasattr(grid, "tsd") else convert.probability_grid(grid, CPU),
                           convert.range_data(rd, CPU))
        assert tc.value - t0 == jc.value - j0 > 0


def test_active_submaps_3d_count_clipped():
    """ActiveSubmaps3D counts the lo-res grid's clipped returns on its
    first insertion (every 8th), as the JAX package does."""
    from hectorgrapher_tpu.sensor.types import PointCloud, RangeData, pad_cloud
    from hectorgrapher_tpu_torch.mapping import submap_2d as tsub
    from hectorgrapher_tpu_torch.mapping.submap_3d import ActiveSubmaps3D

    opts = convert.options(jcfg.replace_deep(jcfg.SubmapsOptions3D(), {"high_grid_size": 32, "low_grid_size": 16}))
    submaps = ActiveSubmaps3D(opts, CPU, 120)
    pts = np.array([[1.0, 0.0, 0.0], [500.0, 0.0, 0.0], [0.0, -400.0, 0.0]], np.float32)
    rd = RangeData(jnp.zeros(3, jnp.float32), PointCloud(jnp.asarray(pts), jnp.ones(3, bool)),
                   pad_cloud(np.zeros((0, 3), np.float32), 4))
    before = tsub.clipped_points_counter().value
    submaps.insert_data(convert.range_data(rd, CPU), np.zeros(120, np.float32), np.zeros(3))
    assert tsub.clipped_points_counter().value - before == 2


# ---------------------------------------------------------------------------
# Rigid3 extras
# ---------------------------------------------------------------------------


def _quats(seed, n=64):
    q = np.random.default_rng(seed).normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def test_quat_to_matrix_and_back_match_jax():
    q = _quats(1)
    q[:4] = [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]]  # each pivot's branch
    m = jr.quat_to_matrix(jnp.asarray(q))
    tm = tr.quat_to_matrix(torch.from_numpy(q))
    _close(tm, m, 1e-6)
    _close(tr.matrix_to_quat(tm), jr.matrix_to_quat(m), 1e-6)
    _close(tm, tr.quat_to_rotation_matrix(torch.from_numpy(q)), 1e-6)


@pytest.mark.parametrize("scale", [1e-9, 0.3, 2.5], ids=["tiny", "mid", "large"])
def test_rigid3_log_exp_match_jax(scale):
    rng = np.random.default_rng(2)
    xi = np.concatenate([rng.normal(size=(32, 3)), scale * rng.normal(size=(32, 3))], axis=1).astype(np.float32)
    j = jr.exp(jnp.asarray(xi))
    t = tr.exp(torch.from_numpy(xi))
    _close(t.translation, j.translation, 1e-6)
    _close(t.rotation, j.rotation, 1e-6)
    _close(tr.log(t), jr.log(j), 1e-5)


# ---------------------------------------------------------------------------
# Collators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["Collator", "TrajectoryCollator"])
def test_collators_dispatch_like_jax(kind):
    from hectorgrapher_tpu.sensor import collator as jcol
    from hectorgrapher_tpu_torch.sensor import collator as tcol

    events = []
    rng = np.random.default_rng(5)
    per_queue = {}
    for traj in (0, 1):
        for sensor, rate in (("imu", 0.01), ("odom", 0.05), ("lidar", 0.1)):
            per_queue[(traj, sensor)] = list(np.cumsum(rng.uniform(0.5, 1.5, 40) * rate))
    while any(per_queue.values()):  # interleave the queues, each in its own order
        keys = [k for k, v in per_queue.items() if v]
        key = keys[int(rng.integers(len(keys)))]
        events.append((*key, float(per_queue[key].pop(0))))
    outs = []
    for mod in (jcol, tcol):
        c = getattr(mod, kind)()
        out = []
        for traj in (0, 1):
            c.add_trajectory(traj, ["imu", "odom", "lidar"], lambda s, t, d, traj=traj: out.append((traj, s, t, d)))
        blockers = []
        for i, (traj, sensor, t) in enumerate(events):
            c.add_sensor_data(traj, sensor, t, i)
            if kind == "Collator":
                blockers.append(c.get_blocking_trajectory_id())
        c.finish_trajectory(0)
        c.flush()
        outs.append((out, blockers))
    assert outs[0] == outs[1]
    assert len(outs[1][0]) == len(events)
    assert not tcol.OrderedMultiQueue().is_native


def test_range_data_collator_matches_jax():
    from hectorgrapher_tpu.mapping import range_data_collator as jrc
    from hectorgrapher_tpu_torch.mapping import range_data_collator as trc

    rng = np.random.default_rng(8)
    msgs = []
    for k in range(6):
        for sensor, offset in (("a", 0.0), ("b", 0.03)):
            n = 50
            msgs.append((sensor, 0.1 * k + offset, rng.normal(size=(n, 3)).astype(np.float32),
                         np.sort(rng.uniform(-0.1, 0.0, n)).astype(np.float32)))
    msgs.append(("a", 0.75, rng.normal(size=(20, 3)).astype(np.float32), np.linspace(-0.1, 0, 20, dtype=np.float32)))
    results = []
    for mod in (jrc, trc):
        c = mod.RangeDataCollator(["a", "b"])
        out = []
        for sensor, t, pts, times in msgs:
            r = c.add_range_data(sensor, mod.TimedCloudInput(t, np.zeros(3, np.float32), pts, times))
            out.append(None if r is None else (r.time, r.points, r.times, r.origin_indices, len(r.origins)))
        results.append(out)
    assert sum(r is not None for r in results[0]) >= 6
    for a, b in zip(*results):
        assert (a is None) == (b is None)
        if a is not None:
            assert a[0] == b[0] and a[4] == b[4]
            for x, y in zip(a[1:4], b[1:4]):
                np.testing.assert_array_equal(x, y)


def test_collated_trajectory_builder_matches_jax():
    from hectorgrapher_tpu.mapping.collated_trajectory_builder import CollatedTrajectoryBuilder as JCTB
    from hectorgrapher_tpu.sensor.collator import Collator as JCollator
    from hectorgrapher_tpu_torch.mapping.collated_trajectory_builder import CollatedTrajectoryBuilder as TCTB
    from hectorgrapher_tpu_torch.sensor.collator import Collator as TCollator

    class Recorder:
        def __init__(self):
            self.calls = []

        def __getattr__(self, name):
            return lambda *a: self.calls.append((name, a))

    stream = [("imu", 0.01 * k, "imu", (0.01 * k, "acc", "gyro")) for k in range(40)]
    stream += [("odom", 0.05 * k + 0.001, "odometry", (0.05 * k + 0.001, "pose")) for k in range(8)]
    stream += [("lidar", 0.1 * k + 0.002, "range", ("scan", k)) for k in range(4)]
    stream.sort(key=lambda e: (e[0] != "lidar", e[1]))  # scans arrive early: the collator orders them
    runs = []
    for ctb, col in ((JCTB, JCollator), (TCTB, TCollator)):
        rec, logs = Recorder(), []
        b = ctb(col(), 0, rec, ["imu", "odom", "lidar"], log_fn=lambda s, r: logs.append((s, r)))
        for sensor, t, kind, payload in stream:
            b.add_sensor_data(sensor, t, kind, payload)
        b.finish()
        runs.append((rec.calls, logs))
    assert runs[0] == runs[1]
    assert [c[0] for c in runs[1][0]].count("add_range_data") == 4


# ---------------------------------------------------------------------------
# The window_solve_fn hook
# ---------------------------------------------------------------------------


def test_window_solve_fn_batches_a_builders_solves():
    """A builder whose window_solve_fn routes every solve through
    solve_ct_window_batched (one window a batch) gives the inline
    builder's poses; the hook sees every solve."""
    from hectorgrapher_tpu_torch.mapping.ct import builder as tbuilder
    from hectorgrapher_tpu_torch.mapping.ct import window_solver as tws
    from hectorgrapher_tpu_torch.sensor import types as ttypes
    from hectorgrapher_tpu_torch.transform import np_quat as tnq
    from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3 as TNpRigid3
    from test_ct_builder import make_options
    from torch_parity import ct_drive

    opts = convert.options(jcfg.replace_deep(make_options(), {
        "optimizing_local_trajectory_builder.use_per_point_unwarping": True}))
    seen = []

    def batched(pending):
        seen.append(pending)
        one = lambda x, cls: cls(*(v[None] for v in x))
        states, _, _ = tws.solve_ct_window_batched(
            [pending.high_grid], [pending.low_grid], one(pending.problem, tws.CtProblem),
            one(pending.state0, tws.CtState), pending.weights, is_tsdf=pending.is_tsdf,
            num_iterations=pending.num_iterations, per_point=pending.per_point)
        return tws.CtState(*(x[0] for x in states))

    runs = []
    for hook in (None, batched):
        builder = tbuilder.OptimizingLocalTrajectoryBuilder(opts, CPU)
        builder.window_solve_fn = hook
        runs.append((ct_drive(builder, TNpRigid3, ttypes.TimedPointCloudData, ttypes.pad_timed_cloud),
                     builder.num_optimizations))
    (inline, n_inline), (hooked, n_hooked) = runs
    assert n_hooked == n_inline == len(seen) > 0 and all(p.per_point for p in seen)
    assert len(hooked) == len(inline) >= 4
    for (tg, pg), (tw, pw) in zip(hooked, inline):
        assert tg == tw
        assert np.abs(pg.t - pw.t).max() < 1e-5
        assert tnq.quat_angle(tnq.quat_multiply(tnq.quat_conjugate(pw.q), pg.q)) < 1e-5
