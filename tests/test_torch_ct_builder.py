"""Parity of the port's CT front end (hectorgrapher_tpu_torch) with the JAX
package's: the timed voxel filters and compaction, the 3D TSDF and
occupancy inserters, the rotational histogram, the 3D submaps of both
grid types, the interpolation buffer and OptimizingLocalTrajectoryBuilder
over TSDF and occupancy submaps, on the CPU with the same seeded inputs.

Tolerances, each with its reason:
  * voxel filters and compaction: exact — the port's stable sorts keep
    the same point of each voxel, in the same order;
  * TSDF inserter: weights and tsd within 1e-5 in all but 1e-4 of the
    cells. Under the tests' x64 mode (ROADMAP C1) the JAX inserter
    computes the band points in float64 (jnp.linspace defaults to it)
    before flooring them in float32; the port stays in float32, so a band
    sample on a cell boundary can land one cell over;
  * occupancy inserter: known equal to the bit (set-scatters of one
    value), log-odds within 1e-6 (the same f32 adds and clamps);
  * histogram: within 1e-4 of its sum — the same buckets, sums of f32
    values in another order;
  * interpolation buffer: 1e-12 (the same float64 numpy);
  * front end: local poses within 1e-3 m and 1e-3 rad over 1.5 s of the
    tests/test_ct_builder.py scenario (LM solves that agree to ~1e-6, fed
    maps within the inserter's tolerance), on either grid type. The JAX
    package's own occupancy front end drifts from the truth on this drive
    (ROADMAP C15); the port is held to its output.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hectorgrapher_tpu.common import config as jcfg
from hectorgrapher_tpu.mapping.ct.builder import OptimizingLocalTrajectoryBuilder
from hectorgrapher_tpu.mapping.grids import make_probability_grid, make_tsdf_grid
from hectorgrapher_tpu.mapping.inserters_3d import make_probability_inserter_3d, make_tsdf_inserter_3d
from hectorgrapher_tpu.mapping.scan_matching.rotational_histogram import compute_histogram
from hectorgrapher_tpu.mapping.submap_3d import ActiveSubmaps3D
from hectorgrapher_tpu.sensor.types import PointCloud, RangeData, TimedPointCloud, TimedPointCloudData, pad_cloud
from hectorgrapher_tpu.sensor.types import pad_timed_cloud
from hectorgrapher_tpu.sensor.voxel_filter import (
    adaptive_voxel_filter_timed,
    compact_cloud,
    compact_timed_cloud,
    voxel_filter_timed,
)
from hectorgrapher_tpu.transform import np_quat as nq
from hectorgrapher_tpu.transform.interpolation import TransformInterpolationBuffer
from hectorgrapher_tpu.transform.np_quat import NpRigid3
from hectorgrapher_tpu.transform.rigid import Rigid3
from hectorgrapher_tpu_torch import convert
from hectorgrapher_tpu_torch.mapping import inserters_3d as tins
from hectorgrapher_tpu_torch.mapping import submap_3d as tsub
from hectorgrapher_tpu_torch.mapping.ct import builder as tbuilder
from hectorgrapher_tpu_torch.mapping.scan_matching import rotational_histogram as thist
from hectorgrapher_tpu_torch.sensor import types as ttypes
from hectorgrapher_tpu_torch.sensor import voxel_filter as tvf
from hectorgrapher_tpu_torch.transform import interpolation as tinterp
from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3 as TNpRigid3
from test_ct_builder import make_options
from torch_parity import CPU, box_room_scan, ct_drive

torch.set_num_threads(1)


def _timed_cloud(seed, capacity=2560):
    pts = box_room_scan(seed)
    times = np.linspace(-0.05, 0.049, len(pts)).astype(np.float32)
    return pad_timed_cloud(pts, times, capacity)


def _assert_same_timed(got, want):
    for name in ("positions", "times", "mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))


@pytest.mark.parametrize("resolution", [0.1, 0.45])
def test_voxel_filter_timed_exact(resolution):
    cloud = _timed_cloud(1)
    want = voxel_filter_timed(TimedPointCloud(*(jnp.asarray(x) for x in cloud)), resolution)
    got = tvf.voxel_filter_timed(convert.timed_point_cloud(cloud, CPU), resolution)
    _assert_same_timed(got, want)


@pytest.mark.parametrize("which", ["high", "low", "sparse"])
def test_adaptive_voxel_filter_timed_and_compaction_exact(which):
    opts = {
        "high": jcfg.AdaptiveVoxelFilterOptions(max_length=2.0, min_num_points=150, max_range=15.0),
        "low": jcfg.AdaptiveVoxelFilterOptions(max_length=4.0, min_num_points=200, max_range=60.0),
        "sparse": jcfg.AdaptiveVoxelFilterOptions(max_length=2.0, min_num_points=5000, max_range=15.0),
    }[which]
    cloud = _timed_cloud(2, capacity=1024)
    want = adaptive_voxel_filter_timed(TimedPointCloud(*(jnp.asarray(x) for x in cloud)), opts)
    got = tvf.adaptive_voxel_filter_timed(convert.timed_point_cloud(cloud, CPU), convert.options(opts))
    _assert_same_timed(got, want)
    for capacity in (256, 2048):
        _assert_same_timed(tvf.compact_timed_cloud(got, capacity), compact_timed_cloud(want, capacity))
        pc = tvf.compact_cloud(ttypes.PointCloud(got.positions, got.mask), capacity)
        ref = compact_cloud(PointCloud(want.positions, want.mask), capacity)
        np.testing.assert_array_equal(pc.positions.numpy(), np.asarray(ref.positions))
        np.testing.assert_array_equal(pc.mask.numpy(), np.asarray(ref.mask))


def _room_range_data(seed):
    pts = box_room_scan(seed).astype(np.float32)
    return RangeData(
        origin=jnp.asarray([0.3, -0.2, 0.1], jnp.float32),
        returns=pad_cloud(pts + np.array([0.3, -0.2, 0.1], np.float32), 4096),
        misses=pad_cloud(np.zeros((0, 3), np.float32), 8),
    )


@pytest.mark.parametrize("which", ["high", "low"])
def test_insert_tsdf_3d_matches_jax(which):
    sub = jcfg.SubmapsOptions3D()
    inserter = (sub.high_resolution_range_data_inserter if which == "high"
                else sub.low_resolution_range_data_inserter).tsdf_range_data_inserter
    res, size = (0.1, 96) if which == "high" else (0.45, 48)
    grid = make_tsdf_grid(res, (size,) * 3, inserter.relative_truncation_distance * res, inserter.maximum_weight)
    tgrid = convert.tsdf_grid(grid, CPU)
    insert = make_tsdf_inserter_3d(inserter, res)
    tinsert = tins.make_tsdf_inserter_3d(convert.options(inserter), res)
    for seed in (3, 4, 5):
        rd = _room_range_data(seed)
        grid = insert(grid, rd)
        tgrid = tinsert(tgrid, convert.range_data(rd, CPU))
    w, tsd = np.asarray(grid.weight), np.asarray(grid.tsd)
    assert (w > 0).sum() > 1000
    bad = (np.abs(tgrid.weight.numpy() - w) > 1e-5) | (np.abs(tgrid.tsd.numpy() - tsd) > 1e-5)
    assert bad.sum() <= max(1, 1e-4 * w.size), f"{bad.sum()} of {w.size} cells differ"


def _assert_same_occupancy(tgrid, grid):
    np.testing.assert_array_equal(tgrid.known.numpy(), np.asarray(grid.known))
    np.testing.assert_allclose(tgrid.log_odds.numpy(), np.asarray(grid.log_odds), rtol=0, atol=1e-6)


@pytest.mark.parametrize("which", ["high", "low", "behind"])
def test_insert_probability_3d_matches_jax(which):
    """The default occupancy inserters (hi: two free-space voxels before
    each hit; lo: none), and with "behind" the hi inserter from an origin
    at the grid's center, so that hits lie behind it on every axis and the
    miss cells' (delta * pos) // n floors negative quotients."""
    sub = jcfg.SubmapsOptions3D()
    inserter = (sub.low_resolution_range_data_inserter if which == "low"
                else sub.high_resolution_range_data_inserter).probability_grid_range_data_inserter
    res, size = (0.45, 48) if which == "low" else (0.1, 96)
    grid = make_probability_grid(res, (size,) * 3)
    tgrid = convert.probability_grid(grid, CPU)
    insert = make_probability_inserter_3d(inserter)
    tinsert = tins.make_probability_inserter_3d(convert.options(inserter))
    for seed in (3, 4, 5):
        rd = _room_range_data(seed)
        if which == "behind":
            origin = np.asarray(rd.origin)
            delta = np.floor((np.asarray(rd.returns.positions) - origin) / res)[np.asarray(rd.returns.mask)]
            assert (delta < 0).any(axis=0).all() and (delta > 0).any(axis=0).all()
        grid = insert(grid, rd)
        tgrid = tinsert(tgrid, convert.range_data(rd, CPU))
    assert int(np.asarray(grid.known).sum()) > 1000
    if which != "low":
        assert int((np.asarray(grid.log_odds) < 0).sum()) > 100  # miss cells were written
    _assert_same_occupancy(tgrid, grid)


@pytest.mark.parametrize("method", ["KNN_PCA", "CLOUD_STRUCTURE", "TRIANGLE_FILL_IN"])
def test_tsdf_inserter_refuses_unported_modes(method):
    """The normal-directed modes, once refused, now run: one organized
    scan inserted by each method matches the JAX package's insertion
    within the TSDF inserter's tolerance (1e-5 in all but 1e-4 of the
    cells): a box-room scan (width 96) for the organized-cloud methods, a
    wall patch for KNN_PCA, whose neighbourhoods in a sparse room scan are
    rows of points with no defined normal (an eigenvector of two near-equal
    eigenvalues). tests/test_torch_frontend_extras.py holds the normals
    themselves."""
    from torch_parity import organized_room_range_data, wall_range_data

    opts = jcfg.TSDFRangeDataInserterOptions3D(normal_computation_method=method, min_range=0.4, max_range=30.0)
    rd, width = wall_range_data(3) if method == "KNN_PCA" else organized_room_range_data(3)
    grid = make_tsdf_grid(0.1, (80, 72, 32), 0.3, 1000.0)
    want = make_tsdf_inserter_3d(opts, 0.1)(grid, rd)
    got = tins.make_tsdf_inserter_3d(convert.options(opts), 0.1)(convert.tsdf_grid(grid, CPU),
                                                                 convert.range_data(rd, CPU))
    w, tsd = np.asarray(want.weight), np.asarray(want.tsd)
    assert (w > 0).sum() > (300 if method == "KNN_PCA" else 1000)
    bad = (np.abs(got.weight.numpy() - w) > 1e-5) | (np.abs(got.tsd.numpy() - tsd) > 1e-5)
    assert bad.sum() <= max(1, 1e-4 * w.size), f"{bad.sum()} of {w.size} cells differ"


@pytest.mark.parametrize("seed", [6, 7])
def test_compute_histogram_matches_jax(seed):
    cloud = pad_cloud(box_room_scan(seed, az=128, el=32).astype(np.float32), 4096)
    want = np.asarray(compute_histogram(cloud.positions, cloud.mask, 120))
    got = thist.compute_histogram(convert.tensor(cloud.positions, CPU), convert.tensor(cloud.mask, CPU), 120).numpy()
    assert want.sum() > 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * want.sum())


@pytest.mark.parametrize("grid_type", ["TSDF", "PROBABILITY_GRID"])
def test_active_submaps_match_jax(grid_type):
    opts = jcfg.replace_deep(jcfg.SubmapsOptions3D(), {
        "grid_type": grid_type, "high_grid_size": 48, "low_grid_size": 24, "num_range_data": 2})
    jsub = ActiveSubmaps3D(opts, 120)
    tsubmaps = tsub.ActiveSubmaps3D(convert.options(opts), CPU, 120)
    hist = np.ones(120, np.float32)
    for seed, origin in ((3, [0.31, -0.17, 0.05]), (4, [0.63, 0.02, -0.11]), (5, [1.07, 0.4, 0.0])):
        rd = _room_range_data(seed)
        jsub.insert_data(rd, hist, np.asarray(origin))
        tsubmaps.insert_data(convert.range_data(rd, CPU), hist, np.asarray(origin))
    assert len(jsub.submaps) == len(tsubmaps.submaps) == 2
    for js, ts in zip(jsub.submaps, tsubmaps.submaps):
        assert js.num_range_data == ts.num_range_data
        assert js.insertion_finished == ts.insertion_finished
        np.testing.assert_array_equal(js.local_pose.t, ts.local_pose.t)
        np.testing.assert_array_equal(js.rotational_histogram, ts.rotational_histogram)
        for attr in ("high_resolution_grid", "low_resolution_grid"):
            jg, tg = getattr(js, attr), getattr(ts, attr)
            # The snapped corner decides every cell floor: equal to the bit.
            np.testing.assert_array_equal(tg.meta.min_corner.numpy(), np.asarray(jg.meta.min_corner))
            if grid_type == "TSDF":
                assert (np.abs(tg.weight.numpy() - np.asarray(jg.weight)) > 1e-5).sum() <= 1e-4 * tg.weight.numel()
            else:
                assert int(np.asarray(jg.known).sum()) > 100
                _assert_same_occupancy(tg, jg)
    # Half-precision storage: TSDF planes in the storage dtype, as the JAX
    # package's; occupancy grids refuse it in both packages
    # (tests/test_torch_half_storage.py holds the half path's values).
    for dtype in ("float16", "bfloat16"):
        half = jcfg.replace_deep(opts, {"grid_storage_dtype": dtype})
        if grid_type == "TSDF":
            jg = ActiveSubmaps3D(half)._make_high()
            tg = tsub.ActiveSubmaps3D(convert.options(half), CPU)._make_high()
            assert tg.tsd.dtype == tg.weight.dtype == getattr(torch, dtype)
            assert torch.equal(convert.tsdf_grid(jg, CPU).tsd, tg.tsd)
        else:
            with pytest.raises(ValueError, match="only supported for TSDF"):
                ActiveSubmaps3D(half)
            with pytest.raises(ValueError, match="only supported for TSDF"):
                tsub.ActiveSubmaps3D(convert.options(half), CPU)


@pytest.mark.parametrize("grid_type", ["TSDF", "PROBABILITY_GRID"])
def test_submap_uint16_finish_and_codec_match_jax(grid_type):
    """grid_storage_dtype="uint16": a finished submap's grids become the
    JAX package's codes (occupancy: equal to the bit; TSDF: within one code,
    9.2e-6 m at a 0.3 m truncation, about the inserter's 1e-5, in all but
    its 1e-4 of cells). On the same f32 grids (the active submap,
    carried across) the codes are equal to the bit and decode within 1e-6
    in log-odds, exactly for a TSDF. prepared_grids decodes a uint16
    submap on every call and caches an f32 one by version."""
    from hectorgrapher_tpu.mapping import grids as jgrids
    from hectorgrapher_tpu_torch.mapping import grids as tgrids

    opts = jcfg.replace_deep(jcfg.SubmapsOptions3D(), {
        "grid_type": grid_type, "high_grid_size": 32, "low_grid_size": 16, "num_range_data": 1,
        "grid_storage_dtype": "uint16"})
    jsub = ActiveSubmaps3D(opts, 120)
    tsubmaps = tsub.ActiveSubmaps3D(convert.options(opts), CPU, 120)
    hist = np.ones(120, np.float32)
    for seed, origin in ((3, [0.31, -0.17, 0.05]), (4, [0.63, 0.02, -0.11])):
        rd = _room_range_data(seed)
        jsub.insert_data(rd, hist, np.asarray(origin))
        tsubmaps.insert_data(convert.range_data(rd, CPU), hist, np.asarray(origin))
    (js, jactive), (ts, tactive) = jsub.submaps, tsubmaps.submaps
    assert js.insertion_finished and ts.insertion_finished and not tactive.insertion_finished
    quantize = tgrids.quantize_tsdf_grid if grid_type == "TSDF" else tgrids.quantize_probability_grid
    jquantize = jgrids.quantize_tsdf_grid if grid_type == "TSDF" else jgrids.quantize_probability_grid
    planes = ("tsd", "weight") if grid_type == "TSDF" else ("log_odds",)
    for attr in ("high_resolution_grid", "low_resolution_grid"):
        jg, tg = getattr(js, attr), getattr(ts, attr)
        for plane in planes:
            got, want = getattr(tg, plane), np.asarray(getattr(jg, plane))
            assert got.dtype == torch.uint16 and int((want > 0).sum()) > 50
            step = np.abs(got.numpy().astype(np.int64) - want.astype(np.int64))
            differ = int((step > (1 if grid_type == "TSDF" else 0)).sum())
            assert differ <= (1e-4 * want.size if grid_type == "TSDF" else 0), f"{plane}: {differ} codes differ"
        # The codec on the same f32 grid.
        jf = getattr(jactive, attr)
        jq, tq = jquantize(jf), quantize(convert.grid_3d(jf, CPU))
        jd, td = jgrids.ensure_f32_grid(jq), tgrids.ensure_f32_grid(tq)
        for plane in planes:
            np.testing.assert_array_equal(getattr(tq, plane).numpy(), np.asarray(getattr(jq, plane)))
            np.testing.assert_allclose(getattr(td, plane).numpy(), np.asarray(getattr(jd, plane)), rtol=0,
                                       atol=1e-6 if plane == "log_odds" else 0)
    assert tactive.prepared_grids() is tactive.prepared_grids()  # one field per version
    hi, _ = ts.prepared_grids()
    assert hi is not ts.prepared_grids()[0]  # decoded per call
    if grid_type != "TSDF":
        want = np.asarray(jgrids.dequantize_probability_grid(js.high_resolution_grid).probability())
        np.testing.assert_allclose(hi.prob.numpy(), want, rtol=0, atol=1e-6)


def test_interpolation_buffer_matches_jax():
    rng = np.random.default_rng(8)
    jbuf, tbuf = TransformInterpolationBuffer(), tinterp.TransformInterpolationBuffer()
    for i in range(20):
        t = rng.normal(0, 0.3, 3) + [0.1 * i, 0, 0]
        q = nq.quat_from_axis_angle(np.array([0.0, 0.0, 0.05 * i]))
        jbuf.push(0.05 * i, Rigid3(t, q))
        tbuf.push(0.05 * i, TNpRigid3(t, q))
    for time in rng.uniform(0.0, 0.95, 16):
        want, got = jbuf.lookup(time), tbuf.lookup(time)
        np.testing.assert_allclose(got.t, np.asarray(want.translation), atol=1e-12)
        np.testing.assert_allclose(got.q, np.asarray(want.rotation), atol=1e-12)
    for args in ((0.1, 0.2, 0.1, 0.025, 0.25), (0.3, 10.0, 10.0, 0.025, 0.25), (0.9, 0.2, 0.1, 0.025, 0.25)):
        assert tbuf.lookup_until_delta(*args) == jbuf.lookup_until_delta(*args)


# ---------------------------------------------------------------------------
# The front end, both builders over the same 1.5 s
# ---------------------------------------------------------------------------


def _front_end_options(grid_type):
    return jcfg.replace_deep(make_options(), {"submaps.grid_type": grid_type})


@pytest.fixture(scope="module", params=["TSDF", "PROBABILITY_GRID"])
def jax_front_end(request):
    builder = OptimizingLocalTrajectoryBuilder(_front_end_options(request.param))
    return ct_drive(builder, NpRigid3, TimedPointCloudData, pad_timed_cloud), builder, request.param


def test_front_end_matches_jax(jax_front_end):
    want, jbuilder, grid_type = jax_front_end
    builder = tbuilder.OptimizingLocalTrajectoryBuilder(convert.options(_front_end_options(grid_type)), CPU)
    got = ct_drive(builder, TNpRigid3, ttypes.TimedPointCloudData, ttypes.pad_timed_cloud)
    assert len(got) == len(want) >= 4
    assert builder.num_optimizations == jbuilder.num_optimizations > 0
    for (tg, pg), (tw, pw) in zip(got, want):
        assert tg == tw
        assert np.abs(pg.t - pw.t).max() < 1e-3
        assert nq.quat_angle(nq.quat_multiply(nq.quat_conjugate(pw.q), pg.q)) < 1e-3
    submap = builder.active_submaps.matching_submap
    grid = submap.high_resolution_grid
    known = grid.weight > 0 if grid_type == "TSDF" else grid.known
    assert int(known.sum()) > 1000
    assert submap.rotational_histogram.sum() > 0


@pytest.mark.parametrize("per_point,direct", [(True, False), (False, True), (True, True)],
                         ids=["per_point", "direct", "per_point_direct"])
def test_front_end_refuses_unported_options(per_point, direct):
    """use_per_point_unwarping and imu_cost_term="DIRECT", once refused,
    now run: over the 1.5 s drive the port's front end gives the JAX
    package's results within 1e-3 m and 1e-3 rad, with as many window
    solves, on TSDF submaps."""
    over = {"optimizing_local_trajectory_builder.use_per_point_unwarping": per_point}
    if direct:
        over["optimizing_local_trajectory_builder.imu_cost_term"] = "DIRECT"
    opts = jcfg.replace_deep(_front_end_options("TSDF"), over)
    jbuilder = OptimizingLocalTrajectoryBuilder(opts)
    want = ct_drive(jbuilder, NpRigid3, TimedPointCloudData, pad_timed_cloud)
    builder = tbuilder.OptimizingLocalTrajectoryBuilder(convert.options(opts), CPU)
    got = ct_drive(builder, TNpRigid3, ttypes.TimedPointCloudData, ttypes.pad_timed_cloud)
    assert len(got) == len(want) >= 4
    assert builder.num_optimizations == jbuilder.num_optimizations > 0
    for (tg, pg), (tw, pw) in zip(got, want):
        assert tg == tw
        assert np.abs(pg.t - pw.t).max() < 1e-3
        assert nq.quat_angle(nq.quat_multiply(nq.quat_conjugate(pw.q), pg.q)) < 1e-3
