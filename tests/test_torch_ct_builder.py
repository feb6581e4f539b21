"""Parity of the port's CT front end (hectorgrapher_tpu_torch) with the JAX
package's: the timed voxel filters and compaction, the 3D TSDF inserter,
the rotational histogram, the 3D submaps, the interpolation buffer and
OptimizingLocalTrajectoryBuilder, on the CPU with the same seeded inputs.

Tolerances, each with its reason:
  * voxel filters and compaction: exact — the port's stable sorts keep
    the same point of each voxel, in the same order;
  * TSDF inserter: weights and tsd within 1e-5 in all but 1e-4 of the
    cells. Under the tests' x64 mode (ROADMAP C1) the JAX inserter
    computes the band points in float64 (jnp.linspace defaults to it)
    before flooring them in float32; the port stays in float32, so a band
    sample on a cell boundary can land one cell over;
  * histogram: within 1e-4 of its sum — the same buckets, sums of f32
    values in another order;
  * interpolation buffer: 1e-12 (the same float64 numpy);
  * front end: local poses within 1e-3 m and 1e-3 rad over 1.5 s of the
    tests/test_ct_builder.py scenario (LM solves that agree to ~1e-6, fed
    maps within the inserter's tolerance).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hectorgrapher_tpu.common import config as jcfg
from hectorgrapher_tpu.mapping.ct.builder import OptimizingLocalTrajectoryBuilder
from hectorgrapher_tpu.mapping.grids import make_tsdf_grid
from hectorgrapher_tpu.mapping.inserters_3d import make_tsdf_inserter_3d
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


def test_tsdf_inserter_refuses_unported_modes():
    opts = convert.options(jcfg.TSDFRangeDataInserterOptions3D(normal_computation_method="KNN_PCA"))
    with pytest.raises(NotImplementedError):
        tins.make_tsdf_inserter_3d(opts, 0.1)
    insert = tins.make_tsdf_inserter_3d(convert.options(jcfg.TSDFRangeDataInserterOptions3D()), 0.1)
    rd = convert.range_data(_room_range_data(3), CPU)._replace(width=96)
    with pytest.raises(NotImplementedError):
        insert(convert.tsdf_grid(make_tsdf_grid(0.1, (8, 8, 8), 0.25, 1000.0), CPU), rd)


@pytest.mark.parametrize("seed", [6, 7])
def test_compute_histogram_matches_jax(seed):
    cloud = pad_cloud(box_room_scan(seed, az=128, el=32).astype(np.float32), 4096)
    want = np.asarray(compute_histogram(cloud.positions, cloud.mask, 120))
    got = thist.compute_histogram(convert.tensor(cloud.positions, CPU), convert.tensor(cloud.mask, CPU), 120).numpy()
    assert want.sum() > 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * want.sum())


def test_active_submaps_match_jax():
    opts = jcfg.replace_deep(jcfg.SubmapsOptions3D(), {
        "grid_type": "TSDF", "high_grid_size": 48, "low_grid_size": 24, "num_range_data": 2})
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
            assert (np.abs(tg.weight.numpy() - np.asarray(jg.weight)) > 1e-5).sum() <= 1e-4 * tg.weight.numel()
    with pytest.raises(NotImplementedError):
        tsub.ActiveSubmaps3D(convert.options(jcfg.SubmapsOptions3D()), CPU)


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


@pytest.fixture(scope="module")
def jax_front_end():
    builder = OptimizingLocalTrajectoryBuilder(make_options())
    return ct_drive(builder, NpRigid3, TimedPointCloudData, pad_timed_cloud), builder


def test_front_end_matches_jax(jax_front_end):
    want, jbuilder = jax_front_end
    builder = tbuilder.OptimizingLocalTrajectoryBuilder(convert.options(make_options()), CPU)
    got = ct_drive(builder, TNpRigid3, ttypes.TimedPointCloudData, ttypes.pad_timed_cloud)
    assert len(got) == len(want) >= 4
    assert builder.num_optimizations == jbuilder.num_optimizations > 0
    for (tg, pg), (tw, pw) in zip(got, want):
        assert tg == tw
        assert np.abs(pg.t - pw.t).max() < 1e-3
        assert nq.quat_angle(nq.quat_multiply(nq.quat_conjugate(pw.q), pg.q)) < 1e-3
    submap = builder.active_submaps.matching_submap
    assert int((submap.high_resolution_grid.weight > 0).sum()) > 1000
    assert submap.rotational_histogram.sum() > 0


def test_front_end_refuses_unported_options():
    for key, value in (("use_per_point_unwarping", True), ("imu_cost_term", "DIRECT")):
        opts = jcfg.replace_deep(make_options(), {f"optimizing_local_trajectory_builder.{key}": value})
        with pytest.raises(NotImplementedError):
            tbuilder.OptimizingLocalTrajectoryBuilder(convert.options(opts), CPU)
