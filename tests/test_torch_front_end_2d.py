"""Parity of the port's 2D front end (hectorgrapher_tpu_torch) with the JAX
package's: voxel filters, the probability inserter, the active submaps and
LocalTrajectoryBuilder2D, on the CPU with the same seeded numpy inputs.

Tolerances, each with its reason:
  * voxel filters: exact — the same kept points in the same order (the
    port's stable sorts reproduce jnp.lexsort's order);
  * inserter: log_odds within 1e-6 (f32 adds of the same constants),
    `known` equal;
  * front end: local poses within 1e-3 m and 1e-3 rad over a few scans —
    flipped cells in the correlative match (see
    test_torch_correlative_2d.py) move the GN start by one cell at most,
    and the refinement lands within that of the same optimum.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hectorgrapher_tpu.common import config as jcfg
from hectorgrapher_tpu.evaluation.scan_generator import raycast_rect_room_2d
from hectorgrapher_tpu.mapping.grids import make_probability_grid
from hectorgrapher_tpu.mapping.inserters_2d import insert_probability_2d
from hectorgrapher_tpu.mapping.local_2d import LocalTrajectoryBuilder2D
from hectorgrapher_tpu.mapping.submap_2d import ActiveSubmaps2D
from hectorgrapher_tpu.sensor.types import PointCloud, RangeData, TimedPointCloudData, pad_cloud, pad_timed_cloud
from hectorgrapher_tpu.sensor.voxel_filter import adaptive_voxel_filter, voxel_filter
from hectorgrapher_tpu.transform import np_quat as nq
from hectorgrapher_tpu.transform.np_quat import NpRigid3
from hectorgrapher_tpu_torch import convert
from hectorgrapher_tpu_torch.mapping import inserters_2d as tins
from hectorgrapher_tpu_torch.mapping import local_2d as tlocal
from hectorgrapher_tpu_torch.mapping import submap_2d as tsubmap
from hectorgrapher_tpu_torch.sensor import types as ttypes
from hectorgrapher_tpu_torch.sensor import voxel_filter as tvf
from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3 as TNpRigid3
from torch_parity import CPU

torch.set_num_threads(1)


def _clumped_cloud(seed, n=1024, n_valid=900):
    """Points in clumps so that most voxels hold several of them, plus
    masked-out padding."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-3.0, 3.0, (64, 3)) * np.array([1.0, 1.0, 0.2])
    pts = centers[rng.integers(0, 64, n)] + rng.normal(0, 0.08, (n, 3))
    mask = np.arange(n) < n_valid
    return PointCloud(positions=jnp.asarray(pts, jnp.float32), mask=jnp.asarray(mask))


def _assert_same_cloud(got, want):
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.positions.numpy(), np.asarray(want.positions))


@pytest.mark.parametrize("resolution", [0.05, 0.2])
def test_voxel_filter_keeps_same_points(resolution):
    cloud = _clumped_cloud(1)
    want = voxel_filter(cloud, resolution)
    got = tvf.voxel_filter(convert.point_cloud(cloud, CPU), resolution)
    assert 50 < int(np.asarray(want.mask).sum()) < 900  # voxels do hold several points
    _assert_same_cloud(got, want)


@pytest.mark.parametrize("min_num_points", [100, 400, 2000])
def test_adaptive_voxel_filter_keeps_same_points(min_num_points):
    cloud = _clumped_cloud(2)
    opts = jcfg.AdaptiveVoxelFilterOptions(max_length=0.5, min_num_points=min_num_points, max_range=4.0)
    want = adaptive_voxel_filter(cloud, opts)
    got = tvf.adaptive_voxel_filter(convert.point_cloud(cloud, CPU), convert.options(opts))
    _assert_same_cloud(got, want)


def _scan_range_data(seed, xy, yaw, n_rays=720, capacity=1024, max_range=3.5):
    """A room scan in the local frame, with returns beyond max_range moved
    to the misses (as the front end does)."""
    rng = np.random.default_rng(seed)
    pts = raycast_rect_room_2d(np.asarray(xy), yaw, num_rays=n_rays, noise_std=0.01, rng=rng)
    pts = pts[~np.isnan(pts[:, 0])]
    c, s = np.cos(yaw), np.sin(yaw)
    world = pts @ np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]]) + np.array([xy[0], xy[1], 0.0])
    far = np.linalg.norm(pts, axis=-1) > max_range
    returns = pad_cloud(world[~far].astype(np.float32), capacity)
    misses = pad_cloud(world[far].astype(np.float32), capacity)
    return RangeData(origin=jnp.asarray([xy[0], xy[1], 0.0], jnp.float32), returns=returns, misses=misses)


def test_insert_probability_matches():
    grid = make_probability_grid(0.05, (256, 256), center=(0.3, -0.2))
    tgrid = convert.probability_grid(grid, CPU)
    for i, (xy, yaw) in enumerate([((0.0, 0.0), 0.0), ((0.3, 0.1), 0.2), ((0.5, -0.2), 0.4)]):
        rd = _scan_range_data(i, xy, yaw)
        grid = insert_probability_2d(grid, rd, 0.2, -0.04, num_samples=200)
        tgrid = tins.insert_probability_2d(tgrid, convert.range_data(rd, CPU), 0.2, -0.04, num_samples=200)
    np.testing.assert_array_equal(tgrid.known.numpy(), np.asarray(grid.known))
    np.testing.assert_allclose(tgrid.log_odds.numpy(), np.asarray(grid.log_odds), rtol=0, atol=1e-6)
    assert 0.05 < float(np.asarray(grid.known).mean()) < 0.9


def test_active_submaps_spawn_and_finish():
    opts = jcfg.replace_deep(jcfg.SubmapsOptions2D(), {"num_range_data": 2, "grid_size": 96})
    jsub = ActiveSubmaps2D(opts, max_ray_length=5.0)
    tsub = tsubmap.ActiveSubmaps2D(convert.options(opts), CPU, max_ray_length=5.0)
    for i in range(6):
        xy = (0.1 * i, 0.05 * i)
        rd = _scan_range_data(10 + i, xy, 0.1 * i, max_range=2.2)
        origin = np.array([xy[0], xy[1], 0.0])
        jl = jsub.insert_range_data(rd, origin)
        tl = tsub.insert_range_data(convert.range_data(rd, CPU), origin)
        assert len(tl) == len(jl)
        for a, b in zip(tl, jl):
            assert (a.num_range_data, a.insertion_finished) == (b.num_range_data, b.insertion_finished)
            np.testing.assert_array_equal(a.local_pose.t, b.local_pose.t)
            np.testing.assert_array_equal(a.grid.meta.min_corner.numpy(), np.asarray(b.grid.meta.min_corner))
            np.testing.assert_array_equal(a.grid.known.numpy(), np.asarray(b.grid.known))
            np.testing.assert_allclose(a.grid.log_odds.numpy(), np.asarray(b.grid.log_odds), rtol=0, atol=1e-6)
    assert jl[0].insertion_finished and not jl[1].insertion_finished


def _front_end_options():
    """The slice's configuration cut to test size: a 256^2 submap (12.8 m),
    max_range 12 m and a 10 degree window (fewer candidate angles)."""
    return jcfg.replace_deep(
        jcfg.TrajectoryBuilder2DOptions(),
        {
            "use_imu_data": False,
            "use_online_correlative_scan_matching": True,
            "max_range": 12.0,
            "real_time_correlative_scan_matcher.linear_search_window": 0.15,
            "real_time_correlative_scan_matcher.angular_search_window": float(np.radians(10.0)),
            "submaps.grid_size": 256,
            "submaps.num_range_data": 3,
            "max_num_points": 1024,
            "motion_filter.max_distance_meters": 0.05,
            "motion_filter.max_time_seconds": 0.1,
        },
    )


def test_local_trajectory_builder_matches_jax():
    opts = _front_end_options()
    jb = LocalTrajectoryBuilder2D(opts)
    tb = tlocal.LocalTrajectoryBuilder2D(convert.options(opts), device=CPU)
    rng = np.random.default_rng(0)
    n_scans, radius, center = 7, 1.4, (0.6, 0.5)
    n_inserted = 0
    for i in range(n_scans):
        t = 0.1 * i
        a = 2 * np.pi * i / 60  # the slice's circle at 60 scans per lap
        xy = np.array([center[0] + radius * np.cos(a), center[1] + radius * np.sin(a)])
        yaw = a + np.pi / 2
        q = nq.quat_from_axis_angle(np.array([0.0, 0.0, yaw]))
        odom_t = np.array([xy[0], xy[1], 0.0]) + rng.normal(0, 0.003, 3)
        jb.add_odometry_data(t, NpRigid3(odom_t, q))
        tb.add_odometry_data(t, TNpRigid3(odom_t, q))
        pts = raycast_rect_room_2d(xy, yaw, num_rays=720, noise_std=0.004, rng=rng)
        pts = pts[~np.isnan(pts[:, 0])].astype(np.float32)
        cloud = pad_timed_cloud(pts, np.zeros(len(pts), np.float32), 1024)
        rj = jb.add_range_data(TimedPointCloudData(time=t, origin=np.zeros(3, np.float32), ranges=cloud))
        rt = tb.add_range_data(
            ttypes.TimedPointCloudData(
                time=t, origin=np.zeros(3, np.float32),
                ranges=ttypes.TimedPointCloud(cloud.positions, cloud.times, cloud.mask),
            )
        )
        np.testing.assert_allclose(rt.local_pose.t, rj.local_pose.t, rtol=0, atol=1e-3)
        dyaw = nq.quat_yaw(rt.local_pose.q) - nq.quat_yaw(rj.local_pose.q)
        assert abs((dyaw + np.pi) % (2 * np.pi) - np.pi) <= 1e-3
        assert (rt.insertion_result is None) == (rj.insertion_result is None)
        n_inserted += rt.insertion_result is not None
    assert n_inserted >= 3
    assert len(tb.active_submaps.submaps) == 2  # the second submap has been spawned
    assert bool(tb.active_submaps.matching_submap.grid.known.any())
