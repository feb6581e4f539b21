"""The port's classic 3D front end (hectorgrapher_tpu_torch/mapping/
local_3d.py) against the JAX package's LocalTrajectoryBuilder3D, on the
CPU: tests/test_local_3d_classic.py's 2.5 s straight drive (IMU at 100 Hz,
noisy odometry at 20 Hz, 0.2 m/s after a 0.5 s rest) at 96^3 / 48^3, on
PROBABILITY_GRID and TSDF submaps, with the online correlative search off
and on.

Tolerances: the same scans give results, each result's pose within 1e-3 m
(and 1e-3 in each quaternion entry) of JAX's, the same insertions; the
port also meets the bounds of JAX's own test (max error < 0.2 m, relative
motion over the second half within 20%). Both sides get the scan times as
float64 (ROADMAP C25).

On TSDF submaps with the correlative search on, the drive is chaotic in
both packages (ROADMAP C29): the search's yaw step at 25 m is 0.004 rad,
the motion filter's angle threshold, so a 1e-4 m difference in a GN3D
result (the packages' TSDF maps differ within C3's tolerance) flips an
insertion, and the trajectories part from 1.66 s on; the JAX builder
itself then misses its test's relative-motion bound. There every scan's
match (the correlative search, then GN3D) is held instead: the port's
_scan_match on the JAX drive's own submap grids, prediction and clouds,
within 1e-3 m of the JAX builder's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hectorgrapher_tpu.common.config import TrajectoryBuilder3DOptions, replace_deep
from hectorgrapher_tpu.evaluation.scan_generator import raycast_box_room_3d
from hectorgrapher_tpu.mapping.local_3d import LocalTrajectoryBuilder3D as JaxBuilder
from hectorgrapher_tpu.sensor.types import TimedPointCloudData as JaxScan
from hectorgrapher_tpu.sensor.types import pad_timed_cloud as jax_pad_timed_cloud
from hectorgrapher_tpu.transform import np_quat as nq
from hectorgrapher_tpu.transform.np_quat import NpRigid3 as JaxRigid3
from hectorgrapher_tpu_torch import convert
from hectorgrapher_tpu_torch.mapping.local_3d import LocalTrajectoryBuilder3D
from hectorgrapher_tpu_torch.sensor.types import TimedPointCloudData, pad_timed_cloud
from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3
from torch_parity import CPU

torch.set_num_threads(2)

GRAVITY = np.array([0.0, 0.0, 9.80665])
SPEED, REST = 0.2, 0.5


def gt_x(t):
    return SPEED * max(0.0, t - REST)


def drive_events(duration=2.5, seed=0):
    """tests/test_local_3d_classic.py's event stream: ("imu", t), ("odom",
    t, translation) and ("scan", t, points), in the order it feeds them."""
    rng = np.random.default_rng(seed)
    dt_imu, dt_odom, dt_scan = 0.01, 0.05, 0.1
    t, next_odom, next_scan, events = 0.0, 0.0, 0.05, []
    while t <= duration:
        events.append(("imu", t))
        if t >= next_odom:
            events.append(("odom", t, np.array([gt_x(t), 0, 0]) + rng.normal(0, 0.002, 3)))
            next_odom += dt_odom
        if t >= next_scan:
            pts = raycast_box_room_3d(np.array([gt_x(t), 0.0, 0.0]), nq.quat_identity(), num_azimuth=96,
                                      num_elevation=24)
            events.append(("scan", t, pts[~np.isnan(pts[:, 0])]))
            next_scan += dt_scan
        t = round(t + dt_imu, 6)
    return events


def run_jax(options, events):
    builder, results = JaxBuilder(options), []
    q = nq.quat_identity()
    for ev in events:
        if ev[0] == "imu":
            builder.add_imu_data(ev[1], nq.quat_rotate(nq.quat_conjugate(q), GRAVITY), np.zeros(3))
        elif ev[0] == "odom":
            builder.add_odometry_data(ev[1], JaxRigid3(ev[2], q))
        else:
            cloud = jax_pad_timed_cloud(ev[2], np.zeros(len(ev[2]), np.float32), 2560)
            r = builder.add_range_data(JaxScan(time=np.float64(ev[1]), origin=jnp.zeros(3, jnp.float32),
                                               ranges=cloud))
            if r is not None:
                results.append(r)
    return builder, results


def run_port(options, events, device=CPU):
    builder, results = LocalTrajectoryBuilder3D(options, device=device), []
    q = nq.quat_identity()
    for ev in events:
        if ev[0] == "imu":
            builder.add_imu_data(ev[1], nq.quat_rotate(nq.quat_conjugate(q), GRAVITY), np.zeros(3))
        elif ev[0] == "odom":
            builder.add_odometry_data(ev[1], NpRigid3(ev[2], q))
        else:
            cloud = pad_timed_cloud(ev[2], np.zeros(len(ev[2]), np.float32), 2560)
            r = builder.add_range_data(TimedPointCloudData(time=np.float64(ev[1]), origin=np.zeros(3, np.float32),
                                                           ranges=cloud))
            if r is not None:
                results.append(r)
    return builder, results


def drive_options(grid_type, correlative):
    return replace_deep(TrajectoryBuilder3DOptions(), {
        "min_range": 0.4, "max_range": 25.0, "submaps.grid_type": grid_type, "submaps.high_grid_size": 96,
        "submaps.low_grid_size": 48, "use_online_correlative_scan_matching": correlative})


def check_jax_test_bounds(results):
    """tests/test_local_3d_classic.py's assertions."""
    assert len(results) >= 10
    errs = [np.linalg.norm(r.local_pose.t - np.array([gt_x(r.time), 0, 0])) for r in results]
    assert max(errs) < 0.2, f"max error {max(errs)}"
    half = len(results) // 2
    est_delta = results[-1].local_pose.t[0] - results[half].local_pose.t[0]
    gt_delta = gt_x(results[-1].time) - gt_x(results[half].time)
    assert abs(est_delta - gt_delta) < 0.2 * max(gt_delta, 0.1), f"relative motion {est_delta} vs gt {gt_delta}"


@pytest.fixture(scope="module")
def events():
    return drive_events()


@pytest.mark.parametrize("grid_type, correlative", [("PROBABILITY_GRID", False), ("PROBABILITY_GRID", True),
                                                     ("TSDF", False)],
                         ids=["PROBABILITY_GRID-gn_only", "PROBABILITY_GRID-correlative", "TSDF-gn_only"])
def test_straight_drive_matches_jax(events, grid_type, correlative):
    options = drive_options(grid_type, correlative)
    jax_builder, want = run_jax(options, events)
    builder, got = run_port(convert.options(options), events)
    assert [r.time for r in got] == [r.time for r in want]
    assert [r.insertion_result is not None for r in got] == [r.insertion_result is not None for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.local_pose.t, w.local_pose.t, atol=1e-3)
        np.testing.assert_allclose(g.local_pose.q, w.local_pose.q, atol=1e-3)
    check_jax_test_bounds(got)
    assert len(builder.active_submaps.submaps) == len(jax_builder.active_submaps.submaps) >= 1
    hi = builder.active_submaps.submaps[0].high_resolution_grid
    assert (hi.weight > 0).any() if grid_type == "TSDF" else hi.known.any()


class _MatchingSubmap:
    def __init__(self, submap):
        self.matching_submap = submap


def test_tsdf_correlative_drive_scan_by_scan(events, monkeypatch):
    """TSDF submaps, correlative search on (see the module docstring)."""
    import hectorgrapher_tpu.mapping.local_3d as jax_local_3d
    from hectorgrapher_tpu_torch.mapping.submap_3d import Submap3D

    options = drive_options("TSDF", True)
    matches = []
    scan_match = jax_local_3d.LocalTrajectoryBuilder3D._scan_match

    def recording(self, prediction, high, low):
        submap = self._active_submaps.matching_submap
        out = scan_match(self, prediction, high, low)
        if submap is not None:
            matches.append((submap.high_resolution_grid, submap.low_resolution_grid, prediction, high, low, out))
        return out

    monkeypatch.setattr(jax_local_3d.LocalTrajectoryBuilder3D, "_scan_match", recording)
    _, want = run_jax(options, events)
    builder, got = run_port(convert.options(options), events)
    assert [r.time for r in got] == [r.time for r in want]
    assert len(matches) == len(want) - 1  # every scan but the first matches against a submap

    for hi, lo, prediction, high, low, out in matches:
        builder._active_submaps = _MatchingSubmap(Submap3D(
            local_pose=NpRigid3(np.zeros(3)), high_resolution_grid=convert.grid_3d(hi, CPU),
            low_resolution_grid=convert.grid_3d(lo, CPU), rotational_histogram=np.zeros(120, np.float32)))
        pose = builder._scan_match(NpRigid3(prediction.t, prediction.q), convert.point_cloud(high, CPU),
                                   convert.point_cloud(low, CPU))
        np.testing.assert_allclose(pose.t, out.t, atol=1e-3)
        np.testing.assert_allclose(pose.q, out.q, atol=1e-3)

    # C29: the JAX builder misses its own test's relative-motion bound here.
    half = len(want) // 2
    est_delta = want[-1].local_pose.t[0] - want[half].local_pose.t[0]
    gt_delta = gt_x(want[-1].time) - gt_x(want[half].time)
    assert abs(est_delta - gt_delta) > 0.2 * gt_delta


def test_builder_defaults_to_the_card(monkeypatch):
    """LocalTrajectoryBuilder3D runs on the card unless asked for the CPU
    (ROADMAP C13), builds the kernels up front, and has no CPU fallback."""
    from hectorgrapher_tpu_torch.common import config as cfg
    from hectorgrapher_tpu_torch.ops import _build

    builds = []
    monkeypatch.setattr(_build, "load_library", lambda: builds.append(1))
    options = cfg.TrajectoryBuilder3DOptions()
    assert LocalTrajectoryBuilder3D(options)._device == torch.device("cuda")
    assert builds == [1]
    assert LocalTrajectoryBuilder3D(options, device="cpu")._device == CPU
    assert builds == [1]
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="need a CUDA card"):
        LocalTrajectoryBuilder3D(options)
