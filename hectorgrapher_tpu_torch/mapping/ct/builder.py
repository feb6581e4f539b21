"""Continuous-time 3D local trajectory builder (counterpart of
hectorgrapher_tpu/mapping/ct/builder.py; ref:
cartographer/mapping/internal/3d/optimizing_local_trajectory_builder.{h,cc}).

Keeps deques of IMU / odometry / point-cloud sets and a sliding window of
control points. On each scan it filters the scan into hi- and lo-res
clouds, places control points (CONSTANT / SYNCED_WITH_RANGE_DATA /
ADAPTIVE), solves the window (window_solver.py, through kernel K3),
marginalizes the clouds that leave the ct_window_horizon, and inserts the
accumulated scan into the active submaps (occupancy, the default, or TSDF)
with a rotational histogram.

Host/device split, as in the JAX package: the streaming state (deques,
extrapolator, control-point bookkeeping) is numpy on the host; the
filters, the window solve, the histogram and the insertion run on
`device`. Per scan the host reads back both filtered clouds in one copy,
the solved state in one copy, and the histogram; the window problem goes
up in one copy.

Every option of the JAX builder runs: use_per_point_unwarping (the window
solve in per-point mode, K3's per-point launch, and each marginalized
point unwarped by its own pose), imu_cost_term="DIRECT" (M = 16 raw IMU
samples a control point pair), and the window_solve_fn hook through which
a caller batches several builders' solves (solve_ct_window_batched).
add_range_data feeds FrontEndMetrics: the step's wall time ends in a host
readback, so it holds the step's device work.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, List, Optional, Tuple

import numpy as np
import torch

import time as _time

from hectorgrapher_tpu_torch.common import profiling
from hectorgrapher_tpu_torch.mapping.ct import imu_integration
from hectorgrapher_tpu_torch.mapping.ct.window_solver import (
    CtProblem,
    CtState,
    CtWeights,
    DirectImuData,
    solve_ct_window,
)
from hectorgrapher_tpu_torch.mapping.frontend_metrics import FrontEndMetrics
from hectorgrapher_tpu_torch.mapping.motion_filter import MotionFilter
from hectorgrapher_tpu_torch.mapping.pose_extrapolator import PoseExtrapolator
from hectorgrapher_tpu_torch.mapping.scan_matching.rotational_histogram import compute_histogram
from hectorgrapher_tpu_torch.mapping.submap_3d import ActiveSubmaps3D, Submap3D
from hectorgrapher_tpu_torch.sensor.types import (
    PointCloud,
    RangeData,
    TimedPointCloud,
    TimedPointCloudData,
    pad_timed_cloud,
)
from hectorgrapher_tpu_torch.sensor.voxel_filter import (
    adaptive_voxel_filter,
    adaptive_voxel_filter_timed,
    compact_cloud,
    compact_timed_cloud,
    voxel_filter,
)
from hectorgrapher_tpu_torch.transform import np_quat as nq
from hectorgrapher_tpu_torch.transform.interpolation import TransformInterpolationBuffer
from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3


def _filtered_clouds_to_host(hi: TimedPointCloud, lo: TimedPointCloud, capacity: int):
    """Both filtered clouds in ONE device-to-host copy: positions, times and
    mask packed into a (2*capacity, 5) f32 array."""

    def one(c):
        return torch.cat([c.positions, c.times[:, None], c.mask[:, None].to(torch.float32)], dim=1)

    packed = torch.cat([one(hi), one(lo)]).cpu().numpy()

    def unpack(a):
        return TimedPointCloud(
            positions=np.ascontiguousarray(a[:, :3]), times=np.ascontiguousarray(a[:, 3]), mask=a[:, 4] > 0.5
        )

    return unpack(packed[:capacity]), unpack(packed[capacity:])


def _to_device(device, arrays: dict) -> dict:
    """Numpy arrays on `device` in ONE host-to-device copy: packed into one
    float32 buffer, then split; bool arrays come back as bool, integer
    arrays as int64 (all values here are small enough for exact float32)."""
    flat = np.concatenate([np.asarray(a, np.float32).reshape(-1) for a in arrays.values()])
    buf = torch.from_numpy(flat).to(device)
    out, start = {}, 0
    for name, a in arrays.items():
        a = np.asarray(a)
        t = buf[start:start + a.size].reshape(a.shape)
        start += a.size
        if a.dtype == bool:
            t = t > 0.5
        elif a.dtype.kind in "iu":
            t = t.to(torch.int64)
        out[name] = t
    return out


def _pad_points(points: np.ndarray, capacity: int) -> np.ndarray:
    """The first `capacity` points as a zero-padded (capacity, 3) f32 array."""
    out = np.zeros((capacity, 3), np.float32)
    n = min(len(points), capacity)
    out[:n] = points[:n]
    return out


@dataclass
class CpState:
    """(ref: internal/3d/state.h State)"""

    translation: np.ndarray
    rotation: np.ndarray  # wxyz
    velocity: np.ndarray

    def to_rigid(self) -> NpRigid3:
        return NpRigid3(self.translation, self.rotation)

    def copy(self) -> "CpState":
        return CpState(self.translation.copy(), self.rotation.copy(), self.velocity.copy())


@dataclass
class ControlPoint:
    """(ref: internal/3d/state.h ControlPoint)"""

    time: float
    state: CpState
    translation_ratio: float = 0.0
    rotation_ratio: float = 0.0
    time_ratio: float = 0.0


@dataclass
class PointCloudSet:
    """(ref: optimizing_local_trajectory_builder.h PointCloudSet)"""

    time: float
    origin: np.ndarray
    points: np.ndarray  # (n, 3) range-filtered points, tracking frame
    times: np.ndarray  # (n,) per-point relative times (<= 0)
    width: int
    high_res: TimedPointCloud  # adaptive-filtered, padded, on the host
    low_res: TimedPointCloud
    min_point_time: float
    max_point_time: float

    @property
    def start_time(self) -> float:
        return self.time + self.min_point_time

    @property
    def end_time(self) -> float:
        return self.time + self.max_point_time


@dataclass
class InsertionResult:
    time: float
    local_pose: NpRigid3
    high_resolution_cloud: PointCloud  # tracking frame
    low_resolution_cloud: PointCloud
    rotational_histogram: np.ndarray
    gravity_alignment: np.ndarray
    insertion_submaps: List[Submap3D]


@dataclass
class PendingWindowSolve:
    """One trajectory's ready window solve, split from its writeback so
    that a caller can batch solves across trajectories (window_solve_fn)."""

    high_grid: object  # the matching submap's prepared grids (Submap3D.prepared_grids)
    low_grid: object
    is_tsdf: bool
    problem: CtProblem
    state0: CtState
    weights: CtWeights
    num_iterations: int
    per_point: bool
    direct: Optional[DirectImuData]
    cps: list
    k: int
    # The solve's final and initial cost (0-d tensors on the card), left
    # here by a solve hook that reports them (cloud/ct_batcher.py).
    cost: Optional[torch.Tensor] = None
    cost0: Optional[torch.Tensor] = None


@dataclass
class MatchingResult:
    time: float
    local_pose: NpRigid3
    range_data_in_local: RangeData
    insertion_result: Optional[InsertionResult]


class OptimizingLocalTrajectoryBuilder:
    def __init__(self, options, device):
        """options: TrajectoryBuilder3DOptions."""
        self._options = options
        self._opt = options.optimizing_local_trajectory_builder
        self._device = torch.device(device)
        self._active_submaps = ActiveSubmaps3D(options.submaps, self._device, options.rotational_histogram_size)
        self._motion_filter = MotionFilter(options.motion_filter)
        self._extrapolator: Optional[PoseExtrapolator] = None
        # Optional hook: PendingWindowSolve -> solved CtState. A caller that
        # serves several trajectories installs a batcher here so that their
        # window solves run as one solve_ct_window_batched; None solves
        # inline (_solve_window_direct).
        self.window_solve_fn = None
        self._frontend_metrics = FrontEndMetrics("ct_3d")

        self._imu_times: List[float] = []
        self._imu_acc: List[np.ndarray] = []
        self._imu_gyro: List[np.ndarray] = []
        self._odom: Deque[Tuple[float, NpRigid3]] = deque()
        self._clouds: Deque[PointCloudSet] = deque()
        self._control_points: Deque[ControlPoint] = deque()

        self._initial_data_time: Optional[float] = None
        self._imu_calibrated = False
        self._gravity_constant = 9.80665
        self._acc_calibration = np.eye(3)
        self._gyro_calibration = np.eye(3)

        self._K = self._opt.max_control_points
        self._C = self._opt.max_clouds_in_window
        self._P = self._opt.points_per_cloud
        self.num_optimizations = 0

    # ------------------------------------------------------------------
    # sensor ingestion (ref: AddImuData/AddOdometryData/AddRangeData)
    # ------------------------------------------------------------------

    def add_imu_data(self, time: float, linear_acceleration, angular_velocity) -> None:
        acc = np.asarray(linear_acceleration, float)
        gyro = np.asarray(angular_velocity, float)
        if self._extrapolator is None:
            self._extrapolator = PoseExtrapolator.initialize_with_imu(
                pose_queue_duration=0.001,
                imu_gravity_time_constant=self._options.imu_gravity_time_constant,
                imu_time=time,
                linear_acceleration=acc,
                angular_velocity=gyro,
            )
            self._initial_data_time = time
        else:
            self._extrapolator.add_imu_data(time, acc, gyro)
        self._imu_times.append(time)
        self._imu_acc.append(acc)
        self._imu_gyro.append(gyro)

    def add_odometry_data(self, time: float, pose: NpRigid3) -> None:
        if self._extrapolator is None:
            return
        self._odom.append((time, pose))
        self._extrapolator.add_odometry_data(time, pose)

    def add_range_data(self, data: TimedPointCloudData) -> Optional[MatchingResult]:
        """The front-end step, timed into FrontEndMetrics: per-scan latency
        and real-time ratios (ref: optimizing_local_trajectory_builder.cc
        :1667-1678). The step ends in host readbacks (the filtered clouds,
        the solved state), so its wall time holds its device work."""
        t0w, t0c = _time.perf_counter(), _time.thread_time()
        result = self._add_range_data_impl(data)
        self._frontend_metrics.observe_step(float(data.time), _time.perf_counter() - t0w, _time.thread_time() - t0c)
        return result

    @property
    def frontend_metrics(self) -> FrontEndMetrics:
        return self._frontend_metrics

    def _add_range_data_impl(self, data: TimedPointCloudData) -> Optional[MatchingResult]:
        """(ref: AddRangeData :188-264)"""
        if self._extrapolator is None:
            return None  # IMU not yet initialized
        if not self._odom:
            return None  # odometry not yet initialized

        time = float(data.time)
        pts = np.asarray(data.ranges.positions)
        mask = np.asarray(data.ranges.mask)
        times = np.asarray(data.ranges.times)
        origin = np.asarray(data.origin)

        ranges = np.linalg.norm(pts - origin[None, :], axis=-1)
        keep = mask & (ranges >= self._options.min_range) & (ranges <= self._options.max_range)
        pts_k = pts[keep]
        times_k = times[keep]
        if len(pts_k) == 0:
            return None
        min_pt = float(times_k.min())
        max_pt = float(times_k.max())

        if self._initial_data_time is None or self._initial_data_time > time + min_pt:
            return None
        if self._odom[0][0] > time + min_pt:
            return None

        # The filters see the first max(P*4, 1024) range-filtered points, as
        # in the JAX package (ROADMAP C8: for an organized cloud these are
        # its lowest rows).
        cloud = pad_timed_cloud(pts_k.astype(np.float32), times_k.astype(np.float32), max(self._P * 4, 1024))
        up = _to_device(self._device, {"positions": cloud.positions, "times": cloud.times, "mask": cloud.mask})
        cloud_dev = TimedPointCloud(up["positions"], up["times"], up["mask"])
        hi = compact_timed_cloud(
            adaptive_voxel_filter_timed(cloud_dev, self._options.high_resolution_adaptive_voxel_filter), self._P
        )
        lo = compact_timed_cloud(
            adaptive_voxel_filter_timed(cloud_dev, self._options.low_resolution_adaptive_voxel_filter), self._P
        )
        hi, lo = _filtered_clouds_to_host(hi, lo, self._P)
        self._clouds.append(
            PointCloudSet(
                time=time,
                origin=origin,
                points=pts_k,
                times=times_k,
                width=int(data.width),
                high_res=hi,
                low_res=lo,
                min_point_time=min_pt,
                max_point_time=max_pt,
            )
        )
        if len(self._clouds) > self._C:
            self._clouds.popleft()  # safety cap
        return self._maybe_optimize(time)

    # ------------------------------------------------------------------
    # control points (ref: AddControlPoint :267-322)
    # ------------------------------------------------------------------

    def _add_control_point(self, t: float, ratios=(0.0, 0.0, 0.0)) -> None:
        if not self._control_points:
            if self._opt.initialize_map_orientation_with_imu:
                g = self._extrapolator.estimate_gravity_orientation(t)
                state = CpState(np.zeros(3), np.asarray(g), np.zeros(3))
            else:
                state = CpState(np.zeros(3), nq.quat_identity(), np.zeros(3))
        else:
            last = self._control_points[-1]
            if not self._active_submaps.submaps:
                state = last.state.copy()
            else:
                state = self._predict_state(last.state, last.time, t)
        self._control_points.append(ControlPoint(t, state, ratios[0], ratios[1], ratios[2]))

    def _odometry_buffer(self) -> TransformInterpolationBuffer:
        buf = TransformInterpolationBuffer()
        for t, p in self._odom:
            buf.push(t, p)
        return buf

    def _predict_state(self, start: CpState, t0: float, t1: float) -> CpState:
        """(ref: PredictStateOdom :1589-1649, the hardcoded default
        upstream.) rel = odom(t0)^-1 * odom(t1); pose1 = pose0 * rel."""
        buf = self._odometry_buffer()

        def lookup(t):
            return buf.lookup(min(max(t, buf.earliest_time), buf.latest_time))

        rel = lookup(t0).inverse().compose(lookup(t1))
        pose0 = start.to_rigid()
        pose1 = pose0.compose(rel)
        dt = max(t1 - t0, 1e-6)
        vel = nq.quat_rotate(pose0.q, rel.t) / dt
        return CpState(pose1.t, pose1.q, vel)

    # ------------------------------------------------------------------
    # the main loop (ref: MaybeOptimize :1114-1413)
    # ------------------------------------------------------------------

    def _maybe_optimize(self, time: float) -> Optional[MatchingResult]:
        if time - self._initial_data_time < self._opt.initialization_duration:
            return None
        if len(self._odom) < 2:
            return None
        if not self._control_points:
            self._add_control_point(max(self._initial_data_time, self._odom[0][0]))

        if not self._imu_calibrated and self._opt.calibrate_imu:
            self._gravity_constant, self._acc_calibration = imu_integration.calibrate_imu_static(
                np.asarray(self._imu_times), np.asarray(self._imu_acc)
            )
            self._imu_calibrated = True

        if not self._place_control_points():
            return None

        # Solve the window, when a submap exists to match against.
        if self._active_submaps.submaps:
            with profiling.section("ct.build_window"):
                pending = self._build_window_solve()
            solve_fn = self.window_solve_fn or self._solve_window_direct
            self._apply_window_solution(pending, solve_fn(pending))
        optimized_pose = self._control_points[0].state.to_rigid()

        time_optimized_pose = self._control_points[0].time
        self._extrapolator.add_pose(time_optimized_pose, optimized_pose)

        accumulated, acc_origin = self._marginalize(optimized_pose)
        self._remove_obsolete_sensor_data()

        if accumulated is None or len(accumulated) == 0:
            return None
        return self._add_accumulated_range_data(time_optimized_pose, optimized_pose, accumulated, acc_origin)

    def _place_control_points(self) -> bool:
        """(ref: MaybeOptimize :1162-1232)"""
        added = False
        mode = self._opt.control_point_sampling
        last_odom_time = self._odom[-1][0]
        if mode == "CONSTANT":
            while (
                self._control_points[-1].time + self._opt.ct_window_rate < last_odom_time
                and len(self._control_points) < self._K
            ):
                self._add_control_point(self._control_points[-1].time + self._opt.ct_window_rate)
                added = True
        elif mode == "SYNCED_WITH_RANGE_DATA":
            imu_last = self._imu_times[-1] if self._imu_times else -np.inf
            for pcs in self._clouds:
                if self._control_points[-1].time < pcs.time < imu_last and len(self._control_points) < self._K:
                    self._add_control_point(pcs.time)
                    added = True
        elif mode == "ADAPTIVE":
            buf = self._odometry_buffer()
            while len(self._control_points) < self._K:
                start = self._control_points[-1].time
                if start >= buf.latest_time:
                    break
                candidate = buf.lookup_until_delta(
                    start,
                    self._opt.sampling_max_delta_translation,
                    self._opt.sampling_max_delta_rotation,
                    self._opt.sampling_min_delta_time,
                    self._opt.sampling_max_delta_time,
                )
                if candidate is None:
                    break
                if candidate - start < self._opt.sampling_min_delta_time:
                    candidate = start + self._opt.sampling_min_delta_time
                if candidate < buf.latest_time:
                    self._add_control_point(candidate)
                    added = True
                else:
                    break
        else:
            raise ValueError(f"unknown control_point_sampling {mode}")
        return added

    def _build_window_solve(self) -> PendingWindowSolve:
        K, C, P = self._K, self._C, self._P
        cps = list(self._control_points)
        k = min(len(cps), K)
        cp_times = np.array([cp.time for cp in cps[:k]])

        cp_mask = np.zeros(K, bool)
        cp_mask[:k] = True
        trans = np.zeros((K, 3), np.float32)
        rot = np.tile(np.array([1, 0, 0, 0], np.float32), (K, 1))
        vel = np.zeros((K, 3), np.float32)
        for i, cp in enumerate(cps[:k]):
            trans[i] = cp.state.translation
            rot[i] = cp.state.rotation
            vel[i] = cp.state.velocity

        # Clouds inside the window with bracketing CPs.
        clouds = [pcs for pcs in self._clouds if cp_times[0] <= pcs.time <= cp_times[-1]][:C]
        t_ref = cp_times[0]
        cloud_mask = np.zeros(C, bool)
        prev_idx = np.zeros(C, np.int32)
        next_idx = np.zeros(C, np.int32)
        factor = np.zeros(C, np.float32)
        cloud_time = np.zeros(C, np.float32)
        hi_pos = np.zeros((C, P, 3), np.float32)
        hi_msk = np.zeros((C, P), bool)
        hi_t = np.zeros((C, P), np.float32)
        lo_pos = np.zeros((C, P, 3), np.float32)
        lo_msk = np.zeros((C, P), bool)
        lo_t = np.zeros((C, P), np.float32)
        for ci, pcs in enumerate(clouds):
            j = int(np.searchsorted(cp_times, pcs.time, side="right"))
            j = min(max(j, 1), k - 1)
            prev_idx[ci] = j - 1
            next_idx[ci] = j
            dt = cp_times[j] - cp_times[j - 1]
            factor[ci] = (pcs.time - cp_times[j - 1]) / max(dt, 1e-9)
            cloud_mask[ci] = True
            cloud_time[ci] = pcs.time - t_ref
            hi_pos[ci] = pcs.high_res.positions
            hi_msk[ci] = pcs.high_res.mask
            hi_t[ci] = pcs.high_res.times
            lo_pos[ci] = pcs.low_res.positions
            lo_msk[ci] = pcs.low_res.mask
            lo_t[ci] = pcs.low_res.times

        # IMU + odometry per consecutive CP pair.
        pair_mask = np.zeros(K - 1, bool)
        pair_dt = np.zeros(K - 1, np.float32)
        imu_dq = np.tile(np.array([1, 0, 0, 0], np.float32), (K - 1, 1))
        imu_dv = np.zeros((K - 1, 3), np.float32)
        imu_dp = np.zeros((K - 1, 3), np.float32)
        odom_mask = np.zeros(K - 1, bool)
        odom_dt_arr = np.zeros((K - 1, 3), np.float32)
        odom_dq = np.tile(np.array([1, 0, 0, 0], np.float32), (K - 1, 1))
        odom_wt = np.zeros(K - 1, np.float32)
        odom_wr = np.zeros(K - 1, np.float32)

        imu_t = np.asarray(self._imu_times)
        imu_g = np.asarray(self._imu_gyro)
        imu_a = np.asarray(self._imu_acc)
        obuf = self._odometry_buffer()

        for i in range(1, k):
            t0, t1 = cp_times[i - 1], cp_times[i]
            pair_mask[i - 1] = True
            pair_dt[i - 1] = t1 - t0
            dq, dv, dp = imu_integration.integrate_imu(
                imu_t, imu_a, imu_g, t0, t1, self._acc_calibration, self._gyro_calibration
            )
            if self._opt.imu_integrator == "RK4":
                # (ref: imu_integrator = "RK4" default; rotation from RK4,
                # translation terms from the ZOH pass above)
                dq = imu_integration.integrate_gyro_rk4(imu_t, imu_g, t0, t1, self._gyro_calibration)
            imu_dq[i - 1] = dq
            imu_dv[i - 1] = dv
            imu_dp[i - 1] = dp
            if obuf.has(t0) and obuf.has(t1):
                rel = obuf.lookup(t0).inverse().compose(obuf.lookup(t1))
                odom_mask[i - 1] = True
                odom_dt_arr[i - 1] = rel.t
                odom_dq[i - 1] = rel.q
                wt = self._opt.odometry_translation_weight
                wr = self._opt.odometry_rotation_weight
                if self._opt.use_adaptive_odometry_weights:
                    dtrans = float(np.linalg.norm(rel.t))
                    drot = float(nq.quat_angle(rel.q))
                    dt_s = t1 - t0
                    wt = wt / np.sqrt(dtrans + self._opt.odometry_translation_normalization * dt_s)
                    wr = wr / np.sqrt(drot + self._opt.odometry_rotation_normalization * dt_s)
                odom_wt[i - 1] = wt
                odom_wr[i - 1] = wr

        # DIRECT IMU cost term: the raw calibrated samples of each pair
        # (ref: optimizing_local_trajectory_builder.cc:942-968 proto::DIRECT).
        direct_arrays = {}
        if self._opt.imu_cost_term == "DIRECT" and len(self._imu_times):
            M = 16
            d_dt = np.zeros((K - 1, M), np.float32)
            d_gy = np.zeros((K - 1, M, 3), np.float32)
            d_ac = np.zeros((K - 1, M, 3), np.float32)
            for i in range(1, k):
                d_dt[i - 1], d_gy[i - 1], d_ac[i - 1] = imu_integration.direct_imu_samples(
                    imu_t, imu_a, imu_g, cp_times[i - 1], cp_times[i], M,
                    self._acc_calibration, self._gyro_calibration,
                )
            direct_arrays = dict(direct_dt=d_dt, direct_gyro=d_gy, direct_accel=d_ac,
                                 direct_gravity=np.float32(self._gravity_constant))

        cp_times_arr = np.zeros(K, np.float32)
        cp_times_arr[:k] = cp_times - t_ref
        o = self._opt
        dev = _to_device(self._device, dict(
            cp_mask=cp_mask, cp_times=cp_times_arr, cloud_mask=cloud_mask, cloud_prev=prev_idx,
            cloud_next=next_idx, cloud_factor=factor, cloud_time=cloud_time,
            hi_points=hi_pos, hi_mask=hi_msk, hi_times=hi_t, lo_points=lo_pos, lo_mask=lo_msk, lo_times=lo_t,
            pair_mask=pair_mask, pair_dt=pair_dt, imu_delta_rotation=imu_dq, imu_delta_velocity=imu_dv,
            imu_delta_translation=imu_dp, odom_mask=odom_mask, odom_delta_translation=odom_dt_arr,
            odom_delta_rotation=odom_dq, odom_translation_weight=odom_wt, odom_rotation_weight=odom_wr,
            translation=trans, rotation=rot, velocity=vel,
            weights=np.array([o.high_resolution_grid_weight, o.low_resolution_grid_weight,
                              o.translation_weight, o.velocity_weight, o.rotation_weight], np.float32),
            **direct_arrays,
        ))
        state0 = CtState(dev.pop("translation"), dev.pop("rotation"), dev.pop("velocity"))
        weights = CtWeights(*dev.pop("weights").unbind())
        direct = None
        if direct_arrays:
            direct = DirectImuData(dev.pop("direct_dt"), dev.pop("direct_gyro"), dev.pop("direct_accel"),
                                   dev.pop("direct_gravity"))
        submap = self._active_submaps.matching_submap
        high_grid, low_grid = submap.prepared_grids()
        return PendingWindowSolve(
            high_grid=high_grid,
            low_grid=low_grid,
            is_tsdf=self._active_submaps.is_tsdf,
            problem=CtProblem(**dev),
            state0=state0,
            weights=weights,
            num_iterations=int(self._opt.max_num_iterations),
            per_point=bool(self._opt.use_per_point_unwarping),
            direct=direct,
            cps=cps,
            k=k,
        )

    def _solve_window_direct(self, pending: PendingWindowSolve) -> CtState:
        solved, _, _ = solve_ct_window(
            pending.high_grid,
            pending.low_grid,
            pending.problem,
            pending.state0,
            pending.weights,
            is_tsdf=pending.is_tsdf,
            num_iterations=pending.num_iterations,
            per_point=pending.per_point,
            direct=pending.direct,
        )
        return solved

    def _apply_window_solution(self, pending: PendingWindowSolve, solved: CtState) -> None:
        self.num_optimizations += 1
        # One device-to-host copy for the solved state.
        packed = torch.cat([solved.translation, solved.rotation, solved.velocity], dim=1).cpu().numpy()
        for i, cp in enumerate(pending.cps[: pending.k]):
            cp.state = CpState(
                packed[i, :3].astype(np.float64), packed[i, 3:7].astype(np.float64), packed[i, 7:10].astype(np.float64)
            )

    # ------------------------------------------------------------------
    # marginalization (ref: MaybeOptimize :1298-1413)
    # ------------------------------------------------------------------

    def _interp_cp_pose(self, t: float) -> NpRigid3:
        cps = self._control_points
        times = [cp.time for cp in cps]
        j = int(np.searchsorted(times, t, side="right"))
        j = min(max(j, 1), len(cps) - 1)
        a, b = cps[j - 1], cps[j]
        f = (t - a.time) / max(b.time - a.time, 1e-9)
        f = min(max(f, 0.0), 1.0)
        ta = a.state.translation
        tb = b.state.translation
        return NpRigid3(ta + f * (tb - ta), nq.quat_slerp(a.state.rotation, b.state.rotation, f))

    def _unwarp_points_per_point(self, pcs: PointCloudSet, inv: NpRigid3) -> np.ndarray:
        """Per-point unwarping of a marginalized cloud: each point by its own
        pose at its own time, into the frame of `inv`'s inverse (ref:
        MaybeOptimize per-point branch :1331-1378; JAX builder.py
        :715-743). The rotation is a sign-aligned lerp, then normalized
        (nlerp), as the JAX builder interpolates here; the window solve
        slerps."""
        cps = list(self._control_points)
        cp_t = np.array([cp.time for cp in cps])
        cp_trans = np.stack([cp.state.translation for cp in cps])
        cp_rot = np.stack([cp.state.rotation for cp in cps])
        abs_t = pcs.time + pcs.times
        nxt = np.clip(np.searchsorted(cp_t, abs_t, side="right"), 1, len(cps) - 1)
        prv = nxt - 1
        f = np.clip((abs_t - cp_t[prv]) / np.maximum(cp_t[nxt] - cp_t[prv], 1e-9), 0.0, 1.0)[:, None]
        trans = cp_trans[prv] + f * (cp_trans[nxt] - cp_trans[prv])
        q0 = cp_rot[prv]
        q1 = cp_rot[nxt]
        dot = np.sum(q0 * q1, axis=-1, keepdims=True)
        q1 = np.where(dot < 0, -q1, q1)
        q = q0 + f * (q1 - q0)
        q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
        u, w = q[:, 1:], q[:, :1]
        v = pcs.points
        uv = np.cross(u, v)
        world = v + 2.0 * (w * uv + np.cross(u, uv)) + trans
        return nq.quat_rotate(inv.q, world) + inv.t

    def _marginalize(self, optimized_pose: NpRigid3):
        """Pop the clouds leaving the window; unwarp them into the frame of
        optimized_pose."""
        accumulated: List[np.ndarray] = []
        acc_origin = None
        inv = optimized_pose.inverse()

        if not self._active_submaps.submaps:
            # Map init: accumulate every cloud before the last control point
            # at its (identity-ish) interpolated state, WITHOUT popping, as
            # the reference does (:1297-1329); the clouds are re-inserted
            # with their optimized poses when they leave the horizon.
            for pcs in self._clouds:
                if pcs.time < self._control_points[-1].time:
                    tf = inv.compose(self._interp_cp_pose(pcs.time))
                    accumulated.append(nq.quat_rotate(tf.q, pcs.points) + tf.t)
                    acc_origin = tf.apply(pcs.origin)
            if not accumulated:
                return None, None
            return np.concatenate(accumulated, axis=0), acc_origin

        horizon = self._opt.ct_window_horizon - self._opt.ct_window_rate
        while (
            self._clouds
            and len(self._control_points) >= 2
            and horizon < self._control_points[-1].time - self._clouds[0].time
        ):
            while len(self._control_points) > 2 and self._control_points[1].time < self._clouds[0].time:
                self._control_points.popleft()
            pcs = self._clouds.popleft()
            tf = inv.compose(self._interp_cp_pose(pcs.time))
            if self._opt.use_per_point_unwarping:
                accumulated.append(self._unwarp_points_per_point(pcs, inv))
            else:
                accumulated.append(nq.quat_rotate(tf.q, pcs.points) + tf.t)
            acc_origin = tf.apply(pcs.origin)
        if not accumulated:
            return None, None
        return np.concatenate(accumulated, axis=0), acc_origin

    def _remove_obsolete_sensor_data(self) -> None:
        """(ref: RemoveObsoleteSensorData :1076-1097)"""
        if not self._control_points:
            return
        while (
            len(self._control_points) > 1
            and self._opt.ct_window_horizon < self._control_points[-1].time - self._control_points[0].time
            and (not self._clouds or self._control_points[1].time < self._clouds[0].start_time)
        ):
            self._control_points.popleft()
        front_time = self._control_points[0].time
        while len(self._imu_times) > 1 and self._imu_times[1] <= front_time:
            self._imu_times.pop(0)
            self._imu_acc.pop(0)
            self._imu_gyro.pop(0)
        while len(self._odom) > 1 and self._odom[1][0] <= front_time:
            self._odom.popleft()

    # ------------------------------------------------------------------
    # insertion (ref: AddAccumulatedRangeData + InsertIntoSubmap :1417-1518)
    # ------------------------------------------------------------------

    def _add_accumulated_range_data(
        self, time: float, optimized_pose: NpRigid3, accumulated: np.ndarray, acc_origin
    ) -> MatchingResult:
        cap = max(self._P * 8, 4096)
        device = self._device
        local_pts = nq.quat_rotate(optimized_pose.q, accumulated) + optimized_pose.t
        origin_local = optimized_pose.apply(acc_origin) if acc_origin is not None else optimized_pose.t
        gravity_alignment = optimized_pose.q
        aligned = nq.quat_rotate(gravity_alignment, accumulated)
        up = _to_device(device, {
            "tracking": _pad_points(accumulated, cap),
            "local": _pad_points(local_pts, cap),
            "aligned": _pad_points(aligned, cap),
            "mask": np.arange(cap) < min(len(accumulated), cap),
            "origin": np.asarray(origin_local, np.float32),
        })
        mask = up["mask"]
        cloud_tracking = voxel_filter(PointCloud(up["tracking"], mask), self._options.voxel_filter_size)
        range_data_in_local = RangeData(
            origin=up["origin"],
            returns=PointCloud(up["local"], mask),
            misses=PointCloud(torch.zeros((8, 3), device=device), torch.zeros(8, dtype=torch.bool, device=device)),
        )
        hi = compact_cloud(
            adaptive_voxel_filter(cloud_tracking, self._options.high_resolution_adaptive_voxel_filter), self._P
        )
        lo = compact_cloud(
            adaptive_voxel_filter(cloud_tracking, self._options.low_resolution_adaptive_voxel_filter), self._P
        )

        insertion_result = None
        if not self._motion_filter.is_similar(time, optimized_pose):
            # Histogram over the gravity-aligned tracking cloud (:1483-1488).
            hist = compute_histogram(up["aligned"], mask, self._options.rotational_histogram_size).cpu().numpy()
            submaps = self._active_submaps.insert_data(range_data_in_local, hist, np.asarray(origin_local))
            insertion_result = InsertionResult(
                time=time,
                local_pose=optimized_pose,
                high_resolution_cloud=hi,
                low_resolution_cloud=lo,
                rotational_histogram=hist,
                gravity_alignment=gravity_alignment,
                insertion_submaps=submaps,
            )
        return MatchingResult(
            time=time,
            local_pose=optimized_pose,
            range_data_in_local=range_data_in_local,
            insertion_result=insertion_result,
        )

    @property
    def active_submaps(self) -> ActiveSubmaps3D:
        return self._active_submaps
