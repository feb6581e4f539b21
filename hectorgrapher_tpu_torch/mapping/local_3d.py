"""Classic discrete-time 3D local SLAM front end (counterpart of
hectorgrapher_tpu/mapping/local_3d.py; ref:
cartographer/mapping/internal/3d/local_trajectory_builder_3d.{h,cc}).

Per scan: predict with the extrapolator, crop by range (a mask: the
organized rows survive for the structured-cloud inserters), voxel filter,
the high- and low-resolution adaptive voxel filters, the optional dense
correlative search (scan_matching/correlative_3d.py), the GN3D refinement
against the matching submap's grid pair (scan_matching/gn_3d.py
match_gn_3d, on kernel K3), extrapolator feedback, and a motion-filtered
insertion with the rotational histogram of the gravity-aligned kept
points. The reference's MapBuilder does not use this builder for 3D (it
always builds the optimizing one, map_builder.cc:126-140); it serves
trajectory-builder evaluation.

Host code orchestrates; filtering, matching and insertion run on `device`,
the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from hectorgrapher_tpu_torch.mapping.frontend_metrics import FrontEndMetrics
from hectorgrapher_tpu_torch.mapping.motion_filter import MotionFilter
from hectorgrapher_tpu_torch.mapping.pose_extrapolator import PoseExtrapolator
from hectorgrapher_tpu_torch.mapping.scan_matching.correlative_3d import (
    make_search_window_3d,
    match_correlative_3d,
)
from hectorgrapher_tpu_torch.mapping.scan_matching.gn_3d import match_gn_3d
from hectorgrapher_tpu_torch.mapping.scan_matching.rotational_histogram import compute_histogram
from hectorgrapher_tpu_torch.mapping.submap_3d import ActiveSubmaps3D, Submap3D
from hectorgrapher_tpu_torch.ops import _build
from hectorgrapher_tpu_torch.sensor.types import PointCloud, RangeData, TimedPointCloudData, pad_cloud
from hectorgrapher_tpu_torch.sensor.voxel_filter import adaptive_voxel_filter, compact_cloud, voxel_filter
from hectorgrapher_tpu_torch.transform import np_quat as nq
from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3
from hectorgrapher_tpu_torch.transform.rigid import Rigid3


@dataclass
class InsertionResult3D:
    time: float
    local_pose: NpRigid3
    high_resolution_cloud: PointCloud
    low_resolution_cloud: PointCloud
    rotational_histogram: np.ndarray
    gravity_alignment: np.ndarray
    insertion_submaps: List[Submap3D]


@dataclass
class MatchingResult3D:
    time: float
    local_pose: NpRigid3
    range_data_in_local: RangeData
    insertion_result: Optional[InsertionResult3D]


class LocalTrajectoryBuilder3D:
    CLOUD_CAP = 4096  # the gravity-aligned cloud of the rotational histogram
    POINTS = 1024  # each adaptive-filtered cloud, compacted

    def __init__(self, options, device="cuda"):
        """options: TrajectoryBuilder3DOptions. Runs on `device`, the card
        unless the caller asks for the CPU; without a card it raises."""
        self._options = options
        self._device = torch.device(device)
        if self._device.type == "cuda":
            _build.load_library()
        self._active_submaps = ActiveSubmaps3D(options.submaps, self._device, options.rotational_histogram_size)
        self._motion_filter = MotionFilter(options.motion_filter)
        self._extrapolator: Optional[PoseExtrapolator] = None
        self._frontend_metrics = FrontEndMetrics("classic_3d")
        rt = options.real_time_correlative_scan_matcher
        self._window = make_search_window_3d(rt.linear_search_window, rt.angular_search_window,
                                             options.submaps.high_resolution, options.max_range)

    def add_imu_data(self, time: float, linear_acceleration, angular_velocity) -> None:
        if self._extrapolator is None:
            self._extrapolator = PoseExtrapolator.initialize_with_imu(
                pose_queue_duration=0.001,
                imu_gravity_time_constant=self._options.imu_gravity_time_constant,
                imu_time=time,
                linear_acceleration=np.asarray(linear_acceleration, float),
                angular_velocity=np.asarray(angular_velocity, float),
            )
        else:
            self._extrapolator.add_imu_data(time, linear_acceleration, angular_velocity)

    def add_odometry_data(self, time: float, pose: NpRigid3) -> None:
        if self._extrapolator is None:
            return
        self._extrapolator.add_odometry_data(time, pose)

    def add_range_data(self, data: TimedPointCloudData) -> Optional[MatchingResult3D]:
        """One scan; publishes the per-scan latency and real-time ratios
        (ref: local_trajectory_builder_2d.cc:29-36). The pose comes back to
        the host, so the wall time holds the scan's matching."""
        t0w, t0c = _time.perf_counter(), _time.thread_time()
        result = self._add_range_data_impl(data)
        self._frontend_metrics.observe_step(float(data.time), _time.perf_counter() - t0w,
                                            _time.thread_time() - t0c)
        return result

    def _add_range_data_impl(self, data: TimedPointCloudData) -> Optional[MatchingResult3D]:
        """(ref: local_trajectory_builder_3d.cc AddRangeData: whole-scan
        unwarping by the extrapolated pose; num_accumulated_range_data 1)."""
        if self._extrapolator is None:
            return None  # IMU not initialized
        time = float(data.time)
        if self._extrapolator.last_pose_time() is None or time < self._extrapolator.last_pose_time():
            return None

        pts = np.asarray(data.ranges.positions)
        origin = np.asarray(data.origin)
        r = np.linalg.norm(pts - origin[None, :], axis=-1)
        # Out-of-range points are masked, never compacted: the organized
        # rows (data.width) must survive for the structured-cloud normal /
        # triangle inserters, which pair the i +- width neighbours.
        keep = np.asarray(data.ranges.mask) & (r >= self._options.min_range) & (r <= self._options.max_range)
        if not keep.any():
            return None

        pose_prediction = self._extrapolator.extrapolate_pose(time)
        gravity_alignment = self._extrapolator.estimate_gravity_orientation(time)

        device = self._device
        keep_dev = torch.from_numpy(keep).to(device)
        cloud = voxel_filter(PointCloud(torch.from_numpy(pts.astype(np.float32)).to(device), keep_dev),
                             self._options.voxel_filter_size)
        high = compact_cloud(adaptive_voxel_filter(cloud, self._options.high_resolution_adaptive_voxel_filter),
                             self.POINTS)
        low = compact_cloud(adaptive_voxel_filter(cloud, self._options.low_resolution_adaptive_voxel_filter),
                            self.POINTS)

        pose_estimate = self._scan_match(pose_prediction, high, low)
        self._extrapolator.add_pose(time, pose_estimate)

        local_pts = nq.quat_rotate(pose_estimate.q, pts) + pose_estimate.t
        range_data_in_local = RangeData(
            origin=torch.tensor(pose_estimate.apply(origin), dtype=torch.float32, device=device),
            returns=PointCloud(torch.from_numpy(local_pts.astype(np.float32)).to(device), keep_dev),
            misses=pad_cloud(np.zeros((0, 3), np.float32), 8, device),
            width=int(data.width),
        )

        insertion_result = None
        if not self._motion_filter.is_similar(time, pose_estimate):
            aligned = nq.quat_rotate(gravity_alignment, pts[keep])
            hist_cloud = pad_cloud(aligned.astype(np.float32), self.CLOUD_CAP, device)
            hist = compute_histogram(hist_cloud.positions, hist_cloud.mask,
                                     self._options.rotational_histogram_size).cpu().numpy()
            submaps = self._active_submaps.insert_data(range_data_in_local, hist, np.asarray(pose_estimate.t))
            insertion_result = InsertionResult3D(
                time=time,
                local_pose=pose_estimate,
                high_resolution_cloud=high,
                low_resolution_cloud=low,
                rotational_histogram=hist,
                gravity_alignment=gravity_alignment,
                insertion_submaps=submaps,
            )
        return MatchingResult3D(time=time, local_pose=pose_estimate, range_data_in_local=range_data_in_local,
                                insertion_result=insertion_result)

    def _scan_match(self, pose_prediction: NpRigid3, high: PointCloud, low: PointCloud) -> NpRigid3:
        """(ref: local_trajectory_builder_3d.cc ScanMatch: the optional
        real-time correlative search, then CeresScanMatcher3D over the grid
        pair.)"""
        submap = self._active_submaps.matching_submap
        if submap is None:
            return pose_prediction
        f32 = dict(dtype=torch.float32, device=self._device)
        target = torch.tensor(pose_prediction.t, **f32)
        initial = Rigid3(translation=target, rotation=torch.tensor(pose_prediction.q, **f32))
        if self._options.use_online_correlative_scan_matching:
            rt = self._options.real_time_correlative_scan_matcher
            _, initial = match_correlative_3d(submap.high_resolution_grid, high, initial, self._window,
                                              rt.translation_delta_cost_weight, rt.rotation_delta_cost_weight)
        cm = self._options.ceres_scan_matcher
        hi, lo = submap.prepared_grids()
        refined, _ = match_gn_3d(hi, lo, high, low, initial, target, cm.occupied_space_weight_0,
                                 cm.occupied_space_weight_1, cm.translation_weight, cm.rotation_weight,
                                 num_iterations=cm.ceres_solver_options.max_num_iterations,
                                 only_optimize_yaw=bool(cm.only_optimize_yaw))
        pose = torch.cat([refined.translation, refined.rotation]).cpu().numpy().astype(np.float64)
        return NpRigid3(pose[:3], pose[3:])

    @property
    def active_submaps(self) -> ActiveSubmaps3D:
        return self._active_submaps
