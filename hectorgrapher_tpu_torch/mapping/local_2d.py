"""2D local SLAM front end (counterpart of hectorgrapher_tpu/mapping/local_2d.py;
ref: cartographer/mapping/internal/2d/local_trajectory_builder_2d.{h,cc} —
extrapolator predict -> gravity-align & z-crop -> voxel filter ->
RealTimeCorrelativeScanMatcher -> CeresScanMatcher2D -> extrapolator
feedback -> motion filter -> submap insert).

Host code orchestrates; matching and insertion run on `device`. On
probability-grid submaps with online correlative matching on, every
matched scan goes through the two correlative kernels
(ops/correlative_prep_2d, ops/correlative_scores_2d), a just-finished
uint16 submap decoded first. On TSDF submaps the correlative matcher is
skipped, as in the JAX package (local_2d.py:237), and the GN refinement
takes the TSDF cost.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from hectorgrapher_tpu_torch.common import profiling
from hectorgrapher_tpu_torch.mapping.motion_filter import MotionFilter
from hectorgrapher_tpu_torch.mapping.pose_extrapolator import PoseExtrapolator
from hectorgrapher_tpu_torch.mapping.scan_matching.correlative_2d import (
    make_search_window,
    match_correlative_2d,
)
from hectorgrapher_tpu_torch.mapping.scan_matching.gn_2d import match_gn_2d_probability, match_gn_2d_tsdf
from hectorgrapher_tpu_torch.mapping.submap_2d import ActiveSubmaps2D, Submap2D
from hectorgrapher_tpu_torch.sensor.types import (
    PointCloud,
    RangeData,
    TimedPointCloudData,
    crop_range_data_z,
    pad_cloud,
)
from hectorgrapher_tpu_torch.sensor.voxel_filter import adaptive_voxel_filter, voxel_filter
from hectorgrapher_tpu_torch.transform import np_quat as nq
from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3
from hectorgrapher_tpu_torch.transform.rigid import Rigid2


@dataclass
class InsertionResult:
    """(ref: local_trajectory_builder_2d.h InsertionResult)"""

    time: float
    local_pose: NpRigid3
    filtered_gravity_aligned_point_cloud: PointCloud
    gravity_alignment: np.ndarray  # quaternion wxyz
    insertion_submaps: List[Submap2D]


@dataclass
class MatchingResult:
    time: float
    local_pose: NpRigid3
    range_data_in_local: RangeData
    insertion_result: Optional[InsertionResult]


class LocalTrajectoryBuilder2D:
    def __init__(self, options, device="cuda"):
        """Runs on `device`, the card unless the caller asks for the CPU."""
        self._options = options
        self._device = torch.device(device)
        self._active_submaps = ActiveSubmaps2D(
            options.submaps,
            self._device,
            max_ray_length=max(options.max_range, options.missing_data_ray_length),
        )
        self._motion_filter = MotionFilter(options.motion_filter)
        self._extrapolator: Optional[PoseExtrapolator] = None
        self._search_window = make_search_window(
            options.real_time_correlative_scan_matcher.linear_search_window,
            options.real_time_correlative_scan_matcher.angular_search_window,
            options.submaps.grid_options_2d.resolution,
            options.max_range,
        )
        self._is_tsdf = options.submaps.grid_options_2d.grid_type == "TSDF"

    # -- sensor input ------------------------------------------------------

    def add_imu_data(self, time: float, linear_acceleration, angular_velocity) -> None:
        assert self._options.use_imu_data
        if self._extrapolator is None:
            self._extrapolator = PoseExtrapolator.initialize_with_imu(
                pose_queue_duration=0.001,
                imu_gravity_time_constant=self._options.imu_gravity_time_constant,
                imu_time=time,
                linear_acceleration=linear_acceleration,
                angular_velocity=angular_velocity,
            )
        else:
            self._extrapolator.add_imu_data(time, linear_acceleration, angular_velocity)

    def add_odometry_data(self, time: float, pose: NpRigid3) -> None:
        if self._extrapolator is None:
            if self._options.use_imu_data:
                return  # wait for IMU to initialize (reference behavior)
            # Without IMU, bootstrap from the first odometry sample so the
            # velocity estimate is available from the second scan on.
            self._extrapolator = PoseExtrapolator(0.001, self._options.imu_gravity_time_constant)
            self._extrapolator.add_pose(time, NpRigid3.identity())
        self._extrapolator.add_odometry_data(time, pose)

    def add_range_data(self, data: TimedPointCloudData) -> Optional[MatchingResult]:
        """(ref: local_trajectory_builder_2d.cc AddRangeData:104-210): one
        range sensor, whole-scan unwarping by the extrapolated pose."""
        time = float(data.time)
        if self._extrapolator is None:
            if self._options.use_imu_data:
                return None  # waiting for IMU
            self._extrapolator = PoseExtrapolator(0.001, self._options.imu_gravity_time_constant)
            self._extrapolator.add_pose(time, NpRigid3.identity())

        if self._extrapolator.last_pose_time() is None or time < self._extrapolator.last_pose_time():
            return None

        # Range filtering (min/max range, misses get fixed length), on host.
        pts = np.asarray(data.ranges.positions)
        mask = np.asarray(data.ranges.mask)
        origin = np.asarray(data.origin)
        delta = pts - origin[None, :]
        ranges = np.linalg.norm(delta, axis=-1)
        in_range = (ranges >= self._options.min_range) & (ranges <= self._options.max_range) & mask
        too_far = mask & (ranges > self._options.max_range)
        miss_pts = origin[None, :] + delta / np.maximum(ranges[:, None], 1e-9) * self._options.missing_data_ray_length

        pose_prediction = self._extrapolator.extrapolate_pose(time)
        gravity_alignment = self._extrapolator.estimate_gravity_orientation(time)

        # z-crop in the gravity-aligned frame applies to insertion too, for
        # the shortened miss rays as well (ref: :51-63).
        aligned_pts = nq.quat_rotate(gravity_alignment, pts) if len(pts) else pts
        aligned_z = aligned_pts[..., 2]
        in_range = in_range & (aligned_z >= self._options.min_z) & (aligned_z <= self._options.max_z)
        miss_z = (nq.quat_rotate(gravity_alignment, miss_pts) if len(miss_pts) else miss_pts)[..., 2]
        too_far = too_far & (miss_z >= self._options.min_z) & (miss_z <= self._options.max_z)

        # 2D pose prediction: project the 3D pose through gravity alignment
        # (ref: :159-164 pose_prediction * gravity_alignment.inverse()).
        pose_2d_full = NpRigid3(
            pose_prediction.t, nq.quat_multiply(pose_prediction.q, nq.quat_conjugate(gravity_alignment))
        )
        pose_prediction_2d = Rigid2(
            translation=torch.tensor(pose_2d_full.t[:2], dtype=torch.float32, device=self._device),
            angle=torch.tensor(nq.quat_yaw(pose_2d_full.q), dtype=torch.float32, device=self._device),
        )

        # Gravity-aligned cloud in the tracking frame
        # (ref: TransformToGravityAlignedFrameAndFilter).
        cap = self._options.max_num_points
        n_pad = cap - len(in_range) if cap > len(in_range) else 0
        in_range_cap = torch.from_numpy(np.pad(in_range, (0, n_pad))[:cap]).to(self._device)
        aligned = pad_cloud(aligned_pts.astype(np.float32), cap, self._device)
        aligned = aligned._replace(mask=aligned.mask & in_range_cap)
        aligned_rd = RangeData(
            origin=torch.tensor(nq.quat_rotate(gravity_alignment, origin), dtype=torch.float32, device=self._device),
            returns=aligned,
            misses=pad_cloud(np.zeros((0, 3), np.float32), 8, self._device),
        )
        aligned_rd = crop_range_data_z(aligned_rd, self._options.min_z, self._options.max_z)
        filtered_returns = voxel_filter(aligned_rd.returns, self._options.voxel_filter_size)

        # The match through its pose's readback, so that the section holds
        # its device work.
        with profiling.section("2d.scan_match"):
            matched_2d = self._scan_match(pose_prediction_2d, filtered_returns)
            matched = torch.cat([matched_2d.translation, matched_2d.angle.reshape(1)]).cpu().numpy()

        # Back to 3D local pose (ref: :196 embed(pose_2d) * gravity_alignment).
        pose_estimate = NpRigid3(
            np.array([float(matched[0]), float(matched[1]), pose_2d_full.t[2]]),
            nq.quat_multiply(nq.quat_from_axis_angle(np.array([0.0, 0.0, float(matched[2])])), gravity_alignment),
        )
        self._extrapolator.add_pose(time, pose_estimate)

        # Range data in the local frame for insertion.
        full_pts_local = nq.quat_rotate(pose_estimate.q, pts) + pose_estimate.t if len(pts) else pts
        returns_local = pad_cloud(full_pts_local.astype(np.float32), cap, self._device)
        returns_local = returns_local._replace(mask=returns_local.mask & in_range_cap)
        miss_local_pts = nq.quat_rotate(pose_estimate.q, miss_pts) + pose_estimate.t if len(miss_pts) else miss_pts
        misses_local = pad_cloud(miss_local_pts.astype(np.float32), cap, self._device)
        too_far_cap = torch.from_numpy(np.pad(too_far, (0, n_pad))[:cap]).to(self._device)
        misses_local = misses_local._replace(mask=misses_local.mask & too_far_cap)
        origin_in_local = pose_estimate.apply(origin)
        range_data_in_local = RangeData(
            origin=torch.tensor(origin_in_local, dtype=torch.float32, device=self._device),
            returns=returns_local,
            misses=misses_local,
        )

        insertion_result = self._insert_into_submap(
            time, range_data_in_local, filtered_returns, pose_estimate, gravity_alignment, origin_in_local
        )
        return MatchingResult(
            time=time,
            local_pose=pose_estimate,
            range_data_in_local=range_data_in_local,
            insertion_result=insertion_result,
        )

    # -- internals ---------------------------------------------------------

    def _scan_match(self, pose_prediction_2d: Rigid2, filtered_cloud: PointCloud) -> Rigid2:
        """(ref: local_trajectory_builder_2d.cc ScanMatch:65-102)"""
        matching_submap = self._active_submaps.matching_submap
        if matching_submap is None:
            return pose_prediction_2d

        # Adaptive voxel filter for matching (ref: :75).
        cloud = adaptive_voxel_filter(filtered_cloud, self._options.adaptive_voxel_filter)

        initial = pose_prediction_2d
        if self._options.use_online_correlative_scan_matching and not self._is_tsdf:
            rt = self._options.real_time_correlative_scan_matcher
            _, initial = match_correlative_2d(
                matching_submap.grid,
                cloud,
                pose_prediction_2d,
                self._search_window,
                rt.translation_delta_cost_weight,
                rt.rotation_delta_cost_weight,
            )

        cm = self._options.ceres_scan_matcher
        match = match_gn_2d_tsdf if self._is_tsdf else match_gn_2d_probability
        pose, _ = match(
            matching_submap.grid,
            cloud,
            initial,
            pose_prediction_2d.translation,
            cm.occupied_space_weight,
            cm.translation_weight,
            cm.rotation_weight,
            num_iterations=cm.ceres_solver_options.max_num_iterations,
        )
        return pose

    def _insert_into_submap(
        self,
        time: float,
        range_data_in_local: RangeData,
        filtered_gravity_aligned_cloud: PointCloud,
        pose_estimate: NpRigid3,
        gravity_alignment: np.ndarray,
        origin_in_local: np.ndarray,
    ) -> Optional[InsertionResult]:
        if self._motion_filter.is_similar(time, pose_estimate):
            return None
        submaps = self._active_submaps.insert_range_data(range_data_in_local, origin_in_local)
        return InsertionResult(
            time=time,
            local_pose=pose_estimate,
            filtered_gravity_aligned_point_cloud=filtered_gravity_aligned_cloud,
            gravity_alignment=gravity_alignment,
            insertion_submaps=submaps,
        )

    @property
    def active_submaps(self) -> ActiveSubmaps2D:
        return self._active_submaps
