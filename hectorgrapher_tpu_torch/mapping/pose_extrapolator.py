"""Pose prediction from recent poses + IMU + odometry.

(ref: cartographer/mapping/pose_extrapolator.{h,cc} — velocity estimates
from the timed pose queue and odometry; orientation extrapolated by an
ImuTracker; gravity orientation estimate for scan alignment.)
Host-side streaming component.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Optional, Tuple

import numpy as np

from hectorgrapher_tpu_torch.mapping.imu_tracker import ImuTracker
from hectorgrapher_tpu_torch.transform import np_quat as nq
from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3


class PoseExtrapolator:
    def __init__(self, pose_queue_duration: float, imu_gravity_time_constant: float):
        self._pose_queue_duration = pose_queue_duration
        self._gravity_time_constant = imu_gravity_time_constant
        self._timed_pose_queue: Deque[Tuple[float, NpRigid3]] = deque()
        self._imu_data: Deque[Tuple[float, np.ndarray, np.ndarray]] = deque()
        self._odometry_data: Deque[Tuple[float, NpRigid3]] = deque()
        self._imu_tracker: Optional[ImuTracker] = None
        self._odometry_imu_tracker: Optional[ImuTracker] = None
        self._extrapolation_imu_tracker: Optional[ImuTracker] = None
        self._cached_extrapolated_pose: Optional[Tuple[float, NpRigid3]] = None
        self._linear_velocity_from_poses = np.zeros(3)
        self._angular_velocity_from_poses = np.zeros(3)
        self._linear_velocity_from_odometry = np.zeros(3)
        self._angular_velocity_from_odometry = np.zeros(3)

    # -- construction ------------------------------------------------------

    @staticmethod
    def initialize_with_imu(
        pose_queue_duration: float,
        imu_gravity_time_constant: float,
        imu_time: float,
        linear_acceleration,
        angular_velocity,
    ) -> "PoseExtrapolator":
        """(ref: pose_extrapolator.cc InitializeWithImu)"""
        e = PoseExtrapolator(pose_queue_duration, imu_gravity_time_constant)
        e.add_imu_data(imu_time, linear_acceleration, angular_velocity)
        e._imu_tracker = ImuTracker(imu_gravity_time_constant, imu_time)
        e._imu_tracker.add_imu_linear_acceleration_observation(linear_acceleration)
        e._imu_tracker.add_imu_angular_velocity_observation(angular_velocity)
        e._imu_tracker.advance(imu_time)
        e.add_pose(imu_time, NpRigid3(np.zeros(3), e._imu_tracker.orientation))
        return e

    # -- queries -----------------------------------------------------------

    def last_pose_time(self) -> Optional[float]:
        if not self._timed_pose_queue:
            return None
        return self._timed_pose_queue[-1][0]

    def last_extrapolated_time(self) -> Optional[float]:
        if self._extrapolation_imu_tracker is None:
            return self.last_pose_time()
        return self._extrapolation_imu_tracker.time

    # -- data ingestion ----------------------------------------------------

    def add_pose(self, time: float, pose: NpRigid3) -> None:
        if self._imu_tracker is None:
            tracker_start = time
            if self._imu_data:
                tracker_start = min(tracker_start, self._imu_data[0][0])
            self._imu_tracker = ImuTracker(self._gravity_time_constant, tracker_start)
        self._timed_pose_queue.append((time, pose))
        while len(self._timed_pose_queue) > 2 and self._timed_pose_queue[1][0] <= time - self._pose_queue_duration:
            self._timed_pose_queue.popleft()
        self._update_velocities_from_poses()
        self._advance_imu_tracker(self._imu_tracker, time)
        self._trim_imu_data()
        self._trim_odometry_data()
        self._odometry_imu_tracker = self._imu_tracker.clone()
        self._extrapolation_imu_tracker = self._imu_tracker.clone()

    def add_imu_data(self, time: float, linear_acceleration, angular_velocity) -> None:
        self._imu_data.append((time, np.asarray(linear_acceleration, float), np.asarray(angular_velocity, float)))
        self._trim_imu_data()

    def add_odometry_data(self, time: float, pose: NpRigid3) -> None:
        """(ref: pose_extrapolator.cc AddOdometryData — velocities from the
        oldest/newest odometry pair.)"""
        self._odometry_data.append((time, pose))
        self._trim_odometry_data()
        if len(self._odometry_data) < 2:
            return
        t_old, p_old = self._odometry_data[0]
        t_new, p_new = self._odometry_data[-1]
        dt = t_new - t_old
        if dt <= 0:
            return
        # Forward delta old -> new in the old body frame.
        delta = p_old.inverse().compose(p_new)
        self._angular_velocity_from_odometry = nq.quat_to_axis_angle(delta.q) / dt
        if not self._timed_pose_queue:
            return
        orientation_newest = self._extrapolate_rotation(t_new, self._odometry_imu_tracker) if self._odometry_imu_tracker else nq.quat_identity()
        newest_pose_q = nq.quat_multiply(self._timed_pose_queue[-1][1].q, orientation_newest)
        # odometry-frame velocity -> world frame using current orientation
        odom_vel_tracking = nq.quat_rotate(nq.quat_conjugate(p_new.q), (p_new.t - p_old.t) / dt)
        self._linear_velocity_from_odometry = nq.quat_rotate(newest_pose_q, odom_vel_tracking)

    # -- extrapolation -----------------------------------------------------

    def extrapolate_pose(self, time: float) -> NpRigid3:
        assert self._timed_pose_queue, "no poses added yet"
        newest_time, newest_pose = self._timed_pose_queue[-1]
        assert time >= newest_time - 1e-9, f"extrapolation into the past: {time} < {newest_time}"
        if self._cached_extrapolated_pose is None or self._cached_extrapolated_pose[0] != time:
            translation = self._extrapolate_translation(time) + newest_pose.t
            rotation = nq.quat_multiply(
                newest_pose.q, self._extrapolate_rotation(time, self._extrapolation_imu_tracker)
            )
            self._cached_extrapolated_pose = (time, NpRigid3(translation, nq.quat_normalize(rotation)))
        return self._cached_extrapolated_pose[1]

    def estimate_gravity_orientation(self, time: float):
        """(ref: pose_extrapolator.cc EstimateGravityOrientation)"""
        tracker = self._imu_tracker.clone()
        self._advance_imu_tracker(tracker, time)
        return tracker.orientation

    # -- internals ---------------------------------------------------------

    def _update_velocities_from_poses(self):
        if len(self._timed_pose_queue) < 2:
            return
        t_new, p_new = self._timed_pose_queue[-1]
        t_old, p_old = self._timed_pose_queue[0]
        dt = t_new - t_old
        # (ref: pose_extrapolator.cc UpdateVelocitiesFromPoses — a queue
        # shorter than pose_queue_duration gives noise-dominated velocity
        # estimates; keep the previous ones.)
        if dt < self._pose_queue_duration or dt <= 1e-9:
            return
        self._linear_velocity_from_poses = (p_new.t - p_old.t) / dt
        delta = p_old.inverse().compose(p_new)
        self._angular_velocity_from_poses = nq.quat_to_axis_angle(delta.q) / dt

    def _trim_imu_data(self):
        while (
            len(self._imu_data) > 1
            and self._timed_pose_queue
            and self._imu_data[1][0] <= self._timed_pose_queue[-1][0]
        ):
            self._imu_data.popleft()

    def _trim_odometry_data(self):
        while (
            len(self._odometry_data) > 2
            and self._timed_pose_queue
            and self._odometry_data[1][0] <= self._timed_pose_queue[-1][0]
        ):
            self._odometry_data.popleft()

    def _advance_imu_tracker(self, tracker: ImuTracker, time: float):
        """(ref: pose_extrapolator.cc AdvanceImuTracker)"""
        if time < tracker.time:
            return
        if not self._imu_data or time < self._imu_data[0][0]:
            # Fall back to pose/odometry-derived angular velocity.
            tracker.advance(time)
            tracker.add_imu_linear_acceleration_observation(np.array([0.0, 0.0, 1.0]))
            av = (
                self._angular_velocity_from_odometry
                if len(self._odometry_data) >= 2
                else self._angular_velocity_from_poses
            )
            tracker.add_imu_angular_velocity_observation(av)
            return
        if tracker.time < self._imu_data[0][0]:
            tracker.advance(self._imu_data[0][0])
        for t, acc, gyro in self._imu_data:
            if t < tracker.time:
                continue
            if t > time:
                break
            tracker.advance(t)
            tracker.add_imu_linear_acceleration_observation(acc)
            tracker.add_imu_angular_velocity_observation(gyro)
        tracker.advance(time)

    def _extrapolate_rotation(self, time: float, tracker: Optional[ImuTracker]):
        if tracker is None:
            return nq.quat_identity()
        self._advance_imu_tracker(tracker, time)
        last_orientation = self._imu_tracker.orientation
        return nq.quat_multiply(nq.quat_conjugate(last_orientation), tracker.orientation)

    def _extrapolate_translation(self, time: float):
        newest_time = self._timed_pose_queue[-1][0]
        dt = time - newest_time
        if len(self._odometry_data) < 2:
            return dt * self._linear_velocity_from_poses
        return dt * self._linear_velocity_from_odometry
