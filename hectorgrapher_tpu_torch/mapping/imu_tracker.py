"""Orientation-only IMU integration with gravity complementary filter.

(ref: cartographer/mapping/imu_tracker.{h,cc} — Advance integrates the
last angular velocity; AddImuLinearAccelerationObservation exponentially
averages the gravity direction and corrects orientation so the tracked
gravity aligns with -z.)
Host-side numpy: runs per IMU sample in the streaming path.
"""

from __future__ import annotations

import numpy as np

from hectorgrapher_tpu_torch.transform import np_quat as nq


class ImuTracker:
    def __init__(self, imu_gravity_time_constant: float, time: float):
        self._gravity_time_constant = imu_gravity_time_constant
        self.time = time
        self._last_linear_acceleration_time = None
        self.orientation = nq.quat_identity()
        self.gravity_vector = np.array([0.0, 0.0, 9.80665])
        self._imu_angular_velocity = np.zeros(3)

    def advance(self, time: float) -> None:
        assert time >= self.time
        dt = time - self.time
        rotation = nq.quat_from_axis_angle(self._imu_angular_velocity * dt)
        self.orientation = nq.quat_normalize(nq.quat_multiply(self.orientation, rotation))
        self.gravity_vector = nq.quat_rotate(nq.quat_conjugate(rotation), self.gravity_vector)
        self.time = time

    def add_imu_linear_acceleration_observation(self, linear_acceleration) -> None:
        # Exponential average with time-constant weighting (imu_tracker.cc:41-56).
        if self._last_linear_acceleration_time is not None:
            dt = self.time - self._last_linear_acceleration_time
        else:
            dt = np.inf
        self._last_linear_acceleration_time = self.time
        alpha = 1.0 - np.exp(-dt / self._gravity_time_constant)
        self.gravity_vector = (1.0 - alpha) * self.gravity_vector + alpha * np.asarray(linear_acceleration)
        # Correct orientation so that gravity maps to the z axis.
        rotation = nq.quat_from_two_vectors(
            self.gravity_vector, nq.quat_rotate(nq.quat_conjugate(self.orientation), np.array([0.0, 0.0, 1.0]))
        )
        self.orientation = nq.quat_normalize(nq.quat_multiply(self.orientation, rotation))

    def add_imu_angular_velocity_observation(self, angular_velocity) -> None:
        self._imu_angular_velocity = np.asarray(angular_velocity)

    def clone(self) -> "ImuTracker":
        c = ImuTracker(self._gravity_time_constant, self.time)
        c._last_linear_acceleration_time = self._last_linear_acceleration_time
        c.orientation = self.orientation.copy()
        c.gravity_vector = self.gravity_vector.copy()
        c._imu_angular_velocity = self._imu_angular_velocity.copy()
        return c
