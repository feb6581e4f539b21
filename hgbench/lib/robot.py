"""One robot fed in process: its stream handed to a trajectory builder in
time order, as a recorded sequence is replayed (IMU and odometry up to a
scan's stamp, then the scan)."""

from __future__ import annotations

import numpy as np


class Robot:
    def __init__(self, trajectory_builder, stream, use_3d: bool):
        from hectorgrapher_tpu_torch.sensor.types import TimedPointCloud, TimedPointCloudData
        from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3

        self._cloud, self._data, self._pose = TimedPointCloud, TimedPointCloudData, NpRigid3
        self.tb = trajectory_builder
        self.local = trajectory_builder._local  # the local SLAM builder the checks watch
        self.stream = stream
        self.use_3d = use_3d
        self.imu_fed = 0
        self.odom_fed = 0
        self.next_scan = 0

    def raw_stream(self):
        """The stream the robot was fed, for the reference."""
        return self.stream

    def scans_left(self) -> int:
        return len(self.stream.scan_t) - self.next_scan

    def feed_until(self, t: float) -> None:
        """Hand every IMU and odometry sample stamped at or before t."""
        s = self.stream
        for kind, i in s.samples_until(t, self.imu_fed, self.odom_fed):
            if kind == "imu":
                self.tb.add_imu_data(float(s.imu_t[i]), s.imu_acc[i], s.imu_gyro[i])
                self.imu_fed = i + 1
            else:
                self.tb.add_odometry_data(float(s.odom_t[i]), self._pose(s.odom_xyz[i], s.odom_q[i]))
                self.odom_fed = i + 1

    def next_scan_data(self):
        """(time, TimedPointCloudData) of the next scan, copied to the host."""
        t, pts, times, mask = self.stream.scan(self.next_scan)
        return t, self._data(t, np.zeros(3, np.float32), self._cloud(pts, times, mask), self.stream.width)

    def hand(self, t: float, data):
        """Hand the samples up to t, then the scan: its local SLAM result
        (None where the builder returned none)."""
        self.feed_until(t)
        self.next_scan += 1
        return self.tb.add_range_data(data)


def finite_pose(result) -> bool:
    return result is not None and bool(np.all(np.isfinite(result.local_pose.t))
                                       and np.all(np.isfinite(result.local_pose.q)))
