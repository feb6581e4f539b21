"""Motion filter: drop poses similar in time/distance/angle.

(ref: cartographer/mapping/internal/motion_filter.{h,cc} IsSimilar)
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from hectorgrapher_tpu_torch.transform import np_quat as nq
from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3


class MotionFilter:
    def __init__(self, options):
        self._max_time_seconds = options.max_time_seconds
        self._max_distance_meters = options.max_distance_meters
        self._max_angle_radians = options.max_angle_radians
        self._last: Optional[Tuple[float, NpRigid3]] = None
        self.num_total = 0
        self.num_different = 0

    def is_similar(self, time: float, pose: NpRigid3) -> bool:
        """True if pose is close enough to the last accepted one to skip."""
        self.num_total += 1
        if self._last is not None:
            last_time, last_pose = self._last
            if (
                time - last_time <= self._max_time_seconds
                and np.linalg.norm(pose.t - last_pose.t) <= self._max_distance_meters
                and nq.quat_angle(nq.quat_multiply(nq.quat_conjugate(last_pose.q), pose.q))
                <= self._max_angle_radians
            ):
                return True
        self._last = (time, pose)
        self.num_different += 1
        return False
