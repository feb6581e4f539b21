"""Timestamped transform interpolation on the host (counterpart of
hectorgrapher_tpu/transform/interpolation.py; ref:
cartographer/transform/transform_interpolation_buffer.h, including
HectorGrapher's LookupUntilDelta used for adaptive control-point sampling,
transform_interpolation_buffer.h:76).

A sorted (time, pose) buffer of float64 numpy poses. The JAX package's
buffer takes and returns its Rigid3 type holding numpy arrays; this one
takes and returns NpRigid3, with the same arithmetic. Its size limit,
which no caller of the CT builder sets, is not ported.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

import numpy as np

from hectorgrapher_tpu_torch.transform import np_quat as nq
from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3


class TransformInterpolationBuffer:
    """Sorted (time, pose) buffer with Lookup and LookupUntilDelta."""

    def __init__(self):
        self._times: List[float] = []
        self._translations: List[np.ndarray] = []
        self._rotations: List[np.ndarray] = []

    @property
    def earliest_time(self) -> float:
        return self._times[0]

    @property
    def latest_time(self) -> float:
        return self._times[-1]

    def push(self, time: float, pose: NpRigid3) -> None:
        t = np.asarray(pose.t, dtype=np.float64)
        q = np.asarray(pose.q, dtype=np.float64)
        if self._times and time <= self._times[-1]:
            # Replace on an equal stamp, drop an older one.
            if time == self._times[-1]:
                self._translations[-1] = t
                self._rotations[-1] = q
            return
        self._times.append(time)
        self._translations.append(t)
        self._rotations.append(q)

    def has(self, time: float) -> bool:
        return bool(self._times) and self._times[0] <= time <= self._times[-1]

    def _bracket(self, time: float) -> Tuple[int, int]:
        idx = bisect.bisect_left(self._times, time)
        if idx == 0:
            return 0, 0
        if idx >= len(self._times):
            return len(self._times) - 1, len(self._times) - 1
        if self._times[idx] == time:
            return idx, idx
        return idx - 1, idx

    def lookup(self, time: float) -> NpRigid3:
        """(ref: transform_interpolation_buffer.cc Lookup)"""
        assert self.has(time), f"time {time} outside the buffer"
        lo, hi = self._bracket(time)
        if lo == hi:
            return NpRigid3(self._translations[lo], self._rotations[lo])
        t0, t1 = self._times[lo], self._times[hi]
        f = (time - t0) / max(t1 - t0, 1e-12)
        trans = self._translations[lo] + f * (self._translations[hi] - self._translations[lo])
        rot = nq.quat_slerp(self._rotations[lo], self._rotations[hi], f)
        return NpRigid3(trans, rot)

    def lookup_until_delta(
        self,
        start_time: float,
        max_delta_translation: float,
        max_delta_rotation: float,
        min_delta_time: float,
        max_delta_time: float,
    ) -> Optional[float]:
        """The first time after start_time at which the translation, the
        rotation or the time since start_time passes its threshold, or None
        when the buffer ends first (ref: transform_interpolation_buffer.cc
        LookupUntilDelta)."""
        if not self.has(start_time):
            return None
        start_pose = self.lookup(start_time)
        idx = bisect.bisect_right(self._times, start_time)
        for i in range(idx, len(self._times)):
            dt = self._times[i] - start_time
            if dt < min_delta_time:
                continue
            if dt >= max_delta_time:
                return start_time + max_delta_time
            d_trans = float(np.linalg.norm(self._translations[i] - start_pose.t))
            dot = float(np.abs(np.sum(self._rotations[i] * start_pose.q)))
            d_rot = 2.0 * float(np.arccos(min(1.0, dot)))
            if d_trans > max_delta_translation or d_rot > max_delta_rotation:
                return self._times[i]
        return None
