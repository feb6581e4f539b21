"""Cross-sensor synchronization of overlapping point-cloud chunks
(counterpart of hectorgrapher_tpu/mapping/range_data_collator.py, host
only).

(ref: cartographer/mapping/internal/range_data_collator.{h,cc} — buffers
one pending message per rangefinder, crops all pending clouds to the
common time interval [current_start, current_end], merges them sorted by
absolute point time, and re-references per-point times to the merged
output timestamp.)

numpy host component feeding the local trajectory builders when multiple
rangefinders are configured.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclass
class TimedCloudInput:
    """One rangefinder message: absolute time + per-point relative times."""

    time: float
    origin: np.ndarray  # (3,)
    points: np.ndarray  # (N, 3)
    times: np.ndarray  # (N,) relative seconds <= 0


@dataclass
class MergedRangeData:
    """(ref: sensor/timed_point_cloud_data.h TimedPointCloudOriginData)"""

    time: float
    origins: List[np.ndarray]
    points: np.ndarray  # (N, 3)
    times: np.ndarray  # (N,) relative to `time`, <= 0
    origin_indices: np.ndarray  # (N,) int


class RangeDataCollator:
    def __init__(self, expected_sensor_ids: Sequence[str]):
        self._expected = set(expected_sensor_ids)
        self._pending: Dict[str, TimedCloudInput] = {}
        self._current_start = -np.inf
        self._current_end = -np.inf

    def add_range_data(self, sensor_id: str, data: TimedCloudInput) -> Optional[MergedRangeData]:
        assert sensor_id in self._expected, f"unexpected sensor {sensor_id}"
        if sensor_id in self._pending:
            # Same sensor twice: flush up to the OLDER message's time.
            self._current_start = self._current_end
            self._current_end = self._pending[sensor_id].time
            result = self._crop_and_merge()
            self._pending[sensor_id] = data
            return result
        self._pending[sensor_id] = data
        if len(self._pending) != len(self._expected):
            return None
        self._current_start = self._current_end
        self._current_end = min(p.time for p in self._pending.values())
        return self._crop_and_merge()

    def _crop_and_merge(self) -> MergedRangeData:
        """(ref: range_data_collator.cc CropAndMerge:56)"""
        origins: List[np.ndarray] = []
        merged_pts: List[np.ndarray] = []
        merged_times: List[np.ndarray] = []
        merged_origin_idx: List[np.ndarray] = []
        for sensor_id in list(self._pending):
            data = self._pending[sensor_id]
            abs_times = data.time + data.times
            keep = (abs_times >= self._current_start) & (abs_times <= self._current_end)
            if keep.any():
                oi = len(origins)
                origins.append(data.origin)
                time_correction = data.time - self._current_end
                merged_pts.append(data.points[keep])
                merged_times.append(data.times[keep] + time_correction)
                merged_origin_idx.append(np.full(int(keep.sum()), oi, np.int32))
            # Keep the tail of the message for the next interval.
            tail = abs_times > self._current_end
            if tail.any():
                self._pending[sensor_id] = TimedCloudInput(
                    time=data.time,
                    origin=data.origin,
                    points=data.points[tail],
                    times=data.times[tail],
                )
            else:
                del self._pending[sensor_id]

        if merged_pts:
            pts = np.concatenate(merged_pts)
            times = np.concatenate(merged_times)
            oidx = np.concatenate(merged_origin_idx)
            order = np.argsort(times, kind="stable")
            pts, times, oidx = pts[order], times[order], oidx[order]
        else:
            pts = np.zeros((0, 3), np.float32)
            times = np.zeros(0, np.float32)
            oidx = np.zeros(0, np.int32)
        return MergedRangeData(
            time=self._current_end,
            origins=origins,
            points=pts,
            times=times,
            origin_indices=oidx,
        )
