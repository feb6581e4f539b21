"""Trajectory builder behind the sensor collator (counterpart of
hectorgrapher_tpu/mapping/collated_trajectory_builder.py, host only).

(ref: cartographer/mapping/internal/collated_trajectory_builder.{h,cc} —
wraps a (global) trajectory builder behind sensor::Collator so all sensor
streams reach it in a single monotonic time order; logs per-sensor rates
via RateTimer, collated_trajectory_builder.cc:65-87.)
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from hectorgrapher_tpu_torch.metrics.metrics import RateTimer
from hectorgrapher_tpu_torch.sensor.collator import Collator


class CollatedTrajectoryBuilder:
    RATE_WINDOW_SECONDS = 15.0  # (ref: kSensorDataRatesLoggingPeriodSeconds)

    def __init__(
        self,
        collator: Collator,
        trajectory_id: int,
        wrapped_builder,
        expected_sensor_ids: Sequence[str],
        log_fn=None,
    ):
        self._wrapped = wrapped_builder
        self._collator = collator
        self.trajectory_id = trajectory_id
        self._rate_timers: Dict[str, RateTimer] = {}
        self._last_log_time: Dict[str, float] = {}
        self._log_fn = log_fn
        collator.add_trajectory(trajectory_id, list(expected_sensor_ids), self._handle)

    def add_sensor_data(self, sensor_id: str, time: float, kind: str, payload) -> None:
        """kind: "range" | "imu" | "odometry" | "fixed_frame" | "landmark"."""
        self._collator.add_sensor_data(self.trajectory_id, sensor_id, time, (kind, payload))

    def finish(self) -> None:
        self._collator.finish_trajectory(self.trajectory_id)

    def _handle(self, sensor_id: str, time: float, item) -> None:
        """(ref: HandleCollatedSensorData — rate logging + dispatch)"""
        timer = self._rate_timers.setdefault(sensor_id, RateTimer(self.RATE_WINDOW_SECONDS))
        timer.pulse(time)
        if self._log_fn is not None:
            # Once per window, not per sample (ref: LOG_EVERY via
            # kSensorDataRatesLoggingPeriodSeconds) — a kHz IMU would
            # otherwise log hundreds of lines per second.
            last = self._last_log_time.get(sensor_id)
            if last is None or time - last >= self.RATE_WINDOW_SECONDS:
                self._last_log_time[sensor_id] = time
                self._log_fn(sensor_id, timer.compute_rate())
        kind, payload = item
        if kind == "range":
            self._wrapped.add_range_data(payload)
        elif kind == "imu":
            self._wrapped.add_imu_data(*payload)
        elif kind == "odometry":
            self._wrapped.add_odometry_data(*payload)
        elif kind == "fixed_frame":
            self._wrapped.add_fixed_frame_pose_data(*payload)
        elif kind == "landmark":
            self._wrapped.add_landmark_data(*payload)
        else:
            raise ValueError(f"unknown sensor data kind {kind!r}")
