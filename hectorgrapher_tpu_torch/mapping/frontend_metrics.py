"""Front-end observability: local-SLAM latency and real-time ratios
(counterpart of hectorgrapher_tpu/mapping/frontend_metrics.py; ref:
mapping/internal/2d/local_trajectory_builder_2d.cc:29-36
kLocalSlamLatencyMetric, kLocalSlamRealTimeRatio,
kLocalSlamCpuRealTimeRatio, and optimizing_local_trajectory_builder.cc
:1667-1678).

A real-time ratio above 1 means the front end processes sensor time
faster than wall time: whether a robot can run live. The ratios are taken
over a sliding window of the last WINDOW steps.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, Optional

from hectorgrapher_tpu_torch.common.profiling import global_factory

_FAMILIES: Optional[Dict[str, object]] = None
_LOCK = threading.Lock()

LATENCY_BUCKETS = [1e-3, 3e-3, 0.01, 0.03, 0.1, 0.3, 1.0, 3.0]  # seconds


def _families() -> Dict[str, object]:
    global _FAMILIES
    with _LOCK:
        if _FAMILIES is None:
            f = global_factory()
            _FAMILIES = {
                "latency": f.new_histogram_family(
                    "hg_local_slam_latency_seconds",
                    "wall time per front-end range-data step (ref: kLocalSlamLatencyMetric)",
                    boundaries=LATENCY_BUCKETS,
                ),
                "rtr": f.new_gauge_family(
                    "hg_local_slam_real_time_ratio",
                    "sensor seconds processed per wall second; >1 keeps up (ref: kLocalSlamRealTimeRatio)",
                ),
                "cpu_rtr": f.new_gauge_family(
                    "hg_local_slam_cpu_real_time_ratio",
                    "sensor seconds processed per host-thread CPU second (ref: kLocalSlamCpuRealTimeRatio)",
                ),
            }
        return _FAMILIES


class FrontEndMetrics:
    """Per-builder latency and real-time-ratio instrumentation; a builder
    passes its kind as the `builder` label ("2d", "ct_3d", "classic_3d").
    Builders of one kind share the label's metrics, as in the JAX package."""

    WINDOW = 32

    def __init__(self, builder: str):
        fams = _families()
        labels = {"builder": builder}
        self._latency = fams["latency"].add(labels)
        self._rtr = fams["rtr"].add(labels)
        self._cpu_rtr = fams["cpu_rtr"].add(labels)
        self._events = collections.deque(maxlen=self.WINDOW)

    def observe_step(self, sensor_time: float, wall_dt: float, cpu_dt: float) -> None:
        self._latency.observe(wall_dt)
        self._events.append((sensor_time, wall_dt, cpu_dt))
        if len(self._events) < 2:
            return
        sensor_span = self._events[-1][0] - self._events[0][0]
        wall = sum(e[1] for e in self._events)
        cpu = sum(e[2] for e in self._events)
        if sensor_span > 0 and wall > 0:
            self._rtr.set(sensor_span / wall)
        if sensor_span > 0 and cpu > 0:
            self._cpu_rtr.set(sensor_span / cpu)

    @property
    def latency(self):
        """The latency histogram (counts_by_bucket over LATENCY_BUCKETS and +inf, sum)."""
        return self._latency

    @property
    def real_time_ratio(self) -> float:
        return self._rtr.value

    @property
    def cpu_real_time_ratio(self) -> float:
        return self._cpu_rtr.value
