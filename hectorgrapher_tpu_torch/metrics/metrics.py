"""Host-side metrics registry (counterpart of the histogram and family
factory and RateTimer of hectorgrapher_tpu/metrics/metrics.py; ref:
cartographer/metrics/{counter,gauge,histogram,family_factory}.h,
common/rate_timer.h): the pose graph's score and residual histograms, its
batched-round counter and pack-bytes gauge, profiling.section's timings,
the front ends' latency and real-time ratios (mapping/frontend_metrics.py)
and the collators' sensor rates.

Plain Python, thread-safe: the pose graph's worker thread and the front
end write to the same families.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple


class Histogram:
    """(ref: metrics/histogram.h, fixed bucket boundaries)"""

    def __init__(self, boundaries: Sequence[float]):
        self._boundaries = list(boundaries)
        self._counts = [0] * (len(self._boundaries) + 1)
        self._sum = 0.0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        with self._lock:
            self._sum += value
            for i, b in enumerate(self._boundaries):
                if value <= b:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    @property
    def counts_by_bucket(self) -> List[int]:
        return list(self._counts)

    @property
    def sum(self) -> float:
        return self._sum


class Counter:
    """(ref: metrics/counter.h)"""

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def increment(self, by: float = 1.0) -> None:
        with self._lock:
            self._value += by

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """(ref: metrics/gauge.h)"""

    def __init__(self):
        self._value = 0.0

    def set(self, value: float) -> None:
        self._value = float(value)

    @property
    def value(self) -> float:
        return self._value


class Family:
    """Labelled metric family (ref: metrics/family_factory.h Family<T>)."""

    def __init__(self, name: str, description: str, factory):
        self.name = name
        self.description = description
        self._factory = factory
        self._metrics: Dict[Tuple[Tuple[str, str], ...], object] = {}
        self._lock = threading.Lock()

    def add(self, labels: Optional[Dict[str, str]] = None):
        key = tuple(sorted((labels or {}).items()))
        with self._lock:
            if key not in self._metrics:
                self._metrics[key] = self._factory()
            return self._metrics[key]

    def items(self):
        with self._lock:
            return [(dict(k), v) for k, v in self._metrics.items()]


class FamilyFactory:
    """(ref: metrics/family_factory.h)"""

    def __init__(self):
        self._families: List[Family] = []

    def new_histogram_family(self, name: str, description: str, boundaries: Sequence[float]) -> Family:
        f = Family(name, description, lambda: Histogram(boundaries))
        self._families.append(f)
        return f

    def new_counter_family(self, name: str, description: str) -> Family:
        f = Family(name, description, Counter)
        self._families.append(f)
        return f

    def new_gauge_family(self, name: str, description: str) -> Family:
        f = Family(name, description, Gauge)
        self._families.append(f)
        return f

    def text_format(self) -> str:
        """Prometheus text exposition, cumulative buckets."""
        lines = []
        for fam in self._families:
            lines.append(f"# HELP {fam.name} {fam.description}")
            for labels, metric in fam.items():
                label_str = ",".join(f'{k}="{v}"' for k, v in labels.items())
                label_part = "{" + label_str + "}" if label_str else ""
                if not isinstance(metric, Histogram):
                    lines.append(f"{fam.name}{label_part} {metric.value}")
                    continue
                lines.append(f"{fam.name}_sum{label_part} {metric.sum}")
                total = 0
                for b, c in zip(list(metric._boundaries) + ["+Inf"], metric.counts_by_bucket):
                    total += c
                    le = f'le="{b}"'
                    joined = f"{{{label_str},{le}}}" if label_str else f"{{{le}}}"
                    lines.append(f"{fam.name}_bucket{joined} {total}")
                lines.append(f"{fam.name}_count{label_part} {total}")
        return "\n".join(lines)


GLOBAL_FACTORY = FamilyFactory()


class RateTimer:
    """Event-rate estimator (ref: common/rate_timer.h RateTimer): pulses in
    a sliding window of `window_duration` seconds; the collators log each
    sensor's rate with it (collated_trajectory_builder.cc:66-84)."""

    def __init__(self, window_duration: float):
        from collections import deque

        self._window = window_duration
        self._events = deque()

    def pulse(self, time: float) -> None:
        self._events.append(time)
        while self._events and self._events[0] < time - self._window:
            self._events.popleft()

    def compute_rate(self) -> float:
        if len(self._events) < 2:
            return 0.0
        dt = self._events[-1] - self._events[0]
        return (len(self._events) - 1) / dt if dt > 0 else 0.0
