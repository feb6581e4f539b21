"""Floor detection from a trajectory's z profile (counterpart of
hectorgrapher_tpu/mapping/detect_floors.py).

(ref: cartographer/mapping/detect_floors.{h,cc} DetectFloors — segment
the trajectory by z level using a histogram of node heights; used for
per-floor X-ray/map export of multi-storey buildings.)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np


@dataclass
class Timespan:
    start: float
    end: float


@dataclass
class Floor:
    """(ref: detect_floors.h Floor — timespans at one z level)"""

    timespans: List[Timespan]
    z: float


def detect_floors(
    times: Sequence[float],
    z_values: Sequence[float],
    z_bin: float = 0.3,
    min_timespan: float = 5.0,
    min_fraction: float = 0.05,
) -> List[Floor]:
    """Cluster node heights into floors and collect the time spans spent on
    each (simplified from the reference's sliding-window mode filter)."""
    times = np.asarray(times)
    z = np.asarray(z_values)
    if len(times) == 0:
        return []

    bins = np.round(z / z_bin).astype(np.int64)
    unique, counts = np.unique(bins, return_counts=True)
    significant = set(unique[counts >= max(1, int(min_fraction * len(z)))].tolist())
    if not significant:
        significant = {int(unique[np.argmax(counts)])}

    # Snap each node to the nearest significant level.
    levels = np.asarray(sorted(significant))
    snapped = levels[np.argmin(np.abs(bins[:, None] - levels[None, :]), axis=1)]

    floors: dict = {}
    span_start = times[0]
    current = snapped[0]
    zs: dict = {lvl: [] for lvl in levels}
    for i in range(1, len(times) + 1):
        if i == len(times) or snapped[i] != current:
            end = times[i - 1] if i < len(times) else times[-1]
            if end - span_start >= min_timespan or len(times) < 3:
                floors.setdefault(int(current), []).append(Timespan(float(span_start), float(end)))
                zs[current].extend(z[(times >= span_start) & (times <= end)].tolist())
            if i < len(times):
                span_start = times[i]
                current = snapped[i]
    if not floors:
        # A short log: every span fell under min_timespan, so the whole
        # trajectory is one floor rather than none (a valid 3-second log
        # must still export).
        lvl = int(snapped[0])
        floors[lvl] = [Timespan(float(times[0]), float(times[-1]))]
        zs[snapped[0]].extend(z.tolist())
    return [
        Floor(timespans=spans, z=float(np.mean(zs[lvl])) if zs[lvl] else lvl * z_bin)
        for lvl, spans in sorted(floors.items())
    ]
