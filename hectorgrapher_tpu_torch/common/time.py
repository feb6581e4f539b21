"""Time representation (a host-only copy of hectorgrapher_tpu/common/time.py).

The reference represents time as 100ns ticks since 0001-01-01 (UTC) via a
custom chrono clock (ref: cartographer/common/time.h:1-69). Here time is a
plain float64 of seconds since an arbitrary epoch: all consumers only ever
take differences or interpolate, and float64 seconds keep sub-microsecond
precision over multi-day spans.

Host-side bookkeeping uses python floats; on-device timestamps are float64
(or float32 *relative* times, as in per-point times within a scan).
"""

from __future__ import annotations

# 100ns ticks per second in the reference's universal time; kept only for
# converting reference-format data (ref: common/time.h kUtsTicksPerSecond).
UTS_TICKS_PER_SECOND = 10_000_000
# Offset of Unix epoch from 0001-01-01 in seconds (ref: common/time.h
# kUtsEpochOffsetFromUnixEpochInSeconds).
UTS_EPOCH_OFFSET_FROM_UNIX_EPOCH_SECONDS = 62_135_596_800


def from_universal(ticks: int) -> float:
    """Convert reference universal-time ticks (100ns since year 1) to seconds."""
    return ticks / UTS_TICKS_PER_SECOND


def to_universal(seconds: float) -> int:
    """Convert seconds to reference universal-time ticks."""
    return int(round(seconds * UTS_TICKS_PER_SECOND))


def from_unix_seconds(unix_seconds: float) -> float:
    """Unix seconds -> universal seconds (since 0001-01-01)."""
    return unix_seconds + UTS_EPOCH_OFFSET_FROM_UNIX_EPOCH_SECONDS
