"""Statistics the harness reports."""

from __future__ import annotations


def percentile(values, p: float):
    """The p-th percentile (0-100) by linear interpolation between order
    statistics (numpy's default), None for no values."""
    v = sorted(values)
    if not v:
        return None
    pos = (len(v) - 1) * p / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)

