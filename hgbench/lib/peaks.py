"""The card's peaks, and the least time a call could take.

NVIDIA H100 SXM (data sheet, dense, at its 700 W limit): 3.35 TB/s of
HBM3, 67 TFLOP/s of float32 outside the tensor cores. A layer call's
roofline bound is the larger of its bytes over the first and its
operations over the second; bytes count each input read once and each
output written once, a gather's distinct 32-byte sectors (the work
counts under hgbench/roofline/)."""

from __future__ import annotations

import sys

import torch

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12


def bound_s(nbytes: float, ops: float) -> float:
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S)


def sectors(idx, element_bytes: int = 4) -> int:
    """Distinct 32-byte sectors of the elements at flat indices idx."""
    return int(torch.unique(idx.reshape(-1) // (32 // element_bytes)).numel())


def roofline_pct(readings: dict, call: str, work) -> float | None:
    """The share of its roofline of a layer call in the traced scans: the
    sum of the calls' bounds over the device time of every operation
    launched inside the calls' spans, in percent. None where the trace
    holds no such call, or its spans and the recorded calls differ in
    number."""
    trace, calls = readings.get("trace"), readings.get("calls", {}).get(call)
    if trace is None or not calls:
        return None
    spans = trace.ops_by_span(call)
    device_ns = sum(o.end - o.start for _, ops in spans for o in ops)
    if len(spans) != len(calls) or device_ns <= 0:
        print(f"roofline of {call}: {len(calls)} calls, {len(spans)} spans, {device_ns} ns on the device: "
              "not read", file=sys.stderr)
        return None
    bound = sum(bound_s(*work(args, kwargs)) for args, kwargs in calls)
    return 100.0 * bound / (device_ns / 1e9)
