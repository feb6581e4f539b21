"""Kernels on the device trace per traced scan (launches/scan): every
kernel of the traced window, the pose graph's worker's included, over the
scans handed in it (layer: device)."""


def read(readings):
    trace, n = readings.get("trace"), readings.get("trace_scans")
    if trace is None or not n or not trace.ops:
        return None
    return len(trace.kernels()) / n
