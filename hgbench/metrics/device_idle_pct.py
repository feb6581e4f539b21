"""Share of the traced window in which no operation ran on the device (%),
from the profiler's trace (layer: device)."""


def read(readings):
    trace = readings.get("trace")
    if trace is None or not trace.ops or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
