"""Mean wait of a robot's window solve in the batcher in the window (ms):
the program's section ct.batch_wait (hg_section_seconds), on the robot's
worker thread from its request's append to its wake, so the wait for the
other robots' windows and for the solve (layer: CT batcher)."""


def read(readings):
    total, count = readings.get("sections", {}).get("ct.batch_wait", (0.0, 0))
    return None if count == 0 else 1e3 * total / count
