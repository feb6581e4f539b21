"""Mean time of building a CT window solve in the window (ms): the
program's section ct.build_window (hg_section_seconds), the host's window
problem from the control points, clouds, IMU pairs and odometry, and its
upload, over the window (layer: CT front end)."""


def read(readings):
    total, count = readings.get("sections", {}).get("ct.build_window", (0.0, 0))
    return None if count == 0 else 1e3 * total / count
