"""Mean time of a CT window solve in the window of a --trace 1 run (ms):
the harness's clock around each solve_ct_window call, ending in a
synchronize, with the profiler off (layer: CT front end)."""


def read(readings):
    times = readings.get("layer_s", {}).get("ct_solve")
    return None if not times else 1e3 * sum(times) / len(times)
