"""Mean time of a pose-graph optimization of the window (ms): the
program's hg_section_seconds{section=pose_graph_optimization} over the
window (layer: pose graph)."""


def read(readings):
    total, count = readings.get("sections", {}).get("pose_graph_optimization", (0.0, 0))
    return None if count == 0 else 1e3 * total / count
