"""Mean time of a constraint-search round of the window (ms): the
program's hg_section_seconds{section=constraint_search} over the window,
the pose graph's worker's host clock around a round that ends in host
readbacks (layer: pose graph)."""


def read(readings):
    total, count = readings.get("sections", {}).get("constraint_search", (0.0, 0))
    return None if count == 0 else 1e3 * total / count
