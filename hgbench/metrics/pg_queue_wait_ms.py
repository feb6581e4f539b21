"""Mean wait of a pose graph work item in the window (ms): the program's
section pg.queue_wait (hg_section_seconds), from an item's put on the
front end's thread to its get on the worker, over the items got in the
window (layer: pose graph)."""


def read(readings):
    total, count = readings.get("sections", {}).get("pg.queue_wait", (0.0, 0))
    return None if count == 0 else 1e3 * total / count
