"""Share of the window the pose graph's worker spent on work items (%):
the program's section pg.work (hg_section_seconds; one worker, so its
items do not overlap) summed over the items that ended in the window,
over the window's seconds (layer: pose graph). Items count whole by
their end time, not clipped to the window (the histogram keeps no start
time): an SPA item across an edge moves the share by its length over
the window's, and can take it a little past 100."""


def read(readings):
    total, count = readings.get("sections", {}).get("pg.work", (0.0, 0))
    window_s = readings.get("window_s")
    return None if count == 0 or not window_s else 100.0 * total / window_s
