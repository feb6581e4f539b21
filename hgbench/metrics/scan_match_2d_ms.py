"""Mean time of the 2D front end's scan match in the window (ms): the
program's section 2d.scan_match (hg_section_seconds), the adaptive voxel
filter and the GN through the matched pose's readback, over the window
(layer: 2D front end)."""


def read(readings):
    total, count = readings.get("sections", {}).get("2d.scan_match", (0.0, 0))
    return None if count == 0 else 1e3 * total / count
