"""Mean wait of a sensor item in the server's queue in the window (ms):
the program's section server.queue_wait (hg_section_seconds), from an
item's put by its gRPC handler to its get on the SLAM thread, over the
items got in the window (layer: server)."""


def read(readings):
    total, count = readings.get("sections", {}).get("server.queue_wait", (0.0, 0))
    return None if count == 0 else 1e3 * total / count
