"""95th percentile of the fleet's scan times in the window (ms): the load
generator's clock from a scan's upload to the server until it leaves
flight (its result back on the robot's stream, or the server done with a
scan that gives none), over every robot's scans that left flight in the
window (layer: server)."""

from hgbench.lib.stats import percentile


def read(readings):
    lat = readings.get("fleet_latencies_s")
    return None if not lat else 1e3 * percentile(lat, 95)
