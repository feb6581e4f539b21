"""95th percentile of the window's per-scan times (ms): the harness's clock
around each scan handed to the map builder, ending in a synchronize, over
every scan of the window (layer: map builder entry)."""

from hgbench.lib.stats import percentile


def read(readings):
    lat = readings.get("scan_latencies_s")
    return None if not lat else 1e3 * percentile(lat, 95)
