"""The port's small host modules against the JAX package's: floor
detection (mapping/detect_floors.py), the control-point CSV logger
(mapping/ct/debug_logger.py) and the Prometheus HTTP exporter
(metrics/http_exporter.py), with the cases of tests/test_misc_mapping.py,
tests/test_metrics.py and tests/test_drawing.py.

Tolerance: equal results (floors, CSV text byte for byte); the exporter
serves the port's own registry. Last, the classic builder and these
modules run in a process that imports neither jax nor hectorgrapher_tpu.
"""

import urllib.request

import numpy as np
import pytest

from hectorgrapher_tpu.mapping.ct import builder as jct
from hectorgrapher_tpu.mapping.ct import debug_logger as jlog
from hectorgrapher_tpu.mapping.detect_floors import detect_floors as jax_detect_floors
from hectorgrapher_tpu.transform import np_quat as jnq
from hectorgrapher_tpu_torch.common import profiling
from hectorgrapher_tpu_torch.mapping.ct import builder as tct
from hectorgrapher_tpu_torch.mapping.ct import debug_logger as tlog
from hectorgrapher_tpu_torch.mapping.detect_floors import detect_floors
from hectorgrapher_tpu_torch.metrics.http_exporter import MetricsExporter
from hectorgrapher_tpu_torch.metrics.metrics import FamilyFactory
from hectorgrapher_tpu_torch.transform import np_quat as tnq


def _floors(floors):
    return [(f.z, [(s.start, s.end) for s in f.timespans]) for f in floors]


FLOOR_CASES = {
    "two_floors": lambda: (np.arange(0, 60, 0.5), None),
    "single_floor": lambda: (np.arange(0, 30, 0.5), np.random.default_rng(0).normal(0, 0.05, 60)),
    "short_log": lambda: (np.arange(0, 3, 0.5), np.array([0.0, 0.0, 2.0, 2.0, 0.0, 0.0])),
    "three_floors": lambda: (np.arange(0, 90, 0.5), None),
    "empty": lambda: (np.zeros(0), np.zeros(0)),
}


def _z(case, times):
    if case == "two_floors":
        return np.where(times < 25, 0.0, np.where(times < 30, (times - 25) * 0.6, 3.0))
    return np.where(times < 30, 0.0, np.where(times < 60, 3.0, 6.2))  # three_floors


@pytest.mark.parametrize("case", sorted(FLOOR_CASES))
def test_detect_floors_matches_jax(case):
    times, z = FLOOR_CASES[case]()
    z = _z(case, times) if z is None else z
    got = detect_floors(times, z)
    assert _floors(got) == _floors(jax_detect_floors(times, z))
    expected = {"two_floors": 2, "single_floor": 1, "short_log": 1, "three_floors": 3, "empty": 0}[case]
    assert len(got) == expected
    if case == "two_floors":  # tests/test_misc_mapping.py's bounds
        assert abs(got[0].z - 0.0) < 0.3 and abs(got[1].z - 3.0) < 0.3


def _control_points(builder, nq):
    rng = np.random.default_rng(5)
    first = builder.CpState(np.array([1.0, 2, 3]), nq.quat_identity(), np.zeros(3))
    return [builder.ControlPoint(time=1.5, state=first, translation_ratio=0.1),
            builder.ControlPoint(time=np.float64(2.25), state=builder.CpState(
                rng.normal(size=3), nq.quat_from_axis_angle(rng.normal(size=3)), rng.normal(size=3).astype(np.float32)),
                translation_ratio=0.5, rotation_ratio=np.float32(0.25), time_ratio=1e-9)]


def test_debug_logger_matches_jax(tmp_path):
    logs = []
    for mod, builder, nq in ((jlog, jct, jnq), (tlog, tct, tnq)):
        log = mod.DebugLogger()
        for cp in _control_points(builder, nq):
            log.add_entry(cp)
        logs.append(log.getvalue())
    assert logs[1] == logs[0]
    lines = logs[1].strip().splitlines()
    assert lines[0].startswith("time,tx") and lines[1].startswith("1.5,1.0")  # tests/test_misc_mapping.py's

    path = tmp_path / "test_log.csv"
    log = tlog.DebugLogger(str(path))
    for cp in _control_points(tct, tnq):
        log.add_entry(cp)
    with pytest.raises(ValueError):
        log.getvalue()
    log.close()
    assert path.read_text() == logs[0]


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.read(), resp.headers


def test_default_exporter_serves_the_process_registry():
    """tests/test_metrics.py's case: the default exporter serves the
    registry the port's instrumentation writes to."""
    with profiling.section("exporter_smoke"):
        pass
    exporter = MetricsExporter(port=0).start()
    try:
        body = _get(f"http://127.0.0.1:{exporter.port}/metrics")[0].decode()
    finally:
        exporter.shutdown()
    assert "hg_section_seconds" in body and "exporter_smoke" in body


def test_scrape_metrics_endpoint():
    """tests/test_drawing.py's case: a given registry, /metrics, /healthz
    and a 404."""
    factory = FamilyFactory()
    counter = factory.new_counter_family("mapping_2d_scans", "scans processed").add({})
    counter.increment()
    counter.increment()
    exporter = MetricsExporter(factory, port=0).start()
    try:
        body, headers = _get(f"http://127.0.0.1:{exporter.port}/metrics")
        assert headers["Content-Type"].startswith("text/plain")
        assert "# HELP mapping_2d_scans scans processed" in body.decode()
        assert "mapping_2d_scans 2" in body.decode()
        assert _get(f"http://127.0.0.1:{exporter.port}/healthz")[0] == b"ok\n"
        with pytest.raises(urllib.error.HTTPError):
            _get(f"http://127.0.0.1:{exporter.port}/nope")
    finally:
        exporter.shutdown()


_NEW_MODULES = """
import sys
import numpy as np
import torch
from hectorgrapher_tpu_torch.common import config as cfg, lua_config
from hectorgrapher_tpu_torch.evaluation import metrics, relations_text_file
from hectorgrapher_tpu_torch.evaluation.scan_generator import raycast_box_room_3d
from hectorgrapher_tpu_torch.mapping import detect_floors, local_3d
from hectorgrapher_tpu_torch.mapping.ct import debug_logger
from hectorgrapher_tpu_torch.metrics import http_exporter
from hectorgrapher_tpu_torch.sensor.types import TimedPointCloudData, pad_timed_cloud
from hectorgrapher_tpu_torch.solvers import gauss_newton
from hectorgrapher_tpu_torch.tools import generate_lua_defaults

opts = cfg.replace_deep(cfg.TrajectoryBuilder3DOptions(), {
    "min_range": 0.4, "submaps.high_grid_size": 32, "submaps.low_grid_size": 16,
    "use_online_correlative_scan_matching": True})
builder = local_3d.LocalTrajectoryBuilder3D(opts, device="cpu")
for i in range(3):
    t = 0.1 * i
    builder.add_imu_data(t, np.array([0.0, 0.0, 9.80665]), np.zeros(3))
    pts = raycast_box_room_3d(np.zeros(3), np.array([1.0, 0, 0, 0]), num_azimuth=48, num_elevation=12)
    result = builder.add_range_data(TimedPointCloudData(
        t + 0.05, np.zeros(3, np.float32), pad_timed_cloud(pts, np.zeros(len(pts), np.float32), 1024)))
    assert result is not None and np.all(np.isfinite(result.local_pose.t))
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.") or m == "hectorgrapher_tpu" or m.startswith("hectorgrapher_tpu."))
print("LEAKED", leaked)
"""


def test_new_modules_run_without_jax():
    """The classic builder (three scans, the correlative search on) and the
    host modules import and run with neither jax nor hectorgrapher_tpu."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _NEW_MODULES], cwd=Path(__file__).resolve().parent.parent, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "LEAKED []" in proc.stdout
