"""Package-level guards of hectorgrapher_tpu_torch: it runs without JAX,
and chip_smoke.py refuses to run without a CUDA card (no CPU fallback)."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_FRONT_END_STEP = """
import sys
import numpy as np
import torch
import hectorgrapher_tpu_torch
from hectorgrapher_tpu_torch.common import config as cfg
from hectorgrapher_tpu_torch.evaluation.scan_generator import raycast_rect_room_2d
from hectorgrapher_tpu_torch.mapping.local_2d import LocalTrajectoryBuilder2D
from hectorgrapher_tpu_torch.sensor.types import TimedPointCloudData, pad_timed_cloud
from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3

torch.set_num_threads(1)
opts = cfg.replace_deep(cfg.TrajectoryBuilder2DOptions(), {
    "use_imu_data": False, "use_online_correlative_scan_matching": True,
    "submaps.grid_size": 128, "max_num_points": 512, "max_range": 6.0,
    "real_time_correlative_scan_matcher.angular_search_window": 0.05})
builder = LocalTrajectoryBuilder2D(opts, device=torch.device("cpu"))
for i in range(2):
    pts = raycast_rect_room_2d(np.zeros(2), 0.0, half_width=2.5, half_height=2.0, num_rays=360)
    builder.add_odometry_data(0.1 * i, NpRigid3())
    result = builder.add_range_data(TimedPointCloudData(
        0.1 * i, np.zeros(3, np.float32), pad_timed_cloud(pts.astype(np.float32), np.zeros(360, np.float32), 512)))
    assert result is not None and np.all(np.isfinite(result.local_pose.t))
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.") or m == "hectorgrapher_tpu" or m.startswith("hectorgrapher_tpu."))
print("LEAKED", leaked)
"""


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(extra)
    return env


def test_package_runs_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _FRONT_END_STEP], cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    assert "LEAKED []" in proc.stdout, proc.stdout


def _last_line(text):
    lines = text.strip().splitlines()
    return lines[-1] if lines else ""


def test_chip_smoke_refuses_without_cuda():
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, env=_env(CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in _last_line(proc.stdout)
    assert "torch.cuda.is_available() is false" in proc.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=_env(), capture_output=True, text=True, timeout=300
    )
    assert proc.returncode != 0
    assert '"ok": true' not in _last_line(proc.stdout)
