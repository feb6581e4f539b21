"""Package-level guards of hectorgrapher_tpu_torch: it runs without JAX (the
2D front end and the CT 3D front end, window solve included), its serving
and distribution layers import without JAX (and without grpc until a
transport is built), and chip_smoke.py refuses to run without a CUDA card
(no CPU fallback)."""

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

# The CT 3D front end: three scans at tiny grids, the third solving a window.
from hectorgrapher_tpu_torch.evaluation.scan_generator import raycast_box_room_3d
from hectorgrapher_tpu_torch.mapping.ct.builder import OptimizingLocalTrajectoryBuilder

opts3 = cfg.replace_deep(cfg.TrajectoryBuilder3DOptions(), {
    "min_range": 0.4, "submaps.grid_type": "TSDF", "submaps.high_grid_size": 32, "submaps.low_grid_size": 16,
    "optimizing_local_trajectory_builder.initialization_duration": 0.0,
    "optimizing_local_trajectory_builder.max_control_points": 8,
    "optimizing_local_trajectory_builder.max_clouds_in_window": 8,
    "optimizing_local_trajectory_builder.points_per_cloud": 64,
    "optimizing_local_trajectory_builder.max_num_iterations": 2})
ct = OptimizingLocalTrajectoryBuilder(opts3, device=torch.device("cpu"))
results = []
for i in range(31):
    t = 0.01 * i
    ct.add_imu_data(t, np.array([0.0, 0.0, 9.80665]), np.zeros(3))
    if i % 5 == 0:
        ct.add_odometry_data(t, NpRigid3(np.array([0.2 * t, 0.0, 0.0])))
    if i % 10 == 5:
        pts = raycast_box_room_3d(np.array([0.2 * t, 0.0, 0.0]), np.array([1.0, 0, 0, 0]), num_azimuth=48, num_elevation=12)
        pts = pts[~np.isnan(pts[:, 0])]
        results.append(ct.add_range_data(TimedPointCloudData(
            t, np.zeros(3, np.float32), pad_timed_cloud(pts, np.zeros(len(pts), np.float32), 1024))))
assert ct.num_optimizations >= 1 and any(r is not None for r in results)
assert all(np.all(np.isfinite(r.local_pose.t)) for r in results if r is not None)
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


_SERVING_IMPORTS = """
import sys
sys.modules["grpc"] = None  # an import of grpc raises ImportError
import hectorgrapher_tpu_torch.cloud.server as server
import hectorgrapher_tpu_torch.cloud.ct_batcher
import hectorgrapher_tpu_torch.cloud.local_slam_result
import hectorgrapher_tpu_torch.cloud.wire
import hectorgrapher_tpu_torch.io.serialization
import hectorgrapher_tpu_torch.io.pbstream_state
from hectorgrapher_tpu_torch.common import config as cfg
from hectorgrapher_tpu_torch.mapping.map_builder import MapBuilder
core = server.MapBuilderServerCore(MapBuilder(cfg.replace_deep(cfg.MapBuilderOptions(), {
    "use_trajectory_builder_3d": True, "pose_graph.async_work_queue": False}), device="cpu"), batch_ct_windows=True)
assert core._handle_add_trajectory({}) == {"trajectory_id": 0}
assert core.map_builder.get_trajectory_builder(0)._local.window_solve_fn == core.ct_batcher._solve
try:
    server.MapBuilderServer(core.map_builder)
except ImportError:
    print("GRPC_BOUND_LAZILY")
"""

_CLOUD_AND_IO_IMPORTS = """
import importlib, pkgutil, sys
import hectorgrapher_tpu_torch.cloud as cloud, hectorgrapher_tpu_torch.io as io_pkg
names = [f"{pkg.__name__}.{m.name}" for pkg in (cloud, io_pkg) for m in pkgutil.iter_modules(pkg.__path__)]
for name in names:
    importlib.import_module(name)
print("MODULES", sorted(names))
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.") or m == "hectorgrapher_tpu" or m.startswith("hectorgrapher_tpu."))
print("LEAKED", leaked)
"""


def test_cloud_and_io_import_without_jax():
    """Every module of hectorgrapher_tpu_torch.cloud and .io imports, and
    none pulls in jax or the JAX package."""
    proc = subprocess.run([sys.executable, "-c", _CLOUD_AND_IO_IMPORTS], cwd=REPO, env=_env(), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    for name in ("cloud.wire", "cloud.ct_batcher", "cloud.local_slam_result", "cloud.server", "cloud.uploader",
                 "cloud.client", "cloud.solver_plane", "io.serialization", "io.protowire", "io.pbstream", "io.pbstream_state"):
        assert f"hectorgrapher_tpu_torch.{name}'" in proc.stdout, name
    assert "LEAKED []" in proc.stdout, proc.stdout


_DISTRIBUTION_IMPORTS = """
import importlib, pkgutil, sys
sys.modules["grpc"] = None  # an import of grpc raises ImportError
import hectorgrapher_tpu_torch.parallel as parallel
names = [f"parallel.{m.name}" for m in pkgutil.iter_modules(parallel.__path__)] + ["cloud.solver_plane"]
for name in names:
    importlib.import_module("hectorgrapher_tpu_torch." + name)
print("MODULES", sorted(names))
from hectorgrapher_tpu_torch.cloud.solver_plane import SolverPlaneFollower, SolverPlaneLeader
for cls, args in ((SolverPlaneFollower, ()), (SolverPlaneLeader, ([],))):
    try:
        cls(*args)
    except ImportError:
        print("GRPC_AT_CONSTRUCTION", cls.__name__)
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.") or m == "hectorgrapher_tpu" or m.startswith("hectorgrapher_tpu."))
print("LEAKED", leaked)
"""


def test_distribution_imports_without_jax_and_grpc():
    """Every module of hectorgrapher_tpu_torch.parallel and the solver
    plane import with grpc blocked and pull in neither jax nor the JAX
    package; the leader and the follower import grpc when constructed."""
    proc = subprocess.run([sys.executable, "-c", _DISTRIBUTION_IMPORTS], cwd=REPO, env=_env(), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    for name in ("parallel.mesh", "parallel.multihost", "parallel.sharded", "parallel.ct_windows",
                 "parallel.constraint_search", "cloud.solver_plane"):
        assert f"'{name}'" in proc.stdout, name
    assert "GRPC_AT_CONSTRUCTION SolverPlaneFollower" in proc.stdout
    assert "GRPC_AT_CONSTRUCTION SolverPlaneLeader" in proc.stdout
    assert "LEAKED []" in proc.stdout, proc.stdout


def test_server_core_and_batcher_import_without_grpc():
    """With grpc blocked, the server core and the batcher import and serve
    a trajectory; only binding the gRPC transport needs grpc."""
    proc = subprocess.run([sys.executable, "-c", _SERVING_IMPORTS], cwd=REPO, env=_env(), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "GRPC_BOUND_LAZILY" in proc.stdout


def test_mapping_does_not_load_the_serving_layer():
    """MapBuilder imports without hectorgrapher_tpu_torch.cloud: only an
    uplink trajectory loads it (its SubmapController), as in the JAX
    package."""
    code = ("import sys\nfrom hectorgrapher_tpu_torch.mapping.map_builder import MapBuilder\n"
            "print('CLOUD', sorted(m for m in sys.modules if m.startswith('hectorgrapher_tpu_torch.cloud')))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "CLOUD []" in proc.stdout, proc.stdout
