"""Parity of the port's 3D back end (hectorgrapher_tpu_torch/mapping/
pose_graph/pose_graph.py PoseGraph3D, mapping/map_builder.py) with the JAX
package's, on the CPU with the same inputs and async_work_queue=False on
both sides (with the worker thread, local_to_global races the optimization
and the two graphs would start from different poses).

- tests/test_pose_graph_3d_integration.py TestLoopClosure3D's scene through
  both graphs: the same constraints, INTER zbar within 1e-3, and the
  optimized poses within 1e-3.
- A short MapBuilder 3D drive (tests/test_map_builder_3d.py make_options(),
  96^3 / 48^3 grids, 2 s) through both packages: equal node and constraint
  counts and global poses within 1e-3 m.
- Two trajectories with IMU, odometry, fixed-frame and landmark data: every
  family of _build_extras, the landmark poses, then delete_trajectory.

Tolerances: the matches are the same (tests/test_torch_fast_correlative_3d.py)
and GN3D agrees to 1e-4 (tests/test_torch_gn_3d.py); SPA then sums in
another order, and the JAX solve computes some residuals in float64 under
the tests' x64 mode (ROADMAP C1). 1e-3 holds that with room.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hectorgrapher_tpu.common.config import replace_deep
from hectorgrapher_tpu.mapping.grids import make_tsdf_grid
from hectorgrapher_tpu.mapping.map_builder import MapBuilder as JMapBuilder
from hectorgrapher_tpu.mapping.pose_graph.pose_graph import PgNode
from hectorgrapher_tpu.mapping.pose_graph.pose_graph import PoseGraph3D as JPoseGraph3D
from hectorgrapher_tpu.mapping.submap_3d import Submap3D as JSubmap3D
from hectorgrapher_tpu.sensor.types import TimedPointCloudData, pad_timed_cloud
from hectorgrapher_tpu.transform import np_quat as nq
from hectorgrapher_tpu.transform.np_quat import NpRigid3
from hectorgrapher_tpu_torch import convert
from hectorgrapher_tpu_torch.common import config as tcfg
from hectorgrapher_tpu_torch.common import profiling
from hectorgrapher_tpu_torch.common.math import normalize_angle_difference
from hectorgrapher_tpu_torch.mapping.map_builder import MapBuilder
from hectorgrapher_tpu_torch.mapping.pose_graph.pose_graph import PgNode as TPgNode
from hectorgrapher_tpu_torch.mapping.pose_graph.pose_graph import PoseGraph3D
from hectorgrapher_tpu_torch.mapping.scan_matching import fast_correlative_3d as tfc
from hectorgrapher_tpu_torch.sensor import types as ttypes
from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3 as TNpRigid3
from test_map_builder_3d import make_options
from test_pose_graph_3d_integration import HIST, build_finished_submap, make_node, pose_graph_options
from torch_parity import CPU, ct_drive

torch.set_num_threads(1)

SYNC = {"async_work_queue": False, "use_batched_constraint_search": False}


def _assert_pose_close(got, want, atol=1e-3):
    np.testing.assert_allclose(got.t, want.t, rtol=0, atol=atol)
    assert nq.quat_angle(nq.quat_multiply(nq.quat_conjugate(want.q), got.q)) < atol


def _assert_same_graph(pg, jpg):
    assert len(pg.nodes) == len(jpg.nodes) and len(pg.submaps) == len(jpg.submaps)
    assert [(c.tag, c.submap_index, c.node_index) for c in pg.constraints] == [
        (c.tag, c.submap_index, c.node_index) for c in jpg.constraints]
    for c, jc in zip(pg.constraints, jpg.constraints):
        _assert_pose_close(c.zbar, jc.zbar)
    for n, jn in zip(pg.nodes, jpg.nodes):
        _assert_pose_close(n.global_pose, jn.global_pose)
    for s, js in zip(pg.submaps, jpg.submaps):
        _assert_pose_close(s.global_pose, js.global_pose)


def test_loop_closure_matches_jax():
    """TestLoopClosure3D: two drift-free nodes INTRA to the anchor submap,
    then a node 0.35 m off INTRA only to an active submap; its INTER search
    against the anchor, then the final optimization, in both graphs."""
    jopts = replace_deep(pose_graph_options(), SYNC)
    jpg = JPoseGraph3D(jopts, histogram_size=HIST)
    pg = PoseGraph3D(convert.options(jopts), histogram_size=HIST, device=CPU)
    anchor = build_finished_submap([np.zeros(3), np.array([0.4, 0.3, 0.0]), np.array([0.8, -0.3, 0.0])])
    active = JSubmap3D(local_pose=NpRigid3(np.array([1.2, 0.0, 0.0])),
                       high_resolution_grid=make_tsdf_grid(0.1, (16, 16, 16), 0.3, 1000.0),
                       low_resolution_grid=make_tsdf_grid(0.45, (8, 8, 8), 1.0, 1000.0),
                       rotational_histogram=np.zeros(HIST, np.float32), num_range_data=1)
    port_submaps = {id(anchor): convert.submap_3d(anchor, CPU), id(active): convert.submap_3d(active, CPU)}
    truth = np.array([0.3, -0.2, 0.0])
    steps = [((0.0, [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]), anchor), ((0.1, [0.4, 0.3, 0.0], [0.4, 0.3, 0.0]), anchor),
             ((0.2, truth + [0.35, 0.0, 0.0], truth), active)]
    tfc.match_fast_3d.score_sums = 0
    for args, submap in steps:
        node = make_node(*args)
        jpg.add_node(node, [submap])
        pg.add_node(convert.pg_node(node, CPU), [port_submaps[id(submap)]])
    inter = [c for c in pg.constraints if c.tag == "INTER"]
    assert any(c.node_index == 2 and c.submap_index == 0 for c in inter)
    assert tfc.match_fast_3d.score_sums >= 4  # at least one full search: coarse + 3 expansion levels
    _assert_same_graph(pg, jpg)
    jpg.run_final_optimization()
    pg.run_final_optimization()
    _assert_same_graph(pg, jpg)
    assert np.linalg.norm(pg.nodes[2].global_pose.t - truth) < 0.15
    # The searches' scores and the sections land in the metrics registry.
    report = profiling.report()
    for name in ("pose_graph_constraint_scores_local_count", 'section="constraint_search"',
                 'hg_pose_graph_residual_translation_m_count{tag="INTER"}'):
        assert name in report


def test_map_builder_3d_matches_jax():
    """MapBuilder(use_trajectory_builder_3d) -> TrajectoryBuilder -> CT
    front end -> PoseGraph3D over 2 s of tests/test_ct_builder.py's drive,
    IMU and odometry routed to both; then the final optimization."""
    jopts = replace_deep(make_options(), {f"pose_graph.{k}": v for k, v in SYNC.items()})
    jmb = JMapBuilder(jopts)
    mb = MapBuilder(convert.options(jopts), device=CPU)
    jtb = jmb.get_trajectory_builder(jmb.add_trajectory_builder())
    tb = mb.get_trajectory_builder(mb.add_trajectory_builder())
    want = ct_drive(jtb, NpRigid3, TimedPointCloudData, pad_timed_cloud, duration=2.0)
    got = ct_drive(tb, TNpRigid3, ttypes.TimedPointCloudData, ttypes.pad_timed_cloud, duration=2.0)
    assert len(got) == len(want)
    jpg, pg = jmb.pose_graph, mb.pose_graph
    assert len(pg.nodes) == len(jpg.nodes) >= 8
    assert pg.num_optimizations == jpg.num_optimizations >= 1  # optimize_every_n_nodes 8
    assert sum(c.tag == "INTRA" for c in pg.constraints) >= len(pg.nodes)
    jpg.run_final_optimization()
    pg.run_final_optimization()
    assert [(c.tag, c.submap_index, c.node_index) for c in pg.constraints] == [
        (c.tag, c.submap_index, c.node_index) for c in jpg.constraints]
    for n, jn in zip(pg.nodes, jpg.nodes):
        assert n.time == jn.time
        _assert_pose_close(n.global_pose, jn.global_pose)


@pytest.mark.parametrize("fix_z", [False, True])
def test_extras_landmarks_and_delete_match_jax(fix_z):
    """Two trajectories of nodes INTRA to unfinished submaps (no search),
    with IMU, odometry, fixed-frame poses and landmarks buffered in both
    graphs: every _build_extras family (IMU rotation and acceleration, or
    odometry and local-pose terms under fix_z_in_3d), the final solve and
    the landmark poses, then delete_trajectory(1)'s trim."""
    # Noise-free IMU and a fixed extrinsic keep the solve well posed: with a
    # free extrinsic and gravity (tests/test_torch_spa_3d.py covers both),
    # 50 LM steps stop in a flat valley where f32 rounding decides the end.
    jopts = replace_deep(pose_graph_options(), {**SYNC, "optimization_problem.fix_z_in_3d": fix_z,
                                                 "optimization_problem.use_online_imu_extrinsics_in_3d": False})
    jpg = JPoseGraph3D(jopts, histogram_size=HIST)
    pg = PoseGraph3D(convert.options(jopts), histogram_size=HIST, device=CPU)
    rng = np.random.default_rng(11)
    subs = [JSubmap3D(local_pose=NpRigid3(np.array([0.5 * i, 0.0, 0.0])),
                      high_resolution_grid=make_tsdf_grid(0.1, (8, 8, 8), 0.3, 1000.0),
                      low_resolution_grid=make_tsdf_grid(0.45, (4, 4, 4), 1.0, 1000.0),
                      rotational_histogram=np.zeros(HIST, np.float32), num_range_data=1) for i in range(3)]
    port_subs = {id(sub): convert.submap_3d(sub, CPU) for sub in subs}
    truth = lambda tid, t: np.array([0.6 * t, 0.1 * tid, 0.02 * t])
    yaw_q = lambda t: nq.quat_from_axis_angle(np.array([0.0, 0.0, 0.2 * t]))
    for graph, rigid in ((jpg, NpRigid3), (pg, TNpRigid3)):
        graph.register_trajectory(1)
        for tid in (0, 1):
            noise = np.random.default_rng(tid)
            for t in np.round(np.arange(0.0, 1.2, 0.01), 6):
                graph.add_imu_data(tid, t, nq.quat_rotate(nq.quat_conjugate(yaw_q(t)), [0.0, 0.0, 9.80665]),
                                   np.array([0.0, 0.0, 0.2]))
                if round(t * 100) % 5 == 0:
                    graph.add_odometry_data(tid, t, rigid(truth(tid, t) + noise.normal(0, 0.003, 3), yaw_q(t)))
        for t in (0.2, 0.5, 0.8):
            graph.add_fixed_frame_pose_data(0, t, rigid(truth(0, t), yaw_q(t)))
        for t, name in ((0.3, "a"), (0.6, "a"), (0.7, "b")):
            graph.add_landmark_data(0, t, name, rigid(np.array([1.0, 0.5, 0.2]) - truth(0, t), nq.quat_identity()),
                                    10.0, 1.0)
    for i, t in enumerate(np.round(np.arange(0.1, 1.1, 0.1), 6)):
        for tid, sub in ((0, subs[min(i // 4, 1)]), (1, subs[2])):
            if tid == 1 and i % 3:
                continue
            local = NpRigid3(truth(tid, t) + rng.normal(0, 0.02, 3), nq.quat_multiply(
                yaw_q(t), nq.quat_from_axis_angle(rng.normal(0, 0.01, 3))))
            jpg.add_node(PgNode(time=float(t), local_pose=local, global_pose=NpRigid3.identity(), trajectory_id=tid),
                         [sub])
            pg.add_node(TPgNode(time=float(t), local_pose=TNpRigid3(local.t, local.q), global_pose=TNpRigid3(),
                                trajectory_id=tid), [port_subs[id(sub)]])
    jpg.run_final_optimization()
    pg.run_final_optimization()
    _assert_same_graph(pg, jpg)
    want, got = jpg.landmark_poses(), pg.landmark_poses()
    assert sorted(got) == sorted(want) == ["a", "b"]
    for name in want:
        _assert_pose_close(got[name], want[name])
    jpg.delete_trajectory(1)
    pg.delete_trajectory(1)
    assert pg.trajectory_states()[1].name == "DELETED"
    _assert_same_graph(pg, jpg)
    assert all(n.trajectory_id == 0 for n in pg.nodes) and len(pg.submaps) == 2


def test_pose_graph_refuses_unported_paths():
    opts = tcfg.PoseGraphOptions(async_work_queue=False)
    assert opts.use_batched_constraint_search  # the JAX default, which the port runs
    pg = PoseGraph3D(tcfg.PoseGraphOptions(), device="cpu")  # the default options construct
    pg.wait_for_all_computations()
    pg = PoseGraph3D(opts, device="cpu")
    assert pg.batched_fallbacks == 0
    with pytest.raises(NotImplementedError):
        pg.set_solver_mesh(object())
    # The 2D pipeline takes TSDF grids and uint16 / half storage (ROADMAP
    # A5b, done); half probability grids raise the JAX package's ValueError.
    for override in ({"trajectory_builder_2d.submaps.grid_options_2d.grid_type": "TSDF"},
                     {"trajectory_builder_2d.submaps.grid_storage_dtype": "uint16"},
                     {"trajectory_builder_2d.submaps.grid_options_2d.grid_type": "TSDF",
                      "trajectory_builder_2d.submaps.grid_storage_dtype": "bfloat16"}):
        mb = MapBuilder(tcfg.replace_deep(tcfg.MapBuilderOptions(use_trajectory_builder_2d=True),
                                          {"pose_graph.async_work_queue": False, **override}), device="cpu")
        mb.add_trajectory_builder()
    mb = MapBuilder(tcfg.replace_deep(tcfg.MapBuilderOptions(use_trajectory_builder_2d=True), {
        "pose_graph.async_work_queue": False, "trajectory_builder_2d.submaps.grid_storage_dtype": "float16"}),
        device="cpu")
    with pytest.raises(ValueError, match="only supported for TSDF"):
        mb.add_trajectory_builder()


def test_normalize_angle_difference():
    from hectorgrapher_tpu.common.math import normalize_angle_difference as jax_normalize

    a = np.array([-7.0, -np.pi, -3.0, 0.0, 3.0, np.pi, 4.0, 10.0], np.float32)
    got = normalize_angle_difference(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_normalize(a)), rtol=0, atol=1e-6)
    assert np.all(got > -np.pi) and np.all(got <= np.pi + 1e-6)


_JAX_FREE_SLAM = """
import sys
import numpy as np
import torch
from hectorgrapher_tpu_torch.common import config as cfg
from hectorgrapher_tpu_torch.evaluation.scan_generator import raycast_box_room_3d
from hectorgrapher_tpu_torch.mapping.map_builder import MapBuilder
from hectorgrapher_tpu_torch.sensor.types import TimedPointCloudData, pad_timed_cloud
from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3

torch.set_num_threads(1)
ct = "trajectory_builder_3d.optimizing_local_trajectory_builder."
opts = cfg.replace_deep(cfg.MapBuilderOptions(), {
    "use_trajectory_builder_3d": True, "trajectory_builder_3d.min_range": 0.4,
    "trajectory_builder_3d.submaps.grid_type": "TSDF", "trajectory_builder_3d.submaps.high_grid_size": 48,
    "trajectory_builder_3d.submaps.low_grid_size": 16, "trajectory_builder_3d.submaps.num_range_data": 2,
    "trajectory_builder_3d.motion_filter.max_time_seconds": 0.05, ct + "initialization_duration": 0.45,
    ct + "max_control_points": 12, ct + "max_clouds_in_window": 12, ct + "points_per_cloud": 64,
    ct + "max_num_iterations": 2, "pose_graph.async_work_queue": True,
    "pose_graph.use_batched_constraint_search": False, "pose_graph.optimize_every_n_nodes": 3,
    "pose_graph.constraint_builder.sampling_ratio": 1.0})
mb = MapBuilder(opts, device="cpu")
tb = mb.get_trajectory_builder(mb.add_trajectory_builder())
for i in range(201):
    t = 0.01 * i
    x = np.array([0.2 * max(0.0, t - 0.6), 0.0, 0.0])
    tb.add_imu_data(t, np.array([0.0, 0.0, 9.80665]), np.zeros(3))
    if i % 5 == 0:
        tb.add_odometry_data(t, NpRigid3(x))
    if i % 10 == 5:
        pts = raycast_box_room_3d(x, np.array([1.0, 0, 0, 0]), num_azimuth=64, num_elevation=16)
        pts = pts[~np.isnan(pts[:, 0])]
        tb.add_range_data(TimedPointCloudData(t, np.zeros(3, np.float32),
                                              pad_timed_cloud(pts, np.zeros(len(pts), np.float32), 1024)))
pg = mb.pose_graph
pg.run_final_optimization()
assert len(pg.nodes) >= 4 and any(s.finished for s in pg.submaps) and pg.num_optimizations >= 2
assert all(np.all(np.isfinite(n.global_pose.t)) for n in pg.nodes)
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.") or m == "hectorgrapher_tpu" or m.startswith("hectorgrapher_tpu."))
print("LEAKED", leaked)
"""


def test_map_builder_3d_runs_without_jax():
    """MapBuilder 3D with the async work queue, at tiny sizes, in a process
    that never imports JAX or the JAX package."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _JAX_FREE_SLAM], cwd=Path(__file__).resolve().parent.parent,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "LEAKED []" in proc.stdout, proc.stdout
