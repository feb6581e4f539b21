"""The port's multi-process solver plane, hermetically: two real processes
on localhost, each with 4 cpu shards, joined in one gloo group
(parallel/multihost.py initialize_process), as tests/test_multihost.py
holds the JAX package's with two jax.distributed processes. The parts
mirror its own:

  1. the sharded SPA 2D over the 8-shard global mesh against one
     process's local solve (bit-equal: the gather puts every shard's
     blocks back in constraint order; one gather per LM evaluation);
  2. the sharded 3D round over the global mesh against a mesh of one
     process's 4 shards (bit-equal scores and poses);
  3. a PoseGraph3D driven by process 0 through the leader / follower
     solver plane (cloud/solver_plane.py): its sharded SPA solve, then
     batched 3D rounds (cs3d_pack, cs3d, spa3d ops), each result equal to
     the same graph without a mesh; process 1 runs the follower. Without
     the broadcast hook, set_solver_mesh refuses the 2-process mesh.

Every child and every collective has a timeout of its own, so a hang fails
the test. Small sizes keep the file within ~10 s.
"""

import os
import socket
import subprocess
import sys

_WORKER = r"""
import os, sys
import numpy as np
import torch

rank, coord, follower_port = int(sys.argv[1]), sys.argv[2], int(sys.argv[3])
sys.path.insert(0, os.getcwd())
torch.set_num_threads(1)

from hectorgrapher_tpu_torch.parallel import multihost

multihost.initialize_process(coord, 2, rank, device="cpu", timeout_s=120.0)
assert multihost.process_count() == 2 and multihost.local_device_slice(8) == slice(4 * rank, 4 * rank + 4)
try:
    multihost.local_device_slice(7)
    raise AssertionError("an odd batch divided")
except ValueError:
    pass
CPU = torch.device("cpu")
mesh = multihost.global_mesh(devices=[CPU] * 4)
assert mesh.size == 8 and mesh.spans_processes and list(mesh.local_shards) == list(range(4 * rank, 4 * rank + 4))

# ---- 1. the sharded SPA 2D --------------------------------------------------
from hectorgrapher_tpu_torch.evaluation.graph_generator import make_scale_spa_problem_2d
from hectorgrapher_tpu_torch.mapping.pose_graph import optimization as topt
from hectorgrapher_tpu_torch.parallel.sharded import solve_spa_2d_sharded

problem, _, _ = make_scale_spa_problem_2d(60, 6, 203, noise=0.3, seed=1, device=CPU)
got = solve_spa_2d_sharded(problem, mesh, num_iterations=15)
assert mesh.collectives == topt.LAST_SOLVE_STATS["lm_iterations"] + 1, mesh.collectives
want = topt.solve_spa_2d(problem, num_iterations=15)
assert all(torch.equal(a, b) for a, b in zip(got, want))
print(f"proc {rank} SPA2D OK gathers={mesh.collectives}", flush=True)

# ---- 2. the sharded 3D round -------------------------------------------------
from hectorgrapher_tpu_torch.common.config import FastCorrelativeScanMatcherOptions3D, TSDFRangeDataInserterOptions3D
from hectorgrapher_tpu_torch.evaluation.scan_generator import raycast_box_room_3d
from hectorgrapher_tpu_torch.mapping.grids import make_tsdf_grid
from hectorgrapher_tpu_torch.mapping.inserters_3d import make_tsdf_inserter_3d
from hectorgrapher_tpu_torch.mapping.scan_matching.fast_correlative_3d import (
    FastCorrelativeScanMatcher3D, make_fast_search_3d_config)
from hectorgrapher_tpu_torch.mapping.scan_matching.rotational_histogram import compute_histogram
from hectorgrapher_tpu_torch.parallel.constraint_search import sharded_fast_matches_3d
from hectorgrapher_tpu_torch.parallel.mesh import Mesh
from hectorgrapher_tpu_torch.sensor.types import RangeData, pad_cloud
from hectorgrapher_tpu_torch.sensor.voxel_filter import compact_cloud, voxel_filter
from hectorgrapher_tpu_torch.transform import np_quat as nq
from hectorgrapher_tpu_torch.transform.rigid import Rigid3

HIST = 64
ins_opts = TSDFRangeDataInserterOptions3D(normal_computation_method="NONE", min_range=0.4, max_range=30.0)
ins_hi, ins_lo = make_tsdf_inserter_3d(ins_opts, 0.2), make_tsdf_inserter_3d(ins_opts, 0.6)


def room(shift):
    # One scan of the room from (shift, 0, 0) into a 32 x 32 x 16 / 12 x 12 x 8 pair.
    hi = make_tsdf_grid(0.2, (32, 32, 16), 0.6, 1000.0, CPU)
    lo = make_tsdf_grid(0.6, (12, 12, 8), 1.2, 1000.0, CPU)
    origin = np.array([shift, 0.0, 0.0])
    pts = raycast_box_room_3d(origin, nq.quat_identity(), half_extents=(2.0, 1.8, 1.0), num_azimuth=64,
                              num_elevation=12)
    pts = (pts[~np.isnan(pts[:, 0])] + origin).astype(np.float32)
    rd = RangeData(origin=torch.tensor(origin, dtype=torch.float32), returns=pad_cloud(pts, 1024, CPU),
                   misses=pad_cloud(np.zeros((0, 3), np.float32), 4, CPU))
    full = pad_cloud(pts, 1024, CPU)
    hist = compute_histogram(full.positions, full.mask, HIST).numpy()
    return ins_hi(hi, rd), ins_lo(lo, rd), hist, full


fc = FastCorrelativeScanMatcherOptions3D(linear_xy_search_window=0.6, linear_z_search_window=0.3,
                                         angular_search_window=np.radians(10.0), branch_and_bound_depth=3,
                                         min_rotational_score=0.1, min_low_resolution_score=0.1)
scenes = [room(s) for s in (0.0, 0.15, 0.3, -0.15, -0.3)]
matchers = [FastCorrelativeScanMatcher3D(fc, hi, lo, hist, HIST) for hi, lo, hist, _ in scenes]
full = scenes[0][3]
high, low = compact_cloud(voxel_filter(full, 0.3), 128), compact_cloud(voxel_filter(full, 0.6), 64)
shist = compute_histogram(high.positions, high.mask, HIST).numpy()
init = Rigid3(np.array([0.1, -0.05, 0.0], np.float32), np.array([1, 0, 0, 0], np.float32))
config = make_fast_search_3d_config(fc, 0.2, 6.0, False, 256)
candidates = [(s, high, low, shist, init, 0.0) for s in (0, 1, 2, 3, 4, 4)]
got = sharded_fast_matches_3d(matchers, candidates, config, mesh)
assert mesh.collectives == topt.LAST_SOLVE_STATS["lm_iterations"] + 2
want = sharded_fast_matches_3d(matchers, candidates, config, Mesh([CPU] * 4))
for (gs, gl, gp), (ws, wl, wp) in zip(got, want):
    assert (gs, gl) == (ws, wl) and torch.equal(gp.translation, wp.translation), (gs, ws)
    assert torch.equal(gp.rotation, wp.rotation)
assert got[0][0] > 0.3, got[0][0]
print(f"proc {rank} FM3D OK score={got[0][0]:.3f}", flush=True)

# ---- 3. a pose graph through the solver plane ---------------------------------
import hectorgrapher_tpu_torch.mapping.pose_graph.pose_graph as pg_mod
from hectorgrapher_tpu_torch.common.config import MapBuilderOptions, replace_deep
from hectorgrapher_tpu_torch.mapping.pose_graph.pose_graph import Constraint, PgNode, PgSubmap, PoseGraph3D
from hectorgrapher_tpu_torch.mapping.submap_3d import Submap3D
from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3

if rank == 1:
    from hectorgrapher_tpu_torch.cloud.solver_plane import SolverPlaneFollower

    follower = SolverPlaneFollower(f"127.0.0.1:{follower_port}", mesh=mesh).start()
    assert follower.wait_for_shutdown(timeout=150), "no shutdown from the leader"
    print("proc 1 FOLLOWER OK " + " ".join(follower.executed), flush=True)
    sys.exit(0)

import json
import time

from hectorgrapher_tpu_torch.cloud.solver_plane import SolverPlaneLeader

leader = SolverPlaneLeader([f"127.0.0.1:{follower_port}"], collect_stats=True)
try:  # a mesh that spans processes needs the broadcast hook
    PoseGraph3D(replace_deep(MapBuilderOptions(), {"pose_graph.async_work_queue": False}).pose_graph,
                device=CPU).set_solver_mesh(mesh)
    raise AssertionError("a 2-process mesh without a broadcast hook was taken")
except ValueError:
    pass


def spa_graph(use_mesh):
    options = replace_deep(MapBuilderOptions(), {"pose_graph.async_work_queue": False,
                                                 "pose_graph.optimize_every_n_nodes": 0}).pose_graph
    pg = PoseGraph3D(options, histogram_size=HIST, device=CPU)
    if use_mesh:
        pg.set_solver_mesh(mesh, broadcast=leader)
    submap = Submap3D(local_pose=NpRigid3(np.zeros(3)),
                      high_resolution_grid=make_tsdf_grid(0.1, (8, 8, 8), 0.3, 100.0, CPU),
                      low_resolution_grid=make_tsdf_grid(0.45, (4, 4, 4), 1.0, 100.0, CPU),
                      rotational_histogram=np.zeros(HIST, np.float32), num_range_data=1)
    pg.submaps.append(PgSubmap(submap=submap, global_pose=NpRigid3(np.zeros(3)), submap_id=0))
    pg._submap_ids[id(submap)] = 0
    pg._submap_index_by_id[0] = 0
    rng = np.random.default_rng(7)
    for k in range(4):
        t_true = np.array([0.2 * k, 0.05 * k, 0.0])
        pg.nodes.append(PgNode(time=0.1 * k, local_pose=NpRigid3(t_true),
                               global_pose=NpRigid3(t_true + rng.normal(0, 0.3, 3)), node_id=k))
        pg._node_index_by_id[k] = k
        pg.constraints.append(Constraint(0, k, NpRigid3(t_true), 1e4, 1e4, "INTRA"))
    pg.run_final_optimization(25)
    return [n.global_pose.t for n in pg.nodes]


def round_graph(use_mesh):
    options = replace_deep(MapBuilderOptions(), {
        "pose_graph.async_work_queue": False, "pose_graph.optimize_every_n_nodes": 0,
        "pose_graph.constraint_builder.sampling_ratio": 1.0,
        "pose_graph.constraint_builder.max_constraint_distance": 100.0,
        "pose_graph.constraint_builder.min_score": 0.2,
        "pose_graph.constraint_builder.fast_correlative_scan_matcher_3d": fc}).pose_graph
    pg = PoseGraph3D(options, histogram_size=HIST, max_scan_range=6.0, device=CPU)
    if use_mesh:
        pg.set_solver_mesh(mesh, broadcast=leader)
    for i in range(4):
        hi, lo, hist, _ = scenes[i]
        sm = Submap3D(local_pose=NpRigid3(np.zeros(3)), high_resolution_grid=hi, low_resolution_grid=lo,
                      rotational_histogram=hist, num_range_data=1, insertion_finished=True)
        node = PgNode(time=0.1 * i, local_pose=NpRigid3(np.zeros(3)), global_pose=NpRigid3.identity(),
                      high_cloud=high, low_cloud=low, histogram=shist)
        pg.add_node(node, [sm])
    pg.run_final_optimization()
    return ([(c.submap_index, c.node_index, c.zbar.t.tolist()) for c in pg.constraints if c.tag == "INTER"],
            [n.global_pose.t.tolist() for n in pg.nodes])


t0 = time.perf_counter()
got = spa_graph(True)
pg_mod.set_constraint_search_mesh(None)
want = spa_graph(False)
assert all(np.array_equal(a, b) for a, b in zip(got, want)), (got, want)
truth = [np.array([0.2 * k, 0.05 * k, 0.0]) for k in range(4)]
assert max(np.linalg.norm(g - t) for g, t in zip(got, truth)) < 1e-3
print(f"proc 0 SOLVERPLANE OK", flush=True)

got3 = round_graph(True)
pg_mod.set_constraint_search_mesh(None)
want3 = round_graph(False)
assert got3[0], "no INTER constraint found"
assert got3 == want3, (got3, want3)
summary = {op: {"count": st["count"], "bytes": st["bytes"],
                "ack_ms_max": round(float(np.max(st["ack_ms"])), 1) if st["ack_ms"] else None}
           for op, st in leader.stats.items()}
print("SOLVERPLANE_STATS " + json.dumps(summary), flush=True)
leader.shutdown()
print(f"proc 0 PROD3D OK inter={len(got3[0])} in {time.perf_counter() - t0:.1f} s", flush=True)
"""


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def test_two_process_global_mesh(tmp_path):
    coord_port, follower_port = _free_ports(2)
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if not k.startswith(("XLA_", "JAX_"))}
    procs = [subprocess.Popen([sys.executable, str(worker), str(rank), f"127.0.0.1:{coord_port}",
                               str(follower_port)], cwd=root, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rc, out in outs:
        assert rc == 0, out[-4000:]
    for mark in ("SPA2D OK", "FM3D OK"):
        assert mark in outs[0][1] and mark in outs[1][1]
    assert "SOLVERPLANE OK" in outs[0][1] and "PROD3D OK" in outs[0][1]
    stats = next(line for line in outs[0][1].splitlines() if line.startswith("SOLVERPLANE_STATS "))
    for op in ("spa3d", "cs3d_pack", "cs3d"):
        assert f'"{op}"' in stats, stats
    executed = next(line for line in outs[1][1].splitlines() if line.startswith("proc 1 FOLLOWER OK")).split()[4:]
    assert executed[0] == "spa3d" and {"cs3d_pack", "cs3d", "spa3d"} <= set(executed)
