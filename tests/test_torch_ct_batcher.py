"""Cross-trajectory batched CT window serving in the port
(hectorgrapher_tpu_torch.cloud.ct_batcher on the server's SLAM thread), as
tests/test_ct_batcher.py holds the JAX package's: a three-trajectory
MapBuilderServerCore in batch_ct_windows mode solves the trajectories'
ready windows together, and each trajectory's results match the serial
server's and the JAX package's batch_ct_windows server's on the same
items, per scan and per point. Then the batcher alone: the batch key
sends windows of other grid shapes or types to their own group or to the
serial path, a failed batched solve reaches its workers, fail_pending
wakes blocked workers, and a 2-shard mesh= gives the unsharded results.

Options: tests/test_ct_batcher.py's small ones (48^3 / 24^3 TSDF, K = C
= 8, P = 128, 6 LM iterations, constraint rounds and SPA running beside
the workers) with ct_window_horizon 0.5 s: at the default 0.9 s, eight
control points 0.1 s apart never span the horizon, the window never
slides, and each trajectory gives one result (the JAX test's 1.1 s drive
gives one). 1.6 s of driving gives each trajectory 12 results.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from hectorgrapher_tpu.common.config import replace_deep
from hectorgrapher_tpu_torch import convert
from hectorgrapher_tpu_torch.cloud import ct_batcher as batcher_mod
from hectorgrapher_tpu_torch.cloud.ct_batcher import CtWindowBatcher, _batch_key
from hectorgrapher_tpu_torch.cloud.server import MapBuilderServerCore
from hectorgrapher_tpu_torch.evaluation.scan_generator import raycast_box_room_3d
from hectorgrapher_tpu_torch.mapping.grids import make_probability_grid, make_tsdf_grid
from hectorgrapher_tpu_torch.mapping.map_builder import MapBuilder
from hectorgrapher_tpu_torch.mapping.scan_matching.interpolated_grid import prepare_grid_3d
from hectorgrapher_tpu_torch.parallel.mesh import Mesh
from hectorgrapher_tpu_torch.sensor.types import TimedPointCloudData, pad_timed_cloud
from hectorgrapher_tpu_torch.transform import np_quat as nq
from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3
from test_ct_batcher import make_options as jax_make_options

CPU = torch.device("cpu")
GRAVITY = np.array([0.0, 0.0, 9.80665])
DURATION = 1.6


def jax_options(per_point):
    ct = "trajectory_builder_3d.optimizing_local_trajectory_builder."
    return replace_deep(jax_make_options(), {ct + "ct_window_horizon": 0.5, ct + "use_per_point_unwarping": per_point})


def make_options(per_point):
    return convert.options(jax_options(per_point))


def sensor_items(trajectory_id, duration=DURATION):
    """tests/test_ct_batcher.py's stream of one trajectory in the port's
    types: IMU at 100 Hz, odometry at 20 Hz, 64 x 16-ray box-room scans at
    10 Hz, at rest for 0.5 s, then along +x at 0.2 + 0.05 * id m/s."""
    rng = np.random.default_rng(100 + trajectory_id)
    speed = 0.2 + 0.05 * trajectory_id
    items = []
    t, next_odom, next_scan = 0.0, 0.0, 0.05
    while t <= duration:
        x = speed * max(0.0, t - 0.5)
        q = nq.quat_identity()
        items.append((trajectory_id, "imu", (t, nq.quat_rotate(nq.quat_conjugate(q), GRAVITY), np.zeros(3))))
        if t >= next_odom:
            items.append((trajectory_id, "odometry", (t, NpRigid3(np.array([x, 0, 0]) + rng.normal(0, 0.002, 3), q))))
            next_odom += 0.05
        if t >= next_scan:
            pts = raycast_box_room_3d(np.array([x, 0, 0.0]), q, num_azimuth=64, num_elevation=16, noise_std=0.004,
                                      rng=rng)
            pts = pts[~np.isnan(pts[:, 0])]
            items.append((trajectory_id, "range", TimedPointCloudData(
                time=t, origin=np.zeros(3, np.float32), ranges=pad_timed_cloud(pts, np.zeros(len(pts), np.float32),
                                                                               1024), width=64)))
            next_scan += 0.1
        t = round(t + 0.01, 6)
    return items


def run_server(batch, per_point, n_traj=3, record=None, ct_mesh=None):
    """The items of n_traj trajectories, round-robin on the sensor queue
    (their windows become ready together), through a server; returns the
    server and each trajectory's (time, local pose) results. With `record`,
    the first flushed batch's pending solves are appended to it; ct_mesh
    shards the batched solves."""
    srv = MapBuilderServerCore(MapBuilder(make_options(per_point), device=CPU), batch_ct_windows=batch,
                               ct_mesh=ct_mesh)
    if record is not None:
        flush = srv.ct_batcher._flush

        def recording_flush(batch):
            if not record:
                record.extend(e["pending"] for e in batch)
            flush(batch)

        srv.ct_batcher._flush = recording_flush
    tids = [srv._handle_add_trajectory({})["trajectory_id"] for _ in range(n_traj)]
    for group in zip(*(sensor_items(tid) for tid in tids)):
        for item in group:
            srv._sensor_queue.put(item)
    srv.start()
    try:
        srv.wait_until_idle()
        srv.map_builder.pose_graph.wait_for_all_computations()
        results = {tid: list(srv._local_slam_results.get(tid, [])) for tid in tids}
    finally:
        srv.shutdown()
    return srv, results


def jax_item(item):
    """One of sensor_items' items in the JAX package's types. The scan time
    stays the float64 the port receives: as a float32, 0.45 s falls below
    initialization_duration's 0.45 and the initialization ends a scan
    later."""
    from hectorgrapher_tpu.sensor import types as jtypes
    from hectorgrapher_tpu.transform.np_quat import NpRigid3 as JaxRigid3

    tid, kind, payload = item
    if kind == "odometry":
        return tid, kind, (payload[0], JaxRigid3(payload[1].t, payload[1].q))
    if kind == "range":
        r = payload.ranges
        return tid, kind, jtypes.TimedPointCloudData(
            time=payload.time, origin=payload.origin, width=payload.width,
            ranges=jtypes.TimedPointCloud(positions=r.positions, times=r.times, mask=r.mask))
    return item


def run_jax_server(per_point, n_traj=3):
    """The same items through the JAX package's MapBuilderServer in
    batch_ct_windows mode (as tests/test_ct_batcher.py drives it); each
    trajectory's (time, local pose) results."""
    from hectorgrapher_tpu.cloud.server import MapBuilderServer as JaxServer
    from hectorgrapher_tpu.mapping.map_builder import MapBuilder as JaxMapBuilder

    srv = JaxServer(JaxMapBuilder(jax_options(per_point)), "127.0.0.1:0", batch_ct_windows=True)
    tids = [srv._handle_add_trajectory({})["trajectory_id"] for _ in range(n_traj)]
    for group in zip(*(sensor_items(tid) for tid in tids)):
        for item in group:
            srv._sensor_queue.put(jax_item(item))
    srv.start()
    try:
        srv.wait_until_idle()
        # Drained, so that no pose-graph work runs on at the interpreter's exit.
        srv.map_builder.pose_graph.wait_for_all_computations()
        assert srv.ct_batcher.batched_launches > 0
        return {tid: list(srv._local_slam_results.get(tid, [])) for tid in tids}
    finally:
        srv.shutdown()


@pytest.fixture(scope="module", params=[False, True], ids=["per_scan", "per_point"])
def served(request):
    recorded = []
    batched = run_server(True, request.param, record=recorded)
    serial = run_server(False, request.param)
    return dict(per_point=request.param, batched=batched, serial=serial, pending=recorded,
                jax=run_jax_server(request.param))


def test_batched_server_matches_serial(served):
    """Batched windows, B >= 2, every solve batched; each trajectory gets the
    serial server's result times and poses within 1e-4 m (the JAX test's
    tolerance)."""
    (srv_b, res_b), (srv_s, res_s) = served["batched"], served["serial"]
    assert srv_b.ct_batcher.batched_launches > 0 and srv_b.ct_batcher.serial_solves == 0
    assert max(srv_b.ct_batcher.batch_sizes) >= 2, srv_b.ct_batcher.batch_sizes
    assert srv_s.ct_batcher is None
    assert set(res_b) == set(res_s)
    for tid in res_b:
        assert len(res_b[tid]) == len(res_s[tid]) >= 10, (tid, len(res_b[tid]), len(res_s[tid]))
        for (tb, pb), (ts, ps) in zip(res_b[tid], res_s[tid]):
            assert tb == ts
            np.testing.assert_allclose(pb.t, ps.t, rtol=0, atol=1e-4)
            assert nq.quat_angle(nq.quat_multiply(nq.quat_conjugate(ps.q), pb.q)) < 1e-4
    # Each builder's solves went through the batcher.
    for tid in res_b:
        local = srv_b.map_builder.get_trajectory_builder(tid)._local
        assert local.window_solve_fn == srv_b.ct_batcher._solve and local.num_optimizations > 0


def test_batched_server_matches_jax(served):
    """The port's batched server against the JAX package's batched server
    on the same items: each trajectory the same result times, local poses
    within 1e-3 m and 1e-3 rad (the CT front end's parity tolerance,
    tests/test_torch_ct_builder.py)."""
    _, res_b = served["batched"]
    res_j = served["jax"]
    assert set(res_b) == set(res_j)
    for tid in res_b:
        assert [t for t, _ in res_b[tid]] == [float(t) for t, _ in res_j[tid]], tid
        assert len(res_b[tid]) >= 10
        for (_, pb), (_, pj) in zip(res_b[tid], res_j[tid]):
            assert np.abs(pb.t - np.asarray(pj.t)).max() < 1e-3
            assert nq.quat_angle(nq.quat_multiply(nq.quat_conjugate(np.asarray(pj.q)), pb.q)) < 1e-3


def _other_grid(grid, shape):
    """A TSDF grid of `shape` with grid's metadata."""
    return make_tsdf_grid(float(grid.meta.resolution), shape, float(grid.truncation_distance),
                          float(grid.max_weight), CPU)


def test_batch_key_groups_windows(served, monkeypatch):
    """Windows that share grid type, storage dtype, shapes, problem shapes,
    iterations, weights and mode share a key and one batched solve;
    another grid shape, grid type or weight gets its own key, and a window
    alone takes the serial solver. A batched solve that raises reaches
    every window of its group."""
    p = served["pending"][0]
    assert p.per_point == served["per_point"]
    shape = tuple(p.high_grid.tsd.shape)
    bigger = dataclasses.replace(p, high_grid=_other_grid(p.high_grid, tuple(s + 2 for s in shape)))
    half = dataclasses.replace(p, high_grid=p.high_grid._replace(tsd=p.high_grid.tsd.half(),
                                                                 weight=p.high_grid.weight.half()))
    occupancy = dataclasses.replace(p, high_grid=prepare_grid_3d(make_probability_grid(0.1, shape, CPU)))
    heavier = dataclasses.replace(p, weights=p.weights._replace(
        translation_weight=p.weights.translation_weight + 1.0))
    keys = [_batch_key(w) for w in (p, bigger, half, occupancy, heavier)]
    assert len(set(keys)) == 5
    assert _batch_key(dataclasses.replace(p)) == keys[0]

    calls = []
    monkeypatch.setattr(batcher_mod.window_solver, "solve_ct_window_batched",
                        lambda his, *a, **kw: calls.append(("batched", len(his))) or (
                            batcher_mod._stack([p.state0] * len(his), batcher_mod.CtState), None, None))
    monkeypatch.setattr(batcher_mod.window_solver, "solve_ct_window",
                        lambda *a, **kw: calls.append(("serial", 1)) or (p.state0, None, None))
    b = CtWindowBatcher()
    entries = [{"pending": w, "event": threading.Event(), "solved": None, "error": None}
               for w in (p, bigger, p, half, occupancy)]
    b._flush(entries)
    assert sorted(calls) == [("batched", 2), ("serial", 1), ("serial", 1), ("serial", 1)]
    assert b.batched_launches == 1 and b.batch_sizes == [2] and b.serial_solves == 3
    assert all(e["event"].is_set() and e["error"] is None for e in entries)
    torch.testing.assert_close(entries[0]["solved"].translation, p.state0.translation, rtol=0, atol=0)

    def fail(*a, **kw):
        raise RuntimeError("batched solve failed")

    monkeypatch.setattr(batcher_mod.window_solver, "solve_ct_window_batched", fail)
    entries = [{"pending": p, "event": threading.Event(), "solved": None, "error": None} for _ in range(3)]
    b._flush(entries)
    assert all(e["event"].is_set() and "batched solve failed" in str(e["error"]) for e in entries)


def test_fail_pending_wakes_blocked_workers(served):
    """A worker blocked in a window solve wakes with fail_pending's error and
    finishes; later solves fail at once."""
    p = served["pending"][0]
    b = CtWindowBatcher()
    b.begin(2)
    errors = []

    def worker():
        try:
            b._solve(p)
        except RuntimeError as e:
            errors.append(e)
        finally:
            b.finish()

    threads = [threading.Thread(target=worker, daemon=True) for _ in range(2)]
    for th in threads:
        th.start()
    deadline = time.monotonic() + 10.0
    while b._blocked < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert b._blocked == 2
    b.fail_pending(RuntimeError("ct batcher aborted"))
    for th in threads:
        th.join(timeout=10.0)
        assert not th.is_alive()
    assert len(errors) == 2 and all("aborted" in str(e) for e in errors)
    assert b._active_workers == 0
    with pytest.raises(RuntimeError, match="aborted"):
        b._solve(p)


def test_mesh_raises(served):
    """(The name is kept from when mesh= raised.) A batcher with a 2-shard
    mesh solves the first served batch of three windows padded to four
    lanes, one batched assembly a shard, and each window gets the
    unsharded batched solve's state within 1e-5 (each lane's own LM steps,
    up to the batched linear solve's rounding); a server with ct_mesh on 2
    shards gives the unsharded batched server's result times, and poses
    within 1e-4 (test_batched_server_matches_serial's tolerance)."""
    pending = served["pending"]
    assert len(pending) == 3

    def solve(batcher):
        entries = [{"pending": p, "event": threading.Event(), "solved": None, "error": None} for p in pending]
        batcher._solve_batched(entries)
        return [e["solved"] for e in entries]

    before = batcher_mod.window_solver.solve_ct_window_batched.assemblies
    want = solve(CtWindowBatcher())
    per_solve = batcher_mod.window_solver.solve_ct_window_batched.assemblies - before
    sharded = CtWindowBatcher(mesh=Mesh([CPU, CPU]))
    got = solve(sharded)
    assert batcher_mod.window_solver.solve_ct_window_batched.assemblies - before - per_solve == 2 * per_solve
    assert sharded.batch_sizes == [3]
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)
    srv, res = run_server(True, served["per_point"], ct_mesh=Mesh([CPU, CPU]))
    _, res_b = served["batched"]
    assert srv.ct_batcher._mesh is not None and srv.ct_batcher.batched_launches > 0
    assert set(res) == set(res_b)
    for tid in res:
        assert [t for t, _ in res[tid]] == [t for t, _ in res_b[tid]]
        for (_, p), (_, pb) in zip(res[tid], res_b[tid]):
            np.testing.assert_allclose(p.t, pb.t, rtol=0, atol=1e-4)
            assert nq.quat_angle(nq.quat_multiply(nq.quat_conjugate(pb.q), p.q)) < 1e-4
