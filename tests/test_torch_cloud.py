"""The port's serving path on the CPU over real loopback gRPC
(hectorgrapher_tpu_torch.cloud: server, client, uploader, wire,
local_slam_result), as tests/test_cloud.py holds the JAX package's: SLAM
through the RPC stack, state write and load through RPC, streaming local
SLAM results, the query and lifecycle RPCs, malformed payloads against
every handler, the wire's caps and whitelist, 2D uplink federation; and
the port's server against the JAX server on the same items.

Options are tests/test_cloud.py's small 2D ones (512^2 submaps of 8
scans, manual optimization). The wire whitelists numpy and the port's own
value types only, so every request here is numpy (the port's
TimedPointCloudData holds numpy leaves).
"""

import pickle
import threading
import time

import grpc
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hectorgrapher_tpu.cloud.client import MapBuilderStub as JMapBuilderStub
from hectorgrapher_tpu.cloud.server import MapBuilderServer as JMapBuilderServer
from hectorgrapher_tpu.common.config import MapBuilderOptions, replace_deep
from hectorgrapher_tpu.mapping.map_builder import MapBuilder as JMapBuilder
from hectorgrapher_tpu.sensor import types as jtypes
from hectorgrapher_tpu.transform.np_quat import NpRigid3 as JNpRigid3
from hectorgrapher_tpu_torch import convert
from hectorgrapher_tpu_torch.cloud import wire
from hectorgrapher_tpu_torch.cloud.client import MapBuilderStub
from hectorgrapher_tpu_torch.cloud.local_slam_result import _unpack_grid
from hectorgrapher_tpu_torch.cloud.server import SERVICE, MapBuilderServer
from hectorgrapher_tpu_torch.evaluation.scan_generator import raycast_rect_room_2d
from hectorgrapher_tpu_torch.mapping.map_builder import MapBuilder, UplinkTrajectoryBuilder
from hectorgrapher_tpu_torch.ops import _build
from hectorgrapher_tpu_torch.sensor.types import TimedPointCloud, TimedPointCloudData, pad_timed_cloud
from hectorgrapher_tpu_torch.transform import np_quat as nq
from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3

CPU = torch.device("cpu")


def jax_options():
    """tests/test_cloud.py's server options."""
    return replace_deep(MapBuilderOptions(), {
        "use_trajectory_builder_2d": True,
        "trajectory_builder_2d.use_imu_data": False,
        "trajectory_builder_2d.use_online_correlative_scan_matching": True,
        "trajectory_builder_2d.submaps.grid_size": 512,
        "trajectory_builder_2d.submaps.num_range_data": 8,
        "trajectory_builder_2d.max_num_points": 2048,
        "trajectory_builder_2d.motion_filter.max_distance_meters": 0.05,
        "trajectory_builder_2d.motion_filter.max_time_seconds": 0.1,
        "pose_graph.optimize_every_n_nodes": 0,
    })


def make_server(**kw):
    srv = MapBuilderServer(MapBuilder(convert.options(jax_options()), device=CPU), "127.0.0.1:0", **kw)
    srv.start()
    return srv


def scan_points(x):
    pts = raycast_rect_room_2d(np.array([x, 0.0]), 0.0, num_rays=720)
    return pts[~np.isnan(pts[:, 0])].astype(np.float32)


def drive(tb, n, step=0.08):
    """test_cloud.py's drive through a trajectory builder stub: odometry
    and a 720-ray scan at 10 Hz along +x."""
    for i in range(n):
        t, x = 0.1 * i, step * i
        tb.add_odometry_data(t, NpRigid3(np.array([x, 0.0, 0.0]), nq.quat_identity()))
        pts = scan_points(x)
        tb.add_range_data(TimedPointCloudData(time=t, origin=np.zeros(3, np.float32),
                                              ranges=pad_timed_cloud(pts, np.zeros(len(pts), np.float32), 1024)))


@pytest.fixture
def server():
    srv = make_server()
    yield srv
    srv.shutdown()


@pytest.fixture(scope="module")
def served():
    """A port server with one trajectory driven 8 scans through the RPC
    stack, and the JAX server's node poses over the same items."""
    srv = make_server()
    stub = MapBuilderStub(f"127.0.0.1:{srv.port}")
    tid = stub.add_trajectory_builder()
    drive(stub.get_trajectory_builder(tid), 8)
    srv.wait_until_idle()
    port_poses = stub.pose_graph.get_trajectory_node_poses()

    jsrv = JMapBuilderServer(JMapBuilder(jax_options()), "127.0.0.1:0")
    jsrv.start()
    jstub = JMapBuilderStub(f"127.0.0.1:{jsrv.port}")
    jtb = jstub.get_trajectory_builder(jstub.add_trajectory_builder())
    for i in range(8):
        t, x = 0.1 * i, 0.08 * i
        jtb.add_odometry_data(t, JNpRigid3(np.array([x, 0.0, 0.0])))
        pts = scan_points(x)
        jtb.add_range_data(jtypes.TimedPointCloudData(
            time=jnp.asarray(t), origin=jnp.zeros(3, jnp.float32),
            ranges=jtypes.pad_timed_cloud(pts, np.zeros(len(pts), np.float32), 1024)))
    jsrv.wait_until_idle()
    jax_poses = jstub.pose_graph.get_trajectory_node_poses()
    jstub.close()
    jsrv.shutdown()
    yield dict(server=srv, stub=stub, tid=tid, port_poses=port_poses, jax_poses=jax_poses)
    stub.close()
    srv.shutdown()


def test_server_node_poses_match_jax(served):
    """The same items through the port's server and the JAX server: equal
    node times, poses within tests/test_torch_pose_graph_2d.py's MapBuilder
    tolerance (5e-3 m and rad: a flipped correlative cell, ROADMAP C0)."""
    got, want = served["port_poses"], served["jax_poses"]
    assert len(got) == len(want) >= 6
    for g, w in zip(got, want):
        assert g["time"] == pytest.approx(float(w["time"]), abs=1e-9)
        np.testing.assert_allclose(g["translation"], w["translation"], rtol=0, atol=5e-3)
        assert nq.quat_angle(nq.quat_multiply(nq.quat_conjugate(np.asarray(w["rotation"])), g["rotation"])) < 5e-3


def test_slam_through_rpc_stack(served):
    stub, tid = served["stub"], served["tid"]
    poses = stub.pose_graph.get_trajectory_node_poses()
    assert len(poses) >= 6
    final = poses[-1]
    assert abs(final["translation"][0] - 0.08 * round(final["time"] / 0.1)) < 0.1
    assert len(stub.get_local_slam_results(tid)) >= 6
    assert any(c["tag"] == "INTRA" for c in stub.pose_graph.get_constraints())
    assert np.isfinite(stub.pose_graph.local_to_global(tid).t).all()


def _assert_same_graph_bits(pg, loaded):
    """Nodes, constraints and submaps equal; every grid bit-equal to the
    served one rounded through the file's float16 planes."""
    assert len(loaded.nodes) == len(pg.nodes) and len(loaded.submaps) == len(pg.submaps)
    for a, b in zip(pg.nodes, loaded.nodes):
        assert a.time == b.time
        np.testing.assert_array_equal(a.local_pose.t, b.local_pose.t)
        np.testing.assert_array_equal(a.global_pose.q, b.global_pose.q)
        torch.testing.assert_close(a.cloud.positions, b.cloud.positions, rtol=0, atol=0)
    assert [(c.submap_index, c.node_index, c.tag) for c in pg.constraints] == [
        (c.submap_index, c.node_index, c.tag) for c in loaded.constraints]
    for a, b in zip(pg.constraints, loaded.constraints):
        np.testing.assert_array_equal(a.zbar.t, b.zbar.t)
    for a, b in zip(pg.submaps, loaded.submaps):
        ga, gb = a.submap.grid, b.submap.grid
        assert torch.equal(ga.log_odds.to(torch.float16).to(torch.float32), gb.log_odds)
        assert torch.equal(ga.known, gb.known)


def test_state_write_load_through_rpc(served, tmp_path):
    """WriteState on the served graph, LoadState into a second server's
    fresh MapBuilder, both through RPC."""
    srv, stub = served["server"], served["stub"]
    path = str(tmp_path / "server_state.npz")
    stub.write_state(path)
    other = make_server()
    try:
        stub2 = MapBuilderStub(f"127.0.0.1:{other.port}")
        remap = stub2.load_state(path, load_frozen_state=True)
        assert stub2.pose_graph.is_trajectory_frozen(remap[served["tid"]])
        _assert_same_graph_bits(srv.map_builder.pose_graph, other.map_builder.pose_graph)
        stub2.close()
    finally:
        other.shutdown()


def test_get_submap_decodes_to_the_grid(served):
    """GetSubmap's payload decodes through _unpack_grid to the served grid
    rounded through float16, its known mask bit-equal."""
    srv, stub = served["server"], served["stub"]
    sub = stub.get_submap(0)
    assert sub["trajectory_id"] == served["tid"] and sub["grid"]["type"] == "probability"
    grid = _unpack_grid(sub["grid"], CPU)
    want = srv.map_builder.pose_graph.submaps[0].submap.grid
    assert torch.equal(grid.log_odds, want.log_odds.to(torch.float16).to(torch.float32))
    assert torch.equal(grid.known, want.known)
    torch.testing.assert_close(grid.meta.min_corner, want.meta.min_corner, rtol=0, atol=0)
    assert stub.get_submap(999).get("error")


def test_get_submap_beyond_grpc_default_message_limit(server):
    """A GetSubmap payload above gRPC's default 4 MB receive limit (a
    1500^2 grid: 6.75 MB; a full-size 3D submap's is 72 MB) reaches the
    client: both ends allow wire.MAX_WIRE_BYTES (ROADMAP C24)."""
    from hectorgrapher_tpu_torch.mapping.grids import make_probability_grid
    from hectorgrapher_tpu_torch.mapping.pose_graph.pose_graph import PgNode
    from hectorgrapher_tpu_torch.mapping.submap_2d import Submap2D
    from hectorgrapher_tpu_torch.sensor.types import pad_cloud

    grid = make_probability_grid(0.05, (1500, 1500), CPU)
    grid = grid._replace(log_odds=torch.linspace(-2, 2, 1500 * 1500).reshape(1500, 1500),
                         known=torch.ones(1500, 1500, dtype=torch.bool))
    pg = server.map_builder.pose_graph
    pg.add_node(PgNode(time=0.0, local_pose=NpRigid3(), global_pose=NpRigid3(), trajectory_id=0,
                       cloud=pad_cloud(np.zeros((4, 3), np.float32), 8, CPU)), [Submap2D(NpRigid3(), grid)])
    pg.wait_for_all_computations()
    stub = MapBuilderStub(f"127.0.0.1:{server.port}")
    sub = stub.get_submap(0)
    assert sub["grid"]["log_odds"].nbytes + sub["grid"]["known"].nbytes > 4 * 1024 * 1024
    assert torch.equal(_unpack_grid(sub["grid"], CPU).log_odds, grid.log_odds.to(torch.float16).to(torch.float32))
    stub.close()


def test_streaming_local_slam_results(server):
    """The server-streaming subscription delivers results live and ends on
    FinishTrajectory."""
    stub = MapBuilderStub(f"127.0.0.1:{server.port}")
    tid = stub.add_trajectory_builder()
    received, done = [], threading.Event()

    def consume():
        for msg in stub.receive_local_slam_results(tid):
            received.append(msg)
        done.set()

    threading.Thread(target=consume, daemon=True).start()
    drive(stub.get_trajectory_builder(tid), 5)
    server.wait_until_idle()
    stub.finish_trajectory(tid)
    assert done.wait(timeout=10.0), "stream did not end after FinishTrajectory"
    assert len(received) >= 1
    times = [float(m["time"]) for m in received]
    assert times == sorted(times)
    assert all(isinstance(m["local_pose"], NpRigid3) for m in received)
    stub.close()


def test_query_and_lifecycle_rpcs(server):
    """GetAllSubmapPoses, GetTrajectoryStates, landmarks, IsTrajectory*,
    ReceiveGlobalSlamOptimizations, FinishTrajectory, DeleteTrajectory."""
    stub = MapBuilderStub(f"127.0.0.1:{server.port}")
    tid = stub.add_trajectory_builder()
    drive(stub.get_trajectory_builder(tid), 6, step=0.06)
    server.wait_until_idle()
    assert len(stub.pose_graph.get_all_submap_poses()) >= 1
    assert stub.pose_graph.trajectory_states()[tid] == "ACTIVE"
    assert not stub.pose_graph.is_trajectory_finished(tid)
    assert not stub.pose_graph.is_trajectory_frozen(tid)

    stub.pose_graph.set_landmark_pose("door_1", NpRigid3(np.array([1.0, 2.0, 0.0])))
    poses = stub.pose_graph.landmark_poses()
    np.testing.assert_allclose(poses["door_1"].t[:2], [1.0, 2.0])

    stream = stub.receive_global_slam_optimizations()
    got = []

    def reader():
        for msg in stream:
            got.append(msg)
            break

    th = threading.Thread(target=reader, daemon=True)
    th.start()
    time.sleep(0.2)
    stub.pose_graph.run_final_optimization()
    th.join(timeout=10.0)
    assert not th.is_alive() and got and got[0]["num_optimizations"] >= 1
    stream.cancel()

    stub.finish_trajectory(tid)
    assert stub.pose_graph.is_trajectory_finished(tid)
    stub.delete_trajectory(tid)
    assert stub.pose_graph.trajectory_states()[tid] == "DELETED"
    assert stub.pose_graph.get_all_submap_poses() == []
    stub.close()


def test_uplink_federation(tmp_path):
    """A serving server uploads its local SLAM results to an uplink server,
    which injects them past local SLAM (test_cloud.py:165-169): the
    uplink's nodes are the serving server's, local poses within 1e-9,
    global poses within 1e-6, finished submaps' grids the served ones
    rounded through the payload's float16."""
    uplink = make_server()
    serving = make_server(uplink_address=f"127.0.0.1:{uplink.port}")
    try:
        stub = MapBuilderStub(f"127.0.0.1:{serving.port}")
        drive(stub.get_trajectory_builder(stub.add_trajectory_builder()), 18)
        serving.wait_until_idle()
        serving.uploader.wait_until_idle()
        time.sleep(1.0)
        uplink.wait_until_idle()
        assert serving.uploader.num_batches_uploaded >= 1

        up_builder = uplink.map_builder.get_trajectory_builder(0)
        assert isinstance(up_builder, UplinkTrajectoryBuilder)
        assert up_builder.num_results_injected >= 6
        s_nodes, u_nodes = serving.map_builder.pose_graph.nodes, uplink.map_builder.pose_graph.nodes
        assert len(u_nodes) == len(s_nodes) >= 6
        for sn, un in zip(s_nodes, u_nodes):
            assert sn.time == un.time
            np.testing.assert_allclose(un.local_pose.t, sn.local_pose.t, atol=1e-9)
            np.testing.assert_allclose(un.local_pose.q, sn.local_pose.q, atol=1e-9)
            np.testing.assert_allclose(un.global_pose.t, sn.global_pose.t, atol=1e-6)
            assert torch.equal(un.cloud.positions, sn.cloud.positions)
        s_submaps, u_submaps = serving.map_builder.pose_graph.submaps, uplink.map_builder.pose_graph.submaps
        assert len(u_submaps) == len(s_submaps) and any(s.finished for s in s_submaps)
        for ss, us in zip(s_submaps, u_submaps):
            np.testing.assert_allclose(us.submap.local_pose.t, ss.submap.local_pose.t, atol=1e-9)
            if ss.finished:
                assert torch.equal(us.submap.grid.known, ss.submap.grid.known)
                assert torch.equal(us.submap.grid.log_odds,
                                   ss.submap.grid.log_odds.to(torch.float16).to(torch.float32))
        with pytest.raises(ValueError, match="LocalSlamResultPayloads"):
            up_builder.add_range_data(None)
        stub.close()
    finally:
        serving.shutdown()
        uplink.shutdown()


def test_server_without_a_card_raises(monkeypatch):
    """A server on the default device finds no card and raises; nothing
    falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="need a CUDA card"):
        MapBuilderServer(MapBuilder(convert.options(jax_options())))


def test_wire_refuses_code_execution_and_tensors():
    """The deserializer refuses anything outside its whitelist: the
    __reduce__ -> os.system exploit, and a pickled torch.Tensor (rebuilt
    through torch._utils), alone or nested; the port's payloads pass."""

    class Evil:
        def __reduce__(self):
            import os

            return (os.system, ("true",))

    for bad in (Evil(), {"payload": [Evil()]}, torch.zeros(3), {"payload": (1, torch.ones(2, 2))}):
        with pytest.raises(wire.WirePayloadError):
            wire.loads(pickle.dumps(bad))
    payload = {
        "trajectory_id": 3,
        "kind": "range",
        "payload": TimedPointCloudData(time=0.5, origin=np.zeros(3, np.float32), ranges=TimedPointCloud(
            np.zeros((4, 3), np.float32), np.zeros(4, np.float32), np.ones(4, bool)), width=0),
        "pose": NpRigid3(np.zeros(3)),
    }
    out = wire.loads(wire.dumps(payload))
    assert out["trajectory_id"] == 3 and out["payload"].ranges.positions.shape == (4, 3)
    np.testing.assert_array_equal(out["pose"].q, nq.quat_identity())


class TestWireHardening:
    """Malformed payloads against the whole RPC surface: every handler
    rejects hostile bytes with an RPC error, never crashes the server or
    runs code, and the server keeps serving."""

    def _payloads(self):
        class Exploit:
            def __reduce__(self):
                import os

                return (os.system, ("echo pwned",))

        deep = cursor = [1]
        for _ in range(200):
            nxt = [1]
            cursor.append(nxt)
            cursor = nxt
        return {
            "random_bytes": b"\x99\xf3garbage-not-a-pickle\x00\x01",
            "truncated_pickle": pickle.dumps({"a": 1})[:-3],
            "forbidden_type": pickle.dumps(Exploit()),
            "pickled_tensor": pickle.dumps(torch.zeros(2)),
            "nesting_bomb": pickle.dumps(deep),
            "wrong_schema": pickle.dumps(12345),
            "empty": b"",
        }

    def test_every_handler_survives_malformed_payloads(self, server):
        channel = grpc.insecure_channel(f"127.0.0.1:{server.port}")
        identity = lambda b: b
        failures = []
        for name in server.method_names:
            streaming = name.startswith("Receive")
            make = channel.unary_stream if streaming else channel.unary_unary
            call = make(f"/{SERVICE}/{name}", request_serializer=identity, response_deserializer=identity,
                        _registered_method=False)
            for kind, payload in self._payloads().items():
                try:
                    result = call(payload, timeout=10)
                    if streaming:
                        list(result)
                except grpc.RpcError:
                    pass  # a decode or handler rejection
                except Exception as e:  # noqa: BLE001
                    failures.append((name, kind, repr(e)))
        channel.close()
        assert not failures, failures
        stub = MapBuilderStub(f"127.0.0.1:{server.port}")
        assert isinstance(stub.add_trajectory_builder(), int)
        stub.close()

    def test_wire_caps(self):
        with pytest.raises(wire.WirePayloadError):
            wire.loads(b"x" * (wire.MAX_WIRE_BYTES + 1))
        deep = cursor = [1]
        for _ in range(wire.MAX_DEPTH + 10):
            nxt = [1]
            cursor.append(nxt)
            cursor = nxt
        with pytest.raises(wire.WirePayloadError):
            wire.loads(pickle.dumps(deep))
        out = wire.loads(wire.dumps({"a": np.arange(10)}))
        np.testing.assert_array_equal(out["a"], np.arange(10))
