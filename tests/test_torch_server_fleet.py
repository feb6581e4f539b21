"""A small fleet on one MapBuilderServerCore with batch_ct_windows (the
port's served CT path, cloud/server.py and cloud/ct_batcher.py), at a
test's size on the CPU: three robots of the benchmark's fleet cell
(hgbench/configs/drz_ct3d_server.json, traffic fleet8), their streams
made by hgbench/gen/stream.py and their items queued round-robin before the
SLAM thread starts, so that every window solve is a batched one.

Held: each batched window's returned state against the float64 LM of
hgbench/reference/ct_window.py from the same start, within the cell's
limits (the benchmark's ct_window check); each trajectory's results on
its own subscription, in its builder's order, none lost or foreign
(hgbench/reference/fleet_results.py); and the server's and batcher's
sections and histogram, one record an event, and each solve's costs left
on its request.
"""

import copy
import json
import sys
import threading
from pathlib import Path

import pytest
import torch

from hectorgrapher_tpu_torch.cloud import ct_batcher as batcher_mod
from hectorgrapher_tpu_torch.cloud.server import MapBuilderServerCore
from hectorgrapher_tpu_torch.common import profiling
from hectorgrapher_tpu_torch.mapping.map_builder import MapBuilder

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "hgbench" / "tests"))

import tiny  # noqa: E402
from hgbench.lib import names  # noqa: E402
from hgbench.lib.session import Session  # noqa: E402
from hgbench.reference import fleet_results  # noqa: E402

CELL = "drz_ct3d_server.fleet8"
ROBOTS = 3
SCANS = 14  # a robot's scans: 0.5 s of initialization, then 9 window solves
SEED = 2147483659


def fleet_module():
    return names.load_module("drivers", "server_fleet")


def batch_windows():
    return fleet_module().batch_windows()


def robot_items(robot):
    """One robot's queue items in time order: its IMU and odometry up to
    each scan's stamp, then the scan."""
    out = []
    for i in range(SCANS):
        t, data = robot.next_scan_data()
        s = robot.stream
        for kind, j in s.samples_until(t, robot.imu_fed, robot.odom_fed):
            if kind == "imu":
                out.append((robot.tid, "imu", (float(s.imu_t[j]), s.imu_acc[j], s.imu_gyro[j])))
                robot.imu_fed = j + 1
            else:
                out.append((robot.tid, "odometry", (float(s.odom_t[j]), robot._pose(s.odom_xyz[j], s.odom_q[j]))))
                robot.odom_fed = j + 1
        robot.next_scan += 1
        out.append((robot.tid, "range", data))
    return out


@pytest.fixture(scope="module")
def served():
    from hgbench.lib.robot import Robot

    session = Session(CELL, SEED, 1.0, False, "cpu",
                      extra_options=tiny.DRZ_CT3D["extra_options"], extra_sensors=tiny.DRZ_CT3D["extra_sensors"],
                      extra_mix={"stream_s": 3.0, "check": {"ct_window_samples": 3}})
    fleet = fleet_module()
    srv = MapBuilderServerCore(MapBuilder(session.options, device=torch.device("cpu")), batch_ct_windows=True)
    batcher = srv.ct_batcher
    streams = fleet.robot_streams(session.config["sensors"], session.mix, SEED, ROBOTS)
    robots = []
    for i, stream in enumerate(streams):
        tid = srv._handle_add_trajectory({})["trajectory_id"]
        robots.append(fleet.ServedRobot(i, tid, srv.map_builder.get_trajectory_builder(tid), stream))
    checks = {type(c).__name__: c for c in session.checks}
    for robot in robots:
        checks["CtWindowCheck"].install(robot)
        checks["FleetResultsCheck"].install(robot)
    fleet.route_solves(session, batcher)
    flushed, drains = [], []
    flush, drain = batcher._flush, srv._drain_batched
    batcher._flush = lambda batch: flushed.append([e["pending"] for e in batch]) or flush(batch)
    srv._drain_batched = lambda item: drains.append(item) or drain(item)
    building = {"now": 0, "most": 0}
    for robot in robots:
        build = robot.local._build_window_solve

        def counted_build(build=build):
            building["now"] += 1
            building["most"] = max(building["most"], building["now"])
            try:
                return build()
            finally:
                building["now"] -= 1

        robot.local._build_window_solve = counted_build

    feeds = []
    for robot in robots:
        feeder = Robot(robot.tb, robot.stream, use_3d=True)
        feeder.tid = robot.tid
        feeds.append(robot_items(feeder))
    received = {r.tid: [] for r in robots}
    done = threading.Event()

    def subscribe(tid):
        for item in srv._handle_receive_local_slam_results({"trajectory_id": tid}, lambda: not done.is_set()):
            pose = item["local_pose"]
            received[tid].append([float(item["time"])] + [float(x) for x in pose.t] + [float(x) for x in pose.q])

    subscribers = [threading.Thread(target=subscribe, args=(r.tid,), daemon=True) for r in robots]
    hist0 = batch_windows()
    items = 0
    with profiling.recording() as rec:
        for t in subscribers:
            t.start()
        checks["CtWindowCheck"].open()
        for group in zip(*feeds):
            for item in group:
                srv._sensor_queue.put(item)
                items += 1
        srv.start()
        try:
            srv.wait_until_idle()
            srv.map_builder.pose_graph.wait_for_all_computations()
        finally:
            checks["CtWindowCheck"].close()
            srv.shutdown()
        while any(len(received[r.tid]) < len(srv._local_slam_results.get(r.tid, [])) for r in robots):
            done.wait(0.05)
        done.set()
        for t in subscribers:
            t.join(5.0)
        assert not any(t.is_alive() for t in subscribers)
    hist1 = batch_windows()
    session.readings["fleet_received"] = received
    numbers = {}
    for c in (checks["CtWindowCheck"], checks["FleetResultsCheck"]):
        numbers.update(c.numbers(False))
    session.unpatch()
    limits = json.loads((names.HGBENCH / "limits" / f"{CELL}.json").read_text())
    return dict(srv=srv, batcher=batcher, robots=robots, rec=rec, items=items, drains=drains, flushed=flushed,
                numbers=numbers, limits=limits, received=received, produced=checks["FleetResultsCheck"].produced,
                sampled=checks["CtWindowCheck"].sample.items, hist=(hist1[0] - hist0[0], hist1[1] - hist0[1]),
                building=building["most"])


def test_every_window_solve_is_batched(served):
    b = served["batcher"]
    solves = sum(r.local.num_optimizations for r in served["robots"])
    assert solves >= ROBOTS * 6 and b.serial_solves == 0
    assert sum(b.batch_sizes) == solves and max(b.batch_sizes) == ROBOTS


@pytest.mark.parametrize("number", ["ct_cost0_rel", "ct_cost_rel", "ct_lm_excess", "ct_pose_gap_m", "ct_pose_gap_rad",
                                    "window_points_foreign"])
def test_batched_windows_match_the_reference(served, number):
    """The sampled batched solves (their costs, their LM against the
    reference's from the same start, the poses written back) within the
    fleet cell's limits."""
    assert len(served["sampled"]) == 3 and any("returned" in rec for rec in served["sampled"])
    assert served["numbers"][number] <= served["limits"][number], served["numbers"]


def test_results_on_their_own_subscription_in_order(served):
    produced, received = served["produced"], served["received"]
    assert set(received) == {r.tid for r in served["robots"]}
    for tid, got in received.items():
        assert len(got) == len(produced[tid]) >= 4
        assert [x[0] for x in got] == sorted(x[0] for x in got)
    assert fleet_results.compare(produced, received) == {"lost": 0, "foreign": 0, "out_of_order": 0}
    assert {k: served["numbers"][f"fleet_results_{k}"] for k in ("lost", "foreign", "out_of_order")} == {
        "lost": 0, "foreign": 0, "out_of_order": 0}


def test_workers_take_turns(served):
    """The robots' workers run their host code one at a time: no two build
    a window at once, and yet every solve was batched (a worker hands its
    turn on while it waits in the batcher)."""
    assert served["building"] == 1 and max(served["batcher"].batch_sizes) == ROBOTS


def test_host_turns_hold_under_contention():
    """More workers than cores, the interpreter switching threads as
    often as it can: no two workers are ever inside their host turn at
    once, and every worker's solves still come back (each waits with its
    turn handed on)."""
    b = batcher_mod.CtWindowBatcher()

    def flush(batch):
        for e in batch:
            e["solved"] = e["pending"]
            e["event"].set()

    b._flush = flush
    workers, solves = 16, 3
    inside, most, done = [0], [0], []
    lock = threading.Lock()

    def host_work():
        with lock:
            inside[0] += 1
            most[0] = max(most[0], inside[0])
        sum(range(2000))
        with lock:
            inside[0] -= 1

    def worker(i):
        try:
            with b.host_turn():
                for j in range(solves):
                    host_work()
                    assert b._solve((i, j)) == (i, j)
                host_work()
            done.append(i)
        finally:
            b.finish()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        b.begin(workers)
        threads = [threading.Thread(target=worker, args=(i,), daemon=True) for i in range(workers)]
        for t in threads:
            t.start()
        b.serve(timeout=30.0)
        for t in threads:
            t.join(30.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert sorted(done) == list(range(workers)) and most[0] == 1


def test_streams_do_not_starve_unary_calls():
    """Each open ReceiveLocalSlamResults stream holds a thread of the
    server's pool for its life; with more streams than num_workers the
    unary calls are still answered."""
    import grpc

    from hectorgrapher_tpu_torch.cloud import wire
    from hectorgrapher_tpu_torch.cloud.server import CHANNEL_OPTIONS, SERVICE, MapBuilderServer
    from hectorgrapher_tpu_torch.common import config as cfg

    srv = MapBuilderServer(MapBuilder(cfg.MapBuilderOptions(), device=torch.device("cpu")), num_workers=1)
    srv.start()
    channel = grpc.insecure_channel(f"127.0.0.1:{srv.port}", options=CHANNEL_OPTIONS)
    unary = lambda method, request: channel.unary_unary(
        f"/{SERVICE}/{method}", request_serializer=wire.dumps, response_deserializer=wire.loads)(request, timeout=20)
    try:
        tids = [unary("AddTrajectory", {})["trajectory_id"] for _ in range(3)]
        streams = [channel.unary_stream(f"/{SERVICE}/ReceiveLocalSlamResults", request_serializer=wire.dumps,
                                        response_deserializer=wire.loads)({"trajectory_id": t}) for t in tids]
        deadline = threading.Event()
        while sum(len(v) for v in srv._subscribers.values()) < len(tids) and not deadline.wait(0.05):
            pass
        assert unary("GetTrajectoryStates", {})["trajectory_states"].keys() == set(tids)
        for stream in streams:
            stream.cancel()
    finally:
        channel.close()
        srv.shutdown()


def test_fleet_results_reference_counts_faults():
    a = [[0.1, 1.2345, 2, 3, 1, 0, 0, 0], [0.2, 1, 2, 3.5, 0.6, 0.8, 0, 0]]
    b = [[0.1, 5, 5, 5, 1, 0, 0, 0]]
    assert fleet_results.compare({0: a, 1: b}, {0: a, 1: b}) == {"lost": 0, "foreign": 0, "out_of_order": 0}
    assert fleet_results.compare({0: a, 1: b}, {0: a[:1], 1: b}) == {"lost": 1, "foreign": 0, "out_of_order": 0}
    assert fleet_results.compare({0: a, 1: b}, {0: b, 1: a}) == {"lost": 3, "foreign": 3, "out_of_order": 0}
    assert fleet_results.compare({0: a, 1: b}, {0: a[::-1], 1: b}) == {"lost": 0, "foreign": 0, "out_of_order": 1}
    assert fleet_results.compare({0: a}, {0: a}, control=True)["foreign"] == 2


def _spans(served, name):
    return served["rec"].spans_named(name)


def test_queue_wait_once_an_item(served):
    assert len(_spans(served, "server.queue_wait")) == served["items"]


def test_drain_once_a_pass(served):
    assert len(served["drains"]) >= 1 and len(_spans(served, "server.drain")) == len(served["drains"])


def test_batch_wait_once_a_request(served):
    solves = sum(r.local.num_optimizations for r in served["robots"])
    waits = _spans(served, "ct.batch_wait")
    assert len(waits) == solves
    # On the robots' worker threads, none on the SLAM thread that solves.
    solving = {s.thread for s in _spans(served, "ct.batched_solve")}
    assert len(solving) == 1 and not solving & {s.thread for s in waits}


def test_turn_wait_once_a_request(served):
    """Every served solve was asked for inside a host turn: each wait to
    take the turn back after the solve is recorded once, on the worker."""
    solves = sum(r.local.num_optimizations for r in served["robots"])
    turns = _spans(served, "ct.turn_wait")
    assert len(turns) == solves
    assert {s.thread for s in turns} == {s.thread for s in _spans(served, "ct.batch_wait")}


def test_batched_solve_once_a_batch(served):
    assert len(_spans(served, "ct.batched_solve")) == served["batcher"].batched_launches == len(served["flushed"])


def test_batch_windows_histogram_once_a_solve(served):
    b = served["batcher"]
    assert served["hist"] == (float(sum(b.batch_sizes) + b.serial_solves), b.batched_launches + b.serial_solves)


def test_batch_windows_histogram_counts_a_serial_solve_as_one(served, monkeypatch):
    """A flush with two windows that batch and one of another grid shape:
    one batched solve observed as 2, one serial as 1."""
    p = served["flushed"][0][0]
    grid = p.high_grid
    bigger = copy.copy(p)
    bigger.high_grid = grid._replace(prob=torch.zeros(tuple(s + 2 for s in grid.prob.shape)))
    monkeypatch.setattr(batcher_mod.window_solver, "solve_ct_window_batched",
                        lambda his, *a, **kw: (batcher_mod._stack([p.state0] * len(his), batcher_mod.CtState),
                                               torch.zeros(len(his)), torch.ones(len(his))))
    monkeypatch.setattr(batcher_mod.window_solver, "solve_ct_window",
                        lambda *a, **kw: (p.state0, torch.tensor(2.0), torch.tensor(3.0)))
    b = batcher_mod.CtWindowBatcher()
    windows = (copy.copy(p), bigger, copy.copy(p))
    entries = [{"pending": w, "event": threading.Event(), "solved": None, "error": None} for w in windows]
    before = batch_windows()
    with profiling.recording() as rec:
        b._flush(entries)
    after = batch_windows()
    assert (after[0] - before[0], after[1] - before[1]) == (3.0, 2)
    assert len(rec.spans_named("ct.batched_solve")) == 1 and b.batch_sizes == [2] and b.serial_solves == 1
    # Each solve's costs left on its own request: the batched lanes' and
    # the serial solve's.
    assert [(float(w.cost), float(w.cost0)) for w in windows] == [(0.0, 1.0), (2.0, 3.0), (0.0, 1.0)]
