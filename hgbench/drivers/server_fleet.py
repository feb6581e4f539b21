"""Robots streaming to one MapBuilderServer over gRPC, closed loop per robot.

The server (hectorgrapher_tpu_torch.cloud.server.MapBuilderServer, with
the configuration's "server" settings; batch_ct_windows: the CT windows
of every robot that waits on a solve are solved together by the
CtWindowBatcher) runs in this process on the card, bound to gRPC on
loopback. The robots are one child process started in set-up (this file,
run as a script), which shares no interpreter with the server and
launches nothing on the card: CUDA is hidden from it and its streams
(gen/stream.py) are cast on the CPU, a chunk when first asked for. Each
robot is one trajectory added through the client stubs (cloud/client.py)
and subscribed to its own ReceiveLocalSlamResults stream. Robot i starts
`start_m + i * spacing_m` along the lap; its noise comes from the seed
and its index (robot_seed). A robot hands its IMU and odometry up to a
scan's stamp, then the scan, and holds at most one scan in flight: the
scan leaves flight when its result arrives on the robot's stream, or,
where the builder returned no result, once the server has processed it
(the server's core, in this process, tells the child: `notice`).

Set-up: the server, the child and its trajectories, the checks installed
(the CT window check's solves go through the batcher's hook:
`route_solves`),
then the robots run until each has the mix's warmup["results"] results
back. The window: `seconds` on the child's clock, the robots running on;
a scan counts to the window when it leaves flight in it: completed where
its result came back with a finite pose, failed where its processing
raised or the pose is not finite. Then the robots finish the scans in
flight and stop; with --trace 1, `trace_scans` more scans a robot under
the profiler. Last, the child hands over what each robot's stream
delivered (the fleet_results check). What the server did in each fifth of
the window (drains, the pose graph's work, the waits for a host turn) is
printed beside the child's counts by fifth.

Every wait of the server's side and of the child has a limit of its own
(LIMITS, CHILD_LIMITS); where one runs out the run stops, naming the
wait: the child exits non-zero, this process raises.
"""

from __future__ import annotations

import json
import os
import queue
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

# Limits (s) of this process's waits on the child, by what it waits for.
LIMITS = {"ready": 300.0, "warm": 1500.0, "closed": 180.0, "window": 600.0, "traced": 900.0, "final": 120.0,
          "exit": 60.0}
# Limits (s) of the child's waits: the server's notice of a scan in
# set-up (the first solves build the kernels on a fresh checkout) and
# after it, a result the notice announced, the robots' wind-down, and
# the server's first answers.
CHILD_LIMITS = {"notice_setup": 900.0, "notice": 120.0, "result": 60.0, "idle": 600.0, "connect": 120.0}
# The child's torch threads: it casts the streams' chunks on the CPU.
CHILD_THREADS = 2


def robot_seed(seed: int, index: int) -> int:
    """Robot `index`'s seed: its noise comes from the run's seed and its
    index, and from nothing else."""
    return int(seed) * 64 + int(index)


def robot_streams(sensors: dict, mix: dict, seed: int, robots: int):
    """Each robot's stream, cast on the CPU a chunk when first asked for:
    the child's and, for the checks, this process's are the same."""
    from hgbench.gen.stream import make_stream

    start, spacing = float(mix["drive"]["start_m"]), float(mix["spacing_m"])
    return [make_stream(sensors, mix, robot_seed(seed, i), "cpu", duration_s=float(mix["stream_s"]),
                        start_m=start + i * spacing, eager=False) for i in range(robots)]


class ServedRobot:
    """One robot as the checks see it: its trajectory builder in the
    server, the local builder under it, the stream it was fed."""

    def __init__(self, index: int, tid: int, trajectory_builder, stream):
        self.index, self.tid = index, tid
        self.tb = trajectory_builder
        self.local = trajectory_builder._local
        self.stream = stream

    def raw_stream(self):
        return self.stream


class Child:
    """The load generator: a child process, JSON lines both ways (its
    stdin from here, its stdout to here; its stderr is this process's)."""

    def __init__(self):
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        self.proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--child"], cwd=str(ROOT),
                                     env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, bufsize=1)
        self._lock = threading.Lock()
        self._inbox = queue.Queue()
        threading.Thread(target=self._read, name="fleet-child-reader", daemon=True).start()

    def _read(self):
        for line in self.proc.stdout:
            try:
                self._inbox.put(json.loads(line))
            except ValueError:
                print(f"fleet: a line from the child that is not JSON: {line!r}", file=sys.stderr)
        self._inbox.put(None)

    def send(self, msg: dict) -> bool:
        """Write one message; False where the child is gone."""
        try:
            with self._lock:
                self.proc.stdin.write(json.dumps(msg) + "\n")
                self.proc.stdin.flush()
            return True
        except (OSError, ValueError):
            return False

    def expect(self, op: str, limit: float) -> dict:
        try:
            msg = self._inbox.get(timeout=limit)
        except queue.Empty:
            raise TimeoutError(f"fleet: waited {limit:.0f} s for the child's {op!r} and it did not come")
        if msg is None:
            try:
                code = self.proc.wait(timeout=LIMITS["exit"])
            except subprocess.TimeoutExpired:
                code = None
            raise RuntimeError(f"fleet: the child ended (exit code {code}) while this process waited for {op!r}")
        if msg.get("op") == "error":
            raise RuntimeError(f"fleet: the child failed while this process waited for {op!r}: {msg.get('what')}")
        if msg.get("op") != op:
            raise RuntimeError(f"fleet: waited for the child's {op!r} and got {msg.get('op')!r}")
        return msg

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
        try:
            self.proc.wait(timeout=LIMITS["exit"])
        except subprocess.TimeoutExpired:
            print("fleet: the child did not end after a kill", file=sys.stderr)


class Fifths(threading.Thread):
    """The program's section totals (`totals`) at the start of the window
    and at each fifth of it, on this process's clock: what the server did
    in each fifth, beside the child's counts by fifth."""

    def __init__(self, totals, seconds: float):
        super().__init__(name="fleet-fifths", daemon=True)
        self.totals, self.seconds = totals, seconds
        self.snaps = []
        self.stop = threading.Event()

    def run(self):
        t0 = time.perf_counter()
        self.snaps.append(self.totals())
        for k in range(1, 6):
            if self.stop.wait(max(0.0, t0 + k * self.seconds / 5 - time.perf_counter())):
                return
            self.snaps.append(self.totals())

    def line(self) -> str:
        def delta(a, b, name):
            return (b.get(name, (0.0, 0))[0] - a.get(name, (0.0, 0))[0],
                    b.get(name, (0.0, 0))[1] - a.get(name, (0.0, 0))[1])

        pairs = list(zip(self.snaps, self.snaps[1:]))
        drains = [delta(a, b, "server.drain")[1] for a, b in pairs]
        work = [round(delta(a, b, "pg.work")[0], 2) for a, b in pairs]
        mean = lambda d: round(1e3 * d[0] / d[1], 1) if d[1] else None
        turn = [mean(delta(a, b, "ct.turn_wait")) for a, b in pairs]
        build = [mean(delta(a, b, "ct.build_window")) for a, b in pairs]
        return (f"server by fifth of the window: drains {drains}, pg.work s {work}, ct.turn_wait ms {turn}, "
                f"ct.build_window ms {build}")


def batch_windows():
    """(sum, count) of the program's hg_ct_batch_windows, None where the
    program has no such histogram."""
    from hectorgrapher_tpu_torch.cloud import ct_batcher

    hist = getattr(ct_batcher, "BATCH_WINDOWS", None)
    return None if hist is None else (hist.sum, sum(hist.counts_by_bucket))


def route_solves(session, batcher):
    """The CT window check solves through the builder module's
    solve_ct_window; here that name hands the window to the batcher's hook
    (the builder's window_solve_fn under the server) and reads the costs
    the hook leaves on the request, so that the checked solves are the
    served ones: batched with the other robots' windows, or alone where
    the batcher solves them alone."""
    from types import SimpleNamespace

    from hectorgrapher_tpu_torch.mapping.ct import builder as ct_builder

    def solve_ct_window(high_grid, low_grid, problem, state0, weights, is_tsdf, num_iterations, per_point=False,
                        direct=None):
        pending = SimpleNamespace(high_grid=high_grid, low_grid=low_grid, problem=problem, state0=state0,
                                  weights=weights, is_tsdf=is_tsdf, num_iterations=num_iterations,
                                  per_point=per_point, direct=direct, cost=None, cost0=None)
        state = batcher._solve(pending)
        return state, pending.cost, pending.cost0

    session.patch(ct_builder, "solve_ct_window", solve_ct_window)


def half_lanes_fault(session):
    """A broken batched solve (tests, calibration): the even lanes of each
    batch hand back their start state, with the solve's costs."""
    import torch

    from hectorgrapher_tpu_torch.mapping.ct import window_solver
    from hectorgrapher_tpu_torch.mapping.ct.window_solver import CtState

    from hgbench.lib.trace import Forwarding

    inner = window_solver.solve_ct_window_batched

    def faulty(*args, **kwargs):
        solved, cost, cost0 = inner(*args, **kwargs)
        states0 = args[3]
        start = torch.arange(solved.translation.shape[0], device=solved.translation.device) % 2 == 0
        pick = lambda got, s0: torch.where(start.view(-1, *([1] * (got.dim() - 1))), s0, got)
        return CtState(*(pick(g, s0) for g, s0 in zip(solved, states0))), cost, cost0

    session.patch(window_solver, "solve_ct_window_batched", Forwarding(faulty, inner))


def run(session):
    s, mix, cfg = session, session.mix, session.config["server"]
    robots = int(cfg["robots"])
    child = Child()  # first: its imports overlap the program's here
    try:
        server = _make_server(s, cfg)
    except BaseException:
        child.close()
        raise
    pg = server.map_builder.pose_graph

    def release():
        child.close()
        server.shutdown()
        pg.wait_for_all_computations()

    s.release = release
    try:
        server.start()
        child.send({"address": f"127.0.0.1:{server.port}", "robots": robots, "sensors": s.config["sensors"],
                    "mix": mix, "seed": s.seed, "threads": CHILD_THREADS,
                    "warmup": int(mix["warmup"]["results"]), "limits": CHILD_LIMITS})
        ready = child.expect("ready", LIMITS["ready"])
        tids = ready["tids"]
        s.readings["setup_marks"] = {k: v - s.t_start for k, v in ready["marks"].items()}
        streams = robot_streams(s.config["sensors"], mix, s.seed, robots)
        fleet = [ServedRobot(i, tid, server.map_builder.get_trajectory_builder(tid), streams[i])
                 for i, tid in enumerate(tids)]
        _serve(s, server, child, fleet)
    except BaseException:
        s.release = lambda: None
        release()
        s.unpatch()
        raise


def _make_server(s, cfg):
    import dataclasses

    from hectorgrapher_tpu_torch.cloud.server import MapBuilderServer
    from hectorgrapher_tpu_torch.mapping.ct.builder import PendingWindowSolve
    from hectorgrapher_tpu_torch.mapping.map_builder import MapBuilder

    if "cost" not in {f.name for f in dataclasses.fields(PendingWindowSolve)}:
        raise RuntimeError("fleet: this program's window solves leave no costs on the request "
                           "(PendingWindowSolve.cost); the CT window check cannot compare the served solves")
    mesh, n = None, int(cfg["ct_mesh_devices"])
    if n > 1:  # the batched solves sharded over the first n cards, as map-builder-server --ct_mesh_devices n
        from hectorgrapher_tpu_torch.parallel.mesh import Mesh

        mesh = Mesh([f"cuda:{i}" for i in range(n)])
    return MapBuilderServer(MapBuilder(s.options, device=s.device), cfg["address"], num_workers=int(cfg["num_workers"]),
                            batch_ct_windows=bool(cfg["batch_ct_windows"]), ct_mesh=mesh)


def _serve(s, server, child, fleet):
    from hgbench.lib import names
    from hgbench.lib.robot import finite_pose
    from hgbench.lib.trace import Tracer

    solo = names.load_module("drivers", "solo")
    mix = s.mix
    pg = server.map_builder.pose_graph
    for robot in fleet:
        s.install(robot)
    route_solves(s, server.ct_batcher)
    if s.fault == "half":
        half_lanes_fault(s)

    # What the builder handed the server for each trajectory's scan in
    # process: "result", "nonfinite", "none" or (unset) raised.
    outcome = {}
    state = {"window": False, "dropped": False, "last": {}}
    for robot in fleet:
        inner = robot.tb.add_range_data

        def add_range_data(data, inner=inner, robot=robot):
            result = _faulty(s, state, robot, inner(data))
            outcome[robot.tid] = "none" if result is None else ("result" if finite_pose(result) else "nonfinite")
            return result

        s.patch(robot.tb, "add_range_data", add_range_data)
    inner_process = server._process_one_item

    def process(item):
        if item[1] != "range":
            return inner_process(item)
        outcome.pop(item[0], None)
        inner_process(item)
        child.send({"op": "done", "tid": item[0], "outcome": outcome.pop(item[0], "raised")})

    s.patch(server, "_process_one_item", process)

    child.send({"op": "go"})
    child.expect("warm", LIMITS["warm"])
    s.setup_done()
    marks = s.readings.pop("setup_marks")
    print("set-up: " + ", ".join(f"{k} at {v:.1f} s" for k, v in marks.items())
          + f", each robot's warm-up results back at {s.setup_s:.1f} s", file=sys.stderr)
    s.timing = False  # no synchronize on the server's threads in the window
    state["window"] = True
    before, hist_before, cpu_before = solo.section_totals(), batch_windows(), os.times()
    fifths = Fifths(solo.section_totals, s.seconds)
    fifths.start()
    child.send({"op": "window", "seconds": s.seconds})
    try:
        child.expect("closed", s.seconds + LIMITS["closed"])
    except BaseException:
        fifths.stop.set()
        raise
    fifths.join(LIMITS["closed"])
    after, hist_after, cpu_after = solo.section_totals(), batch_windows(), os.times()
    state["window"] = False
    s.window_done()
    stats = child.expect("window", LIMITS["window"])
    window_s = stats["window_s"]
    s.attempted, s.completed, s.failed = stats["attempted"], stats["completed"], stats["failed"]
    print(f"window: {stats['attempted']} scans left flight in {window_s:.3f} s, by robot {stats['by_robot']}, "
          f"by fifth of the window {stats['fifths']}; batcher: {server.ct_batcher.batched_launches} batched solves, "
          f"{server.ct_batcher.serial_solves} alone", file=sys.stderr)
    print(fifths.line(), file=sys.stderr)
    s.e2e[mix["rate_metric"]] = s.completed / window_s
    s.readings.update(window_s=window_s, fleet_latencies_s=stats["latencies"],
                      sections=solo.section_deltas(before, after))
    cpu = (cpu_after.user + cpu_after.system) - (cpu_before.user + cpu_before.system)
    spent = {k: v for k, v in s.readings["sections"].items() if v[1] and k.split(".")[0] in ("server", "ct", "pg")}
    print(f"window: the server's process used {cpu:.1f} s of CPU, the child's {stats['cpu_s']:.1f} s; sections "
          + ", ".join(f"{k} {v[1]} x {1e3 * v[0] / v[1]:.1f} ms" for k, v in sorted(spent.items())), file=sys.stderr)
    if hist_before is not None and hist_after is not None:
        s.readings["batch_windows"] = (hist_after[0] - hist_before[0], hist_after[1] - hist_before[1])

    if s.trace:
        n = int(mix["trace_scans"])
        s.tracer = Tracer(s.device)
        with s.tracer:
            child.send({"op": "trace", "scans": n})
            s.failed += child.expect("traced", LIMITS["traced"])["failed"]
            pg.wait_for_all_computations()
        s.readings.update(trace=s.tracer.data, trace_scans=n * len(fleet))
    child.send({"op": "stop"})
    received = child.expect("final", LIMITS["final"])["received"]
    s.readings["fleet_received"] = {int(tid): items for tid, items in received.items()}
    try:
        code = child.proc.wait(timeout=LIMITS["exit"])
    except subprocess.TimeoutExpired:
        raise TimeoutError(f"fleet: waited {LIMITS['exit']:.0f} s for the child to exit")
    if code != 0:
        raise RuntimeError(f"fleet: the child exited with code {code}")


def _faulty(session, state, robot, result):
    """The result as a broken server would hand it on (tests, calibration):
    "drop", robot 0's first result of the window lost; "swap", in the
    window robots 0 and 1 each handed the other's latest result."""
    import dataclasses

    if session.fault == "drop" and robot.index == 0 and result is not None and state["window"] \
            and not state["dropped"]:
        state["dropped"] = True
        return None
    if session.fault == "swap" and robot.index in (0, 1) and result is not None:
        state["last"][robot.index] = result
        other = state["last"].get(1 - robot.index)
        if state["window"] and other is not None:
            return dataclasses.replace(result, time=other.time, local_pose=other.local_pose)
    return result


# -- the child ---------------------------------------------------------------


class _Fleet:
    """The child's robots and the phase they are in: "idle" until the
    server's side says go, "run", "pause" (between the window and the traced
    scans), "stop"."""

    def __init__(self, out, warmup: int, limits: dict):
        self.cv = threading.Condition()
        self.mode = "idle"
        self.budget = None  # scans a robot may still hand (the traced part), None: no limit
        self.in_flight = 0
        self.warmup, self.limits = warmup, limits
        self.warm_sent = False
        self.setup = True
        self.window = None  # (open, close) on the child's clock
        self.records = []  # (robot, upload, leave, outcome)
        self.results = {}
        self.trace_failed = 0
        self.robots = []
        self._out, self._out_lock = out, threading.Lock()

    def send(self, msg: dict):
        with self._out_lock:
            self._out.write(json.dumps(msg) + "\n")
            self._out.flush()

    def fail(self, what: str):
        print(f"fleet child: {what}", file=sys.stderr, flush=True)
        try:
            self.send({"op": "error", "what": what})
        finally:
            os._exit(3)

    def turn(self, r: int) -> bool:
        """Block until robot r may hand its next scan; False once stopped."""
        with self.cv:
            while True:
                if self.mode == "stop":
                    return False
                if self.mode == "run" and (self.budget is None or self.budget[r] > 0):
                    if self.budget is not None:
                        self.budget[r] -= 1
                    self.in_flight += 1
                    return True
                self.cv.wait()

    def left(self, r: int, upload: float, leave: float, outcome: str):
        with self.cv:
            self.in_flight -= 1
            self.records.append((r, upload, leave, outcome))
            if outcome == "result":
                self.results[r] = self.results.get(r, 0) + 1
            if self.budget is not None and outcome in ("raised", "nonfinite"):
                self.trace_failed += 1
            warm = not self.warm_sent and len(self.robots) and all(
                self.results.get(i, 0) >= self.warmup for i in range(len(self.robots)))
            if warm:
                self.warm_sent = True
            traced = self.budget is not None and self.in_flight == 0 and not any(self.budget)
            if traced:
                self.mode, self.budget = "pause", None
            self.cv.notify_all()
        if warm:
            self.send({"op": "warm"})
        if traced:
            self.send({"op": "traced", "failed": self.trace_failed})

    def wait_idle(self, what: str):
        limit = self.limits["idle"]
        with self.cv:
            if not self.cv.wait_for(lambda: self.in_flight == 0, timeout=limit):
                self.fail(f"waited {limit:.0f} s for the scans in flight to leave ({what})")

    def close_window(self, seconds: float):
        cpu = os.times()
        opened = time.perf_counter()
        self.window = (opened, opened + seconds)
        time.sleep(max(0.0, self.window[1] - time.perf_counter()))
        with self.cv:
            self.mode = "pause"
            self.cv.notify_all()
        self.send({"op": "closed"})
        cpu = os.times().user + os.times().system - cpu.user - cpu.system
        self.wait_idle("the window's end")
        lo, hi = self.window
        inside = [rec for rec in self.records if lo <= rec[2] < hi]
        fifths = [sum(1 for rec in inside if lo + k * seconds / 5 <= rec[2] < lo + (k + 1) * seconds / 5)
                  for k in range(5)]
        self.send({"op": "window", "window_s": seconds, "cpu_s": cpu, "attempted": len(inside),
                   "completed": sum(1 for rec in inside if rec[3] == "result"),
                   "failed": sum(1 for rec in inside if rec[3] in ("raised", "nonfinite")),
                   "latencies": [rec[2] - rec[1] for rec in inside], "fifths": fifths,
                   "by_robot": [sum(1 for rec in inside if rec[0] == i) for i in range(len(self.robots))]})


class _ChildRobot:
    def __init__(self, index: int, stub, tid: int, stream):
        from hgbench.lib.robot import Robot

        tb = stub.get_trajectory_builder(tid)
        tb._local = None  # a remote builder: nothing local to watch
        self.index, self.tid, self.stub = index, tid, stub
        self.robot = Robot(tb, stream, use_3d=True)
        self.notices = queue.Queue()
        self.results = queue.Queue()
        self.received = []
        self.call = stub.receive_local_slam_results(tid)

    def listen(self):
        """The robot's stream, until it is cancelled."""
        import grpc

        try:
            for item in self.call:
                pose = item["local_pose"]
                self.received.append([float(item["time"])] + [float(x) for x in pose.t] + [float(x) for x in pose.q])
                self.results.put(item)
        except grpc.RpcError as e:
            if e.code() != grpc.StatusCode.CANCELLED:
                print(f"fleet child: robot {self.index}'s stream ended: {e!r}", file=sys.stderr, flush=True)

    def drive(self, fleet: _Fleet):
        try:
            while fleet.turn(self.index):
                if self.robot.scans_left() <= 0:
                    fleet.fail(f"robot {self.index}'s stream ended: lengthen the mix's stream_s")
                t, data = self.robot.next_scan_data()
                self.robot.feed_until(t)
                upload = time.perf_counter()
                self.robot.next_scan += 1
                self.robot.tb.add_range_data(data)
                limit = fleet.limits["notice_setup" if fleet.setup else "notice"]
                try:
                    outcome = self.notices.get(timeout=limit)
                except queue.Empty:
                    fleet.fail(f"robot {self.index} waited {limit:.0f} s for the server's notice of scan "
                               f"{self.robot.next_scan - 1}")
                if outcome in ("result", "nonfinite"):
                    try:
                        self.results.get(timeout=fleet.limits["result"])
                    except queue.Empty:
                        fleet.fail(f"robot {self.index} waited {fleet.limits['result']:.0f} s for the result of "
                                   f"scan {self.robot.next_scan - 1} on its stream")
                fleet.left(self.index, upload, time.perf_counter(), outcome)
        except Exception:  # noqa: BLE001 - the run stops, the cause printed
            fleet.fail(f"robot {self.index}: {traceback.format_exc()}")


def child_main() -> int:
    marks = {"the child started": time.perf_counter()}
    out = os.fdopen(os.dup(1), "w", buffering=1)
    os.dup2(2, 1)  # the messages alone on the pipe; everything else to stderr
    sys.path.insert(0, str(ROOT))
    import torch

    from hectorgrapher_tpu_torch.cloud.client import MapBuilderStub

    marks["its imports done"] = time.perf_counter()
    params = json.loads(sys.stdin.readline())
    marks["the server up"] = time.perf_counter()
    torch.set_num_threads(int(params["threads"]))
    limits = params["limits"]
    fleet = _Fleet(out, int(params["warmup"]), limits)
    streams = robot_streams(params["sensors"], params["mix"], int(params["seed"]), int(params["robots"]))
    by_tid = {}
    for i, stream in enumerate(streams):
        stub = MapBuilderStub(params["address"])
        done = {}
        t = threading.Thread(target=lambda: done.setdefault("tid", stub.add_trajectory_builder()), daemon=True)
        t.start()
        t.join(limits["connect"])
        if "tid" not in done:
            fleet.fail(f"waited {limits['connect']:.0f} s for the server to add robot {i}'s trajectory")
        robot = _ChildRobot(i, stub, done["tid"], stream)
        by_tid[robot.tid] = robot
        fleet.robots.append(robot)
    listeners = [threading.Thread(target=r.listen, daemon=True) for r in fleet.robots]
    for t in listeners:
        t.start()
    marks["its robots added"] = time.perf_counter()
    fleet.send({"op": "ready", "tids": [r.tid for r in fleet.robots], "marks": marks})
    feeders = [threading.Thread(target=r.drive, args=(fleet,), daemon=True) for r in fleet.robots]
    for t in feeders:
        t.start()
    for line in sys.stdin:
        msg = json.loads(line)
        op = msg["op"]
        if op == "done":
            by_tid[msg["tid"]].notices.put(msg["outcome"])
        elif op == "go":
            with fleet.cv:
                fleet.mode = "run"
                fleet.cv.notify_all()
        elif op == "window":
            fleet.setup = False
            threading.Thread(target=fleet.close_window, args=(float(msg["seconds"]),), daemon=True).start()
        elif op == "trace":
            fleet.wait_idle("the traced part's start")
            with fleet.cv:
                fleet.budget = [int(msg["scans"])] * len(fleet.robots)
                fleet.mode = "run"
                fleet.cv.notify_all()
        elif op == "stop":
            break
    with fleet.cv:
        fleet.mode = "stop"
        fleet.cv.notify_all()
    fleet.wait_idle("the stop")
    for r in fleet.robots:
        r.call.cancel()
    for t in listeners:
        t.join(limits["result"])
    fleet.send({"op": "final", "received": {str(r.tid): r.received for r in fleet.robots}})
    for r in fleet.robots:
        r.stub.close()
    return 0


if __name__ == "__main__" and sys.argv[1:] == ["--child"]:
    code = child_main()
    sys.stdout.flush()
    sys.stderr.flush()
    # Past the interpreter's teardown, which can abort while gRPC's and
    # torch's native threads still run ("terminate called without an
    # active exception"): everything the child owes is out by now.
    os._exit(code)
