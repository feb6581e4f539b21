"""One robot through MapBuilder in process, closed loop.

The robot's IMU and odometry up to a scan's stamp are handed to its
trajectory builder, then the scan; the next scan is handed once the
local SLAM result is back and the device has finished (a synchronize),
as `mapping-evaluation` replays a recorded sequence. The pose graph's
worker thread runs throughout.

Set-up: the stream is made, MapBuilder built, and scans are handed until
the mix's "warmup" holds: {"results": n} local results, or
{"finished_submaps": n} finished submaps in the pose graph. Then the
window: scans for `seconds` (with --trace 1, the CT solves in it timed
to the device's finish: Session.timed); then, with --trace 1,
`trace_scans` more scans under the profiler, the layers' calls wrapped
in spans.

A scan whose result comes back with a finite pose is completed; one that
raised or came back with a pose that is not finite has failed; one that
came back with no result (the builder holds it) is neither.
"""

from __future__ import annotations

import sys
import time
import traceback

from hgbench.gen.stream import make_stream
from hgbench.lib.robot import Robot, finite_pose
from hgbench.lib.trace import SpanPatches, Tracer, span


def section_totals():
    """{section: (seconds, count)} of the program's hg_section_seconds."""
    from hectorgrapher_tpu_torch.common import profiling

    out = {}
    for labels, hist in profiling._sections.items():
        out[labels.get("section")] = (hist.sum, sum(hist.counts_by_bucket))
    return out


def section_deltas(before, after):
    return {k: (v[0] - before.get(k, (0.0, 0))[0], v[1] - before.get(k, (0.0, 0))[1]) for k, v in after.items()}


def trace_patches(robot, pose_graph, use_3d: bool):
    """(owner, attribute, span) triples for the traced part: the local
    builder's stages, the kernel wrapper whose work a roofline counts
    (K3's), and the pose graph's rounds and solves."""
    from hectorgrapher_tpu_torch.mapping.ct import builder as ct_builder
    from hectorgrapher_tpu_torch.mapping.ct import window_solver

    pg = [(pose_graph, "_compute_constraints_for_node", "pg_node"),
          (pose_graph, "run_final_optimization", "pg_optimization")]
    if use_3d:
        return [(ct_builder, "adaptive_voxel_filter_timed", "ct_filter"),
                (window_solver, "cloud_poses", "ct_cloud_poses"),
                (window_solver, "pair_residuals", "ct_pair_residuals"),
                (window_solver, "ct_scan_block", "ct_scan_block"),
                (ct_builder, "compute_histogram", "ct_histogram"),
                (robot.local.active_submaps, "insert_data", "insert_3d")] + pg
    return [(robot.local, "_scan_match", "scan_match_2d"),
            (robot.local, "_insert_into_submap", "insert_2d")] + pg


def hand_timed(session, robot, latencies):
    """Hand the next scan; count it, time it to the device's finish."""
    t, data = robot.next_scan_data()
    session.attempted += 1
    t0 = time.perf_counter()
    try:
        with span("scan"):
            result = robot.hand(t, data)
        session.sync()
    except Exception:  # noqa: BLE001 - a scan that raised is counted and the run goes on
        traceback.print_exc(file=sys.stderr)
        session.failed += 1
        return
    latencies.append(time.perf_counter() - t0)
    if result is None:
        return
    if finite_pose(result):
        session.completed += 1
    else:
        session.failed += 1


def run(session):
    from hectorgrapher_tpu_torch.mapping.map_builder import MapBuilder

    s, mix = session, session.mix
    use_3d = bool(s.options.use_trajectory_builder_3d)
    stream = make_stream(s.config["sensors"], mix, s.seed, s.device, duration_s=float(mix["stream_s"]))
    mb = MapBuilder(s.options, device=s.device)
    robot = Robot(mb.get_trajectory_builder(mb.add_trajectory_builder()), stream, use_3d)
    pg = robot.pose_graph = mb.pose_graph
    s.install(robot)

    def release():
        pg.wait_for_all_computations()

    s.release = release

    warm = mix["warmup"]
    results = 0
    while True:
        if "results" in warm and results >= warm["results"]:
            break
        if "finished_submaps" in warm and sum(1 for m in pg.submaps if m.finished) >= warm["finished_submaps"]:
            break
        if robot.scans_left() <= 0:
            raise RuntimeError("the stream ended in set-up")
        t, data = robot.next_scan_data()
        results += robot.hand(t, data) is not None
    s.setup_done()

    latencies, ends = [], []
    before = section_totals()
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < s.seconds:
        if robot.scans_left() <= 0:
            raise RuntimeError("the stream ended in the window: lengthen the mix's stream_s")
        hand_timed(s, robot, latencies)
        ends.append(time.perf_counter() - t_start)
    window_s = time.perf_counter() - t_start
    s.window_done()
    fifths = [sum(1 for e in ends if k * window_s / 5 <= e < (k + 1) * window_s / 5) for k in range(5)]
    print(f"window: {len(ends)} scans handed in {window_s:.3f} s, by fifth of the window {fifths}", file=sys.stderr)
    s.e2e[mix["rate_metric"]] = s.completed / window_s
    s.readings.update(window_s=window_s, scan_latencies_s=latencies,
                      sections=section_deltas(before, section_totals()))

    if s.trace:
        calls = {"ct_scan_block": []}
        tail = []
        n = int(mix["trace_scans"])
        if robot.scans_left() < n:
            raise RuntimeError("the stream ended before the traced scans")
        s.tracer = Tracer(s.device)
        # The spans live inside the profiled part, and end with it: the
        # pose graph's worker finishes what the traced scans queued.
        with s.tracer, SpanPatches(trace_patches(robot, pg, use_3d), record=calls):
            counted = (s.attempted, s.completed)
            for _ in range(n):
                hand_timed(s, robot, tail)
            s.attempted, s.completed = counted  # the window's; a traced scan that fails still counts
            pg.wait_for_all_computations()
        if tail and latencies:
            print(f"traced scans: {1e3 * sum(tail) / len(tail):.1f} ms a scan under the profiler, the window's "
                  f"{1e3 * sum(latencies) / len(latencies):.1f} ms", file=sys.stderr)
        s.readings.update(trace=s.tracer.data, trace_scans=n, calls=calls)
