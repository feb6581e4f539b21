"""The port's span recorder (hectorgrapher_tpu_torch/common/profiling.py)
on the CPU: off it records nothing and reads no clock; spans nest per
thread and lose nothing under contention; the buffer is bounded; and the
program's sections and spans (ct.build_window, 2d.scan_match, the pose
graph worker's pg.work and pg.queue_wait, a batched round's round.*
stages) are recorded where they are placed, still feeding
hg_section_seconds."""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from hectorgrapher_tpu.evaluation.scan_generator import raycast_rect_room_2d
from hectorgrapher_tpu_torch.common import config as tcfg
from hectorgrapher_tpu_torch.common import profiling
from hectorgrapher_tpu_torch.mapping import local_2d as tlocal
from hectorgrapher_tpu_torch.mapping.map_builder import MapBuilder
from hectorgrapher_tpu_torch.sensor import types as ttypes
from hectorgrapher_tpu_torch.transform import np_quat as nq
from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3 as TNpRigid3
from test_batched_constraint_path import options_2d, options_3d
from torch_parity import CPU, batched_anchors_2d, batched_anchors_3d, ct_drive, port_drive_2d, port_drive_3d

torch.set_num_threads(1)

ROUND_STAGES = ("round.pack", "round.initials", "round.fast_match", "round.gn_prepare", "round.gn",
                "round.gn_readback")


class _Clock:
    """A stand-in for the time module that records each read."""

    def __init__(self):
        self.reads = []

    def perf_counter_ns(self):
        self.reads.append("perf_counter_ns")
        return 0

    def perf_counter(self):
        self.reads.append("perf_counter")
        return 0.0


def _totals():
    """{section: (seconds, count)} of hg_section_seconds."""
    return {labels["section"]: (h.sum, sum(h.counts_by_bucket)) for labels, h in profiling._sections.items()}


def test_off_records_nothing_and_reads_no_clock(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(profiling, "time", clock)
    assert profiling.span("a") is profiling.span("b")  # one shared no-op context
    with profiling.span("a"), profiling.span("b"):
        pass
    assert clock.reads == [] and profiling.active_recording() is None


def test_spans_nest_per_thread():
    started = threading.Barrier(2)

    def worker():
        with profiling.span("w.outer"):
            started.wait()
            with profiling.span("w.inner"):
                pass

    with profiling.recording() as rec:
        t = threading.Thread(target=worker)
        with profiling.span("m.outer"):
            t.start()
            started.wait()
            with profiling.span("m.inner"):
                with profiling.section("m.section"):
                    pass
            t.join()
    assert profiling.active_recording() is None and rec.dropped == 0 and rec.end_ns >= rec.start_ns
    by = {s.name: s for s in rec.spans}
    main, other = threading.get_ident(), t.ident
    assert by["m.inner"].parent == "m.outer" and by["m.section"].parent == "m.inner"
    assert by["w.inner"].parent == "w.outer" and by["w.outer"].parent is None and by["m.outer"].parent is None
    assert {by[n].thread for n in ("m.outer", "m.inner", "m.section")} == {main}
    assert {by[n].thread for n in ("w.outer", "w.inner")} == {other}
    for outer, inner in (("m.outer", "m.inner"), ("m.inner", "m.section"), ("w.outer", "w.inner")):
        assert by[outer].start_ns <= by[inner].start_ns <= by[inner].end_ns <= by[outer].end_ns


def test_spans_lose_nothing_under_contention():
    """More threads than cores, the interpreter switching threads every
    microsecond: every span of every thread is kept."""
    n_threads, n = 4 * (os.cpu_count() or 1), 500
    alive = threading.Barrier(n_threads)  # no thread ends before all began: no ident is reused

    def work():
        alive.wait()
        for _ in range(n):
            with profiling.span("s"):
                pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording() as rec:
            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    spans = rec.spans_named("s")
    assert len(spans) == n_threads * n and len({s.thread for s in spans}) == n_threads


def test_buffer_is_bounded():
    with profiling.recording(capacity=3) as rec:
        for _ in range(5):
            with profiling.span("x"):
                pass
    assert len(rec.spans) == 3 and rec.dropped == 2


def test_one_recording_at_a_time():
    with profiling.recording() as rec:
        with pytest.raises(RuntimeError):
            with profiling.recording():
                pass
        with profiling.span("still"):
            pass
    assert [s.name for s in rec.spans] == ["still"] and profiling.active_recording() is None


def test_section_since_spans_a_handoff_between_threads():
    """An interval stamped on one thread and closed on another: observed
    into hg_section_seconds, and recorded on the closing thread under its
    open span; one stamped before the recording began is not recorded."""
    before = _totals().get("handoff", (0.0, 0))
    early = time.perf_counter_ns()
    with profiling.recording() as rec:
        stamp = time.perf_counter_ns()
        done = []

        def close():
            with profiling.span("outer"):
                profiling.section_since("handoff", stamp)
                profiling.section_since("handoff", early)
            done.append(threading.get_ident())

        t = threading.Thread(target=close)
        t.start()
        t.join()
    (sp,) = rec.spans_named("handoff")
    assert sp.start_ns == stamp <= sp.end_ns and sp.thread == done[0] and sp.parent == "outer"
    seconds, count = _totals()["handoff"]
    assert count == before[1] + 2 and seconds >= before[0] + (sp.end_ns - sp.start_ns) / 1e9


def _ct_map_builder(async_work_queue: bool):
    opts = tcfg.replace_deep(tcfg.MapBuilderOptions(), {
        "use_trajectory_builder_3d": True,
        "pose_graph.async_work_queue": async_work_queue,
        "pose_graph.optimize_every_n_nodes": 4,
        "trajectory_builder_3d.min_range": 0.4,
        "trajectory_builder_3d.motion_filter.max_distance_meters": 0.02,
        "trajectory_builder_3d.motion_filter.max_angle_radians": 0.002,
        "trajectory_builder_3d.motion_filter.max_time_seconds": 0.05,
        "trajectory_builder_3d.optimizing_local_trajectory_builder.ct_window_horizon": 0.4,
        "trajectory_builder_3d.submaps.high_grid_size": 64,
        "trajectory_builder_3d.submaps.low_grid_size": 32,
        "trajectory_builder_3d.submaps.high_resolution": 0.15,
        "trajectory_builder_3d.submaps.low_resolution": 0.45,
        "trajectory_builder_3d.optimizing_local_trajectory_builder.initialization_duration": 0.45,
        "trajectory_builder_3d.optimizing_local_trajectory_builder.max_control_points": 8,
        "trajectory_builder_3d.optimizing_local_trajectory_builder.max_clouds_in_window": 8,
        "trajectory_builder_3d.optimizing_local_trajectory_builder.points_per_cloud": 64,
        "trajectory_builder_3d.optimizing_local_trajectory_builder.max_num_iterations": 4,
    })
    return MapBuilder(opts, device="cpu")


def test_ct_drive_records_the_window_build_and_the_worker():
    """A CT drive through MapBuilder 3D with the worker on: one
    ct.build_window section a window solve on the main thread; one
    pg.queue_wait and one pg.work an item, both on the worker, each wait
    ending where its item's work begins, and the constraint searches inside
    pg.work; every section still counted in hg_section_seconds."""
    mb = _ct_map_builder(async_work_queue=True)
    tb = mb.get_trajectory_builder(mb.add_trajectory_builder())
    before = _totals()
    with profiling.recording() as rec:
        ct_drive(tb, TNpRigid3, ttypes.TimedPointCloudData, ttypes.pad_timed_cloud, duration=1.5)
        mb.pose_graph.wait_for_all_computations()
    main, worker = threading.get_ident(), mb.pose_graph._worker.ident
    builds = rec.spans_named("ct.build_window")
    assert builds and len(builds) == tb._local.num_optimizations and {s.thread for s in builds} == {main}
    work, waits = rec.spans_named("pg.work"), rec.spans_named("pg.queue_wait")
    assert work and len(waits) == len(work) and len(mb.pose_graph.nodes) >= 3
    assert {s.thread for s in work + waits} == {worker}
    for w, item in zip(waits, work):
        assert w.start_ns <= w.end_ns <= item.start_ns <= item.end_ns
    searches = [s for s in rec.spans_named("constraint_search") if s.thread == worker]
    assert searches and {s.parent for s in searches} == {"pg.work"}
    after = _totals()
    for name in ("ct.build_window", "pg.work", "pg.queue_wait", "constraint_search"):
        assert after[name][1] - before.get(name, (0.0, 0))[1] == len(rec.spans_named(name))
    assert "hg_section_seconds_count{section=\"pg.work\"}" in profiling.report()


def test_sync_mode_pose_graph_runs_without_worker_spans():
    mb = _ct_map_builder(async_work_queue=False)
    tb = mb.get_trajectory_builder(mb.add_trajectory_builder())
    with profiling.recording() as rec:
        ct_drive(tb, TNpRigid3, ttypes.TimedPointCloudData, ttypes.pad_timed_cloud, duration=0.9)
    assert not rec.spans_named("pg.work") and not rec.spans_named("pg.queue_wait")
    assert rec.spans_named("constraint_search") and rec.spans_named("ct.build_window")
    assert {s.thread for s in rec.spans} == {threading.get_ident()}


@pytest.mark.parametrize("dims", [2, 3])
def test_batched_round_records_its_stages(dims):
    """A batched round in 2D and in 3D (both anchors as candidates): one
    span of each round stage, in order, each a child of the constraint
    search."""
    if dims == 2:
        anchors, drive, options = batched_anchors_2d(), port_drive_2d, options_2d(True)
    else:
        anchors, drive, options = batched_anchors_3d(), port_drive_3d, options_3d(True)
    with profiling.recording() as rec:
        drive(anchors, options)
    stages = [s for s in rec.spans if s.name in ROUND_STAGES]
    assert [s.name for s in stages] == list(ROUND_STAGES)
    assert {s.parent for s in stages} == {"constraint_search"}
    for a, b in zip(stages, stages[1:]):
        assert a.end_ns <= b.start_ns
    (search,) = [s for s in rec.spans_named("constraint_search") if s.start_ns <= stages[0].start_ns
                 and stages[-1].end_ns <= s.end_ns]
    assert search.thread == stages[0].thread


def _front_end_2d_options():
    return tcfg.replace_deep(tcfg.TrajectoryBuilder2DOptions(), {
        "use_imu_data": False,
        "use_online_correlative_scan_matching": True,
        "max_range": 12.0,
        "real_time_correlative_scan_matcher.linear_search_window": 0.15,
        "real_time_correlative_scan_matcher.angular_search_window": float(np.radians(10.0)),
        "submaps.grid_size": 256,
        "submaps.num_range_data": 3,
        "max_num_points": 1024,
        "motion_filter.max_distance_meters": 0.05,
        "motion_filter.max_time_seconds": 0.1,
    })


def test_2d_front_end_records_its_scan_match():
    """One 2d.scan_match section a matched scan, on the front end's
    thread, into hg_section_seconds as well."""
    tb = tlocal.LocalTrajectoryBuilder2D(_front_end_2d_options(), device=CPU)
    rng = np.random.default_rng(0)
    before = _totals().get("2d.scan_match", (0.0, 0))[1]
    matched = 0
    with profiling.recording() as rec:
        for i in range(4):
            t, a = 0.1 * i, 2 * np.pi * i / 60
            xy = np.array([0.6 + 1.4 * np.cos(a), 0.5 + 1.4 * np.sin(a)])
            yaw = a + np.pi / 2
            tb.add_odometry_data(t, TNpRigid3(np.array([xy[0], xy[1], 0.0]),
                                              nq.quat_from_axis_angle(np.array([0.0, 0.0, yaw]))))
            pts = raycast_rect_room_2d(xy, yaw, num_rays=720, noise_std=0.004, rng=rng)
            pts = pts[~np.isnan(pts[:, 0])].astype(np.float32)
            cloud = ttypes.pad_timed_cloud(pts, np.zeros(len(pts), np.float32), 1024)
            result = tb.add_range_data(ttypes.TimedPointCloudData(
                time=t, origin=np.zeros(3, np.float32),
                ranges=ttypes.TimedPointCloud(cloud.positions, cloud.times, cloud.mask)))
            matched += result is not None
    spans = rec.spans_named("2d.scan_match")
    assert matched >= 3 and len(spans) == matched and {s.thread for s in spans} == {threading.get_ident()}
    assert _totals()["2d.scan_match"][1] - before == matched
