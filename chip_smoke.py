#!/usr/bin/env python3
"""Smoke run of hectorgrapher_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the package's CUDA kernels from csrc/, holds each against its plain
PyTorch version at the shapes the main path gives it, then drives the main
path: the batched correlative + Gauss-Newton matcher at B=1024 and the 2D
local SLAM front end (LocalTrajectoryBuilder2D) over 60 scans of the
mapping-evaluation circle. Each phase prints one line; any failure exits
non-zero before the last line. The second-to-last line is a JSON record of
the kernels, the last line a JSON record of the device.

Imports torch, numpy and hectorgrapher_tpu_torch only. Needs one card and
fails when torch.cuda.is_available() is false.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from hectorgrapher_tpu_torch.common import config as cfg
from hectorgrapher_tpu_torch.evaluation.scan_generator import raycast_rect_room_2d
from hectorgrapher_tpu_torch.mapping.grids import make_probability_grid
from hectorgrapher_tpu_torch.mapping.inserters_2d import make_probability_inserter_2d
from hectorgrapher_tpu_torch.mapping.local_2d import LocalTrajectoryBuilder2D
from hectorgrapher_tpu_torch.mapping.scan_matching.correlative_2d import (
    _window_geometry,
    make_search_window,
    match_correlative_2d_batched,
    prep_inputs,
    prepare_correlative_table,
)
from hectorgrapher_tpu_torch.mapping.scan_matching.gn_2d import (
    match_gn_2d_probability_batched,
    prepare_gn_probability_field,
)
from hectorgrapher_tpu_torch.ops import _build
from hectorgrapher_tpu_torch.ops.correlative_prep_2d import correlative_prep_2d, correlative_prep_2d_plain
from hectorgrapher_tpu_torch.ops.correlative_scores_2d import correlative_scores_2d, correlative_scores_2d_plain
from hectorgrapher_tpu_torch.sensor.types import (
    PointCloud,
    RangeData,
    TimedPointCloud,
    TimedPointCloudData,
    pad_cloud,
    pad_timed_cloud,
)
from hectorgrapher_tpu_torch.sensor.voxel_filter import adaptive_voxel_filter
from hectorgrapher_tpu_torch.transform import np_quat as nq
from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3
from hectorgrapher_tpu_torch.transform.rigid import Rigid2

SEED = 0
BATCH = 1024  # the batched matcher's server operating point
N_SCANS = 60  # 6 s of the front end at 10 Hz

# Front-end error bounds: twice the error of the JAX package's own front
# end on the same 60 scans (hectorgrapher_tpu LocalTrajectoryBuilder2D on
# a CPU: max translation error 0.02864 m, max yaw error 0.00254 rad), and
# no looser than 0.1 m / 0.03 rad.
MAX_TRANSLATION_ERROR = min(2 * 0.02864, 0.1)
MAX_YAW_ERROR = min(2 * 0.00254, 0.03)


def fail(msg: str):
    sys.exit(f"chip_smoke: FAIL: {msg}")


def slice_options():
    """The repo's 2D mapping-evaluation configuration with the real-time
    window of tests/test_map_builder_2d.py."""
    return cfg.replace_deep(
        cfg.TrajectoryBuilder2DOptions(),
        {
            "use_imu_data": False,
            "use_online_correlative_scan_matching": True,
            "real_time_correlative_scan_matcher.linear_search_window": 0.15,
            "submaps.grid_size": 640,
            "submaps.num_range_data": 12,
            "max_num_points": 2048,
            "motion_filter.max_distance_meters": 0.05,
            "motion_filter.max_time_seconds": 0.1,
        },
    )


def circle_scans(n_scans=N_SCANS, seed=SEED):
    """(time, ground-truth pose, odometry pose, timed cloud) along the
    mapping-evaluation circle: radius 1.4 m around (0.6, 0.5), 10 Hz,
    1440-ray rect-room scans with 0.004 m range noise, 0.003 m odometry
    noise."""
    rng = np.random.default_rng(seed)
    radius, center = 1.4, (0.6, 0.5)
    out = []
    for i in range(n_scans):
        t = 0.1 * i
        a = 2 * np.pi * i / max(n_scans - 1, 1)
        xy = np.array([center[0] + radius * np.cos(a), center[1] + radius * np.sin(a)])
        yaw = a + np.pi / 2
        pose = NpRigid3(np.array([xy[0], xy[1], 0.0]), nq.quat_from_axis_angle(np.array([0.0, 0.0, yaw])))
        odom = NpRigid3(pose.t + rng.normal(0, 0.003, 3), pose.q)
        pts = raycast_rect_room_2d(xy, yaw, num_rays=1440, noise_std=0.004, rng=rng)
        pts = pts[~np.isnan(pts[:, 0])].astype(np.float32)
        cloud = pad_timed_cloud(pts, np.zeros(len(pts), np.float32), 2048)
        out.append((t, pose, odom, cloud))
    return out


def front_end_kernel_inputs(device):
    """K1/K2 inputs at the front end's shape (B=1, T=425, N=2048): a
    640^2 submap with the first scan inserted, the first scan after the
    adaptive voxel filter, matched from a pose 5 cm / 0.02 rad off."""
    opts = slice_options()
    _, _, _, cloud = circle_scans(1)[0]
    grid = make_probability_grid(0.05, (640, 640), device)
    insert = make_probability_inserter_2d(
        opts.submaps.range_data_inserter.probability_grid_range_data_inserter, max_range=32.0, resolution=0.05
    )
    pc = pad_cloud(cloud.positions[cloud.mask], 2048, device)
    grid = insert(grid, RangeData(torch.zeros(3, device=device), pc, pad_cloud(np.zeros((0, 3)), 8, device)))
    pc = adaptive_voxel_filter(pc, opts.adaptive_voxel_filter)
    rt = opts.real_time_correlative_scan_matcher
    window = make_search_window(rt.linear_search_window, rt.angular_search_window, 0.05, opts.max_range)
    clouds = PointCloud(pc.positions[None], pc.mask[None])
    poses = Rigid2(torch.tensor([[0.05, -0.03]], device=device), torch.tensor([0.02], device=device))
    return grid, clouds, poses, window


def batched_scene(device, batch=BATCH, seed=SEED):
    """bench.py's batched point: a 256^2 grid at 0.05 m from one 720-ray
    scan of a 8.04 x 6.82 m room, the scan as a 512-point cloud, a 0.15 m /
    10 degree window with the angular step from the scan's own range, and
    `batch` matches from seeded poses within +-0.1 m / +-0.05 rad of the
    true pose (the origin)."""
    grid = make_probability_grid(0.05, (256, 256), device)
    insert = make_probability_inserter_2d(
        cfg.ProbabilityGridRangeDataInserterOptions2D(), max_range=12.8, resolution=0.05
    )
    pts = raycast_rect_room_2d(np.zeros(2), 0.0, half_width=4.02, half_height=3.41, num_rays=720)
    pts = pts[~np.isnan(pts[:, 0])]
    cloud = pad_cloud(pts.astype(np.float32), 512, device)
    grid = insert(grid, RangeData(torch.zeros(3, device=device), cloud, pad_cloud(np.zeros((0, 3)), 8, device)))
    window = make_search_window(0.15, math.radians(10.0), 0.05, float(np.linalg.norm(pts, axis=-1).max()))
    rng = np.random.default_rng(seed)
    offs = rng.uniform(-0.1, 0.1, (batch, 2)).astype(np.float32)
    angs = rng.uniform(-0.05, 0.05, batch).astype(np.float32)
    clouds = PointCloud(cloud.positions.expand(batch, -1, -1), cloud.mask.expand(batch, -1))
    poses = Rigid2(torch.from_numpy(offs).to(device), torch.from_numpy(angs).to(device))
    return grid, clouds, poses, window


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cuda_ms(fn, reps=20):
    """Median milliseconds of one call of fn() over `reps` runs, by CUDA
    events around the call: device time plus any launch gap the host leaves
    on the stream."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps=20):
    """Mean device milliseconds per call of fn(): the self time of every
    kernel, copy and fill it ran, from torch.profiler's CUDA trace. None
    when the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages())
    return total_us / reps / 1e3 if total_us > 0 else None


def _fmt(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


def check_kernels(shapes):
    """Phases 3 and 4: each kernel against its plain version at each shape.
    Returns {kernel: {shape: (max_abs_err, ms, plain_ms)}}."""
    out = {"correlative_prep_2d": {}, "correlative_scores_2d": {}}
    for label, (grid, clouds, poses, window) in shapes.items():
        k, gsz, half, m, pw, n_th, n_groups = _window_geometry(window)
        args, kw = prep_inputs(grid, clouds, poses, window)
        flat, dlin = correlative_prep_2d(*args, **kw)
        flat_p, dlin_p = correlative_prep_2d_plain(*args, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(flat, flat_p) and torch.equal(dlin, dlin_p)):
            bad = int((flat != flat_p).sum() + (dlin != dlin_p).sum())
            fail(f"K1 correlative_prep_2d differs from its plain version at {label}: {bad} outputs")
        kernel = lambda: correlative_prep_2d(*args, **kw)
        plain = lambda: correlative_prep_2d_plain(*args, **kw)
        ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
        out["correlative_prep_2d"][label] = (0.0, ms, plain_ms)
        b, t_pad, n = dlin.shape
        print(f"K1 correlative_prep_2d {label} B={b} T={t_pad} N={n}: exact; per call kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms; device time kernel {_fmt(device_ms(kernel))}, "
              f"plain {_fmt(device_ms(plain))}", flush=True)

        table = prepare_correlative_table(grid, window)
        valid = clouds.mask.to(torch.float32).contiguous()
        sargs = (table, flat, dlin, valid, n_groups, gsz, pw, k)
        got = correlative_scores_2d(*sargs)
        ref = correlative_scores_2d_plain(*sargs)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            fail(f"K2 correlative_scores_2d returned non-finite values at {label}")
        err = (got - ref).abs().amax(dim=(1, 2, 3))  # per match
        n_valid = valid.sum(dim=1)
        # f32 sums of at most n_valid bf16 values, each at most 1, in
        # another order: |delta| <= 1e-4 * n_valid.
        if bool((err > 1e-4 * n_valid).any()):
            fail(f"K2 correlative_scores_2d differs from its plain version at {label}: max {float(err.max())}")
        kernel = lambda: correlative_scores_2d(*sargs)
        plain = lambda: correlative_scores_2d_plain(*sargs)
        ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
        out["correlative_scores_2d"][label] = (float(err.max()), ms, plain_ms)
        print(f"K2 correlative_scores_2d {label} B={b} G={n_groups} N={n}: max |d| {float(err.max()):.3e} "
              f"(bound {1e-4 * float(n_valid.min()):.3e}); per call kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; "
              f"device time kernel {_fmt(device_ms(kernel))}, plain {_fmt(device_ms(plain))}", flush=True)
    return out


def run_batched(device, batch=BATCH, reps=10):
    """Phase 5: correlative + 10 GN iterations on `batch` matches against
    one grid version (table and field prepared once, as bench.py does).
    GN's translation target is the correlative result, as the reference's
    constraint builder sets it (constraint_builder_2d.cc); bench.py's
    target, the perturbed start, holds each match near its start under
    translation_weight 10. Every match must recover the true pose.
    Returns matches/s."""
    grid, clouds, poses, window = batched_scene(device, batch)
    table = prepare_correlative_table(grid, window)
    field = prepare_gn_probability_field(grid)

    def step():
        _, coarse = match_correlative_2d_batched(grid, clouds, poses, window, 0.1, 0.1, prepared_table=table)
        return match_gn_2d_probability_batched(
            grid, clouds, coarse, coarse.translation, 1.0, 10.0, 40.0, num_iterations=10, prepared_field=field
        )

    refined, costs = step()
    t_err = refined.translation.norm(dim=-1)
    a_err = refined.angle.abs()
    if not (bool(torch.isfinite(costs).all()) and refined.translation.shape == (batch, 2)):
        fail("batched matcher: non-finite costs or wrong shape")
    if float(t_err.max()) > 0.05 or float(a_err.max()) > 0.02:
        fail(f"batched matcher: max error {float(t_err.max()):.4f} m / {float(a_err.max()):.4f} rad "
             "exceeds 0.05 m / 0.02 rad")
    times = []
    for _ in range(reps):
        sync(device)
        t0 = time.perf_counter()
        step()
        sync(device)
        times.append(time.perf_counter() - t0)
    step_s = statistics.median(times)
    print(f"batched matcher B={batch}: max error {float(t_err.max()):.4f} m / {float(a_err.max()):.4f} rad; "
          f"step {step_s * 1e3:.3f} ms (median of {reps}), {batch / step_s:.1f} matches/s", flush=True)
    return batch / step_s


def run_front_end(device, n_scans=N_SCANS):
    """Phase 6: LocalTrajectoryBuilder2D over the circle scans. Returns
    (matched scans, per-scan seconds of the matched scans, max translation
    and yaw errors against ground truth, the builder)."""
    builder = LocalTrajectoryBuilder2D(slice_options(), device=device)
    scans = circle_scans(n_scans)
    anchor = scans[0][1]
    n_matched, latencies, t_err, y_err = 0, [], 0.0, 0.0
    for t, pose, odom, cloud in scans:
        builder.add_odometry_data(t, odom)
        matched = builder.active_submaps.matching_submap is not None
        t0 = time.perf_counter()
        result = builder.add_range_data(
            TimedPointCloudData(t, np.zeros(3, np.float32), TimedPointCloud(cloud.positions, cloud.times, cloud.mask))
        )
        sync(device)
        if matched:
            n_matched += 1
            latencies.append(time.perf_counter() - t0)
        if result is None or not np.all(np.isfinite(result.local_pose.t)):
            fail(f"front end: no finite pose at t={t:.1f}")
        truth = anchor.inverse().compose(pose)
        t_err = max(t_err, float(np.linalg.norm(result.local_pose.t[:2] - truth.t[:2])))
        d = nq.quat_yaw(result.local_pose.q) - nq.quat_yaw(truth.q)
        y_err = max(y_err, abs((d + np.pi) % (2 * np.pi) - np.pi))
    return n_matched, latencies, t_err, y_err, builder


def main() -> int:
    # Phase 1: device.
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    # Phase 2: build the kernels from csrc/.
    t0 = time.perf_counter()
    _build.load_library()
    ptxas = [l.strip() for l in _build.build_log.splitlines() if "registers" in l or "Compiling entry" in l]
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds:.2f} s); "
          + " | ".join(ptxas), flush=True)

    # Phases 3 and 4: each kernel against its plain version, at the front
    # end's shape and at the batched shape.
    checks = check_kernels({
        "front_end": front_end_kernel_inputs(device),
        "batched": batched_scene(device),
    })

    # Phase 5: the batched matcher, through both kernels.
    correlative_prep_2d.launches = 0
    correlative_scores_2d.launches = 0
    run_batched(device)
    if correlative_prep_2d.launches == 0 or correlative_scores_2d.launches == 0:
        fail("batched matcher did not launch both kernels")

    # Phase 6: the front end, through both kernels on every matched scan.
    correlative_prep_2d.launches = 0
    correlative_scores_2d.launches = 0
    n_matched, latencies, t_err, y_err, builder = run_front_end(device)
    launches = {"correlative_prep_2d": correlative_prep_2d.launches,
                "correlative_scores_2d": correlative_scores_2d.launches}
    if any(v != n_matched for v in launches.values()) or n_matched == 0:
        fail(f"front end: launches {launches} != {n_matched} matched scans")
    if not bool(builder.active_submaps.matching_submap.grid.known.any()):
        fail("front end: the active submap has no known cells")
    if t_err > MAX_TRANSLATION_ERROR or y_err > MAX_YAW_ERROR:
        fail(f"front end: max error {t_err:.5f} m / {y_err:.5f} rad exceeds "
             f"{MAX_TRANSLATION_ERROR:.5f} m / {MAX_YAW_ERROR:.5f} rad")
    lat_ms = np.array(latencies) * 1e3
    print(f"front end: {n_matched} matched scans, launches {launches}; max error {t_err:.5f} m / {y_err:.5f} rad "
          f"(bounds {MAX_TRANSLATION_ERROR:.5f} / {MAX_YAW_ERROR:.5f}); per-scan latency median "
          f"{np.median(lat_ms):.3f} ms, p95 {np.percentile(lat_ms, 95):.3f} ms", flush=True)

    sources = {
        "correlative_prep_2d": ("hectorgrapher_tpu_torch/csrc/correlative_prep_2d.cu",
                                "hectorgrapher_tpu/ops/pallas_prep2d.py:74"),
        "correlative_scores_2d": ("hectorgrapher_tpu_torch/csrc/correlative_scores_2d.cu",
                                  "hectorgrapher_tpu/ops/pallas_corr2d.py:64"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        err, ms, plain_ms = checks[name]["front_end"]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(v[0] for v in checks[name].values()),
            "ms": ms, "plain_ms": plain_ms,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
