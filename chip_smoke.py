#!/usr/bin/env python3
"""Smoke run of hectorgrapher_tpu_torch on one CUDA card.

    python3 chip_smoke.py

    python3 chip_smoke.py --profile-ct 10   # also profile 10 CT front-end scans

Builds the package's CUDA kernels from csrc/, holds each against its plain
PyTorch version at the shapes the main path gives it, and times each
beside its plain version, its library yardstick where one PyTorch call
computes the same gather-sum, and its bound (bound_ms); then drives the
main paths: the batched correlative + Gauss-Newton matcher at B=1024, the 2D
local SLAM front end (LocalTrajectoryBuilder2D) over 60 scans of the
mapping-evaluation circle, the CT window solve on the production-extent
fixture (256^3 / 128^3 TSDF grids), the continuous-time 3D front end
(OptimizingLocalTrajectoryBuilder) over 80 scans at its default options,
one full fast 3D loop-closure match over a 256^3 submap, and the 3D SLAM
path (MapBuilder -> CT front end -> PoseGraph3D: constraint searches and
SPA on the pose graph's worker thread) over an out-and-back drive at the
front end's full width: on TSDF submaps with the serial and with the
batched constraint search (phases 11 and 12), on the default occupancy
submaps with the batched search (phase 13) and on float16 TSDF submaps
(phase 14); then the plain SPA at the production operating point through
its PCG and its Schur path (phase 15), and pure localization of a second
trajectory on phase 14's map with PureLocalizationTrimmer (phase 16). K3
is held to its plain version in each of its modes (TSDF over f32, f16 and
bf16 volumes, and probability; phase 7).
Each phase prints one line; any failure exits non-zero before the last
line. The second-to-last line is a JSON record of the kernels, the last
line a JSON record of the device.

Imports torch, numpy and hectorgrapher_tpu_torch only. Needs one card and
fails when torch.cuda.is_available() is false.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from hectorgrapher_tpu_torch.common import config as cfg
from hectorgrapher_tpu_torch.evaluation.scan_generator import raycast_box_room_3d, raycast_rect_room_2d
from hectorgrapher_tpu_torch.mapping.ct import window_solver
from hectorgrapher_tpu_torch.mapping.ct.builder import OptimizingLocalTrajectoryBuilder
from hectorgrapher_tpu_torch.mapping.ct.window_solver import CtProblem, CtState, CtWeights, solve_ct_window
from hectorgrapher_tpu_torch.evaluation.graph_generator import make_scale_spa_problem
from hectorgrapher_tpu_torch.mapping.grids import grid_nbytes, make_probability_grid, make_tsdf_grid
from hectorgrapher_tpu_torch.mapping.inserters_3d import make_probability_inserter_3d, make_tsdf_inserter_3d
from hectorgrapher_tpu_torch.mapping.inserters_2d import make_probability_inserter_2d
from hectorgrapher_tpu_torch.mapping.local_2d import LocalTrajectoryBuilder2D
from hectorgrapher_tpu_torch.mapping.map_builder import MapBuilder
from hectorgrapher_tpu_torch.mapping.scan_matching import fast_correlative_3d
from hectorgrapher_tpu_torch.mapping.scan_matching.correlative_2d import (
    _window_geometry,
    make_search_window,
    match_correlative_2d_batched,
    prep_inputs,
    prepare_correlative_table,
)
from hectorgrapher_tpu_torch.mapping.scan_matching import gn_3d as gn_3d_module
from hectorgrapher_tpu_torch.mapping.scan_matching.fast_correlative_3d import FastCorrelativeScanMatcher3D
from hectorgrapher_tpu_torch.mapping.scan_matching.gn_2d import (
    match_gn_2d_probability_batched,
    prepare_gn_probability_field,
)
from hectorgrapher_tpu_torch.mapping.scan_matching.interpolated_grid import PreparedProb3D, prepare_grid_3d
from hectorgrapher_tpu_torch.mapping.scan_matching.rotational_histogram import compute_histogram
from hectorgrapher_tpu_torch.ops import _build
from hectorgrapher_tpu_torch.ops.correlative_prep_2d import correlative_prep_2d, correlative_prep_2d_plain
from hectorgrapher_tpu_torch.ops.correlative_scores_2d import correlative_scores_2d, correlative_scores_2d_plain
from hectorgrapher_tpu_torch.mapping.pose_graph import optimization as spa
from hectorgrapher_tpu_torch.mapping.pose_graph import pose_graph as pose_graph_module
from hectorgrapher_tpu_torch.mapping.pose_graph.pose_graph import PoseGraph3D
from hectorgrapher_tpu_torch.mapping.pose_graph.trimmers import PureLocalizationTrimmer
from hectorgrapher_tpu_torch.ops.ct_scan_block import (
    ct_scan_block,
    ct_scan_block_plain,
    ct_scan_block_slots,
    ct_scan_block_slots_plain,
    grid_params,
    grid_slots,
)
from hectorgrapher_tpu_torch.ops.fast_scores_3d import fast_scores_3d, fast_scores_3d_plain
from hectorgrapher_tpu_torch.sensor.types import (
    PointCloud,
    RangeData,
    TimedPointCloud,
    TimedPointCloudData,
    pad_cloud,
    pad_timed_cloud,
)
from hectorgrapher_tpu_torch.sensor.voxel_filter import adaptive_voxel_filter, compact_cloud, voxel_filter
from hectorgrapher_tpu_torch.transform import np_quat as nq
from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3
from hectorgrapher_tpu_torch.transform.rigid import Rigid2, Rigid3

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


def event_ms(fn, reps=20):
    """Median device milliseconds of the one kernel a call of fn()
    launches, by CUDA events around the call while a spin kernel ahead of
    them keeps the stream busy: the host's enqueueing then leaves no gap
    between the events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)  # ~1 ms of spinning, far longer than the host's enqueueing
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps=20, match=None):
    """Mean device milliseconds per call of fn(): the self time of every
    kernel, copy and fill it ran, from torch.profiler's CUDA trace (None
    when it holds none); with `match`, of the one kernel a call launches
    whose name holds it, as the mean over the launches the trace holds.
    Late in a long process the trace misses launches (a line says how
    many); where it holds none, the time is event_ms's, which reads ~0.004
    ms above the trace's at kernel_ab.py's shapes."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if match is None or match in e.key]
    total_us = sum(getattr(e, "self_device_time_total", 0.0) for e in events)
    if match is None:
        return total_us / reps / 1e3 if total_us > 0 else None
    n = sum(e.count for e in events) if total_us > 0 else 0
    if n != reps:
        print(f"device_ms: the trace holds {n} of {reps} launches of {match}"
              + ("; the time is event_ms's" if n == 0 else ""), flush=True)
    return total_us / n / 1e3 if n else event_ms(fn, reps)


def _fmt(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


# The least time a call could take on an H100 SXM (NVIDIA's data sheet):
# HBM3 at 3.35 TB/s, f32 outside the tensor cores at 67 TFLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# f32 operations per masked point of K3, counted from csrc/ct_scan_block.cu:
# 295 for the world point, stencil, quotient rule and dR(q)p/dq, 253 for
# the 18-column projection and the residual, 380 for the 190 products. In
# probability mode the stencil part (two blends, the w*tsd products and
# the quotient rule: 128) becomes one blend, 1 - p and the scaled
# negation (58).
K3_OPS_PER_POINT = 295 + 253 + 380
K3_PROB_OPS_PER_POINT = 295 - 128 + 58 + 253 + 380


def _sectors(idx, element_bytes=4):
    """Distinct 32-byte sectors of the elements at flat indices idx."""
    return int(torch.unique(idx.reshape(-1) // (32 // element_bytes)).numel())


def k3_stencil_cells(grid, points, mask, pose7):
    """Flat indices of the 2x2x2 stencil cells K3 reads in one grid (the
    masked points whose cell lies inside), and the number of masked points."""
    from hectorgrapher_tpu_torch.transform.rigid import quat_rotate

    world = quat_rotate(pose7[:, None, 3:], points) + pose7[:, None, :3]
    base = torch.floor((world - grid.meta.min_corner) / grid.meta.resolution - 0.5).long()
    nx, ny, nz = grid.shape
    inside = ((base >= 0) & (base < torch.tensor([nx - 1, ny - 1, nz - 1], device=base.device))).all(dim=-1)
    b = base[mask & inside]
    offs = torch.tensor([dx * ny * nz + dy * nz + dz for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)],
                        device=b.device)
    return (((b[:, 0] * ny + b[:, 1]) * nz + b[:, 2])[:, None] + offs).reshape(-1), int(mask.sum())


def k4_gather(table, bx, by, bz, valid, cand_t, off_x, off_y, off_z, level, y_shift, grid_shape, cand_base=None):
    """K4's gather-sum written out: flat table indices (C*X*Y*Z, P) int64
    and 0/1 weights of the same shape, f32, where a weight of 1 marks a
    point that counts (fast_scores_3d_plain's cells for all points at once,
    each candidate's rows from its row base)."""
    nx, ny, nz = grid_shape
    span = 1 << level
    nx_l, ny_l = -(-nx // span), table.shape[1]
    t = cand_t.long()
    base = 0 if cand_base is None else cand_base.long()[:, None, None, None]
    ix = bx[t].long()[:, :, None] + off_x[:, None, :]  # (C, P, X)
    iy = by[t].long()[:, :, None] + off_y[:, None, :]
    iz = bz[t].long()[:, :, None] + off_z[:, None, :]
    xz_in = ((ix > -span) & (ix < nx))[..., :, None] & ((iz > -span) & (iz < nz))[..., None, :]  # (C, P, X, Z)
    row = base + (torch.clamp(iz, min=0) // span)[..., None, :] * nx_l + (torch.clamp(ix, min=0) // span)[..., :, None]
    pick = (iy > -span) & (iy < ny) & valid.expand(bx.shape)[t][:, :, None]  # (C, P, Y)
    lane = torch.clamp(iy, 0, ny - 1) // (1 << y_shift)
    idx = row[:, :, :, None, :] * ny_l + lane[:, :, None, :, None]  # (C, P, X, Y, Z)
    keep = xz_in[:, :, :, None, :] & pick[:, :, None, :, None]
    idx = torch.where(keep, idx, 0)
    c, p = idx.shape[:2]
    to_rows = lambda x: x.permute(0, 2, 3, 4, 1).reshape(-1, p).contiguous()
    return to_rows(idx), to_rows(keep.to(torch.float32))


def k2_gather(table, flat, delta_lin, valid, n_groups, gsz, pw, k):
    """K2's gather-sum written out: flat table indices (B*T*d*d, N) int64
    and the valid flags as weights of the same shape, in the table's
    dtype. Table rows are table.shape[1] lanes apart."""
    d = 2 * k + 1
    b, g, n = flat.shape
    j = delta_lin.reshape(b, g, gsz, n).long()
    off = torch.div(j, gsz, rounding_mode="floor") * pw + torch.remainder(j, gsz)
    r = torch.arange(d, device=flat.device)
    lanes = (r[:, None] * pw + r[None, :]).reshape(1, 1, 1, -1, 1)
    idx = (flat.long()[:, :, None, :] * table.shape[1] + off)[:, :, :, None, :] + lanes  # (B, G, gsz, d^2, N)
    weight = (valid > 0).to(table.dtype)[:, None, None, None, :].expand(idx.shape)
    return idx.reshape(-1, n), weight.reshape(-1, n).contiguous()


def _work(kernel, args):
    """(bytes, operations) of one call: each input read once, each output
    written once; of the gathered tables, the distinct 32-byte sectors the
    call's inputs touch; operations as the call's data needs them."""
    if kernel == "correlative_prep_2d":
        params, px, py, ca, sa, n_groups, gsz, margin, ex, ey = args
        (b, n), t = px.shape, ca.shape[1]
        # 2 x (2 mul, 2 add/sub, 1 sub, 1 div) per (match, angle, point).
        return 4 * (params.numel() + px.numel() + py.numel() + ca.numel() + sa.numel() + b * n_groups * n
                    + b * t * n), 12 * b * t * n
    if kernel == "correlative_scores_2d":
        table, flat, delta_lin, valid, n_groups, gsz, pw, k = args
        d, (b, g, n) = 2 * k + 1, flat.shape
        # Whole rows (the table's own stride) of the table rows the valid
        # points name.
        rows = torch.unique(flat[(valid > 0)[:, None, :].expand(b, g, n)].long())
        row_bytes = table.shape[1] * table.element_size()
        first, last = rows * row_bytes // 32, (rows * row_bytes + row_bytes - 1) // 32
        span = int((last - first).max()) + 1 if rows.numel() else 0
        sectors = torch.unique((first[:, None] + torch.arange(span, device=rows.device)).clamp(max=last[:, None]))
        n_valid = int((valid > 0).sum())
        return (32 * sectors.numel() + 4 * (flat.numel() + delta_lin.numel() + valid.numel() + b * g * gsz * d * d),
                g * gsz * d * d * n_valid)
    if kernel in ("ct_scan_block", "ct_scan_block_slots"):
        if kernel == "ct_scan_block":
            hi, lo, hi_pts, hi_mask, lo_pts, lo_mask, pose7, dpose7, hi_scale, lo_scale = args[:10]
            grid_pairs, lanes, table_bytes = [(hi, lo)], [torch.ones_like(hi_mask[:, 0])], 4 * 8
        else:  # the slot table (pointers, parameters) and the slots
            slots, slot, hi_pts, hi_mask, lo_pts, lo_mask, pose7, dpose7, hi_scale, lo_scale = args[:10]
            grid_pairs = list(zip(slots.hi, slots.lo))
            lanes = [slot == d for d in range(len(grid_pairs))]
            table_bytes = slots.ptrs.numel() * 8 + slots.gparams.numel() * 4 + slot.numel() * 4
        c = hi_mask.shape[0]
        nbytes = (4 * (hi_pts.numel() + lo_pts.numel() + pose7.numel() + dpose7.numel() + 2 * c) + table_bytes
                  + hi_mask.numel() + lo_mask.numel() + 4 * c * (18 * 18 + 18 + 1))
        n_masked = 0
        prob = isinstance(grid_pairs[0][0], PreparedProb3D)
        for (hi, lo), lane in zip(grid_pairs, lanes):
            for grid, pts, mask in ((hi, hi_pts, hi_mask), (lo, lo_pts, lo_mask)):
                # Points outside the interior read no cell (TSDF: unknown;
                # probability: the pad taps are constants). The field, or
                # tsd and weight (one layout, f32 or half: two bytes a
                # cell halve the sectors a stencil touches).
                cells, n = k3_stencil_cells(grid, pts[lane], mask[lane], pose7[lane])
                element = 4 if prob else grid.tsd.element_size()
                nbytes += (1 if prob else 2) * 32 * _sectors(cells, element)
                n_masked += n
        return nbytes, (K3_PROB_OPS_PER_POINT if prob else K3_OPS_PER_POINT) * n_masked
    if kernel == "fast_scores_3d":
        table, bx, by, bz, valid, cand_t, off_x, off_y, off_z = args[:9]
        cand_base = args[12] if len(args) > 12 else None
        idx, weight = k4_gather(*args)
        p, rows = bx.shape[1], int(torch.unique(cand_t).numel())
        # The point rows the candidates name: their cells, and their flags
        # where each point row has its own.
        nbytes = (32 * _sectors(idx[weight > 0]) + 12 * p * rows + (p * rows if valid.dim() == 2 else valid.numel())
                  + 4 * (cand_t.numel() + off_x.numel() + off_y.numel() + off_z.numel() + idx.shape[0])
                  + (0 if cand_base is None else 8 * cand_base.numel()))
        return nbytes, int(weight.sum())
    raise ValueError(f"no work model for {kernel}")


def bound_ms(kernel, args):
    """The least time the card could take for one call of `kernel` on
    `args` (its positional arguments): the larger of its bytes over 3.35
    TB/s and its operations over 67 TFLOP/s. Returns (ms, "bytes" or
    "operations", bytes, operations)."""
    nbytes, ops = _work(kernel, args)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def measure(name, label, kernel, plain, args, err, library=None, note="", kernel_name=None):
    """Time one kernel call against its plain version (and the library
    call, where there is one) at one shape, print one line and return the
    record: per call (CUDA events around the call, host gap included) and
    device time (the kernel's own over 100 calls, device_ms: kernels whose
    name holds kernel_name, by default name + "_kernel") beside its
    bound."""
    b_ms, b_by, nbytes, ops = bound_ms(name, args)
    rec = dict(max_abs_err=err, ms=cuda_ms(kernel), plain_ms=cuda_ms(plain),
               device_ms=device_ms(kernel, reps=100, match=kernel_name or f"{name}_kernel"),
               plain_device_ms=device_ms(plain),
               library_ms=None if library is None else cuda_ms(library), bound_ms=b_ms, bound_by=b_by)
    share = "not measured" if rec["device_ms"] is None else f"{100 * b_ms / rec['device_ms']:.1f}% of it"
    lib = "none" if library is None else f"{rec['library_ms']:.4f} ms"
    print(f"{name} {label}{note}: max |d| {err:.3e}; per call kernel {rec['ms']:.4f} ms, plain "
          f"{rec['plain_ms']:.4f} ms, library {lib}; device time kernel {_fmt(rec['device_ms'])}, plain "
          f"{_fmt(rec['plain_device_ms'])}; bound {b_ms * 1e3:.3f} us by {b_by} ({nbytes / 1e6:.3f} MB, "
          f"{ops / 1e6:.3f} Mop), {share}", flush=True)
    return rec


def check_kernels(shapes):
    """Phases 3 and 4: each kernel against its plain version at each shape.
    Returns {kernel: {shape: record}} (see measure)."""
    out = {"correlative_prep_2d": {}, "correlative_scores_2d": {}}
    for label, (grid, clouds, poses, window) in shapes.items():
        k, gsz, half, m, pw, n_th, n_groups = _window_geometry(window)
        args, kw = prep_inputs(grid, clouds, poses, window)
        args = (*args, *(kw[key] for key in ("n_groups", "gsz", "margin", "ex", "ey")))
        flat, dlin = correlative_prep_2d(*args)
        flat_p, dlin_p = correlative_prep_2d_plain(*args)
        torch.cuda.synchronize()
        if not (torch.equal(flat, flat_p) and torch.equal(dlin, dlin_p)):
            bad = int((flat != flat_p).sum() + (dlin != dlin_p).sum())
            fail(f"K1 correlative_prep_2d differs from its plain version at {label}: {bad} outputs")
        b, t_pad, n = dlin.shape
        out["correlative_prep_2d"][label] = measure(
            "correlative_prep_2d", label, lambda: correlative_prep_2d(*args), lambda: correlative_prep_2d_plain(*args),
            args, 0.0, note=f" B={b} T={t_pad} N={n} (library: none, no one PyTorch call floors rotated points "
                            "into cells and their clipped deltas)")

        table = prepare_correlative_table(grid, window)
        valid = clouds.mask.to(torch.float32).contiguous()
        sargs = (table, flat, dlin, valid, n_groups, gsz, pw, k)
        err = check_k2(label, sargs)
        idx, weight = k2_gather(*sargs)  # the library yardstick's inputs, built outside its timing
        flat_table = table.reshape(-1, 1)
        library = lambda: torch.nn.functional.embedding_bag(idx, flat_table, mode="sum", per_sample_weights=weight)
        out["correlative_scores_2d"][label] = measure(
            "correlative_scores_2d", label, lambda: correlative_scores_2d(*sargs),
            lambda: correlative_scores_2d_plain(*sargs), sargs, err, library=library,
            note=f" B={b} G={n_groups} N={n} (library: embedding_bag, the gather-sum only)")
        del idx, weight
    return out


def check_k2(label, sargs, kernel=correlative_scores_2d):
    """K2 (`kernel`) against its plain version on sargs: finite, the same
    bits on two launches, and within 1e-4 * n_valid of the plain version
    per match (f32 sums of at most n_valid bf16 values, each at most 1, in
    another order; exactly 0 where no point is valid). Returns the largest
    difference."""
    got = kernel(*sargs)
    again = kernel(*sargs)
    ref = correlative_scores_2d_plain(*sargs)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        fail(f"K2 correlative_scores_2d returned non-finite values at {label}")
    if not torch.equal(got, again):
        fail(f"K2 correlative_scores_2d differs between two launches at {label}")
    err = (got - ref).abs().amax(dim=(1, 2, 3))  # per match
    n_valid = (sargs[3] > 0).sum(dim=1)
    if bool((err > 1e-4 * n_valid).any()):
        fail(f"K2 correlative_scores_2d differs from its plain version at {label}: max {float(err.max())}")
    return float(err.max())


def _offset(x):
    """A copy of x that is contiguous but starts one element past a 16-byte
    boundary, so that a kernel must take its scalar loads."""
    store = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = store[1:].view(x.shape)
    out.copy_(x)
    return out


def check_k2_cases(device, seed=SEED, kernel=correlative_scores_2d):
    """Phase 4's K2 (`kernel`) cases beyond the main path's two shapes, each
    against the plain version (check_k2): ragged valid counts (not
    multiples of the 64-point tile, one match with none, N = 1001 not a
    multiple of 4) at B=132 and B=4; all 2048 slots valid at B=1; N = 1024
    with every input starting one element past a 16-byte boundary; and
    windows wider than one 128-lane chunk (k = 5: pw^2 = 225 in 232-lane
    rows; k = 8: pw^2 = 441 in 448) on the batched scene through K1."""
    rng = np.random.default_rng(seed)
    grid, clouds, poses, window = batched_scene(device, 64, seed)
    k, gsz, half, m, pw, n_th, n_groups = _window_geometry(window)
    table = prepare_correlative_table(grid, window)
    for label, b, n, ragged in (("ragged", 132, 1001, True), ("ragged", 4, 1001, True), ("all valid", 1, 2048, False),
                                ("misaligned", 8, 1024, True)):
        flat = torch.from_numpy(rng.integers(0, table.shape[0], (b, n_groups, n)).astype(np.int32)).to(device)
        dlin = torch.from_numpy(rng.integers(0, gsz * gsz, (b, n_groups * gsz, n)).astype(np.int32)).to(device)
        counts = rng.integers(1, n + 1, b) if ragged else np.full(b, n)
        if ragged:
            counts[1] = 0
        keep = rng.random((b, n)).argsort(axis=1) < counts[:, None]
        valid = torch.from_numpy(keep.astype(np.float32)).to(device)
        if label == "misaligned":
            flat, dlin, valid = _offset(flat), _offset(dlin), _offset(valid)
        err = check_k2(f"{label} B={b}", (table, flat, dlin, valid, n_groups, gsz, pw, k), kernel)
        print(f"correlative_scores_2d {label} B={b} G={n_groups} N={n}, valid counts {int(counts.min())}.."
              f"{int(counts.max())}: max |d| {err:.3e}, two launches bit-equal", flush=True)
    for k_wide in (5, 8):
        wide = window._replace(num_linear=k_wide)
        k, gsz, half, m, pw, n_th, n_groups = _window_geometry(wide)
        args, kw = prep_inputs(grid, clouds, poses, wide)
        flat, dlin = correlative_prep_2d(*args, **kw)
        table = prepare_correlative_table(grid, wide)
        sargs = (table, flat, dlin, clouds.mask.to(torch.float32).contiguous(), n_groups, gsz, pw, k)
        err = check_k2(f"wide k={k}", sargs, kernel)
        print(f"correlative_scores_2d wide window k={k} pw^2={pw * pw} in {table.shape[1]}-lane rows, B=64 "
              f"G={n_groups}: max |d| {err:.3e}, two launches bit-equal", flush=True)


def check_k1_boundaries(device, seed=SEED):
    """Phase 4's K1 boundary sweep: points placed so that, for one random
    candidate angle each, (w - min) / res lands within a few ulps of an
    integer on both axes; K1 must equal its plain version exactly. At the
    front end's shape (B=64 matches, T=425, N=2048), and on the kernel's
    scalar path: with N = 1001, and with N = 1024 but px and py starting
    one element past a 16-byte boundary."""
    rng = np.random.default_rng(seed)
    res, minx, miny = 0.05, -16.0, -16.0
    for b, n, n_groups, shift in ((64, 2048, 85, False), (3, 1001, 85, False), (3, 1024, 85, True)):
        t_pad = n_groups * 5
        t = rng.uniform(-1.0, 1.0, (b, 2)).astype(np.float32)
        angles = (rng.uniform(-np.pi, np.pi, (b, 1)) + np.linspace(-0.35, 0.35, t_pad)[None]).astype(np.float32)
        ca, sa = np.cos(angles), np.sin(angles)
        pick = rng.integers(0, t_pad, (b, n))
        c = np.take_along_axis(ca, pick, 1).astype(np.float64)
        s_ = np.take_along_axis(sa, pick, 1).astype(np.float64)
        # World points on cell corners, rotated back into the match frame.
        wx = minx + rng.integers(20, 620, (b, n)) * res - t[:, :1]
        wy = miny + rng.integers(20, 620, (b, n)) * res - t[:, 1:]
        px = (c * wx + s_ * wy).astype(np.float32)
        py = (-s_ * wx + c * wy).astype(np.float32)
        steps = rng.integers(-3, 4, (2, b, n))
        for a, st in ((px, steps[0]), (py, steps[1])):
            for k_ in range(1, 4):
                a[:] = np.where(np.abs(st) >= k_, np.nextafter(a, np.where(st > 0, np.inf, -np.inf)), a)
        params = np.zeros((b, 8), np.float32)
        params[:, 0:2], params[:, 2], params[:, 3], params[:, 4] = t, minx, miny, res
        on = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
        args = (on(params), *(_offset(on(a)) if shift else on(a) for a in (px, py)), on(ca), on(sa), n_groups, 5, 7,
                654, 654)
        flat, dlin = correlative_prep_2d(*args)
        flat_p, dlin_p = correlative_prep_2d_plain(*args)
        torch.cuda.synchronize()
        bad = int((flat != flat_p).sum() + (dlin != dlin_p).sum())
        # How close to a cell boundary the picked angle's quotients land.
        qx = ((c.astype(np.float32) * px - s_.astype(np.float32) * py + t[:, :1]) - np.float32(minx)) / np.float32(res)
        near = int((np.abs(qx - np.round(qx)) < 1e-4).sum())
        if bad:
            fail(f"K1 correlative_prep_2d differs from its plain version on the boundary sweep B={b} N={n}: "
                 f"{bad} outputs")
        where = " misaligned" if shift else ""
        print(f"correlative_prep_2d boundary sweep B={b} T={t_pad} N={n}{where}: exact ({near} of {b * n} picked-angle "
              f"x quotients within 1e-4 of an integer)", flush=True)


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


CT_SCANS = 80  # 8 s of the CT front end at 10 Hz
CT_SPEED, CT_YAW_RATE = 0.2, 0.1  # m/s, rad/s
CT_ROOM = (9.5, 7.5, 2.4)  # half extents, m
# CT front-end error bounds. The JAX package's own CT front end on the
# same 80 scans (hectorgrapher_tpu OptimizingLocalTrajectoryBuilder on a
# CPU) ends with a max translation error of 0.52468 m and a max yaw error
# of 0.02423 rad: it drifts behind the truth along the direction of travel
# (ROADMAP C9), so an absolute cap below that cannot hold. The port must
# stay within twice that, and within 0.1 m / 0.01 rad of it. The drift
# compounds tiny differences: the port on the same CPU ends at 0.54487 m /
# 0.02250 rad (one-ulp cell flips, ROADMAP C0), while over the first 1.5 s
# the two agree to 1e-6 m (tests/test_torch_ct_builder.py).
JAX_CT_TRANSLATION_ERROR = 0.52468
JAX_CT_YAW_ERROR = 0.02423
CT_MAX_TRANSLATION_ERROR = 2 * JAX_CT_TRANSLATION_ERROR
CT_MAX_YAW_ERROR = 2 * JAX_CT_YAW_ERROR
CT_PARITY_TRANSLATION, CT_PARITY_YAW = 0.1, 0.01


def ct_production_grids(device, dtype=torch.float32, n_scans=3):
    """Phase 7's maps: the SubmapsOptions3D default grids (hi 256^3 at
    0.1 m, lo 128^3 at 0.45 m, truncation 2.5 cells) with planes stored in
    `dtype`, each filled with the first n_scans of three scans of a 9.5 x
    7.5 x 2.4 m half-extent box room (256 x 48 rays, from three poses) by
    the port's ray-mode inserter, as bench.py:670-696 builds its
    production submap. Returns (hi, lo, the first scan's points)."""
    sub = cfg.SubmapsOptions3D()
    grids, inserters = [], []
    opts = cfg.TSDFRangeDataInserterOptions3D(normal_computation_method="NONE", min_range=0.4, max_range=60.0)
    for res, size, ins in ((sub.high_resolution, sub.high_grid_size, sub.high_resolution_range_data_inserter),
                           (sub.low_resolution, sub.low_grid_size, sub.low_resolution_range_data_inserter)):
        t = ins.tsdf_range_data_inserter
        grids.append(make_tsdf_grid(res, (size,) * 3, t.relative_truncation_distance * res, t.maximum_weight, device,
                                    dtype=dtype))
        inserters.append(make_tsdf_inserter_3d(opts, res))
    first = None
    for pose_t in (np.zeros(3), np.array([1.5, 1.0, 0.0]), np.array([-1.2, 0.8, 0.0]))[:n_scans]:
        pts = raycast_box_room_3d(pose_t, nq.quat_identity(), half_extents=CT_ROOM, num_azimuth=256, num_elevation=48)
        pts = pts[~np.isnan(pts[:, 0])].astype(np.float32)
        rd = RangeData(
            torch.tensor(pose_t, dtype=torch.float32, device=device),
            pad_cloud(pts + pose_t.astype(np.float32), 16384, device),
            pad_cloud(np.zeros((0, 3), np.float32), 4, device),
        )
        grids = [insert(g, rd) for insert, g in zip(inserters, grids)]
        first = pts if first is None else first
    return grids[0], grids[1], first


def ct_production_probability_grids(device, n_scans=3):
    """Phase 7's occupancy maps: the SubmapsOptions3D default grids (hi
    256^3 at 0.1 m, lo 128^3 at 0.45 m), each filled by the default
    occupancy inserters with the first n_scans of ct_production_grids'
    three scans of the phase-9 room, then prepared for K3 (their
    probability fields, prepare_grid_3d). Returns (hi, lo)."""
    sub = cfg.SubmapsOptions3D()
    grids, inserters = [], []
    for res, size, ins in ((sub.high_resolution, sub.high_grid_size, sub.high_resolution_range_data_inserter),
                           (sub.low_resolution, sub.low_grid_size, sub.low_resolution_range_data_inserter)):
        grids.append(make_probability_grid(res, (size,) * 3, device))
        inserters.append(make_probability_inserter_3d(ins.probability_grid_range_data_inserter))
    for pose_t in (np.zeros(3), np.array([1.5, 1.0, 0.0]), np.array([-1.2, 0.8, 0.0]))[:n_scans]:
        pts = raycast_box_room_3d(pose_t, nq.quat_identity(), half_extents=CT_ROOM, num_azimuth=256, num_elevation=48)
        pts = pts[~np.isnan(pts[:, 0])].astype(np.float32)
        rd = RangeData(
            torch.tensor(pose_t, dtype=torch.float32, device=device),
            pad_cloud(pts + pose_t.astype(np.float32), 16384, device),
            pad_cloud(np.zeros((0, 3), np.float32), 4, device),
        )
        grids = [insert(g, rd) for insert, g in zip(inserters, grids)]
    if not all(bool(g.known.any()) for g in grids):
        fail("phase 7: an occupancy grid has no known cells")
    return tuple(prepare_grid_3d(g) for g in grids)


def ct_kernel_inputs(device, hi, lo, scan_pts, c=32, p=256, k=32, seed=SEED, outside=0):
    """K3's inputs at the CT front end's shape: C=32 clouds of P=256 hi-res
    and 256 lo-res points drawn from a scan (the last 32 lo-res points of
    each cloud masked out, as padding), posed between K=32 control points
    perturbed by up to 5 cm / 0.02 rad, with pose7/dpose7 and the scales
    as the window solver computes them, then the grid parameters. With
    c=1, GN3D's shape: one cloud of 256 + 256 points. With `outside`, the
    first `outside` hi-res and lo-res points of each cloud are moved along
    their rays to 40 m, outside both grids."""
    from types import SimpleNamespace

    from hectorgrapher_tpu_torch.transform.rigid import quat_from_axis_angle

    rng = np.random.default_rng(seed)

    def clouds():
        return torch.from_numpy(np.stack([scan_pts[rng.choice(len(scan_pts), p, replace=False)]
                                          for _ in range(c)])).to(device)

    hi_pts, lo_pts = clouds(), clouds()
    for pts in (hi_pts, lo_pts):
        pts[:, :outside] *= 40.0 / torch.linalg.vector_norm(pts[:, :outside], dim=-1, keepdim=True)
    hi_mask = torch.ones((c, p), dtype=torch.bool, device=device)
    lo_mask = hi_mask.clone()
    lo_mask[:, -32:] = False
    aa = torch.from_numpy(rng.uniform(-0.02, 0.02, (k, 3)).astype(np.float32)).to(device)
    state = CtState(
        translation=torch.from_numpy(rng.uniform(-0.05, 0.05, (k, 3)).astype(np.float32)).to(device),
        rotation=quat_from_axis_angle(aa),
        velocity=torch.zeros((k, 3), device=device),
    )
    prev = torch.clamp(torch.arange(c, device=device), max=k - 2)
    brackets = SimpleNamespace(cloud_prev=prev, cloud_next=prev + 1,
                               cloud_factor=torch.full((c,), 0.5, device=device))
    pose7, dpose7 = window_solver.cloud_poses(state, brackets)
    hi_scale = torch.full((c,), 1.0 / math.sqrt(p), device=device)
    lo_scale = torch.full((c,), 1.0 / math.sqrt(p - 32), device=device)
    return (hi, lo, hi_pts, hi_mask, lo_pts, lo_mask, pose7.contiguous(), dpose7.contiguous(), hi_scale, lo_scale,
            grid_params(hi, lo))


def check_ct_scan_block(args, label, timed=True):
    """Phase 7: K3 against its plain version at one shape; args end in the
    grid parameters, which the main path builds once per solve or match.
    Returns measure's record (timed) or the largest difference."""
    got = ct_scan_block(*args[:10], gparams=args[10])
    want = ct_scan_block_plain(*args[:10])
    torch.cuda.synchronize()
    if not all(bool(torch.isfinite(x).all()) for x in got):
        fail(f"K3 ct_scan_block returned non-finite values at {label}")
    S_p = want[0]
    if float(S_p.abs().max()) <= 0.0:
        fail(f"K3 inputs see no observed cells at {label}")
    # Per cloud: sums over 512 points of f32 products in another order
    # than the plain version's matmuls: |delta| <= 1e-4 * max(1, max|S_c|).
    bound = 1e-4 * torch.clamp(S_p.abs().amax(dim=(1, 2)), min=1.0)
    errs = [(got[0] - want[0]).abs().amax(dim=(1, 2)), (got[1] - want[1]).abs().amax(dim=1),
            (got[2] - want[2]).abs()]
    for name, e in zip(("S", "g", "cost"), errs):
        if bool((e > bound).any()):
            fail(f"K3 ct_scan_block {name} differs from its plain version at {label}: max {float(e.max()):.3e}, "
                 f"bound {float(bound.min()):.3e}")
    err = max(float(e.max()) for e in errs)
    hi, lo = args[0], args[1]
    c, p_hi = args[3].shape
    if not timed:
        print(f"ct_scan_block {label} C={c} P={p_hi}+{args[5].shape[1]}: max |d| {err:.3e} (bound "
              f"{float(bound.min()):.3e}..{float(bound.max()):.3e}, per cloud)", flush=True)
        return err
    return measure("ct_scan_block", label, lambda: ct_scan_block(*args[:10], gparams=args[10]),
                   lambda: ct_scan_block_plain(*args[:10]), args, err,
                   note=f" grids {hi.shape[0]}^3/{lo.shape[0]}^3 C={c} P={p_hi}+{args[5].shape[1]} "
                        f"(error bound {float(bound.min()):.3e}..{float(bound.max()):.3e}; library: none, no one "
                        "PyTorch call fuses the grid stencil, the pose Jacobian and J^T J)")


def build_ct_example(device, K=8, C=8, P=256, grid=256, cube=True):
    """__graft_entry__._build_ct_example(grid, cube) rebuilt from the port's
    modules, with the same seeded draws: hi/lo TSDF grids (0.1 m / 0.45 m)
    holding one 128 x 32-ray scan of the default box room, C clouds of P
    points drawn from it, and K control points at 3 cm translation noise.
    Returns (hi, lo, problem, state, weights)."""
    hi_shape = (grid,) * 3 if cube else (grid, grid, grid // 2)
    lo_shape = (grid // 2,) * 3 if cube else (grid // 2, grid // 2, grid // 4)
    hi = make_tsdf_grid(0.1, hi_shape, 0.25, 1000.0, device)
    lo = make_tsdf_grid(0.45, lo_shape, 1.0, 1000.0, device)
    opts = cfg.TSDFRangeDataInserterOptions3D(normal_computation_method="NONE", min_range=0.4, max_range=30.0)
    pts = raycast_box_room_3d(np.zeros(3), nq.quat_identity(), num_azimuth=128, num_elevation=32)
    pts = pts[~np.isnan(pts[:, 0])]
    rd = RangeData(torch.zeros(3, device=device), pad_cloud(pts.astype(np.float32), 4096, device),
                   pad_cloud(np.zeros((0, 3), np.float32), 4, device))
    hi = make_tsdf_inserter_3d(opts, 0.1)(hi, rd)
    lo = make_tsdf_inserter_3d(opts, 0.45)(lo, rd)

    rng = np.random.default_rng(0)
    cloud_pts = np.stack([pts[rng.choice(len(pts), size=P, replace=len(pts) < P)].astype(np.float32)
                          for _ in range(C)])
    point_times = np.broadcast_to(np.linspace(-0.05, 0.049, P, dtype=np.float32)[None, :], (C, P)).copy()
    translation = rng.normal(0, 0.03, (K, 3)).astype(np.float32)
    t = lambda a, dtype=torch.float32: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    ones = lambda *shape: torch.ones(shape, dtype=torch.bool, device=device)
    q_id = lambda n: t(np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1)))
    state = CtState(translation=t(translation), rotation=q_id(K), velocity=t(np.zeros((K, 3))))
    problem = CtProblem(
        cp_mask=ones(K), cp_times=t(np.arange(K, dtype=np.float32) * 0.1),
        cloud_mask=ones(C),
        cloud_prev=t(np.clip(np.arange(C), 0, K - 2), torch.int64),
        cloud_next=t(np.clip(np.arange(C) + 1, 1, K - 1), torch.int64),
        cloud_factor=t(np.full(C, 0.5)), cloud_time=t(np.arange(C, dtype=np.float32) * 0.1 + 0.05),
        hi_points=t(cloud_pts), hi_mask=ones(C, P), hi_times=t(point_times),
        lo_points=t(cloud_pts), lo_mask=ones(C, P), lo_times=t(point_times),
        pair_mask=ones(K - 1), pair_dt=t(np.full(K - 1, 0.1)), imu_delta_rotation=q_id(K - 1),
        imu_delta_velocity=t(np.zeros((K - 1, 3))), imu_delta_translation=t(np.zeros((K - 1, 3))),
        odom_mask=ones(K - 1), odom_delta_translation=t(np.zeros((K - 1, 3))), odom_delta_rotation=q_id(K - 1),
        odom_translation_weight=t(np.full(K - 1, 5.0)), odom_rotation_weight=t(np.full(K - 1, 5.0)),
    )
    weights = CtWeights(*(t(1.0) for _ in range(5)))
    return hi, lo, problem, state, weights


@contextlib.contextmanager
def plain_scan_blocks():
    """Route the window solver's scan blocks through K3's plain version."""
    window_solver.ct_scan_block = lambda *args, gparams=None: ct_scan_block_plain(*args)
    try:
        yield
    finally:
        window_solver.ct_scan_block = ct_scan_block


def run_ct_window(device, reps=20):
    """Phase 8: the window solve of the production-extent fixture (256^3 /
    128^3, K=8, C=8, P=256), 8 LM iterations, through K3 and through its
    plain version. Returns the per-solve times (median, p95) of both."""
    example = build_ct_example(device)
    window_solver.solve_ct_window_block.assemblies = 0
    ct_scan_block.launches = 0
    solve = lambda: solve_ct_window(*example, is_tsdf=True, num_iterations=8)
    state, final, initial = solve()
    if ct_scan_block.launches != window_solver.solve_ct_window_block.assemblies or ct_scan_block.launches == 0:
        fail(f"window solve: {ct_scan_block.launches} K3 launches for "
             f"{window_solver.solve_ct_window_block.assemblies} assemblies")
    with plain_scan_blocks():
        state_p, final_p, initial_p = solve()
    final, initial, final_p, initial_p = (float(x) for x in (final, initial, final_p, initial_p))
    if not (math.isfinite(final) and final <= initial):
        fail(f"window solve: final cost {final} does not lower the initial cost {initial}")
    # The two paths differ only in the scan blocks' summation order; the
    # same LM steps land within 1e-4 of each other.
    d_state = max(float((a - b).abs().max()) for a, b in zip(state, state_p))
    d_cost = abs(final - final_p) / max(abs(final_p), 1e-12)
    if d_state > 1e-4 or d_cost > 1e-4 or abs(initial - initial_p) > 1e-4 * abs(initial_p):
        fail(f"window solve: K3 path differs from the plain path: state {d_state:.3e}, final cost {d_cost:.3e}")

    def timed(n):
        out = []
        for _ in range(n):
            sync(device)
            t0 = time.perf_counter()
            solve()
            sync(device)
            out.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(out)), float(np.percentile(out, 95))

    timed(2)
    med, p95 = timed(reps)
    with plain_scan_blocks():
        med_p, p95_p = timed(reps)
    print(f"window solve 256^3/128^3 K=8 C=8 P=256, 8 iterations: cost {initial:.6f} -> {final:.6f} "
          f"(plain path {final_p:.6f}, state within {d_state:.2e}); per solve median {med:.3f} ms, p95 {p95:.3f} ms "
          f"over {reps}; plain path median {med_p:.3f} ms, p95 {p95_p:.3f} ms", flush=True)
    return med, p95


def ct_options():
    """TrajectoryBuilder3DOptions defaults (256^3/128^3 grids, K=32, C=32,
    P=256, 12 LM iterations, RK4 preintegration, CONSTANT sampling) with
    TSDF submaps, min_range 0.4 and a 0.45 s initialization, as
    tests/test_ct_builder.py and bench.py:874-886 set them."""
    return cfg.replace_deep(cfg.TrajectoryBuilder3DOptions(), {
        "min_range": 0.4,
        "submaps.grid_type": "TSDF",
        "optimizing_local_trajectory_builder.initialization_duration": 0.45,
    })


def ct_truth(t):
    return (np.array([CT_SPEED * t, 0.0, 0.0]), nq.quat_from_axis_angle(np.array([0.0, 0.0, CT_YAW_RATE * t])))


def ct_drive(n_scans, seed=SEED):
    """The CT front end's sensor events in time order: IMU at 100 Hz
    (gravity and the yaw rate in the body frame), odometry at 20 Hz (2 mm
    noise), and n_scans scans at 10 Hz of 96 x 24 rays of the CT_ROOM box
    room, 4 mm range noise, per-point sweep times over [-0.05, 0.049] s,
    while driving at CT_SPEED with CT_YAW_RATE. Yields ("imu", t, acc,
    gyro), ("odom", t, pose) and ("scan", t, data)."""
    gravity = np.array([0.0, 0.0, 9.80665])
    rng = np.random.default_rng(seed)
    t, next_odom, next_scan, n = 0.0, 0.0, 0.05, 0
    while n < n_scans:
        pt, pq = ct_truth(t)
        yield "imu", t, nq.quat_rotate(nq.quat_conjugate(pq), gravity), np.array([0.0, 0.0, CT_YAW_RATE])
        if t >= next_odom:
            yield "odom", t, NpRigid3(pt + rng.normal(0, 0.002, 3), pq)
            next_odom += 0.05
        if t >= next_scan:
            pts = raycast_box_room_3d(pt, pq, half_extents=CT_ROOM, num_azimuth=96, num_elevation=24,
                                      noise_std=0.004, rng=rng)
            pts = pts[~np.isnan(pts[:, 0])]
            times = np.linspace(-0.05, 0.049, len(pts)).astype(np.float32)
            yield "scan", t, TimedPointCloudData(t, np.zeros(3, np.float32), pad_timed_cloud(pts, times, 2560), 96)
            next_scan += 0.1
            n += 1
        t = round(t + 0.01, 6)


@contextlib.contextmanager
def ct_stage_ranges(builder):
    """Label the CT front end's stages for torch.profiler."""
    from torch.profiler import record_function

    from hectorgrapher_tpu_torch.mapping.ct import builder as bmod

    def labelled(fn, name):
        def run(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return run

    patches = [(bmod, "adaptive_voxel_filter_timed", "ct.filter_scan"),
               (bmod, "solve_ct_window", "ct.window_solve"),
               (window_solver, "cloud_poses", "ct.cloud_poses"),
               (window_solver, "pair_residuals", "ct.pair_residuals"),
               (torch.linalg, "solve", "ct.damped_solve"),
               (window_solver, "ct_scan_block", "ct.scan_block_K3"),
               (bmod, "adaptive_voxel_filter", "ct.insert_filters"),
               (bmod, "compute_histogram", "ct.histogram"),
               (builder.active_submaps, "insert_data", "ct.tsdf_insert")]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, label in patches:
        setattr(obj, name, labelled(getattr(obj, name), label))
    try:
        yield
    finally:
        for obj, name, fn in saved:
            if obj is builder.active_submaps:
                delattr(obj, name)
            else:
                setattr(obj, name, fn)


def run_ct_front_end(device, n_scans=CT_SCANS, profile_scans=0):
    """Phase 9: OptimizingLocalTrajectoryBuilder over the CT drive. Returns
    (scans, per-scan seconds from the first window solve on, max
    translation and yaw errors against ground truth, the builder, K3
    launches, solver assemblies). With profile_scans, profiles that many
    more scans afterwards and prints their breakdown."""
    builder = OptimizingLocalTrajectoryBuilder(ct_options(), device)
    window_solver.solve_ct_window_block.assemblies = 0
    ct_scan_block.launches = 0
    latencies, t_err, y_err, n, counts = [], 0.0, 0.0, 0, None
    prof = None
    for kind, t, *payload in ct_drive(n_scans + profile_scans):
        if kind == "imu":
            builder.add_imu_data(t, *payload)
            continue
        if kind == "odom":
            builder.add_odometry_data(t, payload[0])
            continue
        if n == n_scans:
            counts = (ct_scan_block.launches, window_solver.solve_ct_window_block.assemblies)
            prof = profile_ct_start(builder)
        solves = builder.num_optimizations
        t0 = time.perf_counter()
        result = builder.add_range_data(payload[0])
        sync(device)
        n += 1
        if n > n_scans:
            continue
        if solves or builder.num_optimizations > solves:
            latencies.append(time.perf_counter() - t0)
        if result is not None:
            if not np.all(np.isfinite(result.local_pose.t)):
                fail(f"CT front end: no finite pose at t={t:.1f}")
            truth_t, truth_q = ct_truth(result.time)
            t_err = max(t_err, float(np.linalg.norm(result.local_pose.t - truth_t)))
            d = nq.quat_yaw(result.local_pose.q) - nq.quat_yaw(truth_q)
            y_err = max(y_err, abs((d + np.pi) % (2 * np.pi) - np.pi))
    if counts is None:
        counts = (ct_scan_block.launches, window_solver.solve_ct_window_block.assemblies)
    if prof is not None:
        profile_ct_finish(prof, profile_scans)
    return n_scans, latencies, t_err, y_err, builder, counts


def profile_ct_start(builder):
    from torch.profiler import ProfilerActivity, profile

    stages = ct_stage_ranges(builder)
    stages.__enter__()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    return prof, stages, time.perf_counter()


def profile_ct_finish(handle, n_scans):
    """Print the profiled scans' device time, launches per scan, idle share
    and stages; write the full table under chiprun_out/."""
    prof, stages, t0 = handle
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    prof.__exit__(None, None, None)
    stages.__exit__(None, None, None)
    events = prof.key_averages()
    # Stage labels also appear as device-side annotations spanning their
    # kernels: count kernels, copies and fills only.
    device_events = [e for e in events if getattr(e, "self_device_time_total", 0.0) > 0 and not e.key.startswith("ct.")]
    device_ms_total = sum(e.self_device_time_total for e in device_events) / 1e3
    launches = sum(e.count for e in events if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    print(f"CT front end profile, {n_scans} scans: wall {wall_ms:.3f} ms, device {device_ms_total:.3f} ms "
          f"(idle {100 * (1 - device_ms_total / wall_ms):.1f}%), {launches / n_scans:.0f} kernel launches per scan",
          flush=True)
    stages = [e for e in events if e.key.startswith("ct.") and e.cpu_time_total > 0]
    for e in sorted(stages, key=lambda e: -e.cpu_time_total):
        print(f"  stage {e.key}: {e.count / n_scans:.2f} calls/scan, host {e.cpu_time_total / 1e3 / n_scans:.3f} "
              f"ms/scan, device {getattr(e, 'device_time_total', 0.0) / 1e3 / n_scans:.3f} ms/scan", flush=True)
    for e in sorted(device_events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  device {e.key[:80]}: {e.self_device_time_total / 1e3 / n_scans:.3f} ms/scan, "
              f"{e.count / n_scans:.1f}/scan", flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "ct_profile.txt"), "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=60))
        f.write("\n")
        f.write(events.table(sort_by="cpu_time_total", row_limit=60))


FM_TRUTH = (np.array([0.4, -0.3, 0.05]), 0.05)  # phase 10's scan pose: position, yaw
FM_START = np.array([0.1, -0.1, 0.05])  # its initial estimate, at yaw 0


def node_clouds(pts, device):
    """A scan's loop-closure clouds as the CT front end makes them: the
    0.15 m voxel filter, then each adaptive filter, compacted to 256
    points; and its rotational histogram."""
    opts = cfg.TrajectoryBuilder3DOptions()
    cloud = voxel_filter(pad_cloud(pts.astype(np.float32), 4096, device), opts.voxel_filter_size)
    hi = compact_cloud(adaptive_voxel_filter(cloud, opts.high_resolution_adaptive_voxel_filter), 256)
    lo = compact_cloud(adaptive_voxel_filter(cloud, opts.low_resolution_adaptive_voxel_filter), 256)
    return hi, lo, compute_histogram(cloud.positions, cloud.mask, opts.rotational_histogram_size).cpu().numpy()


@contextlib.contextmanager
def score_sums_through(fn):
    """Route the fast matcher's score sums through fn."""
    fast_correlative_3d.fast_scores_3d = fn
    try:
        yield
    finally:
        fast_correlative_3d.fast_scores_3d = fast_scores_3d


def fast_match_submap(device, hi_size=256, lo_size=128):
    """Phase 10's finished submap: the SubmapsOptions3D default grids (hi
    256^3 at 0.1 m, lo 128^3 at 0.45 m), each filled by the ray-mode
    inserter with a 256 x 48-ray scan of the default box room (4 mm range
    noise) from each of three poses, as tests/test_pose_graph_3d_integration.py
    builds its anchor submap; and the scans' summed rotational histogram.
    Without the noise, rays of one azimuth hit the room's axis-aligned walls
    at the same (x, y), and the histogram's tie order, which the card's
    atomic centroid sums decide, moves whole walls between its first and
    last bucket (ROADMAP C11)."""
    sub = cfg.SubmapsOptions3D()
    opts = cfg.TSDFRangeDataInserterOptions3D(normal_computation_method="NONE", min_range=0.4, max_range=30.0)
    grids, inserters = [], []
    for res, size, ins in ((sub.high_resolution, hi_size, sub.high_resolution_range_data_inserter),
                           (sub.low_resolution, lo_size, sub.low_resolution_range_data_inserter)):
        t = ins.tsdf_range_data_inserter
        grids.append(make_tsdf_grid(res, (size,) * 3, t.relative_truncation_distance * res, t.maximum_weight, device))
        inserters.append(make_tsdf_inserter_3d(opts, res))
    hist = np.zeros(120, np.float32)
    rng = np.random.default_rng(SEED + 1)
    for pose_t in (np.zeros(3), np.array([0.4, 0.3, 0.0]), np.array([0.8, -0.3, 0.0])):
        pts = raycast_box_room_3d(pose_t, nq.quat_identity(), num_azimuth=256, num_elevation=48, noise_std=0.004,
                                  rng=rng)
        pts = pts[~np.isnan(pts[:, 0])].astype(np.float32) + pose_t.astype(np.float32)
        cloud = pad_cloud(pts, 16384, device)
        rd = RangeData(torch.tensor(pose_t, dtype=torch.float32, device=device), cloud,
                       pad_cloud(np.zeros((0, 3), np.float32), 4, device))
        grids = [insert(g, rd) for insert, g in zip(inserters, grids)]
        hist += compute_histogram(cloud.positions, cloud.mask, 120).cpu().numpy()
    return grids[0], grids[1], hist


def fast_match_setup(device, hi, lo, hist, max_scan_range=20.0):
    """Phase 10's matcher over the submap (hi, lo, hist) and its match of
    a scan taken at FM_TRUTH from FM_START: (matcher, match())."""
    matcher = FastCorrelativeScanMatcher3D(cfg.FastCorrelativeScanMatcherOptions3D(), hi, lo, hist)
    sync(device)
    truth_t, truth_yaw = FM_TRUTH
    rng = np.random.default_rng(SEED)
    pts = raycast_box_room_3d(truth_t, nq.quat_from_axis_angle(np.array([0.0, 0.0, truth_yaw])), num_azimuth=96,
                              num_elevation=24, noise_std=0.004, rng=rng)
    high, low, scan_hist = node_clouds(pts[~np.isnan(pts[:, 0])], device)
    initial = Rigid3(torch.tensor(FM_START, dtype=torch.float32, device=device),
                     torch.tensor([1.0, 0.0, 0.0, 0.0], device=device))
    return matcher, lambda: matcher.match(initial, high, low, scan_hist, 0.0, max_scan_range=max_scan_range)


def recorded_score_sums(match):
    """Run match() through K4 and return ([(arguments, output)] of each
    score_sum call, the match's result)."""
    calls = []

    def recorded(*a):
        out = fast_scores_3d(*a)
        calls.append((a, out))
        return out

    with score_sums_through(recorded):
        result = match()
    return calls, result


def run_fast_match(device, hi, lo, hist, max_scan_range=20.0, reps=5):
    """Phase 10: K4 against its plain version in one full match of the fast
    3D matcher (FastCorrelativeScanMatcherOptions3D defaults: 8 levels,
    5 m / 1 m / 15 degree window, 256-wide beam) over fast_match_submap's
    production-extent submap, a scan taken at FM_TRUTH matched from
    FM_START. Every score_sum call of the match is held against the plain
    version; the plain path's match must land on the same pose or on a
    tied score. Returns {shape: measure's record} at fast_score_shapes'
    three shapes."""
    t0 = time.perf_counter()
    matcher, match = fast_match_setup(device, hi, lo, hist, max_scan_range)
    build_s = time.perf_counter() - t0
    truth_t, truth_yaw = FM_TRUTH
    calls, (score, low_score, _, pose) = recorded_score_sums(match)
    with score_sums_through(fast_scores_3d_plain):
        score_p, _, _, pose_p = match()
    torch.cuda.synchronize()
    err = 0.0
    for i, (a, out) in enumerate(calls):
        want = fast_scores_3d_plain(*a)
        if not bool(torch.isfinite(out).all()):
            fail("K4 fast_scores_3d returned non-finite values")
        # Sums of at most 256 values below 0.8 in point order, against the
        # plain version's chunks of 32: |delta| <= 1e-5 * max(1, max|sum|).
        e = float((out - want).abs().max())
        if e > 1e-5 * max(1.0, float(want.abs().max())):
            fail(f"K4 fast_scores_3d differs from its plain version at level {a[9]}: max {e:.3e}")
        err = max(err, e)
        calls[i] = (a, out, want)
    score, low_score, score_p = float(score), float(low_score), float(score_p)
    same_pose = (float((pose.translation - pose_p.translation).abs().max()) <= 1e-5
                 and float((pose.rotation - pose_p.rotation).abs().max()) <= 1e-6)
    if not (same_pose or abs(score - score_p) <= 1e-6):
        fail(f"fast match: the K4 path's pose differs from the plain path's and its score {score:.7f} does not "
             f"tie {score_p:.7f}")
    t_err = float(np.linalg.norm(pose.translation.cpu().numpy() - truth_t))
    y_err = abs(nq.quat_yaw(pose.rotation.cpu().numpy().astype(np.float64)) - truth_yaw)
    if t_err > 0.15 or y_err > 0.05 or score < 0.55 or low_score < 0.55:
        fail(f"fast match: pose {t_err:.4f} m / {y_err:.4f} rad from the truth (bounds 0.15 / 0.05), score "
             f"{score:.4f}, low-res score {low_score:.4f} (gates 0.55)")

    stats = {label: measure_fast_scores(label, a, out, want)
             for label, (a, out, want) in fast_score_shapes(calls).items()}

    def timed(fn):
        out = []
        for _ in range(reps):
            sync(device)
            t1 = time.perf_counter()
            fn()
            sync(device)
            out.append((time.perf_counter() - t1) * 1e3)
        return statistics.median(out)

    match_ms = timed(match)
    with score_sums_through(fast_scores_3d_plain):
        match_plain_ms = timed(match)
    print(f"fast match {hi.shape[0]}^3, {len(matcher._pyramid_levels)} levels "
          f"({matcher.pyramid_bytes / 2**20:.1f} MiB, built in {build_s * 1e3:.1f} ms), {len(calls)} score_sum calls: max |d| {err:.3e}; score {score:.5f} "
          f"(plain path {score_p:.5f}, same pose {same_pose}), low-res {low_score:.5f}, error {t_err:.4f} m / "
          f"{y_err:.4f} rad; per match median {match_ms:.3f} ms, plain path {match_plain_ms:.3f} ms", flush=True)
    return stats


def check_fast_scores_chunks(device, seed=SEED):
    """Phase 10's check of K4 where a block loops over chunks of points and
    tiles of outputs (shapes the matcher does not reach at 256 points):
    C=40 candidates x 3 x 5 x 4 offsets over P=1500 seeded points of a
    random 64 x 96 x 48 level-1 table, held against the plain version."""
    rng = np.random.default_rng(seed)
    grid_shape, level, y_shift = (64, 96, 48), 1, 1
    table = rng.uniform(0.0, 0.8, (24 * 32 + 1, 48)).astype(np.float32)
    table[-1] = 0.0
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)
    cells = [i32(rng.integers(-4, n + 4, (9, 1500))) for n in grid_shape]
    a = (torch.from_numpy(table).to(device), *cells, torch.from_numpy(rng.random(1500) < 0.9).to(device),
         i32(rng.integers(0, 9, 40)), *(i32(rng.integers(-6, 7, (40, k))) for k in (3, 5, 4)), level, y_shift,
         grid_shape)
    got, want = fast_scores_3d(*a), fast_scores_3d_plain(*a)
    torch.cuda.synchronize()
    e = float((got - want).abs().max())
    if not bool(torch.isfinite(got).all()) or e > 1e-5 * max(1.0, float(want.abs().max())):
        fail(f"K4 fast_scores_3d differs from its plain version over chunks and tiles: max {e:.3e}")
    print(f"fast_scores_3d chunks and tiles C=40 X=3 Y=5 Z=4 P=1500: max |d| {e:.3e}", flush=True)


def fast_score_shapes(calls):
    """Phase 10's K4 calls at its three shapes: the coarse call, the first
    expansion and the level-0 expansion."""
    return {"coarse": calls[0], "expansion": calls[1], "expansion_level0": calls[-1]}


def measure_fast_scores(label, a, out, want):
    """measure() for one K4 call, with embedding_bag over the same cells as
    its library yardstick."""
    idx, weight = k4_gather(*a)  # the yardstick's inputs, built outside its timing
    flat_table = a[0].reshape(-1, 1)
    library = lambda: torch.nn.functional.embedding_bag(idx, flat_table, mode="sum", per_sample_weights=weight)
    c, x, y, z = out.shape
    return measure("fast_scores_3d", label, lambda: fast_scores_3d(*a), lambda: fast_scores_3d_plain(*a), a,
                   float((out - want).abs().max()), library=library,
                   note=f" level {a[9]} C={c} X={x} Y={y} Z={z} P={a[1].shape[1]} T={a[1].shape[0]} "
                        "(library: embedding_bag, the gather-sum only)")


SLAM_ANCHOR = np.array([-2.6, -2.0, 0.0])  # phase 11's start, world frame
SLAM_SPEED, SLAM_REST, SLAM_OUT = 0.8, 0.6, 3.0  # m/s, s at rest, m out (and back)
# The JAX package's MapBuilder on a CPU over the same drive and options
# (async work queue, serial constraint search), two runs: 70 nodes, 9
# submaps (7 finished), 275 and 270 INTER constraints, 5 optimizations;
# the returning tail's max local error 0.30263 m both times, its max
# global error 0.03966 / 0.04393 m, the median global error 0.02941 /
# 0.03436 m, the max global error 0.19620 / 0.17909 m (the worker thread's
# timing against the front end changes the solves' starting poses). The
# constants are the larger of each pair; the port must stay within twice
# each, or 0.05 m above it.
JAX_SLAM_LATE_GLOBAL, JAX_SLAM_MEDIAN_GLOBAL, JAX_SLAM_MAX_GLOBAL = 0.04393, 0.03436, 0.19620
# Phase 12's: the same drive with the batched constraint search, two runs
# of tests/jax_slam_reference.py --batched on a CPU: 70 nodes, 9 submaps (7
# finished), 283 and 279 INTER constraints; the tail's local error 0.30263
# m both times, its global error 0.03565 / 0.05800 m, the median global
# error 0.02910 / 0.03771 m, the max 0.17575 / 0.16644 m. The larger of
# each pair.
JAX_SLAM12_LATE_GLOBAL, JAX_SLAM12_MEDIAN_GLOBAL, JAX_SLAM12_MAX_GLOBAL = 0.05800, 0.03771, 0.17575
# Phase 13's: the same drive with the batched search on the default
# PROBABILITY_GRID submaps, two runs of tests/jax_slam_reference.py
# --batched --probability on a CPU: 70 nodes, 9 submaps (7 finished), 236
# and 218 INTER constraints; the tail's local error 0.30263 m both times,
# its global error 0.08222 / 0.05621 m (below half the local error: the
# JAX run meets phase 11's loop-closure gate), the median global error
# 0.06135 / 0.05121 m, the max 0.30265 / 0.27505 m (ROADMAP C15: above
# the TSDF runs'). The larger of each pair.
JAX_SLAM13_LATE_GLOBAL, JAX_SLAM13_MEDIAN_GLOBAL, JAX_SLAM13_MAX_GLOBAL = 0.08222, 0.06135, 0.30265
# Phase 14's: phase 12's drive and options with grid_storage_dtype
# "float16", two runs of tests/jax_slam_reference.py --batched --storage
# float16 on a CPU: 70 nodes, 9 submaps (7 finished), 287 and 266 INTER
# constraints; the tail's local error 0.30263 m both times, its global
# error 0.04274 / 0.03928 m, the median global error 0.03090 / 0.02765 m,
# the max 0.16993 / 0.18697 m. The larger of each pair.
JAX_SLAM14_LATE_GLOBAL, JAX_SLAM14_MEDIAN_GLOBAL, JAX_SLAM14_MAX_GLOBAL = 0.04274, 0.03090, 0.18697
ROUND_PARITY_ROUNDS = 3  # phase 12's rounds re-run through the serial path


def slam_overrides(batched=False, probability=False, storage=None):
    """Phase 11's options as replace_deep overrides of MapBuilderOptions:
    tests/test_map_builder_3d.py loop_options() (over make_options()) at
    the CT front end's full width (256^3 / 128^3 grids, K=32, C=32, P=256,
    12 LM iterations), with the async work queue; the serial constraint
    search, or with `batched` the default batched one (phase 12). With
    `probability` (phase 13) the submaps keep their default grid_type,
    PROBABILITY_GRID, in place of TSDF. With `storage` (phase 14:
    "float16") the TSDF submaps store their planes in that dtype, and a
    later trajectory searches the first one's submaps in full on every
    node (global_sampling_ratio 1) under the local searches' score gate
    (0.45 in place of 0.6: in this box room a right full-submap match
    scores 0.50-0.55 at 96^3 on the CPU, local ones 0.40-0.58); both only
    bear on phase 16's second trajectory, as one trajectory searches
    locally. Plain values, so that tests/jax_slam_reference.py applies
    them to the JAX package's options."""
    ct = "trajectory_builder_3d.optimizing_local_trajectory_builder."
    fm = "pose_graph.constraint_builder.fast_correlative_scan_matcher_3d."
    overrides = {
        "use_trajectory_builder_3d": True,
        "trajectory_builder_3d.min_range": 0.4,
        "trajectory_builder_3d.max_range": 25.0,
        "trajectory_builder_3d.submaps.grid_type": "TSDF",
        "trajectory_builder_3d.submaps.high_grid_size": 256,
        "trajectory_builder_3d.submaps.low_grid_size": 128,
        "trajectory_builder_3d.submaps.num_range_data": 8,
        "trajectory_builder_3d.motion_filter.max_distance_meters": 0.02,
        "trajectory_builder_3d.motion_filter.max_angle_radians": 0.002,
        "trajectory_builder_3d.motion_filter.max_time_seconds": 0.05,
        ct + "initialization_duration": 0.45,
        ct + "max_control_points": 32,
        ct + "max_clouds_in_window": 32,
        ct + "points_per_cloud": 256,
        ct + "max_num_iterations": 12,
        ct + "odometry_translation_weight": 50.0,
        ct + "odometry_rotation_weight": 50.0,
        ct + "high_resolution_grid_weight": 0.05,
        ct + "low_resolution_grid_weight": 0.05,
        "pose_graph.optimize_every_n_nodes": 16,
        "pose_graph.async_work_queue": True,
        "pose_graph.use_batched_constraint_search": batched,
        "pose_graph.constraint_builder.sampling_ratio": 1.0,
        "pose_graph.constraint_builder.max_constraint_distance": 8.0,
        "pose_graph.constraint_builder.min_score": 0.45,
        fm + "linear_xy_search_window": 2.0,
        fm + "linear_z_search_window": 0.4,
        fm + "branch_and_bound_depth": 4,
        fm + "min_rotational_score": 0.2,
        fm + "min_low_resolution_score": 0.45,
    }
    if probability:
        del overrides["trajectory_builder_3d.submaps.grid_type"]
    if storage is not None:
        overrides["trajectory_builder_3d.submaps.grid_storage_dtype"] = storage
        overrides["pose_graph.global_sampling_ratio"] = 1.0
        overrides["pose_graph.constraint_builder.global_localization_min_score"] = 0.45
    return overrides


def slam_options(batched=False, probability=False, storage=None):
    """slam_overrides(batched, probability, storage) applied to the port's
    MapBuilderOptions."""
    return cfg.replace_deep(cfg.MapBuilderOptions(), slam_overrides(batched, probability, storage))


def slam_truth(t):
    """Phase 11's true position in the map frame (the start is its origin):
    rest, drive +x SLAM_OUT at SLAM_SPEED, drive back."""
    s = max(0.0, t - SLAM_REST)
    t_out = SLAM_OUT / SLAM_SPEED
    return np.array([SLAM_SPEED * s if s <= t_out else SLAM_OUT - SLAM_SPEED * min(s - t_out, t_out), 0.0, 0.0])


def slam_drive(seed=1):
    """tests/test_map_builder_3d.py's out-and-back drive in time order: IMU
    at 100 Hz, odometry at 20 Hz with a +x bias growing 0.1 m/s over t in
    [2, 5] s and 2 mm noise, and 10 Hz scans of 96 x 24 rays of the default
    box room with 4 mm range noise. Yields ("imu", t, acc, gyro), ("odom",
    t, pose) and ("scan", t, data)."""
    gravity = np.array([0.0, 0.0, 9.80665])
    rng = np.random.default_rng(seed)
    duration = SLAM_REST + 2 * SLAM_OUT / SLAM_SPEED
    t, next_odom, next_scan = 0.0, 0.0, 0.05
    while t <= duration:
        yield "imu", t, gravity, np.zeros(3)
        pt = SLAM_ANCHOR + slam_truth(t)
        if t >= next_odom:
            bias = np.array([0.1 * np.clip(t - 2.0, 0.0, 3.0), 0.0, 0.0])
            yield "odom", t, NpRigid3(pt + bias + rng.normal(0, 0.002, 3), nq.quat_identity())
            next_odom += 0.05
        if t >= next_scan:
            pts = raycast_box_room_3d(pt, nq.quat_identity(), num_azimuth=96, num_elevation=24, noise_std=0.004,
                                      rng=rng)
            pts = pts[~np.isnan(pts[:, 0])]
            yield "scan", t, TimedPointCloudData(t, np.zeros(3, np.float32),
                                                 pad_timed_cloud(pts, np.zeros(len(pts), np.float32), 2560), 96)
            next_scan += 0.1
        t = round(t + 0.01, 6)


def timed_method(obj, name, times, errors):
    """Wrap obj.name to append its host seconds to `times` (each call ends
    in a device readback) and any exception to `errors`."""
    fn = getattr(obj, name)

    def run(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        except Exception as e:
            errors.append(f"{name}: {e!r}")
            raise
        finally:
            times.append(time.perf_counter() - t0)

    setattr(obj, name, run)


def round_parity(pg, gated, global_search, results):
    """Re-run each candidate of a batched round through the serial path
    (the class's own _compute_constraint, past run_slam's wrappers) at the
    round's scan range: the same gate outcome, zbar within 1e-3 m and |1 -
    |dq0|| < 1e-6 (tests/test_batched_constraint_path.py:324-326). Returns
    (ok, largest translation and quaternion differences, K4 launches)."""
    k4 = fast_scores_3d.launches
    scan_range = max(pg._scan_range_bucket(n) for _, _, n, _ in gated)
    pg._scan_range_bucket = lambda node: scan_range
    try:
        serial = [PoseGraph3D._compute_constraint(pg, node, p, global_search=global_search) for _, _, node, p in gated]
    finally:
        del pg._scan_range_bucket
    ok, dt, dq = True, 0.0, 0.0
    for a, b in zip(results, serial):
        if (a is None) != (b is None):
            ok = False
        elif a is not None:
            dt = max(dt, float(np.linalg.norm(a.zbar.t - b.zbar.t)))
            dq = max(dq, 1.0 - abs(float(nq.quat_multiply(nq.quat_conjugate(a.zbar.q), b.zbar.q)[0])))
    return ok and dt <= 1e-3 and dq < 1e-6, dt, dq, fast_scores_3d.launches - k4


def probe_batched_rounds(pg, rounds, errors, recorded):
    """Wrap pg._compute_constraints_batched to append each round's record
    to `rounds` (candidates, seconds ending in the refinement's readback,
    K4 and slotted K3 launches, LAST_ROUND_BREAKDOWN), any exception to
    `errors`, and the first ROUND_PARITY_ROUNDS rounds' serial re-run
    (round_parity); each record keeps its round's candidates (rounds_alone).
    The first round of >= 4 candidates over >= 2 submaps
    whose scans differ in valid counts has its K4 calls appended to
    `recorded` as (arguments, output)."""
    fn = pg._compute_constraints_batched

    def run(gated, global_search=False):
        k4, k3 = fast_scores_3d.launches, ct_scan_block_slots.launches
        record = (not recorded and len(gated) >= 4 and len({sid for _, sid, _, _ in gated}) >= 2
                  and len({int(n.high_cloud.mask.sum()) for _, _, n, _ in gated}) >= 2)
        t0 = time.perf_counter()
        try:
            if record:
                with score_sums_through(lambda *a: recorded.append((a, fast_scores_3d(*a))) or recorded[-1][1]):
                    results = fn(gated, global_search=global_search)
            else:
                results = fn(gated, global_search=global_search)
            rec = dict(n=len(gated), s=time.perf_counter() - t0, k4=fast_scores_3d.launches - k4,
                       k3=ct_scan_block_slots.launches - k3, stages=dict(pose_graph_module.LAST_ROUND_BREAKDOWN),
                       found=sum(r is not None for r in results), parity=None, gated=list(gated),
                       global_search=global_search)
            if sum(r["parity"] is not None for r in rounds) < ROUND_PARITY_ROUNDS:
                rec["parity"] = round_parity(pg, gated, global_search, results)
        except Exception as e:
            errors.append(f"_compute_constraints_batched: {e!r}")
            raise
        rounds.append(rec)
        return results

    pg._compute_constraints_batched = run


def run_slam(device, options=None, drive=None, rounds=None, recorded=None):
    """Phase 11: MapBuilder 3D -> TrajectoryBuilder -> CT front end ->
    PoseGraph3D over the out-and-back drive, the constraint searches and
    SPA solves on the pose graph's worker thread, then the final
    optimization. Returns a dict of the run's counts, errors, times, the
    pose graph, the local builder and the MapBuilder. With `rounds` (phase
    12), probes the batched rounds (probe_batched_rounds) into it and
    `recorded`."""
    mb = MapBuilder(options or slam_options(), device=device)
    tb = mb.get_trajectory_builder(mb.add_trajectory_builder())
    pg = mb.pose_graph
    searches, solves, errors = [], [], []
    timed_method(pg, "_compute_constraint", searches, errors)
    timed_method(pg, "_run_optimization", solves, errors)
    timed_method(pg, "_on_submap_finished", [], errors)
    if rounds is not None:
        probe_batched_rounds(pg, rounds, errors, recorded)
    latencies = []
    t_start = time.perf_counter()
    for kind, t, *payload in drive or slam_drive():
        if kind == "imu":
            tb.add_imu_data(t, *payload)
        elif kind == "odom":
            tb.add_odometry_data(t, payload[0])
        else:
            solved = tb._local.num_optimizations
            t0 = time.perf_counter()
            tb.add_range_data(payload[0])
            sync(device)
            if solved:
                latencies.append(time.perf_counter() - t0)
    front_s = time.perf_counter() - t_start
    pg.wait_for_all_computations()
    drain_s = time.perf_counter() - t_start - front_s
    n_solves = len(solves)
    return dict(slam_result(pg), optimizations=n_solves, errors=errors, latencies=latencies, searches=searches,
                solves=solves, front_s=front_s, drain_s=drain_s, pose_graph=pg, local_builder=tb._local,
                map_builder=mb)


def slam_result(pg):
    """The drive's counts and errors from a drained pose graph of either
    package: the returning tail's open-loop (local) error, then, after the
    final optimization, the tail's, the median and the largest global
    error against slam_truth."""
    late = pg.nodes[-max(4, len(pg.nodes) // 4):]
    local_errs = [float(np.linalg.norm(n.local_pose.t - slam_truth(n.time))) for n in late]
    n_inter = sum(c.tag == "INTER" for c in pg.constraints)
    pg.run_final_optimization()
    global_errs = [float(np.linalg.norm(n.global_pose.t - slam_truth(n.time))) for n in pg.nodes]
    return dict(
        nodes=len(pg.nodes), submaps=len(pg.submaps), finished=sum(s.finished for s in pg.submaps), inter=n_inter,
        late_local=max(local_errs), late_global=max(global_errs[-len(late):]),
        median_global=float(np.median(global_errs)), max_global=max(global_errs),
        finite=all(np.all(np.isfinite(n.global_pose.t)) for n in pg.nodes),
    )


def check_k4_round(calls):
    """Phase 12's K4 gate on one batched round's recorded calls (>= 4
    candidates over >= 2 packed submaps, scans of different valid counts):
    the coarse call and the first expansion, each within 1e-5 * max(1,
    max|sum|) of its plain version, and bit-equal to one K4 call per
    candidate against its own submap's block of the stacked table. Returns
    {shape: measure's record}."""
    stats = {}
    for label, (a, out) in (("round_coarse", calls[0]), ("round_expansion", calls[1])):
        table, bx, by, bz, valid, cand_t, off_x, off_y, off_z, level, y_shift, grid_shape, cand_base = a
        want = fast_scores_3d_plain(*a)
        span = 1 << level
        rows = -(-grid_shape[2] // span) * -(-grid_shape[0] // span) + 1
        singles = torch.cat([
            fast_scores_3d(table[base:base + rows], bx, by, bz, valid, cand_t[k:k + 1], off_x[k:k + 1],
                           off_y[k:k + 1], off_z[k:k + 1], level, y_shift, grid_shape)
            for k, base in enumerate(cand_base.tolist())])
        torch.cuda.synchronize()
        e = float((out - want).abs().max())
        if not bool(torch.isfinite(out).all()) or e > 1e-5 * max(1.0, float(want.abs().max())):
            fail(f"K4 fast_scores_3d with row bases differs from its plain version at {label}: max {e:.3e}")
        if not torch.equal(out, singles):
            fail(f"K4 fast_scores_3d with row bases is not bit-equal to one call per candidate at {label}")
        n_sub = len(set((cand_base // rows).tolist()))
        idx, weight = k4_gather(*a)  # the yardstick's inputs, built outside its timing
        flat_table = table.reshape(-1, 1)
        library = lambda: torch.nn.functional.embedding_bag(idx, flat_table, mode="sum", per_sample_weights=weight)
        c, x, y, z = out.shape
        stats[label] = measure("fast_scores_3d", label, lambda: fast_scores_3d(*a), lambda: fast_scores_3d_plain(*a),
                               a, e, library=library,
                               note=f" level {level} C={c} X={x} Y={y} Z={z} P={bx.shape[1]} R={bx.shape[0]} over "
                                    f"{n_sub} packed submaps, bit-equal to {c} single calls (library: embedding_bag, "
                                    "the gather-sum only)")
        del idx, weight
    return stats


def k3_slots_inputs(pg, device, lanes=(0, 1, 2, 0)):
    """K3's slotted inputs from a drained SLAM pose graph: the first three
    finished submaps' 256^3 / 128^3 grids, and per lane a node inserted
    into its submap, posed in the submap's frame with GN3D's Jacobian and
    scales (the lanes of a packed GN3D run)."""
    from hectorgrapher_tpu_torch.transform.rigid import quat_left_matrix

    subs = [i for i, s in enumerate(pg.submaps) if s.finished][:3]
    grids = [pg.submaps[i].submap.prepared_grids() for i in subs]
    slots = grid_slots([hi for hi, _ in grids], [lo for _, lo in grids])
    intra = {}
    for c in pg.constraints:
        if c.tag == "INTRA":
            intra.setdefault(c.submap_index, []).append(c.node_index)
    cm = pg._options.constraint_builder.ceres_scan_matcher_3d
    nodes, poses = [], []
    for k, d in enumerate(lanes):
        node = pg.nodes[intra[subs[d]][k]]
        pose, _ = pg._node_in_grid(node, pg.submaps[subs[d]])
        nodes.append(node)
        poses.append(np.concatenate([pose.translation, pose.rotation]))
    f32 = dict(dtype=torch.float32, device=device)
    pose7 = torch.tensor(np.stack(poses), **f32)
    dpose7 = torch.zeros((len(lanes), 7, 18), **f32)
    dpose7[:, :3, :3] = torch.eye(3, **f32)
    dpose7[:, 3:, 3:6] = 0.5 * quat_left_matrix(pose7[:, 3:])[:, :, 1:]
    hi_pts, hi_mask = (torch.stack([getattr(n.high_cloud, f) for n in nodes]) for f in ("positions", "mask"))
    lo_pts, lo_mask = (torch.stack([getattr(n.low_cloud, f) for n in nodes]) for f in ("positions", "mask"))
    s_hi = cm.occupied_space_weight_0 / torch.sqrt(hi_mask.sum(dim=1).clamp(min=1).to(torch.float32))
    s_lo = cm.occupied_space_weight_1 / torch.sqrt(lo_mask.sum(dim=1).clamp(min=1).to(torch.float32))
    return (slots, torch.tensor(lanes, dtype=torch.int32, device=device), hi_pts, hi_mask, lo_pts, lo_mask, pose7,
            dpose7, s_hi, s_lo)


def check_k3_slots(args, label="gn3d_packed"):
    """Phase 12's K3 gate (and phase 7's in probability mode): the slotted
    kernel on >= 4 lanes over 3 distinct 256^3 / 128^3 grid pairs, one
    repeated, within 1e-4 * max(1, max|S_c|) per cloud of its plain
    version and bit-equal to one unslotted call per lane. Returns
    measure's record."""
    slots, slot = args[0], args[1]
    got = ct_scan_block_slots(*args)
    want = ct_scan_block_slots_plain(*args)
    singles = [ct_scan_block(slots.hi[d], slots.lo[d], *(x[k:k + 1] for x in args[2:]),
                             gparams=slots.gparams[d]) for k, d in enumerate(slot.tolist())]
    torch.cuda.synchronize()
    if not all(bool(torch.isfinite(x).all()) for x in got) or float(want[0].abs().max()) <= 0.0:
        fail(f"K3 ct_scan_block_slots returned non-finite values, or its lanes see no observed cells at {label}")
    bound = 1e-4 * torch.clamp(want[0].abs().amax(dim=(1, 2)), min=1.0)
    errs = [(got[0] - want[0]).abs().amax(dim=(1, 2)), (got[1] - want[1]).abs().amax(dim=1), (got[2] - want[2]).abs()]
    if any(bool((e > bound).any()) for e in errs):
        fail(f"K3 ct_scan_block_slots differs from its plain version at {label}: max "
             f"{max(float(e.max()) for e in errs):.3e}")
    for k, one in enumerate(singles):
        if not all(torch.equal(a[k:k + 1], b) for a, b in zip(got, one)):
            fail(f"K3 ct_scan_block_slots lane {k} is not bit-equal to one call against its grids at {label}")
    err = max(float(e.max()) for e in errs)
    c, p_hi = args[3].shape
    return measure("ct_scan_block_slots", label, lambda: ct_scan_block_slots(*args),
                   lambda: ct_scan_block_slots_plain(*args), args, err, kernel_name="ct_scan_block_kernel",
                   note=f" C={c} lanes over {len(slots.hi)} distinct 256^3/128^3 grid pairs (slots {slot.tolist()}), "
                        f"P={p_hi}+{args[5].shape[1]}, bit-equal to {c} single calls (library: none)")


ROUND_STAGES = ("pack", "initials", "cand_build", "fm_launch", "fm_readback", "gn_prepare", "gn_launch",
                "gn_readback")


def stage_medians(stages):
    """Median ms of each ROUND_STAGES stage over LAST_ROUND_BREAKDOWN records."""
    return {k: float(np.median([s.get(k, 0.0) for s in stages])) * 1e3 for k in ROUND_STAGES}


def rounds_alone(pg, rounds):
    """Phase 12's rounds again once the drive has drained (no front end;
    the nodes at their final poses): each round batched (the class's own
    _compute_constraints_batched, ROUND_PROFILING on), then its candidates
    serially at the round's scan range (round_parity), each timed to its
    readback. Returns (batched ms, serial ms, stage records, parity records),
    one entry a round."""
    batched_ms, serial_ms, stages, parity = [], [], [], []
    pose_graph_module.ROUND_PROFILING = True
    try:
        for r in rounds:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = PoseGraph3D._compute_constraints_batched(pg, r["gated"], global_search=r["global_search"])
            t1 = time.perf_counter()
            stages.append(dict(pose_graph_module.LAST_ROUND_BREAKDOWN))
            parity.append(round_parity(pg, r["gated"], r["global_search"], results))
            batched_ms.append((t1 - t0) * 1e3)
            serial_ms.append((time.perf_counter() - t1) * 1e3)
    finally:
        pose_graph_module.ROUND_PROFILING = False
    return np.array(batched_ms), np.array(serial_ms), stages, parity


def run_phase_12(device, slam, k4_serial, options=None):
    """Phase 12: run_slam over phase 11's drive with the default batched
    constraint search (slam_options(batched=True), or `options`): K4 once
    per pyramid level for a whole round, K3 once per LM iteration of the
    round's packed GN3D; ROUND_PROFILING on for the whole phase. Gates the
    rounds, the fallbacks, the launches, the errors against the JAX
    package's batched run and the rounds' serial parity, prints the
    phase's lines beside phase 11's latency (`slam`, whose K4 launches were
    k4_serial), then holds K4 with row bases and K3 with slots to their
    plain versions (check_k4_round, check_k3_slots). Last, it re-runs the
    rounds with the card otherwise idle, batched and serially
    (rounds_alone), and prints their times. Returns (K4 launches by path,
    packed K3 launches, {kernel: {shape: measure's record}}, (per-scan
    latencies, ms per round, the finished submaps' grid bytes))."""
    fast_correlative_3d.match_fast_3d.score_sums = 0
    fast_scores_3d.launches = 0
    ct_scan_block.launches = 0
    ct_scan_block_slots.launches = 0
    window_solver.solve_ct_window_block.assemblies = 0
    rounds, recorded = [], []
    pose_graph_module.ROUND_PROFILING = True
    slam12 = run_slam(device, options or slam_options(batched=True), rounds=rounds, recorded=recorded)
    pose_graph_module.ROUND_PROFILING = False
    k4_12, score_sums12, k3_packed = (fast_scores_3d.launches, fast_correlative_3d.match_fast_3d.score_sums,
                                      ct_scan_block_slots.launches)
    pg12 = slam12.pop("pose_graph")
    del slam12["local_builder"], slam12["map_builder"]
    parity = [r["parity"] for r in rounds if r["parity"] is not None]
    k4_parity = sum(p[3] for p in parity)
    k4_paths = {"slam_serial": k4_serial, "slam_batched": k4_12 - k4_parity}
    if slam12["errors"]:
        fail(f"SLAM batched: pose-graph work failed: {slam12['errors'][:3]}")
    if not rounds or max(r["n"] for r in rounds) < 2 or pg12.batched_fallbacks:
        fail(f"SLAM batched: {len(rounds)} batched rounds, {pg12.batched_fallbacks} fallbacks to the serial path")
    if k4_12 != score_sums12 or score_sums12 == 0 or k3_packed == 0:
        fail(f"SLAM batched: {k4_12} K4 launches for {score_sums12} score_sum calls, {k3_packed} packed K3 launches")
    if not slam12["finite"] or slam12["inter"] == 0:
        fail(f"SLAM batched: {slam12['inter']} INTER constraints, finite {slam12['finite']}")
    if not slam12["late_global"] < slam12["late_local"] / 2:
        fail(f"SLAM batched: the returning tail's global error {slam12['late_global']:.5f} m is not below half its "
             f"open-loop error {slam12['late_local']:.5f} m")
    for key, jax_err in (("late_global", JAX_SLAM12_LATE_GLOBAL), ("median_global", JAX_SLAM12_MEDIAN_GLOBAL),
                         ("max_global", JAX_SLAM12_MAX_GLOBAL)):
        if slam12[key] > max(2 * jax_err, jax_err + 0.05):
            fail(f"SLAM batched: {key} error {slam12[key]:.5f} m exceeds max(2 x, +0.05 m) of the JAX package's "
                 f"batched {jax_err:.5f}")
    if not parity or not all(p[0] for p in parity):
        fail(f"SLAM batched: round parity with the serial path failed: {[p[:3] for p in parity]}")
    if not recorded:
        fail("SLAM batched: no round of >= 4 candidates over >= 2 submaps with different valid counts to hold K4 to")
    n_cand = [r["n"] for r in rounds]
    round_ms = np.array([r["s"] for r in rounds]) * 1e3
    lat12, lat11 = np.array(slam12["latencies"]) * 1e3, np.array(slam["latencies"]) * 1e3
    stages = stage_medians([r["stages"] for r in rounds])
    print(f"SLAM 3D batched: {slam12['nodes']} nodes, {slam12['submaps']} submaps ({slam12['finished']} finished), "
          f"{slam12['inter']} INTER constraints; {len(rounds)} batched rounds, candidates per round median "
          f"{np.median(n_cand):.1f}, max {max(n_cand)}; fallbacks {pg12.batched_fallbacks}; per round median "
          f"{np.median(round_ms):.3f} ms, p95 {np.percentile(round_ms, 95):.3f} ms, "
          f"{round_ms.sum() / sum(n_cand):.3f} ms per candidate; K4 launches {k4_12} = score_sum calls "
          f"{score_sums12} ({k4_parity} of them the parity re-runs), per round median "
          f"{np.median([r['k4'] for r in rounds]):.0f}; packed K3 launches {k3_packed}, serial "
          f"{ct_scan_block.launches - window_solver.solve_ct_window_block.assemblies} besides the CT assemblies; "
          f"{len(parity)} rounds re-run serially at the round's scan range: max |dt| "
          f"{max(p[1] for p in parity):.3e} m, max 1-|dq0| {max(p[2] for p in parity):.3e}; pack "
          f"{pg12._pack3d['bytes'] / 2**20:.1f} MiB over {len(pg12._pack3d['order'])} submaps; returning tail local "
          f"{slam12['late_local']:.5f} m, global {slam12['late_global']:.5f} m; global median "
          f"{slam12['median_global']:.5f} m, max {slam12['max_global']:.5f} m (JAX batched on the CPU "
          f"{JAX_SLAM12_LATE_GLOBAL:.5f} / {JAX_SLAM12_MEDIAN_GLOBAL:.5f} / {JAX_SLAM12_MAX_GLOBAL:.5f}); per-scan "
          f"latency median {np.median(lat12):.3f} ms, p95 {np.percentile(lat12, 95):.3f} ms over {len(lat12)} scans "
          f"(phase 11 in this run: {np.median(lat11):.3f} / {np.percentile(lat11, 95):.3f} ms); drive "
          f"{slam12['front_s']:.1f} s, queue drained {slam12['drain_s']:.1f} s after", flush=True)
    print("SLAM 3D batched round stages (LAST_ROUND_BREAKDOWN, ROUND_PROFILING on for the whole phase), median ms: "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()), flush=True)
    shapes = {"fast_scores_3d": check_k4_round(recorded),
              "ct_scan_block": {"gn3d_packed": check_k3_slots(k3_slots_inputs(pg12, device))}}
    alone_ms, serial_ms, alone_stages, alone_parity = rounds_alone(pg12, rounds)
    print(f"SLAM 3D batched rounds re-run after the drive (no front end, final poses): {len(rounds)} rounds, "
          f"{sum(n_cand)} candidates; batched per round median {np.median(alone_ms):.3f} ms, p95 "
          f"{np.percentile(alone_ms, 95):.3f} ms, {alone_ms.sum() / sum(n_cand):.3f} ms per candidate; the same "
          f"candidates serially per round median {np.median(serial_ms):.3f} ms, p95 "
          f"{np.percentile(serial_ms, 95):.3f} ms, {serial_ms.sum() / sum(n_cand):.3f} ms per candidate; "
          f"{sum(not p[0] for p in alone_parity)} rounds off the serial results (max |dt| "
          f"{max(p[1] for p in alone_parity):.3e} m, max 1-|dq0| {max(p[2] for p in alone_parity):.3e}); stage "
          "medians ms: " + ", ".join(f"{k} {v:.3f}" for k, v in stage_medians(alone_stages).items()), flush=True)
    grid_bytes = [grid_nbytes(s.submap.high_resolution_grid) + grid_nbytes(s.submap.low_resolution_grid)
                  for s in pg12.submaps if s.finished]
    return k4_paths, k3_packed, shapes, (slam12["latencies"], round_ms, grid_bytes)


@contextlib.contextmanager
def counted_gn3d_blocks(counts):
    """Count GN3D's K3 calls by form: counts["serial"] (match_gn_3d, one
    cloud) and counts["packed"] (match_gn_3d_packed, one slotted call per
    LM iteration), at gn_3d's own call sites."""
    single, slotted = gn_3d_module.ct_scan_block, gn_3d_module.ct_scan_block_slots

    def count(key, fn):
        def run(*a, **kw):
            counts[key] += 1
            return fn(*a, **kw)
        return run

    gn_3d_module.ct_scan_block = count("serial", single)
    gn_3d_module.ct_scan_block_slots = count("packed", slotted)
    try:
        yield counts
    finally:
        gn_3d_module.ct_scan_block, gn_3d_module.ct_scan_block_slots = single, slotted


def reset_k3_counts():
    """Zero K3's launch counts, in all and by mode, on both entries."""
    for wrapper in (ct_scan_block, ct_scan_block_slots):
        wrapper.launches = wrapper.prob_launches = wrapper.f16_launches = wrapper.bf16_launches = 0


def run_phase_13(device, slam12_latencies, round12_ms):
    """Phase 13: run_slam over phase 11's drive with phase 12's options
    (the batched search) and the default submaps (PROBABILITY_GRID), at
    full width; phases 12 and 13 differ only in the grid. Every K3 launch
    is in probability mode: the CT assemblies, serial GN3D (rounds of one
    and the parity re-runs) and packed GN3D. Gates the launches, the work
    queue, the fallbacks, the matching submap's known cells, the loop
    closure and the errors against the JAX package's run on the same
    drive (JAX_SLAM13_*); prints its latency and ms per round beside phase
    12's. Phase 12's idle re-runs are not repeated. Returns the K3 and K4
    launches by path."""
    fast_correlative_3d.match_fast_3d.score_sums = 0
    fast_scores_3d.launches = 0
    reset_k3_counts()
    window_solver.solve_ct_window_block.assemblies = 0
    rounds, recorded = [], []
    options = slam_options(batched=True, probability=True)
    if options.trajectory_builder_3d.submaps.grid_type != "PROBABILITY_GRID":
        fail("SLAM occupancy: the default submaps are not PROBABILITY_GRID")
    with counted_gn3d_blocks({"serial": 0, "packed": 0}) as gn3d:
        slam13 = run_slam(device, options, rounds=rounds, recorded=recorded)
    pg13, local = slam13.pop("pose_graph"), slam13.pop("local_builder")
    del slam13["map_builder"]
    assemblies = window_solver.solve_ct_window_block.assemblies
    k3 = ct_scan_block.launches + ct_scan_block_slots.launches
    k3_prob = ct_scan_block.prob_launches + ct_scan_block_slots.prob_launches
    k4, score_sums = fast_scores_3d.launches, fast_correlative_3d.match_fast_3d.score_sums
    paths = {"slam13_front_end": assemblies, "slam13_gn3d": gn3d["serial"], "slam13_gn3d_packed": gn3d["packed"]}
    if slam13["errors"]:
        fail(f"SLAM occupancy: pose-graph work failed: {slam13['errors'][:3]}")
    if k3_prob != k3 or k3_prob != assemblies + gn3d["serial"] + gn3d["packed"] or assemblies == 0 or gn3d["packed"] == 0:
        fail(f"SLAM occupancy: K3 launches {k3} ({k3_prob} in probability mode) for {paths}")
    if k4 != score_sums or score_sums == 0:
        fail(f"SLAM occupancy: {k4} K4 launches for {score_sums} score_sum calls")
    if not rounds or max(r["n"] for r in rounds) < 2 or pg13.batched_fallbacks:
        fail(f"SLAM occupancy: {len(rounds)} batched rounds, {pg13.batched_fallbacks} fallbacks to the serial path")
    submap = local.active_submaps.matching_submap
    if submap is None or not bool(submap.high_resolution_grid.known.any()):
        fail("SLAM occupancy: the matching submap has no known cells")
    if not slam13["finite"] or slam13["inter"] == 0:
        fail(f"SLAM occupancy: {slam13['inter']} INTER constraints, finite {slam13['finite']}")
    if not slam13["late_global"] < slam13["late_local"] / 2:
        fail(f"SLAM occupancy: the returning tail's global error {slam13['late_global']:.5f} m is not below half its "
             f"open-loop error {slam13['late_local']:.5f} m")
    for key, jax_err in (("late_global", JAX_SLAM13_LATE_GLOBAL), ("median_global", JAX_SLAM13_MEDIAN_GLOBAL),
                         ("max_global", JAX_SLAM13_MAX_GLOBAL)):
        if slam13[key] > max(2 * jax_err, jax_err + 0.05):
            fail(f"SLAM occupancy: {key} error {slam13[key]:.5f} m exceeds max(2 x, +0.05 m) of the JAX package's "
                 f"{jax_err:.5f}")
    parity = [r["parity"] for r in rounds if r["parity"] is not None]
    if not parity or not all(p[0] for p in parity):
        fail(f"SLAM occupancy: round parity with the serial path failed: {[p[:3] for p in parity]}")
    n_cand = [r["n"] for r in rounds]
    round_ms = np.array([r["s"] for r in rounds]) * 1e3
    lat13, lat12 = np.array(slam13["latencies"]) * 1e3, np.array(slam12_latencies) * 1e3
    print(f"SLAM 3D occupancy (PROBABILITY_GRID, batched): {slam13['nodes']} nodes, {slam13['submaps']} submaps "
          f"({slam13['finished']} finished), {slam13['inter']} INTER constraints; {len(rounds)} batched rounds, "
          f"candidates per round median {np.median(n_cand):.1f}, max {max(n_cand)}; fallbacks "
          f"{pg13.batched_fallbacks}; per round median {np.median(round_ms):.3f} ms, p95 "
          f"{np.percentile(round_ms, 95):.3f} ms (phase 12 in this run: {np.median(round12_ms):.3f} / "
          f"{np.percentile(round12_ms, 95):.3f} ms); K3 launches {k3}, all in probability mode = {assemblies} CT "
          f"assemblies + {gn3d['serial']} serial GN3D + {gn3d['packed']} packed GN3D; K4 launches {k4} = score_sum "
          f"calls {score_sums}; {len(parity)} rounds re-run serially: max |dt| {max(p[1] for p in parity):.3e} m, "
          f"max 1-|dq0| {max(p[2] for p in parity):.3e}; returning tail local {slam13['late_local']:.5f} m, global "
          f"{slam13['late_global']:.5f} m; global median {slam13['median_global']:.5f} m, max "
          f"{slam13['max_global']:.5f} m (JAX on the CPU {JAX_SLAM13_LATE_GLOBAL:.5f} / {JAX_SLAM13_MEDIAN_GLOBAL:.5f} / "
          f"{JAX_SLAM13_MAX_GLOBAL:.5f}); per-scan latency median {np.median(lat13):.3f} ms, p95 "
          f"{np.percentile(lat13, 95):.3f} ms over {len(lat13)} scans (phase 12 in this run: {np.median(lat12):.3f} / "
          f"{np.percentile(lat12, 95):.3f} ms); drive {slam13['front_s']:.1f} s, queue drained "
          f"{slam13['drain_s']:.1f} s after", flush=True)
    return paths, {"slam13_batched": k4}


def run_phase_14(device, slam12_latencies, round12_ms, grid_bytes12):
    """Phase 14: run_slam over phase 11's drive with phase 12's options
    (TSDF submaps, the batched search) and grid_storage_dtype "float16",
    at full width. Every K3 launch is in its f16 mode: the CT assemblies,
    serial GN3D (rounds of one and the parity re-runs) and packed GN3D.
    Gates the launches, the work queue, the fallbacks, the finished
    submaps' planes and bytes (half of phase 12's per submap), the loop
    closure and the errors against the JAX package's run on the same
    options (JAX_SLAM14_*); prints its latency and ms per round beside
    phase 12's. Returns (K3 launches by path, K4 launches by path, the
    MapBuilder, the run's error list), for phase 16."""
    fast_correlative_3d.match_fast_3d.score_sums = 0
    fast_scores_3d.launches = 0
    reset_k3_counts()
    window_solver.solve_ct_window_block.assemblies = 0
    rounds, recorded = [], []
    options = slam_options(batched=True, storage="float16")
    with counted_gn3d_blocks({"serial": 0, "packed": 0}) as gn3d:
        slam14 = run_slam(device, options, rounds=rounds, recorded=recorded)
    pg14, mb14 = slam14.pop("pose_graph"), slam14.pop("map_builder")
    del slam14["local_builder"]
    assemblies = window_solver.solve_ct_window_block.assemblies
    k3 = ct_scan_block.launches + ct_scan_block_slots.launches
    k3_f16 = ct_scan_block.f16_launches + ct_scan_block_slots.f16_launches
    k4, score_sums = fast_scores_3d.launches, fast_correlative_3d.match_fast_3d.score_sums
    paths = {"slam14_front_end": assemblies, "slam14_gn3d": gn3d["serial"], "slam14_gn3d_packed": gn3d["packed"]}
    if slam14["errors"]:
        fail(f"SLAM float16: pose-graph work failed: {slam14['errors'][:3]}")
    if k3_f16 != k3 or k3_f16 != assemblies + gn3d["serial"] + gn3d["packed"] or assemblies == 0 or gn3d["packed"] == 0:
        fail(f"SLAM float16: K3 launches {k3} ({k3_f16} in f16 mode) for {paths}")
    if k4 != score_sums or score_sums == 0:
        fail(f"SLAM float16: {k4} K4 launches for {score_sums} score_sum calls")
    if not rounds or max(r["n"] for r in rounds) < 2 or pg14.batched_fallbacks:
        fail(f"SLAM float16: {len(rounds)} batched rounds, {pg14.batched_fallbacks} fallbacks to the serial path")
    finished = [s.submap for s in pg14.submaps if s.finished]
    grid_bytes = [grid_nbytes(s.high_resolution_grid) + grid_nbytes(s.low_resolution_grid) for s in finished]
    if not finished or any(g.dtype != torch.float16 for s in finished for grid in (s.high_resolution_grid,
                                                                                   s.low_resolution_grid)
                           for g in (grid.tsd, grid.weight)):
        fail("SLAM float16: no finished submap, or a finished submap holds planes other than f16")
    if len(grid_bytes) != len(grid_bytes12) or set(2 * b for b in grid_bytes) != set(grid_bytes12):
        fail(f"SLAM float16: finished submaps' grid bytes {grid_bytes} are not half of phase 12's {grid_bytes12}")
    if not slam14["finite"] or slam14["inter"] == 0:
        fail(f"SLAM float16: {slam14['inter']} INTER constraints, finite {slam14['finite']}")
    if not slam14["late_global"] < slam14["late_local"] / 2:
        fail(f"SLAM float16: the returning tail's global error {slam14['late_global']:.5f} m is not below half its "
             f"open-loop error {slam14['late_local']:.5f} m")
    for key, jax_err in (("late_global", JAX_SLAM14_LATE_GLOBAL), ("median_global", JAX_SLAM14_MEDIAN_GLOBAL),
                         ("max_global", JAX_SLAM14_MAX_GLOBAL)):
        if slam14[key] > max(2 * jax_err, jax_err + 0.05):
            fail(f"SLAM float16: {key} error {slam14[key]:.5f} m exceeds max(2 x, +0.05 m) of the JAX package's "
                 f"{jax_err:.5f}")
    parity = [r["parity"] for r in rounds if r["parity"] is not None]
    if not parity or not all(p[0] for p in parity):
        fail(f"SLAM float16: round parity with the serial path failed: {[p[:3] for p in parity]}")
    n_cand = [r["n"] for r in rounds]
    round_ms = np.array([r["s"] for r in rounds]) * 1e3
    lat14, lat12 = np.array(slam14["latencies"]) * 1e3, np.array(slam12_latencies) * 1e3
    print(f"SLAM 3D float16 (TSDF, grid_storage_dtype float16, batched): {slam14['nodes']} nodes, "
          f"{slam14['submaps']} submaps ({slam14['finished']} finished), {slam14['inter']} INTER constraints; "
          f"{len(rounds)} batched rounds, candidates per round median {np.median(n_cand):.1f}, max {max(n_cand)}; "
          f"fallbacks {pg14.batched_fallbacks}; per round median {np.median(round_ms):.3f} ms, p95 "
          f"{np.percentile(round_ms, 95):.3f} ms (phase 12 in this run: {np.median(round12_ms):.3f} / "
          f"{np.percentile(round12_ms, 95):.3f} ms); K3 launches {k3}, all in f16 mode = {assemblies} CT "
          f"assemblies + {gn3d['serial']} serial GN3D + {gn3d['packed']} packed GN3D; K4 launches {k4} = score_sum "
          f"calls {score_sums}; finished submaps' grids {grid_bytes[0] / 1e6:.3f} MB each (phase 12: "
          f"{grid_bytes12[0] / 1e6:.3f} MB) over {len(grid_bytes)} submaps; pack "
          f"{pg14._pack3d['bytes'] / 2**20:.1f} MiB; {len(parity)} rounds re-run serially: max |dt| "
          f"{max(p[1] for p in parity):.3e} m, max 1-|dq0| {max(p[2] for p in parity):.3e}; returning tail local "
          f"{slam14['late_local']:.5f} m, global {slam14['late_global']:.5f} m; global median "
          f"{slam14['median_global']:.5f} m, max {slam14['max_global']:.5f} m (JAX on the CPU "
          f"{JAX_SLAM14_LATE_GLOBAL:.5f} / {JAX_SLAM14_MEDIAN_GLOBAL:.5f} / {JAX_SLAM14_MAX_GLOBAL:.5f}); per-scan "
          f"latency median {np.median(lat14):.3f} ms, p95 {np.percentile(lat14, 95):.3f} ms over {len(lat14)} scans "
          f"(phase 12 in this run: {np.median(lat12):.3f} / {np.percentile(lat12, 95):.3f} ms); drive "
          f"{slam14['front_s']:.1f} s, queue drained {slam14['drain_s']:.1f} s after", flush=True)
    return paths, {"slam14_batched": k4}, mb14, slam14["errors"]


def device_kernels(fn):
    """(fn(), kernels on the device trace of the call) by torch.profiler
    (copies and fills not counted); late in a long process the trace can
    miss launches, so the count is a floor."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith(("Memcpy", "Memset")))
    return out, n


SPA_SCALE = dict(num_nodes=5000, num_submaps=500, num_constraints=20000, noise=0.5, seed=0)


def run_phase_15(device, reps=3, num_iterations=10):
    """Phase 15: the plain SPA at the reference's production operating
    point (tests/test_spa_scale.py: 5000 nodes, 500 submaps, 20000
    constraints, 0.5 m noise), solve_spa_3d with "auto" (S*N = 2.5e6 above
    the Schur budget: the PCG path) and with the Schur path on the same
    problem. Gates: node and submap errors to the truth below 0.01 m on
    both, the PCG within 5e-3 m of the Schur path on every node
    (tests/test_spa_cg.py), final costs below 1. Prints ms per solve
    (median over `reps` after one checked solve), PCG iterations per LM
    step, kernels and host syncs a solve."""
    problem, t_gt, s_gt = make_scale_spa_problem(**SPA_SCALE, device=device)
    out, stats = {}, {}
    for solver in ("auto", "schur"):
        result, kernels = device_kernels(lambda: spa.solve_spa_3d(problem, num_iterations=num_iterations,
                                                                  linear_solver=solver))
        stats[solver] = dict(spa.LAST_SOLVE_STATS, kernels=kernels)
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            spa.solve_spa_3d(problem, num_iterations=num_iterations, linear_solver=solver)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        stats[solver]["ms"] = statistics.median(times)
        st, _, nt, _, cost = (x.cpu().numpy() for x in result)
        out[solver] = nt
        node_err, sub_err = (float(np.linalg.norm(a - b, axis=1).max()) for a, b in ((nt, t_gt), (st, s_gt)))
        stats[solver].update(node_err=node_err, submap_err=sub_err, cost=float(cost))
        if not (node_err < 0.01 and sub_err < 0.01 and float(cost) < 1.0):
            fail(f"SPA scale ({solver}): node error {node_err:.3e} m, submap error {sub_err:.3e} m, cost {float(cost)}")
    if stats["auto"]["linear_solver"] != "cg" or stats["schur"]["linear_solver"] != "schur":
        fail(f"SPA scale: auto took {stats['auto']['linear_solver']!r} above the Schur budget")
    gap = float(np.abs(out["auto"] - out["schur"]).max())
    if not gap < 5e-3:
        fail(f"SPA scale: the PCG path is {gap:.3e} m off the Schur path")
    line = "; ".join(
        f"{name}: {s['ms']:.3f} ms per solve (median of {reps}), {s['lm_iterations']} LM steps"
        + (f", PCG iterations per step {s['cg_iterations']}" if s["cg_iterations"] else "")
        + f", {s['kernels']} kernels and {s['host_syncs']} host syncs a solve, node error {s['node_err']:.3e} m, "
        f"submap error {s['submap_err']:.3e} m, cost {s['cost']:.3e}"
        for name, s in (("PCG (auto)", stats["auto"]), ("Schur", stats["schur"])))
    print(f"SPA scale (N={SPA_SCALE['num_nodes']}, S={SPA_SCALE['num_submaps']}, C={SPA_SCALE['num_constraints']}, "
          f"{num_iterations} LM iterations): {line}; PCG vs Schur max |dt| {gap:.3e} m", flush=True)
    return stats


def packed_ids(pose_graph):
    """The submap ids the batched search's pack holds, in its order or its
    host cache."""
    pack = pose_graph._pack3d
    return set() if pack is None else set(pack["order"]) | set(pack["host"])


class RecordingTrimmer(PureLocalizationTrimmer):
    """A PureLocalizationTrimmer that records, at each trim, how many
    submaps its trajectory keeps, which ids it trimmed, and the trimmed
    ids the pack still holds right after."""

    def __init__(self, trajectory_id, max_submaps_to_keep):
        super().__init__(trajectory_id, max_submaps_to_keep)
        self.kept, self.trimmed, self.held, self.packs_dropped = [], set(), set(), 0

    def trim(self, pose_graph):
        own = lambda: {s.submap_id for s in pose_graph.submaps if s.trajectory_id == self.trajectory_id}
        before, had_pack = own(), pose_graph._pack3d is not None
        super().trim(pose_graph)
        after = own()
        self.kept.append(len(after))
        self.trimmed |= before - after
        self.held |= packed_ids(pose_graph) & (before - after)
        self.packs_dropped += had_pack and pose_graph._pack3d is None


def run_phase_16(device, mb, errors, seconds=4.5):
    """Phase 16: pure localization on phase 14's finished map. Trajectory
    0 is finished and frozen; a second trajectory drives the first
    `seconds` of the same route (another noise seed) with
    PureLocalizationTrimmer(1, max_submaps_to_keep=3) in
    pose_graph.trimmers. Gates: after every optimization the trajectory
    holds at most 3 submaps and some were trimmed, INTER constraints tie
    its nodes to trajectory 0's submaps, no work item failed, a trim
    dropped a pack that held a trimmed submap, and neither the pack nor
    its host cache holds a trimmed id, right after each trim or at the
    end. Returns K3's f16 launches in the phase."""
    pg = mb.pose_graph
    mb.finish_trajectory(0)
    pg.freeze_trajectory(0)
    k3 = ct_scan_block.f16_launches + ct_scan_block_slots.f16_launches
    tid = mb.add_trajectory_builder()
    trimmer = RecordingTrimmer(tid, 3)
    pg.trimmers.append(trimmer)
    timed_method(pg, "_compute_constraints_for_node", [], errors)
    tb = mb.get_trajectory_builder(tid)
    t0 = time.perf_counter()
    for kind, t, *payload in slam_drive(seed=2):
        if t > seconds:
            break
        if kind == "imu":
            tb.add_imu_data(t, *payload)
        elif kind == "odom":
            tb.add_odometry_data(t, payload[0])
        else:
            tb.add_range_data(payload[0])
    pg.wait_for_all_computations()
    pg.run_final_optimization()
    wall = time.perf_counter() - t0
    with pg._lock:
        own = [s for s in pg.submaps if s.trajectory_id == tid]
        inter = sum(c.tag == "INTER" and pg.nodes[c.node_index].trajectory_id == tid
                    and pg.submaps[c.submap_index].trajectory_id == 0 for c in pg.constraints)
        nodes = sum(n.trajectory_id == tid for n in pg.nodes)
    pack = pg._pack3d
    held = trimmer.held | (packed_ids(pg) & trimmer.trimmed)
    if errors:
        fail(f"pure localization: pose-graph work failed: {errors[:3]}")
    if not trimmer.kept or max(trimmer.kept) > 3 or not trimmer.trimmed or len(own) > 3:
        fail(f"pure localization: the trajectory kept {trimmer.kept} submaps after its optimizations "
             f"({len(own)} now), trimmed {sorted(trimmer.trimmed)}")
    if inter == 0:
        fail(f"pure localization: no INTER constraint from trajectory {tid} to trajectory 0's submaps")
    if held or not trimmer.packs_dropped:
        fail(f"pure localization: the pack holds trimmed submaps {sorted(held)}, or no trim dropped a pack "
             f"({trimmer.packs_dropped})")
    k3 = ct_scan_block.f16_launches + ct_scan_block_slots.f16_launches - k3
    print(f"pure localization (trajectory {tid} on phase 14's frozen map, PureLocalizationTrimmer keeping 3): "
          f"{nodes} nodes over {seconds} s, {inter} INTER constraints to trajectory 0's submaps; submaps kept after "
          f"each of {len(trimmer.kept)} optimizations {trimmer.kept}, trimmed ids {sorted(trimmer.trimmed)}, packs "
          f"dropped {trimmer.packs_dropped}; pack at the end {'none' if pack is None else sorted(pack['order'])}; "
          f"{pg.batched_fallbacks} fallbacks; K3 f16 "
          f"launches {k3}; {wall:.1f} s", flush=True)
    return k3


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile-ct", type=int, default=0, metavar="N",
                        help="after phase 9, profile N more CT front-end scans with torch.profiler")
    args = parser.parse_args()

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
    check_k1_boundaries(device)
    check_k2_cases(device)

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

    # Phase 7: K3 against its plain version at the CT front end's shape
    # and at GN3D's.
    # Every f32 matmul and solve of the CT path runs at full precision (C2).
    if torch.get_float32_matmul_precision() != "highest" or torch.backends.cuda.matmul.allow_tf32:
        fail("f32 matmuls are not at full precision")
    hi, lo, scan_pts = ct_production_grids(device)
    checks["ct_scan_block"] = {
        "front_end": check_ct_scan_block(ct_kernel_inputs(device, hi, lo, scan_pts), "front_end"),
        "gn3d": check_ct_scan_block(ct_kernel_inputs(device, hi, lo, scan_pts, c=1), "gn3d"),
    }
    # A block loops over chunks of points only past 512 points a cloud.
    check_ct_scan_block(ct_kernel_inputs(device, hi, lo, scan_pts, c=4, p=1024), "chunks", timed=False)
    del hi, lo
    # K3's probability mode on occupancy maps of the same scans, the same
    # shapes, 16 points of each cloud outside both grids (the pad taps);
    # slotted over three grid pairs (three, two and one scans inserted).
    pairs = [ct_production_probability_grids(device, n) for n in (3, 2, 1)]
    hi, lo = pairs[0]
    checks["ct_scan_block"].update({
        "prob_front_end": check_ct_scan_block(ct_kernel_inputs(device, hi, lo, scan_pts, outside=16),
                                              "prob_front_end"),
        "prob_gn3d": check_ct_scan_block(ct_kernel_inputs(device, hi, lo, scan_pts, c=1, outside=16), "prob_gn3d"),
    })
    check_ct_scan_block(ct_kernel_inputs(device, hi, lo, scan_pts, c=4, p=1024, outside=16), "prob_chunks",
                        timed=False)
    a = ct_kernel_inputs(device, hi, lo, scan_pts, c=4, outside=16)
    slots = grid_slots([h for h, _ in pairs], [l for _, l in pairs])
    checks["ct_scan_block"]["prob_gn3d_packed"] = check_k3_slots(
        (slots, torch.tensor([0, 1, 2, 0], dtype=torch.int32, device=device), *a[2:10]), "prob_gn3d_packed")
    if ct_scan_block.prob_launches == 0 or ct_scan_block_slots.prob_launches == 0:
        fail("phase 7: K3 did not launch in probability mode")
    del hi, lo, pairs, slots, a
    # K3's f16 and bf16 TSDF modes: maps of the same scans filled by the
    # half inserter, the same shapes and tolerance as the f32 rows;
    # slotted over three grid pairs (three, two and one scans inserted).
    for dtype, tag in ((torch.float16, "f16"), (torch.bfloat16, "bf16")):
        pairs = [ct_production_grids(device, dtype, n)[:2] for n in (3, 2, 1)]
        hi, lo = pairs[0]
        if hi.tsd.dtype != dtype or not bool((hi.weight > 0).any()):
            fail(f"phase 7: the {tag} maps hold {hi.tsd.dtype} planes or no observed cell")
        checks["ct_scan_block"].update({
            f"{tag}_front_end": check_ct_scan_block(ct_kernel_inputs(device, hi, lo, scan_pts), f"{tag}_front_end"),
            f"{tag}_gn3d": check_ct_scan_block(ct_kernel_inputs(device, hi, lo, scan_pts, c=1), f"{tag}_gn3d"),
        })
        a = ct_kernel_inputs(device, hi, lo, scan_pts, c=4)
        slots = grid_slots([h for h, _ in pairs], [l for _, l in pairs])
        checks["ct_scan_block"][f"{tag}_gn3d_packed"] = check_k3_slots(
            (slots, torch.tensor([0, 1, 2, 0], dtype=torch.int32, device=device), *a[2:10]), f"{tag}_gn3d_packed")
        del hi, lo, pairs, slots, a
    if not all((ct_scan_block.f16_launches, ct_scan_block.bf16_launches, ct_scan_block_slots.f16_launches,
                ct_scan_block_slots.bf16_launches)):
        fail("phase 7: K3 did not launch in its f16 and bf16 modes")

    # Phase 8: the window solve on the production-extent fixture.
    run_ct_window(device)

    # Phase 9: the CT front end, through K3 on every assembly.
    n_scans, ct_lat, ct_t_err, ct_y_err, ct_builder, (k3_launches, assemblies) = run_ct_front_end(
        device, profile_scans=args.profile_ct)
    launches["ct_scan_block"] = k3_launches
    if k3_launches != assemblies or k3_launches == 0:
        fail(f"CT front end: {k3_launches} K3 launches for {assemblies} solver assemblies")
    submap = ct_builder.active_submaps.matching_submap
    if submap is None or int((submap.high_resolution_grid.weight > 0).sum()) == 0:
        fail("CT front end: the matching submap has no observed cells")
    if ct_t_err > CT_MAX_TRANSLATION_ERROR or ct_y_err > CT_MAX_YAW_ERROR:
        fail(f"CT front end: max error {ct_t_err:.5f} m / {ct_y_err:.5f} rad exceeds "
             f"{CT_MAX_TRANSLATION_ERROR:.5f} m / {CT_MAX_YAW_ERROR:.5f} rad")
    if (abs(ct_t_err - JAX_CT_TRANSLATION_ERROR) > CT_PARITY_TRANSLATION
            or abs(ct_y_err - JAX_CT_YAW_ERROR) > CT_PARITY_YAW):
        fail(f"CT front end: max error {ct_t_err:.5f} m / {ct_y_err:.5f} rad is not within "
             f"{CT_PARITY_TRANSLATION} m / {CT_PARITY_YAW} rad of the JAX front end's")
    lat_ms = np.array(ct_lat) * 1e3
    print(f"CT front end: {n_scans} scans, {ct_builder.num_optimizations} window solves "
          f"({ct_builder.num_optimizations / n_scans:.2f} per scan), K3 launches {k3_launches} = assemblies "
          f"{assemblies}; max error {ct_t_err:.5f} m / {ct_y_err:.5f} rad (JAX on the CPU "
          f"{JAX_CT_TRANSLATION_ERROR:.5f} / {JAX_CT_YAW_ERROR:.5f}, bounds {CT_MAX_TRANSLATION_ERROR:.5f} / "
          f"{CT_MAX_YAW_ERROR:.5f}); per-scan latency median {np.median(lat_ms):.3f} ms, "
          f"p95 {np.percentile(lat_ms, 95):.3f} ms over {len(lat_ms)} scans", flush=True)

    # Phase 10: K4 against its plain version in a full fast match over a
    # production-extent submap.
    checks["fast_scores_3d"] = run_fast_match(device, *fast_match_submap(device))
    check_fast_scores_chunks(device)

    # Phase 11: the 3D SLAM path, through K4 on every score sum of every
    # constraint search, and K3 on every CT assembly and GN3D evaluation.
    fast_correlative_3d.match_fast_3d.score_sums = 0
    fast_scores_3d.launches = 0
    ct_scan_block.launches = 0
    window_solver.solve_ct_window_block.assemblies = 0
    slam = run_slam(device)
    del slam["pose_graph"], slam["local_builder"], slam["map_builder"]
    launches["fast_scores_3d"] = fast_scores_3d.launches
    score_sums = fast_correlative_3d.match_fast_3d.score_sums
    # Only the window solve and GN3D call K3: the solve once per assembly.
    k3_slam_front, k3_gn3d = (window_solver.solve_ct_window_block.assemblies,
                              ct_scan_block.launches - window_solver.solve_ct_window_block.assemblies)
    k3_paths = {"ct_front_end": launches["ct_scan_block"], "slam_front_end": k3_slam_front, "slam_gn3d": k3_gn3d}
    if slam["errors"]:
        fail(f"SLAM: pose-graph work failed: {slam['errors'][:3]}")
    if fast_scores_3d.launches != score_sums or score_sums == 0:
        fail(f"SLAM: {fast_scores_3d.launches} K4 launches for {score_sums} score_sum calls")
    if k3_slam_front == 0 or k3_gn3d <= 0:
        fail(f"SLAM: K3 launches {k3_paths}: the front end or GN3D did not launch K3")
    if not slam["finite"] or slam["finished"] == 0 or slam["inter"] == 0:
        fail(f"SLAM: {slam['finished']} finished submaps, {slam['inter']} INTER constraints, finite {slam['finite']}")
    if not slam["late_global"] < slam["late_local"] / 2:
        fail(f"SLAM: the returning tail's global error {slam['late_global']:.5f} m is not below half its "
             f"open-loop error {slam['late_local']:.5f} m")
    for key, jax_err in (("late_global", JAX_SLAM_LATE_GLOBAL), ("median_global", JAX_SLAM_MEDIAN_GLOBAL),
                         ("max_global", JAX_SLAM_MAX_GLOBAL)):
        if slam[key] > max(2 * jax_err, jax_err + 0.05):
            fail(f"SLAM: {key} error {slam[key]:.5f} m exceeds max(2 x, +0.05 m) of the JAX package's {jax_err:.5f}")
    lat_ms, search_ms, solve_ms = (np.array(slam[k]) * 1e3 for k in ("latencies", "searches", "solves"))
    print(f"SLAM 3D: {slam['nodes']} nodes, {slam['submaps']} submaps ({slam['finished']} finished), "
          f"{slam['inter']} INTER constraints, {slam['optimizations']} optimizations; K4 launches "
          f"{fast_scores_3d.launches} = score_sum calls {score_sums}, K3 launches {ct_scan_block.launches} "
          f"({k3_slam_front} CT assemblies, {k3_gn3d} GN3D); "
          f"returning tail local {slam['late_local']:.5f} m, "
          f"global {slam['late_global']:.5f} m; global median {slam['median_global']:.5f} m, max "
          f"{slam['max_global']:.5f} m (JAX on the CPU {JAX_SLAM_LATE_GLOBAL:.5f} / {JAX_SLAM_MEDIAN_GLOBAL:.5f} / "
          f"{JAX_SLAM_MAX_GLOBAL:.5f}); per-scan latency median {np.median(lat_ms):.3f} ms, p95 "
          f"{np.percentile(lat_ms, 95):.3f} ms over {len(lat_ms)} scans; constraint search median "
          f"{np.median(search_ms):.3f} ms, p95 {np.percentile(search_ms, 95):.3f} ms over {len(search_ms)}; SPA solve "
          f"median {np.median(solve_ms):.3f} ms, max {solve_ms.max():.3f} ms over {len(solve_ms)}; drive "
          f"{slam['front_s']:.1f} s, queue drained {slam['drain_s']:.1f} s after", flush=True)

    # Phase 12: the same drive with the default batched constraint search.
    k4_paths, k3_paths["slam_gn3d_packed"], shapes12, (lat12, round12_ms, grid_bytes12) = run_phase_12(
        device, slam, launches["fast_scores_3d"])
    checks["fast_scores_3d"].update(shapes12["fast_scores_3d"])
    checks["ct_scan_block"].update(shapes12["ct_scan_block"])

    # Phase 13: the same drive and search on the default occupancy submaps.
    k3_paths13, k4_paths13 = run_phase_13(device, lat12, round12_ms)
    k3_paths.update(k3_paths13)
    k4_paths.update(k4_paths13)

    # Phase 14: the same drive and search on float16 TSDF submaps.
    k3_paths14, k4_paths14, mb14, errors14 = run_phase_14(device, lat12, round12_ms, grid_bytes12)
    k3_paths.update(k3_paths14)
    k4_paths.update(k4_paths14)

    # Phase 15: the plain SPA at the production operating point, PCG and Schur.
    run_phase_15(device)

    # Phase 16: pure localization on phase 14's map.
    k3_paths["slam16_pure_localization"] = run_phase_16(device, mb14, errors14)
    del mb14

    sources = {
        "correlative_prep_2d": ("hectorgrapher_tpu_torch/csrc/correlative_prep_2d.cu",
                                "hectorgrapher_tpu/ops/pallas_prep2d.py:74"),
        "correlative_scores_2d": ("hectorgrapher_tpu_torch/csrc/correlative_scores_2d.cu",
                                  "hectorgrapher_tpu/ops/pallas_corr2d.py:64"),
        "ct_scan_block": ("hectorgrapher_tpu_torch/csrc/ct_scan_block.cu",
                          "hectorgrapher_tpu/mapping/ct/window_solver.py:467 (XLA fusion of scan_block, "
                          "with interpolated_grid.py:332-466)"),
        "fast_scores_3d": ("hectorgrapher_tpu_torch/csrc/fast_scores_3d.cu",
                           "hectorgrapher_tpu/mapping/scan_matching/fast_correlative_3d.py:329 (score_sum of "
                           "_match_fast_3d_core, an XLA gather-reduce)"),
    }
    # Each kernel's record at its main-path shape (K1 and K2 at B=1024, K3
    # at the CT front end's, K4 at the coarse stage's), its other shapes
    # under "shapes" (K3's probability mode under prob_*, its f16 and bf16
    # TSDF modes under f16_* and bf16_*); launches from its main path's run
    # (K1, K2: phase 6; K3: phase 9, with phases 11-14 and 16 under
    # "launches_by_path", slam13_* all in probability mode, slam14_* and
    # slam16_* all in f16 mode; K4: phase 11, with phases 12-14 beside it
    # under "launches_by_path").
    main_shape = {"correlative_prep_2d": "batched", "correlative_scores_2d": "batched",
                  "ct_scan_block": "front_end", "fast_scores_3d": "coarse"}
    kernels = []
    for name, (source, replaces) in sources.items():
        rec = checks[name][main_shape[name]]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            **{k: rec[k] for k in ("ms", "plain_ms", "device_ms", "bound_ms", "bound_by", "library_ms")},
            "max_abs_err": max(v["max_abs_err"] for v in checks[name].values()),
            "shapes": checks[name],
            **({"launches_by_path": {"ct_scan_block": k3_paths, "fast_scores_3d": k4_paths}[name]}
               if name in ("ct_scan_block", "fast_scores_3d") else {}),
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
