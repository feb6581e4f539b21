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
trajectory on phase 14's map with PureLocalizationTrimmer (phase 16);
then the 2D SLAM path (MapBuilder -> 2D front end -> PoseGraph2D, the
default batched constraint search through K5) over two laps of phase 6's
circle (phase 20), the same on uint16 submaps, K1 and K2 reading each
just-quantized submap decoded and K5 its decoded levels (phase 22a), the
2D front end on TSDF submaps in float32, float16, bfloat16 and uint16
storage (phase 22b), and the 2D SPA through its Schur, PCG and dense paths
(phase 21); last, the serving path (phase 23): MapBuilderServer over gRPC
on loopback with 8 CT trajectories at phase 9's width, their window
solves batched across trajectories (CtWindowBatcher: one slotted K3
launch an assembly) against a serial server on the same items, then
WriteState / LoadState and the pbstream state through a fresh MapBuilder,
and one trajectory's results injected into an uplink MapBuilder; then
distribution (phase 24): (a) over a Mesh of four shards on the card, the
sharded SPA (3D and 2D, a Schur and a PCG size each) against the local
solve, the sharded constraint rounds at phase 12's and phase 20's shapes
against the unsharded round (bit-equal, K4 / K5 counted per shard) and
phase 19's eight captured windows sharded (one slotted K3 launch a shard
and assembly); (b) the solver plane in child processes of this script: a
leader and a follower on the card in one gloo group (the leader's 2D
drive, a direct 2D SPA and a 3D graph through cs2d_pack, cs2d, spa2d,
cs3d_pack, cs3d and spa3d, each against the same work with no mesh), and
a one-process NCCL group whose sharded SPA gathers through NCCL. K3 is
held to its plain version in each of its modes (TSDF over f32, f16 and
bf16 volumes, and probability; phase 7), K6 (an LM assembly's pair
residuals and cloud poses) to its eager twins at the CT front end's
shape (phase 7) and at phase 19's B = 8 windows (phase 24a), K7 (the 2D
Gauss-Newton refinement's whole LM solve) to its eager twin at phase 5's
B = 1024, on every front-end match of phases 6 and 20, on phase 20's
rounds and serial refinements and on phase 22b's TSDF front ends, K5 at phase
20's round, a full-submap search, a round over four packed submaps and
synthetic calls on that pack that reach each of its instances with edge
rows (no valid point, all valid, the last slots only, shared rows).
Last, the command-line tools over recorded data (phase 26): a bag shaped
like the DRZ sequences through `mapping-evaluation --use_3d` and 60 PLY
scans through the 2D one (K1-K5 launched through the CLI, errors against
the JAX CLI's on the same bytes), the state tools on the bag run's state,
and `map-builder-server` as a child process serving the bag.
Each phase prints one line; any failure exits non-zero before the last
line. The second-to-last line is a JSON record of the kernels, the last
line a JSON record of the device.

Imports torch, numpy and hectorgrapher_tpu_torch only (grpc through the
package's server and client, for phase 23, and its solver plane, for
24b). Needs one card and fails when torch.cuda.is_available() is false.
Measurement depth kept short so that the run stays well inside its time
limit: each kernel row's device time traces 30 launches, phases 9, 17
and 18 trace one extra scan's kernels, phases 15 and 21 time each solve
once after the gated one.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import hashlib
import io
import json
import math
import os
import signal
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import zlib

import numpy as np
import torch

from hectorgrapher_tpu_torch.cloud import wire
from hectorgrapher_tpu_torch.cloud.local_slam_result import _unpack_grid, make_local_slam_result_payload
from hectorgrapher_tpu_torch.cloud.server import MapBuilderServer
from hectorgrapher_tpu_torch.cloud.solver_plane import SolverPlaneFollower, SolverPlaneLeader
from hectorgrapher_tpu_torch.common import config as cfg
from hectorgrapher_tpu_torch.common import profiling
from hectorgrapher_tpu_torch.evaluation.scan_generator import raycast_box_room_3d, raycast_rect_room_2d
from hectorgrapher_tpu_torch.mapping.ct import window_solver
from hectorgrapher_tpu_torch.mapping.ct.builder import OptimizingLocalTrajectoryBuilder
from hectorgrapher_tpu_torch.mapping.ct.window_solver import CtProblem, CtState, CtWeights, solve_ct_window
from hectorgrapher_tpu_torch.evaluation.graph_generator import (
    make_scale_spa_problem,
    make_scale_spa_problem_2d,
    odometry_extras_2d,
)
from hectorgrapher_tpu_torch.mapping.grids import (
    STORAGE_DTYPES,
    grid_nbytes,
    make_probability_grid,
    make_tsdf_grid,
    quantize_tsdf_grid,
)
from hectorgrapher_tpu_torch.mapping.inserters_3d import make_probability_inserter_3d, make_tsdf_inserter_3d
from hectorgrapher_tpu_torch.mapping.inserters_2d import make_probability_inserter_2d
from hectorgrapher_tpu_torch.mapping import local_3d as local_3d_module
from hectorgrapher_tpu_torch.mapping import local_2d as local_2d_module
from hectorgrapher_tpu_torch.mapping.local_2d import LocalTrajectoryBuilder2D
from hectorgrapher_tpu_torch.mapping.local_3d import LocalTrajectoryBuilder3D
from hectorgrapher_tpu_torch.io.pbstream_state import load_pbstream_state, write_pbstream_state
from hectorgrapher_tpu_torch.mapping.map_builder import MapBuilder, UplinkTrajectoryBuilder
from hectorgrapher_tpu_torch.mapping.scan_matching import fast_correlative_2d, fast_correlative_3d
from hectorgrapher_tpu_torch.mapping.scan_matching.correlative_3d import correlative_scores_3d
from hectorgrapher_tpu_torch.mapping.scan_matching.correlative_2d import (
    _window_geometry,
    make_search_window,
    match_correlative_2d_batched,
    prep_inputs,
    prepare_correlative_table,
)
from hectorgrapher_tpu_torch.mapping.scan_matching import gn_2d as gn_2d_module
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
from hectorgrapher_tpu_torch.ops.ct_pair_block import ct_cloud_poses, ct_pair_residuals
from hectorgrapher_tpu_torch.mapping.pose_graph import optimization as spa
from hectorgrapher_tpu_torch.mapping.pose_graph import pose_graph as pose_graph_module
from hectorgrapher_tpu_torch.mapping.pose_graph.pose_graph import PgNode, PoseGraph2D, PoseGraph3D
from hectorgrapher_tpu_torch.mapping.pose_graph.trimmers import PureLocalizationTrimmer
from hectorgrapher_tpu_torch.ops.ct_scan_block import (
    ct_scan_block,
    ct_scan_block_plain,
    ct_scan_block_points,
    ct_scan_block_points_plain,
    ct_scan_block_points_slots,
    ct_scan_block_points_slots_plain,
    ct_scan_block_slots,
    ct_scan_block_slots_plain,
    grid_params,
    grid_slots,
    plan_poses,
    point_plan,
    segment_terms,
    window_plan,
)
from hectorgrapher_tpu_torch.ops.fast_scores_2d import fast_scores_2d, fast_scores_2d_plain
from hectorgrapher_tpu_torch.ops.fast_scores_2d import instance as k5_instance
from hectorgrapher_tpu_torch.ops.fast_scores_3d import fast_scores_3d, fast_scores_3d_plain
from hectorgrapher_tpu_torch.ops.gn_2d_lm import gn_2d_lm
from hectorgrapher_tpu_torch.mapping.submap_3d import Submap3D
from hectorgrapher_tpu_torch.parallel.constraint_search import (
    matcher_host_arrays_3d,
    pack_submaps_2d,
    pack_submaps_3d_from_arrays,
    sharded_fast_matches_2d_packed,
    sharded_fast_matches_3d_packed,
)
from hectorgrapher_tpu_torch.parallel.ct_windows import solve_ct_windows_sharded
from hectorgrapher_tpu_torch.parallel.mesh import Mesh
from hectorgrapher_tpu_torch.parallel.multihost import global_mesh, initialize_process
from hectorgrapher_tpu_torch.parallel.sharded import solve_spa_2d_sharded, solve_spa_3d_sharded
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
# a CPU, tests/jax_slam_reference.py --front-end-2d, float64 scan times:
# max translation error 0.02864 m, max yaw error 0.00254 rad), and no
# looser than 0.1 m / 0.03 rad.
MAX_TRANSLATION_ERROR = min(2 * 0.02864, 0.1)
MAX_YAW_ERROR = min(2 * 0.00254, 0.03)


def fail(msg: str):
    sys.exit(f"chip_smoke: FAIL: {msg}")


# The repo's 2D mapping-evaluation configuration with the real-time window
# of tests/test_map_builder_2d.py, as replace_deep overrides of
# TrajectoryBuilder2DOptions (plain values, so that
# tests/jax_slam_reference.py applies them to the JAX package's options).
SLICE_OVERRIDES = {
    "use_imu_data": False,
    "use_online_correlative_scan_matching": True,
    "real_time_correlative_scan_matcher.linear_search_window": 0.15,
    "submaps.grid_size": 640,
    "submaps.num_range_data": 12,
    "max_num_points": 2048,
    "motion_filter.max_distance_meters": 0.05,
    "motion_filter.max_time_seconds": 0.1,
}


def slice_options():
    """The 2D front end's options (SLICE_OVERRIDES)."""
    return cfg.replace_deep(cfg.TrajectoryBuilder2DOptions(), SLICE_OVERRIDES)


def circle_scans(n_scans=N_SCANS, seed=SEED, laps=1):
    """(time, ground-truth pose, odometry pose, timed cloud) along the
    mapping-evaluation circle: radius 1.4 m around (0.6, 0.5), 10 Hz,
    1440-ray rect-room scans with 0.004 m range noise, 0.003 m odometry
    noise. With `laps`, the n_scans scans go round that many times at the
    same speed (n_scans = laps * (N_SCANS - 1) + 1 keeps phase 6's)."""
    rng = np.random.default_rng(seed)
    radius, center = 1.4, (0.6, 0.5)
    out = []
    for i in range(n_scans):
        t = 0.1 * i
        a = 2 * np.pi * laps * i / max(n_scans - 1, 1)
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
# K3's per-point mode, counted from the same file, every f32 add, sub,
# mul, div, sqrt, reciprocal, negation, abs or min and each f64 acos, sin
# or cos as one operation (the sign flip onto one hemisphere a choice, not
# counted): 101 a pair with points for its terms (pair_terms: the
# translation difference, the half products, dot and tdot, theta, sin and
# cos of theta, the tangents, 1 / denom and 1 / denom^2), then per point 473
# for its pose and 4 x 6 rotation Jacobian (point_pose: two sin and two
# cos, the weights, two normalizations; dq_column six times), 393 on a pair
# in the lerp branch (no angles, constant weights); the per-cloud mode's
# 295 (its probability variant likewise), 62 for the 18-wide row and the
# residual, 380 for the 190 products.
K3P_OPS_PER_PAIR = 101
K3P_POSE_OPS, K3P_LERP_POSE_OPS = 473, 393
K3P_ROW_OPS = 295 + 62 + 380
K3P_PROB_ROW_OPS = 295 - 128 + 58 + 62 + 380


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


def k5_gather(table, bx, by, valid, cand_t, off_x, off_y, level, dims, cand_base=None):
    """K5's gather-sum written out: flat table indices (C*X*Y, P) int64 and
    0/1 weights of the same shape, f32, where a weight of 1 marks a point
    that counts (fast_scores_2d_plain's cells for all points at once, each
    candidate's rows from its row base)."""
    nx, ny = dims
    span = 1 << level
    t = cand_t.long()
    base = (0 if cand_base is None else cand_base.long()[:, None, None]) + level * (nx + 1)
    ix = bx[t].long()[:, :, None] + off_x[:, None, :]  # (C, P, X)
    iy = by[t].long()[:, :, None] + off_y[:, None, :]  # (C, P, Y)
    pick = (iy > -span) & (iy < ny) & valid.expand(bx.shape)[t][:, :, None]
    keep = ((ix > -span) & (ix < nx))[:, :, :, None] & pick[:, :, None, :]  # (C, P, X, Y)
    idx = (base + torch.clamp(ix, min=0))[:, :, :, None] * ny + torch.clamp(iy, 0, ny - 1)[:, :, None, :]
    idx = torch.where(keep, idx, 0)
    p = idx.shape[1]
    to_rows = lambda x: x.permute(0, 2, 3, 1).reshape(-1, p).contiguous()
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
    if kernel in ("ct_scan_block_points", "ct_scan_block_points_slots"):
        if kernel == "ct_scan_block_points":
            hi, lo, plan, cp7 = args[:4]
            grid_pairs, window_slot, table_bytes = [(hi, lo)], [0], 4 * 8
        else:
            slots, slot, plan, cp7 = args[:4]
            grid_pairs, window_slot = list(zip(slots.hi, slots.lo)), slot.tolist()
            table_bytes = slots.ptrs.numel() * 8 + slots.gparams.numel() * 4 + slot.numel() * 4
        # What the function reads and writes, not what the kernel's design
        # adds (its tickets and scratch): the points of some segment (the
        # plan's dropped points are never read), point, factor, scale and
        # grid flag each; the control points, the segment starts, the
        # outputs.
        m = int(plan.starts[-1])
        nbytes = (21 * m + 4 * (cp7.numel() + plan.starts.numel() + plan.segments * (18 * 18 + 18 + 1))
                  + table_bytes)
        k1 = plan.k - 1
        pair = plan.pair[:m]
        t, q, _ = plan_poses(plan, cp7, m)
        pose7 = torch.cat([t, q], dim=-1)
        window = (pair // k1).long()
        prob = isinstance(grid_pairs[0][0], PreparedProb3D)
        lerp = segment_terms(plan, cp7).lerp
        used = torch.diff(plan.starts) > 0
        n_lerp = int((torch.diff(plan.starts) * lerp).sum())
        ops = (K3P_OPS_PER_PAIR * int(used.sum()) + K3P_POSE_OPS * (m - n_lerp) + K3P_LERP_POSE_OPS * n_lerp
               + (K3P_PROB_ROW_OPS if prob else K3P_ROW_OPS) * m)
        for d, (hi, lo) in enumerate(grid_pairs):
            lane = torch.zeros_like(window, dtype=torch.bool)
            for b, sd in enumerate(window_slot):
                if sd == d:
                    lane |= window == b
            for grid, use in ((hi, ~plan.lo[:m]), (lo, plan.lo[:m])):
                sel = lane & use
                cells, _ = k3_stencil_cells(grid, plan.points[:m][sel][:, None, :], sel[sel][:, None], pose7[sel])
                element = 4 if prob else grid.tsd.element_size()
                nbytes += (1 if prob else 2) * 32 * _sectors(cells, element)
        return nbytes, ops
    if kernel == "ct_pair_residuals":
        state, problem = args[:2]
        k = state.translation.shape[-2]
        n = problem.pair_dt.numel()
        # The control points' states (t, q, v) once, a pair's 58 bytes of
        # terms (dt, imu_dq, odom_dt, odom_dq, two weights f32; two masks),
        # the three weights; r and J.
        return 40 * (n // (k - 1)) * k + 58 * n + 12 + 4 * 285 * n, K6_PAIR_OPS * n
    if kernel == "ct_cloud_poses":
        state, problem = args[:2]
        n = problem.cloud_factor.numel()
        index = problem.cloud_prev.element_size()
        return (28 * (state.translation.numel() // 3) + (2 * index + 4) * n + 4 * 133 * n, K6_CLOUD_OPS * n)
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
    if kernel == "fast_scores_2d":
        table, bx, by, valid, cand_t, off_x, off_y = args[:7]
        cand_base = args[9] if len(args) > 9 else None
        idx, weight = k5_gather(*args)
        p, rows = bx.shape[1], torch.unique(cand_t).long()
        # The point rows the candidates name: the sectors of their valid
        # points' cells in bx and in by (the kernel reads no invalid
        # point's cells), every flag of each row where each point row has
        # its own; the offsets, row bases and the output.
        named = (rows[:, None] * p + torch.arange(p, device=rows.device))[valid.expand(bx.shape)[rows]]
        nbytes = (32 * _sectors(idx[weight > 0]) + 2 * 32 * _sectors(named)
                  + (p * rows.numel() if valid.dim() == 2 else valid.numel())
                  + 4 * (cand_t.numel() + off_x.numel() + off_y.numel() + idx.shape[0])
                  + (0 if cand_base is None else 8 * cand_base.numel()))
        return nbytes, int(weight.sum())
    if kernel == "gn_2d_lm":
        rows, base, mc, res, pts, valid, scale, pose0, target = args[:9]
        iterations = args[-1]  # the iterations each lane ran (K7's third output)
        (b, n, w2), planes = rows[0].shape, len(rows)
        w = math.isqrt(w2)
        # The live taps' distinct 32-byte sectors at the initial pose (a
        # lower bound: later poses may reach other taps), per plane; each
        # valid point's xy and base cell; every flag; a lane's scale,
        # corner, resolution, pose and target; the pose, cost and count.
        f = ((gn_2d_module._world_of(Rigid2(pose0[:, :2], pose0[:, 2]), pts) - mc[:, None, :])
             / res[:, None, None] - 0.5 - base)
        first = torch.floor(f).long() - 1  # (B, N, 2)
        lanes = torch.arange(4, device=f.device)
        ax, ay = first[..., 0, None] + lanes, first[..., 1, None] + lanes  # (B, N, 4)
        live = (ax >= 0)[..., :, None] & (ax < w)[..., :, None] & (ay >= 0)[..., None, :] & (ay < w)[..., None, :]
        slot = (torch.arange(b * n, device=f.device).reshape(b, n, 1, 1)) * w2
        idx = (slot + ax[..., :, None] * w + ay[..., None, :])[live & valid[..., None, None]]
        n_valid = valid.sum(dim=-1).long()
        it = iterations.long().to(n_valid.device)
        nbytes = planes * 32 * _sectors(idx) + 16 * int(n_valid.sum()) + b * n + 56 * b
        ops = int((n_valid * (K7_COST_OPS[planes] * (1 + it) + K7_NORMAL_OPS[planes] * it) + K7_STEP_OPS * it).sum())
        return nbytes, ops
    raise ValueError(f"no work model for {kernel}")


def bound_ms(kernel, args):
    """The least time the card could take for one call of `kernel` on
    `args` (its positional arguments): the larger of its bytes over 3.35
    TB/s and its operations over 67 TFLOP/s. Returns (ms, "bytes" or
    "operations", bytes, operations)."""
    nbytes, ops = _work(kernel, args)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def measure(name, label, kernel, plain, args, err, library=None, note="", kernel_name=None, plain_reps=5,
            reps=30):
    """Time one kernel call against its plain version (and the library
    call, where there is one) at one shape, print one line and return the
    record: per call (CUDA events around the call, host gap included) and
    device time (the kernel's own over `reps` calls, device_ms: kernels
    whose name holds kernel_name, by default name + "_kernel") beside its
    bound; the plain version over plain_reps calls, its device time over
    one traced call (a plain version launches hundreds of small kernels,
    and tracing them is what a row's time went to)."""
    b_ms, b_by, nbytes, ops = bound_ms(name, args)
    rec = dict(max_abs_err=err, ms=cuda_ms(kernel), plain_ms=cuda_ms(plain, reps=plain_reps),
               device_ms=device_ms(kernel, reps=reps, match=kernel_name or f"{name}_kernel"),
               plain_device_ms=device_ms(plain, reps=1),
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


# K7: f32 operations counted from csrc/gn_2d_lm.cu as the data needs them
# (every multiply, add, subtract and divide; of the Catmull-Rom weight's two
# branches the one a tap takes, two near and two far an axis; a point's 16
# taps live): a valid point's cost pass (its residual at a trial pose, 16 to
# place it, 52 for its weights, 49 for one plane's value or 97 for the
# TSDF's two, its square summed) and normal pass (the residual, 36 more for
# the weights' derivatives, the two gradient contractions, dR/dtheta p, the
# Jacobian and its 9 sums), by the planes of the cost; and a lane's step,
# once an iteration (the damped 3 x 3 solve, the trial pose, its cost, the
# stop test and lambda).
K7_COST_OPS = {1: 120, 2: 168}
K7_NORMAL_OPS = {1: 282, 2: 331}
K7_STEP_OPS = 100
# K7 against its twin: pose (m, rad) and cost (relative). Where a lane
# stopped on its own test at the twin's iteration, both took one path. A
# lane that ran to the limit or stopped elsewhere may have taken another:
# phase 5's LMs zig-zag down a valley, each step lowering the cost by about
# function_tolerance * cost, so the stop test and the accepts compare
# numbers an ulp or two apart (the twin against itself with its points
# summed in another order moves 5 of phase 5's 1,024 lanes to another
# count, by up to 1.2e-4 m; K7 against the twin reads 9.6e-5 m on lanes
# at the limit). Such a lane is held to the benchmark's GN limits
# (K7_OTHER_PATH_TOL: 1e-3 m, 1e-4 rad, PERF.md section 2), its cost to K7_TOL.
K7_TOL = 1e-4
K7_OTHER_PATH_TOL = (1e-3, 1e-4)
K7_SITE = threading.local()


@contextlib.contextmanager
def k7_sites(record):
    """Within the block, every K7 call (gn_2d's gn_2d_lm) appended to
    `record` as (site, arguments, outputs): its site the caller it came
    through, "front" (the 2D front end's match_gn_2d_probability), "round"
    (a batched round's match_gn_2d_packed_grids), "serial" (the pose
    graph's match_gn_2d_probability) or None (any other)."""

    def at(site):
        def wrap(fn):
            def run(*a, **kw):
                K7_SITE.site = site
                try:
                    return fn(*a, **kw)
                finally:
                    K7_SITE.site = None
            return run
        return wrap

    def launch(fn):
        def run(*a):
            out = fn(*a)
            record.append((getattr(K7_SITE, "site", None), a, out))
            return out
        return run

    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(local_2d_module, "match_gn_2d_probability", at("front")))
        stack.enter_context(patched(pose_graph_module, "match_gn_2d_packed_grids", at("round")))
        stack.enter_context(patched(pose_graph_module, "match_gn_2d_probability", at("serial")))
        stack.enter_context(patched(gn_2d_module, "gn_2d_lm", launch))
        yield record


def k7_twin(args):
    """K7's plain twin (gn_2d._lm_rows_plain) on a K7 call's arguments:
    (pose (B, 3), cost (B,), iterations (B,))."""
    rows, base, mc, res, pts, valid, scale, pose0, target, tw, rw, iters, *lm = args
    pose, cost, it = gn_2d_module._lm_rows_plain(
        gn_2d_module._COST_OF_PLANES[len(rows)], rows, base, mc[:, None, :], res, pts, valid, scale,
        Rigid2(pose0[:, :2], pose0[:, 2]), target, tw, rw, iters, *lm)
    return torch.cat([pose.translation, pose.angle[:, None]], dim=-1), cost, it


def k7_lane(args, b):
    """A K7 call's arguments for its lane b alone."""
    return tuple(tuple(r[b:b + 1] for r in x) if isinstance(x, tuple)
                 else x[b:b + 1] if torch.is_tensor(x) else x for x in args)


def check_k7(label, calls, lanes=False, timed=None):
    """K7 on each recorded call (arguments, outputs) against its twin on the
    same arguments: finite, a second launch bit-equal, every cost within
    K7_TOL relative, the pose within K7_TOL m / rad where the lane stopped
    on its own test at the twin's iteration and within K7_OTHER_PATH_TOL
    where it did not; with
    `lanes`, each lane bit-equal to a
    launch for it alone (ROADMAP C31). Prints the gaps and the iteration
    counts against the twin's. Returns measure's record of call `timed`
    (an index), or the largest pose gap in m."""
    gap_t = gap_a = gap_c = other_t = other_a = 0.0
    n_lanes = n_other = 0
    counts = []
    for args, got in calls:
        again, want = gn_2d_lm(*args), k7_twin(args)
        torch.cuda.synchronize()
        if not all(bool(torch.isfinite(x).all()) for x in (got[0], got[1], want[0], want[1])):
            fail(f"K7 {label}: K7 or its twin returned non-finite poses or costs")
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            fail(f"K7 {label}: two launches differ")
        dt = (got[0][:, :2] - want[0][:, :2]).norm(dim=-1)
        da = (got[0][:, 2] - want[0][:, 2]).abs()
        dc = (got[1] - want[1]).abs() / want[1].abs().clamp(min=1e-30)
        same = (got[2] == want[2]) & (want[2] < args[11])  # one path: stopped at the same iteration
        gap_c = max(gap_c, float(dc.max()))
        if bool(same.any()):
            gap_t, gap_a = max(gap_t, float(dt[same].max())), max(gap_a, float(da[same].max()))
        if not bool(same.all()):
            other_t, other_a = max(other_t, float(dt[~same].max())), max(other_a, float(da[~same].max()))
        n_lanes += same.numel()
        n_other += int((~same).sum())
        counts.append((got[2].tolist(), want[2].tolist()))
        for b in range(got[0].shape[0] if lanes else 0):
            one = gn_2d_lm(*k7_lane(args, b))
            if not all(torch.equal(x[b:b + 1], y) for x, y in zip(got, one)):
                fail(f"K7 {label}: lane {b} is not bit-equal to a launch for it alone")
    tol_t, tol_a = K7_OTHER_PATH_TOL
    if gap_c > K7_TOL or gap_t > K7_TOL or gap_a > K7_TOL or other_t > tol_t or other_a > tol_a:
        fail(f"K7 {label} differs from its twin: cost {gap_c:.3e} relative, pose {gap_t:.3e} m / {gap_a:.3e} rad "
             f"(gate {K7_TOL:g}); {n_other} of {n_lanes} lanes ran to the limit or stopped elsewhere, pose "
             f"{other_t:.3e} m / {other_a:.3e} rad (gate {tol_t:g} / {tol_a:g})")
    k7_it = [i for c, _ in counts for i in c]
    twin_it = [i for _, c in counts for i in c]
    listed = ("; per call K7 / twin: " + " ".join(f"{a[0]}/{t[0]}" for a, t in counts)
              if all(len(a) == 1 for a, _ in counts) else "")
    summary = (f"{len(calls)} calls, {n_lanes} lanes: cost {gap_c:.3e} relative, pose {gap_t:.3e} m / {gap_a:.3e} "
               f"rad (gate {K7_TOL:g}) where both stopped at one iteration; {n_other} lanes ran to the limit or "
               f"stopped elsewhere (pose {other_t:.3e} m / {other_a:.3e} rad, gate {tol_t:g} / {tol_a:g}); "
               f"iterations K7 mean {np.mean(k7_it):.2f}, twin {np.mean(twin_it):.2f}"
               f"{listed}; bit-equal over two launches" + (", each lane bit-equal to a launch alone" if lanes else ""))
    if timed is None:
        print(f"gn_2d_lm {label}: {summary}", flush=True)
        return max(gap_t, other_t)
    args, got = calls[timed]
    rows = args[0]
    return measure("gn_2d_lm", label, lambda: gn_2d_lm(*args), lambda: k7_twin(args), (*args, got[2]),
                   max(gap_t, other_t), note=f" B={rows[0].shape[0]} N={rows[0].shape[1]} planes={len(rows)}, "
                   f"{int(args[5].sum())} valid points, {int(got[2].sum())} iterations ({summary}; library: none, "
                   "no one PyTorch call is an LM solve)")


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


def run_front_end(device, n_scans=N_SCANS, options=None):
    """Phase 6: LocalTrajectoryBuilder2D over the circle scans at
    slice_options(), or at `options` (phase 22b). Returns (matched scans,
    per-scan seconds of the matched scans, max translation and yaw errors
    against ground truth, the builder, the scans matched against a submap
    of uint16 codes)."""
    builder = LocalTrajectoryBuilder2D(options or slice_options(), device=device)
    scans = circle_scans(n_scans)
    anchor = scans[0][1]
    n_matched, n_quantized, latencies, t_err, y_err = 0, 0, [], 0.0, 0.0
    for t, pose, odom, cloud in scans:
        builder.add_odometry_data(t, odom)
        matching = builder.active_submaps.matching_submap
        matched = matching is not None
        n_quantized += matched and getattr(matching.grid, "tsd", getattr(matching.grid, "log_odds", None)).dtype == \
            torch.uint16
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
    return n_matched, latencies, t_err, y_err, builder, n_quantized


CT_SCANS = 80  # 8 s of the CT front end at 10 Hz
CT_SPEED, CT_YAW_RATE = 0.2, 0.1  # m/s, rad/s
CT_ROOM = (9.5, 7.5, 2.4)  # half extents, m
# CT front-end error bounds. The JAX package's own CT front end on the
# same 80 scans (hectorgrapher_tpu OptimizingLocalTrajectoryBuilder on a
# CPU, tests/jax_slam_reference.py --ct-drift --per-scan, float64 scan
# times) ends with a max translation error of 0.52468 m and a max yaw
# error of 0.02423 rad: it drifts behind the truth along the direction of travel
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
# Phases 17 and 18: the JAX package's CT front end over the same scans at
# phase 9's options with per-point unwarping (17: all 80) and with the
# DIRECT IMU term as well (18: the first CT18_SCANS), on a CPU
# (tests/jax_slam_reference.py --ct-drift --per-point [--direct], float64
# scan times): max translation and yaw errors. The port must stay within
# max(2x, +0.05 m) and max(2x, +0.01 rad) of them.
JAX_CT17_TRANSLATION_ERROR, JAX_CT17_YAW_ERROR = 0.55603, 0.02181
JAX_CT18_TRANSLATION_ERROR, JAX_CT18_YAW_ERROR = 0.11492, 0.02195
CT18_SCANS = 30  # phase 18 (DIRECT: ~0.6 s a scan on the card) drives the first 3 s


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


def ct_point_problem(device, scan_pts, c=32, p=256, k=32, seed=SEED, outside=0):
    """Phase 7's per-point window at the CT front end's shape: C=32 clouds
    of 256 hi-res and 256 lo-res points drawn from a scan (the last 32
    lo-res points of each cloud masked out, the first `outside` of each
    set moved to 40 m, outside both grids), K=32 control points 0.1 s
    apart, the last one masked (its time +inf, its state the identity),
    perturbed by up to 5 cm / 0.02 rad. Cloud times put cloud 0's sweep
    partly before the first control point, the last cloud's after the last
    valid one, and no point in pair 5; each cloud's sweep times over
    [-0.05, 0.049] s are shuffled (a filtered cloud is not time-ordered).
    Returns (problem, weights, state): a CtProblem's per-point fields, CtWeights."""
    from types import SimpleNamespace

    from hectorgrapher_tpu_torch.transform.rigid import quat_from_axis_angle

    rng = np.random.default_rng(seed)
    to = lambda a, dtype=torch.float32: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    def clouds():
        pts = np.stack([scan_pts[rng.choice(len(scan_pts), p, replace=False)] for _ in range(c)])
        pts[:, :outside] *= 40.0 / np.linalg.norm(pts[:, :outside], axis=-1, keepdims=True)
        return to(pts)

    times = lambda: to(np.stack([rng.permutation(np.linspace(-0.05, 0.049, p, dtype=np.float32)) for _ in range(c)]))
    cloud_time = np.arange(c) * 0.1 + 0.05 + np.where(np.arange(c) >= 5, 0.11, 0.0)  # pair 5: no point
    cloud_time[0] = -0.02  # partly before control point 0
    lo_mask = np.ones((c, p), bool)
    lo_mask[:, -32:] = False
    cp_mask = np.ones(k, bool)
    cp_mask[-1] = False
    problem = SimpleNamespace(
        cp_mask=to(cp_mask, torch.bool), cp_times=to(np.arange(k) * 0.1), cloud_mask=to(np.ones(c, bool), torch.bool),
        cloud_time=to(cloud_time), hi_points=clouds(), hi_mask=to(np.ones((c, p), bool), torch.bool),
        hi_times=times(), lo_points=clouds(), lo_mask=to(lo_mask, torch.bool), lo_times=times())
    aa = rng.uniform(-0.02, 0.02, (k, 3)).astype(np.float32)
    aa[-1] = 0.0
    trans = rng.uniform(-0.05, 0.05, (k, 3)).astype(np.float32)
    trans[-1] = 0.0
    state = CtState(to(trans), quat_from_axis_angle(to(aa)), torch.zeros((k, 3), device=device))
    weights = CtWeights(*(to(w) for w in (1.0, 1.0, 1.0, 1.0, 1.0)))
    return problem, weights, state


def ct_point_inputs(device, hi, lo, scan_pts, outside=0, seed=SEED):
    """K3 per-point mode's arguments at phase 7's shape (ct_point_problem):
    (hi, lo, plan, cp7, gparams)."""
    problem, weights, state = ct_point_problem(device, scan_pts, seed=seed, outside=outside)
    plan = window_solver.problem_plan(problem, weights)
    k1 = plan.k - 1
    counts = (plan.starts[1:] - plan.starts[:-1]).tolist()
    if counts[5] != 0 or min(counts[:5] + counts[6:k1 - 1]) == 0:
        fail(f"phase 7: per-point segment sizes {counts} do not leave exactly pair 5 empty")
    return hi, lo, plan, torch.cat([state.translation, state.rotation], dim=-1).contiguous(), grid_params(hi, lo)


def _pair_errors(got, want):
    """Per pair block: the largest |difference| of S, g and cost, and the
    gate 1e-4 * max(1, max|S_p|) of the plain version."""
    bound = 1e-4 * torch.clamp(want[0].abs().amax(dim=(1, 2)), min=1.0)
    errs = [(got[0] - want[0]).abs().amax(dim=(1, 2)), (got[1] - want[1]).abs().amax(dim=1), (got[2] - want[2]).abs()]
    return errs, bound


def ct_point_segment_inputs(device, hi, lo, scan_pts, case, seed=SEED):
    """K3 per-point mode's arguments on one window of uneven segments:
    "long", K = 4 control points whose pair 0 draws 4,600 points (~4,370
    kept: 34 tiles, whose sums its last block adds), pair 1 none and pair 2
    100; "skewed", K = 32 with pair 3 drawing 12,000 points beside one to
    three in every other pair but pair 5, which is empty. Points drawn from
    a scan, hi or lo res at random, 5% of them dropped (scale 0), factors
    uniform on [0, 1), control points perturbed by up to 5 cm / 0.05 rad.
    Returns (hi, lo, plan, cp7, gparams, empty pair)."""
    from hectorgrapher_tpu_torch.transform.rigid import quat_from_axis_angle

    rng = np.random.default_rng(seed)
    if case == "long":
        k, counts, empty = 4, [4600, 0, 100], 1
    else:
        k, empty = 32, 5
        counts = rng.integers(1, 4, k - 1)
        counts[3], counts[empty] = 12000, 0
    pair = rng.permutation(np.repeat(np.arange(k - 1), counts))
    n = pair.size
    lo_flag = rng.random(n) < 0.5
    scale = np.where(rng.random(n) < 0.05, 0.0, 1.0 / math.sqrt(n)).astype(np.float32)
    to = lambda a, dtype=torch.float32: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    parts = []
    for sel in (~lo_flag, lo_flag):
        cnt = int(sel.sum())
        parts += [to(scan_pts[rng.choice(len(scan_pts), cnt)][None]), to(pair[sel][None], torch.int64),
                  to(rng.random(cnt).astype(np.float32)[None]), to(scale[sel][None])]
    plan = point_plan(*parts, k)
    cp7 = torch.cat([to(rng.uniform(-0.05, 0.05, (k, 3)).astype(np.float32)),
                     quat_from_axis_angle(to(rng.uniform(-0.05, 0.05, (k, 3)).astype(np.float32)))], dim=-1)
    return hi, lo, plan, cp7.contiguous(), grid_params(hi, lo), empty


def check_ct_points(args, label, timed=True, empty=5):
    """Phase 7: K3's per-point mode against its plain twin on one window's
    plan (ct_point_inputs or ct_point_segment_inputs): every pair block
    within 1e-4 * max(1, max|S_p|), the empty pair's block zero in both,
    two launches bit-equal. Returns measure's record (timed) or the largest
    difference."""
    hi, lo, plan, cp7, gparams = args
    got = ct_scan_block_points(hi, lo, plan, cp7, gparams=gparams)
    again = ct_scan_block_points(hi, lo, plan, cp7, gparams=gparams)
    want = ct_scan_block_points_plain(hi, lo, plan, cp7)
    torch.cuda.synchronize()
    if not all(bool(torch.isfinite(x).all()) for x in got) or float(want[0].abs().max()) <= 0.0:
        fail(f"K3 ct_scan_block_points returned non-finite values or sees no observed cell at {label}")
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        fail(f"K3 ct_scan_block_points: two launches differ at {label}")
    if any(float(x[empty].abs().max()) != 0.0 for x in (*got, *want)):
        fail(f"K3 ct_scan_block_points: the empty pair {empty} has a nonzero block at {label}")
    errs, bound = _pair_errors(got, want)
    for name, e in zip(("S", "g", "cost"), errs):
        if bool((e > bound).any()):
            fail(f"K3 ct_scan_block_points {name} differs from its plain twin at {label}: max {float(e.max()):.3e}, "
                 f"bound {float(bound.min()):.3e}")
    err = max(float(e.max()) for e in errs)
    m = int(plan.starts[-1])
    if not timed:
        sizes = torch.diff(plan.starts)
        print(f"ct_scan_block_points {label} K={plan.k}: {m} points, segments of {int(sizes.min())}.."
              f"{int(sizes.max())}, pair {empty} empty; max |d| {err:.3e} (bound {float(bound.min()):.3e}.."
              f"{float(bound.max()):.3e} per pair), two launches bit-equal", flush=True)
        return err
    return measure("ct_scan_block_points", label, lambda: ct_scan_block_points(hi, lo, plan, cp7, gparams=gparams),
                   lambda: ct_scan_block_points_plain(hi, lo, plan, cp7), args, err,
                   note=f" grids {hi.shape[0]}^3/{lo.shape[0]}^3 K={plan.k} ({plan.segments} pairs, pair 5 empty, "
                        f"control point {plan.k - 1} masked) C=32 P=256+256, {m} points (error bound "
                        f"{float(bound.min()):.3e}..{float(bound.max()):.3e} per pair, two launches bit-equal; "
                        "library: none, no one PyTorch call fuses the per-point slerp, the stencil and the per-pair "
                        "J^T J)")


def ct_points_slots_inputs(device, pairs, scan_pts, windows=4):
    """K3 per-point slotted arguments: `windows` windows of phase 7's shape
    (other seeds) over the grid pairs `pairs` (slots 0, 1, 2, 0, ...)."""
    problems = [ct_point_problem(device, scan_pts, seed=SEED + 1 + b, outside=16) for b in range(windows)]
    batch = type(problems[0][0])(**{f: torch.stack([getattr(pr, f) for pr, _, _ in problems])
                                     for f in vars(problems[0][0])})
    plan = window_solver.problem_plan(batch, problems[0][1])
    cp7 = torch.cat([torch.cat([st.translation, st.rotation], dim=-1) for _, _, st in problems]).contiguous()
    slots = grid_slots([h for h, _ in pairs], [l for _, l in pairs])
    slot = torch.tensor([b % len(pairs) for b in range(windows)], dtype=torch.int32, device=device)
    return slots, slot, plan, cp7


def check_ct_points_slots(args, label):
    """Phase 7: K3's slotted per-point form on several windows over three
    grid pairs, within the per-pair gate of its plain version, bit-equal
    to one launch per window and over two launches. Returns measure's
    record."""
    slots, slot, plan, cp7 = args
    got = ct_scan_block_points_slots(*args)
    again = ct_scan_block_points_slots(*args)
    want = ct_scan_block_points_slots_plain(*args)
    k = plan.k
    singles = [ct_scan_block_points(slots.hi[d], slots.lo[d], window_plan(plan, b), cp7[b * k:(b + 1) * k],
                                    gparams=slots.gparams[d]) for b, d in enumerate(slot.tolist())]
    torch.cuda.synchronize()
    if not all(bool(torch.isfinite(x).all()) for x in got) or float(want[0].abs().max()) <= 0.0:
        fail(f"K3 ct_scan_block_points_slots returned non-finite values or sees no observed cell at {label}")
    errs, bound = _pair_errors(got, want)
    if any(bool((e > bound).any()) for e in errs):
        fail(f"K3 ct_scan_block_points_slots differs from its plain twin at {label}: max "
             f"{max(float(e.max()) for e in errs):.3e}")
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        fail(f"K3 ct_scan_block_points_slots: two launches differ at {label}")
    k1 = k - 1
    for b, one in enumerate(singles):
        if not all(torch.equal(a[b * k1:(b + 1) * k1], o) for a, o in zip(got, one)):
            fail(f"K3 ct_scan_block_points_slots window {b} is not bit-equal to one launch for it alone at {label}")
    err = max(float(e.max()) for e in errs)
    return measure("ct_scan_block_points_slots", label, lambda: ct_scan_block_points_slots(*args),
                   lambda: ct_scan_block_points_slots_plain(*args), args, err,
                   kernel_name="ct_scan_block_points_kernel",
                   note=f" B={slot.shape[0]} windows over {len(slots.hi)} distinct 256^3/128^3 grid pairs (slots "
                        f"{slot.tolist()}), K={k}, bit-equal to {slot.shape[0]} single launches and over two launches "
                        "(library: none)")


def check_points_mode(device, tag, pairs, scan_pts, checks):
    """Phase 7, K3's per-point mode on one mode's maps: `pairs` of grids
    filled with three, two and one scans. At the CT front end's shape
    against pairs[0] (points outside both grids, a masked control point,
    points before the first and after the last valid control point, an
    empty pair), then slotted: 8 windows over the three pairs; then
    untimed, a long segment and a skewed window (ct_point_segment_inputs)."""
    hi, lo = pairs[0]
    rec = checks.setdefault("ct_scan_block_points", {})
    rec[f"{tag}front_end"] = check_ct_points(ct_point_inputs(device, hi, lo, scan_pts, outside=16), f"{tag}front_end")
    rec[f"{tag}front_end_slotted_b8"] = check_ct_points_slots(
        ct_points_slots_inputs(device, pairs, scan_pts, windows=8), f"{tag}front_end_slotted_b8")
    for case in ("long", "skewed"):
        *args, empty = ct_point_segment_inputs(device, hi, lo, scan_pts, case)
        check_ct_points(args, f"{tag}{case}_segment", timed=False, empty=empty)


def ct_pair_block_inputs(device, k=32, c=32, seed=SEED):
    """K6's inputs at the CT front end's shape: one window's (state,
    problem, weights) with K=32 control points 0.1 s apart turning by up
    to 0.05 rad a step from a random attitude (control point 9 negated:
    its pairs' dot below 0, the slerp's sign flip; control point 20 a copy
    of 19: theta = 0, the lerp branch), C=32 clouds on brackets that cover
    both, IMU and odometry terms near the true motion with adaptive-weight
    sized odometry weights, pairs 4 and 17 out of the IMU term and pairs 4
    and 25 out of the odometry term (their masks false)."""
    from hectorgrapher_tpu_torch.transform.rigid import quat_from_axis_angle, quat_multiply, quat_normalize

    rng = np.random.default_rng(seed)
    to = lambda a, dtype=torch.float32: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    turns = to(rng.uniform(-0.05, 0.05, (k, 3)).astype(np.float32))
    q = quat_normalize(quat_from_axis_angle(to(rng.uniform(-1.0, 1.0, 3).astype(np.float32))))
    rotations = []
    for i in range(k):
        q = quat_normalize(quat_multiply(q, quat_from_axis_angle(turns[i])))
        rotations.append(q)
    rotation = torch.stack(rotations)
    rotation[20] = rotation[19]
    rotation[9] = -rotation[9]
    state = CtState(to(np.cumsum(rng.normal(0.0, 0.02, (k, 3)), axis=0).astype(np.float32)), rotation.contiguous(),
                    to(rng.normal(0.0, 0.25, (k, 3)).astype(np.float32)))
    prev = np.minimum(np.arange(c) * (k - 1) // c, k - 2)
    prev[:3] = (8, 9, 19)
    near = lambda: quat_normalize(quat_from_axis_angle(turns[1:] + to(rng.normal(0.0, 1e-3, (k - 1, 3)))))
    pair_mask, odom_mask = np.ones(k - 1, bool), np.ones(k - 1, bool)
    pair_mask[[4, 17]] = False
    odom_mask[[4, 25]] = False
    problem = CtProblem(
        cp_mask=to(np.ones(k, bool), torch.bool), cp_times=to(np.arange(k) * 0.1),
        cloud_mask=to(np.ones(c, bool), torch.bool), cloud_prev=to(prev, torch.int32),
        cloud_next=to(prev + 1, torch.int32), cloud_factor=to(rng.uniform(0.0, 1.0, c).astype(np.float32)),
        cloud_time=to(np.zeros(c)), hi_points=None, hi_mask=None, hi_times=None, lo_points=None, lo_mask=None,
        lo_times=None, pair_mask=to(pair_mask, torch.bool), pair_dt=to(np.full(k - 1, 0.1)),
        imu_delta_rotation=near(), imu_delta_velocity=to(np.zeros((k - 1, 3))),
        imu_delta_translation=to(np.zeros((k - 1, 3))), odom_mask=to(odom_mask, torch.bool),
        odom_delta_translation=to(rng.normal(0.0, 0.02, (k - 1, 3)).astype(np.float32)),
        odom_delta_rotation=near(), odom_translation_weight=to(rng.uniform(1.0, 20.0, k - 1).astype(np.float32)),
        odom_rotation_weight=to(rng.uniform(1.0, 20.0, k - 1).astype(np.float32)))
    weights = CtWeights(*(to(w) for w in (5.0, 15.0, 1.0, 1.0, 1.0)))
    return state, problem, weights


# K6's gate: each entry of an output within K6_TOL * max(1, the largest
# |entry| of the twin's block) of the twin's, a block being one pair's r
# or J, one cloud's pose7 or dpose7. The same formulas in f32; the twins'
# torch reductions (vector_norm's fused squares) and library calls, and
# for the cloud poses K3's f64 angles and reciprocals, round apart by a
# few ulps of the terms an entry sums, and those scale with the block's
# weights (odometry weights of ~20 give J entries of ~20 whose sums cancel
# to ~0.01).
K6_TOL = 1e-5
# f32 operations a call executes, counted from csrc/ct_pair_block.cu on the
# host (every multiply, add, subtract, divide, square root, reciprocal and
# f64 rounding): 14,706 a pair, 2,994 a cloud in the slerp branch, over
# the 18 lanes, each lane computing the block's values again.
K6_PAIR_OPS, K6_CLOUD_OPS = 14706, 2994


def _k6_gaps(got, want):
    """(largest |difference|, largest difference over its bound, where:
    the output, block and entry) of K6's outputs against the twin's (r, J
    or pose7, dpose7; a block is the last axis of r and pose7, the last two
    of J and dpose7)."""
    gap, ratio, where = 0.0, -1.0, None
    for out, (g, w) in enumerate(zip(got, want)):
        d = (g - w).abs()
        dims = tuple(range(w.dim() - 1 - out, w.dim()))
        bound = K6_TOL * torch.clamp(w.abs().amax(dim=dims, keepdim=True), min=1.0)
        r = d / bound
        i = int(r.argmax())
        gap = max(gap, float(d.max()))
        if float(r.flatten()[i]) > ratio:
            ratio = float(r.flatten()[i])
            idx = np.unravel_index(i, tuple(w.shape))
            where = (out, tuple(int(x) for x in idx), float(w.flatten()[i]), float(g.flatten()[i]))
    return gap, ratio, where


def check_ct_pair_block(state, problem, weights, label, timed=True, lanes=False):
    """Phase 7 (and 24a): K6's pair residuals and cloud poses against their
    eager twins: finite, within the per-entry gate, bit-equal over two
    launches; with `lanes` (a leading window axis), each window bit-equal
    to a launch for it alone (ROADMAP C31). Returns {"ct_pair_residuals":
    record, "ct_cloud_poses": record} (measure's, timed) or the largest
    differences."""
    out = {}
    for name, kernel, plain, args in (
            ("ct_pair_residuals", ct_pair_residuals, window_solver.pair_residuals_plain, (state, problem, weights)),
            ("ct_cloud_poses", ct_cloud_poses, window_solver.cloud_poses_plain, (state, problem))):
        got, again, want = kernel(*args), kernel(*args), plain(*args)
        torch.cuda.synchronize()
        if not all(bool(torch.isfinite(x).all()) for x in got + want):
            fail(f"K6 {name} or its eager twin returned non-finite values at {label}")
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            fail(f"K6 {name}: two launches differ at {label}")
        for b in range(state.translation.shape[0] if lanes else 0):
            lane = lambda nt: type(nt)(*(x[b] if torch.is_tensor(x) and x.dim() else x for x in nt))
            one = kernel(lane(args[0]), lane(args[1]), *args[2:])
            if not all(torch.equal(x[b], y) for x, y in zip(got, one)):
                fail(f"K6 {name}: window {b} is not bit-equal to a launch for it alone at {label}")
        gap, ratio, where = _k6_gaps(got, want)
        if ratio > 1.0:
            fail(f"K6 {name} differs from its eager twin at {label}: max |d| {gap:.3e}, {ratio:.2f}x the gate "
                 f"{K6_TOL:g} x max(1, |twin block|) at output {where[0]} entry {where[1]}: twin {where[2]:.7e}, "
                 f"K6 {where[3]:.7e}")
        shape = "x".join(map(str, got[1].shape))
        alone = f", each of the {state.translation.shape[0]} windows bit-equal to a launch alone" if lanes else ""
        if not timed:
            print(f"{name} {label} {shape}: max |d| {gap:.3e} ({ratio:.3f} of the gate {K6_TOL:g} x max(1, |twin "
                  f"block|)), bit-equal over two launches{alone}", flush=True)
            out[name] = gap
            continue
        out[name] = measure(name, label, lambda: kernel(*args), lambda: plain(*args), args, gap,
                            note=f" J {shape} ({ratio:.3f} of the gate {K6_TOL:g} x max(1, |twin block|), bit-equal "
                                 f"over two launches{alone}; library: none, no one PyTorch call is a closed-form "
                                 "Jacobian)")
    return out


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
    window_solver.solve_ct_window.assemblies = 0
    ct_scan_block.launches = 0
    solve = lambda: solve_ct_window(*example, is_tsdf=True, num_iterations=8)
    state, final, initial = solve()
    if ct_scan_block.launches != window_solver.solve_ct_window.assemblies or ct_scan_block.launches == 0:
        fail(f"window solve: {ct_scan_block.launches} K3 launches for "
             f"{window_solver.solve_ct_window.assemblies} assemblies")
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


def ct_overrides(per_point=False, direct=False):
    """Phase 9's overrides of TrajectoryBuilder3DOptions: TSDF submaps,
    min_range 0.4 and a 0.45 s initialization, as tests/test_ct_builder.py
    and bench.py:874-886 set them; with `per_point` per-point unwarping
    (phase 17), with `direct` the DIRECT IMU cost term (phase 18).
    tests/jax_slam_reference.py applies them to the JAX package's options."""
    out = {
        "min_range": 0.4,
        "submaps.grid_type": "TSDF",
        "optimizing_local_trajectory_builder.initialization_duration": 0.45,
    }
    if per_point:
        out["optimizing_local_trajectory_builder.use_per_point_unwarping"] = True
    if direct:
        out["optimizing_local_trajectory_builder.imu_cost_term"] = "DIRECT"
    return out


def ct_options(per_point=False, direct=False):
    """TrajectoryBuilder3DOptions defaults (256^3/128^3 grids, K=32, C=32,
    P=256, 12 LM iterations, RK4 preintegration, CONSTANT sampling) with
    ct_overrides."""
    return cfg.replace_deep(cfg.TrajectoryBuilder3DOptions(), ct_overrides(per_point, direct))


def ct_pose_error(time_s, t, q, speed=CT_SPEED):
    """(translation error m, yaw error rad) of a CT front-end pose at
    time_s against ct_truth at `speed`."""
    truth_t, truth_q = ct_truth(time_s, speed)
    d = nq.quat_yaw(q) - nq.quat_yaw(truth_q)
    return float(np.linalg.norm(t - truth_t)), abs((d + np.pi) % (2 * np.pi) - np.pi)


def ct_truth(t, speed=CT_SPEED):
    return (np.array([speed * t, 0.0, 0.0]), nq.quat_from_axis_angle(np.array([0.0, 0.0, CT_YAW_RATE * t])))


def ct_drive(n_scans, seed=SEED, speed=CT_SPEED):
    """The CT front end's sensor events in time order: IMU at 100 Hz
    (gravity and the yaw rate in the body frame), odometry at 20 Hz (2 mm
    noise), and n_scans scans at 10 Hz of 96 x 24 rays of the CT_ROOM box
    room, 4 mm range noise, per-point sweep times over [-0.05, 0.049] s,
    while driving at `speed` with CT_YAW_RATE. Yields ("imu", t, acc,
    gyro), ("odom", t, pose) and ("scan", t, data)."""
    gravity = np.array([0.0, 0.0, 9.80665])
    rng = np.random.default_rng(seed)
    t, next_odom, next_scan, n = 0.0, 0.0, 0.05, 0
    while n < n_scans:
        pt, pq = ct_truth(t, speed)
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


def ct_launch_counts():
    """The CT front end's counters: K3 launches per cloud and per point,
    K6 launches (pair residuals, cloud poses), pair residuals taken by the
    eager twin on the card (DIRECT), solver assemblies."""
    return dict(k3=ct_scan_block.launches, k3_points=ct_scan_block_points.launches,
                k6_pairs=window_solver.pair_residuals.launches, k6_clouds=window_solver.cloud_poses.launches,
                pairs_eager=window_solver.pair_residuals.eager_on_card,
                assemblies=window_solver.solve_ct_window.assemblies)


def run_ct_front_end(device, n_scans=CT_SCANS, profile_scans=0, options=None, hook=None, count_scans=1):
    """Phases 9, 17 and 18: OptimizingLocalTrajectoryBuilder over the CT
    drive at `options` (phase 9's ct_options() by default), its solves
    through `hook` (the builder's window_solve_fn) when given. Returns
    (scans, per-scan seconds from the first window solve on, max
    translation and yaw errors against ground truth, the builder, counts:
    ct_launch_counts() over the n_scans, and "kernels_per_scan", the kernels on
    the device trace of each of count_scans more scans, a floor). With profile_scans, profiles
    that many more scans afterwards and prints their breakdown."""
    builder = OptimizingLocalTrajectoryBuilder(options or ct_options(), device)
    builder.window_solve_fn = hook
    window_solver.solve_ct_window.assemblies = 0
    ct_scan_block.launches = ct_scan_block_points.launches = 0
    window_solver.pair_residuals.launches = window_solver.pair_residuals.eager_on_card = 0
    window_solver.cloud_poses.launches = 0
    latencies, t_err, y_err, n, counts, kernels = [], 0.0, 0.0, 0, None, []
    prof = None
    for kind, t, *payload in ct_drive(n_scans + count_scans + profile_scans):
        if kind == "imu":
            builder.add_imu_data(t, *payload)
            continue
        if kind == "odom":
            builder.add_odometry_data(t, payload[0])
            continue
        if n == n_scans:
            counts = ct_launch_counts()
        if n == n_scans + count_scans and profile_scans:
            prof = profile_ct_start(builder)
        solves = builder.num_optimizations
        t0 = time.perf_counter()
        if n_scans <= n < n_scans + count_scans:
            result, n_kernels = device_kernels(lambda: builder.add_range_data(payload[0]))
            kernels.append(n_kernels)
        else:
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
            e_t, e_y = ct_pose_error(result.time, result.local_pose.t, result.local_pose.q)
            t_err, y_err = max(t_err, e_t), max(y_err, e_y)
    if counts is None:
        counts = ct_launch_counts()
    counts["kernels_per_scan"] = float(np.mean(kernels)) if kernels else None
    if prof is not None:
        profile_ct_finish(prof, profile_scans)
    return n_scans, latencies, t_err, y_err, builder, counts


def latency_snapshot():
    """The CT front ends' latency histogram's bucket counts (FrontEndMetrics
    "ct_3d", shared by every CT builder of the process)."""
    from hectorgrapher_tpu_torch.mapping.frontend_metrics import FrontEndMetrics

    return FrontEndMetrics("ct_3d").latency.counts_by_bucket


def print_front_end_metrics(label, builder, before):
    """One line of FrontEndMetrics for a phase's CT builder: its steps per
    latency bucket (the counts since `before`) and its real-time ratios."""
    from hectorgrapher_tpu_torch.mapping.frontend_metrics import LATENCY_BUCKETS

    counts = [a - b for a, b in zip(latency_snapshot(), before)]
    edges = [f"<={b:g}s" for b in LATENCY_BUCKETS] + [f">{LATENCY_BUCKETS[-1]:g}s"]
    m = builder.frontend_metrics
    print(f"{label} FrontEndMetrics: latency buckets {dict(zip(edges, counts))}; real-time ratio "
          f"{m.real_time_ratio:.4f}, CPU real-time ratio {m.cpu_real_time_ratio:.4f} (last {m.WINDOW} steps)",
          flush=True)


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


def solve_inline(pending):
    """A PendingWindowSolve solved as the builder solves it inline."""
    return solve_ct_window(pending.high_grid, pending.low_grid, pending.problem, pending.state0, pending.weights,
                           is_tsdf=pending.is_tsdf, num_iterations=pending.num_iterations,
                           per_point=pending.per_point, direct=pending.direct)[0]


class WindowCapture:
    """A window_solve_fn that solves inline and keeps the solves numbered
    in `picks`, each with clones of its grids (so that later insertions do
    not change them): phase 19's distinct full-width windows."""

    def __init__(self, picks):
        self.picks, self.count, self.kept = set(picks), 0, []

    def __call__(self, pending):
        if self.count in self.picks:
            clone = lambda g: g._replace(tsd=g.tsd.clone(), weight=g.weight.clone())
            self.kept.append(dataclasses.replace(pending, high_grid=clone(pending.high_grid),
                                                 low_grid=clone(pending.low_grid), cps=[]))
        self.count += 1
        return solve_inline(pending)


def check_ct_drive(label, n_scans, lat, t_err, y_err, builder, counts, jax_t, jax_y, before, direct=False):
    """Phases 17 and 18's gates and line: every assembly one per-point K3
    launch and none per cloud, no cloud poses, and one K6 pair-residual
    launch (with `direct`, one eager pair residual instead); errors within
    max(2x, +0.05 m) and max(2x, +0.01 rad) of the JAX package's on the
    same options and scans."""
    if counts["k3"] != 0 or counts["k3_points"] != counts["assemblies"] or counts["assemblies"] == 0:
        fail(f"{label}: K3 launches {counts['k3']} per cloud and {counts['k3_points']} per point for "
             f"{counts['assemblies']} assemblies")
    k6_pairs, eager = (0, counts["assemblies"]) if direct else (counts["assemblies"], 0)
    if (counts["k6_pairs"], counts["pairs_eager"], counts["k6_clouds"]) != (k6_pairs, eager, 0):
        fail(f"{label}: K6 pair launches {counts['k6_pairs']}, eager pair residuals {counts['pairs_eager']}, "
             f"K6 cloud launches {counts['k6_clouds']} for {counts['assemblies']} assemblies")
    t_bound, y_bound = max(2 * jax_t, jax_t + 0.05), max(2 * jax_y, jax_y + 0.01)
    if t_err > t_bound or y_err > y_bound:
        fail(f"{label}: max error {t_err:.5f} m / {y_err:.5f} rad exceeds {t_bound:.5f} m / {y_bound:.5f} rad "
             f"(JAX {jax_t:.5f} / {jax_y:.5f})")
    lat_ms = np.array(lat) * 1e3
    print(f"{label}: {n_scans} scans, {builder.num_optimizations} window solves, K3 per-point launches "
          f"{counts['k3_points']} = assemblies {counts['assemblies']}, per-cloud launches {counts['k3']}; K6 "
          f"pair launches {counts['k6_pairs']}, eager pair residuals {counts['pairs_eager']}; "
          f"{counts['kernels_per_scan']:.0f} kernels a scan (device trace of 1 scan); max error {t_err:.5f} m / "
          f"{y_err:.5f} rad (JAX on the CPU {jax_t:.5f} / {jax_y:.5f}, bounds {t_bound:.5f} / {y_bound:.5f}); "
          f"per-scan latency median {np.median(lat_ms):.3f} ms, p95 {np.percentile(lat_ms, 95):.3f} ms over "
          f"{len(lat_ms)} scans", flush=True)
    print_front_end_metrics(label, builder, before)


def check_knn_insertion(device, size=256):
    """Phase 17's setup: the first scan of the CT drive inserted into an
    empty size^3 TSDF grid (0.1 m, the hi-res submap's) with KNN_PCA
    normals (knn_pca_normals: topk over the dense distances and eigh on
    the card), timed, and held to the same insertion on the CPU within
    ROADMAP C3's tolerance: tsd and weight within 1e-5 in all but 1e-4 of
    the cells."""
    scan = next(payload[0] for kind, _, *payload in ct_drive(1) if kind == "scan")
    opts = cfg.TSDFRangeDataInserterOptions3D(normal_computation_method="KNN_PCA", min_range=0.4, max_range=60.0)
    insert = make_tsdf_inserter_3d(opts, 0.1)

    def on(dev):
        grid = make_tsdf_grid(0.1, (size,) * 3, 0.3, 1000.0, dev)
        rd = RangeData(torch.zeros(3, device=dev), PointCloud(torch.from_numpy(scan.ranges.positions).to(dev),
                                                              torch.from_numpy(scan.ranges.mask).to(dev)),
                       pad_cloud(np.zeros((0, 3), np.float32), 4, dev))
        return grid, rd

    grid, rd = on(device)
    got = insert(grid, rd)
    ms = cuda_ms(lambda: insert(grid, rd), reps=5)
    want = insert(*on(torch.device("cpu")))
    bad = sum(int(((a.cpu() - b).abs() > 1e-5).sum()) for a, b in ((got.tsd, want.tsd), (got.weight, want.weight)))
    cells = 2 * want.tsd.numel()
    observed = int((want.weight > 0).sum())
    if observed == 0 or bad > max(1, 1e-4 * cells):
        fail(f"phase 17: KNN_PCA insertion on the card differs from the CPU's in {bad} of {cells} values "
             f"({observed} cells observed)")
    print(f"KNN_PCA TSDF insertion of one CT scan ({int(rd.returns.mask.sum())} points) into a {size}^3 grid: "
          f"{observed} cells observed, {bad} of {cells} values beyond 1e-5 of the CPU's (C3 allows "
          f"{int(max(1, 1e-4 * cells))}); per insertion {ms:.3f} ms (CUDA events, topk and eigh on the card)",
          flush=True)


def run_phase_17(device, picks=range(10, 74, 8)):
    """Phase 17: the CT front end with per-point unwarping over phase 9's
    drive, capturing the solves numbered in `picks` for phase 19, after a
    KNN_PCA insertion check (check_knn_insertion). Returns (the captured
    PendingWindowSolves, K3 per-point launches)."""
    check_knn_insertion(device)
    capture = WindowCapture(picks)
    before = latency_snapshot()
    n, lat, t_err, y_err, builder, counts = run_ct_front_end(device, options=ct_options(per_point=True),
                                                             hook=capture)
    check_ct_drive("CT front end, per-point unwarping (phase 17)", n, lat, t_err, y_err, builder, counts,
                   JAX_CT17_TRANSLATION_ERROR, JAX_CT17_YAW_ERROR, before)
    if len(capture.kept) != len(capture.picks):
        fail(f"phase 17: captured {len(capture.kept)} of {len(capture.picks)} windows")
    return capture.kept, counts["k3_points"]


def run_phase_18(device):
    """Phase 18: per-point unwarping and the DIRECT IMU term over the first
    CT18_SCANS scans of phase 9's drive; the kernels a pair-residual
    evaluation takes with the M = 16 sub-steps (the eager twin) and in the
    preintegration form (K6, one), on the drive's first window. Returns K3
    per-point launches."""
    capture = WindowCapture([0])
    before = latency_snapshot()
    n, lat, t_err, y_err, builder, counts = run_ct_front_end(
        device, n_scans=CT18_SCANS, options=ct_options(per_point=True, direct=True), hook=capture)
    check_ct_drive("CT front end, per-point unwarping and DIRECT IMU (phase 18)", n, lat, t_err, y_err, builder,
                   counts, JAX_CT18_TRANSLATION_ERROR, JAX_CT18_YAW_ERROR, before, direct=True)
    pending = capture.kept[0]
    if pending.direct is None:
        fail("phase 18: the window carries no DIRECT IMU samples")
    pair = lambda direct, n=1: device_kernels(lambda: [window_solver.pair_residuals(
        pending.state0, pending.problem, pending.weights, direct) for _ in range(n)])[1]
    pair(pending.direct)
    direct_kernels = pair(pending.direct)
    # The preintegration form, 20 evaluations in one trace: K6's counter
    # must count 20 launches, and the trace (a floor) no other kernel.
    before_k6, before_eager = window_solver.pair_residuals.launches, window_solver.pair_residuals.eager_on_card
    preint_kernels = pair(None, 20)
    k6 = window_solver.pair_residuals.launches - before_k6
    if k6 != 20 or window_solver.pair_residuals.eager_on_card != before_eager or preint_kernels > 20:
        fail(f"phase 18: 20 pair-residual evaluations in the preintegration form made {k6} K6 launches and "
             f"{preint_kernels} kernels on the trace")
    print(f"phase 18: a pair-residual evaluation takes {direct_kernels} kernels with DIRECT (M = "
          f"{pending.direct.dt.shape[-1]} sub-steps, the eager twin) and 1 in the preintegration form (K6: 20 "
          f"launches counted in 20 evaluations, {preint_kernels} kernels on their trace)", flush=True)
    return counts["k3_points"]


def _stack(items, cls):
    return cls(*(torch.stack(list(leaves)) for leaves in zip(*items)))


def _lane_gaps(batched, single):
    """(max translation/velocity difference m, max rotation angle rad) of
    one lane's state against its serial solve."""
    from hectorgrapher_tpu_torch.transform.rigid import quat_conjugate, quat_multiply

    d = quat_multiply(quat_conjugate(batched.rotation), single.rotation)
    angle = 2.0 * torch.atan2(torch.linalg.vector_norm(d[..., 1:], dim=-1), d[..., 0].abs())
    return (max(float((batched.translation - single.translation).abs().max()),
                float((batched.velocity - single.velocity).abs().max())), float(angle.max()))


def run_batched_windows(device, label, windows, weights, iters, per_point, reps=1):
    """Phase 19: B windows (hi, lo, problem, state0, is_tsdf) in one
    solve_ct_window_batched against B serial solve_ct_window calls. Gates
    each lane within 1e-3 m / 1e-3 rad of its serial solve, final cost
    within 1e-4 relative and not above the initial, and one slotted K3
    launch per batched assembly; `label` names the phase. Returns (batched
    ms, serial ms) medians of `reps` turns after the gated one, and the
    slotted K3 launches of the gated solve."""
    b = len(windows)
    his, los = [w[0] for w in windows], [w[1] for w in windows]
    problems = _stack([w[2] for w in windows], CtProblem)
    states0 = _stack([w[3] for w in windows], CtState)
    is_tsdf = windows[0][4]
    slotted = ct_scan_block_points_slots if per_point else ct_scan_block_slots
    batched = lambda: window_solver.solve_ct_window_batched(his, los, problems, states0, weights, is_tsdf=is_tsdf,
                                                            num_iterations=iters, per_point=per_point)
    serial = lambda: [solve_ct_window(h, lo, p, s0, weights, is_tsdf=is_tsdf, num_iterations=iters,
                                      per_point=per_point) for h, lo, p, s0, _ in windows]
    window_solver.solve_ct_window_batched.assemblies = 0
    slotted.launches = 0
    states, final, initial = batched()
    sync(device)
    assemblies = window_solver.solve_ct_window_batched.assemblies
    n_launches = slotted.launches
    if n_launches != assemblies or assemblies != 1 + iters:
        fail(f"{label}: {slotted.launches} slotted K3 launches for {assemblies} batched assemblies")
    singles = serial()
    worst = [0.0, 0.0, 0.0]
    for lane, (s1, f1, i1) in enumerate(singles):
        gap_t, gap_r = _lane_gaps(CtState(*(x[lane] for x in states)), s1)
        gap_c = abs(float(final[lane]) - float(f1)) / max(abs(float(f1)), 1e-12)
        if gap_t > 1e-3 or gap_r > 1e-3 or gap_c > 1e-4:
            fail(f"{label}: lane {lane} is {gap_t:.3e} m / {gap_r:.3e} rad / cost {gap_c:.3e} from its "
                 "serial solve")
        if not float(final[lane]) <= float(initial[lane]):
            fail(f"{label}: lane {lane}'s final cost {float(final[lane])} is above its initial cost "
                 f"{float(initial[lane])}")
        worst = [max(worst[0], gap_t), max(worst[1], gap_r), max(worst[2], gap_c)]

    def timed(fn):
        sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        return (time.perf_counter() - t0) * 1e3

    t_b, t_s = [], []
    for _ in range(reps):
        t_b.append(timed(batched))
        t_s.append(timed(serial))
    med_b, med_s = float(np.median(t_b)), float(np.median(t_s))
    print(f"batched window solve {label} ({'per-point' if per_point else 'per-scan'}), B={b}, {iters} "
          f"iterations: {assemblies} assemblies, slotted K3 launches {n_launches} (one each); lanes within "
          f"{worst[0]:.2e} m / {worst[1]:.2e} rad / cost {worst[2]:.2e} relative of their serial solves; per batched "
          f"solve median {med_b:.3f} ms against {med_s:.3f} ms for {b} serial solves ({med_s / med_b:.2f}x) over "
          f"{reps} turns", flush=True)
    return med_b, med_s, n_launches


def run_phase_19(device, captured):
    """Phase 19: the batched window solve at B = 8, per-scan and per-point:
    (a) the entry() fixture of phase 8 broadcast to 8 lanes, 8 LM
    iterations, the TPU bench's operating point; (b) 8 distinct full-width
    windows of phase 17's drive, each against clones of its matching
    submap's grids, 12 iterations. Returns {label: (batched ms, serial
    ms)} and the slotted K3 launches of each gated batched solve by path,
    per-scan ({"batched19_entry": n, ...}, ct_scan_block_slots) and
    per-point (ct_scan_block_points_slots)."""
    hi, lo, problem, state, weights = build_ct_example(device)
    entry = [(hi, lo, problem, state, True)] * 8
    drive = [(p.high_grid, p.low_grid, p.problem, p.state0, p.is_tsdf) for p in captured]
    out, per_scan, per_point_paths = {}, {}, {}
    for per_point in (False, True):
        mode = "per_point" if per_point else "per_scan"
        paths = per_point_paths if per_point else per_scan
        *out[f"entry_{mode}"], paths["batched19_entry"] = run_batched_windows(
            device, "phase 19 (a) entry() fixture x 8", entry, weights, 8, per_point)
        *out[f"drive_{mode}"], paths["batched19_drive"] = run_batched_windows(
            device, f"phase 19 (b) {len(drive)} phase-17 windows, own grids", drive, captured[0].weights,
            captured[0].num_iterations, per_point)
    SHARD24_INPUTS["windows"] = (drive, captured[0].weights, captured[0].num_iterations)
    return out, per_scan, per_point_paths


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
SLAM_SPEED, SLAM_REST, SLAM_OUT = 0.8, 0.6, 2.2  # m/s, s at rest, m out (and back): a 6.1 s drive
# The JAX package's MapBuilder on a CPU over the same drive and options
# (async work queue, serial constraint search), two runs of
# tests/jax_slam_reference.py (float64 scan times, as the port gets them):
# 50 nodes, 7 submaps (5 finished), 118 and 107 INTER constraints; the
# returning tail's max local error 0.29587 m both times, its max global
# error 0.04686 / 0.04257 m, the median global error 0.04632 / 0.03556
# m, the max global error 0.20775 / 0.16621 m (the worker thread's timing
# against the front end changes the solves' starting poses). The
# constants are the larger of each pair; the port must stay within twice
# each, or 0.05 m above it.
JAX_SLAM_LATE_GLOBAL, JAX_SLAM_MEDIAN_GLOBAL, JAX_SLAM_MAX_GLOBAL = 0.04686, 0.04632, 0.20775
# Phase 12's: the same drive with the batched constraint search, two runs
# of tests/jax_slam_reference.py --batched on a CPU: 50 nodes, 7 submaps (5
# finished), 113 INTER constraints both times; the tail's local error
# 0.29587 m both times, its global error 0.03765 / 0.03826 m, the median
# global error 0.04196 / 0.03639 m, the max 0.17290 / 0.16654 m. The
# larger of each pair.
JAX_SLAM12_LATE_GLOBAL, JAX_SLAM12_MEDIAN_GLOBAL, JAX_SLAM12_MAX_GLOBAL = 0.03826, 0.04196, 0.17290
# Phase 13's: the same drive with the batched search on the default
# PROBABILITY_GRID submaps, two runs of tests/jax_slam_reference.py
# --batched --probability on a CPU: 50 nodes, 7 submaps (5 finished), 121
# and 120 INTER constraints; the tail's local error 0.29587 m both times,
# its global error 0.05294 / 0.03264 m, the median global error 0.04011 /
# 0.02887 m, the max 0.21637 / 0.19074 m. The larger of each pair.
JAX_SLAM13_LATE_GLOBAL, JAX_SLAM13_MEDIAN_GLOBAL, JAX_SLAM13_MAX_GLOBAL = 0.05294, 0.04011, 0.21637
# Phase 14's: phase 12's drive and options with grid_storage_dtype
# "float16", two runs of tests/jax_slam_reference.py --batched --storage
# float16 on a CPU: 50 nodes, 7 submaps (5 finished), 115 and 118 INTER
# constraints; the tail's local error 0.29587 m both times, its global
# error 0.04138 / 0.04262 m, the median global error 0.04281 / 0.03441 m,
# the max 0.21424 / 0.15861 m. The larger of each pair.
JAX_SLAM14_LATE_GLOBAL, JAX_SLAM14_MEDIAN_GLOBAL, JAX_SLAM14_MAX_GLOBAL = 0.04262, 0.04281, 0.21424
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
    K4 and slotted K3 launches, round_stages), any exception to
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
        t0, mark = time.perf_counter(), recording_mark()
        try:
            if record:
                with score_sums_through(lambda *a: recorded.append((a, fast_scores_3d(*a))) or recorded[-1][1]):
                    results = fn(gated, global_search=global_search)
            else:
                results = fn(gated, global_search=global_search)
            rec = dict(n=len(gated), s=time.perf_counter() - t0, k4=fast_scores_3d.launches - k4,
                       k3=ct_scan_block_slots.launches - k3, stages=round_stages(mark),
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


ROUND_STAGES = ("round.pack", "round.initials", "round.fast_match", "round.gn_prepare", "round.gn",
                "round.gn_readback")


def recording_mark() -> int:
    """The number of spans the open recording holds (0 with none open)."""
    rec = profiling.active_recording()
    return len(rec.spans) if rec is not None else 0


def round_stages(mark: int) -> dict:
    """Seconds of each ROUND_STAGES span that the open recording took on
    this thread after `mark` (recording_mark): one batched round's stages,
    host time (no synchronize; round.gn_readback waits for the device)."""
    rec = profiling.active_recording()
    out, me = {}, threading.get_ident()
    for sp in (rec.spans[mark:] if rec is not None else ()):
        if sp.thread == me and sp.name in ROUND_STAGES:
            out[sp.name] = out.get(sp.name, 0.0) + (sp.end_ns - sp.start_ns) / 1e9
    return out


def stage_medians(stages):
    """Median ms of each ROUND_STAGES stage over round_stages records."""
    return {k: float(np.median([s.get(k, 0.0) for s in stages])) * 1e3 for k in ROUND_STAGES}


# Phase 12 re-runs every ROUNDS_ALONE_STRIDE-th round with the card idle
# (a measurement, no gate rides on it): 6 of the drive's 47 rounds.
ROUNDS_ALONE_STRIDE = 8


def rounds_alone(pg, rounds):
    """Phase 12's rounds again once the drive has drained (no front end;
    the nodes at their final poses): each round batched (the class's own
    _compute_constraints_batched, its stages recorded), then its candidates
    serially at the round's scan range (round_parity), each timed to its
    readback. Returns (batched ms, serial ms, stage records, parity records),
    one entry a round."""
    batched_ms, serial_ms, stages, parity = [], [], [], []
    with profiling.recording():
        for r in rounds:
            torch.cuda.synchronize()
            t0, mark = time.perf_counter(), recording_mark()
            results = PoseGraph3D._compute_constraints_batched(pg, r["gated"], global_search=r["global_search"])
            t1 = time.perf_counter()
            stages.append(round_stages(mark))
            parity.append(round_parity(pg, r["gated"], r["global_search"], results))
            batched_ms.append((t1 - t0) * 1e3)
            serial_ms.append((time.perf_counter() - t1) * 1e3)
    return np.array(batched_ms), np.array(serial_ms), stages, parity


def run_phase_12(device, slam, k4_serial, options=None):
    """Phase 12: run_slam over phase 11's drive with the default batched
    constraint search (slam_options(batched=True), or `options`): K4 once
    per pyramid level for a whole round, K3 once per LM iteration of the
    round's packed GN3D; the recorder on for the whole phase. Gates the
    rounds, the fallbacks, the launches, the errors against the JAX
    package's batched run and the rounds' serial parity, prints the
    phase's lines beside phase 11's latency (`slam`, whose K4 launches were
    k4_serial), then holds K4 with row bases and K3 with slots to their
    plain versions (check_k4_round, check_k3_slots). Last, it re-runs
    every ROUNDS_ALONE_STRIDE-th round with the card otherwise idle,
    batched and serially (rounds_alone), and prints their times. Returns (K4 launches by path,
    packed K3 launches, {kernel: {shape: measure's record}}, (per-scan
    latencies, ms per round, the finished submaps' grid bytes))."""
    fast_correlative_3d.match_fast_3d.score_sums = 0
    fast_scores_3d.launches = 0
    ct_scan_block.launches = 0
    ct_scan_block_slots.launches = 0
    window_solver.solve_ct_window.assemblies = 0
    rounds, recorded = [], []
    with profiling.recording():
        slam12 = run_slam(device, options or slam_options(batched=True), rounds=rounds, recorded=recorded)
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
          f"{ct_scan_block.launches - window_solver.solve_ct_window.assemblies} besides the CT assemblies; "
          f"{len(parity)} rounds re-run serially at the round's scan range: max |dt| "
          f"{max(p[1] for p in parity):.3e} m, max 1-|dq0| {max(p[2] for p in parity):.3e}; pack "
          f"{pg12._pack3d['bytes'] / 2**20:.1f} MiB over {len(pg12._pack3d['order'])} submaps; returning tail local "
          f"{slam12['late_local']:.5f} m, global {slam12['late_global']:.5f} m; global median "
          f"{slam12['median_global']:.5f} m, max {slam12['max_global']:.5f} m (JAX batched on the CPU "
          f"{JAX_SLAM12_LATE_GLOBAL:.5f} / {JAX_SLAM12_MEDIAN_GLOBAL:.5f} / {JAX_SLAM12_MAX_GLOBAL:.5f}); per-scan "
          f"latency median {np.median(lat12):.3f} ms, p95 {np.percentile(lat12, 95):.3f} ms over {len(lat12)} scans "
          f"(phase 11 in this run: {np.median(lat11):.3f} / {np.percentile(lat11, 95):.3f} ms); drive "
          f"{slam12['front_s']:.1f} s, queue drained {slam12['drain_s']:.1f} s after", flush=True)
    print("SLAM 3D batched round stages (the recorder's round spans, host time), median ms: "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()), flush=True)
    shapes = {"fast_scores_3d": check_k4_round(recorded),
              "ct_scan_block": {"gn3d_packed": check_k3_slots(k3_slots_inputs(pg12, device))}}
    alone = rounds[::ROUNDS_ALONE_STRIDE]
    n_alone = sum(r["n"] for r in alone)
    alone_ms, serial_ms, alone_stages, alone_parity = rounds_alone(pg12, alone)
    print(f"SLAM 3D batched rounds re-run after the drive (no front end, final poses): {len(alone)} of "
          f"{len(rounds)} rounds (every {ROUNDS_ALONE_STRIDE}th), {n_alone} candidates; batched per round median "
          f"{np.median(alone_ms):.3f} ms, p95 {np.percentile(alone_ms, 95):.3f} ms, {alone_ms.sum() / n_alone:.3f} ms "
          f"per candidate; the same candidates serially per round median {np.median(serial_ms):.3f} ms, p95 "
          f"{np.percentile(serial_ms, 95):.3f} ms, {serial_ms.sum() / n_alone:.3f} ms per candidate; "
          f"{sum(not p[0] for p in alone_parity)} rounds off the serial results (max |dt| "
          f"{max(p[1] for p in alone_parity):.3e} m, max 1-|dq0| {max(p[2] for p in alone_parity):.3e}); stage "
          "medians ms: " + ", ".join(f"{k} {v:.3f}" for k, v in stage_medians(alone_stages).items()), flush=True)
    grid_bytes = [grid_nbytes(s.submap.high_resolution_grid) + grid_nbytes(s.submap.low_resolution_grid)
                  for s in pg12.submaps if s.finished]
    SHARD24_INPUTS["round_3d"] = shard24_round_3d(pg12)
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
    window_solver.solve_ct_window.assemblies = 0
    rounds, recorded = [], []
    options = slam_options(batched=True, probability=True)
    if options.trajectory_builder_3d.submaps.grid_type != "PROBABILITY_GRID":
        fail("SLAM occupancy: the default submaps are not PROBABILITY_GRID")
    with counted_gn3d_blocks({"serial": 0, "packed": 0}) as gn3d:
        slam13 = run_slam(device, options, rounds=rounds, recorded=recorded)
    pg13, local = slam13.pop("pose_graph"), slam13.pop("local_builder")
    del slam13["map_builder"]
    assemblies = window_solver.solve_ct_window.assemblies
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
    window_solver.solve_ct_window.assemblies = 0
    rounds, recorded = [], []
    options = slam_options(batched=True, storage="float16")
    with counted_gn3d_blocks({"serial": 0, "packed": 0}) as gn3d:
        slam14 = run_slam(device, options, rounds=rounds, recorded=recorded)
    pg14, mb14 = slam14.pop("pose_graph"), slam14.pop("map_builder")
    del slam14["local_builder"]
    assemblies = window_solver.solve_ct_window.assemblies
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


def run_phase_15(device, reps=1, num_iterations=10):
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


SLAM2D_LAPS = 2  # phase 20 drives phase 6's circle twice
SLAM2D_SCANS = SLAM2D_LAPS * (N_SCANS - 1) + 1


def slam2d_overrides():
    """Phase 20's options as replace_deep overrides of MapBuilderOptions:
    the 2D pipeline with phase 6's front end (SLICE_OVERRIDES) and the
    pose-graph overrides of tests/test_map_builder_2d.py make_options(),
    the async work queue and the batched constraint search left at their
    defaults (on). Plain values, so that tests/jax_slam_reference.py
    applies them to the JAX package's options."""
    cb = "pose_graph.constraint_builder."
    return {
        "use_trajectory_builder_2d": True,
        "use_trajectory_builder_3d": False,
        **{f"trajectory_builder_2d.{k}": v for k, v in SLICE_OVERRIDES.items()},
        "pose_graph.optimize_every_n_nodes": 10,
        cb + "sampling_ratio": 1.0,
        cb + "min_score": 0.45,
        cb + "fast_correlative_scan_matcher.linear_search_window": 2.0,
        cb + "max_constraint_distance": 12.0,
    }


def slam2d_options():
    """slam2d_overrides() applied to the port's MapBuilderOptions."""
    return cfg.replace_deep(cfg.MapBuilderOptions(), slam2d_overrides())


def slam2d_scans():
    """Phase 20's drive: circle_scans over SLAM2D_LAPS laps."""
    return circle_scans(SLAM2D_SCANS, laps=SLAM2D_LAPS)


def slam2d_result(pg, scans):
    """Phase 20's counts and errors from a drained 2D pose graph of either
    package, against the truth in the first pose's frame: the returning
    lap's open-loop (local) error, then, after the final optimization, the
    returning lap's, the median and the largest global error."""
    anchor = scans[0][1]
    truth = {round(t * 10): anchor.inverse().compose(pose).t[:2] for t, pose, _, _ in scans}
    lap = N_SCANS - 1
    late = [n for n in pg.nodes if round(n.time * 10) >= lap]
    local_errs = [float(np.linalg.norm(n.local_pose.t[:2] - truth[round(n.time * 10)])) for n in late]
    n_inter = sum(c.tag == "INTER" for c in pg.constraints)
    pg.run_final_optimization()
    global_errs = [float(np.linalg.norm(n.global_pose.t[:2] - truth[round(n.time * 10)])) for n in pg.nodes]
    late_global = [e for n, e in zip(pg.nodes, global_errs) if round(n.time * 10) >= lap]
    return dict(
        nodes=len(pg.nodes), submaps=len(pg.submaps), finished=sum(s.finished for s in pg.submaps), inter=n_inter,
        late_local=max(local_errs), late_global=max(late_global), median_global=float(np.median(global_errs)),
        max_global=max(global_errs), finite=all(np.all(np.isfinite(n.global_pose.t)) for n in pg.nodes),
    )


# Phase 20's JAX reference: tests/jax_slam_reference.py --slam-2d on a CPU
# (float64 scan times), two runs over the same drive and options: 119
# nodes, 10 submaps (8 finished), 489 and 481 INTER constraints; the
# returning lap's local error 0.03261 m both times, its global error
# 0.11209 / 0.12711 m, the median global error 0.05831 / 0.07848 m, the
# max 0.11209 / 0.12711 m (the returning lap holds the largest). The
# larger of each pair; the port must stay within twice each, or 0.05 m
# above it.
JAX_SLAM20_LATE_GLOBAL, JAX_SLAM20_MEDIAN_GLOBAL = 0.12711, 0.07848


@contextlib.contextmanager
def score_sums_2d_through(fn):
    """Route the fast 2D matcher's score sums through fn."""
    fast_correlative_2d.fast_scores_2d = fn
    try:
        yield
    finally:
        fast_correlative_2d.fast_scores_2d = fast_scores_2d


def recorded_k5(fn):
    """Run fn() with every K5 call recorded: ([(arguments, output)], fn())."""
    calls = []

    def recorded(*a):
        out = fast_scores_2d(*a)
        calls.append((a, out))
        return out

    with score_sums_2d_through(recorded):
        result = fn()
    return calls, result


def round_parity_2d(pg, gated, global_search, results):
    """Re-run each candidate of a batched 2D round through the serial path
    (the class's own _compute_constraint, past the phase's wrappers) at the
    round's scan range: the same gate outcome, zbar within 1e-3 m and 1e-3
    rad. Returns (ok, largest translation and angle differences, K5
    launches)."""
    k5 = fast_scores_2d.launches
    scan_range = max(pg._scan_range_bucket(n) for _, _, n, _ in gated)
    pg._scan_range_bucket = lambda node: scan_range
    try:
        serial = [PoseGraph2D._compute_constraint(pg, node, p, global_search=global_search) for _, _, node, p in gated]
    finally:
        del pg._scan_range_bucket
    ok, dt, da = True, 0.0, 0.0
    for a, b in zip(results, serial):
        if (a is None) != (b is None):
            ok = False
        elif a is not None:
            dt = max(dt, float(np.linalg.norm(a.zbar.t - b.zbar.t)))
            d = nq.quat_yaw(a.zbar.q) - nq.quat_yaw(b.zbar.q)
            da = max(da, abs((d + np.pi) % (2 * np.pi) - np.pi))
    return ok and dt <= 1e-3 and da <= 1e-3, dt, da, fast_scores_2d.launches - k5


def probe_rounds_2d(pg, rounds, errors, recorded):
    """Wrap pg._compute_constraints_batched to append each round's record
    to `rounds` (candidates, seconds ending in the refinement's readback,
    K5 launches and the round's search depth, round_stages), any
    exception to `errors`, and the first ROUND_PARITY_ROUNDS rounds' serial
    re-run (round_parity_2d). The first round's K5 calls are appended to
    `recorded` as (arguments, output)."""
    fn = pg._compute_constraints_batched

    def run(gated, global_search=False):
        k5 = fast_scores_2d.launches
        t0, mark = time.perf_counter(), recording_mark()
        try:
            if not recorded:
                calls, results = recorded_k5(lambda: fn(gated, global_search=global_search))
                recorded.extend(calls)
            else:
                results = fn(gated, global_search=global_search)
            scan_range = max(pg._scan_range_bucket(n) for _, _, n, _ in gated)
            depth = pg._search_config(gated[0][3], scan_range, global_search)[0].depth
            rec = dict(n=len(gated), s=time.perf_counter() - t0, k5=fast_scores_2d.launches - k5, depth=depth,
                       submaps=len({sid for _, sid, _, _ in gated}), stages=round_stages(mark),
                       found=sum(r is not None for r in results), parity=None)
            if sum(r["parity"] is not None for r in rounds) < ROUND_PARITY_ROUNDS:
                rec["parity"] = round_parity_2d(pg, gated, global_search, results)
        except Exception as e:
            errors.append(f"_compute_constraints_batched: {e!r}")
            raise
        rounds.append(rec)
        return results

    pg._compute_constraints_batched = run


def k5_gates(label, a, out, block_rows=None):
    """K5's three gates on one call's arguments `a` and output `out`: every
    output within 1e-5 * max(1, max|sum|) of the plain version (sums of at
    most P values below 0.8, in the kernel's fixed order against the plain
    version's chunks of 32), the same bits on a second launch, and, with
    row bases, bit-equal to one call per candidate against its own
    submap's block of block_rows rows. Returns (largest difference, number
    of submaps the call reads)."""
    table, bx, by, valid, cand_t, off_x, off_y, level, dims, cand_base = a
    want = fast_scores_2d_plain(*a)
    again = fast_scores_2d(*a)
    torch.cuda.synchronize()
    e = float((out - want).abs().max())
    if not bool(torch.isfinite(out).all()) or e > 1e-5 * max(1.0, float(want.abs().max())):
        fail(f"K5 fast_scores_2d differs from its plain version at {label}: max {e:.3e}")
    if not torch.equal(out, again):
        fail(f"K5 fast_scores_2d differs between two launches at {label}")
    if cand_base is None:
        return e, 1
    singles = torch.cat([
        fast_scores_2d(table[base:base + block_rows], bx, by, valid, cand_t[k:k + 1], off_x[k:k + 1],
                       off_y[k:k + 1], level, dims) for k, base in enumerate(cand_base.tolist())])
    torch.cuda.synchronize()
    if not torch.equal(out, singles):
        fail(f"K5 fast_scores_2d with row bases is not bit-equal to one call per candidate at {label}")
    return e, len(set(cand_base.tolist()))


def check_k5_calls(label, calls, block_rows=None, all_calls=False):
    """K5 against its plain version on recorded calls (k5_gates). Holds the
    coarse call and the first expansion (every call with all_calls) and
    measures those two. Returns {shape: measure's record}."""
    stats, err = {}, 0.0
    picked = list(enumerate(calls)) if all_calls else [(0, calls[0]), (1, calls[1])]
    for i, (a, out) in picked:
        table, bx, by, valid, cand_t, off_x, off_y, level, dims, cand_base = a
        e, n_sub = k5_gates(f"{label} call {i}", a, out, block_rows)
        err = max(err, e)
        if i < 2:
            shape = f"{label}_{'coarse' if i == 0 else 'expansion'}"
            idx, weight = k5_gather(*a)  # the yardstick's inputs, built outside its timing
            flat_table = table.reshape(-1, 1)
            library = lambda: torch.nn.functional.embedding_bag(idx, flat_table, mode="sum", per_sample_weights=weight)
            c, x, y = out.shape
            stats[shape] = measure(
                "fast_scores_2d", shape, lambda: fast_scores_2d(*a), lambda: fast_scores_2d_plain(*a), a, e,
                library=library, note=f" level {level} C={c} X={x} Y={y} P={bx.shape[1]} R={bx.shape[0]} over "
                                      f"{n_sub} packed submaps{', bit-equal to single calls' if cand_base is not None else ''}"
                                      " (library: embedding_bag, the gather-sum only)")
            del idx, weight
    return stats


# K5's synthetic calls (check_k5_edges): label, X, Y, level, the instance
# the wrapper must pick (ops/fast_scores_2d.py INSTANCES), point slots.
# 9x9 gives the generic instance more tasks than warps, so each round of
# tasks stages its two chunks again; the _long cases stage a row in
# several chunks (P = 4100) in the 2x2 and 5x5 instances.
K5_EDGE_CASES = (("2x2", 2, 2, 0, 1, 2048), ("2x2_level4", 2, 2, 4, 1, 2048), ("5x5", 5, 5, 5, 2, 2048),
                 ("11x11", 11, 11, 5, 3, 2048), ("3x7", 3, 7, 2, 0, 2048), ("9x9", 9, 9, 3, 0, 2048),
                 ("2x2_long", 2, 2, 2, 1, 4100), ("5x5_long", 5, 5, 4, 2, 4100), ("2x2_ragged", 2, 2, 1, 1, 2047))


def k5_edge_args(packed, case, device, seed=SEED):
    """One synthetic K5 call on a pack of phase 20's submaps (its levels,
    grid and row bases) for K5_EDGE_CASES' `case`: 8 point rows of P cells
    from the seed, 80 cells past each edge of the grid; row 0 with no valid
    point, row 1 with every slot valid, row 2 valid only in its last 32
    slots and row 3 only in its last 256 (the last warp's 128-slot groups
    in every instance), rows 4-7 at random; 24 candidates, the first 8 on
    rows 0-7 and 16 more sharing them, each with its own offsets around
    the coarse grid's stride 2^level and a random submap of the pack. The
    ragged case has P = 2047 and one flag row (row 4's) at an odd address.
    Returns K5's arguments."""
    label, nxo, nyo, level, _, p = case
    rng = np.random.default_rng([seed, K5_EDGE_CASES.index(case)])
    (nx, ny), r, c = packed.dims, 8, 24
    i32 = lambda x: torch.tensor(np.asarray(x, np.int32), device=device)
    bx, by = i32(rng.integers(-80, nx + 80, (r, p))), i32(rng.integers(-80, ny + 80, (r, p)))
    valid = rng.random((r, p)) < 0.7
    valid[0], valid[1], valid[2:4] = False, True, False
    valid[2, -32:], valid[3, -256:] = True, True
    if label.endswith("ragged"):
        flags = torch.tensor(np.concatenate([[True], valid[4]]), device=device)[1:]  # at an odd address
    else:
        flags = torch.tensor(valid, device=device)
    cand_t = np.concatenate([np.arange(r), rng.integers(0, r, c - r)])
    span = 1 << level
    off_x = (np.arange(nxo) - nxo // 2) * span - span // 2 + rng.integers(-span, span + 1, (c, 1))
    off_y = (np.arange(nyo) - nyo // 2) * span - span // 2 + rng.integers(-span, span + 1, (c, 1))
    base = torch.tensor(rng.integers(0, packed.count, c) * packed.block_rows, dtype=torch.int64, device=device)
    return (packed.levels, bx, by, flags, i32(cand_t), i32(off_x), i32(off_y), level, packed.dims, base)


def check_k5_edges(packed, device):
    """K5 at every instance and the edge rows (K5_EDGE_CASES, k5_edge_args)
    on a pack of phase 20's submaps: the wrapper's instance, k5_gates, and
    all-zero outputs for the candidates on the row with no valid point.
    Returns the largest difference from the plain version."""
    err = 0.0
    for case in K5_EDGE_CASES:
        label, nxo, nyo, level, inst, p = case
        if k5_instance(nxo, nyo) != inst:
            fail(f"K5 fast_scores_2d picks instance {k5_instance(nxo, nyo)} for {nxo} x {nyo}, not {inst}")
        a = k5_edge_args(packed, case, device)
        out = fast_scores_2d(*a)
        e, _ = k5_gates(f"edge {label}", a, out, packed.block_rows)
        if not label.endswith("ragged") and bool((out[a[4] == 0] != 0).any()):
            fail(f"K5 fast_scores_2d gives a nonzero sum for a row with no valid point at edge {label}")
        err = max(err, e)
    return err


def k5_global_calls(pg, device):
    """K5's calls in a full-submap search (a window of half the grid, the
    full angular range: the global constraint search's shape) of a node of
    phase 20's graph against its first finished submap."""
    sub = next(s for s in pg.submaps if s.finished)
    node = pg.nodes[len(pg.nodes) // 2]
    config, _ = pg._search_config(sub, pg._scan_range_bucket(node), True)
    fast = pg._submap_matcher(sub, config.depth)
    t, yaw = pg._initial_in_grid(node, sub)
    f32 = dict(dtype=torch.float32, device=device)
    initial = Rigid2(torch.tensor(t, **f32), torch.tensor(yaw, **f32))
    calls, _ = recorded_k5(lambda: fast_correlative_2d.match_fast_2d_prepared(fast, node.cloud, initial, config))
    return calls, config


def k5_rows_calls(pg, device, n_submaps=4, n_nodes=3):
    """K5's calls in a round over a pack of n_submaps of phase 20's
    finished submaps: n_nodes nodes of the returning lap, each against
    every packed submap, at the local search's configuration."""
    subs = [s for s in pg.submaps if s.finished][:n_submaps]
    nodes = pg.nodes[-n_nodes:]
    config, _ = pg._search_config(subs[0], max(pg._scan_range_bucket(n) for n in nodes), False)
    packed = pack_submaps_2d([pg._submap_matcher(s, config.depth) for s in subs], device)
    candidates = [(k, node.cloud, Rigid2(*pg._initial_in_grid(node, s))) for node in nodes for k, s in enumerate(subs)]
    calls, _ = recorded_k5(lambda: sharded_fast_matches_2d_packed(packed, candidates, config))
    return calls, packed, len(subs)


def drive_slam2d(device, options, label):
    """MapBuilder 2D -> LocalTrajectoryBuilder2D -> PoseGraph2D over
    slam2d_scans() at `options`, the constraint searches and SPA solves on
    the pose graph's worker thread, the recorder on; then the final
    optimization. The counts of K1, K2 and K5 are set to 0 first. Gates
    (failing as `label`) the work items, K5's launches against the rounds
    and the score sums, K1 / K2 on the front end and on every scan whose
    matching submap holds uint16 codes (a just-finished quantized submap),
    the first ROUND_PARITY_ROUNDS rounds against the serial path, INTER
    constraints found, and the final optimization's cost. Returns a dict
    of the run: the pose graph, slam2d_result's counts and errors, the
    rounds, the first round's recorded K5 calls, and the timings."""
    for kernel in (fast_scores_2d, correlative_prep_2d, correlative_scores_2d):
        kernel.launches = 0
    fast_correlative_2d.match_fast_2d_batched.score_sums = 0
    mb = MapBuilder(options, device=device)
    tb = mb.get_trajectory_builder(mb.add_trajectory_builder())
    pg = mb.pose_graph
    searches, solves, errors, rounds, recorded = [], [], [], [], []
    timed_method(pg, "_compute_constraint", searches, errors)
    timed_method(pg, "_run_optimization", solves, errors)
    probe_rounds_2d(pg, rounds, errors, recorded)
    k7_launches, matched = gn_2d_lm.launches, 0
    with profiling.recording(), k7_sites([]) as k7_calls:
        scans = slam2d_scans()
        latencies, quantized = [], []
        t_start = time.perf_counter()
        for i, (t, _, odom, cloud) in enumerate(scans):
            tb.add_odometry_data(t, odom)
            matching = tb._local.active_submaps.matching_submap
            matched += matching is not None
            k12 = (correlative_prep_2d.launches, correlative_scores_2d.launches)
            t0 = time.perf_counter()
            tb.add_range_data(TimedPointCloudData(t, np.zeros(3, np.float32),
                                                  TimedPointCloud(cloud.positions, cloud.times, cloud.mask)))
            sync(device)
            if i:
                latencies.append(time.perf_counter() - t0)
            if matching is not None and matching.grid.log_odds.dtype == torch.uint16:
                quantized.append((correlative_prep_2d.launches - k12[0], correlative_scores_2d.launches - k12[1]))
        front_s = time.perf_counter() - t_start
        pg.wait_for_all_computations()
        drain_s = time.perf_counter() - t_start - front_s
    k5, score_sums = fast_scores_2d.launches, fast_correlative_2d.match_fast_2d_batched.score_sums
    k12 = (correlative_prep_2d.launches, correlative_scores_2d.launches)
    n_solves = len(solves)
    result = slam2d_result(pg, scans)  # runs the final optimization
    cost0, cost1 = (float(spa.LAST_SOLVE_STATS[k]) for k in ("initial_cost", "final_cost"))
    parity = [r["parity"] for r in rounds if r["parity"] is not None]
    bad_rounds = [(r["k5"], r["depth"]) for r in rounds if r["k5"] != r["depth"]]
    if errors:
        fail(f"{label}: pose-graph work failed: {errors[:3]}")
    if not rounds or bad_rounds or k5 != score_sums or pg.batched_fallbacks:
        fail(f"{label}: {len(rounds)} batched rounds, rounds whose K5 launches are not their levels "
             f"{bad_rounds[:5]}, {k5} K5 launches for {score_sums} score sums, {pg.batched_fallbacks} fallbacks")
    if min(k12) == 0 or any(min(q) == 0 for q in quantized):
        fail(f"{label}: the front end launched K1 / K2 {k12} times, on the scans matched against a uint16 "
             f"submap {quantized}")
    if not result["finite"] or result["finished"] == 0 or result["inter"] == 0:
        fail(f"{label}: {result['finished']} finished submaps, {result['inter']} INTER constraints, finite "
             f"{result['finite']}")
    if not cost1 < cost0:
        fail(f"{label}: the final optimization did not lower the SPA cost: {cost0:.6e} -> {cost1:.6e}")
    if not parity or not all(p[0] for p in parity):
        fail(f"{label}: round parity with the serial path failed: {[p[:3] for p in parity]}")
    # K7: one launch a front-end match (a scan with a matching submap), a
    # round's refinement (its round.gn span) and a serial refinement (the
    # parity re-runs), and no other.
    k7_launches = gn_2d_lm.launches - k7_launches
    sites = collections.Counter(site for site, _, _ in k7_calls)
    round_gn = sum("round.gn" in r["stages"] for r in rounds)
    if (k7_launches != len(k7_calls) or sites["front"] != matched or sites["round"] != round_gn
            or sites[None] or sites["round"] == 0):
        fail(f"{label}: {k7_launches} K7 launches: {dict(sites)} by caller against {matched} matched scans and "
             f"{round_gn} round.gn spans")
    print(f"{label}: K7 launches {k7_launches} = front-end matches {sites['front']} (scans matched) + round.gn "
          f"{sites['round']} + serial refinements {sites['serial']}", flush=True)
    return dict(pg=pg, result=result, rounds=rounds, recorded=recorded, latencies=latencies, searches=searches,
                solves=solves, n_solves=n_solves, k5=k5, score_sums=score_sums, k12=k12, quantized=quantized,
                parity=parity, cost=(cost0, cost1), front_s=front_s, drain_s=drain_s, k7_calls=k7_calls,
                k7_launches=k7_launches)


def print_slam2d(label, run, jax_late, jax_median):
    """Phase 20's and 22a's line: counts, launches, rounds, errors and
    latencies of drive_slam2d's run, and the round stages."""
    result, rounds, parity, (cost0, cost1) = run["result"], run["rounds"], run["parity"], run["cost"]
    lat, search_ms, solve_ms = (np.array(run[k]) * 1e3 for k in ("latencies", "searches", "solves"))
    round_ms = np.array([r["s"] for r in rounds]) * 1e3
    n_cand = [r["n"] for r in rounds]
    print(f"{label}: {result['nodes']} nodes, {result['submaps']} submaps ({result['finished']} finished), "
          f"{result['inter']} INTER constraints, {run['n_solves']} optimizations; K1 / K2 launches {run['k12']} "
          f"({len(run['quantized'])} scans matched against a just-finished uint16 submap); {len(rounds)} batched "
          f"rounds (candidates median {np.median(n_cand):.1f}, max {max(n_cand)}, submaps max "
          f"{max(r['submaps'] for r in rounds)}), each {rounds[0]['depth']}-level round one K5 launch a level: K5 "
          f"launches {run['k5']} = score sums {run['score_sums']} ({sum(p[3] for p in parity)} of them the parity "
          f"re-runs), {len(search_ms)} serial searches; per round median {np.median(round_ms):.3f} ms, p95 "
          f"{np.percentile(round_ms, 95):.3f} ms; serial search median "
          f"{np.median(search_ms) if len(search_ms) else float('nan'):.3f} ms; SPA solve median "
          f"{np.median(solve_ms):.3f} ms, max {solve_ms.max():.3f} ms over {len(solve_ms)}; final optimization cost "
          f"{cost0:.6e} -> {cost1:.6e}; {len(parity)} rounds re-run serially: max |dt| {max(p[1] for p in parity):.3e} "
          f"m, max |da| {max(p[2] for p in parity):.3e} rad; returning lap local {result['late_local']:.5f} m, global "
          f"{result['late_global']:.5f} m; global median {result['median_global']:.5f} m, max "
          f"{result['max_global']:.5f} m (JAX on the CPU {jax_late:.5f} / {jax_median:.5f}); "
          f"per-scan latency median {np.median(lat):.3f} ms, p95 {np.percentile(lat, 95):.3f} ms over {len(lat)} scans; "
          f"drive {run['front_s']:.1f} s, queue drained {run['drain_s']:.1f} s after", flush=True)
    print(f"{label} round stages (the recorder's round spans, host time), median ms: "
          + ", ".join(f"{k} {v:.3f}" for k, v in stage_medians([r["stages"] for r in rounds]).items()), flush=True)


def check_slam2d_errors(label, result, jax_late, jax_median, note=""):
    """The returning lap's and the median global error within max(2x, +0.05
    m) of the JAX package's on the same drive (C19's spread)."""
    for key, jax_err in (("late_global", jax_late), ("median_global", jax_median)):
        if result[key] > max(2 * jax_err, jax_err + 0.05):
            fail(f"{label}: {key} error {result[key]:.5f} m exceeds max(2 x, +0.05 m) of the JAX package's "
                 f"{jax_err:.5f}{note}")


def slam2d_stats(run):
    """(per-scan median and p95 ms, round median ms) of a drive_slam2d run."""
    lat = np.array(run["latencies"]) * 1e3
    return (float(np.median(lat)), float(np.percentile(lat, 95)),
            float(np.median([r["s"] for r in run["rounds"]])) * 1e3)


def run_phase_20(device):
    """Phase 20: drive_slam2d at slam2d_options() over two laps of phase
    6's circle at the front end's full width (640^2 submaps, 2048 points,
    online correlative matching through K1 and K2, the default batched
    search through K5), then the returning lap's global error against the
    JAX package's; then holds K5 to its plain version at the first round's
    shapes, a full-submap search's and a round over >= 3 packed submaps.
    Returns (K5 launches of the run, K1 / K2 launches, {shape: measure's
    record}, slam2d_stats, grid bytes of a finished submap)."""
    run = drive_slam2d(device, slam2d_options(), "SLAM 2D")
    pg = run["pg"]
    check_slam2d_errors("SLAM 2D", run["result"], JAX_SLAM20_LATE_GLOBAL, JAX_SLAM20_MEDIAN_GLOBAL)
    print_slam2d("SLAM 2D", run, JAX_SLAM20_LATE_GLOBAL, JAX_SLAM20_MEDIAN_GLOBAL)
    rounds, recorded = run["rounds"], run["recorded"]
    stats = check_k5_calls("round", recorded, pg._packs2d[rounds[0]["depth"]]["packed"].block_rows, all_calls=True)
    calls, config = k5_global_calls(pg, device)
    stats.update(check_k5_calls("global", calls))
    print(f"fast_scores_2d global: a full-submap search ({2 * config.num_angles + 1} angles, {config.depth} levels, "
          f"{calls[0][0][5].shape[1]} x {calls[0][0][6].shape[1]} coarse offsets)", flush=True)
    calls, packed, n_sub = k5_rows_calls(pg, device)
    stats.update(check_k5_calls("rows", calls, packed.block_rows, all_calls=True))
    edge_err = check_k5_edges(packed, device)
    print(f"fast_scores_2d edges: {', '.join(f'{c[0]} (instance {c[4]}, P={c[5]})' for c in K5_EDGE_CASES)}; "
          f"2x2_ragged with one flag row at an odd address; on {n_sub} packed submaps, rows with no valid point, all valid, the last 32 and "
          f"the last 256 slots only, shared rows: within tolerance (max |d| {edge_err:.3e}), two launches and row "
          "bases bit-equal, empty rows zero", flush=True)
    finished_bytes = grid_nbytes(next(s for s in pg.submaps if s.finished).submap.grid)
    SHARD24_INPUTS["round_2d"] = shard24_round_2d(pg)
    # K7 against its twin on every refinement of the drive; the timed row
    # is the round with the most lanes.
    calls = run.pop("k7_calls")
    rounds_k7 = [c[1:] for c in calls if c[0] == "round"]
    widest = max(range(len(rounds_k7)), key=lambda i: rounds_k7[i][0][0][0].shape[0])
    k7 = {"launches": run["k7_launches"], "round": check_k7("round", rounds_k7, lanes=True, timed=widest)}
    check_k7("slam20_front_and_serial", [c[1:] for c in calls if c[0] != "round"])
    del calls, rounds_k7
    return (run["k5"] - sum(p[3] for p in run["parity"]), run["k12"], stats, slam2d_stats(run), finished_bytes, k7)


# Phase 22a's JAX reference: tests/jax_slam_reference.py --slam-2d
# --storage uint16 on a CPU, two runs over phase 20's drive with
# grid_storage_dtype "uint16" (float64 scan times): 119 nodes, 10 submaps
# (8 finished), 490 and 479 INTER constraints; the returning lap's local
# error 0.03272 m both times, its global error 0.11341 / 0.12084 m, the
# median global error 0.05743 / 0.07447 m. The larger of each pair; the
# port must stay within twice each, or 0.05 m above it (C19's spread).
JAX_SLAM22_LATE_GLOBAL, JAX_SLAM22_MEDIAN_GLOBAL = 0.12084, 0.07447
# A finished 640^2 submap's planes: uint16 codes and the bool known mask,
# against f32 log-odds and the mask.
U16_SUBMAP_BYTES, F32_SUBMAP_BYTES = 640 * 640 * 3, 640 * 640 * 5


def run_phase_22a(device, stats20, bytes20):
    """Phase 22a: drive_slam2d over phase 20's drive and options with
    grid_storage_dtype "uint16": every finished submap holds uint16 codes,
    the scans matched against a just-quantized submap (K1 and K2 on each,
    the decoded grid's table), K5 on every round over the decoded levels;
    the global errors against the JAX package's uint16 run. Prints the
    bytes of a finished submap and the per-scan and per-round times beside
    phase 20's (stats20, bytes20) from this call. Returns (K5 launches,
    K1 / K2 launches, K7 launches)."""
    label = "SLAM 2D uint16 (phase 22a)"
    run = drive_slam2d(device, cfg.replace_deep(slam2d_options(), {
        "trajectory_builder_2d.submaps.grid_storage_dtype": "uint16"}), label)
    del run["k7_calls"]
    pg = run["pg"]
    finished = [s.submap.grid for s in pg.submaps if s.finished]
    dtypes = {str(g.log_odds.dtype) for g in finished}
    if dtypes != {"torch.uint16"}:
        fail(f"{label}: finished submaps hold {dtypes}, not uint16 codes")
    if not run["quantized"]:
        fail(f"{label}: no scan was matched against a just-finished uint16 submap")
    nbytes = {grid_nbytes(g) for g in finished}
    if nbytes != {U16_SUBMAP_BYTES} or bytes20 != F32_SUBMAP_BYTES:
        fail(f"{label}: a finished submap holds {nbytes} B (phase 20: {bytes20} B), not {U16_SUBMAP_BYTES} "
             f"({F32_SUBMAP_BYTES})")
    check_slam2d_errors(label, run["result"], JAX_SLAM22_LATE_GLOBAL, JAX_SLAM22_MEDIAN_GLOBAL)
    print_slam2d(label, run, JAX_SLAM22_LATE_GLOBAL, JAX_SLAM22_MEDIAN_GLOBAL)
    med, p95, round_ms = slam2d_stats(run)
    print(f"{label}: a finished submap {U16_SUBMAP_BYTES} B against phase 20's {bytes20} B "
          f"({U16_SUBMAP_BYTES / bytes20:.3f}); per-scan median {med:.3f} ms, p95 {p95:.3f} ms, per round "
          f"{round_ms:.3f} ms; phase 20 in this call: {stats20[0]:.3f} / {stats20[1]:.3f} / {stats20[2]:.3f} ms",
          flush=True)
    return run["k5"] - sum(p[3] for p in run["parity"]), run["k12"], run["k7_launches"]


# Phase 22b's JAX references: tests/jax_slam_reference.py --front-end-2d
# --grid-type TSDF --storage S on a CPU (float64 scan times), phase 6's 60
# scans through the JAX LocalTrajectoryBuilder2D on TSDF submaps of storage
# S: its max translation and yaw errors (0.303284 m / 0.106431 rad in
# float32 and uint16, 0.303286 / 0.106432 in float16, 0.303285 / 0.106432
# in bfloat16), rounded up. The JAX half runs widen the planes to f32 at the
# first insert (ROADMAP C21); the port keeps them half, and is held to the
# JAX run all the same. The JAX 2D TSDF front end drifts ten times as far
# as its probability one on these scans (0.02864 m; ROADMAP C22).
JAX_TSDF22_ERRORS = {"float32": (0.30329, 0.10644), "float16": (0.30329, 0.10644), "bfloat16": (0.30329, 0.10644),
                     "uint16": (0.30329, 0.10644)}


def tsdf_front_end_options(storage):
    """Phase 22b's options: phase 6's (SLICE_OVERRIDES) on TSDF submaps
    of grid_storage_dtype `storage`."""
    return cfg.replace_deep(slice_options(), {"submaps.grid_options_2d.grid_type": "TSDF",
                                              "submaps.grid_storage_dtype": storage})


def run_phase_22b(device):
    """Phase 22b: LocalTrajectoryBuilder2D on TSDF submaps over phase 6's
    60 scans in each grid_storage_dtype: the grids hold their storage
    dtype after the drive (ROADMAP C21; uint16 after a finish, with scans
    matched against the quantized submap), no correlative kernel runs (the
    TSDF front end skips the matcher, as in the JAX package), and the
    largest errors are within max(2x, +0.05 m) (yaw max(2x, +0.01 rad)) of
    the JAX package's on the same scans; every matched scan one K7 launch
    in its TSDF mode, held to its twin. Returns {path: K7 launches}."""
    k7_paths = {}
    for storage, (jax_t, jax_y) in JAX_TSDF22_ERRORS.items():
        label = f"TSDF front end {storage} (phase 22b)"
        correlative_prep_2d.launches = correlative_scores_2d.launches = 0
        with k7_sites([]) as k7_calls:
            n_matched, latencies, t_err, y_err, builder, n_quantized = run_front_end(
                device, options=tsdf_front_end_options(storage))
        k12 = (correlative_prep_2d.launches, correlative_scores_2d.launches)
        if len(k7_calls) != n_matched or any(len(a[0]) != 2 for _, a, _ in k7_calls):
            fail(f"{label}: {len(k7_calls)} K7 launches for {n_matched} matched scans, or not all in the TSDF mode")
        check_k7(f"tsdf22b_{storage}", [c[1:] for c in k7_calls])
        k7_paths[f"tsdf22b_{storage}"] = len(k7_calls)
        del k7_calls
        submaps = builder.active_submaps.submaps
        grids = [s.grid for s in submaps]
        # uint16: f32 while active, codes once finished.
        want = [STORAGE_DTYPES["float32" if storage == "uint16" and not s.insertion_finished else storage]
                for s in submaps]
        if [(g.tsd.dtype, g.weight.dtype) for g in grids] != [(w, w) for w in want] or k12 != (0, 0):
            fail(f"{label}: the active grids hold {[str(g.tsd.dtype) for g in grids]}, not {want}; K1 / K2 {k12}")
        if storage == "uint16" and n_quantized == 0:
            fail(f"{label}: no scan was matched against a quantized submap")
        if not bool((grids[0].weight.to(torch.float32) > 0).any()):
            fail(f"{label}: the matching submap has no observed cell")
        if t_err > max(2 * jax_t, jax_t + 0.05) or y_err > max(2 * jax_y, jax_y + 0.01):
            fail(f"{label}: max error {t_err:.5f} m / {y_err:.5f} rad exceeds max(2 x, +0.05 m / +0.01 rad) of "
                 f"the JAX package's {jax_t:.5f} / {jax_y:.5f}"
                 + (" (JAX's planes widen to f32 at the first insert, C21)" if storage in ("float16", "bfloat16")
                    else ""))
        lat_ms = np.array(latencies) * 1e3
        nbytes = grid_nbytes(quantize_tsdf_grid(grids[-1]) if storage == "uint16" else grids[-1])
        print(f"{label}: {n_matched} matched scans ({n_quantized} against a quantized submap), K1 / K2 {k12}; max "
              f"error {t_err:.5f} m / {y_err:.5f} rad (JAX on the CPU {jax_t:.5f} / {jax_y:.5f}"
              + (", its planes widened to f32, C21" if storage in ("float16", "bfloat16") else "")
              + f"); grids {[str(g.tsd.dtype) for g in grids]}, {nbytes} B a "
              f"{'finished ' if storage == 'uint16' else ''}submap; "
              f"per-scan latency median {np.median(lat_ms):.3f} ms, p95 {np.percentile(lat_ms, 95):.3f} ms", flush=True)
    return k7_paths


def run_phase_21(device, reps=1, num_iterations=10):
    """Phase 21: the 2D SPA on generated graphs (make_scale_spa_problem_2d,
    0.5 m / 0.02 rad noise): solve_spa_2d with "auto" on 1000 nodes, 100
    submaps and 4000 constraints (S*N = 1e5, the Schur path) and on 5000 /
    500 / 20000 (2.5e6, above the Schur budget: the PCG path), the big one
    through the Schur path as well; solve_spa_2d_full on the small graph
    with the odometry chain of a pose graph. Gates: node and submap errors
    to the truth below 0.01 m, final costs below 1, the PCG within 5e-3 m
    of the Schur path. Prints ms per solve (median over `reps` after one
    checked solve), LM and PCG iterations, kernels and host syncs a
    solve."""
    small = make_scale_spa_problem_2d(1000, 100, 4000, noise=0.5, seed=0, device=device)
    big = make_scale_spa_problem_2d(5000, 500, 20000, noise=0.5, seed=0, device=device)
    cases = [("schur_auto", small, "auto", False), ("pcg_auto", big, "auto", False), ("schur", big, "schur", False),
             ("full", small, None, True)]
    stats, nodes = {}, {}
    for name, (problem, gt, s_gt), solver, full in cases:
        extras = odometry_extras_2d(gt, device=device) if full else None
        solve = ((lambda: spa.solve_spa_2d_full(problem, extras, num_iterations=num_iterations)) if full else
                 (lambda: spa.solve_spa_2d(problem, num_iterations=num_iterations, linear_solver=solver)))
        result, kernels = device_kernels(solve)
        st = dict(spa.LAST_SOLVE_STATS, kernels=kernels)
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solve()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        sp, np_, cost = result[0].cpu().numpy(), result[1].cpu().numpy(), float(result[-1])
        nodes[name] = np_
        node_err = float(np.linalg.norm(np_[:, :2] - gt[:, :2], axis=1).max())
        sub_err = float(np.linalg.norm(sp[:, :2] - s_gt[:, :2], axis=1).max())
        st.update(ms=statistics.median(times), node_err=node_err, submap_err=sub_err, cost=cost,
                  n=problem.node_pose.shape[0], s=problem.submap_pose.shape[0], c=problem.c_mask.shape[0])
        stats[name] = st
        if not (node_err < 0.01 and sub_err < 0.01 and cost < 1.0):
            fail(f"SPA 2D {name}: node error {node_err:.3e} m, submap error {sub_err:.3e} m, cost {cost}")
    if (stats["schur_auto"]["linear_solver"], stats["pcg_auto"]["linear_solver"]) != ("schur", "cg"):
        fail(f"SPA 2D: auto took {stats['schur_auto']['linear_solver']!r} / {stats['pcg_auto']['linear_solver']!r}")
    gap = float(np.abs(nodes["pcg_auto"][:, :2] - nodes["schur"][:, :2]).max())
    if not gap < 5e-3:
        fail(f"SPA 2D: the PCG path is {gap:.3e} m off the Schur path")
    print("SPA 2D: " + "; ".join(
        f"{name} (N={st['n']}, S={st['s']}, C={st['c']}, {st['linear_solver']}): {st['ms']:.3f} ms per solve (median "
        f"of {reps}), {st['lm_iterations']} LM steps"
        + (f", PCG iterations per step {st['cg_iterations']}" if st["cg_iterations"] else "")
        + f", {st['kernels']} kernels and {st['host_syncs']} host syncs a solve, node error {st['node_err']:.3e} m, "
        f"submap error {st['submap_err']:.3e} m, cost {st['cost']:.3e}" for name, st in stats.items())
        + f"; PCG vs Schur max |dt| {gap:.3e} m", flush=True)
    return stats


# ---------------------------------------------------------------------------
# Phase 23: the serving path
# ---------------------------------------------------------------------------

SERVE_TRAJECTORIES = 8  # the B = 8 of phase 19 and of bench.py:363-414's multi-robot point
SERVE_SCANS = 26  # per trajectory: >= 16 results after the front end's initialization, one submap finished
SERVE_SPEED_STEP = 0.05  # m/s more for each trajectory, as tests/test_ct_batcher.py:61-85 offsets them
# Batched against serial poses over the whole drive, m and rad: the
# secondary gate. A lane of the batched solve rounds apart from its single
# solve, and over the drive that compounds: an LM accept at a converged
# step flips, the window ends elsewhere within the LM's tolerance, its
# clouds are inserted there, and later windows match against that map.
# Batched against serial the drive ended 1.8e-2 and 2.1e-2 m, 5.1e-3 and
# 8.0e-3 rad apart in the first two runs on an H100, and 4.1e-3 m / 1.5e-3
# rad in 2 of 10 CPU rehearsals (3e-7 m in the rest). The primary gate is
# per lane (check_served_batch): a served batch re-solved batched and one
# window at a time, each lane within phase 19's 1e-3.
SERVE_TRANSLATION_TOLERANCE, SERVE_ROTATION_TOLERANCE = 0.05, 0.02
SERVE_MIN_RESULTS = 16
# The serial server runs the first SERVE_SERIAL_SCANS scans of each stream
# (a cut of depth: 26 scans took 81.4 s of it on an H100); the batched
# server's results over those scans are held to its (the front end is
# causal, so a stream's prefix gives the same results).
SERVE_SERIAL_SCANS = 16
SERVE_SERIAL_MIN_RESULTS = 6
# Phase 23a's error bounds: each trajectory's max translation and yaw
# errors (m, rad) when its stream goes through the JAX package's CT front
# end on a CPU at phase 23's front-end options (tests/jax_slam_reference.py
# --serve: 17 results and 21 window solves a trajectory, as the port
# gives). Each served trajectory must stay within twice its pair, or
# 0.05 m / 0.01 rad above it (phase 9's rule).
JAX_SERVE_ERRORS = ((0.08658, 0.01856), (0.12854, 0.02375), (0.16292, 0.02231), (0.20291, 0.02353),
                    (0.12473, 0.02403), (0.18113, 0.01871), (0.25689, 0.02233), (0.25865, 0.01067))


def serve_overrides():
    """Phase 23's MapBuilderOptions overrides: the CT front end at phase 9's
    full width (ct_overrides(): the TrajectoryBuilder3DOptions defaults,
    256^3 / 128^3 TSDF, K = C = 32, P = 256, 12 LM iterations) with submaps
    of 8 scans in place of 160 (slam_overrides' value: the submaps finish
    inside the drive, which 23b and 23c read); the pose graph at phase 12's
    (slam_overrides(batched=True): the batched search, async work queue)."""
    out = {"use_trajectory_builder_3d": True, "trajectory_builder_3d.submaps.num_range_data": 8}
    out.update({f"trajectory_builder_3d.{k}": v for k, v in ct_overrides().items()})
    out.update({k: v for k, v in slam_overrides(batched=True).items() if k.startswith("pose_graph.")})
    return out


def serve_options():
    return cfg.replace_deep(cfg.MapBuilderOptions(), serve_overrides())


def serve_streams(n_traj, n_scans):
    """Each trajectory's (trajectory_id, kind, payload) items in time order:
    ct_drive's box room with seed SEED + id at CT_SPEED + SERVE_SPEED_STEP *
    id. Every stream has the same kinds at the same times."""
    kinds = {"imu": "imu", "odom": "odometry", "scan": "range"}
    return [[(tid, kinds[kind], payload[0] if kind == "scan" else (t, *payload))
             for kind, t, *payload in ct_drive(n_scans, seed=SEED + tid, speed=CT_SPEED + SERVE_SPEED_STEP * tid)]
            for tid in range(n_traj)]


class PayloadRecorder:
    """A TrajectoryBuilder callback keeping each inserted result as the
    uplink receives it: make_local_slam_result_payload with the server's
    starting-index rule (cloud/server.py _upload_local_slam_result), then
    through wire.dumps / wire.loads."""

    def __init__(self):
        self.payloads, self.start, self.wire_bytes = [], 0, 0

    def __call__(self, trajectory_id, result):
        if result.insertion_result is None:
            return
        payload = make_local_slam_result_payload(result, True, self.start)
        if result.insertion_result.insertion_submaps[0].insertion_finished:
            self.start += 1
        data = wire.dumps(payload)
        self.wire_bytes += len(data)
        self.payloads.append(wire.loads(data))


def serve_drive(device, options, streams, batch):
    """Phase 23a on one server: a MapBuilderServer on the card bound to
    gRPC on loopback, len(streams) trajectories added and fed round-robin
    through MapBuilderStub, as robots stream; wait_until_idle, then the
    pose graph's queue drained. Returns the run's record."""
    from hectorgrapher_tpu_torch.cloud.client import MapBuilderStub

    srv = MapBuilderServer(MapBuilder(options, device=device), batch_ct_windows=batch)
    srv.start()
    stub = MapBuilderStub(f"127.0.0.1:{srv.port}")
    tids = [stub.add_trajectory_builder() for _ in streams]
    pg = srv.map_builder.pose_graph
    errors, scans, searches, solves, batched = [], [], [], [], []
    for name, times in (("_compute_constraints_batched", searches), ("_compute_constraint", searches),
                        ("_run_optimization", solves), ("_on_submap_finished", [])):
        timed_method(pg, name, times, errors)
    for tid in tids:
        tb = srv.map_builder.get_trajectory_builder(tid)
        add = tb.add_range_data

        def timed_add(data, add=add, local=tb._local):
            t0 = time.perf_counter()
            try:
                return add(data)
            except Exception as e:
                errors.append(f"add_range_data: {e!r}")
                raise
            finally:
                scans.append((time.perf_counter() - t0, local.num_optimizations > 0))

        tb.add_range_data = timed_add
    recorder = PayloadRecorder()
    srv.map_builder.get_trajectory_builder(tids[0])._callback = recorder
    if batch:
        solve_batched = srv.ct_batcher._solve_batched

        def timed_solve(entries):
            t0 = time.perf_counter()
            try:
                solve_batched(entries)
                sync(device)
            except Exception as e:
                errors.append(f"_solve_batched: {e!r}")
                raise
            batched.append((len(entries), time.perf_counter() - t0, [e["pending"] for e in entries]))

        srv.ct_batcher._solve_batched = timed_solve
    builders = [stub.get_trajectory_builder(tid) for tid in tids]
    t0 = time.perf_counter()
    for group in zip(*streams):
        for tid, kind, payload in group:
            if kind == "imu":
                builders[tid].add_imu_data(*payload)
            elif kind == "odometry":
                builders[tid].add_odometry_data(*payload)
            else:
                builders[tid].add_range_data(payload)
    srv.wait_until_idle()
    seconds = time.perf_counter() - t0
    pg.wait_for_all_computations()
    results = {tid: stub.get_local_slam_results(tid) for tid in tids}
    return dict(server=srv, stub=stub, results=results, seconds=seconds, errors=errors, scans=scans,
                searches=searches, solves=solves, batched=batched, recorder=recorder, options=options,
                window_solves=sum(srv.map_builder.get_trajectory_builder(t)._local.num_optimizations for t in tids))


def check_served_batch(device, batches):
    """Phase 23a's per-lane gate on the served windows: the last batch of
    the largest B the server solved, re-solved once as one
    solve_ct_window_batched and once one window at a time
    (run_batched_windows: each lane within phase 19's 1e-3 m / 1e-3 rad and
    1e-4 relative cost of its single solve, one slotted K3 launch an
    assembly), then both timed once more. The grids are the submaps' as
    they stand after the drive, the same for both solves. Returns (B,
    batched ms, serial ms)."""
    b = max(len(pendings) for _, _, pendings in batches)
    pendings = [pendings for _, _, pendings in batches if len(pendings) == b][-1]
    p0 = pendings[0]
    windows = [(p.high_grid, p.low_grid, p.problem, p.state0, p.is_tsdf) for p in pendings]
    ms_b, ms_s, _ = run_batched_windows(device, "phase 23a served batch", windows, p0.weights, p0.num_iterations,
                                        p0.per_point)
    return b, ms_b, ms_s


def serve_latency(run):
    """(median, p95) ms of the range items from each trajectory's first
    window solve on."""
    ms = np.array([s for s, solved in run["scans"] if solved]) * 1e3
    return float(np.median(ms)), float(np.percentile(ms, 95))


def serve_gaps(results_a, results_b):
    """(largest translation m, rotation rad) between two servers'
    results, trajectory by trajectory."""
    gap_t = gap_r = 0.0
    for tid, got in results_a.items():
        for (_, a), (_, b) in zip(got, results_b[tid]):
            gap_t = max(gap_t, float(np.abs(a.t - b.t).max()))
            gap_r = max(gap_r, float(nq.quat_angle(nq.quat_multiply(nq.quat_conjugate(b.q), a.q))))
    return gap_t, gap_r


def run_phase_23a(device, n_traj=SERVE_TRAJECTORIES, n_scans=SERVE_SCANS, options=None,
                  min_results=SERVE_MIN_RESULTS, jax_errors=JAX_SERVE_ERRORS, serial_scans=SERVE_SERIAL_SCANS):
    """Phase 23a: multi-robot CT serving, n_traj trajectories on one
    batch_ct_windows server, then the first serial_scans scans of the same
    streams on a serial server. Gates:
    batched solves with a largest B >= 4 (B = n_traj below 4), one slotted
    K3 launch a batched assembly, the last served batch of the largest B
    re-solved lane by lane within phase 19's 1e-3 (check_served_batch),
    every trajectory the serial server's result times and poses within
    SERVE_TRANSLATION_TOLERANCE and SERVE_ROTATION_TOLERANCE over the
    serial server's results (at least SERVE_SERIAL_MIN_RESULTS), each
    trajectory's largest errors against its truth within max(2x, +0.05 m /
    +0.01 rad) of the JAX package's on the same stream (jax_errors, phase
    9's rule), no error in a worker, the batcher or the pose graph. Returns
    (the batched run, launches by path)."""
    options = options or serve_options()
    iters = options.trajectory_builder_3d.optimizing_local_trajectory_builder.max_num_iterations
    streams = serve_streams(n_traj, n_scans)
    slotted_calls = [0]
    real_slotted = window_solver.ct_scan_block_slots

    def counted_slotted(*a, **kw):
        slotted_calls[0] += 1
        return real_slotted(*a, **kw)

    window_solver.ct_scan_block_slots = counted_slotted
    k3_before, slots_before, k4_before = ct_scan_block.launches, ct_scan_block_slots.launches, fast_scores_3d.launches
    assemblies_before = window_solver.solve_ct_window_batched.assemblies
    try:
        run_b = serve_drive(device, options, streams, batch=True)
        assemblies = window_solver.solve_ct_window_batched.assemblies - assemblies_before
        window_calls = slotted_calls[0]
        k3_mid = ct_scan_block.launches
        serial_scans = min(serial_scans, n_scans)
        run_s = serve_drive(device, options, serve_streams(n_traj, serial_scans), batch=False)
    finally:
        window_solver.ct_scan_block_slots = real_slotted
    paths = {"ct_scan_block": {"serve23_batched_windows": window_calls,
                               "serve23_serial_server": ct_scan_block.launches - k3_mid,
                               "serve23_slotted_all": ct_scan_block_slots.launches - slots_before},
             "fast_scores_3d": {"serve23": fast_scores_3d.launches - k4_before}}
    batcher = run_b["server"].ct_batcher
    label = f"phase 23a ({n_traj} trajectories x {n_scans} scans)"
    for run, name in ((run_b, "batched"), (run_s, "serial")):
        if run["errors"]:
            fail(f"{label}: the {name} server logged errors: {run['errors'][:3]}")
    if batcher.batched_launches == 0 or max(batcher.batch_sizes) < min(4, n_traj):
        fail(f"{label}: batched solves {batcher.batched_launches}, batch sizes {batcher.batch_sizes}")
    if window_calls != assemblies or assemblies != batcher.batched_launches * (1 + iters):
        fail(f"{label}: {window_calls} slotted K3 calls for {assemblies} batched assemblies of "
             f"{batcher.batched_launches} batched solves")
    if ct_scan_block_slots.launches - slots_before < window_calls:
        fail(f"{label}: {ct_scan_block_slots.launches - slots_before} slotted K3 launches for {window_calls} calls")
    worst = []  # each trajectory's (translation m, yaw rad, bound m, bound rad)
    for tid, got in run_b["results"].items():
        want = run_s["results"][tid]
        if ([t for t, _ in got][:len(want)] != [t for t, _ in want] or len(got) < min_results
                or len(want) < min(SERVE_SERIAL_MIN_RESULTS, min_results)):
            fail(f"{label}: trajectory {tid}: {len(got)} batched and {len(want)} serial results (over "
                 f"{serial_scans} scans), or other times")
        speed = CT_SPEED + SERVE_SPEED_STEP * tid
        errs = [ct_pose_error(t, pose.t, pose.q, speed) for t, pose in got]
        e_t, e_y = max(e for e, _ in errs), max(e for _, e in errs)
        jax_t, jax_y = jax_errors[tid]
        b_t, b_y = max(2 * jax_t, jax_t + 0.05), max(2 * jax_y, jax_y + 0.01)
        worst.append((e_t, e_y, b_t, b_y))
        if e_t > b_t or e_y > b_y:
            fail(f"{label}: trajectory {tid}: max error {e_t:.5f} m / {e_y:.5f} rad exceeds {b_t:.5f} m / "
                 f"{b_y:.5f} rad (JAX on the CPU {jax_t:.5f} / {jax_y:.5f})")
    lane_b, lane_ms_b, lane_ms_s = check_served_batch(device, run_b["batched"])
    gap_t, gap_r = serve_gaps(run_b["results"], run_s["results"])
    if gap_t > SERVE_TRANSLATION_TOLERANCE or gap_r > SERVE_ROTATION_TOLERANCE:
        fail(f"{label}: batched poses {gap_t:.3e} m / {gap_r:.3e} rad from the serial server's")
    n_results = sum(len(r) for r in run_b["results"].values())
    sizes = dict(sorted(collections.Counter(batcher.batch_sizes).items()))
    by_b = {b: float(np.median([s for bb, s, _ in run_b["batched"] if bb == b])) * 1e3 for b in sizes}
    lat_b, lat_s = serve_latency(run_b), serve_latency(run_s)
    scans = n_traj * n_scans
    print(f"{label}, gRPC on loopback: batched server {scans / run_b['seconds']:.3f} scans/s ({run_b['seconds']:.3f} s "
          f"from the first item to wait_until_idle), serial server over the first {serial_scans} scans "
          f"{n_traj * serial_scans / run_s['seconds']:.3f} scans/s ({run_s['seconds']:.3f} s); per-scan latency "
          f"median (p95) batched {lat_b[0]:.3f} ({lat_b[1]:.3f}) ms, "
          f"serial {lat_s[0]:.3f} ({lat_s[1]:.3f}) ms; {batcher.batched_launches} batched solves, batch sizes "
          f"{sizes}, ms per batched solve by B {', '.join(f'{b}: {ms:.3f}' for b, ms in by_b.items())} "
          f"({sum(s for _, s, _ in run_b['batched']):.3f} s in all; the last B = {lane_b} batch again with the card "
          f"idle {lane_ms_b:.3f} ms, its windows one by one {lane_ms_s:.3f} ms); "
          f"{batcher.serial_solves} solves alone in the batched server, {run_s['window_solves']} in the serial "
          f"server; slotted K3 launches {window_calls} = batched assemblies {assemblies}; {n_results} results, "
          f"batched poses within {gap_t:.3e} m / {gap_r:.3e} rad of the serial server's over its "
          f"{sum(len(r) for r in run_s['results'].values())} results; max error by trajectory "
          + ", ".join(f"{w[0]:.5f} m / {w[1]:.5f} rad (bound {w[2]:.5f} / {w[3]:.5f})" for w in worst)
          + f"; on the pose graph's worker, batched / serial "
          f"server: {len(run_b['searches'])} / {len(run_s['searches'])} constraint rounds in "
          f"{sum(run_b['searches']):.3f} / {sum(run_s['searches']):.3f} s, {len(run_b['solves'])} / "
          f"{len(run_s['solves'])} SPA solves in {sum(run_b['solves']):.3f} / {sum(run_s['solves']):.3f} s", flush=True)
    run_s["stub"].close()
    run_s["server"].shutdown()
    return run_b, paths


def _as_stored(plane):
    """A grid plane as a state file or payload gives it back: float planes
    rounded through float16 into float32, uint16 codes and known masks as
    they are."""
    return plane if plane.dtype in (torch.uint16, torch.bool) else plane.to(torch.float16).to(torch.float32)


def state_gaps(pg, loaded, remap):
    """The first difference between a served pose graph and its npz load
    (node poses, times, clouds, histograms; constraints; submap poses and
    every grid plane as stored: TSDF or occupancy), or None."""
    if len(pg.nodes) != len(loaded.nodes) or len(pg.submaps) != len(loaded.submaps):
        return (f"{len(loaded.nodes)} nodes / {len(loaded.submaps)} submaps loaded of {len(pg.nodes)} / "
                f"{len(pg.submaps)}")
    for i, (a, b) in enumerate(zip(pg.nodes, loaded.nodes)):
        pairs = ((a.local_pose.t, b.local_pose.t), (a.local_pose.q, b.local_pose.q), (a.global_pose.t, b.global_pose.t),
                 (a.global_pose.q, b.global_pose.q), (a.histogram, b.histogram))
        same = (a.time == b.time and remap[a.trajectory_id] == b.trajectory_id
                and all(np.array_equal(x, y) for x, y in pairs)
                and torch.equal(a.high_cloud.positions, b.high_cloud.positions)
                and torch.equal(a.low_cloud.mask, b.low_cloud.mask))
        if not same:
            return f"node {i}"
    if [(c.submap_index, c.node_index, c.tag, c.translation_weight) for c in pg.constraints] != [
            (c.submap_index, c.node_index, c.tag, c.translation_weight) for c in loaded.constraints]:
        return "constraint lists"
    if not all(np.array_equal(a.zbar.t, b.zbar.t) and np.array_equal(a.zbar.q, b.zbar.q)
               for a, b in zip(pg.constraints, loaded.constraints)):
        return "constraint poses"
    for i, (a, b) in enumerate(zip(pg.submaps, loaded.submaps)):
        if not (np.array_equal(a.global_pose.t, b.global_pose.t) and a.finished == b.finished
                and np.array_equal(a.submap.rotational_histogram, b.submap.rotational_histogram)):
            return f"submap {i}"
        for key in ("high_resolution_grid", "low_resolution_grid"):
            ga, gb = getattr(a.submap, key), getattr(b.submap, key)
            planes = ("tsd", "weight") if hasattr(ga, "tsd") else ("log_odds", "known")
            if not (all(torch.equal(_as_stored(getattr(ga, p)), getattr(gb, p)) for p in planes)
                    and torch.equal(ga.meta.min_corner, gb.meta.min_corner)):
                return f"submap {i} {key}"
    return None


def pbstream_grid_gaps(served, decoded, origin_t):
    """A served TSDF grid against its pbstream decode (its known voxels'
    box in the submap frame): (known voxels served, decoded, largest tsd
    and weight differences over the served known voxels)."""
    res = float(served.meta.resolution)
    base = np.round((served.meta.min_corner.double().cpu().numpy() - origin_t) / res + 0.5).astype(np.int64)
    lo = np.round(decoded.meta.min_corner.double().cpu().numpy() / res + 0.5).astype(np.int64)
    idx = (served.weight > 0).nonzero()
    j = idx + torch.as_tensor(base - lo, device=idx.device)
    if bool(((j < 0) | (j >= torch.as_tensor(decoded.shape, device=idx.device))).any()):
        return int(idx.shape[0]), int((decoded.weight > 0).sum()), math.inf, math.inf
    at = lambda g, ix: g[ix[:, 0], ix[:, 1], ix[:, 2]].to(torch.float32)
    d_tsd = (at(served.tsd, idx) - at(decoded.tsd, j)).abs().max()
    d_w = (at(served.weight, idx) - at(decoded.weight, j)).abs().max()
    return int(idx.shape[0]), int((decoded.weight > 0).sum()), float(d_tsd), float(d_w)


def run_phase_23b(device, run):
    """Phase 23b: WriteState of the served graph and LoadState into a fresh
    MapBuilder on the card, through RPC; gates: every node, constraint and
    submap grid bit-equal (float planes as the file's float16 gives them
    back); a finished submap's GetSubmap payload decodes through
    _unpack_grid to the same grid bits; write_pbstream_state /
    load_pbstream_state within the bounded-float codes' step
    (tests/test_pbstream_state.py: 2 * truncation / 32766 for tsd,
    max_weight / 32766 for weights), node and constraint poses exact."""
    from hectorgrapher_tpu_torch.cloud.client import MapBuilderStub

    srv, stub = run["server"], run["stub"]
    pg = srv.map_builder.pose_graph
    with tempfile.TemporaryDirectory() as tmp:
        npz, pbs = os.path.join(tmp, "state.npz"), os.path.join(tmp, "state.pbstream")
        t0 = time.perf_counter()
        stub.write_state(npz)
        write_s = time.perf_counter() - t0
        loading = MapBuilderServer(MapBuilder(run["options"], device=device))
        loading.start()
        stub2 = MapBuilderStub(f"127.0.0.1:{loading.port}")
        t0 = time.perf_counter()
        remap = stub2.load_state(npz, load_frozen_state=True)
        sync(device)
        load_s = time.perf_counter() - t0
        gap = state_gaps(pg, loading.map_builder.pose_graph, remap)
        if gap is not None:
            fail(f"phase 23b: the loaded state differs from the served graph at {gap}")
        stub2.close()
        loading.shutdown()
        del loading
        finished = [i for i, s in enumerate(pg.submaps) if s.finished]
        if not finished:
            fail("phase 23b: no finished submap to query")
        sub = stub.get_submap(finished[0])
        for key in ("high_resolution_grid", "low_resolution_grid"):
            got, want = _unpack_grid(sub[key], device), getattr(pg.submaps[finished[0]].submap, key)
            if not (torch.equal(got.tsd, _as_stored(want.tsd)) and torch.equal(got.weight, _as_stored(want.weight))):
                fail(f"phase 23b: GetSubmap({finished[0]})'s {key} does not decode to the served grid's bits")

        t0 = time.perf_counter()
        write_pbstream_state(pg, pbs)
        pbs_write_s = time.perf_counter() - t0
        frozen = MapBuilder(run["options"], device=device).pose_graph
        t0 = time.perf_counter()
        load_pbstream_state(frozen, pbs)
        sync(device)
        pbs_load_s = time.perf_counter() - t0
        sizes = os.path.getsize(npz), os.path.getsize(pbs)
    if len(frozen.nodes) != len(pg.nodes) or len(frozen.constraints) != len(pg.constraints):
        fail(f"phase 23b: pbstream gave {len(frozen.nodes)} nodes, {len(frozen.constraints)} constraints")
    order = sorted(range(len(pg.nodes)), key=lambda i: (pg.nodes[i].trajectory_id, i))
    for a, b in zip((pg.nodes[i] for i in order), frozen.nodes):
        if not (np.array_equal(a.global_pose.t, b.global_pose.t) and np.array_equal(a.local_pose.q, b.local_pose.q)
                and abs(a.time - b.time) < 1e-7):
            fail(f"phase 23b: pbstream node at {a.time} differs")
    worst_tsd = worst_w = 0.0
    s_order = sorted(range(len(pg.submaps)), key=lambda i: (pg.submaps[i].trajectory_id, i))
    for a, b in zip((pg.submaps[i] for i in s_order), frozen.submaps):
        for key in ("high_resolution_grid", "low_resolution_grid"):
            ga, gb = getattr(a.submap, key), getattr(b.submap, key)
            n_a, n_b, d_tsd, d_w = pbstream_grid_gaps(ga, gb, a.submap.local_pose.t)
            tsd_step = 2 * float(ga.truncation_distance) / 32766
            w_step = float(ga.max_weight) / 32766
            if n_a != n_b or d_tsd > tsd_step or d_w > w_step:
                fail(f"phase 23b: pbstream {key}: {n_b} of {n_a} known voxels, tsd within {d_tsd:.3e} (step "
                     f"{tsd_step:.3e}), weight within {d_w:.3e} (step {w_step:.3e})")
            worst_tsd, worst_w = max(worst_tsd, d_tsd), max(worst_w, d_w)
    print(f"phase 23b: WriteState {sizes[0]} B in {write_s:.3f} s, LoadState {load_s:.3f} s, {len(pg.nodes)} nodes, "
          f"{len(pg.constraints)} constraints, {len(pg.submaps)} submaps bit-equal as stored; GetSubmap("
          f"{finished[0]}) decodes to the served bits; pbstream {sizes[1]} B written in {pbs_write_s:.3f} s, loaded "
          f"in {pbs_load_s:.3f} s, known voxels equal, tsd within {worst_tsd:.3e}, weight within {worst_w:.3e}",
          flush=True)


def run_phase_23c(device, run):
    """Phase 23c: trajectory 0's results of the batched server, each as a
    LocalSlamResultPayload through wire.dumps / wire.loads, injected into
    a second MapBuilder's UplinkTrajectoryBuilder on the card. Gates: its
    nodes' local poses within 1e-9 of the serving graph's, its submaps'
    grids the payloads' grids, no CT window solve."""
    payloads = run["recorder"].payloads
    served = [n for n in run["server"].map_builder.pose_graph.nodes if n.trajectory_id == 0]
    mb = MapBuilder(run["options"], device=device)
    builder = mb.get_trajectory_builder(mb.add_trajectory_builder(local_slam_results=True))
    if not isinstance(builder, UplinkTrajectoryBuilder):
        fail(f"phase 23c: add_trajectory_builder(local_slam_results=True) gave a {type(builder).__name__}")
    solves = window_solver.solve_ct_window.assemblies, window_solver.solve_ct_window_batched.assemblies
    t0 = time.perf_counter()
    for payload in payloads:
        builder.add_local_slam_result(payload)
    mb.pose_graph.wait_for_all_computations()
    inject_s = time.perf_counter() - t0
    if (window_solver.solve_ct_window.assemblies, window_solver.solve_ct_window_batched.assemblies) != solves:
        fail("phase 23c: the uplink ran CT window solves")
    nodes = mb.pose_graph.nodes
    if len(nodes) != len(served) or builder.num_results_injected != len(payloads) or not nodes:
        fail(f"phase 23c: {len(nodes)} uplink nodes for {len(served)} served and {len(payloads)} payloads")
    if [a.time for a in nodes] != [b.time for b in served]:
        fail("phase 23c: the uplink's node times differ from the serving graph's")
    gap = max(float(max(np.abs(a.local_pose.t - b.local_pose.t).max(), np.abs(a.local_pose.q - b.local_pose.q).max()))
              for a, b in zip(nodes, served))
    if gap > 1e-9:
        fail(f"phase 23c: uplink node local poses {gap:.3e} from the serving graph's")
    finished = {}
    for payload in payloads:
        for sp in payload.submaps:
            if sp.insertion_finished:
                finished[sp.submap_index] = sp
    n_finished = 0
    for k, s in enumerate(mb.pose_graph.submaps):
        for key, pk in (("high_resolution_grid", "high_grid"), ("low_resolution_grid", "low_grid")):
            grid = getattr(s.submap, key)
            if k in finished:
                d = getattr(finished[k], pk)
                same = all(torch.equal(getattr(grid, p), torch.from_numpy(d[p].astype(np.float32)).to(device))
                           for p in ("tsd", "weight"))
            else:
                same = not bool((grid.weight > 0).any())
            if not same:
                fail(f"phase 23c: uplink submap {k}'s {key} differs from its payload's")
        n_finished += k in finished
    if n_finished == 0:
        fail("phase 23c: no finished submap reached the uplink")
    print(f"phase 23c: {len(payloads)} payloads of trajectory 0 ({run['recorder'].wire_bytes} B through the wire) "
          f"injected in {inject_s:.3f} s: {len(nodes)} uplink nodes within {gap:.1e} of the served local poses, "
          f"{len(mb.pose_graph.submaps)} submaps ({n_finished} finished) equal to the payloads' grids, no CT window "
          "solve", flush=True)


def run_phase_23(device, **kw):
    """Phase 23: the serving path on the card (23a, 23b, 23c); returns the
    launches by path of K3 and K4."""
    run, paths = run_phase_23a(device, **kw)
    run_phase_23b(device, run)
    run_phase_23c(device, run)
    run["stub"].close()
    run["server"].shutdown()
    return paths


# ---------------------------------------------------------------------------
# Phase 24: distribution (ROADMAP A6b)
# ---------------------------------------------------------------------------

SHARDS24 = 4  # 24a's mesh: four shards on the one card
# 24a's sharded SPA: one Schur size and one PCG size in 3D (phase 15's
# generator; 5000 / 500 / 20000 is phase 15's problem) and in 2D (phase 21's).
SHARD24_SPA = (("3d", 1000, 100, 4000), ("3d", 5000, 500, 20000), ("2d", 1000, 100, 4000), ("2d", 5000, 500, 20000))
SHARD24_SPA_TOLERANCE = 1e-4  # m and rad against the local solve
SHARD24_TIMEOUT_S = 300  # each child process of 24b, and each collective of its groups
# What phases 12, 19 and 20 keep for phase 24: a round's inputs at phase
# 12's and phase 20's shapes, phase 19's captured windows.
SHARD24_INPUTS = {}


def shard24_round_3d(pg, n_submaps=4, n_nodes=3):
    """A round at phase 12's shapes: the returning tail's last n_nodes
    nodes, each against n_submaps finished submaps of pg, as host copies
    of the submaps' pack state (finished submaps do not change)."""
    subs = [s for s in pg.submaps if s.finished and s.matcher is not None][:n_submaps]
    nodes = pg.nodes[-n_nodes:]
    fc = pg._options.constraint_builder.fast_correlative_scan_matcher_3d
    return dict(arrays=[matcher_host_arrays_3d(s.matcher) for s in subs],
                candidates=[pg._candidate(node, s, k) for node in nodes for k, s in enumerate(subs)],
                config=subs[0].matcher.search_config(max(pg._scan_range_bucket(n) for n in nodes), False),
                use_rotational=bool(fc.use_rotational_scan_matcher))


def shard24_round_2d(pg, n_submaps=4, n_nodes=3):
    """A round at phase 20's shapes: k5_rows_calls' round (the returning
    lap's last n_nodes nodes against n_submaps finished submaps)."""
    subs = [s for s in pg.submaps if s.finished][:n_submaps]
    nodes = pg.nodes[-n_nodes:]
    config, _ = pg._search_config(subs[0], max(pg._scan_range_bucket(n) for n in nodes), False)
    return dict(prepared=[pg._submap_matcher(s, config.depth) for s in subs], config=config,
                candidates=[(k, node.cloud, Rigid2(*pg._initial_in_grid(node, s)))
                            for node in nodes for k, s in enumerate(subs)])


def timed_ms(fn, device):
    """(fn()'s result, host milliseconds to its end on the card)."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, (time.perf_counter() - t0) * 1e3


def _quat_gap(a, b):
    """The largest rotation angle (rad) between matching quaternions."""
    from hectorgrapher_tpu_torch.transform.rigid import quat_conjugate, quat_multiply

    d = quat_multiply(quat_conjugate(a), b)
    return float((2.0 * torch.atan2(torch.linalg.vector_norm(d[..., 1:], dim=-1), d[..., 0].abs())).max())


def spa_gaps(dim, got, want):
    """(max translation gap m, max rotation gap rad, bit-equal) of two SPA
    results (poses only)."""
    if dim == "3d":
        gap_t = max(float((got[i] - want[i]).abs().max()) for i in (0, 2))
        gap_r = max(_quat_gap(got[i], want[i]) for i in (1, 3))
        leaves = 4
    else:
        gap_t = max(float((got[i][:, :2] - want[i][:, :2]).abs().max()) for i in (0, 1))
        gap_r = max(float(torch.remainder(got[i][:, 2] - want[i][:, 2] + math.pi, 2 * math.pi).sub(math.pi).abs().max())
                    for i in (0, 1))
        leaves = 2
    return gap_t, gap_r, all(torch.equal(got[i], want[i]) for i in range(leaves))


def run_phase_24_spa(device, num_iterations=10):
    """24a's sharded SPA: each SHARD24_SPA problem solved locally, over a
    Mesh of SHARDS24 shards on the card and over a 1-shard mesh. Gates:
    poses within SHARD24_SPA_TOLERANCE (m, rad) of the local solve, one
    gather per LM evaluation (1 + the LM iterations); prints ms beside the
    local solve's and whether the results are bit-equal."""
    parts = []
    for dim, n, s, c in SHARD24_SPA:
        if dim == "3d":
            problem = make_scale_spa_problem(n, s, c, noise=0.5, seed=0, device=device)[0]
            local_fn, sharded_fn = spa.solve_spa_3d, solve_spa_3d_sharded
        else:
            problem = make_scale_spa_problem_2d(n, s, c, noise=0.5, seed=0, device=device)[0]
            local_fn, sharded_fn = spa.solve_spa_2d, solve_spa_2d_sharded
        want, ms_local = timed_ms(lambda: local_fn(problem, num_iterations=num_iterations), device)
        solver = spa.LAST_SOLVE_STATS["linear_solver"]
        row = [f"{dim} N={n} S={s} C={c} ({solver}): local {ms_local:.3f} ms"]
        for shards in (SHARDS24, 1):
            mesh = Mesh([device] * shards)
            got, ms = timed_ms(lambda: sharded_fn(problem, mesh, num_iterations=num_iterations), device)
            lm = spa.LAST_SOLVE_STATS["lm_iterations"]
            gap_t, gap_r, equal = spa_gaps(dim, got, want)
            if mesh.collectives != lm + 1:
                fail(f"phase 24 SPA {dim} N={n} on {shards} shards: {mesh.collectives} gathers for {lm} LM iterations")
            if gap_t > SHARD24_SPA_TOLERANCE or gap_r > SHARD24_SPA_TOLERANCE:
                fail(f"phase 24 SPA {dim} N={n} on {shards} shards: {gap_t:.3e} m / {gap_r:.3e} rad from the "
                     "local solve")
            row.append(f"{shards} shard{'s' if shards > 1 else ''} {ms:.3f} ms, {mesh.collectives} gathers for {lm} "
                       f"LM iterations, {gap_t:.2e} m / {gap_r:.2e} rad from local{' (bit-equal)' if equal else ''}")
        parts.append(", ".join(row))
    print("phase 24a sharded SPA (the constraint blocks on each shard, one gather an LM evaluation, the solve "
          "replicated): " + "; ".join(parts), flush=True)


def run_phase_24_round(device, label, inputs, kernel, dim):
    """24a's sharded round of `inputs` (shard24_round_3d / _2d) over a
    Mesh of SHARDS24 shards and of 1 on the card against the unsharded
    round. Gates: scores and poses bit-equal, `kernel`'s launches the
    unsharded round's times the shards with candidates. Returns the
    SHARDS24-shard round's launches."""
    if dim == "3d":
        pack = lambda where: pack_submaps_3d_from_arrays(inputs["arrays"], where)
        match = lambda packed: sharded_fast_matches_3d_packed(packed, inputs["candidates"], inputs["config"],
                                                              inputs["use_rotational"])
        n_sub = len(inputs["arrays"])
    else:
        pack = lambda where: pack_submaps_2d(inputs["prepared"], where)
        match = lambda packed: sharded_fast_matches_2d_packed(packed, inputs["candidates"], inputs["config"])
        n_sub = len(inputs["prepared"])
    if n_sub < 4:
        fail(f"phase 24 {label}: {n_sub} finished submaps for the round, not >= 4")
    packed = pack(device)
    kernel.launches = 0
    want, ms_unsharded = timed_ms(lambda: match(packed), device)
    per_launch = kernel.launches
    row = [f"{len(want)} candidates over {n_sub} submaps: unsharded {ms_unsharded:.3f} ms, {per_launch} launches"]
    out = None
    for shards in (SHARDS24, 1):
        mesh = Mesh([device] * shards)
        mesh_pack = pack(mesh)
        owners = {c[0] // mesh_pack.s_per_dev for c in inputs["candidates"]}
        kernel.launches = 0
        got, ms = timed_ms(lambda: match(mesh_pack), device)
        launches = kernel.launches
        same = len(got) == len(want) and all(
            g[:-1] == w[:-1] and all(torch.equal(a, b) for a, b in zip(g[-1], w[-1])) for g, w in zip(got, want))
        if not same:
            fail(f"phase 24 {label} on {shards} shards: scores or poses differ from the unsharded round")
        if launches != per_launch * len(owners) or mesh.collectives != 1:
            fail(f"phase 24 {label} on {shards} shards: {launches} launches for {len(owners)} shards with candidates "
                 f"({per_launch} a shard), {mesh.collectives} gathers")
        row.append(f"{shards} shard{'s' if shards > 1 else ''} ({len(owners)} with candidates) {ms:.3f} ms, {launches} "
                   "launches, bit-equal")
        out = launches if shards == SHARDS24 else out
    print(f"phase 24a sharded round {label}: " + ", ".join(row), flush=True)
    return out


def run_phase_24_windows(device, inputs):
    """24a's sharded window solves: phase 19's B = 8 captured windows,
    per scan and per point, over a Mesh of SHARDS24 shards on the card
    against the unsharded batched solve. Gates: each lane within phase
    19's 1e-3 m / 1e-3 rad, one slotted K3 launch a shard and assembly;
    first K6 on the B windows (check_ct_pair_block with lanes). Returns
    the slotted launches, per scan and per point, and K6's records."""
    windows, weights, iters = inputs
    his, los = [w[0] for w in windows], [w[1] for w in windows]
    problems, states0 = _stack([w[2] for w in windows], CtProblem), _stack([w[3] for w in windows], CtState)
    is_tsdf = windows[0][4]
    # K6 at the batched shape against its eager twins, each window bit-equal
    # to a launch for it alone.
    k6 = check_ct_pair_block(states0, problems, weights, f"batched_b{len(windows)}", lanes=True)
    launches, row = {"k6": k6}, []
    for per_point in (False, True):
        slotted = ct_scan_block_points_slots if per_point else ct_scan_block_slots
        kw = dict(is_tsdf=is_tsdf, num_iterations=iters, per_point=per_point)
        (want, _, _), ms_unsharded = timed_ms(
            lambda: window_solver.solve_ct_window_batched(his, los, problems, states0, weights, **kw), device)
        mesh = Mesh([device] * SHARDS24)
        window_solver.solve_ct_window_batched.assemblies = 0
        slotted.launches = 0
        (got, _, _), ms = timed_ms(
            lambda: solve_ct_windows_sharded(mesh, his, los, problems, states0, weights, **kw), device)
        assemblies, n = window_solver.solve_ct_window_batched.assemblies, slotted.launches
        if n != assemblies or assemblies != SHARDS24 * (1 + iters):
            fail(f"phase 24 windows: {n} slotted K3 launches for {assemblies} assemblies over {SHARDS24} shards")
        gaps = [_lane_gaps(CtState(*(x[lane] for x in got)), CtState(*(x[lane] for x in want)))
                for lane in range(len(windows))]
        gap_t, gap_r = max(g[0] for g in gaps), max(g[1] for g in gaps)
        if gap_t > 1e-3 or gap_r > 1e-3:
            fail(f"phase 24 windows: a lane is {gap_t:.3e} m / {gap_r:.3e} rad from the unsharded batched solve")
        launches["per_point" if per_point else "per_scan"] = n
        row.append(f"{'per point' if per_point else 'per scan'}: unsharded {ms_unsharded:.3f} ms, {SHARDS24} shards "
                   f"{ms:.3f} ms, {n} slotted K3 launches = {assemblies} assemblies, lanes within {gap_t:.2e} m / "
                   f"{gap_r:.2e} rad")
    print(f"phase 24a sharded window solves, B={len(windows)}, {iters} iterations: " + "; ".join(row), flush=True)
    return launches


def solver_plane_rooms(device, hist_size=64):
    """24b's 3D scene: five 32 x 32 x 16 / 12 x 12 x 8 TSDF submaps of a
    box room, each one scan from (x, 0, 0), and a node's clouds from the
    first place (tests/test_torch_multihost.py's)."""
    opts = cfg.TSDFRangeDataInserterOptions3D(normal_computation_method="NONE", min_range=0.4, max_range=30.0)
    ins_hi, ins_lo = make_tsdf_inserter_3d(opts, 0.2), make_tsdf_inserter_3d(opts, 0.6)
    scenes = []
    for shift in (0.0, 0.15, 0.3, -0.15, -0.3):
        origin = np.array([shift, 0.0, 0.0])
        pts = raycast_box_room_3d(origin, nq.quat_identity(), half_extents=(2.0, 1.8, 1.0), num_azimuth=64,
                                  num_elevation=12)
        pts = (pts[~np.isnan(pts[:, 0])] + origin).astype(np.float32)
        rd = RangeData(origin=torch.tensor(origin, dtype=torch.float32, device=device),
                       returns=pad_cloud(pts, 1024, device), misses=pad_cloud(np.zeros((0, 3), np.float32), 4, device))
        full = pad_cloud(pts, 1024, device)
        scenes.append((ins_hi(make_tsdf_grid(0.2, (32, 32, 16), 0.6, 1000.0, device), rd),
                       ins_lo(make_tsdf_grid(0.6, (12, 12, 8), 1.2, 1000.0, device), rd),
                       compute_histogram(full.positions, full.mask, hist_size).cpu().numpy(), full))
    full = scenes[0][3]
    high, low = compact_cloud(voxel_filter(full, 0.3), 128), compact_cloud(voxel_filter(full, 0.6), 64)
    return scenes, (high, low, compute_histogram(high.positions, high.mask, hist_size).cpu().numpy())


def solver_plane_graph_3d(device, mesh, broadcast, rooms):
    """24b's 3D drive: a PoseGraph3D (async off) given four finished
    rooms (solver_plane_rooms' scene), one node each, its rounds batched
    (cs3d_pack, cs3d), then the final optimization (spa3d: no extras on
    this graph). Returns the INTER constraints and node poses."""
    scenes, (high, low, hist) = rooms
    fc = cfg.FastCorrelativeScanMatcherOptions3D(
        linear_xy_search_window=0.6, linear_z_search_window=0.3, angular_search_window=math.radians(10.0),
        branch_and_bound_depth=3, min_rotational_score=0.1, min_low_resolution_score=0.1)
    options = cfg.replace_deep(cfg.MapBuilderOptions(), {
        "pose_graph.async_work_queue": False, "pose_graph.optimize_every_n_nodes": 0,
        "pose_graph.constraint_builder.sampling_ratio": 1.0,
        "pose_graph.constraint_builder.max_constraint_distance": 100.0,
        "pose_graph.constraint_builder.min_score": 0.2,
        "pose_graph.constraint_builder.fast_correlative_scan_matcher_3d": fc}).pose_graph
    pg = PoseGraph3D(options, histogram_size=len(hist), max_scan_range=6.0, device=device)
    if mesh is not None:
        pg.set_solver_mesh(mesh, broadcast=broadcast)
    for i in range(4):
        hi, lo, submap_hist, _ = scenes[i]
        submap = Submap3D(local_pose=NpRigid3(np.zeros(3)), high_resolution_grid=hi, low_resolution_grid=lo,
                          rotational_histogram=submap_hist, num_range_data=1, insertion_finished=True)
        pg.add_node(PgNode(time=0.1 * i, local_pose=NpRigid3(np.zeros(3)), global_pose=NpRigid3.identity(),
                           high_cloud=high, low_cloud=low, histogram=hist), [submap])
    pg.run_final_optimization()
    pose_graph_module.set_constraint_search_mesh(None)
    return ([(c.submap_index, c.node_index, c.zbar.t.tolist()) for c in pg.constraints if c.tag == "INTER"],
            np.stack([n.global_pose.t for n in pg.nodes]))


def solver_plane_drive_2d(device, mesh, broadcast, n_scans=N_SCANS):
    """24b's 2D drive: phase 20's options, its async work queue off, over
    the first lap of its circle; the final optimization at the end.
    Returns (node poses, rounds, INTER constraints)."""
    mb = MapBuilder(cfg.replace_deep(slam2d_options(), {"pose_graph.async_work_queue": False}), device=device)
    if mesh is not None:
        mb.pose_graph.set_solver_mesh(mesh, broadcast=broadcast)
    rounds = []
    batched = mb.pose_graph._compute_constraints_batched
    mb.pose_graph._compute_constraints_batched = lambda gated, **kw: (rounds.append(len(gated)),
                                                                      batched(gated, **kw))[1]
    tb = mb.get_trajectory_builder(mb.add_trajectory_builder())
    for t, _, odom, cloud in slam2d_scans()[:n_scans]:
        tb.add_odometry_data(t, odom)
        tb.add_range_data(TimedPointCloudData(t, np.zeros(3, np.float32),
                                              TimedPointCloud(cloud.positions, cloud.times, cloud.mask)))
    mb.pose_graph.run_final_optimization()
    pose_graph_module.set_constraint_search_mesh(None)
    pg = mb.pose_graph
    return (np.stack([n.global_pose.t for n in pg.nodes]), rounds,
            sum(c.tag == "INTER" for c in pg.constraints))


def solver_plane_child(role, coord_port, follower_port, device=None):
    """One child process of 24b (role leader, follower or nccl) on
    `device` (cuda:0 unless given); prints "<ROLE> OK" and its results,
    exits non-zero on any failure."""
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    if device.type == "cuda":
        _build.load_library()
    if role == "nccl":
        # One process, one NCCL group: the gather of a sharded SPA solve
        # runs as an NCCL collective on the card.
        import torch.distributed as dist

        initialize_process(f"127.0.0.1:{coord_port}", 1, 0, device=device, backend="nccl",
                           timeout_s=SHARD24_TIMEOUT_S)
        mesh = Mesh([device] * SHARDS24, group=dist.group.WORLD)
        problem = make_scale_spa_problem_2d(1000, 100, 4000, noise=0.5, seed=0, device=device)[0]
        want = spa.solve_spa_2d(problem, num_iterations=10)
        got, ms = timed_ms(lambda: solve_spa_2d_sharded(problem, mesh, num_iterations=10), device)
        gap_t, gap_r, equal = spa_gaps("2d", got, want)
        lm = spa.LAST_SOLVE_STATS["lm_iterations"]
        if mesh.backend != "nccl" or mesh.collectives != lm + 1 or max(gap_t, gap_r) > SHARD24_SPA_TOLERANCE:
            fail(f"NCCL: backend {mesh.backend}, {mesh.collectives} gathers for {lm} LM iterations, {gap_t:.3e} m / "
                 f"{gap_r:.3e} rad from local")
        dist.destroy_process_group()
        print(f"NCCL OK: the 2D SPA (1000 / 100 / 4000) over {SHARDS24} shards in a one-process NCCL group, "
              f"{mesh.collectives} NCCL gathers for {lm} LM iterations, {ms:.3f} ms, {gap_t:.2e} m / {gap_r:.2e} rad "
              f"from local{' (bit-equal)' if equal else ''}", flush=True)
        return
    rank = 0 if role == "leader" else 1
    initialize_process(f"127.0.0.1:{coord_port}", 2, rank, device=device, backend="gloo", timeout_s=SHARD24_TIMEOUT_S)
    mesh = global_mesh(devices=[device] * (SHARDS24 // 2))
    if role == "follower":
        follower = SolverPlaneFollower(f"127.0.0.1:{follower_port}", mesh=mesh, seq_timeout_s=SHARD24_TIMEOUT_S)
        follower.start()
        if not follower.wait_for_shutdown(timeout=SHARD24_TIMEOUT_S):
            fail("follower: no shutdown from the leader")
        print(f"FOLLOWER OK: ran {collections.Counter(follower.executed)} in sequence; K4 launches "
              f"{fast_scores_3d.launches}, K5 launches {fast_scores_2d.launches} on its {len(mesh.devices)} shards",
              flush=True)
        return
    leader = SolverPlaneLeader([f"127.0.0.1:{follower_port}"], collect_stats=True, wait_timeout_s=SHARD24_TIMEOUT_S)
    (poses, rounds, inter), ms_mesh = timed_ms(lambda: solver_plane_drive_2d(device, mesh, leader), device)
    (poses0, rounds0, inter0), ms_local = timed_ms(lambda: solver_plane_drive_2d(device, None, None), device)
    gap = float(np.abs(poses - poses0).max())
    if not rounds or rounds != rounds0 or inter != inter0 or gap > SHARD24_SPA_TOLERANCE:
        fail(f"leader 2D drive: {len(rounds)} / {len(rounds0)} rounds, {inter} / {inter0} INTER constraints, poses "
             f"{gap:.3e} m apart with and without the mesh")
    problem = make_scale_spa_problem_2d(1000, 100, 4000, noise=0.5, seed=1, device=device)[0]
    host = spa.SpaProblem2D(*(x.cpu().numpy() for x in problem))
    leader("spa2d", (host, 10))
    got = solve_spa_2d_sharded(host, mesh, num_iterations=10)
    spa_gap = spa_gaps("2d", got, spa.solve_spa_2d(problem, num_iterations=10))
    # One scene for both graphs: the TSDF inserter sums with atomics on
    # the card (ROADMAP C3), so rooms built twice differ in their last bits.
    rooms = solver_plane_rooms(device)
    (inter3, poses3), ms_3d = timed_ms(lambda: solver_plane_graph_3d(device, mesh, leader, rooms), device)
    want3 = solver_plane_graph_3d(device, None, None, rooms)
    gap3 = float(np.abs(poses3 - want3[1]).max())
    if not inter3 or [(s, n) for s, n, _ in inter3] != [(s, n) for s, n, _ in want3[0]] or gap3 > 1e-4 or max(
            spa_gap[:2]) > SHARD24_SPA_TOLERANCE:
        fail(f"leader 3D: {len(inter3)} / {len(want3[0])} INTER constraints, poses {gap3:.3e} m apart; the "
             f"sharded 2D SPA {spa_gap[0]:.3e} m / {spa_gap[1]:.3e} rad from local")
    stats = {op: {"count": st["count"], "bytes": st["bytes"],
                  "ack_ms_median": round(float(np.median(st["ack_ms"])), 3) if st["ack_ms"] else None,
                  "ack_ms_max": round(float(np.max(st["ack_ms"])), 3) if st["ack_ms"] else None}
             for op, st in leader.stats.items()}
    missing = {"cs2d_pack", "cs2d", "spa2d", "cs3d_pack", "cs3d", "spa3d"} - set(stats)
    if missing:
        fail(f"leader: the solver plane never issued {sorted(missing)}")
    leader.shutdown()
    print(f"LEADER OK: the 2D drive ({N_SCANS} scans, async off) with the 2-process mesh {ms_mesh:.1f} ms, without "
          f"{ms_local:.1f} ms: {len(rounds)} rounds, {inter} INTER constraints both, node poses {gap:.2e} m apart"
          f"{' (bit-equal)' if gap == 0 else ''}; the sharded 2D SPA {spa_gap[0]:.2e} m / {spa_gap[1]:.2e} rad from "
          f"local; the 3D graph ({len(inter3)} INTER constraints, {ms_3d:.1f} ms with the mesh) {gap3:.2e} m from "
          "the one without", flush=True)
    print("SOLVERPLANE_STATS " + json.dumps(stats), flush=True)


def run_phase_24b():
    """24b: the solver plane on the card. Three child processes of this
    script, each bounded by SHARD24_TIMEOUT_S (a hang fails the phase):
    a leader and a follower, both on cuda:0 in one gloo group (NCCL
    refuses two ranks on one device), each with SHARDS24 / 2 shards; and a
    one-process NCCL group whose sharded SPA gathers through NCCL. Prints
    their lines and the leader's op counts, bytes and acknowledgement ms."""
    import socket

    socks = [socket.socket() for _ in range(3)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    coord, follower_port, nccl_coord = (s.getsockname()[1] for s in socks)
    for s in socks:
        s.close()
    script = os.path.abspath(__file__)
    args = {"leader": (coord, follower_port), "follower": (coord, follower_port), "nccl": (nccl_coord, 0)}
    procs = {role: subprocess.Popen([sys.executable, script, "--solver-plane-child", role, str(a), str(b)],
                                    cwd=os.path.dirname(script), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True) for role, (a, b) in args.items()}
    outs = {}
    deadline = time.monotonic() + SHARD24_TIMEOUT_S
    try:
        for role, proc in procs.items():
            try:
                outs[role] = (proc.communicate(timeout=max(1.0, deadline - time.monotonic()))[0], proc.returncode)
            except subprocess.TimeoutExpired:
                outs[role] = ("", "timeout")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for role, (out, rc) in outs.items():
        mark_line = f"{role.upper()} OK"
        if rc != 0 or mark_line not in out:
            fail(f"phase 24b {role}: exit {rc}; its output ends: {out[-3000:]}")
        for line in out.splitlines():
            if line.startswith((mark_line, "SOLVERPLANE_STATS")):
                print(f"phase 24b {line}", flush=True)


def _plane_diffs(a, b):
    """(cells that differ, cells) between two lists of TSDF grids' planes."""
    planes = [(getattr(ga, f), getattr(gb, f)) for ga, gb in zip(a, b) for f in ("tsd", "weight")]
    return sum(int((x != y).sum()) for x, y in planes), sum(x.numel() for x, _ in planes)


def run_phase_24_graph(device):
    """24a: 24b's 3D graph on one scene (solver_plane_rooms), unsharded and
    over a mesh of SHARDS24 shards on the card: the same INTER constraints
    and bit-equal node poses (the sharded rounds and SPA compute each lane
    and block as unsharded). A second build of the scene is compared cell
    by cell for the record: the TSDF inserter's atomics order its sums
    anew (ROADMAP C3), the cause of C28."""
    rooms = solver_plane_rooms(device)
    want = solver_plane_graph_3d(device, None, None, rooms)
    got, ms = timed_ms(lambda: solver_plane_graph_3d(device, Mesh([device] * SHARDS24), None, rooms), device)
    gap = float(np.abs(got[1] - want[1]).max())
    if not want[0] or [(s, n) for s, n, _ in got[0]] != [(s, n) for s, n, _ in want[0]] or gap != 0.0:
        fail(f"phase 24a 3D graph: {len(got[0])} / {len(want[0])} INTER constraints, node poses {gap:.3e} m apart "
             f"over {SHARDS24} shards and unsharded on one scene")
    rebuilt = solver_plane_rooms(device)
    differ, cells = _plane_diffs([g for r in rooms[0] for g in r[:2]], [g for r in rebuilt[0] for g in r[:2]])
    print(f"phase 24a 3D graph (24b's, {len(want[0])} INTER constraints) over {SHARDS24} shards: bit-equal to the "
          f"unsharded graph on one scene, {ms:.1f} ms; the scene built again differs in {differ} of {cells} cells",
          flush=True)


def run_phase_24(device):
    """Phase 24: distribution. 24a in this process, on a Mesh of SHARDS24
    shards on the card (and of 1): the sharded SPA, 24b's 3D graph on one
    scene, the sharded rounds at phase 12's and phase 20's shapes, phase
    19's windows sharded; 24b the solver plane in child processes. Returns
    the launches by path."""
    run_phase_24_spa(device)
    run_phase_24_graph(device)
    k4 = run_phase_24_round(device, "3d (phase 12's shapes)", SHARD24_INPUTS.pop("round_3d"), fast_scores_3d, "3d")
    k5 = run_phase_24_round(device, "2d (phase 20's shapes)", SHARD24_INPUTS.pop("round_2d"), fast_scores_2d, "2d")
    k3 = run_phase_24_windows(device, SHARD24_INPUTS.pop("windows"))
    mark("24b")
    run_phase_24b()
    return dict(fast_scores_3d={"shard24_rounds_3d": k4}, fast_scores_2d={"shard24_rounds_2d": k5},
                ct_scan_block={"shard24_windows": k3["per_scan"]},
                ct_scan_block_points={"shard24_windows": k3["per_point"]}, k6=k3["k6"])


CLASSIC_SCANS = CT_SCANS  # phase 25: 8 s at 10 Hz, as phase 9
CLASSIC_SPEED, CLASSIC_REST = 0.2, 0.5  # tests/test_local_3d_classic.py's drive: m/s after a rest of s
CLASSIC_RAYS = (256, 48)  # azimuth x elevation
CLASSIC_CUT_GRIDS = (192, 96)  # 25b's gated run (see JAX_CLASSIC25B_CUT)
# The JAX package's classic 3D builder over the same scans on a CPU
# (tests/jax_slam_reference.py --classic-3d [--correlative --grids 192 96],
# float64 scan times): (results, max translation error m). 25a at the
# default options (256^3 / 128^3): 80 results, 0.14192 m (relative motion
# off by 0.113). 25b with the correlative search at 192^3 / 96^3: the JAX
# search builds a shifted-field table on every scan, (n + 4)^3 x 125
# floats, 8.8 GB at the default 256^3 and 3.8 GB at 192^3, whose 19.2 m
# still holds the 19 m room: 80 results, 0.15747 m (0.107). At the JAX
# test's 96^3 / 48^3 the room overflows the high grid and both builders
# stall (JAX 1.05282 m, relative motion off by 0.717; the port on a CPU
# 1.06071 m, 0.742). The port must give as many results and stay within
# max(2x, +0.05 m) of the error.
JAX_CLASSIC25A = (80, 0.14192)
JAX_CLASSIC25B_CUT = (80, 0.15747)


def classic_overrides(correlative=False, grids=None):
    """Phase 25's overrides of TrajectoryBuilder3DOptions (defaults: the
    PROBABILITY_GRID submaps at 256^3 / 128^3, correlative matching off):
    with `correlative` the online correlative search, with `grids` other
    (high, low) grid sizes. tests/jax_slam_reference.py applies them to the
    JAX package's options."""
    out = {"use_online_correlative_scan_matching": correlative}
    if grids is not None:
        out["submaps.high_grid_size"], out["submaps.low_grid_size"] = grids
    return out


def classic_options(correlative=False, grids=None):
    return cfg.replace_deep(cfg.TrajectoryBuilder3DOptions(), classic_overrides(correlative, grids))


def classic_truth(t):
    return np.array([CLASSIC_SPEED * max(0.0, t - CLASSIC_REST), 0.0, 0.0])


def classic_drive(n_scans=CLASSIC_SCANS, seed=SEED):
    """Phase 25's sensor events in time order: tests/test_local_3d_classic.py's
    drive (IMU at 100 Hz, odometry at 20 Hz with 2 mm noise, a straight
    0.2 m/s run along x after a 0.5 s rest) with phase 9's room: n_scans
    scans at 10 Hz of CLASSIC_RAYS rays of the CT_ROOM box room, 4 mm range
    noise. Yields ("imu", t, acc, gyro), ("odom", t, pose), ("scan", t, data)."""
    gravity = np.array([0.0, 0.0, 9.80665])
    rng = np.random.default_rng(seed)
    n_az, n_el = CLASSIC_RAYS
    t, next_odom, next_scan, n = 0.0, 0.0, 0.05, 0
    while n < n_scans:
        yield "imu", t, gravity, np.zeros(3)
        if t >= next_odom:
            yield "odom", t, NpRigid3(classic_truth(t) + rng.normal(0, 0.002, 3))
            next_odom += 0.05
        if t >= next_scan:
            pts = raycast_box_room_3d(classic_truth(t), nq.quat_identity(), half_extents=CT_ROOM, num_azimuth=n_az,
                                      num_elevation=n_el, noise_std=0.004, rng=rng)
            pts = pts[~np.isnan(pts[:, 0])]
            cloud = pad_timed_cloud(pts, np.zeros(len(pts), np.float32), n_az * n_el)
            yield "scan", t, TimedPointCloudData(t, np.zeros(3, np.float32), cloud, n_az)
            next_scan += 0.1
            n += 1
        t = round(t + 0.01, 6)


def classic_errors(results):
    """(max translation error m against classic_truth, the relative motion
    error over the second half of the results: |estimated - true| / max(true,
    0.1), the JAX test's rule, below 0.2)."""
    errs = [float(np.linalg.norm(r.local_pose.t - classic_truth(r.time))) for r in results]
    half = len(results) // 2
    est = results[-1].local_pose.t[0] - results[half].local_pose.t[0]
    true = classic_truth(results[-1].time)[0] - classic_truth(results[half].time)[0]
    return max(errs), abs(est - true) / max(true, 0.1)


def run_classic(device, options, n_scans=CLASSIC_SCANS):
    """LocalTrajectoryBuilder3D over classic_drive. Returns its results, the
    per-scan seconds of the scans matched against a submap (the pose comes
    back to the host in each), K3 launches and the builder."""
    builder = LocalTrajectoryBuilder3D(options, device)
    k3_before = ct_scan_block.launches
    results, latencies = [], []
    for kind, t, *payload in classic_drive(n_scans):
        if kind == "imu":
            builder.add_imu_data(t, *payload)
        elif kind == "odom":
            builder.add_odometry_data(t, payload[0])
        else:
            matched = builder.active_submaps.matching_submap is not None
            t0 = time.perf_counter()
            result = builder.add_range_data(payload[0])
            sync(device)
            if matched:
                latencies.append(time.perf_counter() - t0)
            if result is not None:
                if not np.all(np.isfinite(result.local_pose.t)):
                    fail(f"phase 25: no finite pose at t={t:.2f}")
                results.append(result)
    return dict(results=results, latencies=latencies, k3=ct_scan_block.launches - k3_before, builder=builder)


def check_classic(label, run, jax_ref=None):
    """Phase 25's gates on one drive: K3 on every match, the relative motion
    rule and, with jax_ref (results, max error), at least as many results
    and the max error within max(2x, +0.05 m) of the JAX builder's. Prints
    the drive's line; returns (median ms, K3 launches)."""
    results, lat = run["results"], np.array(run["latencies"]) * 1e3
    if not results or run["k3"] < len(lat) or len(lat) == 0:
        fail(f"{label}: {len(results)} results, {run['k3']} K3 launches for {len(lat)} matched scans")
    max_err, rel = classic_errors(results)
    if rel > 0.2:
        fail(f"{label}: relative motion over the second half off by {rel:.3f} of the truth (bound 0.2)")
    note = ""
    if jax_ref is not None:
        n_jax, err_jax = jax_ref
        if len(results) < n_jax or max_err > max(2 * err_jax, err_jax + 0.05):
            fail(f"{label}: {len(results)} results (JAX {n_jax}), max error {max_err:.5f} m beyond max(2x, +0.05 m) "
                 f"of the JAX builder's {err_jax:.5f}")
        note = f" (JAX on the CPU {n_jax} results, {err_jax:.5f} m)"
    submap = run["builder"].active_submaps.submaps[0]
    grid_bytes = grid_nbytes(submap.high_resolution_grid) + grid_nbytes(submap.low_resolution_grid)
    print(f"{label}: {len(results)} results, max error {max_err:.5f} m{note}, relative motion off by {rel:.4f}; "
          f"per-scan latency median {np.median(lat):.3f} ms, p95 {np.percentile(lat, 95):.3f} ms over {len(lat)} "
          f"matched scans (period 100 ms); K3 launches {run['k3']} ({run['k3'] / len(lat):.2f} a matched scan); "
          f"grid bytes a submap {grid_bytes}", flush=True)
    return float(np.median(lat)), run["k3"]


def _cpu(x):
    """A grid, cloud or pose (NamedTuples of tensors) on the CPU."""
    if isinstance(x, torch.Tensor):
        return x.cpu()
    return type(x)(*(_cpu(v) for v in x)) if isinstance(x, tuple) and hasattr(x, "_fields") else x


def check_correlative_on_cpu(device, args):
    """25b: one scan's correlative search on the card against the same call
    on the CPU: the same winner where it leads its runner-up by more than
    the tolerance, and the best score within 1e-5 * max(1, |score|).
    Returns (the score gap, the winner's lead)."""
    got = correlative_scores_3d(*args)[0].reshape(-1)
    want = correlative_scores_3d(*(_cpu(a) for a in args))[0].reshape(-1)
    best, best_cpu = int(torch.argmax(got)), int(torch.argmax(want))
    tol = 1e-5 * max(1.0, float(want.max().abs()))
    lead = float(torch.topk(want, 2).values.diff().abs())
    gap = abs(float(got[best]) - float(want[best_cpu]))
    if gap > tol or (lead > tol and best != best_cpu):
        fail(f"phase 25b: the correlative search's winner {best} on the card, {best_cpu} on the CPU (lead {lead:.2e}), "
             f"scores {gap:.2e} apart (tolerance {tol:.1e})")
    return gap, lead


def run_phase_25(device):
    """Phase 25: the classic 3D builder (LocalTrajectoryBuilder3D) over
    classic_drive: 25a at the default options (256^3 / 128^3 occupancy
    submaps), 25b with the online correlative search at full width (its ms
    a call, one call on the card against the CPU) and at CLASSIC_CUT_GRIDS,
    where JAX_CLASSIC25B_CUT gates it. Every match refines through GN3D
    (K3, C = 1). Returns K3's launches by path."""
    paths = {}
    paths["classic25a"] = check_classic("phase 25a classic 3D builder (default options)",
                                        run_classic(device, classic_options()), JAX_CLASSIC25A)[1]
    calls = []
    real = local_3d_module.match_correlative_3d

    def timed(*args):
        sync(device)
        t0 = time.perf_counter()
        out = real(*args)
        sync(device)
        calls.append((time.perf_counter() - t0, args))
        return out

    local_3d_module.match_correlative_3d = timed
    try:
        run = run_classic(device, classic_options(correlative=True))
    finally:
        local_3d_module.match_correlative_3d = real
    _, paths["classic25b"] = check_classic("phase 25b, the correlative search on (full width)", run)
    gap, lead = check_correlative_on_cpu(device, calls[-1][1])
    ms = np.array([c[0] for c in calls]) * 1e3
    print(f"phase 25b match_correlative_3d: {len(ms)} calls, median {np.median(ms):.3f} ms, p95 "
          f"{np.percentile(ms, 95):.3f} ms a call ({2 * calls[-1][1][3].num_angles + 1} yaws x "
          f"{(2 * calls[-1][1][3].num_linear + 1) ** 3} offsets x {calls[-1][1][1].positions.shape[0]} points); the "
          f"last on the CPU: best scores {gap:.2e} apart, the winner's lead {lead:.2e}", flush=True)
    del run, calls
    paths["classic25b_cut"] = check_classic(
        f"phase 25b at {CLASSIC_CUT_GRIDS[0]}^3 / {CLASSIC_CUT_GRIDS[1]}^3",
        run_classic(device, classic_options(correlative=True, grids=CLASSIC_CUT_GRIDS)), JAX_CLASSIC25B_CUT)[1]
    return paths


# Phase 26: the port's CLI (tools/cli.py) over recorded data. 26a writes a
# bag shaped like the DRZ Living Lab sequences (tests/test_drz_rehearsal.py's
# pattern at a 64-beam lidar's density in 512-column mode) and runs
# mapping-evaluation --use_3d on it at phase 13's options; 26b writes phase
# 6's 60 scans as a sequence directory of binary PLY files and runs the 2D
# mapping-evaluation at phase 20's options; 26c runs the state tools on 26a's
# state; 26d serves 26a's bag through map-builder-server in a child process.
DRZ26_DURATION = 4.0  # s: 0.6 s at rest, then 3.4 s along +x: 40 scans at 10 Hz
DRZ26_SPEED, DRZ26_REST = 0.25, 0.6  # m/s, s
DRZ26_RAYS = (512, 64)  # azimuth columns x beams: 32,768 points a scan
# tests/jax_slam_reference.py --drz-bag: the JAX CLI's mapping-evaluation
# --use_3d on the same bag (its sha256) at the same options, on a CPU; two
# runs: 30 nodes, 4 submaps, 80 constraints, ATE 0.0954 m both times.
JAX_DRZ26_SHA256 = "399c1deca0a6a42e40a536f0572c45c28e0a1e01c523b04492ac784ece49b333"
JAX_DRZ26_ATE = 0.0954
# tests/jax_slam_reference.py --sequence-2d: the JAX CLI's 2D
# mapping-evaluation on the same files (their sha256) at the same options;
# two runs: 60 nodes, 5 submaps, 193 and 194 constraints, ATE 0.0082 and
# 0.0081 m. The larger.
JAX_SEQ26_SHA256 = "447705dfdbdd20299e6192ba89c73dd838b70afbd6b053f704e66461d1488441"
JAX_SEQ26_ATE = 0.0082
SERVER26_TIMEOUT_S = 120  # 26d: the server child's start, and its exit after SIGINT (30 s of it)


def drz26_truth(t):
    return np.array([DRZ26_SPEED * max(0.0, t - DRZ26_REST), 0.0, 0.0])


def drz26_messages(rosbag_module, raycast=raycast_box_room_3d, duration=DRZ26_DURATION, rays=DRZ26_RAYS, seed=7):
    """26a's bag as (topic, type, stamp, message bytes) in time order,
    encoded by `rosbag_module` (the port's, or the JAX package's for the
    reference run), and the mocap rows (time, x, y, z, qw, qx, qy, qz) at
    the odometry's times: 100 Hz IMU (gravity), 20 Hz odometry with 2 mm
    noise, 10 Hz organized PointCloud2 of `rays` (columns x beams) of the
    default box room with 4 mm range noise, with intensity, ring and
    per-point time fields; a point's time goes with its column over the
    0.1 s sweep (-0.1 s to 0, the stamp the sweep's end), dropped rays at
    the sensor origin (the range filter drops them)."""
    gravity = np.array([0.0, 0.0, 9.80665])
    n_az, n_el = rays
    rng = np.random.default_rng(seed)
    col = np.arange(n_az * n_el) % n_az
    times = (col / (n_az - 1) * 0.1 - 0.1).astype(np.float32)
    rings = (np.arange(n_az * n_el) // n_az).astype(np.uint16)
    q = nq.quat_identity()
    msgs, mocap = [], []
    t, next_odom, next_scan = 0.0, 0.0, 0.05
    while t <= duration:
        pt = drz26_truth(t)
        msgs.append(("/imu/data", "sensor_msgs/Imu", t, rosbag_module.encode_imu(t, gravity, np.zeros(3))))
        if t >= next_odom:
            msgs.append(("/odom", "nav_msgs/Odometry", t,
                         rosbag_module.encode_odometry(t, NpRigid3(pt + rng.normal(0, 0.002, 3), q))))
            mocap.append([t, *pt, *q])
            next_odom += 0.05
        if t >= next_scan:
            pts = raycast(pt, q, num_azimuth=n_az, num_elevation=n_el, noise_std=0.004, rng=rng)
            inten = rng.uniform(0, 100, len(pts)).astype(np.float32)
            msgs.append(("/os_cloud_node/points", "sensor_msgs/PointCloud2", t, rosbag_module.encode_point_cloud2(
                t, np.nan_to_num(pts, nan=0.0), width=n_az, times=times, rings=rings, intensities=inten)))
            next_scan += 0.1
        t = round(t + 0.01, 6)
    return msgs, mocap


def write_drz26_bag(path, rosbag_module, raycast=raycast_box_room_3d, **kw):
    """Write 26a's bag to `path` (.bag) and its ground truth beside it
    (<name>.mocap.csv); returns the bag's sha256."""
    msgs, mocap = drz26_messages(rosbag_module, raycast, **kw)
    rosbag_module.write_bag(path, msgs)
    np.savetxt(path[: -len(".bag")] + ".mocap.csv", np.asarray(mocap), delimiter=",")
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def write_seq26_dir(path, write_ply):
    """26b's sequence directory: phase 6's scans (circle_scans) as binary
    PLY files named by their times (written by `write_ply`, the port's or
    the JAX package's), its odometry 1 ms before each scan in
    odometry.csv and the truth in mocap.csv. Returns the sha256 over the
    files' names and bytes, in name order."""
    os.makedirs(path, exist_ok=True)
    odom_rows, mocap_rows = [], []
    for t, pose, odom, cloud in circle_scans():
        write_ply(os.path.join(path, f"scan_{t:0.3f}.ply"), cloud.positions[cloud.mask])
        odom_rows.append([t - 0.001, *odom.t, *odom.q])
        mocap_rows.append([t, *pose.t, *pose.q])
    np.savetxt(os.path.join(path, "odometry.csv"), np.asarray(odom_rows), delimiter=",")
    np.savetxt(os.path.join(path, "mocap.csv"), np.asarray(mocap_rows), delimiter=",")
    digest = hashlib.sha256()
    for name in sorted(os.listdir(path)):
        digest.update(name.encode())
        with open(os.path.join(path, name), "rb") as f:
            digest.update(f.read())
    return digest.hexdigest()


def cli_overrides(overrides):
    """replace_deep overrides as the CLI's --config_overrides key=json flags."""
    return [a for k, v in overrides.items() for a in ("--config_overrides", f"{k}={json.dumps(v)}")]


def drz26_argv(bag):
    """26a's mapping-evaluation over the bag at phase 13's options."""
    return ["mapping-evaluation", "--use_3d", "--sequence_dir", bag,
            *cli_overrides(slam_overrides(batched=True, probability=True))]


def seq26_argv(path):
    """26b's 2D mapping-evaluation over the directory at phase 20's options."""
    return ["mapping-evaluation", "--sequence_dir", path, *cli_overrides(slam2d_overrides())]


def cli_ate(out):
    """The ATE RMSE (m) a mapping-evaluation run printed, or None."""
    if "ATE RMSE:" not in out:
        return None
    return float(out.split("ATE RMSE:")[1].split("m")[0])


@contextlib.contextmanager
def patched(owner, name, wrap):
    """owner.name replaced by wrap(owner.name) for the block (a class's
    method, or a module's function), then restored."""
    fn = getattr(owner, name)
    own = not isinstance(owner, type) or name in vars(owner)
    setattr(owner, name, wrap(fn))
    try:
        yield
    finally:
        if own:
            setattr(owner, name, fn)
        else:
            delattr(owner, name)


def run_cli(argv):
    """The port's tools.cli.main(argv) in this process: (exit code, what it
    printed)."""
    from hectorgrapher_tpu_torch.tools import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return rc, out.getvalue()


def read_png(path):
    """An image that io/image.write_png wrote (8-bit gray or RGB, filter 0
    on every row) as a numpy array."""
    with open(path, "rb") as f:
        data = f.read()
    pos, idat, header = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, _, color_type = header[:4]
    ch = 3 if color_type == 2 else 1
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w * ch + 1)
    if rows[:, 0].any():
        fail(f"{path}: a PNG row with a filter other than 0")
    return rows[:, 1:].reshape(h, w, ch) if ch == 3 else rows[:, 1:].reshape(h, w)


def parity_line(ate, jax_ate):
    return f"ATE {ate:.4f} m (JAX CLI on the CPU {jax_ate:.4f}, bound {max(2 * jax_ate, jax_ate + 0.05):.4f})"


def run_phase_26a(device, tmp):
    """Phase 26a: the DRZ-shaped bag through `mapping-evaluation --use_3d`
    at phase 13's options, in this process, on the card. The bag (written
    by the port's rosbag encoders) must have the JAX reference run's
    sha256; per-scan host clocks wrap TrajectoryBuilder.add_range_data (a
    synchronize at its end), others the bag read and the final
    optimization. Gates: exit code 0, the ATE printed and within max(2 x,
    +0.05 m) of the JAX CLI's, the first range event's per-point times over
    more than 0.05 s, K3 and K4 launched and a batched round run. Returns
    the state file, the decoded events and K3 / K4 launches."""
    from hectorgrapher_tpu_torch.io import rosbag
    from hectorgrapher_tpu_torch.mapping import map_builder as map_builder_module

    bag, state = os.path.join(tmp, "drz26.bag"), os.path.join(tmp, "drz26.npz")
    t0 = time.perf_counter()
    sha = write_drz26_bag(bag, rosbag)
    write_s = time.perf_counter() - t0
    if sha != JAX_DRZ26_SHA256:
        fail(f"phase 26a: the bag's sha256 {sha} is not the JAX reference run's {JAX_DRZ26_SHA256}")
    fast_correlative_3d.match_fast_3d.score_sums = 0
    fast_scores_3d.launches = 0
    reset_k3_counts()
    window_solver.solve_ct_window.assemblies = 0
    rec = dict(read=0.0, events=None, scans=[], final=[], rounds=0, read_end=None, final_start=None)

    def timed_read(fn):
        def run(*a, **kw):
            t_read = time.perf_counter()
            rec["events"] = fn(*a, **kw)
            rec["read_end"] = time.perf_counter()
            rec["read"] = rec["read_end"] - t_read
            return rec["events"]
        return run

    def timed_scan(fn):
        def run(self, data):
            t_scan = time.perf_counter()
            out = fn(self, data)
            sync(device)
            rec["scans"].append(time.perf_counter() - t_scan)
            return out
        return run

    def timed_final(fn):
        def run(self, *a, **kw):
            if threading.current_thread() is not threading.main_thread():  # the worker's periodic solve
                return fn(self, *a, **kw)
            rec["final_start"] = time.perf_counter()
            out = fn(self, *a, **kw)
            sync(device)
            rec["final"].append(time.perf_counter() - rec["final_start"])
            return out
        return run

    def counted_round(fn):
        def run(self, *a, **kw):
            rec["rounds"] += 1
            return fn(self, *a, **kw)
        return run

    with contextlib.ExitStack() as stack:
        gn3d = stack.enter_context(counted_gn3d_blocks({"serial": 0, "packed": 0}))
        stack.enter_context(patched(rosbag, "read_bag_sequence", timed_read))
        stack.enter_context(patched(map_builder_module.TrajectoryBuilder, "add_range_data", timed_scan))
        stack.enter_context(patched(PoseGraph3D, "run_final_optimization", timed_final))
        stack.enter_context(patched(PoseGraph3D, "_compute_constraints_batched", counted_round))
        t0 = time.perf_counter()
        rc, out = run_cli(drz26_argv(bag) + ["--output_state", state])
        wall = time.perf_counter() - t0
    ate = cli_ate(out)
    assemblies = window_solver.solve_ct_window.assemblies
    k3 = assemblies + gn3d["serial"] + gn3d["packed"]
    k4 = fast_scores_3d.launches
    if rc != 0 or ate is None or not os.path.exists(state):
        fail(f"phase 26a: mapping-evaluation exited {rc}, ATE {ate}, state written {os.path.exists(state)}: "
             f"{out[-2000:]}")
    if ate > max(2 * JAX_DRZ26_ATE, JAX_DRZ26_ATE + 0.05):
        fail(f"phase 26a: {parity_line(ate, JAX_DRZ26_ATE)} is out of bounds")
    ranges = [e for e in rec["events"] if e.kind == "range"]
    span = float(np.ptp(ranges[0].times)) if ranges and ranges[0].times is not None else 0.0
    if span <= 0.05:
        fail(f"phase 26a: the first range event's per-point times span {span:.4f} s")
    k3_all = ct_scan_block.launches + ct_scan_block_slots.launches
    if assemblies == 0 or k3 != k3_all or k4 == 0 or k4 != fast_correlative_3d.match_fast_3d.score_sums \
            or rec["rounds"] == 0:
        fail(f"phase 26a: K3 launches {k3_all} ({assemblies} CT assemblies, GN3D {gn3d}), K4 launches {k4}, "
             f"{rec['rounds']} batched rounds")
    counts = out.split("nodes:")[1].splitlines()[0].strip()
    lat = np.array(rec["scans"]) * 1e3
    print(f"phase 26a (mapping-evaluation --use_3d over the DRZ-shaped bag: {len(ranges)} scans of "
          f"{DRZ26_RAYS[0]} x {DRZ26_RAYS[1]} rays, {os.path.getsize(bag)} B, sha256 = the JAX run's): {parity_line(ate, JAX_DRZ26_ATE)}; "
          f"nodes: {counts}; bag written in {write_s:.3f} s, read {rec['read']:.3f} s, SLAM "
          f"{rec['final_start'] - rec['read_end']:.3f} s, final optimization {rec['final'][0]:.3f} s, CLI "
          f"{wall:.3f} s; per scan median {np.median(lat):.3f} ms, p95 {np.percentile(lat, 95):.3f} ms over "
          f"{len(lat)} scans; K3 launches {k3} ({assemblies} CT assemblies, {gn3d['serial']} serial GN3D, "
          f"{gn3d['packed']} packed GN3D), K4 launches {k4}, {rec['rounds']} batched rounds; first scan's point "
          f"times over {span:.4f} s", flush=True)
    return dict(state=state, events=rec["events"], k3=k3, k4=k4)


def run_phase_26b(device, tmp):
    """Phase 26b: phase 6's 60 scans as a sequence directory of binary PLY
    files (the port's write_ply) through the 2D mapping-evaluation at phase
    20's options. Gates: the files' sha256 equals the JAX reference run's,
    exit code 0, the ATE within max(2 x, +0.05 m) of the JAX CLI's, K1, K2
    and K5 each launched. Returns ((K1, K2), K5) launches."""
    from hectorgrapher_tpu_torch.io.readers import write_ply

    path = os.path.join(tmp, "seq26")
    sha = write_seq26_dir(path, write_ply)
    if sha != JAX_SEQ26_SHA256:
        fail(f"phase 26b: the files' sha256 {sha} is not the JAX reference run's {JAX_SEQ26_SHA256}")
    correlative_prep_2d.launches = correlative_scores_2d.launches = fast_scores_2d.launches = 0
    t0 = time.perf_counter()
    rc, out = run_cli(seq26_argv(path))
    wall = time.perf_counter() - t0
    ate = cli_ate(out)
    k1, k2, k5 = correlative_prep_2d.launches, correlative_scores_2d.launches, fast_scores_2d.launches
    if rc != 0 or ate is None:
        fail(f"phase 26b: mapping-evaluation exited {rc}, ATE {ate}: {out[-2000:]}")
    if ate > max(2 * JAX_SEQ26_ATE, JAX_SEQ26_ATE + 0.05):
        fail(f"phase 26b: {parity_line(ate, JAX_SEQ26_ATE)} is out of bounds")
    if not (k1 and k2 and k5):
        fail(f"phase 26b: launches K1 {k1}, K2 {k2}, K5 {k5}")
    counts = out.split("nodes:")[1].splitlines()[0].strip()
    print(f"phase 26b (2D mapping-evaluation over a sequence directory of 60 PLY scans, sha256 = the JAX run's): "
          f"{parity_line(ate, JAX_SEQ26_ATE)}; nodes: {counts}; CLI {wall:.3f} s; launches K1 {k1}, K2 {k2}, "
          f"K5 {k5}", flush=True)
    return (k1, k2), k5


def pbstream_occupancy_gaps(served, decoded, origin_t):
    """A served occupancy grid against its pbstream decode: (known cells
    served, decoded, largest probability difference over the served known
    cells), as pbstream_grid_gaps maps the decoded box."""
    res = float(served.meta.resolution)
    base = np.round((served.meta.min_corner.double().cpu().numpy() - origin_t) / res + 0.5).astype(np.int64)
    lo = np.round(decoded.meta.min_corner.double().cpu().numpy() / res + 0.5).astype(np.int64)
    idx = served.known.nonzero()
    j = idx + torch.as_tensor(base - lo, device=idx.device)
    if bool(((j < 0) | (j >= torch.as_tensor(decoded.shape, device=idx.device))).any()):
        return int(idx.shape[0]), int(decoded.known.sum()), math.inf
    at = lambda g, ix: g.probability()[ix[:, 0], ix[:, 1], ix[:, 2]]
    return int(idx.shape[0]), int(decoded.known.sum()), float((at(served, idx) - at(decoded, j)).abs().max())


def start_server_26(device):
    """26d's map-builder-server, a child process of the port's CLI on
    `device` at phase 13's options, batched CT windows; its output lines go
    to a list as they come."""
    sync(device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    argv = [sys.executable, "-m", "hectorgrapher_tpu_torch.tools.cli", "--device", str(device), "map-builder-server", "--use_3d",
            "--batch_ct_windows", "--monitoring_port", "-1", "--address", "127.0.0.1:0",
            *cli_overrides(slam_overrides(batched=True, probability=True))]
    proc = subprocess.Popen(argv, cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines = []
    reader = threading.Thread(target=lambda: lines.extend(iter(proc.stdout.readline, "")), daemon=True)
    reader.start()
    return dict(proc=proc, lines=lines, reader=reader, t0=time.perf_counter())


def stop_server_26(server):
    if server["proc"].poll() is None:
        server["proc"].kill()
        server["proc"].wait()


def run_phase_26c(device, tmp, drz):
    """Phase 26c: the state tools on 26a's state, through the CLI. Gates:
    state-info reads it as 3D; state-convert npz -> pbstream -> npz: the
    pbstream's pose graph and its npz bit-equal as stored (state_gaps), and
    the pbstream against the state as phase 23b holds its pbstream (node
    poses exact, each occupancy grid's known cells equal, probabilities
    within one uint16 code step); paint-map on the card has known pixels and
    equals paint-map of the same state on the CPU, but for at most a
    thousandth of its pixels one level off (exp on the card and on the CPU
    may part in the last bit); HybridGridPointsProcessor over 26a's first
    10 scans at 256^3 on the card against the CPU: log-odds within 1e-5,
    known equal."""
    from hectorgrapher_tpu_torch.io.points_pipeline import PointsBatch, build_pipeline, run_pipeline
    from hectorgrapher_tpu_torch.io.serialization import load_state
    from hectorgrapher_tpu_torch.mapping import probability_values as pv

    state, cpu = drz["state"], torch.device("cpu")
    rc, out = run_cli(["state-info", state])
    if rc != 0 or "dimension: 3D" not in out:
        fail(f"phase 26c: state-info exited {rc}: {out[-1000:]}")
    pbs, back = os.path.join(tmp, "drz26.pbstream"), os.path.join(tmp, "drz26_back.npz")
    t0 = time.perf_counter()
    rcs = [run_cli(["state-convert", a, b])[0] for a, b in ((state, pbs), (pbs, back))]
    convert_s = time.perf_counter() - t0
    if rcs != [0, 0]:
        fail(f"phase 26c: state-convert exited {rcs}")

    def loaded(path, loader):
        pg = PoseGraph3D(cfg.MapBuilderOptions().pose_graph, device=device)
        return pg, loader(pg, path, load_frozen_state=False)

    (pg_a, _), (pg_p, _), (pg_b, remap) = (loaded(state, load_state), loaded(pbs, load_pbstream_state),
                                           loaded(back, load_state))
    gap = state_gaps(pg_p, pg_b, remap)  # back.npz holds the ids the pbstream's load gave
    if gap is not None:
        fail(f"phase 26c: npz -> pbstream -> npz: the npz differs from the pbstream's graph at {gap}")
    if len(pg_p.nodes) != len(pg_a.nodes) or len(pg_p.constraints) != len(pg_a.constraints) \
            or len(pg_p.submaps) != len(pg_a.submaps):
        fail(f"phase 26c: the pbstream gave {len(pg_p.nodes)} nodes, {len(pg_p.constraints)} constraints, "
             f"{len(pg_p.submaps)} submaps of {len(pg_a.nodes)}, {len(pg_a.constraints)}, {len(pg_a.submaps)}")
    for a, b in zip(pg_a.nodes, pg_p.nodes):
        if not (np.array_equal(a.global_pose.t, b.global_pose.t) and np.array_equal(a.local_pose.q, b.local_pose.q)
                and abs(a.time - b.time) < 1e-7):
            fail(f"phase 26c: pbstream node at {a.time} differs")
    step, worst = (pv.MAX_PROBABILITY - pv.MIN_PROBABILITY) / 32766, 0.0
    for a, b in zip(pg_a.submaps, pg_p.submaps):
        for key in ("high_resolution_grid", "low_resolution_grid"):
            n_a, n_b, d = pbstream_occupancy_gaps(getattr(a.submap, key), getattr(b.submap, key),
                                                  a.submap.local_pose.t)
            if n_a != n_b or d > step:
                fail(f"phase 26c: pbstream {key}: {n_b} of {n_a} known cells, probability within {d:.3e} "
                     f"(step {step:.3e})")
            worst = max(worst, d)
    del pg_a, pg_p, pg_b

    pngs = [os.path.join(tmp, f"map26_{d}.png") for d in ("card", "cpu")]
    t0 = time.perf_counter()
    rc_card, _ = run_cli(["paint-map", state, pngs[0]])
    paint_s = time.perf_counter() - t0
    rc_cpu, _ = run_cli(["--device", "cpu", "paint-map", state, pngs[1]])
    if (rc_card, rc_cpu) != (0, 0):
        fail(f"phase 26c: paint-map exited {rc_card} on the card, {rc_cpu} on the CPU")
    img, img_cpu = read_png(pngs[0]), read_png(pngs[1])
    known = int((img != np.array([127, 0, 0], np.uint8)).any(axis=-1).sum())
    diff = np.abs(img.astype(np.int16) - img_cpu.astype(np.int16)).max(axis=-1) if img.shape == img_cpu.shape else None
    if known == 0 or diff is None or diff.max() > 1 or int((diff > 0).sum()) > img.shape[0] * img.shape[1] // 1000:
        fail(f"phase 26c: paint-map: {known} known pixels; card {img.shape} against CPU {img_cpu.shape}, "
             f"{'-' if diff is None else int((diff > 0).sum())} pixels apart")

    batches = [PointsBatch(points=e.payload + drz26_truth(e.time).astype(np.float32), origin=drz26_truth(e.time))
               for e in drz["events"] if e.kind == "range"][:10]
    grids, hybrid_s = [], []
    for dev in (device, cpu):
        path = os.path.join(tmp, f"hybrid26_{dev.type}.npz")
        pipeline = build_pipeline([{"action": "min_max_range_filter", "min_range": 0.4, "max_range": 25.0},
                                   {"action": "write_hybrid_grid", "filename": path, "voxel_size": 0.1}], device=dev)
        t0 = time.perf_counter()
        run_pipeline(pipeline, lambda: batches)
        hybrid_s.append(time.perf_counter() - t0)
        with np.load(path) as data:
            grids.append((data["log_odds"], data["known"]))
    d_lo = float(np.abs(grids[0][0] - grids[1][0]).max())
    if not np.array_equal(grids[0][1], grids[1][1]) or d_lo > 1e-5 or not grids[0][1].any():
        fail(f"phase 26c: HybridGridPointsProcessor: known equal {np.array_equal(grids[0][1], grids[1][1])} "
             f"({int(grids[0][1].sum())} cells), log-odds within {d_lo:.3e} of the CPU's")
    print(f"phase 26c (the state tools on 26a's state): state-info 3D; state-convert npz -> pbstream -> npz in "
          f"{convert_s:.3f} s ({os.path.getsize(pbs)} B pbstream), the npz bit-equal as stored to the pbstream's "
          f"graph, the pbstream's occupancy within {worst:.3e} (step {step:.3e}), nodes exact; paint-map "
          f"{img.shape[1]}x{img.shape[0]} px in {paint_s:.3f} s on the card, {known} known pixels, "
          f"{int((diff > 0).sum())} pixels one level off the CPU's; HybridGridPointsProcessor over 10 scans at "
          f"256^3: {int(grids[0][1].sum())} known cells, equal on the card and the CPU, log-odds within "
          f"{d_lo:.3e}; {hybrid_s[0]:.3f} s on the card, {hybrid_s[1]:.3f} s on the CPU", flush=True)


def run_phase_26d(device, server, events):
    """Phase 26d: 26a's bag served by the CLI's map-builder-server in a
    child process on the card (started by start_server_26). Through the
    port's client: one trajectory, the bag's IMU, odometry and 40 scans;
    gates: at least one local SLAM result back, GetSubmap(0) above 4 MB
    with known cells (an insertion reached it: C24 through the CLI), exit
    code 0 within 30 s of SIGINT."""
    import re

    from hectorgrapher_tpu_torch.cloud.client import MapBuilderStub

    proc, port = server["proc"], None
    while port is None and time.perf_counter() - server["t0"] < SERVER26_TIMEOUT_S and proc.poll() is None:
        found = [re.search(r"listening on port (\d+)", line) for line in list(server["lines"])]
        port = next((int(m.group(1)) for m in found if m), None)
        time.sleep(0.05)
    start_s = time.perf_counter() - server["t0"]
    if port is None:
        fail(f"phase 26d: map-builder-server did not listen within {SERVER26_TIMEOUT_S} s (exit "
             f"{proc.poll()}): {''.join(server['lines'])[-2000:]}")
    stub = MapBuilderStub(f"127.0.0.1:{port}")
    tid = stub.add_trajectory_builder()
    tb = stub.get_trajectory_builder(tid)
    capacity = 1 << int(np.ceil(np.log2(max(len(e.payload) for e in events if e.kind == "range"))))
    t0 = time.perf_counter()
    for e in events:
        if e.kind == "imu":
            tb.add_imu_data(e.time, *e.payload)
        elif e.kind == "odometry":
            tb.add_odometry_data(e.time, e.payload)
        else:
            tb.add_range_data(TimedPointCloudData(e.time, np.zeros(3, np.float32),
                                                  pad_timed_cloud(e.payload, e.times, capacity)))
    stub.pose_graph.run_final_optimization()  # after the server drained its sensor queue
    serve_s = time.perf_counter() - t0
    results = stub.get_local_slam_results(tid)
    t0 = time.perf_counter()
    sub = stub.get_submap(0)
    get_s = time.perf_counter() - t0
    stub.close()
    grids = [sub.get(k) for k in ("high_resolution_grid", "low_resolution_grid")]
    nbytes = sum(g["log_odds"].nbytes + g["known"].nbytes for g in grids if g is not None)
    known = sum(int(g["known"].sum()) for g in grids if g is not None)
    if not results or "error" in sub or nbytes <= 4 * 1024 * 1024 or known == 0:
        fail(f"phase 26d: {len(results)} local SLAM results, GetSubmap(0) {sub.get('error', '')} {nbytes} B with "
             f"{known} known cells")
    t0 = time.perf_counter()
    proc.send_signal(signal.SIGINT)
    try:
        rc = proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        rc = None
    stop_s = time.perf_counter() - t0
    if rc != 0:
        fail(f"phase 26d: map-builder-server gave exit code {rc} {stop_s:.1f} s after SIGINT: "
             f"{''.join(server['lines'])[-2000:]}")
    print(f"phase 26d (map-builder-server --use_3d --batch_ct_windows as a child process): listening "
          f"{start_s:.3f} s after its start; {sum(e.kind == 'range' for e in events)} scans with IMU and odometry "
          f"served in {serve_s:.3f} s, {len(results)} local SLAM results; GetSubmap(0) {nbytes} B ({known} known "
          f"cells) in {get_s:.3f} s; exit code 0 {stop_s:.3f} s after SIGINT", flush=True)


PHASE_MARKS = []


def mark(label):
    """The start of a phase of main(), for the seconds-by-phase line."""
    PHASE_MARKS.append((label, time.perf_counter()))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile-ct", type=int, default=0, metavar="N",
                        help="after phase 9, profile N more CT front-end scans with torch.profiler")
    parser.add_argument("--solver-plane-child", nargs=3, metavar=("ROLE", "PORT", "PORT"), help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.solver_plane_child:  # one of phase 24b's child processes
        role, coord_port, follower_port = args.solver_plane_child
        solver_plane_child(role, int(coord_port), int(follower_port))
        return 0

    mark("1")
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

    mark("2")
    # Phase 2: build the kernels from csrc/.
    t0 = time.perf_counter()
    _build.load_library()
    ptxas = [l.strip() for l in _build.build_log.splitlines() if "registers" in l or "Compiling entry" in l]
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds:.2f} s); "
          + " | ".join(ptxas), flush=True)

    mark("3 and 4")
    # Phases 3 and 4: each kernel against its plain version, at the front
    # end's shape and at the batched shape.
    checks = check_kernels({
        "front_end": front_end_kernel_inputs(device),
        "batched": batched_scene(device),
    })
    check_k1_boundaries(device)
    check_k2_cases(device)

    mark("5")
    # Phase 5: the batched matcher, through both kernels and K7 (its GN
    # solve at B = 1024, 10 iterations, held to its twin on the first step).
    correlative_prep_2d.launches = 0
    correlative_scores_2d.launches = 0
    with k7_sites([]) as k7_calls:
        run_batched(device)
    if correlative_prep_2d.launches == 0 or correlative_scores_2d.launches == 0 or not k7_calls:
        fail("batched matcher did not launch K1, K2 and K7")
    k12_paths = {"batched5": (correlative_prep_2d.launches, correlative_scores_2d.launches)}
    k7_paths = {"batched5": len(k7_calls)}
    checks["gn_2d_lm"] = {"batched": check_k7("batched", [c[1:] for c in k7_calls[:1]], lanes=True, timed=0)}
    del k7_calls

    mark("6")
    # Phase 6: the front end, through both kernels on every matched scan.
    correlative_prep_2d.launches = 0
    correlative_scores_2d.launches = 0
    with k7_sites([]) as k7_calls:
        n_matched, latencies, t_err, y_err, builder, _ = run_front_end(device)
    launches = {"correlative_prep_2d": correlative_prep_2d.launches,
                "correlative_scores_2d": correlative_scores_2d.launches, "gn_2d_lm": len(k7_calls)}
    k12_paths["front_end6"] = (correlative_prep_2d.launches, correlative_scores_2d.launches)
    if any(v != n_matched for v in launches.values()) or n_matched == 0:
        fail(f"front end: launches {launches} != {n_matched} matched scans")
    # K7 on every matched scan against its twin; the timed row is the last
    # scan's (a submap of ~60 scans).
    checks["gn_2d_lm"]["front_end"] = check_k7("front_end", [c[1:] for c in k7_calls], timed=len(k7_calls) - 1)
    del k7_calls
    if not bool(builder.active_submaps.matching_submap.grid.known.any()):
        fail("front end: the active submap has no known cells")
    if t_err > MAX_TRANSLATION_ERROR or y_err > MAX_YAW_ERROR:
        fail(f"front end: max error {t_err:.5f} m / {y_err:.5f} rad exceeds "
             f"{MAX_TRANSLATION_ERROR:.5f} m / {MAX_YAW_ERROR:.5f} rad")
    lat_ms = np.array(latencies) * 1e3
    print(f"front end: {n_matched} matched scans, launches {launches}; max error {t_err:.5f} m / {y_err:.5f} rad "
          f"(bounds {MAX_TRANSLATION_ERROR:.5f} / {MAX_YAW_ERROR:.5f}); per-scan latency median "
          f"{np.median(lat_ms):.3f} ms, p95 {np.percentile(lat_ms, 95):.3f} ms", flush=True)

    mark("7")
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
    # K3's per-point mode on the f32 maps (and below on the occupancy and
    # f16 ones), alone and slotted over three grid pairs.
    check_points_mode(device, "", [(hi, lo)] + [ct_production_grids(device, n_scans=n)[:2] for n in (2, 1)],
                      scan_pts, checks)
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
    check_points_mode(device, "prob_", pairs, scan_pts, checks)
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
        if tag == "f16":
            check_points_mode(device, "f16_", pairs, scan_pts, checks)
        del hi, lo, pairs, slots, a
    if not all((ct_scan_block.f16_launches, ct_scan_block.bf16_launches, ct_scan_block_slots.f16_launches,
                ct_scan_block_slots.bf16_launches)):
        fail("phase 7: K3 did not launch in its f16 and bf16 modes")
    if not all((ct_scan_block_points.launches, ct_scan_block_points.f16_launches, ct_scan_block_points.prob_launches,
                ct_scan_block_points_slots.f16_launches, ct_scan_block_points_slots.prob_launches)):
        fail("phase 7: K3's per-point mode did not launch in its f32, f16 and probability modes")
    # K6: an LM assembly's pair residuals and cloud poses against their eager
    # twins at the CT front end's shape (rotated states, masked pairs, a
    # sign flip and a lerp pair).
    for name, rec in check_ct_pair_block(*ct_pair_block_inputs(device), "front_end").items():
        checks[name] = {"front_end": rec}

    mark("8")
    # Phase 8: the window solve on the production-extent fixture.
    run_ct_window(device)

    mark("9")
    # Phase 9: the CT front end, through K3 on every assembly.
    before = latency_snapshot()
    n_scans, ct_lat, ct_t_err, ct_y_err, ct_builder, ct_counts = run_ct_front_end(
        device, profile_scans=args.profile_ct)
    k3_launches, assemblies = ct_counts["k3"], ct_counts["assemblies"]
    launches["ct_scan_block"] = k3_launches
    if k3_launches != assemblies or k3_launches == 0:
        fail(f"CT front end: {k3_launches} K3 launches for {assemblies} solver assemblies")
    k6 = (ct_counts["k6_pairs"], ct_counts["k6_clouds"], ct_counts["pairs_eager"])
    if k6 != (assemblies, assemblies, 0):
        fail(f"CT front end: K6 pair and cloud launches and eager pair residuals {k6} for {assemblies} assemblies")
    launches["ct_pair_residuals"], launches["ct_cloud_poses"] = k6[:2]
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
          f"({ct_builder.num_optimizations / n_scans:.2f} per scan), K3 launches {k3_launches} = K6 pair and "
          f"cloud launches {k6[0]}, {k6[1]} = assemblies {assemblies}; max error {ct_t_err:.5f} m / {ct_y_err:.5f} rad (JAX on the CPU "
          f"{JAX_CT_TRANSLATION_ERROR:.5f} / {JAX_CT_YAW_ERROR:.5f}, bounds {CT_MAX_TRANSLATION_ERROR:.5f} / "
          f"{CT_MAX_YAW_ERROR:.5f}); per-scan latency median {np.median(lat_ms):.3f} ms, "
          f"p95 {np.percentile(lat_ms, 95):.3f} ms over {len(lat_ms)} scans; {ct_counts['kernels_per_scan']:.0f} "
          "kernels a scan (device trace of 1 scan)", flush=True)
    print_front_end_metrics("CT front end (phase 9)", ct_builder, before)
    del ct_builder

    # Phases 17-19: the CT front end with per-point unwarping, then with
    # the DIRECT IMU term as well, each assembly one per-point K3 launch;
    # the batched window solve at B = 8, one slotted K3 launch an assembly.
    mark("17")
    captured, launches["ct_scan_block_points"] = run_phase_17(device)
    mark("18")
    k3p_paths = {"ct17_per_point": launches["ct_scan_block_points"], "ct18_direct": run_phase_18(device)}
    mark("19")
    _, k3_paths19, k3p_paths19 = run_phase_19(device, captured)
    k3p_paths.update(k3p_paths19)
    del captured

    mark("10")
    # Phase 10: K4 against its plain version in a full fast match over a
    # production-extent submap.
    checks["fast_scores_3d"] = run_fast_match(device, *fast_match_submap(device))
    check_fast_scores_chunks(device)

    mark("11")
    # Phase 11: the 3D SLAM path, through K4 on every score sum of every
    # constraint search, and K3 on every CT assembly and GN3D evaluation.
    fast_correlative_3d.match_fast_3d.score_sums = 0
    fast_scores_3d.launches = 0
    ct_scan_block.launches = 0
    window_solver.solve_ct_window.assemblies = 0
    slam = run_slam(device)
    del slam["pose_graph"], slam["local_builder"], slam["map_builder"]
    launches["fast_scores_3d"] = fast_scores_3d.launches
    score_sums = fast_correlative_3d.match_fast_3d.score_sums
    # Only the window solve and GN3D call K3: the solve once per assembly.
    k3_slam_front, k3_gn3d = (window_solver.solve_ct_window.assemblies,
                              ct_scan_block.launches - window_solver.solve_ct_window.assemblies)
    k3_paths = {"ct_front_end": launches["ct_scan_block"], "slam_front_end": k3_slam_front, "slam_gn3d": k3_gn3d,
                **k3_paths19}
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

    mark("12")
    # Phase 12: the same drive with the default batched constraint search.
    k4_paths, k3_paths["slam_gn3d_packed"], shapes12, (lat12, round12_ms, grid_bytes12) = run_phase_12(
        device, slam, launches["fast_scores_3d"])
    checks["fast_scores_3d"].update(shapes12["fast_scores_3d"])
    checks["ct_scan_block"].update(shapes12["ct_scan_block"])

    mark("13")
    # Phase 13: the same drive and search on the default occupancy submaps.
    k3_paths13, k4_paths13 = run_phase_13(device, lat12, round12_ms)
    k3_paths.update(k3_paths13)
    k4_paths.update(k4_paths13)

    mark("14")
    # Phase 14: the same drive and search on float16 TSDF submaps.
    k3_paths14, k4_paths14, mb14, errors14 = run_phase_14(device, lat12, round12_ms, grid_bytes12)
    k3_paths.update(k3_paths14)
    k4_paths.update(k4_paths14)

    mark("15")
    # Phase 15: the plain SPA at the production operating point, PCG and Schur.
    run_phase_15(device)

    mark("16")
    # Phase 16: pure localization on phase 14's map.
    k3_paths["slam16_pure_localization"] = run_phase_16(device, mb14, errors14)
    del mb14

    mark("20")
    # Phase 20: MapBuilder 2D with the default batched constraint search,
    # through K5 once per pyramid level a round; K5 against its plain
    # version at the round's shapes, a full-submap search's and a round
    # over a pack of 4 submaps.
    k5_20, k12_paths["slam20"], checks["fast_scores_2d"], stats20, bytes20, k7_20 = run_phase_20(device)
    launches["fast_scores_2d"] = k5_20
    k7_paths["slam20"] = k7_20["launches"]
    checks["gn_2d_lm"]["round"] = k7_20["round"]

    mark("22")
    # Phase 22: (a) phase 20's drive on uint16 submaps, through K1 / K2 on
    # the scans matched against a just-quantized submap and K5 over the
    # decoded levels; (b) the TSDF front end in every storage dtype.
    k5_22, k12_paths["slam22a_uint16"], k7_paths["slam22a_uint16"] = run_phase_22a(device, stats20, bytes20)
    k7_paths.update(run_phase_22b(device))

    mark("21")
    # Phase 21: the 2D SPA through its Schur, PCG and dense paths.
    run_phase_21(device)

    mark("23")
    # Phase 23: the serving path: MapBuilderServer over gRPC with 8 CT
    # trajectories, their window solves batched (one slotted K3 launch an
    # assembly), against a serial server; state I/O; uplink ingestion.
    paths23 = run_phase_23(device)
    k3_paths.update(paths23["ct_scan_block"])
    k4_paths.update(paths23["fast_scores_3d"])

    mark("24a")
    # Phase 24: distribution: (a) the sharded SPA, rounds and window solves
    # over a mesh of SHARDS24 shards on the card; (b) the solver plane in
    # child processes, and an NCCL gather.
    paths24 = run_phase_24(device)
    for name, rec in paths24["k6"].items():
        checks[name]["batched_b8"] = rec
    k3_paths.update(paths24["ct_scan_block"])
    k3p_paths.update(paths24["ct_scan_block_points"])
    k4_paths.update(paths24["fast_scores_3d"])

    mark("25")
    # Phase 25: the classic 3D builder, each match refined through GN3D on
    # K3 (C = 1): the default options, then the online correlative search.
    k3_paths.update(run_phase_25(device))

    mark("26")
    # Phase 26: the CLI over recorded data: (a) the DRZ-shaped bag through
    # mapping-evaluation --use_3d, K3 and K4 through the CLI; (b) a 2D
    # sequence directory, K1, K2 and K5; (c) the state tools on (a)'s state;
    # (d) map-builder-server in a child process, serving (a)'s bag.
    with tempfile.TemporaryDirectory() as tmp26:
        drz = run_phase_26a(device, tmp26)
        k3_paths["drz26"], k4_paths["drz26"] = drz["k3"], drz["k4"]
        k12_paths["seq2d26"], k5_26 = run_phase_26b(device, tmp26)
        server = start_server_26(device)
        try:
            run_phase_26c(device, tmp26, drz)
            run_phase_26d(device, server, drz["events"])
        finally:
            stop_server_26(server)
        del drz

    sources = {
        "correlative_prep_2d": ("hectorgrapher_tpu_torch/csrc/correlative_prep_2d.cu",
                                "hectorgrapher_tpu/ops/pallas_prep2d.py:74"),
        "correlative_scores_2d": ("hectorgrapher_tpu_torch/csrc/correlative_scores_2d.cu",
                                  "hectorgrapher_tpu/ops/pallas_corr2d.py:64"),
        "ct_scan_block": ("hectorgrapher_tpu_torch/csrc/ct_scan_block.cu",
                          "hectorgrapher_tpu/mapping/ct/window_solver.py:467 (XLA fusion of scan_block, "
                          "with interpolated_grid.py:332-466)"),
        "ct_scan_block_points": ("hectorgrapher_tpu_torch/csrc/ct_scan_block.cu",
                                 "hectorgrapher_tpu/mapping/ct/window_solver.py:366 (XLA fusion of the per-point "
                                 "point_scan_block, :366-462, with interpolated_grid.py:332-466)"),
        "ct_pair_residuals": ("hectorgrapher_tpu_torch/csrc/ct_pair_block.cu",
                              "hectorgrapher_tpu/mapping/ct/window_solver.py:515 (jax.jacfwd of pair_block inside "
                              "the assembly's XLA fusion)"),
        "ct_cloud_poses": ("hectorgrapher_tpu_torch/csrc/ct_pair_block.cu",
                           "hectorgrapher_tpu/mapping/ct/window_solver.py:479 (jax.jacfwd of scan_block's pose_of "
                           "inside the assembly's XLA fusion)"),
        "fast_scores_3d": ("hectorgrapher_tpu_torch/csrc/fast_scores_3d.cu",
                           "hectorgrapher_tpu/mapping/scan_matching/fast_correlative_3d.py:329 (score_sum of "
                           "_match_fast_3d_core, an XLA gather-reduce)"),
        "fast_scores_2d": ("hectorgrapher_tpu_torch/csrc/fast_scores_2d.cu",
                           "hectorgrapher_tpu/mapping/scan_matching/fast_correlative_2d.py:249 (score_sum of "
                           "_match_fast_2d_core, an XLA gather-reduce)"),
        "gn_2d_lm": ("hectorgrapher_tpu_torch/csrc/gn_2d_lm.cu",
                     "hectorgrapher_tpu/mapping/scan_matching/gn_2d.py:82 (_lm_grid_2d, a jax.lax.while_loop in XLA)"),
    }
    # Each kernel's record at its main-path shape (K1 and K2 at B=1024, K3
    # at the CT front end's, K4 at the coarse stage's), its other shapes
    # under "shapes" (K3's probability mode under prob_*, its f16 and bf16
    # TSDF modes under f16_* and bf16_*); launches from its main path's run
    # (K1, K2: phase 6, with phases 5, 20 and 22a under "launches_by_path";
    # K3: phase 9, with phases 11-14 and 16 under
    # "launches_by_path", slam13_* all in probability mode, slam14_* and
    # slam16_* all in f16 mode, and phase 19's per-scan batched solves as
    # batched19_entry / batched19_drive, slotted launches of the gated
    # solve only, and phase 23's: serve23_batched_windows (the batched
    # window solves' slotted calls), serve23_slotted_all (those and the
    # batched server's packed GN3D), serve23_serial_server (per-cloud
    # launches of the serial server), and phase 25's GN3D launches of the
    # classic 3D builder (classic25a, classic25b, classic25b_cut), and the
    # CLI's bag run (drz26: CT assemblies and GN3D); K3 per point: phase 17,
    # with phases 18 and 19 beside it; K4: phase 11, with phases 12-14, 23
    # (both servers' rounds) and 26a (drz26) beside it under
    # "launches_by_path"; K5: phase 20, without its rounds' serial re-runs,
    # with phases 22a and 26b (seq2d26) beside it; K1 and K2 with 26b's
    # seq2d26; K6, pair residuals and cloud poses: phase 9, its batched
    # gate of phase 24a under "shapes" as batched_b8; K7: phase 6, with
    # phases 5, 20, 22a and 22b's four storages beside it).
    main_shape = {"correlative_prep_2d": "batched", "correlative_scores_2d": "batched",
                  "ct_scan_block": "front_end", "ct_scan_block_points": "front_end", "ct_pair_residuals": "front_end",
                  "ct_cloud_poses": "front_end", "fast_scores_3d": "coarse",
                  "fast_scores_2d": "round_coarse", "gn_2d_lm": "front_end"}
    paths = {"ct_scan_block": k3_paths, "ct_scan_block_points": k3p_paths, "fast_scores_3d": k4_paths,
             "gn_2d_lm": k7_paths,
             "fast_scores_2d": {"slam20": k5_20, "slam22a_uint16": k5_22, **paths24["fast_scores_2d"], "seq2d26": k5_26},
             **{name: {path: k[i] for path, k in k12_paths.items()}
                for i, name in enumerate(("correlative_prep_2d", "correlative_scores_2d"))}}
    kernels = []
    for name, (source, replaces) in sources.items():
        rec = checks[name][main_shape[name]]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            **{k: rec[k] for k in ("ms", "plain_ms", "device_ms", "bound_ms", "bound_by", "library_ms")},
            "max_abs_err": max(v["max_abs_err"] for v in checks[name].values()),
            "shapes": checks[name],
            **({"launches_by_path": paths[name]} if name in paths else {}),
        })
    mark("end")
    print("seconds by phase (from the start of each to the next): " + ", ".join(
        f"{a}: {t1 - t0:.1f}" for (a, t0), (_, t1) in zip(PHASE_MARKS, PHASE_MARKS[1:])), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
