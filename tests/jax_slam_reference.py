"""The JAX package's MapBuilder over chip_smoke.py's 3D SLAM drive, on the
CPU: the reference errors that chip_smoke.py holds phases 11 and 12 to.

    JAX_PLATFORMS=cpu python tests/jax_slam_reference.py [--batched] [--probability] [--storage float16] [--runs 2]

The drive (chip_smoke.slam_drive) and the options (chip_smoke.
slam_overrides, applied to the JAX package's MapBuilderOptions) are those
of the chip phase: serial constraint search, or with --batched the default
batched search (phase 12); --probability drops the TSDF override, so the
submaps keep the default grid_type, PROBABILITY_GRID (with --batched,
phase 13); --storage float16 stores the TSDF submaps' planes in float16
(with --batched, phase 14). Each run prints one JSON line with the counts
and errors of chip_smoke.slam_result; with the async work queue the
worker's timing against the front end moves the solves' starting poses,
so the constants chip_smoke.py records are the larger of each over the
runs. A full-width run holds a few GiB and takes a few minutes.

    JAX_PLATFORMS=cpu python tests/jax_slam_reference.py --slam-2d [--runs 2]

runs chip_smoke.py's phase 20 (chip_smoke.slam2d_scans: two laps of the
2D mapping-evaluation circle, with odometry) through the JAX MapBuilder
2D at chip_smoke.slam2d_overrides() (the async work queue, the batched
constraint search) and prints one JSON line a run with the counts and
errors of chip_smoke.slam2d_result: the JAX_SLAM20_* constants; with
--storage uint16 phase 22a's, the JAX_SLAM22_* constants (--grid-type
sets the submaps' grid type). --port
runs the same drive through the port's MapBuilder on the CPU (its kernels'
plain versions), and --sync turns the async work queue off in either
package, so that the two run the same schedule of searches and solves.
--back-end (async off) feeds the JAX front end's nodes and submaps to the
port's PoseGraph2D as well, and prints where the two back ends' INTER
constraints first part and the port's SPA replaying the JAX graph
(run_slam_2d_back_end; ~5 minutes).

    JAX_PLATFORMS=cpu python tests/jax_slam_reference.py --front-end-2d [--grid-type TSDF] [--storage S]

runs chip_smoke.py's phase 6 (chip_smoke.circle_scans, 60 scans) through
the JAX LocalTrajectoryBuilder2D at chip_smoke.SLICE_OVERRIDES on submaps
of that grid type and grid_storage_dtype, and prints its max translation
and yaw errors: with --grid-type TSDF, phase 22b's JAX_TSDF22_ERRORS
(float32, float16, bfloat16 or uint16; the half runs widen to f32, ROADMAP
C21). About a minute a run.

    JAX_PLATFORMS=cpu python tests/jax_slam_reference.py --ct-drift

runs tests/test_ct_builder.py's straight 3 s drive (96^3 / 48^3 grids,
seed 0) through the JAX OptimizingLocalTrajectoryBuilder once with TSDF
and once with PROBABILITY_GRID submaps, and prints each one's result count
and max translation error (ROADMAP C15).

    JAX_PLATFORMS=cpu python tests/jax_slam_reference.py --ct-drift --per-scan
    JAX_PLATFORMS=cpu python tests/jax_slam_reference.py --ct-drift --per-point [--direct]

run chip_smoke.py's CT drive (chip_smoke.ct_drive: CT_SCANS scans, with
--direct CT18_SCANS) through the JAX OptimizingLocalTrajectoryBuilder at
phase 9's full-width options (chip_smoke.ct_overrides): per scan, or with
per-point unwarping, and with --direct the DIRECT IMU cost term as well:
the max translation and yaw errors that chip_smoke.py holds phases 9, 17
and 18 to (JAX_CT_*, JAX_CT17_*, JAX_CT18_*). Each run takes about a
minute and ~2 GiB.

    JAX_PLATFORMS=cpu python tests/jax_slam_reference.py --classic-3d [--correlative] [--grids 192 96]

runs chip_smoke.py's phase 25 drive (chip_smoke.classic_drive: CLASSIC_SCANS
scans of the CT_ROOM box room, tests/test_local_3d_classic.py's straight
drive) through the JAX LocalTrajectoryBuilder3D at chip_smoke.
classic_overrides (the default options; --correlative turns the online
correlative search on, --grids sets the high and low grid sizes), and prints
its result count, max translation error and relative-motion error: the
JAX_CLASSIC25A (~25 s) and JAX_CLASSIC25B_CUT (--correlative --grids 192 96,
~4 min, ~6 GiB) constants. With the correlative search the JAX package
builds an (n + 4)^3 x 125 table on every scan, 8.8 GB at the default
256^3, so 25b's constant is taken at 192^3 / 96^3.

Every drive feeds the JAX package its scan times as float64, as the port
gets them (scan_time).

    JAX_PLATFORMS=cpu python tests/jax_slam_reference.py --drz-bag [--runs 1]
    JAX_PLATFORMS=cpu python tests/jax_slam_reference.py --sequence-2d [--runs 1]

write chip_smoke.py's phase 26a bag (chip_smoke.write_drz26_bag: 40 scans
of 512 x 64 rays, IMU and odometry) with the JAX package's bag encoders
and ray caster, or phase 26b's sequence directory (chip_smoke.
write_seq26_dir: phase 6's 60 scans as PLY files) with its PLY writer, run
the JAX CLI's mapping-evaluation on them at the chip phase's options
(chip_smoke.drz26_argv / seq26_argv: phase 13's and phase 20's), and print
one JSON line a run with the files' sha256 and the ATE: the JAX_DRZ26_* and
JAX_SEQ26_* constants. The CLI feeds the scans' times as the decoded
float64 stamps. The bag run holds a few GiB and takes several minutes.

    JAX_PLATFORMS=cpu python tests/jax_slam_reference.py --serve

runs chip_smoke.py's phase 23 drives (chip_smoke.serve_streams: the
SERVE_TRAJECTORIES box-room streams, SERVE_SCANS scans each, each at its
own seed and speed) one trajectory at a time through the JAX
OptimizingLocalTrajectoryBuilder at phase 23's front-end options
(chip_smoke.serve_overrides' trajectory_builder_3d keys: phase 9's full
width, submaps of 8 scans), and prints each trajectory's result count and
max translation and yaw errors: the JAX_SERVE_ERRORS that chip_smoke.py
holds the served trajectories to. About 2 minutes and ~2 GiB.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import chip_smoke  # noqa: E402
from hectorgrapher_tpu.common.config import MapBuilderOptions, replace_deep  # noqa: E402
from hectorgrapher_tpu.mapping.map_builder import MapBuilder  # noqa: E402
from hectorgrapher_tpu.sensor.types import TimedPointCloud, TimedPointCloudData  # noqa: E402
from hectorgrapher_tpu.transform.np_quat import NpRigid3  # noqa: E402


def scan_time(t) -> np.float64:
    """A scan time as the port receives it, a float64 (ROADMAP C25), for
    every drive of this script. jnp.asarray(t) would give a float32 (x64
    is off outside the test suite), and a float32 0.45 s lies below
    initialization_duration's 0.45: the JAX CT front end would then end
    its initialization a scan later than the port does."""
    return np.float64(t)


def run(batched: bool, probability: bool, storage=None) -> dict:
    mb = MapBuilder(replace_deep(MapBuilderOptions(), chip_smoke.slam_overrides(batched, probability, storage)))
    tb = mb.get_trajectory_builder(mb.add_trajectory_builder())
    t0 = time.perf_counter()
    for kind, t, *payload in chip_smoke.slam_drive():
        if kind == "imu":
            tb.add_imu_data(t, *payload)
        elif kind == "odom":
            tb.add_odometry_data(t, NpRigid3(payload[0].t, payload[0].q))
        else:
            data = payload[0]
            r = data.ranges
            tb.add_range_data(TimedPointCloudData(
                time=scan_time(data.time), origin=jnp.zeros(3, jnp.float32),
                ranges=TimedPointCloud(positions=r.positions, times=r.times, mask=r.mask), width=data.width))
    mb.pose_graph.wait_for_all_computations()
    return dict(chip_smoke.slam_result(mb.pose_graph), seconds=time.perf_counter() - t0)


def storage_overrides_2d(grid_type=None, storage=None, prefix="trajectory_builder_2d."):
    """The 2D submaps' grid_type and grid_storage_dtype overrides."""
    return {**({prefix + "submaps.grid_options_2d.grid_type": grid_type} if grid_type else {}),
            **({prefix + "submaps.grid_storage_dtype": storage} if storage else {})}


def run_slam_2d(sync: bool = False, grid_type=None, storage=None) -> dict:
    """chip_smoke.py's phase 20: the JAX MapBuilder 2D over two laps of the
    circle (chip_smoke.slam2d_scans) at chip_smoke.slam2d_overrides(); with
    sync, the async work queue off; with storage "uint16", phase 22a."""
    overrides = dict(chip_smoke.slam2d_overrides(), **({"pose_graph.async_work_queue": False} if sync else {}),
                     **storage_overrides_2d(grid_type, storage))
    mb = MapBuilder(replace_deep(MapBuilderOptions(), overrides))
    tb = mb.get_trajectory_builder(mb.add_trajectory_builder())
    scans = chip_smoke.slam2d_scans()
    t0 = time.perf_counter()
    for t, _, odom, cloud in scans:
        tb.add_odometry_data(t, NpRigid3(odom.t, odom.q))
        tb.add_range_data(TimedPointCloudData(
            time=scan_time(t), origin=jnp.zeros(3, jnp.float32),
            ranges=TimedPointCloud(positions=cloud.positions, times=cloud.times, mask=cloud.mask)))
    mb.pose_graph.wait_for_all_computations()
    return dict(chip_smoke.slam2d_result(mb.pose_graph, scans), seconds=time.perf_counter() - t0)


def front_end_2d_errors(grid_type=None, storage=None) -> dict:
    """chip_smoke.py's phase 6 (and with --grid-type TSDF, phase 22b): the
    JAX LocalTrajectoryBuilder2D over chip_smoke.circle_scans() at
    chip_smoke.SLICE_OVERRIDES on submaps of grid_type and storage; the max
    translation and yaw errors as chip_smoke.run_front_end takes them. The
    JAX package's half TSDF planes widen to f32 at the first insert
    (ROADMAP C21)."""
    import numpy as np

    from hectorgrapher_tpu.common.config import TrajectoryBuilder2DOptions
    from hectorgrapher_tpu.mapping.local_2d import LocalTrajectoryBuilder2D
    from hectorgrapher_tpu.transform import np_quat as nq

    builder = LocalTrajectoryBuilder2D(replace_deep(TrajectoryBuilder2DOptions(), dict(
        chip_smoke.SLICE_OVERRIDES, **storage_overrides_2d(grid_type, storage, prefix=""))))
    scans = chip_smoke.circle_scans()
    anchor = scans[0][1]
    t0 = time.perf_counter()
    t_err = y_err = 0.0
    for t, pose, odom, cloud in scans:
        builder.add_odometry_data(t, NpRigid3(odom.t, odom.q))
        result = builder.add_range_data(TimedPointCloudData(
            time=scan_time(t), origin=jnp.zeros(3, jnp.float32),
            ranges=TimedPointCloud(positions=cloud.positions, times=cloud.times, mask=cloud.mask)))
        truth = anchor.inverse().compose(pose)
        t_err = max(t_err, float(np.linalg.norm(result.local_pose.t[:2] - truth.t[:2])))
        d = nq.quat_yaw(result.local_pose.q) - nq.quat_yaw(truth.q)
        y_err = max(y_err, abs((d + np.pi) % (2 * np.pi) - np.pi))
    grid = builder.active_submaps.submaps[0].grid
    planes = getattr(grid, "tsd", getattr(grid, "log_odds", None))
    return dict(front_end_2d=True, grid_type=grid_type, storage=storage, max_translation_error=t_err,
                max_yaw_error=y_err, active_dtype=str(planes.dtype), seconds=time.perf_counter() - t0)


def ct_drift() -> None:
    """ROADMAP C15: test_straight_drive_tracks_pose's drive and error, on
    either grid type."""
    import numpy as np

    from hectorgrapher_tpu.mapping.ct.builder import OptimizingLocalTrajectoryBuilder
    from test_ct_builder import drive_ct, gt_pose, make_options

    for grid_type in ("TSDF", "PROBABILITY_GRID"):
        builder = OptimizingLocalTrajectoryBuilder(replace_deep(make_options(), {"submaps.grid_type": grid_type}))
        results = drive_ct(builder, duration=3.0, speed=0.2, odom_noise=0.002, seed=0)
        errs = [float(np.linalg.norm(r.local_pose.t - gt_pose(r.time)[0])) for r in results[2:]]
        print(json.dumps({"grid_type": grid_type, "results": len(results), "max_error": max(errs)}), flush=True)


def ct_front_end_errors(per_point: bool, direct: bool, n_scans: int) -> dict:
    """Phases 17-18: n_scans of chip_smoke.ct_drive through the JAX CT
    front end at chip_smoke.ct_overrides(per_point, direct); the max errors
    over its results, as chip_smoke.run_ct_front_end takes them."""
    from hectorgrapher_tpu.common.config import TrajectoryBuilder3DOptions
    from hectorgrapher_tpu.mapping.ct.builder import OptimizingLocalTrajectoryBuilder

    builder = OptimizingLocalTrajectoryBuilder(
        replace_deep(TrajectoryBuilder3DOptions(), chip_smoke.ct_overrides(per_point, direct)))
    t0 = time.perf_counter()
    t_err = y_err = 0.0
    n_results = 0
    for kind, t, *payload in chip_smoke.ct_drive(n_scans):
        if kind == "imu":
            builder.add_imu_data(t, *payload)
        elif kind == "odom":
            builder.add_odometry_data(t, NpRigid3(payload[0].t, payload[0].q))
        else:
            data = payload[0]
            r = data.ranges
            result = builder.add_range_data(TimedPointCloudData(
                time=scan_time(data.time), origin=jnp.zeros(3, jnp.float32),
                ranges=TimedPointCloud(positions=r.positions, times=r.times, mask=r.mask), width=data.width))
            if result is not None:
                n_results += 1
                e_t, e_y = chip_smoke.ct_pose_error(result.time, result.local_pose.t, result.local_pose.q)
                t_err, y_err = max(t_err, e_t), max(y_err, e_y)
    return dict(per_point=per_point, direct=direct, scans=n_scans, results=n_results, solves=builder.num_optimizations,
                max_translation_error=t_err, max_yaw_error=y_err, seconds=time.perf_counter() - t0)


def classic_3d_errors(correlative: bool, grids) -> dict:
    """Phase 25: chip_smoke.classic_drive through the JAX classic 3D builder
    at chip_smoke.classic_overrides(correlative, grids)."""
    from hectorgrapher_tpu.common.config import TrajectoryBuilder3DOptions
    from hectorgrapher_tpu.mapping.local_3d import LocalTrajectoryBuilder3D

    builder = LocalTrajectoryBuilder3D(
        replace_deep(TrajectoryBuilder3DOptions(), chip_smoke.classic_overrides(correlative, grids)))
    t0 = time.perf_counter()
    results = []
    for kind, t, *payload in chip_smoke.classic_drive():
        if kind == "imu":
            builder.add_imu_data(t, *payload)
        elif kind == "odom":
            builder.add_odometry_data(t, NpRigid3(payload[0].t, payload[0].q))
        else:
            data = payload[0]
            r = data.ranges
            result = builder.add_range_data(TimedPointCloudData(
                time=scan_time(data.time), origin=jnp.zeros(3, jnp.float32),
                ranges=TimedPointCloud(positions=r.positions, times=r.times, mask=r.mask), width=data.width))
            if result is not None:
                results.append(result)
    max_error, relative = chip_smoke.classic_errors(results)
    return dict(classic_3d=True, correlative=correlative, grids=grids, scans=chip_smoke.CLASSIC_SCANS,
                results=len(results), max_translation_error=max_error, relative_motion_error=relative,
                seconds=time.perf_counter() - t0)


def serve_errors() -> None:
    """Phase 23: each of chip_smoke.serve_streams' trajectories through the
    JAX CT front end at the front-end keys of chip_smoke.serve_overrides;
    its max errors against its own truth (ct_pose_error at its speed), as
    chip_smoke.run_phase_23a takes them from the served results; one JSON
    line a trajectory."""
    from hectorgrapher_tpu.common.config import TrajectoryBuilder3DOptions
    from hectorgrapher_tpu.mapping.ct.builder import OptimizingLocalTrajectoryBuilder

    prefix = "trajectory_builder_3d."
    overrides = {k[len(prefix):]: v for k, v in chip_smoke.serve_overrides().items() if k.startswith(prefix)}
    for tid, stream in enumerate(chip_smoke.serve_streams(chip_smoke.SERVE_TRAJECTORIES, chip_smoke.SERVE_SCANS)):
        speed = chip_smoke.CT_SPEED + chip_smoke.SERVE_SPEED_STEP * tid
        builder = OptimizingLocalTrajectoryBuilder(replace_deep(TrajectoryBuilder3DOptions(), overrides))
        t0 = time.perf_counter()
        t_err = y_err = 0.0
        n_results = 0
        for _, kind, payload in stream:
            if kind == "imu":
                builder.add_imu_data(*payload)
            elif kind == "odometry":
                builder.add_odometry_data(payload[0], NpRigid3(payload[1].t, payload[1].q))
            else:
                r = payload.ranges
                result = builder.add_range_data(TimedPointCloudData(
                    time=scan_time(payload.time), origin=jnp.zeros(3, jnp.float32),
                    ranges=TimedPointCloud(positions=r.positions, times=r.times, mask=r.mask), width=payload.width))
                if result is not None:
                    n_results += 1
                    e_t, e_y = chip_smoke.ct_pose_error(result.time, result.local_pose.t, result.local_pose.q, speed)
                    t_err, y_err = max(t_err, e_t), max(y_err, e_y)
        print(json.dumps(dict(trajectory=tid, speed=speed, results=n_results, solves=builder.num_optimizations,
                              max_translation_error=t_err, max_yaw_error=y_err, seconds=time.perf_counter() - t0)),
              flush=True)


def run_slam_2d_port(sync: bool = False) -> dict:
    """run_slam_2d through the port's MapBuilder on the CPU (plain kernel
    versions), the same drive and options: what phase 20 runs on the card,
    less the card's arithmetic."""
    import numpy as np
    import torch

    from hectorgrapher_tpu_torch.mapping.map_builder import MapBuilder as PortMapBuilder
    from hectorgrapher_tpu_torch.sensor.types import TimedPointCloud as PortCloud
    from hectorgrapher_tpu_torch.sensor.types import TimedPointCloudData as PortData

    options = chip_smoke.slam2d_options()
    if sync:
        options = chip_smoke.cfg.replace_deep(options, {"pose_graph.async_work_queue": False})
    mb = PortMapBuilder(options, device=torch.device("cpu"))
    tb = mb.get_trajectory_builder(mb.add_trajectory_builder())
    scans = chip_smoke.slam2d_scans()
    t0 = time.perf_counter()
    for t, _, odom, cloud in scans:
        tb.add_odometry_data(t, odom)
        tb.add_range_data(PortData(t, np.zeros(3, np.float32), PortCloud(cloud.positions, cloud.times, cloud.mask)))
    mb.pose_graph.wait_for_all_computations()
    return dict(chip_smoke.slam2d_result(mb.pose_graph, scans), seconds=time.perf_counter() - t0)


def run_slam_2d_back_end() -> dict:
    """Phase 20's drive, the async work queue off, through the JAX
    MapBuilder, each node and its submaps also fed to the port's
    PoseGraph2D on the CPU: the port's back end on the JAX front end's
    output. Returns both packages' slam2d_result, the first INTER
    constraint whose zbar differs by more than 1 mm (node, submap, the
    largest node-pose difference of the two graphs just before it, each
    zbar's distance from the truth), and the port's final optimization
    run on the JAX graph's poses and constraints (replay) with its largest
    node difference from the JAX result."""
    import numpy as np
    import torch

    from hectorgrapher_tpu_torch import convert
    from hectorgrapher_tpu_torch.mapping.pose_graph.pose_graph import Constraint as PortConstraint
    from hectorgrapher_tpu_torch.mapping.pose_graph.pose_graph import PoseGraph2D
    from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3 as PortRigid3

    cpu = torch.device("cpu")
    overrides = dict(chip_smoke.slam2d_overrides(), **{"pose_graph.async_work_queue": False})
    mb = MapBuilder(replace_deep(MapBuilderOptions(), overrides))
    options = chip_smoke.cfg.replace_deep(chip_smoke.cfg.MapBuilderOptions(), overrides)
    port = PoseGraph2D(options.pose_graph, max_scan_range=options.trajectory_builder_2d.max_range, device=cpu)
    port.register_trajectory(0)
    tb = mb.get_trajectory_builder(mb.add_trajectory_builder())
    jpg = mb.pose_graph
    scans = chip_smoke.slam2d_scans()
    anchor = scans[0][1]
    truth = {round(t * 10): anchor.inverse().compose(pose).t[:2] for t, pose, _, _ in scans}
    submaps, first = {}, {}
    jax_add_node = jpg.add_node

    def inter(pg):
        return {(c.submap_index, c.node_index): c.zbar for c in pg.constraints if c.tag == "INTER"}

    def add_node(node, insertion_submaps, newly_finished=()):
        before = max((float(np.abs(a.global_pose.t - b.global_pose.t).max()) for a, b in zip(jpg.nodes, port.nodes)),
                     default=0.0)
        out = jax_add_node(node, insertion_submaps, newly_finished)
        fed = []
        for s in insertion_submaps:  # one port submap object a JAX submap, its grid brought up to date
            new = convert.submap_2d(s, cpu)
            fed.append(submaps.setdefault(id(s), new))
            if fed[-1] is not new:
                fed[-1].__dict__.update(new.__dict__)
        port.add_node(convert.pg_node(node, cpu), fed, [submaps[id(s)] for s in newly_finished if id(s) in submaps])
        if not first:
            j, p = inter(jpg), inter(port)
            for key in sorted(set(j) | set(p), key=lambda k: (k[1], k[0])):
                if key in j and key in p and np.abs(j[key].t - p[key].t).max() <= 1e-3:
                    continue
                t_node = truth[round(jpg.nodes[key[1]].time * 10)]
                err = lambda z: None if z is None else float(np.linalg.norm(
                    jpg.submaps[key[0]].submap.local_pose.compose(NpRigid3(z.t, z.q)).t[:2] - t_node))
                first.update(node=key[1], submap=key[0], node_pose_difference_before=before,
                             jax_zbar_error=err(j.get(key)), port_zbar_error=err(p.get(key)))
                break
        return out

    jpg.add_node = add_node
    for t, _, odom, cloud in scans:
        tb.add_odometry_data(t, NpRigid3(odom.t, odom.q))
        port.add_odometry_data(0, t, odom)
        tb.add_range_data(TimedPointCloudData(
            time=scan_time(t), origin=jnp.zeros(3, jnp.float32),
            ranges=TimedPointCloud(positions=cloud.positions, times=cloud.times, mask=cloud.mask)))
    j, p = inter(jpg), inter(port)
    common = [k for k in j if k in p]
    dz = np.array([np.abs(j[k].t - p[k].t).max() for k in common])
    snapshot = ([(n.local_pose, n.global_pose) for n in jpg.nodes], [s.global_pose for s in jpg.submaps],
                [(c.submap_index, c.node_index, c.zbar, c.translation_weight, c.rotation_weight, c.tag)
                 for c in jpg.constraints])
    jax_result, port_result = chip_smoke.slam2d_result(jpg, scans), chip_smoke.slam2d_result(port, scans)
    rigid = lambda r: PortRigid3(r.t, r.q)
    for n, (local, glob) in zip(port.nodes, snapshot[0]):
        n.local_pose, n.global_pose = rigid(local), rigid(glob)
    for s, glob in zip(port.submaps, snapshot[1]):
        s.global_pose = rigid(glob)
    port.constraints = [PortConstraint(si, ni, rigid(z), tw, rw, tag) for si, ni, z, tw, rw, tag in snapshot[2]]
    replay = chip_smoke.slam2d_result(port, scans)
    return dict(jax=jax_result, port_back_end=port_result, inter_only_jax=len(set(j) - set(p)),
                inter_only_port=len(set(p) - set(j)), inter_zbar_difference_median=float(np.median(dz)),
                inter_zbar_difference_max=float(dz.max()), first_difference=first, replay=replay,
                replay_node_difference=max(float(np.abs(a.global_pose.t - b.global_pose.t).max())
                                           for a, b in zip(jpg.nodes, port.nodes)))


def cli_reference(kind: str, runs: int) -> None:
    """The JAX CLI over chip_smoke.py's phase 26a bag ("drz") or 26b
    sequence directory ("seq2d"), written with the JAX package's writers:
    one JSON line a run with the files' sha256, the ATE and the seconds."""
    from hectorgrapher_tpu.evaluation.scan_generator import raycast_box_room_3d
    from hectorgrapher_tpu.io import readers, rosbag
    from hectorgrapher_tpu.tools.cli import main as cli_main

    with tempfile.TemporaryDirectory() as tmp:
        if kind == "drz":
            path = os.path.join(tmp, "drz26.bag")
            sha = chip_smoke.write_drz26_bag(path, rosbag, raycast_box_room_3d)
            argv = chip_smoke.drz26_argv(path)
        else:
            path = os.path.join(tmp, "seq26")
            sha = chip_smoke.write_seq26_dir(path, readers.write_ply)
            argv = chip_smoke.seq26_argv(path)
        for _ in range(runs):
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = cli_main(argv)
            text = out.getvalue()
            print(json.dumps(dict(kind=kind, sha256=sha, rc=rc, ate=chip_smoke.cli_ate(text),
                                  counts=text.split("nodes:")[1].splitlines()[0].strip() if "nodes:" in text else "",
                                  seconds=time.perf_counter() - t0)), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batched", action="store_true", help="the batched constraint search (phase 12)")
    parser.add_argument("--probability", action="store_true",
                        help="the default PROBABILITY_GRID submaps in place of TSDF (with --batched, phase 13)")
    parser.add_argument("--storage", choices=("float32", "float16", "bfloat16", "uint16"), default=None,
                        help="the submaps' grid_storage_dtype (3D: float16 with --batched, phase 14; with "
                             "--slam-2d: uint16, phase 22a; with --front-end-2d: any, phase 22b)")
    parser.add_argument("--grid-type", choices=("PROBABILITY_GRID", "TSDF"), default=None,
                        help="with --slam-2d or --front-end-2d: the 2D submaps' grid_type")
    parser.add_argument("--front-end-2d", action="store_true",
                        help="chip_smoke.py's phase 6 instead (with --grid-type TSDF, phase 22b): the 2D front end "
                             "over 60 scans")
    parser.add_argument("--runs", type=int, default=2)
    parser.add_argument("--ct-drift", action="store_true",
                        help="the CT front end's drift on either grid type instead (ROADMAP C15)")
    parser.add_argument("--per-scan", action="store_true",
                        help="with --ct-drift: chip_smoke's CT drive with per-scan residuals (phase 9)")
    parser.add_argument("--per-point", action="store_true",
                        help="with --ct-drift: chip_smoke's CT drive with per-point unwarping (phase 17)")
    parser.add_argument("--direct", action="store_true",
                        help="with --ct-drift --per-point: and the DIRECT IMU cost term (phase 18)")
    parser.add_argument("--scans", type=int, default=None,
                        help="with --per-point: scans of the drive (phase 17's CT_SCANS, phase 18's CT18_SCANS)")
    parser.add_argument("--serve", action="store_true",
                        help="chip_smoke.py's phase 23 drives instead: each trajectory's CT front-end errors")
    parser.add_argument("--slam-2d", action="store_true",
                        help="chip_smoke.py's phase 20 instead: MapBuilder 2D over two laps of the circle")
    parser.add_argument("--port", action="store_true",
                        help="with --slam-2d: the port's MapBuilder on the CPU instead of the JAX package's")
    parser.add_argument("--sync", action="store_true", help="with --slam-2d: the async work queue off")
    parser.add_argument("--back-end", action="store_true",
                        help="with --slam-2d: the port's PoseGraph2D fed the JAX front end's nodes (run_slam_2d_back_end)")
    parser.add_argument("--classic-3d", action="store_true",
                        help="chip_smoke.py's phase 25 instead: the classic 3D builder's errors")
    parser.add_argument("--correlative", action="store_true",
                        help="with --classic-3d: the online correlative search on (phase 25b)")
    parser.add_argument("--grids", type=int, nargs=2, default=None, metavar=("HIGH", "LOW"),
                        help="with --classic-3d: the high and low grid sizes")
    parser.add_argument("--drz-bag", action="store_true",
                        help="chip_smoke.py's phase 26a instead: the JAX CLI over the DRZ-shaped bag")
    parser.add_argument("--sequence-2d", action="store_true",
                        help="chip_smoke.py's phase 26b instead: the JAX CLI over the 2D sequence directory")
    opts = parser.parse_args()
    if opts.drz_bag or opts.sequence_2d:
        cli_reference("drz" if opts.drz_bag else "seq2d", opts.runs)
        return 0
    if opts.classic_3d:
        print(json.dumps(classic_3d_errors(opts.correlative, opts.grids)), flush=True)
        return 0
    if opts.serve:
        serve_errors()
        return 0
    if opts.slam_2d and opts.back_end:
        print(json.dumps(dict(run_slam_2d_back_end(), slam_2d=True, back_end=True)), flush=True)
        return 0
    if opts.front_end_2d:
        print(json.dumps(front_end_2d_errors(opts.grid_type, opts.storage)), flush=True)
        return 0
    if opts.slam_2d:
        for _ in range(opts.runs):
            if opts.port:
                out = run_slam_2d_port(opts.sync)
            else:
                out = run_slam_2d(opts.sync, opts.grid_type, opts.storage)
            print(json.dumps(dict(out, slam_2d=True, port=opts.port, sync=opts.sync, grid_type=opts.grid_type,
                                  storage=opts.storage)), flush=True)
        return 0
    if opts.ct_drift and (opts.per_scan or opts.per_point or opts.direct):
        n = opts.scans or (chip_smoke.CT18_SCANS if opts.direct else chip_smoke.CT_SCANS)
        print(json.dumps(ct_front_end_errors(opts.per_point, opts.direct, n)), flush=True)
        return 0
    if opts.ct_drift:
        ct_drift()
        return 0
    for _ in range(opts.runs):
        print(json.dumps(dict(run(opts.batched, opts.probability, opts.storage), batched=opts.batched,
                              probability=opts.probability, storage=opts.storage)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
