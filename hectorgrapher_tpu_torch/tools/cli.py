"""Command-line tools (counterpart of hectorgrapher_tpu/tools/cli.py).

Replaces the reference's binaries (SURVEY.md section 2.11):
  * state info/migrate/convert (ref: io/pbstream_main.cc)
  * print-configuration       (ref: common/print_configuration_main.cc)
  * autogenerate-ground-truth (ref: ground_truth/autogenerate_ground_truth_main.cc)
  * ground-truth-from-mocap   (ref: ground_truth/generate_ground_truth_from_mocap_main.cc)
  * compute-relations-metrics (ref: ground_truth/compute_relations_metrics_main.cc)
  * scan-matching-evaluation  (ref: evaluation/scan_matching_evaluation.cc)
  * mapping-evaluation, trajectory-builder-evaluation (ref: evaluation/)
  * paint-map                 (ref: io/submap_painter.cc, io/draw_trajectories.cc)
  * map-builder-server        (ref: cloud/map_builder_server_main.cc)

Usage: python -m hectorgrapher_tpu_torch.tools.cli [--device cuda|cpu] <subcommand> [args].

Every subcommand runs its tensors and builders on --device: the card
unless the caller asks for the CPU. Without a card and without --device
cpu, the first kernel a subcommand needs raises instead of falling back.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _overrides(items):
    """--override / --config_overrides items, dotted.key=json_value, as a dict."""
    kv = {}
    for item in items or ():
        key, _, value = item.partition("=")
        kv[key] = json.loads(value)
    return kv


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _relations_to_proto(relations, covered_distance: float = 0.0):
    """evaluation Relation (seconds) -> pbstream Relation (universal ticks)."""
    from hectorgrapher_tpu_torch.common.time import to_universal
    from hectorgrapher_tpu_torch.io import pbstream

    return [
        pbstream.Relation(
            timestamp1=to_universal(r.time1),
            timestamp2=to_universal(r.time2),
            expected=r.expected,
            covered_distance=covered_distance,
        )
        for r in relations
    ]


def _relations_from_proto(pb_relations):
    from hectorgrapher_tpu_torch.common.time import from_universal
    from hectorgrapher_tpu_torch.evaluation.metrics import Relation

    return [
        Relation(time1=from_universal(r.timestamp1), time2=from_universal(r.timestamp2), expected=r.expected)
        for r in pb_relations
    ]


def _write_relations(path: str, relations, fmt: str) -> None:
    if fmt == "proto":
        from hectorgrapher_tpu_torch.io import pbstream

        pbstream.write_ground_truth(path, _relations_to_proto(relations))
    else:
        from hectorgrapher_tpu_torch.evaluation.relations_text_file import write_relations_text_file

        write_relations_text_file(path, relations)


def _read_relations(path: str):
    """Read relations in either the TORO-style text format or the
    reference's binary GroundTruth proto (sniffed)."""
    try:
        from hectorgrapher_tpu_torch.evaluation.relations_text_file import read_relations_text_file

        return read_relations_text_file(path)
    except (UnicodeDecodeError, ValueError):
        from hectorgrapher_tpu_torch.io import pbstream

        return _relations_from_proto(pbstream.read_ground_truth(path))


def _npz_index(path: str) -> dict:
    with np.load(path, allow_pickle=False) as data:
        return json.loads(bytes(data["__index__"]).decode())


def cmd_state_info(args) -> int:
    """(ref: pbstream_main.cc `info`)"""
    if args.state.endswith(".pbstream"):
        from hectorgrapher_tpu_torch.io import pbstream

        state = pbstream.read_state(args.state)
        print(f"format version: {state.format_version}")
        print(f"record counts: {dict(sorted(state.record_counts.items()))}")
        print(f"nodes (pose graph): {len(state.nodes)}")
        print(f"submaps (pose graph): {len(state.submap_poses)}")
        print(f"constraints: {len(state.constraints)}")
        inter = sum(1 for c in state.constraints if c.tag == "INTER_SUBMAP")
        print(f"  inter (loop closure): {inter}")
        if state.landmark_poses:
            print(f"landmarks: {sorted(state.landmark_poses)}")
        return 0
    index = _npz_index(args.state)
    trajectories = sorted(
        {e["trajectory_id"] for e in index["nodes"]} | {e["trajectory_id"] for e in index["submaps"]}
    )
    print(f"format version: {index['version']}")
    print(f"dimension: {index['dim']}D")
    print(f"nodes: {len(index['nodes'])}")
    print(f"submaps: {len(index['submaps'])}")
    print(f"constraints: {len(index['constraints'])}")
    inter = sum(1 for c in index["constraints"] if c["tag"] == "INTER")
    print(f"  inter (loop closure): {inter}")
    print(f"trajectories: {trajectories}")
    for t in trajectories:
        state = index["trajectory_states"].get(str(t), "?")
        n = sum(1 for e in index["nodes"] if e["trajectory_id"] == t)
        print(f"  trajectory {t}: {n} nodes, state {state}")
    return 0


def cmd_print_configuration(args) -> int:
    """(ref: print_configuration_main.cc — resolved options dump; flags
    --configuration_directories/--configuration_basename/--subdictionary
    mirror print_configuration_main.cc:27-34)"""
    from hectorgrapher_tpu_torch.common import config as cfg

    options = cfg.MapBuilderOptions()
    if args.configuration_basename:
        from hectorgrapher_tpu_torch.common import lua_config

        dirs = [d for d in (args.configuration_directories or "").split(",") if d]
        loaded = lua_config.load_map_builder_options(
            args.configuration_basename, dirs, strict=not args.non_strict
        )
        options = loaded.map_builder
    if args.override:
        options = cfg.replace_deep(options, _overrides(args.override))
    tree = cfg.to_dict(options)
    if args.subdictionary:
        for part in args.subdictionary.strip(".").split("."):
            tree = tree[part]
    print(json.dumps(tree, indent=2, default=str))
    return 0


def cmd_state_migrate(args) -> int:
    """(ref: pbstream_main.cc `migrate`:40-43 +
    serialization_format_migration.cc — v1 states lack 3D submap
    rotational histograms; recompute them from node histograms.)"""
    from hectorgrapher_tpu_torch.io.serialization import migrate_state_v1_to_v2

    migrated = migrate_state_v1_to_v2(args.state, args.output)
    print(f"migrated to version 2 ({migrated} submap histograms recomputed): {args.output}")
    return 0


def _pose_graph(dim: int, device):
    """An empty pose graph of the state's dimensionality, at the default
    options, on `device`."""
    from hectorgrapher_tpu_torch.common.config import MapBuilderOptions
    from hectorgrapher_tpu_torch.mapping.pose_graph.pose_graph import PoseGraph2D, PoseGraph3D

    cls = PoseGraph3D if dim == 3 else PoseGraph2D
    return cls(MapBuilderOptions().pose_graph, device=device)


def _load_pose_graph_from_state(path: str, device):
    """Instantiate the right-dimensional pose graph for an npz state file
    and load it (the header records dim; ref:
    io/proto_stream_deserializer.cc reads the header before dispatching)."""
    from hectorgrapher_tpu_torch.io.serialization import load_state

    pg = _pose_graph(3 if _npz_index(path).get("dim") == 3 else 2, device)
    load_state(pg, path, load_frozen_state=False)
    return pg


def cmd_autogenerate_ground_truth(args) -> int:
    fmt = args.format or ("proto" if args.output.endswith(".pb") else "text")
    kwargs = dict(
        min_covered_distance=args.min_covered_distance,
        outlier_threshold_meters=args.outlier_threshold_meters,
        outlier_threshold_radians=args.outlier_threshold_radians,
    )
    if args.state.endswith(".pbstream"):
        # Reference-produced optimized state: relations straight from the
        # decoded pose graph proto (ref: autogenerate_ground_truth_main.cc:77).
        from hectorgrapher_tpu_torch.evaluation.metrics import autogenerate_relations_from_pbstream_state
        from hectorgrapher_tpu_torch.io import pbstream

        relations = autogenerate_relations_from_pbstream_state(pbstream.read_state(args.state), **kwargs)
    else:
        from hectorgrapher_tpu_torch.evaluation.metrics import autogenerate_relations_from_pose_graph

        relations = autogenerate_relations_from_pose_graph(
            _load_pose_graph_from_state(args.state, args.device), **kwargs)
    _write_relations(args.output, relations, fmt)
    print(f"wrote {len(relations)} relations to {args.output} ({fmt})")
    return 0


def cmd_state_convert(args) -> int:
    """Convert between the .npz state container and the reference's full
    .pbstream (submap grids, node data, pose graph — ref:
    io/internal/mapping_state_serialization.cc, io/pbstream_main.cc)."""
    from hectorgrapher_tpu_torch.io.pbstream_state import load_pbstream_state, sniff_dim, write_pbstream_state
    from hectorgrapher_tpu_torch.io.serialization import save_state

    if args.input.endswith(".pbstream"):
        pg = _pose_graph(sniff_dim(args.input), args.device)
        load_pbstream_state(pg, args.input, load_frozen_state=False)
    else:
        pg = _load_pose_graph_from_state(args.input, args.device)
    if args.output.endswith(".pbstream"):
        write_pbstream_state(pg, args.output)
    else:
        save_state(pg, args.output)
    print(
        f"converted {args.input} -> {args.output} "
        f"({len(pg.nodes)} nodes, {len(pg.submaps)} submaps, "
        f"{len(pg.constraints)} constraints)"
    )
    return 0


def cmd_paint_map(args) -> int:
    """Render a serialized state to a PNG: composited submaps + stroked
    trajectories (ref: io/submap_painter.cc PaintSubmapSlices +
    io/draw_trajectories.cc DrawTrajectory)."""
    from hectorgrapher_tpu_torch.io.drawing import paint_pose_graph
    from hectorgrapher_tpu_torch.io.image import write_png

    pg = _load_pose_graph_from_state(args.state, args.device)
    rgb = paint_pose_graph(pg, resolution=args.resolution, include_unfinished=not args.finished_only)
    write_png(args.output, rgb)
    print(
        f"wrote {args.output} ({rgb.shape[1]}x{rgb.shape[0]} px at "
        f"{args.resolution} m/px, {len(pg.submaps)} submaps, {len(pg.nodes)} nodes)"
    )
    return 0


def cmd_ground_truth_from_mocap(args) -> int:
    """(ref: generate_ground_truth_from_mocap_main.cc:33-43 — CSV columns
    time,x,y,z,qw,qx,qy,qz; relations every pose_time_delta.)"""
    from hectorgrapher_tpu_torch.evaluation.metrics import relations_from_ground_truth
    from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3

    rows = np.loadtxt(args.csv, delimiter=",", skiprows=args.skip_rows)
    times = rows[:, 0]
    poses = [NpRigid3(r[1:4], r[4:8]) for r in rows]
    relations = relations_from_ground_truth(times, poses, args.pose_time_delta)
    fmt = args.format or ("proto" if args.output.endswith(".pb") else "text")
    _write_relations(args.output, relations, fmt)
    print(f"wrote {len(relations)} relations to {args.output} ({fmt})")
    return 0


def cmd_compute_relations_metrics(args) -> int:
    from hectorgrapher_tpu_torch.evaluation.metrics import TrajectoryInterpolator, compute_relation_metrics
    from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3

    relations = _read_relations(args.relations)
    if args.state.endswith(".pbstream"):
        from hectorgrapher_tpu_torch.common.time import from_universal
        from hectorgrapher_tpu_torch.io import pbstream

        nodes = sorted(pbstream.read_state(args.state).nodes, key=lambda n: n.timestamp)
        times = [from_universal(n.timestamp) for n in nodes]
        poses = [n.pose for n in nodes]
    else:
        with np.load(args.state, allow_pickle=False) as data:
            index = json.loads(bytes(data["__index__"]).decode())
            times = [e["time"] for e in index["nodes"]]
            poses = [
                NpRigid3(data[f"node{i}_global"][:3], data[f"node{i}_global"][3:7])
                for i in range(len(index["nodes"]))
            ]
    metrics = compute_relation_metrics(TrajectoryInterpolator(times, poses), relations)
    print(metrics)
    return 0


def cmd_scan_matching_evaluation(args) -> int:
    """(ref: evaluation/scan_matching_evaluation.cc — synthetic scans,
    matcher benchmarking with perturbed initial poses.)"""
    import time as _time

    import torch

    from hectorgrapher_tpu_torch.common.config import ProbabilityGridRangeDataInserterOptions2D
    from hectorgrapher_tpu_torch.evaluation.scan_generator import raycast_rect_room_2d
    from hectorgrapher_tpu_torch.mapping.grids import make_probability_grid
    from hectorgrapher_tpu_torch.mapping.inserters_2d import make_probability_inserter_2d
    from hectorgrapher_tpu_torch.mapping.scan_matching.correlative_2d import make_search_window, match_correlative_2d
    from hectorgrapher_tpu_torch.mapping.scan_matching.gn_2d import match_gn_2d_probability
    from hectorgrapher_tpu_torch.sensor.types import RangeData, pad_cloud
    from hectorgrapher_tpu_torch.transform.rigid import Rigid2

    device = args.device
    rng = np.random.default_rng(args.seed)
    grid = make_probability_grid(0.05, (512, 512), device)
    insert = make_probability_inserter_2d(
        ProbabilityGridRangeDataInserterOptions2D(), max_range=12.8, resolution=0.05
    )
    pts = raycast_rect_room_2d(np.zeros(2), 0.0, num_rays=1440)
    pts = pts[~np.isnan(pts[:, 0])]
    cloud = pad_cloud(pts.astype(np.float32), 2048, device)
    grid = insert(
        grid,
        RangeData(origin=torch.zeros(3, dtype=torch.float32, device=device), returns=cloud,
                  misses=pad_cloud(np.zeros((0, 3), np.float32), 8, device)),
    )
    window = make_search_window(0.3, np.radians(20.0), 0.05, 12.0)

    errors, times = [], []
    for _ in range(args.num_trials):
        offset = rng.uniform(-0.2, 0.2, 2)
        angle = rng.uniform(-0.15, 0.15)
        initial = Rigid2(
            translation=torch.as_tensor(offset, dtype=torch.float32, device=device),
            angle=torch.as_tensor(angle, dtype=torch.float32, device=device),
        )
        t0 = _time.perf_counter()
        _, coarse = match_correlative_2d(grid, cloud, initial, window, 0.1, 0.1)
        # Free refinement: the reference's evaluation zeroes the delta
        # penalties so the matcher itself is measured, not the anchor
        # (ref: evaluation/scan_matching_evaluation.cc:390-392
        # translation_weight = 0., rotation_weight = 0.).
        pose, _ = match_gn_2d_probability(
            grid, cloud, coarse, coarse.translation, 1.0, 0.0, 0.0, num_iterations=10
        )
        _sync(device)
        times.append(_time.perf_counter() - t0)
        errors.append(float(torch.linalg.norm(pose.translation)))
    print(f"trials: {args.num_trials}")
    print(f"mean translation error: {np.mean(errors):.4f} m (max {np.max(errors):.4f})")
    warm = times[1:] if len(times) > 1 else times  # single trial: no warm-up split
    print(f"mean match time: {np.mean(warm) * 1e3:.2f} ms")
    return 0


def _mocap_path(sequence_dir: str) -> str:
    """Where a sequence's ground truth sits: beside a bag (<seq>.bag +
    <seq>.mocap.csv, or mocap.csv in its directory), or mocap.csv in a
    sequence directory."""
    if sequence_dir.endswith(".bag"):
        sidecar = sequence_dir[: -len(".bag")] + ".mocap.csv"
        if os.path.exists(sidecar):
            return sidecar
        return os.path.join(os.path.dirname(sequence_dir) or ".", "mocap.csv")
    return os.path.join(sequence_dir, "mocap.csv")


def _run_sequence_evaluation(args) -> int:
    """File-driven evaluation over a recorded sequence directory or ROS bag
    (ref: evaluation/mapping_evaluation.cc:38-268 — consumes point-cloud
    files + sensor streams; ground truth from a mocap CSV like
    generate_ground_truth_from_mocap_main.cc). Directory layout:
    *.ply|*.pcd|*.xyz scans (timestamp in filename) + optional imu.csv,
    odometry.csv, mocap.csv."""
    from hectorgrapher_tpu_torch.common import config as cfg
    from hectorgrapher_tpu_torch.evaluation.metrics import (
        TrajectoryInterpolator,
        ate_rmse,
        compute_relation_metrics,
        relations_from_ground_truth,
    )
    from hectorgrapher_tpu_torch.io import readers
    from hectorgrapher_tpu_torch.mapping.map_builder import MapBuilder
    from hectorgrapher_tpu_torch.sensor.types import TimedPointCloudData, pad_timed_cloud

    if args.sequence_dir.endswith(".bag"):
        # DRZ sequences ship as ROS bags; decode PointCloud2/Imu/Odometry
        # into the same stream.
        from hectorgrapher_tpu_torch.io import rosbag

        events = rosbag.read_bag_sequence(args.sequence_dir)
    else:
        events = readers.read_sequence_dir(args.sequence_dir)
    n_range = sum(1 for e in events if e.kind == "range")
    if n_range == 0:
        print(f"no point-cloud files found in {args.sequence_dir}")
        return 1
    max_points = max(len(e.payload) for e in events if e.kind == "range")
    capacity = 1 << max(int(np.ceil(np.log2(max(max_points, 256)))), 8)

    overrides = {"use_trajectory_builder_3d": args.use_3d, "use_trajectory_builder_2d": not args.use_3d}
    if not args.use_3d:
        overrides.update({
            "trajectory_builder_2d.use_imu_data": False,
            "trajectory_builder_2d.use_online_correlative_scan_matching": True,
            "trajectory_builder_2d.max_num_points": capacity,
        })
    options = cfg.replace_deep(cfg.MapBuilderOptions(), overrides)
    if args.config_overrides:
        options = cfg.replace_deep(options, _overrides(args.config_overrides))
    mb = MapBuilder(options, device=args.device)
    tb = mb.get_trajectory_builder(mb.add_trajectory_builder())
    for e in events:
        if e.kind == "imu":
            tb.add_imu_data(e.time, e.payload[0], e.payload[1])
        elif e.kind == "odometry":
            tb.add_odometry_data(e.time, e.payload)
        else:
            pts = e.payload
            # Per-point relative times (DRZ lidar bags) drive the CT
            # builder's unwarping; sources without them are instantaneous.
            times = e.times if e.times is not None else np.zeros(len(pts), np.float32)
            cloud = pad_timed_cloud(pts, np.asarray(times, np.float32), capacity)
            tb.add_range_data(TimedPointCloudData(time=e.time, origin=np.zeros(3, np.float32), ranges=cloud))
    pg = mb.pose_graph
    mb.finish_trajectory(0)
    pg.run_final_optimization()
    est_times = [n.time for n in pg.nodes]
    est_poses = [n.global_pose for n in pg.nodes]
    print(f"nodes: {len(pg.nodes)}  submaps: {len(pg.submaps)}  constraints: {len(pg.constraints)}")
    if not est_poses:
        return 1
    mocap = _mocap_path(args.sequence_dir)
    if os.path.exists(mocap):
        gt = readers.read_mocap_csv(mocap)
        gt_times = [t for t, _ in gt]
        gt_poses = [p for _, p in gt]
        rmse = ate_rmse(est_times, est_poses, gt_times, gt_poses, align=not args.no_align)
        relations = relations_from_ground_truth(gt_times, gt_poses, 0.5)
        metrics = compute_relation_metrics(TrajectoryInterpolator(est_times, est_poses), relations)
        print(f"ATE RMSE: {rmse:.4f} m")
        print(metrics)
    else:
        print("no mocap.csv ground truth; trajectory only")
    if args.output_state:
        from hectorgrapher_tpu_torch.io.serialization import save_state

        save_state(pg, args.output_state)
        print(f"state written to {args.output_state}")
    return 0


# The synthetic 3D drives' options (mapping-evaluation --use_3d and
# trajectory-builder-evaluation), as in the JAX CLI.
_SYNTHETIC_3D_OVERRIDES = {
    "use_trajectory_builder_3d": True,
    "trajectory_builder_3d.min_range": 0.4,
    "trajectory_builder_3d.submaps.grid_type": "TSDF",
    "trajectory_builder_3d.submaps.high_grid_size": 96,
    "trajectory_builder_3d.submaps.low_grid_size": 48,
    "trajectory_builder_3d.optimizing_local_trajectory_builder.initialization_duration": 0.45,
    "trajectory_builder_3d.optimizing_local_trajectory_builder.max_control_points": 12,
    "trajectory_builder_3d.optimizing_local_trajectory_builder.max_clouds_in_window": 12,
    "trajectory_builder_3d.optimizing_local_trajectory_builder.points_per_cloud": 256,
}
_GRAVITY = np.array([0.0, 0.0, 9.80665])


def cmd_mapping_evaluation(args) -> int:
    """(ref: evaluation/mapping_evaluation.cc + trajectory_builder_
    evaluation.cc — end-to-end SLAM over synthetic data with relation/ATE
    metrics.) Runs the 2D or 3D pipeline on a synthetic scene — or a
    recorded sequence directory or bag with --sequence_dir — and prints
    ATE RMSE + relation metrics against ground truth."""
    if args.sequence_dir:
        return _run_sequence_evaluation(args)
    from hectorgrapher_tpu_torch.common import config as cfg
    from hectorgrapher_tpu_torch.evaluation.metrics import (
        TrajectoryInterpolator,
        ate_rmse,
        compute_relation_metrics,
        relations_from_ground_truth,
    )
    from hectorgrapher_tpu_torch.evaluation.scan_generator import raycast_box_room_3d, raycast_rect_room_2d
    from hectorgrapher_tpu_torch.mapping.map_builder import MapBuilder
    from hectorgrapher_tpu_torch.sensor.types import TimedPointCloudData, pad_timed_cloud
    from hectorgrapher_tpu_torch.transform import np_quat as nq
    from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3

    rng = np.random.default_rng(args.seed)
    gt_times, gt_poses = [], []

    if args.use_3d:
        mb = MapBuilder(cfg.replace_deep(cfg.MapBuilderOptions(), _SYNTHETIC_3D_OVERRIDES), device=args.device)
        tb = mb.get_trajectory_builder(mb.add_trajectory_builder())
        speed, rest = 0.2, 0.6
        t, next_odom, next_scan = 0.0, 0.0, 0.05
        while t <= args.duration:
            x = speed * max(0.0, t - rest)
            q = nq.quat_identity()
            tb.add_imu_data(t, _GRAVITY.copy(), np.zeros(3))
            if t >= next_odom:
                tb.add_odometry_data(t, NpRigid3(np.array([x, 0, 0]) + rng.normal(0, 0.002, 3), q))
                next_odom += 0.05
            if t >= next_scan:
                pts = raycast_box_room_3d(np.array([x, 0, 0]), q, num_azimuth=96, num_elevation=24,
                                          noise_std=args.noise, rng=rng if args.noise else None)
                pts = pts[~np.isnan(pts[:, 0])]
                cloud = pad_timed_cloud(pts, np.zeros(len(pts), np.float32), 2560)
                tb.add_range_data(TimedPointCloudData(time=t, origin=np.zeros(3, np.float32),
                                                      ranges=cloud, width=96))
                gt_times.append(t)
                gt_poses.append(NpRigid3(np.array([x, 0.0, 0.0]), q))
                next_scan += 0.1
            t = round(t + 0.01, 6)
    else:
        options = cfg.replace_deep(
            cfg.MapBuilderOptions(),
            {
                "use_trajectory_builder_2d": True,
                "trajectory_builder_2d.use_imu_data": False,
                "trajectory_builder_2d.use_online_correlative_scan_matching": True,
                "trajectory_builder_2d.submaps.grid_size": 640,
                "trajectory_builder_2d.submaps.num_range_data": 12,
                "trajectory_builder_2d.max_num_points": 2048,
                "trajectory_builder_2d.motion_filter.max_distance_meters": 0.05,
                "trajectory_builder_2d.motion_filter.max_time_seconds": 0.1,
                "pose_graph.optimize_every_n_nodes": 10,
                "pose_graph.constraint_builder.sampling_ratio": 1.0,
            },
        )
        mb = MapBuilder(options, device=args.device)
        tb = mb.get_trajectory_builder(mb.add_trajectory_builder())
        n = int(args.duration / 0.1)
        radius, center = 1.4, (0.6, 0.5)
        for i in range(n):
            t = 0.1 * i
            a = 2 * np.pi * i / max(n - 1, 1)
            xy = np.array([center[0] + radius * np.cos(a), center[1] + radius * np.sin(a)])
            yaw = a + np.pi / 2
            pose = NpRigid3(np.array([xy[0], xy[1], 0.0]), nq.quat_from_axis_angle(np.array([0.0, 0.0, yaw])))
            tb.add_odometry_data(t, NpRigid3(pose.t + rng.normal(0, 0.003, 3), pose.q))
            pts = raycast_rect_room_2d(xy, yaw, num_rays=1440, noise_std=args.noise, rng=rng)
            pts = pts[~np.isnan(pts[:, 0])]
            cloud = pad_timed_cloud(pts.astype(np.float32), np.zeros(len(pts), np.float32), 2048)
            tb.add_range_data(TimedPointCloudData(time=t, origin=np.zeros(3, np.float32), ranges=cloud))
            gt_times.append(t)
            gt_poses.append(pose)

    pg = mb.pose_graph
    pg.run_final_optimization()
    est_times = [node.time for node in pg.nodes]
    est_poses = [node.global_pose for node in pg.nodes]
    if not est_poses:
        print("no nodes produced")
        return 1
    # Express ground truth relative to the first ground-truth pose (the
    # SLAM frame anchor).
    anchor = None
    for tt, p in zip(gt_times, gt_poses):
        if abs(tt - est_times[0]) < 0.26:
            anchor = p
            break
    anchor = anchor or gt_poses[0]
    gt_rel = [anchor.inverse().compose(p) for p in gt_poses]
    rmse = ate_rmse(est_times, est_poses, gt_times, gt_rel, align=not args.no_align)
    relations = relations_from_ground_truth(gt_times, gt_rel, 0.5)
    metrics = compute_relation_metrics(TrajectoryInterpolator(est_times, est_poses), relations)
    print(f"nodes: {len(pg.nodes)}  submaps: {len(pg.submaps)}  constraints: {len(pg.constraints)}")
    print(f"ATE RMSE: {rmse:.4f} m")
    print(metrics)
    return 0


def cmd_trajectory_builder_evaluation(args) -> int:
    """Classic discrete-time LTB3D vs the continuous-time optimizing
    builder on the same synthetic 3D drive — per-builder pose error and
    wall time (ref: evaluation/trajectory_builder_evaluation.cc:346, the
    comparison of the two 3D front-ends)."""
    import time as _time

    from hectorgrapher_tpu_torch.common import config as cfg
    from hectorgrapher_tpu_torch.evaluation.scan_generator import raycast_box_room_3d
    from hectorgrapher_tpu_torch.mapping.ct.builder import OptimizingLocalTrajectoryBuilder
    from hectorgrapher_tpu_torch.mapping.local_3d import LocalTrajectoryBuilder3D
    from hectorgrapher_tpu_torch.sensor.types import TimedPointCloudData, pad_timed_cloud
    from hectorgrapher_tpu_torch.transform import np_quat as nq
    from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3

    options = cfg.replace_deep(cfg.MapBuilderOptions(), _SYNTHETIC_3D_OVERRIDES).trajectory_builder_3d
    speed, rest = 0.2, 0.6

    def drive(builder, label):
        rng_local = np.random.default_rng(args.seed)
        errors = []
        t0_wall = _time.perf_counter()
        t, next_odom, next_scan = 0.0, 0.0, 0.05
        n_results = 0
        while t <= args.duration:
            x = speed * max(0.0, t - rest)
            q = nq.quat_identity()
            builder.add_imu_data(t, _GRAVITY.copy(), np.zeros(3))
            if t >= next_odom:
                builder.add_odometry_data(t, NpRigid3(np.array([x, 0, 0]) + rng_local.normal(0, 0.002, 3), q))
                next_odom += 0.05
            if t >= next_scan:
                pts = raycast_box_room_3d(
                    np.array([x, 0, 0]), q, num_azimuth=96, num_elevation=24,
                    noise_std=args.noise, rng=rng_local if args.noise else None,
                )
                pts = pts[~np.isnan(pts[:, 0])]
                cloud = pad_timed_cloud(pts, np.zeros(len(pts), np.float32), 2560)
                result = builder.add_range_data(
                    TimedPointCloudData(time=t, origin=np.zeros(3, np.float32), ranges=cloud, width=96)
                )
                if result is not None:
                    gt_x = speed * max(0.0, result.time - rest)
                    errors.append(float(np.linalg.norm(result.local_pose.t - np.array([gt_x, 0, 0]))))
                    n_results += 1
                next_scan += 0.1
            t = round(t + 0.01, 6)
        wall = _time.perf_counter() - t0_wall
        max_err = max(errors) if errors else float("nan")
        print(
            f"{label}: results {n_results}  max pose error {max_err:.4f} m  "
            f"final error {errors[-1] if errors else float('nan'):.4f} m  wall {wall:.1f} s"
        )
        return max_err

    drive(OptimizingLocalTrajectoryBuilder(options, args.device), "continuous-time (flagship)")
    drive(LocalTrajectoryBuilder3D(options, args.device), "classic discrete-time")
    return 0


def _local_devices(device, n: int):
    """The first n devices of `device`'s type, as JAX's local_devices()[:n]:
    the visible cards (at most n), or n shards on the CPU (the port's Mesh
    takes a device more than once)."""
    import torch

    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(min(n, torch.cuda.device_count()))]
    return [device] * n


def cmd_map_builder_server(args) -> int:
    """(ref: cloud/map_builder_server_main.cc)"""
    import time as _time

    from hectorgrapher_tpu_torch.cloud.server import MapBuilderServer
    from hectorgrapher_tpu_torch.common import config as cfg
    from hectorgrapher_tpu_torch.mapping.map_builder import MapBuilder

    if args.configuration_basename:
        # (ref: map_builder_server_main.cc:28-34 — -configuration_directory
        # + -configuration_basename load the Lua options.)
        from hectorgrapher_tpu_torch.common.lua_config import load_map_builder_options

        dirs = args.configuration_directory or [
            os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configuration_files")
        ]
        options = load_map_builder_options(args.configuration_basename, dirs).map_builder
    else:
        options = cfg.replace_deep(
            cfg.MapBuilderOptions(),
            {"use_trajectory_builder_2d": not args.use_3d, "use_trajectory_builder_3d": args.use_3d},
        )
    if args.config_overrides:
        options = cfg.replace_deep(options, _overrides(args.config_overrides))

    # Multi-process solver plane: every participating process joins one
    # torch.distributed group. Process 0 runs the gRPC sensor edge + pose
    # graph and broadcasts each sharded solve; the other processes run
    # solver-plane followers executing the same work so that the
    # collectives complete.
    mesh = None
    solver_leader = None
    if args.multihost_coordinator:
        from hectorgrapher_tpu_torch.parallel.multihost import global_mesh, initialize_process

        initialize_process(args.multihost_coordinator, args.multihost_num_processes, args.multihost_process_id,
                           device=args.device)
        mesh = global_mesh()
        print(f"multihost mesh: {mesh.size} devices across {args.multihost_num_processes} processes", flush=True)
        if args.multihost_process_id != 0:
            from hectorgrapher_tpu_torch.cloud.solver_plane import SolverPlaneFollower

            follower = SolverPlaneFollower(args.solver_plane_address, mesh=mesh).start()
            print(f"solver-plane follower listening on port {follower.port}", flush=True)
            follower.wait_for_shutdown()
            _leave_process_group()
            return 0
        if args.follower_addresses:
            from hectorgrapher_tpu_torch.cloud.solver_plane import SolverPlaneLeader

            solver_leader = SolverPlaneLeader(args.follower_addresses.split(","))

    # Batched CT serving (cloud/ct_batcher.py): ready windows across
    # trajectories solve as one launch; with --ct_mesh_devices N > 1 the
    # batch is additionally sharded over the first N local devices.
    ct_mesh = None
    if args.batch_ct_windows and args.ct_mesh_devices > 1:
        from hectorgrapher_tpu_torch.parallel.mesh import Mesh

        ct_mesh = Mesh(_local_devices(args.device, args.ct_mesh_devices))
        print(f"ct mesh: {len(ct_mesh.devices)} devices", flush=True)
    server = MapBuilderServer(
        MapBuilder(options, device=args.device),
        args.address,
        batch_ct_windows=args.batch_ct_windows,
        ct_mesh=ct_mesh,
    )
    if mesh is not None:
        server.map_builder.pose_graph.set_solver_mesh(mesh, broadcast=solver_leader)
    server.start()
    print(f"map builder server listening on port {server.port}", flush=True)
    exporter = None
    if args.monitoring_port >= 0:
        # (ref: map_builder_server_main.cc:40-46 — prometheus::Exposer on
        # the monitoring port, global registry registered with it.)
        from hectorgrapher_tpu_torch.metrics.http_exporter import MetricsExporter

        exporter = MetricsExporter(port=args.monitoring_port).start()
        print(f"prometheus metrics on http://127.0.0.1:{exporter.port}/metrics", flush=True)
    try:
        while True:
            _time.sleep(1.0)
    except KeyboardInterrupt:
        server.shutdown()
        if exporter is not None:
            exporter.shutdown()
        if solver_leader is not None:
            solver_leader.shutdown()
        if mesh is not None:
            _leave_process_group()
    return 0


def _leave_process_group() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="hectorgrapher_tpu_torch", description=__doc__)
    parser.add_argument("--device", default="cuda",
                        help="torch device every subcommand runs on (default: the card; cpu for the tests)")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("state-info", help="inspect a serialized state file (.npz or reference .pbstream)")
    p.add_argument("state")
    p.set_defaults(fn=cmd_state_info)

    p = sub.add_parser("state-migrate", help="migrate a v1 state file to the current version")
    p.add_argument("state")
    p.add_argument("output")
    p.set_defaults(fn=cmd_state_migrate)

    p = sub.add_parser(
        "state-convert",
        help="convert a state file between .npz and the reference's full .pbstream",
    )
    p.add_argument("input")
    p.add_argument("output")
    p.set_defaults(fn=cmd_state_convert)

    p = sub.add_parser("print-configuration", help="dump resolved options")
    p.add_argument("--override", action="append", help="dotted.key=json_value")
    p.add_argument(
        "--configuration_directories",
        default="",
        help="comma-separated dirs searched for Lua config files (first match wins)",
    )
    p.add_argument("--configuration_basename", default="", help="Lua file to load, e.g. map_builder.lua")
    p.add_argument("--subdictionary", default="", help="dotted path to print only a sub-tree")
    p.add_argument(
        "--non_strict",
        action="store_true",
        help="drop Lua keys this build deliberately does not carry instead of raising",
    )
    p.set_defaults(fn=cmd_print_configuration)

    p = sub.add_parser("autogenerate-ground-truth")
    p.add_argument("state")
    p.add_argument("output")
    p.add_argument("--min_covered_distance", type=float, default=100.0)
    p.add_argument("--outlier_threshold_meters", type=float, default=0.15)
    p.add_argument("--outlier_threshold_radians", type=float, default=0.02)
    p.add_argument("--format", choices=["text", "proto"], default=None,
                   help="relations output format (default: proto for .pb outputs, else text)")
    p.set_defaults(fn=cmd_autogenerate_ground_truth)

    p = sub.add_parser("ground-truth-from-mocap")
    p.add_argument("csv")
    p.add_argument("output")
    p.add_argument("--pose_time_delta", type=float, default=0.1)
    p.add_argument("--skip_rows", type=int, default=0)
    p.add_argument("--format", choices=["text", "proto"], default=None)
    p.set_defaults(fn=cmd_ground_truth_from_mocap)

    p = sub.add_parser("compute-relations-metrics")
    p.add_argument("state")
    p.add_argument("relations")
    p.set_defaults(fn=cmd_compute_relations_metrics)

    p = sub.add_parser("scan-matching-evaluation")
    p.add_argument("--num_trials", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_scan_matching_evaluation)

    p = sub.add_parser("mapping-evaluation", help="end-to-end synthetic SLAM evaluation")
    p.add_argument("--use_3d", action="store_true")
    p.add_argument("--duration", type=float, default=3.6)
    p.add_argument("--noise", type=float, default=0.004)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no_align", action="store_true")
    p.add_argument("--sequence_dir", default="",
                   help="recorded sequence directory (*.ply/*.pcd/*.xyz + imu.csv/odometry.csv/mocap.csv) "
                        "or a ROS bag (.bag, ground truth in <name>.mocap.csv beside it)")
    p.add_argument("--config_overrides", action="append", help="dotted.key=json_value")
    p.add_argument("--output_state", default="", help="write the final state to this .npz")
    p.set_defaults(fn=cmd_mapping_evaluation)

    p = sub.add_parser("trajectory-builder-evaluation",
                       help="classic vs continuous-time 3D front-end comparison")
    p.add_argument("--duration", type=float, default=2.4)
    p.add_argument("--noise", type=float, default=0.004)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_trajectory_builder_evaluation)

    p = sub.add_parser("paint-map", help="render a state file to a PNG map image")
    p.add_argument("state")
    p.add_argument("output")
    p.add_argument("--resolution", type=float, default=0.05, help="meters per pixel")
    p.add_argument("--finished_only", action="store_true", help="skip unfinished submaps")
    p.set_defaults(fn=cmd_paint_map)

    p = sub.add_parser("map-builder-server")
    p.add_argument("--address", default="127.0.0.1:50051")
    p.add_argument("--use_3d", action="store_true")
    p.add_argument(
        "--batch_ct_windows",
        action="store_true",
        help="solve ready CT windows across trajectories as one batched "
        "launch (cloud/ct_batcher.py; 3D trajectories only)",
    )
    p.add_argument(
        "--ct_mesh_devices",
        type=int,
        default=1,
        help="shard batched CT window solves over this many local devices",
    )
    p.add_argument(
        "--monitoring_port",
        type=int,
        default=9100,
        help="prometheus /metrics port (ref: map_builder_server_main.cc:40); -1 disables",
    )
    p.add_argument(
        "--configuration_basename",
        default="",
        help="Lua config file, e.g. map_builder_server.lua "
        "(ref: map_builder_server_main.cc -configuration_basename)",
    )
    p.add_argument(
        "--configuration_directory",
        action="append",
        help="Lua include directories (default: the packaged configuration_files/)",
    )
    p.add_argument(
        "--config_overrides",
        action="append",
        help="dotted-key=json overrides applied after the Lua config",
    )
    p.add_argument("--multihost_coordinator", default="",
                   help="host:port of process 0's torch.distributed rendezvous; empty: one process, no group")
    p.add_argument("--multihost_num_processes", type=int, default=1)
    p.add_argument("--multihost_process_id", type=int, default=0)
    p.add_argument("--solver_plane_address", default="127.0.0.1:0",
                   help="where a follower process (--multihost_process_id > 0) serves the solver plane")
    p.add_argument("--follower_addresses", default="",
                   help="comma-separated solver-plane addresses of the followers (process 0 only)")
    p.set_defaults(fn=cmd_map_builder_server)
    return parser


def main(argv=None) -> int:
    import torch

    args = build_parser().parse_args(argv)
    args.device = torch.device(args.device)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
