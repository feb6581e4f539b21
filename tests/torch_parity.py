"""Shared inputs for the parity tests of hectorgrapher_tpu_torch against
hectorgrapher_tpu (tests/test_torch_*.py).

Inputs are made with numpy from a seed and built once with the JAX
package; convert.py carries them into the port. Everything runs on the
CPU, where the port's kernel wrappers take their plain PyTorch versions.
"""

from __future__ import annotations

import numpy as np
import torch

from hectorgrapher_tpu.common.config import ProbabilityGridRangeDataInserterOptions2D
from hectorgrapher_tpu.evaluation.scan_generator import raycast_rect_room_2d
from hectorgrapher_tpu.mapping.grids import make_probability_grid
from hectorgrapher_tpu.mapping.inserters_2d import make_probability_inserter_2d
from hectorgrapher_tpu.sensor.types import RangeData, pad_cloud

CPU = torch.device("cpu")


def room_grid_and_cloud(size=256, num_rays=720, capacity=1024, inserts=3):
    """A 0.05 m probability grid (JAX) built from `inserts` scans of a
    rectangular room seen from the origin, and that scan as a cloud."""
    import jax.numpy as jnp

    grid = make_probability_grid(0.05, (size, size))
    insert = make_probability_inserter_2d(
        ProbabilityGridRangeDataInserterOptions2D(), max_range=size * 0.05, resolution=0.05
    )
    half = size * 0.05 / 2
    pts = raycast_rect_room_2d(
        np.zeros(2), 0.0, half_width=0.8 * half, half_height=0.66 * half, num_rays=num_rays
    )
    pts = pts[~np.isnan(pts[:, 0])].astype(np.float32)
    cloud = pad_cloud(pts, capacity)
    rd = RangeData(
        origin=jnp.zeros(3, jnp.float32),
        returns=cloud,
        misses=pad_cloud(np.zeros((0, 3), np.float32), 8),
    )
    for _ in range(inserts):
        grid = insert(grid, rd)
    return grid, cloud, float(np.linalg.norm(pts[:, :2], axis=-1).max())


def perturbations(seed, b, lin=0.1, ang=0.05):
    """(B, 2) translations and (B,) angles, f32, uniform in +-lin / +-ang."""
    rng = np.random.default_rng(seed)
    offs = rng.uniform(-lin, lin, (b, 2)).astype(np.float32)
    angs = rng.uniform(-ang, ang, b).astype(np.float32)
    return offs, angs


def bf16_to_torch(x) -> torch.Tensor:
    """A JAX/ml_dtypes bfloat16 array as a torch bfloat16 tensor, bit for bit."""
    return torch.from_numpy(np.asarray(x).view(np.uint16).copy()).view(torch.bfloat16)


def probability_grids_of(hi, lo):
    """Occupancy grids (JAX) of the TSDF pair's shapes and geometry, filled
    by the default 3D occupancy inserters (SubmapsOptions3D) with the
    scan that _build_ct_example inserts into the TSDF pair."""
    import jax.numpy as jnp

    from hectorgrapher_tpu.common.config import SubmapsOptions3D
    from hectorgrapher_tpu.evaluation.scan_generator import raycast_box_room_3d
    from hectorgrapher_tpu.mapping.grids import ProbabilityGrid
    from hectorgrapher_tpu.mapping.inserters_3d import make_probability_inserter_3d
    from hectorgrapher_tpu.transform import np_quat as nq

    pts = raycast_box_room_3d(np.zeros(3), nq.quat_identity(), num_azimuth=128, num_elevation=32)
    pts = pts[~np.isnan(pts[:, 0])]
    rd = RangeData(origin=jnp.zeros(3, jnp.float32), returns=pad_cloud(pts.astype(np.float32), 4096),
                   misses=pad_cloud(np.zeros((0, 3), np.float32), 4))
    sub = SubmapsOptions3D()
    out = []
    for tsdf, ins in ((hi, sub.high_resolution_range_data_inserter), (lo, sub.low_resolution_range_data_inserter)):
        empty = ProbabilityGrid(jnp.zeros(tsdf.tsd.shape, jnp.float32), jnp.zeros(tsdf.tsd.shape, bool), tsdf.meta)
        out.append(make_probability_inserter_3d(ins.probability_grid_range_data_inserter)(empty, rd))
    return tuple(out)


def ct_example(grid=32, lo_filtered=False, grid_type="TSDF"):
    """__graft_entry__._build_ct_example(grid) (JAX: hi, lo, problem,
    state, weights). With lo_filtered, each lo-res cloud is its hi-res
    cloud voxel-filtered at 0.45 m and compacted, as ct/builder.py builds
    it (ROADMAP C4), so the lo-res path sees another point set. With
    grid_type="PROBABILITY_GRID" the grids are occupancy grids of the same
    geometry and scan (probability_grids_of)."""
    import jax.numpy as jnp

    from __graft_entry__ import _build_ct_example
    from hectorgrapher_tpu.sensor.types import PointCloud
    from hectorgrapher_tpu.sensor.voxel_filter import compact_cloud, voxel_filter

    hi, lo, problem, state, weights = _build_ct_example(grid=grid)
    if grid_type == "PROBABILITY_GRID":
        hi, lo = probability_grids_of(hi, lo)
    if lo_filtered:
        p = problem.hi_points.shape[1]
        clouds = [
            compact_cloud(voxel_filter(PointCloud(problem.hi_points[c], problem.hi_mask[c]), 0.45), p)
            for c in range(problem.hi_points.shape[0])
        ]
        problem = problem._replace(
            lo_points=jnp.stack([c.positions for c in clouds]), lo_mask=jnp.stack([c.mask for c in clouds])
        )
    return hi, lo, problem, state, weights


def rotated_state(state, seed, angle=0.05):
    """The CT state with each control point rotated by a seeded random
    angle-axis of up to `angle` rad (the fixture's are all identity)."""
    import jax.numpy as jnp

    from hectorgrapher_tpu.transform.rigid import quat_from_axis_angle, quat_multiply, quat_normalize

    rng = np.random.default_rng(seed)
    aa = rng.uniform(-angle, angle, (state.rotation.shape[0], 3)).astype(np.float32)
    return state._replace(rotation=quat_normalize(quat_multiply(state.rotation, quat_from_axis_angle(jnp.asarray(aa)))))


def direct_payload(k, m=16, seed=3):
    """DIRECT IMU samples for a window of k control points 0.1 s apart, as
    (JAX DirectImuData, the port's): M uniform sub-steps a pair with
    seeded gyro (0.1 rad/s noise) and accelerometer readings (gravity plus
    0.2 m/s^2 noise); the last pair's last sub-steps are padding (dt 0)."""
    import jax.numpy as jnp

    from hectorgrapher_tpu.mapping.ct.window_solver import DirectImuData
    from hectorgrapher_tpu_torch.mapping.ct.window_solver import DirectImuData as TDirectImuData

    rng = np.random.default_rng(seed)
    dt = np.full((k - 1, m), 0.1 / m, np.float32)
    dt[-1, m - 6:] = 0.0
    gyro = rng.normal(0.0, 0.1, (k - 1, m, 3)).astype(np.float32)
    accel = (rng.normal(0.0, 0.2, (k - 1, m, 3)) + [0.0, 0.0, 9.80665]).astype(np.float32)
    jax_direct = DirectImuData(jnp.asarray(dt), jnp.asarray(gyro), jnp.asarray(accel), jnp.asarray(9.80665, jnp.float32))
    port = TDirectImuData(torch.from_numpy(dt), torch.from_numpy(gyro), torch.from_numpy(accel),
                          torch.tensor(9.80665, dtype=torch.float32))
    return jax_direct, port


def organized_room_range_data(seed, pose_t=(0.3, -0.2, 0.1), yaw=0.2, az=96, el=24):
    """One organized scan (el rows of az rays, width az) of the default box
    room with 4 mm range noise, seen from pose_t at `yaw`, as JAX
    RangeData in the room's frame: rays that miss stay in their slot,
    masked out at position 0. Returns (range data, width)."""
    import jax.numpy as jnp

    from hectorgrapher_tpu.evaluation.scan_generator import raycast_box_room_3d
    from hectorgrapher_tpu.sensor.types import PointCloud
    from hectorgrapher_tpu.transform import np_quat as nq

    rng = np.random.default_rng(seed)
    q = nq.quat_from_axis_angle(np.array([0.0, 0.0, yaw]))
    pts = raycast_box_room_3d(np.asarray(pose_t), q, num_azimuth=az, num_elevation=el, noise_std=0.004, rng=rng)
    mask = ~np.isnan(pts[:, 0])
    pts = np.where(mask[:, None], pts + np.asarray(pose_t), 0.0).astype(np.float32)
    rd = RangeData(origin=jnp.asarray(pose_t, jnp.float32), returns=PointCloud(jnp.asarray(pts), jnp.asarray(mask)),
                   misses=pad_cloud(np.zeros((0, 3), np.float32), 8), width=az)
    return rd, az


def wall_range_data(seed, n=24, noise=0.002):
    """An organized n x n scan of a wall patch at x = 1 m over y, z in
    [-0.6, 0.6] m (5 cm apart, `noise` m of noise along x) from the origin,
    as JAX RangeData (width n): planar neighbourhoods, whose smallest
    eigenvector is well defined (a row of a sparse scan is not)."""
    import jax.numpy as jnp

    from hectorgrapher_tpu.sensor.types import PointCloud

    rng = np.random.default_rng(seed)
    ys, zs = np.meshgrid(np.linspace(-0.6, 0.6, n), np.linspace(-0.6, 0.6, n))
    pts = np.stack([1.0 + rng.normal(0.0, noise, ys.size), ys.ravel(), zs.ravel()], axis=-1).astype(np.float32)
    rd = RangeData(origin=jnp.zeros(3, jnp.float32), returns=PointCloud(jnp.asarray(pts), jnp.ones(len(pts), bool)),
                   misses=pad_cloud(np.zeros((0, 3), np.float32), 8), width=n)
    return rd, n


def box_room_scan(seed, pose_t=(0.3, -0.2, 0.1), yaw=0.2, az=96, el=24):
    """The valid points of one raycast_box_room_3d scan (default room) with
    4 mm range noise, seen from pose_t at `yaw`."""
    from hectorgrapher_tpu.evaluation.scan_generator import raycast_box_room_3d
    from hectorgrapher_tpu.transform import np_quat as nq

    rng = np.random.default_rng(seed)
    q = nq.quat_from_axis_angle(np.array([0.0, 0.0, yaw]))
    pts = raycast_box_room_3d(np.asarray(pose_t), q, num_azimuth=az, num_elevation=el, noise_std=0.004, rng=rng)
    return pts[~np.isnan(pts[:, 0])]


def box_room_submap_3d(hi_shape=(80, 72, 32), lo_shape=(20, 18, 8), az=128, el=32,
                       scan_poses=((0.0, 0.0, 0.0), (0.4, 0.3, 0.0), (0.8, -0.3, 0.0)), grid_type="TSDF"):
    """tests/test_pose_graph_3d_integration.py build_finished_submap at
    smaller extents: a finished JAX Submap3D at the origin (hi 0.1 m, lo
    0.45 m TSDF grids) filled by the ray-mode inserter with one scan of the
    asymmetric box room (its scan_at) from each pose, and its histogram.
    With grid_type="PROBABILITY_GRID", occupancy grids of the same
    geometry filled by the default 3D occupancy inserters
    (SubmapsOptions3D)."""
    import jax.numpy as jnp

    from hectorgrapher_tpu.common.config import SubmapsOptions3D, TSDFRangeDataInserterOptions3D
    from hectorgrapher_tpu.mapping.grids import make_probability_grid, make_tsdf_grid
    from hectorgrapher_tpu.mapping.inserters_3d import make_probability_inserter_3d, make_tsdf_inserter_3d
    from hectorgrapher_tpu.mapping.scan_matching.rotational_histogram import compute_histogram
    from hectorgrapher_tpu.mapping.submap_3d import Submap3D
    from hectorgrapher_tpu.transform.np_quat import NpRigid3
    from test_pose_graph_3d_integration import HIST, scan_at

    if grid_type == "TSDF":
        hi = make_tsdf_grid(0.1, hi_shape, truncation_distance=0.3, max_weight=1000.0)
        lo = make_tsdf_grid(0.45, lo_shape, truncation_distance=1.0, max_weight=1000.0)
        opts = TSDFRangeDataInserterOptions3D(normal_computation_method="NONE", min_range=0.4, max_range=30.0)
        ins_hi, ins_lo = make_tsdf_inserter_3d(opts, 0.1), make_tsdf_inserter_3d(opts, 0.45)
    else:
        sub = SubmapsOptions3D()
        hi, lo = make_probability_grid(0.1, hi_shape), make_probability_grid(0.45, lo_shape)
        ins_hi, ins_lo = (make_probability_inserter_3d(o.probability_grid_range_data_inserter) for o in
                          (sub.high_resolution_range_data_inserter, sub.low_resolution_range_data_inserter))
    hist = np.zeros(HIST, np.float32)
    for pose_t in scan_poses:
        pts = scan_at(pose_t, n_az=az, n_el=el) + np.asarray(pose_t, np.float32)
        cloud = pad_cloud(pts, 8192)
        rd = RangeData(origin=jnp.asarray(pose_t, jnp.float32), returns=cloud,
                       misses=pad_cloud(np.zeros((0, 3), np.float32), 4))
        hi, lo = ins_hi(hi, rd), ins_lo(lo, rd)
        hist += np.asarray(compute_histogram(cloud.positions, cloud.mask, HIST))
    return Submap3D(local_pose=NpRigid3(np.zeros(3)), high_resolution_grid=hi, low_resolution_grid=lo,
                    rotational_histogram=hist, num_range_data=len(scan_poses), insertion_finished=True)


def ct_drive(builder, rigid, timed_data, pad, duration=1.5, speed=0.2, yaw_rate=0.1, seed=0):
    """Drive a CT builder (either package's, with its own pose, data and
    padding types) through the tests/test_ct_builder.py scenario: IMU at
    100 Hz, odometry at 20 Hz with 2 mm noise, scans at 10 Hz of 96 x 24
    rays with 4 mm range noise and sweep times over [-0.05, 0.049] s.
    Returns [(time, local pose)] of its results."""
    from hectorgrapher_tpu.evaluation.scan_generator import raycast_box_room_3d
    from hectorgrapher_tpu.transform import np_quat as nq
    from test_ct_builder import GRAVITY, gt_pose

    rng = np.random.default_rng(seed)
    out = []
    t, next_odom, next_scan = 0.0, 0.0, 0.05
    while t <= duration:
        _, q = gt_pose(t, speed, yaw_rate)
        builder.add_imu_data(t, nq.quat_rotate(nq.quat_conjugate(q), GRAVITY), np.array([0.0, 0.0, yaw_rate]))
        if t >= next_odom:
            pt, pq = gt_pose(t, speed, yaw_rate)
            builder.add_odometry_data(t, rigid(pt + rng.normal(0, 0.002, 3), pq))
            next_odom += 0.05
        if t >= next_scan:
            pt, pq = gt_pose(t, speed, yaw_rate)
            pts = raycast_box_room_3d(pt, pq, num_azimuth=96, num_elevation=24, noise_std=0.004, rng=rng)
            pts = pts[~np.isnan(pts[:, 0])]
            times = np.linspace(-0.05, 0.049, len(pts)).astype(np.float32)
            res = builder.add_range_data(timed_data(t, np.zeros(3, np.float32), pad(pts, times, 2560)))
            if res is not None:
                out.append((res.time, res.local_pose))
            next_scan += 0.1
        t = round(t + 0.01, 6)
    return out


def batched_anchors_3d():
    """tests/test_batched_constraint_path.py's two finished anchor submaps
    (96 x 96 x 32 at 0.1 m, 32 x 32 x 12 at 0.45 m; :224-284), built with
    the JAX package."""
    from test_batched_constraint_path import build_finished_submap_3d

    return (build_finished_submap_3d([np.zeros(3), np.array([0.4, 0.3, 0.0])]),
            build_finished_submap_3d([np.array([0.3, -0.3, 0.0]), np.array([0.7, 0.0, 0.0])]))


def batched_probability_anchors_3d(repeats=4):
    """batched_anchors_3d's two anchors with occupancy grids of the same
    geometry, filled from the same scans by the default 3D occupancy
    inserters (SubmapsOptions3D), each scan inserted `repeats` times. A
    finished submap sees its place in 2 * num_range_data scans; two
    insertions leave hit cells at p <= 0.6, and the scene's scores (0.38-0.40)
    under its 0.4 gate, so no constraint would be found."""
    import jax.numpy as jnp

    from hectorgrapher_tpu.common.config import SubmapsOptions3D
    from hectorgrapher_tpu.mapping.grids import make_probability_grid
    from hectorgrapher_tpu.mapping.inserters_3d import make_probability_inserter_3d
    from hectorgrapher_tpu.mapping.scan_matching.rotational_histogram import compute_histogram
    from hectorgrapher_tpu.mapping.submap_3d import Submap3D
    from hectorgrapher_tpu.transform.np_quat import NpRigid3
    from test_batched_constraint_path import HIST, scan_3d

    sub = SubmapsOptions3D()
    ins_hi, ins_lo = (make_probability_inserter_3d(o.probability_grid_range_data_inserter) for o in
                      (sub.high_resolution_range_data_inserter, sub.low_resolution_range_data_inserter))
    anchors = []
    for scan_poses in ([np.zeros(3), np.array([0.4, 0.3, 0.0])], [np.array([0.3, -0.3, 0.0]), np.array([0.7, 0.0, 0.0])]):
        hi, lo = make_probability_grid(0.1, (96, 96, 32)), make_probability_grid(0.45, (32, 32, 12))
        hist = np.zeros(HIST, np.float32)
        for pose_t in scan_poses:
            pts = scan_3d(pose_t, n_az=192, n_el=40) + np.asarray(pose_t, np.float32)
            rd = RangeData(origin=jnp.asarray(pose_t, jnp.float32), returns=pad_cloud(pts, 8192),
                           misses=pad_cloud(np.zeros((0, 3), np.float32), 4))
            for _ in range(repeats):
                hi, lo = ins_hi(hi, rd), ins_lo(lo, rd)
            hist += np.asarray(compute_histogram(rd.returns.positions, rd.returns.mask, HIST))
        anchors.append(Submap3D(local_pose=NpRigid3(np.zeros(3)), high_resolution_grid=hi, low_resolution_grid=lo,
                                rotational_histogram=hist, num_range_data=len(scan_poses), insertion_finished=True))
    return tuple(anchors)


def port_drive_3d(anchors, options, device=CPU):
    """drive_3d of tests/test_batched_constraint_path.py (:287-296) through
    the port's PoseGraph3D with `options` (the JAX package's
    PoseGraphOptions, converted): two drift-free nodes INTRA to the
    anchors, then a returning node 0.3 m off INTRA only to an active
    submap, whose round has both anchors as candidates. The nodes are
    built by the JAX test's node_3d and carried over."""
    from hectorgrapher_tpu_torch import convert
    from hectorgrapher_tpu_torch.mapping.pose_graph.pose_graph import PoseGraph3D
    from test_batched_constraint_path import HIST, active_submap_3d, node_3d

    pg = PoseGraph3D(convert.options(options), histogram_size=HIST, device=device)
    subs = [convert.submap_3d(a, device) for a in (*anchors, active_submap_3d())]
    truth = np.array([0.3, -0.2, 0.0])
    for time, local, true, k in ((0.0, np.zeros(3), np.zeros(3), 0), (0.1, [0.4, 0.3, 0.0], [0.4, 0.3, 0.0], 1),
                                 (0.2, truth + [0.3, 0.0, 0.0], truth, 2)):
        pg.add_node(convert.pg_node(node_3d(time, local, true), device), [subs[k]])
    pg.wait_for_all_computations()
    return pg


def inter_constraints(pg):
    """[(node id, submap id, constraint)] of pg's INTER constraints, sorted."""
    return sorted(((pg.nodes[c.node_index].node_id, pg.submaps[c.submap_index].submap_id, c)
                   for c in pg.constraints if c.tag == "INTER"), key=lambda x: (x[0], x[1]))


def batched_anchors_2d():
    """tests/test_batched_constraint_path.py's two finished 2D anchor
    submaps (256 x 256 at 0.05 m; :85-131), built with the JAX package."""
    from test_batched_constraint_path import build_finished_submap_2d

    return (build_finished_submap_2d([np.zeros(3), np.array([0.4, 0.3, 0.0])]),
            build_finished_submap_2d([np.array([0.3, -0.3, 0.0]), np.array([0.7, 0.0, 0.0])]))


def batched_tsdf_anchor_grids_2d():
    """TSDF grids (JAX) of batched_anchors_2d's two submaps: the same scans
    (256 x 256 at 0.05 m), filled by the default 2D TSDF inserter."""
    import jax.numpy as jnp

    from hectorgrapher_tpu.common.config import TSDFRangeDataInserterOptions2D
    from hectorgrapher_tpu.mapping.grids import make_tsdf_grid
    from hectorgrapher_tpu.mapping.inserters_2d import make_tsdf_inserter_2d
    from test_batched_constraint_path import scan_2d

    opts = TSDFRangeDataInserterOptions2D()
    insert = make_tsdf_inserter_2d(opts, 0.05)
    grids = []
    for poses in ([np.zeros(3), np.array([0.4, 0.3, 0.0])], [np.array([0.3, -0.3, 0.0]), np.array([0.7, 0.0, 0.0])]):
        grid = make_tsdf_grid(0.05, (256, 256), opts.truncation_distance, opts.maximum_weight)
        for pose_t in poses:
            pts = scan_2d(pose_t) + np.asarray(pose_t, np.float32)
            grid = insert(grid, RangeData(origin=jnp.asarray(np.asarray(pose_t, np.float32)),
                                          returns=pad_cloud(pts, 1024),
                                          misses=pad_cloud(np.zeros((0, 3), np.float32), 8)))
        grids.append(grid)
    return grids


def port_drive_2d(anchors, options, device=CPU, pose_graph=None):
    """drive_2d of tests/test_batched_constraint_path.py (:134-149) through
    the port's PoseGraph2D with `options` (the JAX package's
    PoseGraphOptions, converted), or through `pose_graph`: two drift-free
    nodes INTRA to the anchors, then a returning node 0.3 m off INTRA only
    to an active submap, whose round has both anchors as candidates. The
    nodes are built by the JAX test's node_2d and carried over."""
    from hectorgrapher_tpu_torch import convert
    from hectorgrapher_tpu_torch.mapping.pose_graph.pose_graph import PoseGraph2D
    from test_batched_constraint_path import active_submap_2d, node_2d

    pg = pose_graph or PoseGraph2D(convert.options(options), device=device)
    subs = [convert.submap_2d(a, device) for a in (*anchors, active_submap_2d())]
    truth = np.array([0.3, -0.2, 0.0])
    for time, local, true, k in ((0.0, np.zeros(3), np.zeros(3), 0), (0.1, [0.4, 0.3, 0.0], [0.4, 0.3, 0.0], 1),
                                 (0.2, truth + [0.3, 0.0, 0.0], truth, 2)):
        pg.add_node(convert.pg_node(node_2d(time, local, true), device), [subs[k]])
    pg.wait_for_all_computations()
    return pg
