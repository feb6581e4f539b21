"""MapBuilder (counterpart of hectorgrapher_tpu/mapping/map_builder.py;
ref: cartographer/mapping/map_builder.cc and
internal/global_trajectory_builder.cc).

With use_trajectory_builder_3d, MapBuilder wires each trajectory's
OptimizingLocalTrajectoryBuilder to one PoseGraph3D on `device`; without
it (the default options) each trajectory's LocalTrajectoryBuilder2D to one
PoseGraph2D. TrajectoryBuilder feeds every inserted scan to the graph as a
node, and routes odometry (and in 3D IMU) to both. An uplink trajectory
(add_trajectory_builder(local_slam_results=True), :119-195 there) has no
local builder: UplinkTrajectoryBuilder injects the serving server's
uploaded local SLAM results into the graph, its submaps rebuilt on
`device` by cloud/local_slam_result.py's SubmapController.
"""

from __future__ import annotations

from typing import List

import torch

from hectorgrapher_tpu_torch import convert
from hectorgrapher_tpu_torch.mapping.ct.builder import OptimizingLocalTrajectoryBuilder
from hectorgrapher_tpu_torch.mapping.local_2d import LocalTrajectoryBuilder2D
from hectorgrapher_tpu_torch.mapping.pose_graph.pose_graph import PgNode, PoseGraph2D, PoseGraph3D
from hectorgrapher_tpu_torch.sensor.types import TimedPointCloudData
from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3


def _newly_finished(submaps) -> list:
    """The submaps that finished since the pose graph last saw them; the
    reported state lives on the submap itself."""
    out = []
    for submap in submaps:
        if submap.insertion_finished and not getattr(submap, "_finish_reported", False):
            submap._finish_reported = True
            out.append(submap)
    return out


class TrajectoryBuilder:
    """Feeds local SLAM results into the pose graph (ref:
    global_trajectory_builder.cc:34-138). use_3d says which pipeline the
    local builder and the pose graph belong to."""

    def __init__(self, trajectory_id: int, local_builder, pose_graph, use_3d: bool, callback=None):
        self.trajectory_id = trajectory_id
        self._local = local_builder
        self._pose_graph = pose_graph
        self._use_3d = use_3d
        self._callback = callback

    def add_range_data(self, data: TimedPointCloudData):
        result = self._local.add_range_data(data)
        if result is None:
            return result
        ir = result.insertion_result
        if ir is not None:
            if self._use_3d:
                clouds = dict(high_cloud=ir.high_resolution_cloud, low_cloud=ir.low_resolution_cloud,
                              histogram=ir.rotational_histogram)
            else:
                clouds = dict(cloud=ir.filtered_gravity_aligned_point_cloud)
            node = PgNode(
                time=result.time,
                local_pose=result.local_pose,
                global_pose=NpRigid3.identity(),
                trajectory_id=self.trajectory_id,
                gravity_alignment=ir.gravity_alignment,
                **clouds,
            )
            self._pose_graph.add_node(node, ir.insertion_submaps, _newly_finished(ir.insertion_submaps))
        # The local-SLAM callback sees every result, motion-filtered ones
        # included (global_trajectory_builder.cc).
        if self._callback is not None:
            self._callback(self.trajectory_id, result)
        return result

    def add_imu_data(self, time: float, linear_acceleration, angular_velocity) -> None:
        """To local SLAM and, in 3D, the pose graph (ref:
        AddSensorData(ImuData)); PoseGraph2D takes no IMU."""
        self._local.add_imu_data(time, linear_acceleration, angular_velocity)
        if self._use_3d:
            self._pose_graph.add_imu_data(self.trajectory_id, time, linear_acceleration, angular_velocity)

    def add_odometry_data(self, time: float, pose: NpRigid3) -> None:
        """To local SLAM and the pose graph (ref: AddSensorData(OdometryData))."""
        self._local.add_odometry_data(time, pose)
        self._pose_graph.add_odometry_data(self.trajectory_id, time, pose)

    def add_fixed_frame_pose_data(self, time: float, pose: NpRigid3) -> None:
        self._pose_graph.add_fixed_frame_pose_data(self.trajectory_id, time, pose)

    def add_landmark_data(self, time, landmark_id, landmark_to_tracking, translation_weight, rotation_weight) -> None:
        self._pose_graph.add_landmark_data(self.trajectory_id, time, landmark_id, landmark_to_tracking,
                                           translation_weight, rotation_weight)


class UplinkTrajectoryBuilder:
    """A trajectory builder without local SLAM: injects uploaded
    LocalSlamResultPayloads straight into the pose graph (ref:
    global_trajectory_builder.cc AddLocalSlamResultData:118-123; the
    submaps are re-instantiated as in local_slam_result_2d.cc
    AddToPoseGraph:30-52, through SubmapController on `device`)."""

    def __init__(self, trajectory_id: int, pose_graph, use_3d: bool, callback=None, device="cuda"):
        # Imported here, as the JAX package does, so that the mapping layer
        # does not load the serving layer.
        from hectorgrapher_tpu_torch.cloud.local_slam_result import SubmapController

        self.trajectory_id = trajectory_id
        self._pose_graph = pose_graph
        self._use_3d = use_3d
        self._callback = callback
        self._device = torch.device(device)
        self._controller = SubmapController(self._device)
        self.num_results_injected = 0

    def add_range_data(self, data):
        raise ValueError("uplink trajectories accept LocalSlamResultPayloads, not raw range data "
                         "(ref: global_trajectory_builder.cc:119 CHECK)")

    def add_local_slam_result(self, payload) -> None:
        """(ref: local_slam_result_2d.cc AddToPoseGraph:30-52)"""
        submaps = [self._controller.update_submap(self.trajectory_id, sp) for sp in payload.submaps]
        if not submaps:
            return  # ref: "Ignoring node"
        cloud = lambda c: None if c is None else convert.point_cloud(c, self._device)
        node = PgNode(
            time=payload.time,
            local_pose=NpRigid3(payload.local_pose_t, payload.local_pose_q),
            global_pose=NpRigid3.identity(),
            trajectory_id=self.trajectory_id,
            cloud=cloud(payload.cloud),
            high_cloud=cloud(payload.high_cloud),
            low_cloud=cloud(payload.low_cloud),
            histogram=payload.histogram,
            gravity_alignment=payload.gravity_alignment,
        )
        self._pose_graph.add_node(node, submaps, _newly_finished(submaps))
        self.num_results_injected += 1
        if self._callback is not None:
            self._callback(self.trajectory_id, payload)

    def add_imu_data(self, time: float, linear_acceleration, angular_velocity) -> None:
        if self._use_3d:
            self._pose_graph.add_imu_data(self.trajectory_id, time, linear_acceleration, angular_velocity)

    def add_odometry_data(self, time: float, pose: NpRigid3) -> None:
        self._pose_graph.add_odometry_data(self.trajectory_id, time, pose)

    def add_fixed_frame_pose_data(self, time: float, pose: NpRigid3) -> None:
        self._pose_graph.add_fixed_frame_pose_data(self.trajectory_id, time, pose)

    def add_landmark_data(self, time, landmark_id, landmark_to_tracking, translation_weight, rotation_weight) -> None:
        self._pose_graph.add_landmark_data(self.trajectory_id, time, landmark_id, landmark_to_tracking,
                                           translation_weight, rotation_weight)


class MapBuilder:
    """(ref: map_builder.cc MapBuilder)"""

    def __init__(self, options, device="cuda"):
        """options: MapBuilderOptions; use_trajectory_builder_3d picks the
        3D pipeline, else the 2D one. Runs on the card unless `device` says
        otherwise; without one it raises."""
        self._options = options
        self._device = torch.device(device)
        self._trajectory_builders: List[TrajectoryBuilder] = []
        if options.use_trajectory_builder_3d:
            self.pose_graph = PoseGraph3D(
                options.pose_graph,
                histogram_size=options.trajectory_builder_3d.rotational_histogram_size,
                max_scan_range=options.trajectory_builder_3d.submaps.high_resolution_max_range,
                device=self._device,
            )
        else:
            self.pose_graph = PoseGraph2D(options.pose_graph, max_scan_range=options.trajectory_builder_2d.max_range,
                                          device=self._device)

    def add_trajectory_builder(self, callback=None, local_slam_results: bool = False) -> int:
        """(ref: map_builder.cc AddTrajectoryBuilder:120-177; with
        local_slam_results, the uplink federation case, no local builder
        is made and results are injected, map_builder.cc:126-133.)"""
        trajectory_id = len(self._trajectory_builders)
        use_3d = self._options.use_trajectory_builder_3d
        if local_slam_results:
            builder = UplinkTrajectoryBuilder(trajectory_id, self.pose_graph, use_3d, callback, self._device)
        else:
            if use_3d:
                local = OptimizingLocalTrajectoryBuilder(self._options.trajectory_builder_3d, self._device)
            else:
                local = LocalTrajectoryBuilder2D(self._options.trajectory_builder_2d, self._device)
            builder = TrajectoryBuilder(trajectory_id, local, self.pose_graph, use_3d, callback)
        self._trajectory_builders.append(builder)
        self.pose_graph.register_trajectory(trajectory_id)
        return trajectory_id

    def get_trajectory_builder(self, trajectory_id: int) -> TrajectoryBuilder:
        return self._trajectory_builders[trajectory_id]

    def finish_trajectory(self, trajectory_id: int) -> None:
        """(ref: map_builder.cc FinishTrajectory, after the work queue drains)"""
        self.pose_graph.wait_for_all_computations()
        self.pose_graph.finish_trajectory(trajectory_id)

    def delete_trajectory(self, trajectory_id: int) -> None:
        """(ref: map_builder_interface.h DeleteTrajectory)"""
        self.pose_graph.delete_trajectory(trajectory_id)
        if 0 <= trajectory_id < len(self._trajectory_builders):
            self._trajectory_builders[trajectory_id] = None  # keep ids stable

    def num_trajectory_builders(self) -> int:
        return len(self._trajectory_builders)
