"""MapBuilder (counterpart of hectorgrapher_tpu/mapping/map_builder.py
:34-116 and :198-254; ref: cartographer/mapping/map_builder.cc and
internal/global_trajectory_builder.cc).

With use_trajectory_builder_3d, MapBuilder wires each trajectory's
OptimizingLocalTrajectoryBuilder to one PoseGraph3D on `device`; without
it (the default options) each trajectory's LocalTrajectoryBuilder2D to one
PoseGraph2D. TrajectoryBuilder feeds every inserted scan to the graph as a
node, and routes odometry (and in 3D IMU) to both. Uplink trajectories
(LOCAL_SLAM_RESULT data) are not ported and raise NotImplementedError.
"""

from __future__ import annotations

from typing import List

import torch

from hectorgrapher_tpu_torch.mapping.ct.builder import OptimizingLocalTrajectoryBuilder
from hectorgrapher_tpu_torch.mapping.local_2d import LocalTrajectoryBuilder2D
from hectorgrapher_tpu_torch.mapping.pose_graph.pose_graph import PgNode, PoseGraph2D, PoseGraph3D
from hectorgrapher_tpu_torch.sensor.types import TimedPointCloudData
from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3


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
            newly_finished = []
            for submap in ir.insertion_submaps:
                # The reported state lives on the submap itself.
                if submap.insertion_finished and not getattr(submap, "_finish_reported", False):
                    submap._finish_reported = True
                    newly_finished.append(submap)
            self._pose_graph.add_node(node, ir.insertion_submaps, newly_finished)
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
        """(ref: map_builder.cc AddTrajectoryBuilder:120-177)"""
        if local_slam_results:
            raise NotImplementedError("uplink trajectories (LOCAL_SLAM_RESULT data) are not ported")
        trajectory_id = len(self._trajectory_builders)
        if self._options.use_trajectory_builder_3d:
            local = OptimizingLocalTrajectoryBuilder(self._options.trajectory_builder_3d, self._device)
        else:
            local = LocalTrajectoryBuilder2D(self._options.trajectory_builder_2d, self._device)
        self._trajectory_builders.append(
            TrajectoryBuilder(trajectory_id, local, self.pose_graph, self._options.use_trajectory_builder_3d, callback))
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
