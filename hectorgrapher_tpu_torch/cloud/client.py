"""Location-transparent client stubs for the mapping server (counterpart
of hectorgrapher_tpu/cloud/client.py; host and gRPC only).

(ref: cartographer/cloud/client/map_builder_stub.h:30 +
internal/client/{pose_graph_stub,trajectory_builder_stub}.h — the stubs
implement the same interfaces as the local MapBuilder so callers cannot
tell local from remote.)
"""

from __future__ import annotations

from typing import Dict, List

import grpc
import numpy as np

from hectorgrapher_tpu_torch.cloud import wire
from hectorgrapher_tpu_torch.cloud.server import CHANNEL_OPTIONS, SERVICE
from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3


class _Channel:
    def __init__(self, address: str):
        self._channel = grpc.insecure_channel(address, options=CHANNEL_OPTIONS)

    def call(self, method: str, request: dict):
        callable_ = self._channel.unary_unary(
            f"/{SERVICE}/{method}",
            request_serializer=wire.dumps,
            response_deserializer=wire.loads,
        )
        return callable_(request)

    def call_stream(self, method: str, request: dict):
        """Server-streaming call; returns an iterator of responses."""
        callable_ = self._channel.unary_stream(
            f"/{SERVICE}/{method}",
            request_serializer=wire.dumps,
            response_deserializer=wire.loads,
        )
        return callable_(request)

    def close(self):
        self._channel.close()


class TrajectoryBuilderStub:
    """(ref: internal/client/trajectory_builder_stub.h)"""

    def __init__(self, channel: _Channel, trajectory_id: int):
        self._channel = channel
        self.trajectory_id = trajectory_id

    def add_range_data(self, data) -> None:
        self._channel.call(
            "AddSensorData",
            {"trajectory_id": self.trajectory_id, "kind": "range", "payload": data},
        )

    def add_imu_data(self, time, linear_acceleration, angular_velocity) -> None:
        self._channel.call(
            "AddSensorData",
            {
                "trajectory_id": self.trajectory_id,
                "kind": "imu",
                "payload": (time, np.asarray(linear_acceleration), np.asarray(angular_velocity)),
            },
        )

    def add_odometry_data(self, time, pose: NpRigid3) -> None:
        self._channel.call(
            "AddSensorData",
            {"trajectory_id": self.trajectory_id, "kind": "odometry", "payload": (time, pose)},
        )

    def add_fixed_frame_pose_data(self, time, pose: NpRigid3) -> None:
        """(ref: map_builder_service.proto AddFixedFramePoseData +
        add_fixed_frame_pose_data_handler.cc — GPS-like global poses)"""
        self._channel.call(
            "AddSensorData",
            {"trajectory_id": self.trajectory_id, "kind": "fixed_frame", "payload": (time, pose)},
        )

    def add_landmark_data(
        self, time, landmark_id: str, landmark_to_tracking: NpRigid3,
        translation_weight: float, rotation_weight: float,
    ) -> None:
        """(ref: map_builder_service.proto AddLandmarkData +
        add_landmark_data_handler.cc)"""
        self._channel.call(
            "AddSensorData",
            {
                "trajectory_id": self.trajectory_id,
                "kind": "landmark",
                "payload": (time, landmark_id, landmark_to_tracking,
                            translation_weight, rotation_weight),
            },
        )


class PoseGraphStub:
    """(ref: internal/client/pose_graph_stub.h)"""

    def __init__(self, channel: _Channel):
        self._channel = channel

    def local_to_global(self, trajectory_id: int) -> NpRigid3:
        r = self._channel.call("GetLocalToGlobalTransform", {"trajectory_id": trajectory_id})
        return NpRigid3(r["translation"], r["rotation"])

    def get_trajectory_node_poses(self) -> List[dict]:
        return self._channel.call("GetTrajectoryNodePoses", {})["poses"]

    def get_constraints(self) -> List[dict]:
        return self._channel.call("GetConstraints", {})["constraints"]

    def run_final_optimization(self) -> None:
        self._channel.call("RunFinalOptimization", {})

    def get_all_submap_poses(self) -> List[dict]:
        """(ref: pose_graph_stub GetAllSubmapPoses)"""
        return self._channel.call("GetAllSubmapPoses", {})["submap_poses"]

    def trajectory_states(self) -> Dict[int, str]:
        """(ref: pose_graph_stub GetTrajectoryStates)"""
        return self._channel.call("GetTrajectoryStates", {})["trajectory_states"]

    def landmark_poses(self) -> Dict[str, NpRigid3]:
        """(ref: pose_graph_stub GetLandmarkPoses)"""
        r = self._channel.call("GetLandmarkPoses", {})["landmark_poses"]
        return {name: NpRigid3(p["translation"], p["rotation"]) for name, p in r.items()}

    def set_landmark_pose(self, landmark_id: str, pose: NpRigid3) -> None:
        """(ref: pose_graph_stub SetLandmarkPose)"""
        self._channel.call(
            "SetLandmarkPose",
            {"landmark_id": landmark_id, "translation": pose.t, "rotation": pose.q},
        )

    def is_trajectory_finished(self, trajectory_id: int) -> bool:
        return self._channel.call("IsTrajectoryFinished", {"trajectory_id": trajectory_id})[
            "is_finished"
        ]

    def is_trajectory_frozen(self, trajectory_id: int) -> bool:
        return self._channel.call("IsTrajectoryFrozen", {"trajectory_id": trajectory_id})[
            "is_frozen"
        ]


class MapBuilderStub:
    """(ref: client/map_builder_stub.h — same facade as MapBuilder)"""

    def __init__(self, address: str):
        self._channel = _Channel(address)
        self.pose_graph = PoseGraphStub(self._channel)
        self._builders: Dict[int, TrajectoryBuilderStub] = {}

    def add_trajectory_builder(self) -> int:
        trajectory_id = self._channel.call("AddTrajectory", {})["trajectory_id"]
        self._builders[trajectory_id] = TrajectoryBuilderStub(self._channel, trajectory_id)
        return trajectory_id

    def get_trajectory_builder(self, trajectory_id: int) -> TrajectoryBuilderStub:
        return self._builders[trajectory_id]

    def finish_trajectory(self, trajectory_id: int) -> None:
        self._channel.call("FinishTrajectory", {"trajectory_id": trajectory_id})

    def get_local_slam_results(self, trajectory_id: int):
        return self._channel.call("GetLocalSlamResults", {"trajectory_id": trajectory_id})["results"]

    def receive_local_slam_results(self, trajectory_id: int):
        """Live subscription: yields {"time", "local_pose"} dicts as local
        SLAM produces them; the stream ends when the trajectory finishes
        (ref: map_builder_stub + ReceiveLocalSlamResults streaming RPC)."""
        return self._channel.call_stream(
            "ReceiveLocalSlamResults", {"trajectory_id": trajectory_id}
        )

    def delete_trajectory(self, trajectory_id: int) -> None:
        """(ref: map_builder_stub DeleteTrajectory)"""
        self._channel.call("DeleteTrajectory", {"trajectory_id": trajectory_id})
        self._builders.pop(trajectory_id, None)

    def get_submap(self, submap_index: int) -> dict:
        """(ref: map_builder_stub SubmapToProto / GetSubmap — the submap's
        global pose + grid payload; use cloud.local_slam_result._unpack_grid
        to reconstruct grid objects)."""
        return self._channel.call("GetSubmap", {"submap_index": submap_index})

    def receive_global_slam_optimizations(self):
        """Streams {"num_optimizations"} after each optimization round
        (ref: ReceiveGlobalSlamOptimizations streaming RPC)."""
        return self._channel.call_stream("ReceiveGlobalSlamOptimizations", {})

    def write_state(self, filename: str) -> None:
        self._channel.call("WriteState", {"filename": filename})

    def load_state(self, filename: str, load_frozen_state: bool = True) -> dict:
        return self._channel.call(
            "LoadState", {"filename": filename, "load_frozen_state": load_frozen_state}
        )["trajectory_remapping"]

    def close(self) -> None:
        self._channel.close()
