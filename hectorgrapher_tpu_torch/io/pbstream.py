"""`.pbstream` interop: read/write the reference's proto stream container
and decode the state messages needed for ground-truth tooling (a
host-only copy of hectorgrapher_tpu/io/pbstream.py).

Container format (ref: io/proto_stream.cc:25-96): 8-byte little-endian
magic 0x7b1d1f7b5bf501db, then length-prefixed gzip-compressed serialized
protos. Record sequence for state files (ref:
io/internal/mapping_state_serialization.cc): SerializationHeader, then
SerializedData records (PoseGraph, options, submaps, nodes, ...).

This module gives the evaluation/ground-truth pipeline interop with
reference-produced artifacts WITHOUT protoc: enough of the pose graph
(constraints, trajectory node poses) decodes to run
autogenerate-ground-truth on a reference pbstream, and GroundTruth
relation files round-trip bit-compatibly with
compute_relations_metrics_main.cc:205-207.
"""

from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

import numpy as np

from hectorgrapher_tpu_torch.io import protowire as pw
from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3

MAGIC = 0x7B1D1F7B5BF501DB

# SerializedData oneof field numbers (ref: mapping/proto/serialization.proto)
SERIALIZED_DATA_KINDS = {
    1: "pose_graph",
    2: "all_trajectory_builder_options",
    3: "submap",
    4: "node",
    5: "trajectory_data",
    6: "imu_data",
    7: "odometry_data",
    8: "fixed_frame_pose_data",
    9: "landmark_data",
}


# -- container ------------------------------------------------------------------


def read_records(path: str) -> Iterator[bytes]:
    """Yield decompressed records (ref: ProtoStreamReader::Read)."""
    with open(path, "rb") as f:
        magic = struct.unpack("<Q", f.read(8))[0]
        if magic != MAGIC:
            raise ValueError(f"{path}: not a pbstream (magic {magic:#x})")
        while True:
            size_bytes = f.read(8)
            if len(size_bytes) < 8:
                return
            (size,) = struct.unpack("<Q", size_bytes)
            compressed = f.read(size)
            if len(compressed) < size:
                raise ValueError(f"{path}: truncated record")
            yield gzip.decompress(compressed)


def write_records(path: str, records: List[bytes]) -> None:
    """(ref: ProtoStreamWriter::Write — gzip each record, length-prefix)"""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", MAGIC))
        for record in records:
            compressed = gzip.compress(record)
            f.write(struct.pack("<Q", len(compressed)))
            f.write(compressed)


# -- decoded state views ----------------------------------------------------------


@dataclass
class PbNodePose:
    trajectory_id: int
    node_index: int
    timestamp: int  # universal 100ns ticks (ref: common/time.h)
    pose: NpRigid3  # tracking -> global map


@dataclass
class PbConstraint:
    submap_trajectory_id: int
    submap_index: int
    node_trajectory_id: int
    node_index: int
    relative_pose: NpRigid3
    translation_weight: float
    rotation_weight: float
    tag: str  # "INTRA_SUBMAP" | "INTER_SUBMAP"


@dataclass
class PbState:
    format_version: int = 0
    constraints: List[PbConstraint] = field(default_factory=list)
    nodes: List[PbNodePose] = field(default_factory=list)  # across trajectories
    submap_poses: List[dict] = field(default_factory=list)
    landmark_poses: Dict[str, NpRigid3] = field(default_factory=dict)
    record_counts: Dict[str, int] = field(default_factory=dict)


def _decode_id(buf: bytes) -> tuple:
    fd = pw.fields_to_dict(buf)
    return int(pw.first(fd, 1, 0)), int(pw.first(fd, 2, 0))


def _decode_constraint(buf: bytes) -> PbConstraint:
    """(ref: pose_graph.proto PoseGraph.Constraint — submap_id=1, node_id=2,
    relative_pose=3, tag=5, translation_weight=6, rotation_weight=7)"""
    fd = pw.fields_to_dict(buf)
    st, si = _decode_id(pw.first(fd, 1, b""))
    nt, ni = _decode_id(pw.first(fd, 2, b""))
    rel = pw.decode_rigid3d(pw.first(fd, 3, b""))
    tag = "INTER_SUBMAP" if int(pw.first(fd, 5, 0)) == 1 else "INTRA_SUBMAP"
    return PbConstraint(
        submap_trajectory_id=st,
        submap_index=si,
        node_trajectory_id=nt,
        node_index=ni,
        relative_pose=rel,
        translation_weight=pw.as_double(pw.first(fd, 6, 0)),
        rotation_weight=pw.as_double(pw.first(fd, 7, 0)),
        tag=tag,
    )


def _decode_trajectory(buf: bytes, state: PbState) -> None:
    """(ref: trajectory.proto Trajectory — node=1, submap=2, trajectory_id=3)"""
    fd = pw.fields_to_dict(buf)
    trajectory_id = int(pw.first(fd, 3, 0))
    for node_buf in fd.get(1, []):
        nd = pw.fields_to_dict(node_buf)
        state.nodes.append(
            PbNodePose(
                trajectory_id=trajectory_id,
                node_index=int(pw.first(nd, 7, 0)),
                timestamp=pw._signed64(int(pw.first(nd, 1, 0))),
                pose=pw.decode_rigid3d(pw.first(nd, 5, b"")),
            )
        )
    for submap_buf in fd.get(2, []):
        sd = pw.fields_to_dict(submap_buf)
        state.submap_poses.append(
            {
                "trajectory_id": trajectory_id,
                "submap_index": int(pw.first(sd, 2, 0)),
                "pose": pw.decode_rigid3d(pw.first(sd, 1, b"")),
            }
        )


def _decode_pose_graph(buf: bytes, state: PbState) -> None:
    """(ref: pose_graph.proto PoseGraph — constraint=2, trajectory=4,
    landmark_poses=5)"""
    for fieldno, _, value in pw.iter_fields(buf):
        if fieldno == 2:
            state.constraints.append(_decode_constraint(value))
        elif fieldno == 4:
            _decode_trajectory(value, state)
        elif fieldno == 5:
            fd = pw.fields_to_dict(value)
            name = pw.first(fd, 1, b"").decode()
            state.landmark_poses[name] = pw.decode_rigid3d(pw.first(fd, 2, b""))


def read_state(path: str) -> PbState:
    """Decode header + pose graph from a pbstream state file; other record
    kinds are counted (ref: proto_stream_deserializer.cc:35)."""
    state = PbState()
    for i, record in enumerate(read_records(path)):
        if i == 0:
            fd = pw.fields_to_dict(record)
            state.format_version = int(pw.first(fd, 1, 0))
            continue
        fd = pw.fields_to_dict(record)
        for fieldno in fd:
            kind = SERIALIZED_DATA_KINDS.get(fieldno, f"unknown_{fieldno}")
            state.record_counts[kind] = state.record_counts.get(kind, 0) + 1
            if kind == "pose_graph":
                _decode_pose_graph(fd[fieldno][0], state)
    return state


# -- state writing (for tests + tool output interop) ---------------------------


def encode_pose_graph(state: PbState) -> bytes:
    """Encode constraints + trajectories back into a PoseGraph proto."""
    out = b""
    for c in state.constraints:
        body = (
            pw.emit_message(1, pw.emit_int(1, c.submap_trajectory_id) + pw.emit_int(2, c.submap_index))
            + pw.emit_message(2, pw.emit_int(1, c.node_trajectory_id) + pw.emit_int(2, c.node_index))
            + pw.emit_message(3, pw.encode_rigid3d(c.relative_pose))
            + pw.emit_int(5, 1 if c.tag == "INTER_SUBMAP" else 0)
            + pw.emit_double(6, c.translation_weight)
            + pw.emit_double(7, c.rotation_weight)
        )
        out += pw.emit_message(2, body)
    by_traj: Dict[int, List[PbNodePose]] = {}
    for node in state.nodes:
        by_traj.setdefault(node.trajectory_id, []).append(node)
    submaps_by_traj: Dict[int, List[dict]] = {}
    for sm in state.submap_poses:
        submaps_by_traj.setdefault(sm["trajectory_id"], []).append(sm)
    for tid in sorted(set(by_traj) | set(submaps_by_traj)):
        body = pw.emit_int(3, tid)
        for node in by_traj.get(tid, []):
            body += pw.emit_message(
                1,
                pw.emit_int(7, node.node_index)
                + pw.emit_int(1, node.timestamp)
                + pw.emit_message(5, pw.encode_rigid3d(node.pose)),
            )
        for sm in submaps_by_traj.get(tid, []):
            body += pw.emit_message(
                2,
                pw.emit_message(1, pw.encode_rigid3d(sm["pose"]))
                + pw.emit_int(2, sm["submap_index"]),
            )
        out += pw.emit_message(4, body)
    for name, pose in state.landmark_poses.items():
        out += pw.emit_message(
            5, pw.emit_string(1, name) + pw.emit_message(2, pw.encode_rigid3d(pose))
        )
    return out


def write_state(path: str, state: PbState) -> None:
    """Write a minimal pbstream state file: header + PoseGraph record —
    the subset the ground-truth tools consume (ref:
    mapping_state_serialization.cc ordering: header first, PoseGraph
    second)."""
    header = pw.emit_int(1, state.format_version or 2)
    pose_graph_record = pw.emit_message(1, encode_pose_graph(state))
    write_records(path, [header, pose_graph_record])


# -- GroundTruth relations (binary proto file, NOT a pbstream) ------------------


@dataclass
class Relation:
    """(ref: ground_truth/proto/relations.proto Relation)"""

    timestamp1: int
    timestamp2: int
    expected: NpRigid3  # tracking frame at timestamp2 -> at timestamp1
    covered_distance: float


def read_ground_truth(path: str) -> List[Relation]:
    """Parse a reference-compatible GroundTruth binary proto
    (ref: compute_relations_metrics_main.cc:205-207 ParseFromIstream)."""
    with open(path, "rb") as f:
        buf = f.read()
    relations = []
    for fieldno, _, value in pw.iter_fields(buf):
        if fieldno != 1:
            continue
        fd = pw.fields_to_dict(value)
        relations.append(
            Relation(
                timestamp1=pw._signed64(int(pw.first(fd, 1, 0))),
                timestamp2=pw._signed64(int(pw.first(fd, 2, 0))),
                expected=pw.decode_rigid3d(pw.first(fd, 3, b"")),
                covered_distance=pw.as_double(pw.first(fd, 4, 0)),
            )
        )
    return relations


def write_ground_truth(path: str, relations: List[Relation]) -> None:
    out = b""
    for r in relations:
        body = (
            pw.emit_int(1, r.timestamp1)
            + pw.emit_int(2, r.timestamp2)
            + pw.emit_message(3, pw.encode_rigid3d(r.expected))
            + pw.emit_double(4, r.covered_distance)
        )
        out += pw.emit_message(1, body)
    with open(path, "wb") as f:
        f.write(out)
