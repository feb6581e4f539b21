"""Minimal rosbag (v2.0) deserializer for the DRZ dataset's topics
(counterpart of hectorgrapher_tpu/io/rosbag.py; host-only numpy, and the
writer's bytes equal the JAX package's).

The reference's evaluation data ships as ROS bags
(ref: the reference's README.md:31-37 — DRZ Living Lab Tracked Robot SLAM
Dataset, Qualisys mocap ground truth); this reader decodes the three
sensor message types the SLAM pipeline consumes — sensor_msgs/PointCloud2,
sensor_msgs/Imu, nav_msgs/Odometry — into the same SensorEvent stream
io/readers.py produces from file sequences, so the four DRZ sequences run
through evaluation/mapping_evaluation unmodified when the data is present.

Format (https://wiki.ros.org/Bags/Format/2.0):
  "#ROSBAG V2.0\n" then records; record = header_len(u32 LE) + header +
  data_len(u32) + data; header = concatenated fields, each
  len(u32) + b"name=" + value. Record kinds by op byte: 0x03 bag header,
  0x05 chunk (compression none/bz2[/lz4]), 0x07 connection, 0x02 message
  data, 0x04 index data, 0x06 chunk info. Message/connection records live
  inside chunk payloads; index records are skipped (we stream
  sequentially, no random access needed).

A minimal writer (uncompressed, no index records) exists for test
fixtures — our reader never needs the index, so fixtures stay tiny.
"""

from __future__ import annotations

import bz2
import struct
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from hectorgrapher_tpu_torch.io.readers import SensorEvent
from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3

MAGIC = b"#ROSBAG V2.0\n"

OP_MESSAGE_DATA = 0x02
OP_BAG_HEADER = 0x03
OP_INDEX_DATA = 0x04
OP_CHUNK = 0x05
OP_CHUNK_INFO = 0x06
OP_CONNECTION = 0x07


def _parse_header(buf: bytes) -> Dict[bytes, bytes]:
    fields: Dict[bytes, bytes] = {}
    pos = 0
    while pos < len(buf):
        (flen,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        field = buf[pos : pos + flen]
        pos += flen
        name, _, value = field.partition(b"=")
        fields[name] = value
    return fields


def _emit_header(fields: Dict[bytes, bytes]) -> bytes:
    out = b""
    for name, value in fields.items():
        field = name + b"=" + value
        out += struct.pack("<I", len(field)) + field
    return out


def _read_record(buf: bytes, pos: int) -> Tuple[Dict[bytes, bytes], bytes, int]:
    (hlen,) = struct.unpack_from("<I", buf, pos)
    pos += 4
    header = _parse_header(buf[pos : pos + hlen])
    pos += hlen
    (dlen,) = struct.unpack_from("<I", buf, pos)
    pos += 4
    data = buf[pos : pos + dlen]
    pos += dlen
    return header, data, pos


@dataclass
class BagMessage:
    topic: str
    msg_type: str
    time: float  # receive timestamp (seconds)
    raw: bytes  # serialized ROS1 message body


def read_bag(path: str, topics: Optional[List[str]] = None) -> Iterator[BagMessage]:
    """Stream messages (optionally filtered by topic) in file order."""
    with open(path, "rb") as f:
        blob = f.read()
    if not blob.startswith(MAGIC):
        raise ValueError(f"{path}: not a rosbag v2.0 file")
    pos = len(MAGIC)
    connections: Dict[int, Tuple[str, str]] = {}  # conn id -> (topic, type)

    def handle_stream(buf: bytes) -> Iterator[BagMessage]:
        p = 0
        while p < len(buf):
            header, data, p = _read_record(buf, p)
            op = header.get(b"op", b"\x00")[0]
            if op == OP_CONNECTION:
                conn = int(struct.unpack("<I", header[b"conn"])[0])
                conn_header = _parse_header(data)
                topic = header.get(b"topic", conn_header.get(b"topic", b"")).decode()
                msg_type = conn_header.get(b"type", b"").decode()
                connections[conn] = (topic, msg_type)
            elif op == OP_MESSAGE_DATA:
                conn = int(struct.unpack("<I", header[b"conn"])[0])
                secs, nsecs = struct.unpack("<II", header[b"time"])
                topic, msg_type = connections.get(conn, ("", ""))
                if topics is None or topic in topics:
                    yield BagMessage(topic, msg_type, secs + nsecs * 1e-9, data)

    while pos < len(blob):
        header, data, pos = _read_record(blob, pos)
        op = header.get(b"op", b"\x00")[0]
        if op == OP_CHUNK:
            compression = header.get(b"compression", b"none").decode()
            if compression == "none":
                payload = data
            elif compression == "bz2":
                payload = bz2.decompress(data)
            else:
                raise ValueError(f"unsupported chunk compression {compression!r}")
            yield from handle_stream(payload)
        elif op in (OP_CONNECTION, OP_MESSAGE_DATA):
            # Unchunked records (our minimal writer; also legal in bags).
            yield from handle_stream(
                struct.pack("<I", len(_emit_header(header)))
                + _emit_header(header)
                + struct.pack("<I", len(data))
                + data
            )
        # OP_BAG_HEADER / OP_INDEX_DATA / OP_CHUNK_INFO: skipped.


# ---------------------------------------------------------------------------
# ROS1 message codecs (only what the DRZ topics need)
# ---------------------------------------------------------------------------

_PC2_DTYPES = {
    1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
    5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64,
}


def _read_string(buf: bytes, pos: int) -> Tuple[str, int]:
    (n,) = struct.unpack_from("<I", buf, pos)
    pos += 4
    return buf[pos : pos + n].decode(errors="replace"), pos + n


def _read_ros_header(buf: bytes, pos: int) -> Tuple[float, int]:
    (seq, secs, nsecs) = struct.unpack_from("<III", buf, pos)
    pos += 12
    _, pos = _read_string(buf, pos)  # frame_id
    return secs + nsecs * 1e-9, pos


def decode_point_cloud2(raw: bytes):
    """sensor_msgs/PointCloud2 -> (stamp, (N,3) float32 xyz, width,
    per-point times or None).

    Rows with non-finite coordinates are kept (the SLAM range filter
    drops them); the organized width is preserved for CLOUD_STRUCTURE
    normals (ref: the reference's `width` addition, SURVEY §2.3). A
    float `time`/`t`/`time_offset` field (Velodyne/Ouster convention, the
    DRZ sensors) is decoded as per-point relative times for the CT
    builder's unwarping."""
    stamp, pos = _read_ros_header(raw, 0)
    height, width = struct.unpack_from("<II", raw, pos)
    pos += 8
    (nfields,) = struct.unpack_from("<I", raw, pos)
    pos += 4
    fields = []
    for _ in range(nfields):
        name, pos = _read_string(raw, pos)
        offset, datatype, count = struct.unpack_from("<IBI", raw, pos)
        pos += 9
        fields.append((name, offset, datatype, count))
    is_bigendian = raw[pos]
    pos += 1
    point_step, row_step = struct.unpack_from("<II", raw, pos)
    pos += 8
    (dlen,) = struct.unpack_from("<I", raw, pos)
    pos += 4
    data = raw[pos : pos + dlen]
    pos += dlen
    if is_bigendian:
        raise ValueError("big-endian PointCloud2 not supported")
    by_name = {f[0]: f for f in fields}
    n = height * width
    out = np.zeros((n, 3), np.float32)
    arr = np.frombuffer(data, np.uint8)[: n * point_step].reshape(n, point_step)
    for k, axis in enumerate(("x", "y", "z")):
        if axis not in by_name:
            raise ValueError(f"PointCloud2 missing field {axis!r}")
        _, offset, datatype, _ = by_name[axis]
        dt = np.dtype(_PC2_DTYPES[datatype]).newbyteorder("<")
        vals = arr[:, offset : offset + dt.itemsize].copy().view(dt)[:, 0]
        out[:, k] = vals.astype(np.float32)
    times = None
    for tname in ("time", "t", "time_offset"):
        if tname in by_name:
            _, offset, datatype, _ = by_name[tname]
            dt = np.dtype(_PC2_DTYPES[datatype]).newbyteorder("<")
            tv = arr[:, offset : offset + dt.itemsize].copy().view(dt)[:, 0]
            if np.issubdtype(dt, np.integer):
                # Ouster's 't' is uint32 NANOSECONDS since scan start;
                # float fields (Velodyne 'time') are seconds.
                times = (tv.astype(np.float64) * 1e-9).astype(np.float32)
            else:
                times = tv.astype(np.float32)
            break
    return stamp, out, int(width), times


def encode_point_cloud2(
    stamp: float,
    points: np.ndarray,
    width: int = 0,
    times: np.ndarray = None,
    rings: np.ndarray = None,
    intensities: np.ndarray = None,
) -> bytes:
    """With times/rings/intensities this emits the DRZ-sensor layout
    (xyz f32 + intensity f32 + ring u16 + time f32, 20-byte point_step,
    the Velodyne/Ouster convention) so synthesized dress-rehearsal
    bags exercise the exact field-offset decoding the real sequences
    need; bare xyz otherwise."""
    points = np.asarray(points, np.float32)
    n = len(points)
    width = width or n
    # Organized clouds require height*width == point count: pad the last
    # row with NaN points (as sensors report dropped returns).
    height = max(1, (n + width - 1) // max(width, 1))
    m = height * width

    def padded(a, fill, dtype):
        a = np.asarray(a if a is not None else np.full(n, fill), dtype)
        if len(a) < m:
            a = np.concatenate([a, np.full(m - len(a), fill, dtype)])
        return np.ascontiguousarray(a[:m])

    if n < m:
        points = np.concatenate(
            [points, np.full((m - n, 3), np.nan, np.float32)]
        )
    points = np.ascontiguousarray(points[:m])
    secs = int(stamp)
    nsecs = int(round((stamp - secs) * 1e9))
    rich = times is not None or rings is not None or intensities is not None
    out = struct.pack("<III", 0, secs, nsecs) + struct.pack("<I", 0)  # header, frame_id ""
    out += struct.pack("<II", height, width)
    fields = [(axis, 4 * k, 7, 1) for k, axis in enumerate(("x", "y", "z"))]
    point_step = 12
    if rich:
        fields += [("intensity", 12, 7, 1), ("ring", 16, 4, 1), ("time", 18, 7, 1)]
        point_step = 22
    out += struct.pack("<I", len(fields))
    for name, offset, datatype, count in fields:
        out += struct.pack("<I", len(name)) + name.encode()
        out += struct.pack("<IBI", offset, datatype, count)
    out += b"\x00"  # little endian
    out += struct.pack("<II", point_step, point_step * width)
    if rich:
        rows = np.zeros((m, point_step), np.uint8)
        rows[:, 0:12] = points.view(np.uint8).reshape(m, 12)
        rows[:, 12:16] = padded(intensities, 0.0, np.float32).view(np.uint8).reshape(m, 4)
        rows[:, 16:18] = padded(rings, 0, np.uint16).view(np.uint8).reshape(m, 2)
        rows[:, 18:22] = padded(times, 0.0, np.float32).view(np.uint8).reshape(m, 4)
        payload = rows.tobytes()
    else:
        payload = points.tobytes()
    out += struct.pack("<I", len(payload)) + payload
    out += b"\x01"  # is_dense
    return out


def decode_imu(raw: bytes) -> Tuple[float, np.ndarray, np.ndarray]:
    """sensor_msgs/Imu -> (stamp, linear_acceleration, angular_velocity)."""
    stamp, pos = _read_ros_header(raw, 0)
    pos += 4 * 8 + 9 * 8  # orientation quaternion + covariance
    gyro = np.frombuffer(raw, np.float64, 3, pos).copy()
    pos += 3 * 8 + 9 * 8
    accel = np.frombuffer(raw, np.float64, 3, pos).copy()
    return stamp, accel, gyro


def encode_imu(stamp: float, accel, gyro) -> bytes:
    secs = int(stamp)
    nsecs = int(round((stamp - secs) * 1e9))
    out = struct.pack("<III", 0, secs, nsecs) + struct.pack("<I", 0)
    out += struct.pack("<4d", 0.0, 0.0, 0.0, 1.0) + struct.pack("<9d", *([0.0] * 9))
    out += struct.pack("<3d", *np.asarray(gyro, np.float64)) + struct.pack("<9d", *([0.0] * 9))
    out += struct.pack("<3d", *np.asarray(accel, np.float64)) + struct.pack("<9d", *([0.0] * 9))
    return out


def decode_odometry(raw: bytes) -> Tuple[float, NpRigid3]:
    """nav_msgs/Odometry -> (stamp, pose). ROS quaternions are xyzw; ours
    wxyz."""
    stamp, pos = _read_ros_header(raw, 0)
    _, pos = _read_string(raw, pos)  # child_frame_id
    t = np.frombuffer(raw, np.float64, 3, pos).copy()
    pos += 3 * 8
    xyzw = np.frombuffer(raw, np.float64, 4, pos).copy()
    q = np.array([xyzw[3], xyzw[0], xyzw[1], xyzw[2]])
    return stamp, NpRigid3(t, q)


def encode_odometry(stamp: float, pose: NpRigid3) -> bytes:
    secs = int(stamp)
    nsecs = int(round((stamp - secs) * 1e9))
    out = struct.pack("<III", 0, secs, nsecs) + struct.pack("<I", 0)
    out += struct.pack("<I", 0)  # child_frame_id ""
    out += struct.pack("<3d", *np.asarray(pose.t, np.float64))
    q = np.asarray(pose.q, np.float64)
    out += struct.pack("<4d", q[1], q[2], q[3], q[0])  # wxyz -> xyzw
    out += struct.pack("<36d", *([0.0] * 36))
    out += struct.pack("<6d", *([0.0] * 6)) + struct.pack("<36d", *([0.0] * 36))
    return out


# ---------------------------------------------------------------------------
# SensorEvent bridge + minimal writer
# ---------------------------------------------------------------------------

_TYPES = {
    "sensor_msgs/PointCloud2": "range",
    "sensor_msgs/Imu": "imu",
    "nav_msgs/Odometry": "odometry",
}


def read_bag_sequence(
    path: str,
    point_topic: Optional[str] = None,
    imu_topic: Optional[str] = None,
    odom_topic: Optional[str] = None,
) -> List[SensorEvent]:
    """Decode a bag into the SensorEvent stream io/readers.py produces —
    the DRZ entry point for evaluation/mapping_evaluation. Topics default
    to 'first topic of the matching type'. Range payloads are
    (points, width) organized clouds."""
    events: List[SensorEvent] = []
    chosen = {"range": point_topic, "imu": imu_topic, "odometry": odom_topic}
    for msg in read_bag(path):
        kind = _TYPES.get(msg.msg_type)
        if kind is None:
            continue
        if chosen[kind] is None:
            chosen[kind] = msg.topic
        if msg.topic != chosen[kind]:
            continue
        if kind == "range":
            stamp, points, width, times = decode_point_cloud2(msg.raw)
            events.append(
                SensorEvent(time=stamp, kind="range", payload=points, times=times)
            )
        elif kind == "imu":
            stamp, accel, gyro = decode_imu(msg.raw)
            events.append(SensorEvent(time=stamp, kind="imu", payload=(accel, gyro)))
        else:
            stamp, pose = decode_odometry(msg.raw)
            events.append(SensorEvent(time=stamp, kind="odometry", payload=pose))
    events.sort(key=lambda e: (e.time, e.kind != "imu"))
    return events


def write_bag(path: str, messages: List[Tuple[str, str, float, bytes]]) -> None:
    """Minimal v2.0 writer (uncompressed, unchunked, no index) for test
    fixtures: messages = [(topic, msg_type, stamp, raw)]."""
    conn_by_topic: Dict[str, int] = {}
    out = bytearray(MAGIC)

    def record(header: Dict[bytes, bytes], data: bytes) -> None:
        h = _emit_header(header)
        out.extend(struct.pack("<I", len(h)))
        out.extend(h)
        out.extend(struct.pack("<I", len(data)))
        out.extend(data)

    record({b"op": bytes([OP_BAG_HEADER]), b"index_pos": struct.pack("<Q", 0),
            b"conn_count": struct.pack("<I", 0), b"chunk_count": struct.pack("<I", 0)},
           b"\x20" * 4096)  # bag headers are padded; content unused by readers
    for topic, msg_type, stamp, raw in messages:
        if topic not in conn_by_topic:
            conn = len(conn_by_topic)
            conn_by_topic[topic] = conn
            record(
                {b"op": bytes([OP_CONNECTION]), b"conn": struct.pack("<I", conn),
                 b"topic": topic.encode()},
                _emit_header({b"topic": topic.encode(), b"type": msg_type.encode(),
                              b"md5sum": b"*", b"message_definition": b""}),
            )
        secs = int(stamp)
        nsecs = int(round((stamp - secs) * 1e9))
        record(
            {b"op": bytes([OP_MESSAGE_DATA]),
             b"conn": struct.pack("<I", conn_by_topic[topic]),
             b"time": struct.pack("<II", secs, nsecs)},
            raw,
        )
    with open(path, "wb") as f:
        f.write(bytes(out))
