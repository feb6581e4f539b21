"""Minimal protobuf wire-format codec (no protoc / generated code); a
host-only copy of hectorgrapher_tpu/io/protowire.py.

Implements just enough of the proto3 encoding to interoperate with the
reference's binary artifacts:

  * GroundTruth relation files (ref: ground_truth/proto/relations.proto,
    parsed with ParseFromIstream at
    ground_truth/compute_relations_metrics_main.cc:205-207)
  * the pose-graph / trajectory messages inside `.pbstream` state files
    (ref: mapping/proto/pose_graph.proto, trajectory.proto,
    serialization.proto)
  * transform messages (ref: transform/proto/transform.proto)

Wire format: https://protobuf.dev/programming-guides/encoding/ — varints,
64-bit fixed (doubles), and length-delimited submessages. proto3 omits
fields at their default value; decoders below must (and do) tolerate
missing fields.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Tuple

import numpy as np

from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3

# wire types
VARINT = 0
FIXED64 = 1
BYTES = 2
FIXED32 = 5


# -- primitive encoding --------------------------------------------------------


def encode_varint(value: int) -> bytes:
    if value < 0:
        value &= (1 << 64) - 1  # two's-complement 64-bit, as protobuf does
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def decode_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        byte = buf[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise ValueError("malformed varint")


def _signed64(value: int) -> int:
    """Interpret a decoded varint as a signed int64 (int64 proto fields)."""
    if value >= 1 << 63:
        value -= 1 << 64
    return value


def _tag(field: int, wire_type: int) -> bytes:
    return encode_varint((field << 3) | wire_type)


def iter_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value); value is int for
    VARINT/FIXED*, bytes for BYTES."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = decode_varint(buf, pos)
        field, wire_type = key >> 3, key & 7
        if wire_type == VARINT:
            value, pos = decode_varint(buf, pos)
        elif wire_type == FIXED64:
            value = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wire_type == BYTES:
            size, pos = decode_varint(buf, pos)
            value = buf[pos : pos + size]
            pos += size
        elif wire_type == FIXED32:
            value = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire_type}")
        yield field, wire_type, value


def fields_to_dict(buf: bytes) -> Dict[int, List[object]]:
    out: Dict[int, List[object]] = {}
    for field, _, value in iter_fields(buf):
        out.setdefault(field, []).append(value)
    return out


# -- field emitters (proto3: skip default values) ------------------------------


def emit_double(field: int, value: float) -> bytes:
    if value == 0.0:
        return b""
    return _tag(field, FIXED64) + struct.pack("<d", value)


def emit_float(field: int, value: float) -> bytes:
    if value == 0.0:
        return b""
    return _tag(field, FIXED32) + struct.pack("<f", value)


def emit_int(field: int, value: int) -> bytes:
    if value == 0:
        return b""
    return _tag(field, VARINT) + encode_varint(value)


def emit_bytes(field: int, value: bytes) -> bytes:
    return _tag(field, BYTES) + encode_varint(len(value)) + value


def emit_message(field: int, body: bytes) -> bytes:
    return emit_bytes(field, body)


def emit_string(field: int, value: str) -> bytes:
    return emit_bytes(field, value.encode())


def as_double(value: object) -> float:
    """Decode a FIXED64 field value as a double."""
    return struct.unpack("<d", struct.pack("<Q", value))[0]


def as_float(value: object) -> float:
    return struct.unpack("<f", struct.pack("<I", value))[0]


def first(fd: Dict[int, List[object]], field: int, default=None):
    values = fd.get(field)
    return values[0] if values else default


# -- packed repeated scalars (proto3 default packing) ---------------------------


def encode_packed_varints(values) -> bytes:
    """Packed varint payload for repeated int32/int64/uint32 fields.
    Negative values use the 10-byte two's-complement form, as protobuf
    does. Vectorized for the common all-in-[0, 2^21) case (grid cells)."""
    values = np.asarray(values, np.int64)
    if values.size == 0:
        return b""
    if values.min() >= 0 and values.max() < (1 << 21):
        v = values
        n1 = v < (1 << 7)
        n2 = (~n1) & (v < (1 << 14))
        n3 = ~(n1 | n2)
        lengths = np.where(n1, 1, np.where(n2, 2, 3)).astype(np.int64)
        offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        out = np.zeros(int(lengths.sum()), np.uint8)
        out[offsets] = np.where(lengths > 1, (v & 0x7F) | 0x80, v & 0x7F)
        m2 = lengths >= 2
        out[offsets[m2] + 1] = np.where(
            lengths[m2] > 2, ((v[m2] >> 7) & 0x7F) | 0x80, (v[m2] >> 7) & 0x7F
        )
        m3 = lengths >= 3
        out[offsets[m3] + 2] = (v[m3] >> 14) & 0x7F
        return out.tobytes()
    return b"".join(encode_varint(int(x)) for x in values)


def decode_packed_varints(blob: bytes) -> np.ndarray:
    """Decode a packed varint payload to int64 (two's-complement
    interpretation, so negative int32/int64 round-trip)."""
    b = np.frombuffer(blob, np.uint8).astype(np.uint64)
    if b.size == 0:
        return np.zeros(0, np.int64)
    ends = np.flatnonzero(b < 128)
    starts = np.concatenate([[0], ends[:-1] + 1])
    lengths = ends - starts + 1
    vals = np.zeros(len(ends), np.uint64)
    for k in range(int(lengths.max())):
        idx = lengths > k
        vals[idx] |= (b[starts[idx] + k] & np.uint64(0x7F)) << np.uint64(7 * k)
    return vals.astype(np.int64)


def zigzag_encode(values) -> np.ndarray:
    """sint32/sint64 zigzag (proto sint fields, e.g. hybrid-grid indices)."""
    v = np.asarray(values, np.int64)
    return (v << 1) ^ (v >> 63)


def zigzag_decode(values) -> np.ndarray:
    v = np.asarray(values, np.int64)
    return (v >> 1) ^ -(v & 1)


def encode_packed_floats(values) -> bytes:
    """Packed fixed32 float payload (repeated float)."""
    return np.asarray(values, "<f4").tobytes()


def decode_packed_floats(blob: bytes) -> np.ndarray:
    return np.frombuffer(blob, "<f4").copy()


def repeated_varints(fd: Dict[int, List[object]], field: int) -> np.ndarray:
    """Collect a repeated varint-scalar field that may arrive packed
    (length-delimited blobs) or unpacked (individual varints) — decoders
    must accept both per the protobuf spec."""
    chunks = []
    for value in fd.get(field, []):
        if isinstance(value, (bytes, bytearray)):
            chunks.append(decode_packed_varints(bytes(value)))
        else:
            chunks.append(np.asarray([value], np.uint64).astype(np.int64))
    if not chunks:
        return np.zeros(0, np.int64)
    return np.concatenate(chunks)


def repeated_floats(fd: Dict[int, List[object]], field: int) -> np.ndarray:
    """Collect a repeated float field, packed or unpacked."""
    chunks = []
    for value in fd.get(field, []):
        if isinstance(value, (bytes, bytearray)):
            chunks.append(decode_packed_floats(bytes(value)))
        else:
            chunks.append(np.asarray([as_float(value)], np.float32))
    if not chunks:
        return np.zeros(0, np.float32)
    return np.concatenate(chunks)


# -- transform.proto messages ---------------------------------------------------


def encode_vector3d(v) -> bytes:
    return emit_double(1, float(v[0])) + emit_double(2, float(v[1])) + emit_double(3, float(v[2]))


def decode_vector3d(buf: bytes) -> np.ndarray:
    fd = fields_to_dict(buf)
    return np.array(
        [as_double(first(fd, 1, 0)), as_double(first(fd, 2, 0)), as_double(first(fd, 3, 0))]
    )


def encode_quaterniond(q) -> bytes:
    """q in (w, x, y, z) order — the proto stores x=1, y=2, z=3, w=4
    (ref: transform.proto Quaterniond)."""
    return (
        emit_double(1, float(q[1]))
        + emit_double(2, float(q[2]))
        + emit_double(3, float(q[3]))
        + emit_double(4, float(q[0]))
    )


def decode_quaterniond(buf: bytes) -> np.ndarray:
    fd = fields_to_dict(buf)
    return np.array(
        [
            as_double(first(fd, 4, 0)),  # w
            as_double(first(fd, 1, 0)),  # x
            as_double(first(fd, 2, 0)),  # y
            as_double(first(fd, 3, 0)),  # z
        ]
    )


def encode_rigid3d(pose: NpRigid3) -> bytes:
    """(ref: transform.proto Rigid3d — translation=1, rotation=2)"""
    return emit_message(1, encode_vector3d(pose.t)) + emit_message(
        2, encode_quaterniond(pose.q)
    )


def decode_rigid3d(buf: bytes) -> NpRigid3:
    fd = fields_to_dict(buf)
    t = decode_vector3d(first(fd, 1, b""))
    q_raw = first(fd, 2)
    if q_raw is None:
        q = np.array([1.0, 0.0, 0.0, 0.0])
    else:
        q = decode_quaterniond(q_raw)
        if not np.any(q):
            q = np.array([1.0, 0.0, 0.0, 0.0])
    return NpRigid3(t, q)
