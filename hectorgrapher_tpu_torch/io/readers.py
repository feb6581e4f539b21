"""Real-data ingestion: PLY / PCD point-cloud files + IMU/odometry CSV
(counterpart of hectorgrapher_tpu/io/readers.py; host-only numpy).

The reference's evaluation mains consume recorded point-cloud files
(ref: evaluation/mapping_evaluation.cc:38 pointcloud_filename flag, PCD
via PCL with x/y/z/intensity/ring fields; io/ply_writing_points_processor
and pcd_writing_points_processor define the formats the pipeline emits).
This module reads both formats (ascii + binary little-endian) so a
DRZ-style recorded sequence — a directory of per-scan cloud files plus
imu.csv / odometry.csv — can drive the evaluation tools the moment the
data is available.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3

_PLY_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read a PLY vertex cloud (ascii or binary_little_endian).

    Returns {property_name: (N,) array}; callers stack x/y/z themselves.
    (format per io/ply_writing_points_processor.cc output)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        count = 0
        props: List[Tuple[str, str]] = []
        in_vertex = False
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unterminated PLY header")
            parts = line.decode("ascii", "replace").strip().split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                in_vertex = parts[1] == "vertex"
                if in_vertex:
                    count = int(parts[2])
            elif parts[0] == "property" and in_vertex:
                if parts[1] == "list":
                    raise ValueError(f"{path}: list properties unsupported")
                props.append((parts[2], _PLY_TYPES[parts[1]]))
            elif parts[0] == "end_header":
                break
        names = [n for n, _ in props]
        if fmt == "ascii":
            rows = np.loadtxt(f, dtype=np.float64, max_rows=count, ndmin=2)
            return {n: rows[:, i] for i, n in enumerate(names)}
        if fmt != "binary_little_endian":
            raise ValueError(f"{path}: unsupported PLY format {fmt}")
        dtype = np.dtype([(n, "<" + t) for n, t in props])
        data = np.frombuffer(f.read(dtype.itemsize * count), dtype=dtype, count=count)
        return {n: np.ascontiguousarray(data[n]) for n in names}


def read_pcd(path: str) -> Dict[str, np.ndarray]:
    """Read a PCD file (ascii or binary), the format mapping_evaluation.cc
    consumes via PCL (PointXYZIR: x y z intensity ring)."""
    with open(path, "rb") as f:
        header: Dict[str, List[str]] = {}
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unterminated PCD header")
            text = line.decode("ascii", "replace").strip()
            if not text or text.startswith("#"):
                continue
            parts = text.split()
            header[parts[0].upper()] = parts[1:]
            if parts[0].upper() == "DATA":
                data_kind = parts[1]
                break
        fields = header["FIELDS"]
        sizes = [int(s) for s in header["SIZE"]]
        types = header["TYPE"]
        counts = [int(c) for c in header.get("COUNT", ["1"] * len(fields))]
        n_points = int(header["POINTS"][0])
        np_types = {("F", 4): "f4", ("F", 8): "f8", ("I", 1): "i1", ("I", 2): "i2",
                    ("I", 4): "i4", ("U", 1): "u1", ("U", 2): "u2", ("U", 4): "u4"}
        if any(c != 1 for c in counts):
            raise ValueError(f"{path}: COUNT>1 unsupported")
        if data_kind == "ascii":
            rows = np.loadtxt(f, dtype=np.float64, max_rows=n_points, ndmin=2)
            return {n: rows[:, i] for i, n in enumerate(fields)}
        if data_kind != "binary":
            raise ValueError(f"{path}: unsupported DATA {data_kind} (binary_compressed not implemented)")
        dtype = np.dtype([(n, "<" + np_types[(t, s)]) for n, t, s in zip(fields, types, sizes)])
        data = np.frombuffer(f.read(dtype.itemsize * n_points), dtype=dtype, count=n_points)
        return {n: np.ascontiguousarray(data[n]) for n in fields}


def read_cloud_file(path: str) -> np.ndarray:
    """Read any supported cloud file -> (N, 3) float32 xyz."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".ply":
        d = read_ply(path)
    elif ext == ".pcd":
        d = read_pcd(path)
    elif ext in (".xyz", ".txt"):
        pts = np.loadtxt(path, dtype=np.float64, ndmin=2)
        return pts[:, :3].astype(np.float32)
    else:
        raise ValueError(f"unsupported cloud format: {path}")
    return np.stack([d["x"], d["y"], d["z"]], axis=-1).astype(np.float32)


def write_ply(path: str, points: np.ndarray) -> None:
    """Binary little-endian PLY writer (x y z float32), matching
    io/ply_writing_points_processor.cc's layout."""
    points = np.asarray(points, np.float32)
    with open(path, "wb") as f:
        f.write(
            (
                "ply\nformat binary_little_endian 1.0\n"
                f"element vertex {len(points)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "end_header\n"
            ).encode()
        )
        f.write(np.ascontiguousarray(points).tobytes())


# -- sensor CSV + sequence --------------------------------------------------------


@dataclass
class SensorEvent:
    time: float
    kind: str  # "range" | "imu" | "odometry"
    # range: (N,3) points in sensor frame; imu: (accel(3), gyro(3));
    # odometry: NpRigid3
    payload: object
    # range only: (N,) per-point RELATIVE times (seconds from `time`),
    # None when the source has no per-point timing (then the CT builder
    # treats the scan as instantaneous). DRZ lidar bags carry these in
    # the PointCloud2 `time` field.
    times: object = None


def read_imu_csv(path: str) -> List[SensorEvent]:
    """CSV rows: time, ax, ay, az, wx, wy, wz (comment lines with #)."""
    rows = np.loadtxt(path, delimiter=",", dtype=np.float64, ndmin=2)
    return [
        SensorEvent(time=float(r[0]), kind="imu", payload=(r[1:4].copy(), r[4:7].copy()))
        for r in rows
    ]


def read_odometry_csv(path: str) -> List[SensorEvent]:
    """CSV rows: time, x, y, z, qw, qx, qy, qz."""
    rows = np.loadtxt(path, delimiter=",", dtype=np.float64, ndmin=2)
    return [
        SensorEvent(
            time=float(r[0]), kind="odometry", payload=NpRigid3(r[1:4].copy(), r[4:8].copy())
        )
        for r in rows
    ]


def read_mocap_csv(path: str) -> List[Tuple[float, NpRigid3]]:
    """Qualisys-style mocap trajectory CSV: time, x, y, z, qw, qx, qy, qz
    (ref: generate_ground_truth_from_mocap_main.cc:33-43 consumes a mocap
    CSV to build relations)."""
    rows = np.loadtxt(path, delimiter=",", dtype=np.float64, ndmin=2)
    return [(float(r[0]), NpRigid3(r[1:4].copy(), r[4:8].copy())) for r in rows]


_STAMP_RE = re.compile(r"(\d+(?:\.\d+)?)")


def _stamp_of(filename: str) -> float:
    """Scan timestamp from a cloud filename like cloud_12.400.ply or
    scan_000123.pcd (last numeric group wins)."""
    matches = _STAMP_RE.findall(os.path.basename(filename))
    if not matches:
        raise ValueError(f"no timestamp in cloud filename: {filename}")
    return float(matches[-1])


def read_sequence_dir(path: str) -> List[SensorEvent]:
    """Read a recorded sequence directory into time-ordered sensor events.

    Layout: <dir>/*.ply|*.pcd|*.xyz (timestamp in filename) plus optional
    imu.csv and odometry.csv — the shape of data
    evaluation/mapping_evaluation.cc consumes (point-cloud files + sensor
    streams)."""
    events: List[SensorEvent] = []
    for name in os.listdir(path):
        full = os.path.join(path, name)
        ext = os.path.splitext(name)[1].lower()
        if ext in (".ply", ".pcd", ".xyz"):
            events.append(
                SensorEvent(time=_stamp_of(name), kind="range", payload=read_cloud_file(full))
            )
    imu_path = os.path.join(path, "imu.csv")
    if os.path.exists(imu_path):
        events.extend(read_imu_csv(imu_path))
    odom_path = os.path.join(path, "odometry.csv")
    if os.path.exists(odom_path):
        events.extend(read_odometry_csv(odom_path))
    events.sort(key=lambda e: (e.time, e.kind != "imu"))
    return events
