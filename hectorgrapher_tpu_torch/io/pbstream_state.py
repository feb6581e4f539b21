"""Full reference-format pbstream state interop (counterpart of
hectorgrapher_tpu/io/pbstream_state.py).

Encodes and decodes the reference's complete mapping state: submaps with
grid payloads, trajectory node data with compressed clouds, trajectory
data. A reference-produced `.pbstream` loads into the port's pose graph as
a frozen map for pure localization, and `write_pbstream_state` emits a
stream whose record sequence and protos the reference's deserializer
accepts (ref: io/internal/mapping_state_serialization.cc WritePbStream
ordering: header -> PoseGraph -> AllTrajectoryBuilderOptions -> Submap*
-> Node* -> TrajectoryData*; mapping/proto/serialization.proto
SerializedData oneof).

The codecs run on the host over numpy: a grid leaves the card as float64
(uint16 codes decoded first) and a decoded grid comes back onto `device`
as float32 planes, through convert.py's grid builders.

Value codecs match the reference bit for bit:
- uint16 bounded-float codes: value = round((clamp(f)-lo)*32766/(hi-lo))+1
  in [1,32767], 0 = unknown (ref: probability_values.h:34-44
  BoundedFloatToValue; tsd_value_converter.h:39-55).
- Grid2D cell layout: flat = ix + iy*num_x_cells where
  ix = round((max.y-p.y)/res-0.5), iy = round((max.x-p.x)/res-0.5)
  (ref: 2d/map_limits.h GetCellIndex, 2d/grid_2d.h ToFlatIndex): both
  axes reversed relative to the port's min-corner dense arrays.
- HybridGrid/HybridGridTSDF: sparse (x,y,z,value) voxel lists with
  zigzag-coded signed indices; cell center at index*resolution
  (ref: 3d/hybrid_grid.h GetCenterOfCell, proto/3d/hybrid_grid_tsdf.proto).
- CompressedPointCloud: 1mm raster, 10-bit block-relative packing
  (ref: sensor/compressed_point_cloud.cc; sensor/compression.py is
  wire-identical).

A reference quirk, mirrored as the JAX package mirrors it:
HybridGridTSDF::ToProto stores the absolute max TSD in
`relative_truncation_distance` (hybrid_grid_tsdf.h:132) while FromProto
multiplies the field by resolution again (:68-71). ToProto's semantics
(absolute) are written and read, so reference-produced files decode to
the right truncation here and these files read back exactly.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, List, Tuple

import numpy as np
import torch

from hectorgrapher_tpu_torch import convert
from hectorgrapher_tpu_torch.common import time as common_time
from hectorgrapher_tpu_torch.io import protowire as pw
from hectorgrapher_tpu_torch.io.pbstream import (
    SERIALIZED_DATA_KINDS,
    PbConstraint,
    PbNodePose,
    PbState,
    _decode_pose_graph,
    encode_pose_graph,
    read_records,
    write_records,
)
from hectorgrapher_tpu_torch.mapping import probability_values as pv
from hectorgrapher_tpu_torch.mapping.grids import ProbabilityGrid, TSDFGrid, ensure_f32_grid
from hectorgrapher_tpu_torch.mapping.pose_graph.pose_graph import Constraint, PgNode, PgSubmap, TrajectoryState
from hectorgrapher_tpu_torch.mapping.submap_2d import Submap2D
from hectorgrapher_tpu_torch.mapping.submap_3d import Submap3D
from hectorgrapher_tpu_torch.sensor import compression
from hectorgrapher_tpu_torch.sensor.types import PointCloud, pad_cloud
from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3

# common::Time: 100 ns ticks since 0001-01-01; the unix epoch is
# UTS_EPOCH_OFFSET_FROM_UNIX_EPOCH_SECONDS later (ref: common/time.h).
_EPOCH_OFFSET_TICKS = common_time.UTS_EPOCH_OFFSET_FROM_UNIX_EPOCH_SECONDS * common_time.UTS_TICKS_PER_SECOND


def seconds_to_ticks(t: float) -> int:
    return common_time.to_universal(float(t)) + _EPOCH_OFFSET_TICKS


def ticks_to_seconds(ticks: int) -> float:
    return common_time.from_universal(int(ticks) - _EPOCH_OFFSET_TICKS)


def _host(x: torch.Tensor) -> np.ndarray:
    """A plane or field off the card as float64 (exact for f32 and half)."""
    return x.to(torch.float64).cpu().numpy()


# ---------------------------------------------------------------------------
# Bounded-float <-> uint16 codes (ref: probability_values.h:34-44)
# ---------------------------------------------------------------------------


def encode_bounded(values, lo: float, hi: float, known) -> np.ndarray:
    """float -> codes 1..32767; unknown -> 0. Round half away from zero
    like common::RoundToInt (values after the clamp-shift are >= 0, so
    floor(x+0.5) is exact)."""
    f = np.clip(np.asarray(values, np.float64), lo, hi)
    codes = np.floor((f - lo) * (32766.0 / (hi - lo)) + 0.5).astype(np.int64) + 1
    return np.where(np.asarray(known, bool), codes, 0).astype(np.uint16)


def decode_bounded(codes, lo: float, hi: float, unknown: float) -> np.ndarray:
    """codes -> float: lo + (code-1)*scale; 0 -> unknown
    (ref: value_conversion_tables.cc table construction)."""
    codes = np.asarray(codes, np.int64)
    scale = (hi - lo) / 32766.0
    vals = lo + (codes - 1) * scale
    return np.where(codes > 0, vals, unknown).astype(np.float32)


# ---------------------------------------------------------------------------
# CompressedPointCloud proto (sensor.proto:33-36)
# ---------------------------------------------------------------------------


def encode_compressed_cloud(points: np.ndarray) -> bytes:
    stream, n = compression.compress(np.asarray(points, np.float64))
    return pw.emit_int(1, int(n)) + (pw.emit_bytes(3, pw.encode_packed_varints(stream)) if n else b"")


def decode_compressed_cloud(buf: bytes) -> np.ndarray:
    fd = pw.fields_to_dict(buf)
    n = int(pw.first(fd, 1, 0))
    if n == 0:
        return np.zeros((0, 3), np.float32)
    stream = pw.repeated_varints(fd, 3)
    # int32 negatives arrive sign-extended to 64 bits (already negative
    # after the int64 view); a 32-bit-truncated encoder's [2^31, 2^32)
    # values narrow here too.
    stream = np.where((stream >= 2**31) & (stream < 2**32), stream - 2**32, stream)
    return compression.decompress(stream.astype(np.int64), n)


def _cloud_to_padded(points: np.ndarray, device, min_pad: int = 64) -> PointCloud:
    pad = min_pad
    while pad < len(points):
        pad *= 2
    return pad_cloud(np.asarray(points, np.float32), pad, device)


def _valid_points(cloud: PointCloud) -> np.ndarray:
    return cloud.positions.cpu().numpy()[cloud.mask.cpu().numpy()]


# ---------------------------------------------------------------------------
# Grid2D (proto/2d/grid_2d.proto + map_limits.proto + cell_limits.proto)
# ---------------------------------------------------------------------------


def _encode_map_limits(resolution: float, max_xy: np.ndarray, num_x: int, num_y: int) -> bytes:
    vec = pw.emit_double(1, float(max_xy[0])) + pw.emit_double(2, float(max_xy[1]))
    cells = pw.emit_int(1, num_x) + pw.emit_int(2, num_y)
    return pw.emit_double(1, resolution) + pw.emit_message(2, vec) + pw.emit_message(3, cells)


def _decode_map_limits(buf: bytes) -> Tuple[float, np.ndarray, int, int]:
    fd = pw.fields_to_dict(buf)
    res = pw.as_double(pw.first(fd, 1, 0))
    vec = pw.fields_to_dict(pw.first(fd, 2, b""))
    max_xy = np.array([pw.as_double(pw.first(vec, 1, 0)), pw.as_double(pw.first(vec, 2, 0))])
    cl = pw.fields_to_dict(pw.first(fd, 3, b""))
    return res, max_xy, int(pw.first(cl, 1, 0)), int(pw.first(cl, 2, 0))


def _meta(resolution, min_corner) -> SimpleNamespace:
    return SimpleNamespace(resolution=np.float32(resolution), min_corner=np.asarray(min_corner, np.float32))


def _tsdf_grid(tsd, weight, trunc, max_w, meta, device) -> TSDFGrid:
    return convert.tsdf_grid(SimpleNamespace(tsd=tsd, weight=weight, truncation_distance=np.float32(trunc),
                                             max_weight=np.float32(max_w), meta=meta), device)


def encode_grid_2d(grid, origin_t=None) -> bytes:
    """A port 2D grid -> reference Grid2D proto bytes.

    The port's O[ox, oy] (min-corner ascending axes) maps to the
    reference's C[iy, ix] with ox = num_y-1-iy, oy = num_x-1-ix: C =
    O[::-1, ::-1] flattened with ix fastest (ref: grid_2d.h ToFlatIndex).

    origin_t: the submap origin (local_pose translation). The port's grids
    live in the local frame, the reference's in the submap frame; the
    corner is rebased by -origin_t (exact: MapLimits.max is a double)."""
    grid = ensure_f32_grid(grid)
    nx, ny = int(grid.shape[0]), int(grid.shape[1])  # ours: (x cells, y cells)
    num_y, num_x = nx, ny  # reference: num_y_cells spans world x, num_x spans y
    res = float(grid.meta.resolution)
    mc = _host(grid.meta.min_corner)
    if origin_t is not None:
        mc = mc - np.asarray(origin_t, np.float64)[:2]
    max_xy = mc + np.array([nx * res, ny * res])

    if isinstance(grid, TSDFGrid):
        trunc = float(grid.truncation_distance)
        max_w = float(grid.max_weight)
        tsd = _host(grid.tsd)
        weight = _host(grid.weight)
        known = weight > 0
        cells = encode_bounded(tsd, -trunc, trunc, known)
        wcells = encode_bounded(weight, 0.0, max_w, known)
        cells_ref = cells[::-1, ::-1].reshape(-1)  # (num_y, num_x) row-major
        wcells_ref = wcells[::-1, ::-1].reshape(-1)
        sub = pw.emit_float(1, trunc) + pw.emit_float(2, max_w) + pw.emit_bytes(3, pw.encode_packed_varints(wcells_ref))
        return (
            pw.emit_message(1, _encode_map_limits(res, max_xy, num_x, num_y))
            + pw.emit_bytes(2, pw.encode_packed_varints(cells_ref))
            + _encode_known_box(known[::-1, ::-1])
            + pw.emit_message(5, sub)
            + pw.emit_float(6, -trunc)
            + pw.emit_float(7, trunc)
        )

    if not isinstance(grid, ProbabilityGrid):
        raise TypeError(f"encode_grid_2d: not a 2D grid: {type(grid).__name__}")
    p = _host(grid.probability())
    known = grid.known.cpu().numpy()
    cost = 1.0 - p  # ref: ProbabilityToCorrespondenceCost
    cells = encode_bounded(cost, pv.MIN_PROBABILITY, pv.MAX_PROBABILITY, known)
    cells_ref = cells[::-1, ::-1].reshape(-1)
    return (
        pw.emit_message(1, _encode_map_limits(res, max_xy, num_x, num_y))
        + pw.emit_bytes(2, pw.encode_packed_varints(cells_ref))
        + _encode_known_box(known[::-1, ::-1])
        + pw.emit_message(4, b"")  # oneof: probability_grid_2d (empty msg)
        + pw.emit_float(6, float(pv.MIN_PROBABILITY))
        + pw.emit_float(7, float(pv.MAX_PROBABILITY))
    )


def _encode_known_box(known_ref: np.ndarray) -> bytes:
    """CellBox over the reference-layout known mask (C[iy, ix]); indices
    are (ix, iy) per Grid2D::known_cells_box (Eigen AlignedBox2i of cell
    indices, x component = ix)."""
    iy, ix = np.nonzero(known_ref)
    if len(ix) == 0:
        return b""
    box = (pw.emit_int(1, int(ix.max())) + pw.emit_int(2, int(iy.max())) + pw.emit_int(3, int(ix.min()))
           + pw.emit_int(4, int(iy.min())))
    return pw.emit_message(3, box)


def decode_grid_2d(buf: bytes, device="cuda"):
    """Reference Grid2D proto -> a port ProbabilityGrid / TSDFGrid on
    `device`, float32 planes."""
    fd = pw.fields_to_dict(buf)
    res, max_xy, num_x, num_y = _decode_map_limits(pw.first(fd, 1, b""))
    codes = pw.repeated_varints(fd, 2).astype(np.int64)
    if codes.size != num_x * num_y:
        raise ValueError(f"Grid2D cells {codes.size} != {num_x}*{num_y}")
    O_codes = codes.reshape(num_y, num_x)[::-1, ::-1]  # ours: (nx, ny) = (num_y, num_x)
    meta = _meta(res, np.array([max_xy[0] - num_y * res, max_xy[1] - num_x * res]))
    min_cc = pw.as_float(pw.first(fd, 6, 0))
    max_cc = pw.as_float(pw.first(fd, 7, 0))
    if min_cc == 0.0 and max_cc == 0.0:  # ref: grid_2d.cc:22-44 legacy default
        min_cc, max_cc = float(pv.MIN_PROBABILITY), float(pv.MAX_PROBABILITY)

    if 5 in fd:  # TSDF2D
        sub = pw.fields_to_dict(fd[5][0])
        trunc = pw.as_float(pw.first(sub, 1, 0))
        max_w = pw.as_float(pw.first(sub, 2, 0))
        wcodes = pw.repeated_varints(sub, 3).astype(np.int64).reshape(num_y, num_x)[::-1, ::-1]
        return _tsdf_grid(decode_bounded(O_codes, -trunc, trunc, trunc), decode_bounded(wcodes, 0.0, max_w, 0.0),
                          trunc, max_w, meta, device)

    cost = decode_bounded(O_codes, min_cc, max_cc, float(pv.MAX_PROBABILITY))
    p = np.clip(1.0 - cost, 1e-6, 1.0 - 1e-6)
    known = O_codes > 0
    log_odds = np.where(known, np.log(p / (1.0 - p)), 0.0).astype(np.float32)
    return convert.probability_grid(SimpleNamespace(log_odds=log_odds, known=known, meta=meta), device)


# ---------------------------------------------------------------------------
# HybridGrid / HybridGridTSDF (proto/3d/hybrid_grid*.proto)
# ---------------------------------------------------------------------------

_MAX_DENSE_CELLS = 1 << 28  # decode guard: refuse absurd bounding boxes


def _voxel_base(grid, origin_t) -> np.ndarray:
    """The reference index of the grid's cell (0, 0, 0): the port's cell
    center is min_corner + (i + 0.5) * res, the reference's index * res."""
    mc = _host(grid.meta.min_corner)
    if origin_t is not None:
        mc = mc - np.asarray(origin_t, np.float64)
    return np.round(mc / float(grid.meta.resolution) + 0.5).astype(np.int64)


def _emit_voxel_indices(xi, yi, zi, base) -> bytes:
    return (pw.emit_bytes(3, pw.encode_packed_varints(pw.zigzag_encode(xi + base[0])))
            + pw.emit_bytes(4, pw.encode_packed_varints(pw.zigzag_encode(yi + base[1])))
            + pw.emit_bytes(5, pw.encode_packed_varints(pw.zigzag_encode(zi + base[2]))))


def encode_hybrid_tsdf(grid, origin_t=None) -> bytes:
    """A port 3D TSDFGrid -> HybridGridTSDF voxel lists. Only known
    (weight > 0) voxels are emitted, like the reference's iterator.

    origin_t rebases from the local frame into the reference's submap
    frame. The proto's integer index space puts voxel centers at
    index*resolution (ref: hybrid_grid.h GetCenterOfCell); a grid whose
    lattice is off that raster is snapped to the nearest lattice, a rigid
    sub-half-voxel translation. ActiveSubmaps3D aligns its grids at
    creation, so production exports are lossless."""
    grid = ensure_f32_grid(grid)
    res = float(grid.meta.resolution)
    trunc = float(grid.truncation_distance)
    max_w = float(grid.max_weight)
    tsd = _host(grid.tsd)
    weight = _host(grid.weight)
    xi, yi, zi = np.nonzero(weight > 0)
    tsd_codes = encode_bounded(tsd[xi, yi, zi], -trunc, trunc, True)
    w_codes = encode_bounded(weight[xi, yi, zi], 0.0, max_w, True)
    return (
        pw.emit_float(1, res)
        + _emit_voxel_indices(xi, yi, zi, _voxel_base(grid, origin_t))
        + pw.emit_bytes(6, pw.encode_packed_varints(tsd_codes))
        + pw.emit_bytes(7, pw.encode_packed_varints(w_codes))
        # ToProto quirk: the absolute max TSD in this field (module doc).
        + pw.emit_float(8, trunc)
        + pw.emit_float(9, max_w)
    )


def _decode_voxels(fd):
    """(resolution, x, y, z indices, box lower corner, box shape)."""
    res = pw.as_float(pw.first(fd, 1, 0))
    xs = pw.zigzag_decode(pw.repeated_varints(fd, 3))
    ys = pw.zigzag_decode(pw.repeated_varints(fd, 4))
    zs = pw.zigzag_decode(pw.repeated_varints(fd, 5))
    if len(xs) == 0:
        return res, xs, ys, zs, np.zeros(3, np.int64), (2, 2, 2)
    lo = np.array([xs.min(), ys.min(), zs.min()])
    shape = tuple(int(v) for v in np.array([xs.max(), ys.max(), zs.max()]) - lo + 1)
    if int(np.prod(shape)) > _MAX_DENSE_CELLS:
        raise ValueError(f"hybrid grid bounding box too large: {shape}")
    return res, xs, ys, zs, lo, shape


def decode_hybrid_tsdf(buf: bytes, device="cuda") -> TSDFGrid:
    """HybridGridTSDF -> a dense port TSDFGrid over the known voxels'
    bounding box, on `device`."""
    fd = pw.fields_to_dict(buf)
    res, xs, ys, zs, lo, shape = _decode_voxels(fd)
    trunc = pw.as_float(pw.first(fd, 8, 0))
    max_w = pw.as_float(pw.first(fd, 9, 0))
    tsd = np.full(shape, trunc, np.float32)
    weight = np.zeros(shape, np.float32)
    if len(xs):
        tsd[xs - lo[0], ys - lo[1], zs - lo[2]] = decode_bounded(pw.repeated_varints(fd, 6), -trunc, trunc, trunc)
        weight[xs - lo[0], ys - lo[1], zs - lo[2]] = decode_bounded(pw.repeated_varints(fd, 7), 0.0, max_w, 0.0)
    return _tsdf_grid(tsd, weight, trunc, max_w, _meta(res, (lo - 0.5) * res), device)


def encode_hybrid_occupancy(grid, origin_t=None) -> bytes:
    """A port 3D ProbabilityGrid -> HybridGrid probability-code lists
    (frame and lattice as encode_hybrid_tsdf)."""
    grid = ensure_f32_grid(grid)
    p = _host(grid.probability())
    xi, yi, zi = np.nonzero(grid.known.cpu().numpy())
    codes = encode_bounded(p[xi, yi, zi], float(pv.MIN_PROBABILITY), float(pv.MAX_PROBABILITY), True)
    return (
        pw.emit_float(1, float(grid.meta.resolution))
        + _emit_voxel_indices(xi, yi, zi, _voxel_base(grid, origin_t))
        + pw.emit_bytes(6, pw.encode_packed_varints(codes))
    )


def decode_hybrid_occupancy(buf: bytes, device="cuda") -> ProbabilityGrid:
    fd = pw.fields_to_dict(buf)
    res, xs, ys, zs, lo, shape = _decode_voxels(fd)
    p = decode_bounded(pw.repeated_varints(fd, 6), float(pv.MIN_PROBABILITY), float(pv.MAX_PROBABILITY), 0.5)
    log_odds = np.zeros(shape, np.float32)
    known = np.zeros(shape, bool)
    if len(xs):
        pc = np.clip(p, 1e-6, 1 - 1e-6)
        log_odds[xs - lo[0], ys - lo[1], zs - lo[2]] = np.log(pc / (1 - pc))
        known[xs - lo[0], ys - lo[1], zs - lo[2]] = True
    return convert.probability_grid(SimpleNamespace(log_odds=log_odds, known=known, meta=_meta(res, (lo - 0.5) * res)),
                                    device)


# ---------------------------------------------------------------------------
# Submap / Node records (serialization.proto + submap.proto +
# trajectory_node_data.proto)
# ---------------------------------------------------------------------------


def encode_submap_record(trajectory_id: int, submap_index: int, pg_submap) -> bytes:
    """SerializedData{submap=3} record bytes."""
    submap = pg_submap.submap
    sid = pw.emit_int(1, trajectory_id) + pw.emit_int(2, submap_index)
    # The port's grids live in the local frame, the reference's in the
    # submap frame: rebase by local_pose, translation-only in the port's
    # submaps (a rotated local_pose would need grid resampling, which the
    # dense representation cannot express).
    q = np.asarray(submap.local_pose.q, np.float64)
    if abs(abs(q[0]) - 1.0) > 1e-6:
        raise ValueError("pbstream export requires translation-only submap local_pose "
                         "(grid resampling under rotation is not supported)")
    origin_t = np.asarray(submap.local_pose.t, np.float64)
    head = (pw.emit_message(1, pw.encode_rigid3d(submap.local_pose)) + pw.emit_int(2, int(submap.num_range_data))
            + (pw.emit_int(3, 1) if pg_submap.finished else b""))
    if isinstance(submap, Submap3D):
        hi, lo = submap.high_resolution_grid, submap.low_resolution_grid
        if isinstance(hi, TSDFGrid):
            hi_field, hi_body = 7, encode_hybrid_tsdf(hi, origin_t)
            lo_field, lo_body = 8, encode_hybrid_tsdf(lo, origin_t)
        else:
            hi_field, hi_body = 4, encode_hybrid_occupancy(hi, origin_t)
            lo_field, lo_body = 5, encode_hybrid_occupancy(lo, origin_t)
        body = (head + pw.emit_message(hi_field, hi_body) + pw.emit_message(lo_field, lo_body)
                + pw.emit_bytes(6, pw.encode_packed_floats(np.asarray(submap.rotational_histogram))))
        sub = pw.emit_message(3, body)  # Submap.submap_3d
    else:
        sub = pw.emit_message(2, head + pw.emit_message(4, encode_grid_2d(submap.grid, origin_t)))  # Submap.submap_2d
    return pw.emit_message(3, pw.emit_message(1, sid) + sub)


def decode_submap_record(buf: bytes, device="cuda") -> dict:
    """Submap proto bytes -> dict of the id and the port submap's parts,
    its grids on `device`."""
    fd = pw.fields_to_dict(buf)
    sid = pw.fields_to_dict(pw.first(fd, 1, b""))
    out = {"trajectory_id": int(pw.first(sid, 1, 0)), "submap_index": int(pw.first(sid, 2, 0))}
    if 2 in fd:  # Submap2D
        sd = pw.fields_to_dict(fd[2][0])
        out["kind"] = "2d"
        out["grid"] = decode_grid_2d(pw.first(sd, 4, b""), device)
    elif 3 in fd:  # Submap3D
        sd = pw.fields_to_dict(fd[3][0])
        out["kind"] = "3d"
        for key, tsdf, occupancy in (("high_grid", 7, 4), ("low_grid", 8, 5)):
            if tsdf in sd:
                out[key] = decode_hybrid_tsdf(sd[tsdf][0], device)
            elif occupancy in sd:
                out[key] = decode_hybrid_occupancy(sd[occupancy][0], device)
        out["histogram"] = pw.repeated_floats(sd, 6)
    else:
        return out
    out["local_pose"] = pw.decode_rigid3d(pw.first(sd, 1, b""))
    out["num_range_data"] = int(pw.first(sd, 2, 0))
    out["finished"] = bool(int(pw.first(sd, 3, 0)))
    return out


def encode_node_record(trajectory_id: int, node_index: int, node) -> bytes:
    """SerializedData{node=4} record bytes from a PgNode."""
    nid = pw.emit_int(1, trajectory_id) + pw.emit_int(2, node_index)
    data = pw.emit_int(1, seconds_to_ticks(node.time))
    if node.gravity_alignment is not None:
        data += pw.emit_message(2, pw.encode_quaterniond(np.asarray(node.gravity_alignment)))
    for field, cloud in ((3, node.cloud), (4, node.high_cloud), (5, node.low_cloud)):
        if cloud is not None:
            data += pw.emit_message(field, encode_compressed_cloud(_valid_points(cloud)))
    if node.histogram is not None:
        data += pw.emit_bytes(6, pw.encode_packed_floats(np.asarray(node.histogram)))
    data += pw.emit_message(7, pw.encode_rigid3d(node.local_pose))
    return pw.emit_message(4, pw.emit_message(1, nid) + pw.emit_message(5, data))


def decode_node_record(buf: bytes) -> dict:
    fd = pw.fields_to_dict(buf)
    nid = pw.fields_to_dict(pw.first(fd, 1, b""))
    out = {"trajectory_id": int(pw.first(nid, 1, 0)), "node_index": int(pw.first(nid, 2, 0))}
    nd = pw.fields_to_dict(pw.first(fd, 5, b""))
    out["time"] = ticks_to_seconds(int(pw.first(nd, 1, 0)))
    if 2 in nd:
        out["gravity_alignment"] = pw.decode_quaterniond(nd[2][0])
    for field, key in ((3, "cloud"), (4, "high_cloud"), (5, "low_cloud")):
        if field in nd:
            out[key] = decode_compressed_cloud(nd[field][0])
    hist = pw.repeated_floats(nd, 6)
    if hist.size:
        out["histogram"] = hist
    if 7 in nd:
        out["local_pose"] = pw.decode_rigid3d(nd[7][0])
    return out


# ---------------------------------------------------------------------------
# Whole-state write / load
# ---------------------------------------------------------------------------


def _per_trajectory_indices(items) -> List[Tuple[int, int]]:
    """(trajectory_id, index within the trajectory) of each node or submap:
    the reference's NodeId / SubmapId are per trajectory, the port's lists
    global."""
    out, counters = [], {}
    for item in items:
        k = counters.get(item.trajectory_id, 0)
        out.append((item.trajectory_id, k))
        counters[item.trajectory_id] = k + 1
    return out


def write_pbstream_state(pose_graph, path: str) -> None:
    """Serialize the pose graph into the reference's pbstream layout (ref:
    mapping_state_serialization.cc WritePbStream record order), under the
    pose graph's host lock as JAX holds it."""
    with pose_graph._lock:
        _write_pbstream_state_locked(pose_graph, path)


def _write_pbstream_state_locked(pose_graph, path: str) -> None:
    node_tid_idx = _per_trajectory_indices(pose_graph.nodes)
    submap_tid_idx = _per_trajectory_indices(pose_graph.submaps)

    state = PbState(format_version=2)
    for c in pose_graph.constraints:
        st, si = submap_tid_idx[c.submap_index]
        nt, ni = node_tid_idx[c.node_index]
        state.constraints.append(PbConstraint(
            submap_trajectory_id=st, submap_index=si, node_trajectory_id=nt, node_index=ni, relative_pose=c.zbar,
            translation_weight=c.translation_weight, rotation_weight=c.rotation_weight,
            tag="INTER_SUBMAP" if c.tag == "INTER" else "INTRA_SUBMAP"))
    for (tid, idx), node in zip(node_tid_idx, pose_graph.nodes):
        state.nodes.append(PbNodePose(trajectory_id=tid, node_index=idx, timestamp=seconds_to_ticks(node.time),
                                      pose=node.global_pose))
    for (tid, idx), s in zip(submap_tid_idx, pose_graph.submaps):
        state.submap_poses.append({"trajectory_id": tid, "submap_index": idx, "pose": s.global_pose})
    for name, pose in getattr(pose_graph, "_landmark_poses", {}).items():
        state.landmark_poses[name] = pose

    records = [pw.emit_int(1, 2)]  # SerializationHeader{format_version: 2}
    records.append(pw.emit_message(1, encode_pose_graph(state)))
    # AllTrajectoryBuilderOptions: one (empty) entry per trajectory; the
    # deserializer CHECKs the count (ref: proto_stream_deserializer.cc).
    tids = sorted({t for t, _ in node_tid_idx} | {t for t, _ in submap_tid_idx})
    records.append(pw.emit_message(2, b"".join(pw.emit_message(1, b"") for _ in tids)))
    for (tid, idx), s in zip(submap_tid_idx, pose_graph.submaps):
        records.append(encode_submap_record(tid, idx, s))
    for (tid, idx), node in zip(node_tid_idx, pose_graph.nodes):
        records.append(encode_node_record(tid, idx, node))
    if hasattr(pose_graph, "_histogram_size"):  # 3D: TrajectoryData records
        for tid in tids:
            records.append(pw.emit_message(5, pw.emit_int(1, tid) + pw.emit_double(2, 9.806)))
    write_records(path, records)


def sniff_dim(path: str) -> int:
    """2 or 3: the dimensionality of a pbstream state's submaps (decides
    which pose-graph class to instantiate, like map_builder.cc dispatches
    on the options' use_trajectory_builder_3d). A stream with no submap
    reads as 2D, as in the JAX package (pbstream_state.py:672)."""
    for i, record in enumerate(read_records(path)):
        if i == 0:
            continue
        fd = pw.fields_to_dict(record)
        for fieldno in fd:
            if SERIALIZED_DATA_KINDS.get(fieldno) == "submap":
                sub = pw.fields_to_dict(fd[fieldno][0])
                if 3 in sub:
                    return 3
                if 2 in sub:
                    return 2
    return 2


def load_pbstream_state(pose_graph, path: str, load_frozen_state: bool = True) -> Dict[int, int]:
    """Load a reference-format pbstream state into the port's pose graph,
    its grids and clouds on the pose graph's device (ref: map_builder.cc
    LoadState:227-404: trajectory remapping, node and submap replay,
    constraints re-added, FreezeTrajectory). Returns the trajectory id
    remap {serialized: new}."""
    device = pose_graph._device
    pg_state = PbState()
    submaps: List[dict] = []
    nodes: List[dict] = []
    for i, record in enumerate(read_records(path)):
        fd = pw.fields_to_dict(record)
        if i == 0:
            pg_state.format_version = int(pw.first(fd, 1, 0))
            continue
        for fieldno in fd:
            kind = SERIALIZED_DATA_KINDS.get(fieldno)
            if kind == "pose_graph":
                _decode_pose_graph(fd[fieldno][0], pg_state)
            elif kind == "submap":
                submaps.append(decode_submap_record(fd[fieldno][0], device))
            elif kind == "node":
                nodes.append(decode_node_record(fd[fieldno][0]))

    node_pose = {(n.trajectory_id, n.node_index): n for n in pg_state.nodes}
    submap_pose = {(s["trajectory_id"], s["submap_index"]): s["pose"] for s in pg_state.submap_poses}

    with pose_graph._lock:
        old_ids = sorted({s["trajectory_id"] for s in submaps} | {n["trajectory_id"] for n in nodes})
        base = max(pose_graph._trajectory_states.keys(), default=-1) + 1
        remap = {old: base + i for i, old in enumerate(old_ids)}

        node_global_index: Dict[Tuple[int, int], int] = {}
        for nd in sorted(nodes, key=lambda d: (d["trajectory_id"], d["node_index"])):
            pose_entry = node_pose.get((nd["trajectory_id"], nd["node_index"]))
            global_pose = pose_entry.pose if pose_entry else nd.get("local_pose", NpRigid3.identity())
            clouds = {key: _cloud_to_padded(nd[key], device) if key in nd else None
                      for key in ("cloud", "high_cloud", "low_cloud")}
            node = PgNode(
                time=nd["time"],
                local_pose=nd.get("local_pose", global_pose),
                global_pose=global_pose,
                trajectory_id=remap[nd["trajectory_id"]],
                histogram=nd.get("histogram"),
                gravity_alignment=nd.get("gravity_alignment"),
                **clouds,
            )
            node.node_id = pose_graph._next_node_id
            pose_graph._next_node_id += 1
            node_global_index[(nd["trajectory_id"], nd["node_index"])] = len(pose_graph.nodes)
            pose_graph._node_index_by_id[node.node_id] = len(pose_graph.nodes)
            pose_graph.nodes.append(node)

        submap_global_index: Dict[Tuple[int, int], int] = {}
        for sd in sorted(submaps, key=lambda d: (d["trajectory_id"], d["submap_index"])):
            # Decoded grids are in the submap frame. The matcher and zbar
            # math are frame-consistent with an identity local_pose:
            # node_in_grid = local_pose o (submap_global^-1 o node_global)
            # = node-in-submap, and zbar = local_pose^-1 o refined =
            # node-in-submap. This also takes reference maps whose
            # local_pose carries the gravity-alignment rotation
            # (submap_3d.cc), which a dense axis-aligned array could not
            # rebase without resampling.
            if sd["kind"] == "3d":
                submap = Submap3D(
                    local_pose=NpRigid3.identity(),
                    high_resolution_grid=sd["high_grid"],
                    low_resolution_grid=sd["low_grid"],
                    rotational_histogram=np.asarray(sd["histogram"], np.float32),
                    num_range_data=sd["num_range_data"],
                    insertion_finished=sd["finished"],
                )
            else:
                submap = Submap2D(local_pose=NpRigid3.identity(), grid=sd["grid"], num_range_data=sd["num_range_data"],
                                  insertion_finished=sd["finished"])
            pg_submap = PgSubmap(
                submap=submap,
                global_pose=submap_pose.get((sd["trajectory_id"], sd["submap_index"]), sd["local_pose"]),
                trajectory_id=remap[sd["trajectory_id"]],
                finished=sd["finished"],
            )
            pg_submap.submap_id = pose_graph._next_submap_id
            pose_graph._next_submap_id += 1
            submap_global_index[(sd["trajectory_id"], sd["submap_index"])] = len(pose_graph.submaps)
            pose_graph._submap_index_by_id[pg_submap.submap_id] = len(pose_graph.submaps)
            pose_graph._submap_ids[id(submap)] = len(pose_graph.submaps)
            pose_graph.submaps.append(pg_submap)

        for c in pg_state.constraints:
            si = submap_global_index.get((c.submap_trajectory_id, c.submap_index))
            ni = node_global_index.get((c.node_trajectory_id, c.node_index))
            if si is None or ni is None:
                continue
            pose_graph.constraints.append(Constraint(
                submap_index=si, node_index=ni, zbar=c.relative_pose, translation_weight=c.translation_weight,
                rotation_weight=c.rotation_weight, tag="INTER" if c.tag == "INTER_SUBMAP" else "INTRA"))

        for new in remap.values():
            pose_graph._trajectory_states[new] = (TrajectoryState.FROZEN if load_frozen_state
                                                  else TrajectoryState.FINISHED)
    return remap
