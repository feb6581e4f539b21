"""Uplink payloads of local SLAM results and the uplink's submap control
(counterpart of hectorgrapher_tpu/cloud/local_slam_result.py).

A serving MapBuilderServer runs local SLAM and uploads *results*: node
data and insertion submaps, not raw sensor data; the uplink injects them
past local SLAM straight into its pose graph (ref:
cloud/internal/sensor/serialization.cc
CreateSensorDataForLocalSlamResult:80-100,
mapping/internal/global_trajectory_builder.cc AddLocalSlamResultData:118-123).

Grid arrays ride along only when the submap is finished
(serialization.cc:93); an unfinished submap uploads its metadata, which
the uplink's SubmapController instantiates with empty grids and fills
from the finishing update (ref: mapping/internal/submap_controller.h:29-60).

Payloads are numpy throughout (the wire whitelists no tensor): grids and
node clouds leave the card here (_pack_grid, make_local_slam_result_payload)
and come back onto `device` on the uplink (_unpack_grid, through
convert.py's grid builders).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from hectorgrapher_tpu_torch import convert
from hectorgrapher_tpu_torch.mapping.grids import TSDFGrid, plane_to_numpy
from hectorgrapher_tpu_torch.mapping.submap_2d import Submap2D
from hectorgrapher_tpu_torch.mapping.submap_3d import Submap3D
from hectorgrapher_tpu_torch.sensor.types import PointCloud
from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3


class SubmapPayload(NamedTuple):
    """One insertion submap as shipped to the uplink
    (ref: mapping/proto/serialization.proto Submap + submap_id)."""

    submap_index: int  # per-trajectory stable index (SubmapId.submap_index)
    kind: str  # "2d" | "3d"
    insertion_finished: bool
    num_range_data: int
    local_pose_t: np.ndarray
    local_pose_q: np.ndarray
    # Grid dicts: metadata always, arrays only when insertion_finished.
    grid: Optional[dict] = None  # 2d
    high_grid: Optional[dict] = None  # 3d
    low_grid: Optional[dict] = None  # 3d
    rotational_histogram: Optional[np.ndarray] = None  # 3d, finished only


class LocalSlamResultPayload(NamedTuple):
    """(ref: serialization.proto LocalSlamResultData: timestamp,
    TrajectoryNodeData, repeated Submap.) Clouds are PointClouds with
    numpy leaves."""

    time: float
    local_pose_t: np.ndarray
    local_pose_q: np.ndarray
    dim: str  # "2d" | "3d"
    cloud: Optional[PointCloud] = None  # 2D gravity-aligned filtered cloud
    high_cloud: Optional[PointCloud] = None  # 3D
    low_cloud: Optional[PointCloud] = None
    histogram: Optional[np.ndarray] = None
    gravity_alignment: Optional[np.ndarray] = None
    submaps: Tuple[SubmapPayload, ...] = ()


# -- grid packing ------------------------------------------------------------


def _pack_grid(grid, include_arrays: bool) -> dict:
    """A grid's metadata, and with include_arrays its planes, as numpy
    (local_slam_result.py _pack_grid :66-96)."""
    d = {
        "resolution": float(grid.meta.resolution),
        "min_corner": grid.meta.min_corner.cpu().numpy().astype(np.float32),
    }
    if isinstance(grid, TSDFGrid):
        d["type"] = "tsdf"
        d["shape"] = tuple(int(s) for s in grid.tsd.shape)
        d["truncation_distance"] = float(grid.truncation_distance)
        d["max_weight"] = float(grid.max_weight)
        if include_arrays:
            # uint16-quantized grids ship their codes verbatim (the
            # reference uploads uint16 proto cells, submap_3d.cc ToProto).
            d["quantized"] = grid.tsd.dtype == torch.uint16
            d["tsd"] = plane_to_numpy(grid.tsd)
            d["weight"] = plane_to_numpy(grid.weight)
    else:
        d["type"] = "probability"
        d["shape"] = tuple(int(s) for s in grid.log_odds.shape)
        if include_arrays:
            d["quantized"] = grid.log_odds.dtype == torch.uint16
            d["log_odds"] = plane_to_numpy(grid.log_odds)
            d["known"] = grid.known.cpu().numpy()
    return d


def _unpack_grid(d: dict, device="cuda"):
    """A packed grid on `device` (local_slam_result.py _unpack_grid
    :98-121): uint16 codes as they are, float planes as float32; a grid
    packed without arrays comes back empty (tsd at the truncation
    distance, weight 0; log-odds 0, nothing known)."""
    shape = tuple(d["shape"])
    dt = np.uint16 if d.get("quantized") else np.float32
    meta = SimpleNamespace(resolution=np.float32(d["resolution"]), min_corner=np.asarray(d["min_corner"], np.float32))
    if d["type"] == "tsdf":
        trunc = d["truncation_distance"]
        return convert.tsdf_grid(SimpleNamespace(
            tsd=np.asarray(d.get("tsd", np.full(shape, trunc, np.float32)), dt),
            weight=np.asarray(d.get("weight", np.zeros(shape, np.float32)), dt),
            truncation_distance=np.float32(trunc),
            max_weight=np.float32(d["max_weight"]),
            meta=meta,
        ), device)
    return convert.probability_grid(SimpleNamespace(
        log_odds=np.asarray(d.get("log_odds", np.zeros(shape, np.float32)), dt),
        known=np.asarray(d.get("known", np.zeros(shape, bool))),
        meta=meta,
    ), device)


def _fill_grid(grid, d: dict, device="cuda"):
    """A placeholder grid's planes replaced from a finishing update
    (local_slam_result.py _fill_grid :124-135); its metadata stays."""
    filled = _unpack_grid(d, device)
    if isinstance(grid, TSDFGrid):
        return grid._replace(tsd=filled.tsd, weight=filled.weight)
    return grid._replace(log_odds=filled.log_odds, known=filled.known)


def _cloud_to_numpy(cloud: PointCloud) -> PointCloud:
    return PointCloud(positions=cloud.positions.cpu().numpy(), mask=cloud.mask.cpu().numpy())


def _numpy_or_none(x) -> Optional[np.ndarray]:
    return None if x is None else np.asarray(x)


# -- payload construction (serving server side) -------------------------------


def make_local_slam_result_payload(result, use_3d: bool, starting_submap_index: int) -> LocalSlamResultPayload:
    """An insertion result packaged for upload (ref: serialization.cc
    CreateSensorDataForLocalSlamResult:80-100: submap_index is
    starting_submap_index + position; grid arrays only for finished
    submaps)."""
    ir = result.insertion_result
    submaps = []
    for i, submap in enumerate(ir.insertion_submaps):
        finished = bool(submap.insertion_finished)
        common = dict(
            submap_index=starting_submap_index + i,
            insertion_finished=finished,
            num_range_data=int(submap.num_range_data),
            local_pose_t=np.asarray(submap.local_pose.t, np.float64),
            local_pose_q=np.asarray(submap.local_pose.q, np.float64),
        )
        if use_3d:
            submaps.append(SubmapPayload(
                kind="3d",
                high_grid=_pack_grid(submap.high_resolution_grid, finished),
                low_grid=_pack_grid(submap.low_resolution_grid, finished),
                rotational_histogram=np.asarray(submap.rotational_histogram) if finished else None,
                **common,
            ))
        else:
            submaps.append(SubmapPayload(kind="2d", grid=_pack_grid(submap.grid, finished), **common))
    common = dict(
        time=float(result.time),
        local_pose_t=np.asarray(result.local_pose.t, np.float64),
        local_pose_q=np.asarray(result.local_pose.q, np.float64),
        gravity_alignment=_numpy_or_none(ir.gravity_alignment),
        submaps=tuple(submaps),
    )
    if use_3d:
        return LocalSlamResultPayload(
            dim="3d",
            high_cloud=_cloud_to_numpy(ir.high_resolution_cloud),
            low_cloud=_cloud_to_numpy(ir.low_resolution_cloud),
            histogram=np.asarray(ir.rotational_histogram),
            **common,
        )
    return LocalSlamResultPayload(dim="2d", cloud=_cloud_to_numpy(ir.filtered_gravity_aligned_point_cloud), **common)


# -- uplink-side re-instantiation ---------------------------------------------


class SubmapController:
    """Creates and updates submaps from uploaded payloads on the uplink, on
    `device` (ref: mapping/internal/submap_controller.h:29-60 UpdateSubmap:
    create unseen submaps, update known unfinished ones, drop them from
    the unfinished set once the finishing payload arrives)."""

    def __init__(self, device="cuda"):
        self._device = torch.device(device)
        self._unfinished: Dict[Tuple[int, int], object] = {}

    def update_submap(self, trajectory_id: int, payload: SubmapPayload):
        key = (trajectory_id, payload.submap_index)
        existing = self._unfinished.get(key)
        if existing is None:
            local_pose = NpRigid3(payload.local_pose_t, payload.local_pose_q)
            if payload.kind == "3d":
                hist = payload.rotational_histogram
                submap = Submap3D(
                    local_pose=local_pose,
                    high_resolution_grid=_unpack_grid(payload.high_grid, self._device),
                    low_resolution_grid=_unpack_grid(payload.low_grid, self._device),
                    rotational_histogram=np.asarray(hist) if hist is not None else np.zeros(128, np.float32),
                    num_range_data=payload.num_range_data,
                    insertion_finished=payload.insertion_finished,
                )
            else:
                submap = Submap2D(
                    local_pose=local_pose,
                    grid=_unpack_grid(payload.grid, self._device),
                    num_range_data=payload.num_range_data,
                    insertion_finished=payload.insertion_finished,
                )
            if not payload.insertion_finished:
                self._unfinished[key] = submap
            return submap
        # The pose graph holds the same object: flipping insertion_finished
        # here is what its finish detection sees.
        existing.num_range_data = payload.num_range_data
        if payload.insertion_finished:
            if payload.kind == "3d":
                existing.high_resolution_grid = _fill_grid(existing.high_resolution_grid, payload.high_grid,
                                                           self._device)
                existing.low_resolution_grid = _fill_grid(existing.low_resolution_grid, payload.low_grid,
                                                          self._device)
                existing.rotational_histogram = np.asarray(payload.rotational_histogram)
                existing.version += 1
            else:
                existing.grid = _fill_grid(existing.grid, payload.grid, self._device)
            existing.insertion_finished = True
            del self._unfinished[key]
        return existing
