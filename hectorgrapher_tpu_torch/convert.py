"""Carries state of the JAX package (hectorgrapher_tpu) into the port's types.

Every JAX value is read as a numpy array (np.asarray), so this module
needs neither jax nor hectorgrapher_tpu: it works on any object with the
same field names. Options are rebuilt by field name from
dataclasses.asdict of the JAX option dataclasses.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hectorgrapher_tpu_torch.common import config
from hectorgrapher_tpu_torch.mapping.ct.window_solver import CtProblem, CtState, CtWeights
from hectorgrapher_tpu_torch.mapping.grids import GridMeta, ProbabilityGrid, TSDFGrid
from hectorgrapher_tpu_torch.mapping.pose_graph.optimization import SpaExtras3D, SpaProblem3D
from hectorgrapher_tpu_torch.mapping.pose_graph.pose_graph import PgNode
from hectorgrapher_tpu_torch.mapping.submap_3d import Submap3D
from hectorgrapher_tpu_torch.sensor.types import PointCloud, RangeData, TimedPointCloud
from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3
from hectorgrapher_tpu_torch.transform.rigid import Rigid2


def tensor(x, device, dtype=None) -> torch.Tensor:
    """A numpy-convertible array as a tensor on device."""
    t = torch.from_numpy(np.array(x, copy=True))
    return t.to(device=device, dtype=dtype) if dtype is not None else t.to(device)


def grid_meta(meta, device) -> GridMeta:
    return GridMeta(
        resolution=tensor(meta.resolution, device, torch.float32),
        min_corner=tensor(meta.min_corner, device, torch.float32),
    )


def _f32_or_u16(x, device) -> torch.Tensor:
    """A grid plane: uint16 codes stay codes, anything else becomes f32."""
    a = np.asarray(x)
    return tensor(a, device, torch.uint16 if a.dtype == np.uint16 else torch.float32)


def probability_grid(grid, device) -> ProbabilityGrid:
    """A JAX ProbabilityGrid, 2D or 3D (f32 log_odds or uint16 codes, bool
    known, meta)."""
    return ProbabilityGrid(
        log_odds=_f32_or_u16(grid.log_odds, device),
        known=tensor(grid.known, device, torch.bool),
        meta=grid_meta(grid.meta, device),
    )


def tsdf_grid(grid, device) -> TSDFGrid:
    """A JAX TSDFGrid: float32 storage, or uint16 codes as they are."""
    return TSDFGrid(
        tsd=_f32_or_u16(grid.tsd, device),
        weight=_f32_or_u16(grid.weight, device),
        truncation_distance=tensor(grid.truncation_distance, device, torch.float32),
        max_weight=tensor(grid.max_weight, device, torch.float32),
        meta=grid_meta(grid.meta, device),
    )


def _named_tuple(cls, value, device):
    """cls with every field of `value` as a tensor: bool and integer arrays
    keep their kind (integers as int64), the rest become float32."""
    out = {}
    for name in cls._fields:
        a = np.asarray(getattr(value, name))
        dtype = torch.bool if a.dtype == bool else torch.int64 if a.dtype.kind in "iu" else torch.float32
        out[name] = tensor(a, device, dtype)
    return cls(**out)


def ct_state(state, device) -> CtState:
    return _named_tuple(CtState, state, device)


def ct_problem(problem, device) -> CtProblem:
    return _named_tuple(CtProblem, problem, device)


def ct_weights(weights, device) -> CtWeights:
    return _named_tuple(CtWeights, weights, device)


def timed_point_cloud(cloud, device) -> TimedPointCloud:
    """A timed cloud with tensor leaves, for the device-side timed filters."""
    return TimedPointCloud(
        positions=tensor(cloud.positions, device, torch.float32),
        times=tensor(cloud.times, device, torch.float32),
        mask=tensor(cloud.mask, device, torch.bool),
    )


def point_cloud(cloud, device) -> PointCloud:
    return PointCloud(
        positions=tensor(cloud.positions, device, torch.float32),
        mask=tensor(cloud.mask, device, torch.bool),
    )


def np_rigid3(pose) -> NpRigid3:
    """A host pose (float64 t, q) of either package."""
    return NpRigid3(np.array(pose.t, np.float64), np.array(pose.q, np.float64))


def grid_3d(grid, device):
    """A JAX 3D submap grid of either type (ProbabilityGrid or TSDFGrid,
    told apart by their fields)."""
    return probability_grid(grid, device) if hasattr(grid, "log_odds") else tsdf_grid(grid, device)


def submap_3d(submap, device) -> Submap3D:
    """A JAX Submap3D, finished or not, with grids of either type, f32 or
    uint16-quantized."""
    return Submap3D(
        local_pose=np_rigid3(submap.local_pose),
        high_resolution_grid=grid_3d(submap.high_resolution_grid, device),
        low_resolution_grid=grid_3d(submap.low_resolution_grid, device),
        rotational_histogram=np.array(submap.rotational_histogram, np.float32),
        num_range_data=int(submap.num_range_data),
        insertion_finished=bool(submap.insertion_finished),
        quantize_on_finish=bool(getattr(submap, "quantize_on_finish", False)),
    )


def pg_node(node, device) -> PgNode:
    """A JAX 3D pose-graph node, its loop-closure clouds on device."""
    return PgNode(
        time=float(node.time),
        local_pose=np_rigid3(node.local_pose),
        global_pose=np_rigid3(node.global_pose),
        trajectory_id=int(node.trajectory_id),
        high_cloud=point_cloud(node.high_cloud, device),
        low_cloud=point_cloud(node.low_cloud, device),
        histogram=np.array(node.histogram, np.float32),
        gravity_alignment=None if node.gravity_alignment is None else np.array(node.gravity_alignment),
        node_id=int(node.node_id),
    )


def spa_problem_3d(problem, device) -> SpaProblem3D:
    return _named_tuple(SpaProblem3D, problem, device)


def spa_extras_3d(extras, device) -> SpaExtras3D:
    return _named_tuple(SpaExtras3D, extras, device)


def pyramid_levels(levels, device):
    """A JAX FastCorrelativeScanMatcher3D's flat level tables (f32, unpaired)."""
    return tuple(tensor(t, device, torch.float32).contiguous() for t in levels)


def rigid2(pose, device) -> Rigid2:
    return Rigid2(
        translation=tensor(pose.translation, device, torch.float32),
        angle=tensor(pose.angle, device, torch.float32),
    )


def range_data(rd, device) -> RangeData:
    return RangeData(
        origin=tensor(rd.origin, device, torch.float32),
        returns=point_cloud(rd.returns, device),
        misses=point_cloud(rd.misses, device),
        width=int(rd.width),
    )


def options(jax_options):
    """The port's option dataclass of the same class name, with every field
    taken from the JAX options (nested options included)."""
    cls = getattr(config, type(jax_options).__name__)
    return config.from_dict(cls, dataclasses.asdict(jax_options))
