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
from hectorgrapher_tpu_torch.mapping.pose_graph.optimization import SpaExtras2D, SpaExtras3D, SpaProblem2D, SpaProblem3D
from hectorgrapher_tpu_torch.mapping.pose_graph.pose_graph import PgNode
from hectorgrapher_tpu_torch.mapping.scan_matching.fast_correlative_2d import PreparedFastMatcher2D
from hectorgrapher_tpu_torch.mapping.submap_2d import Submap2D
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


def _grid_plane(x, device) -> torch.Tensor:
    """A grid plane in its storage dtype, bit for bit: uint16 codes stay
    codes, float16 stays float16, bfloat16 (numpy's ml_dtypes.bfloat16)
    becomes torch.bfloat16 through a uint16 view; anything else f32."""
    a = np.asarray(x)
    if a.dtype == np.uint16:
        return tensor(a, device, torch.uint16)
    if a.dtype == np.float16:
        return tensor(a, device, torch.float16)
    if a.dtype.name == "bfloat16":
        return tensor(a.view(np.uint16), device).view(torch.bfloat16)
    return tensor(a, device, torch.float32)


def probability_grid(grid, device) -> ProbabilityGrid:
    """A JAX ProbabilityGrid, 2D or 3D (f32 log_odds or uint16 codes, bool
    known, meta)."""
    return ProbabilityGrid(
        log_odds=_grid_plane(grid.log_odds, device),
        known=tensor(grid.known, device, torch.bool),
        meta=grid_meta(grid.meta, device),
    )


def tsdf_grid(grid, device) -> TSDFGrid:
    """A JAX TSDFGrid in its storage dtype: float32, float16 or bfloat16
    planes, or uint16 codes, as they are."""
    return TSDFGrid(
        tsd=_grid_plane(grid.tsd, device),
        weight=_grid_plane(grid.weight, device),
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
    """A JAX submap grid of either type (ProbabilityGrid or TSDFGrid, told
    apart by their fields), 3D or 2D, in its storage dtype."""
    return probability_grid(grid, device) if hasattr(grid, "log_odds") else tsdf_grid(grid, device)


grid_2d = grid_3d  # 2D grids have the same fields


def submap_3d(submap, device) -> Submap3D:
    """A JAX Submap3D, finished or not, with grids of either type in their
    storage dtype (f32, f16 or bf16 TSDF planes, or uint16 codes)."""
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
    """A JAX pose-graph node, its loop-closure clouds on device: a 3D
    node's high and low clouds and histogram, or a 2D node's cloud."""
    is_2d = getattr(node, "cloud", None) is not None
    return PgNode(
        time=float(node.time),
        local_pose=np_rigid3(node.local_pose),
        global_pose=np_rigid3(node.global_pose),
        trajectory_id=int(node.trajectory_id),
        cloud=point_cloud(node.cloud, device) if is_2d else None,
        high_cloud=None if is_2d else point_cloud(node.high_cloud, device),
        low_cloud=None if is_2d else point_cloud(node.low_cloud, device),
        histogram=None if is_2d else np.array(node.histogram, np.float32),
        gravity_alignment=None if node.gravity_alignment is None else np.array(node.gravity_alignment),
        node_id=int(node.node_id),
    )


def spa_problem_3d(problem, device) -> SpaProblem3D:
    return _named_tuple(SpaProblem3D, problem, device)


def spa_extras_3d(extras, device) -> SpaExtras3D:
    return _named_tuple(SpaExtras3D, extras, device)


def spa_problem_2d(problem, device) -> SpaProblem2D:
    return _named_tuple(SpaProblem2D, problem, device)


def spa_extras_2d(extras, device) -> SpaExtras2D:
    return _named_tuple(SpaExtras2D, extras, device)


def prepared_fast_matcher_2d(prepared, device) -> PreparedFastMatcher2D:
    """A JAX PreparedFastMatcher2D (its CPU branch's f32 levels)."""
    return PreparedFastMatcher2D(
        flat_levels=tensor(prepared.flat_levels, device, torch.float32).contiguous(),
        meta=grid_meta(prepared.meta, device),
        dims=tuple(int(v) for v in np.asarray(prepared.dims)),
    )


def submap_2d(submap, device) -> Submap2D:
    """A JAX Submap2D, finished or not, over a grid of either type in its
    storage dtype (f32 probabilities or uint16 codes; f32, f16 or bf16 TSDF
    planes, or uint16 codes)."""
    return Submap2D(
        local_pose=np_rigid3(submap.local_pose),
        grid=grid_2d(submap.grid, device),
        num_range_data=int(submap.num_range_data),
        insertion_finished=bool(submap.insertion_finished),
        quantize_on_finish=bool(getattr(submap, "quantize_on_finish", False)),
    )


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
