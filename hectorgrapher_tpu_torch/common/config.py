"""Typed configuration tree.

TPU-native replacement for the reference's Lua -> LuaParameterDictionary ->
option-proto pipeline (ref: cartographer/common/lua_parameter_dictionary.h,
configuration_files/*.lua). Parameter names and defaults mirror the Lua
files one-to-one so reference configurations translate directly; the loader
accepts nested dicts (e.g. parsed from JSON/TOML or hand-written) and
reports unknown keys, mirroring the reference's unused-key checking
(lua_parameter_dictionary.h:120).

All classes are frozen dataclasses; `replace_deep(cfg, {"a.b": v})` or
`from_dict` produce modified copies.

Counterpart of hectorgrapher_tpu/common/config.py: the 2D trajectory
builder's options only, with the same field names and defaults.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Dict, Mapping


def _mkdefault(cls):
    return field(default_factory=cls)


# ---------------------------------------------------------------------------
# Shared sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SolverOptions:
    """(ref: common/ceres_solver_options.h; we run a damped GN/LM instead)."""

    use_nonmonotonic_steps: bool = False
    max_num_iterations: int = 20
    num_threads: int = 1  # ignored on TPU; kept for config parity


@dataclass(frozen=True)
class AdaptiveVoxelFilterOptions:
    """(ref: sensor/internal/adaptive_voxel_filter.h, proto
    sensor/proto/adaptive_voxel_filter_options.proto)"""

    max_length: float = 0.5
    min_num_points: int = 200
    max_range: float = 50.0


@dataclass(frozen=True)
class RealTimeCorrelativeScanMatcherOptions:
    """(ref: mapping/internal/scan_matching/real_time_correlative_scan_matcher.h)"""

    linear_search_window: float = 0.1
    angular_search_window: float = math.radians(20.0)
    translation_delta_cost_weight: float = 1e-1
    rotation_delta_cost_weight: float = 1e-1


@dataclass(frozen=True)
class MotionFilterOptions:
    """(ref: mapping/internal/motion_filter.h)"""

    max_time_seconds: float = 5.0
    max_distance_meters: float = 0.2
    max_angle_radians: float = math.radians(1.0)


# ---------------------------------------------------------------------------
# 2D trajectory builder
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CeresScanMatcher2DOptions:
    """(ref: internal/2d/scan_matching/ceres_scan_matcher_2d.h)"""

    occupied_space_weight: float = 1.0
    translation_weight: float = 10.0
    rotation_weight: float = 40.0
    ceres_solver_options: SolverOptions = field(default_factory=lambda: SolverOptions(max_num_iterations=20))


@dataclass(frozen=True)
class NormalEstimationOptions2D:
    """(ref: internal/2d/normal_estimation_2d.h)"""

    num_normal_samples: int = 4
    sample_radius: float = 0.5


@dataclass(frozen=True)
class ProbabilityGridRangeDataInserterOptions2D:
    """(ref: 2d/probability_grid_range_data_inserter_2d.h)"""

    insert_free_space: bool = True
    hit_probability: float = 0.55
    miss_probability: float = 0.49


@dataclass(frozen=True)
class TSDFRangeDataInserterOptions2D:
    """(ref: 2d/tsdf_range_data_inserter_2d.h)"""

    truncation_distance: float = 0.3
    maximum_weight: float = 10.0
    update_free_space: bool = False
    normal_estimation_options: NormalEstimationOptions2D = _mkdefault(NormalEstimationOptions2D)
    project_sdf_distance_to_scan_normal: bool = True
    update_weight_range_exponent: int = 0
    update_weight_angle_scan_normal_to_ray_kernel_bandwidth: float = 0.5
    update_weight_distance_cell_to_hit_kernel_bandwidth: float = 0.5


@dataclass(frozen=True)
class RangeDataInserterOptions2D:
    range_data_inserter_type: str = "PROBABILITY_GRID_INSERTER_2D"
    probability_grid_range_data_inserter: ProbabilityGridRangeDataInserterOptions2D = _mkdefault(
        ProbabilityGridRangeDataInserterOptions2D
    )
    tsdf_range_data_inserter: TSDFRangeDataInserterOptions2D = _mkdefault(TSDFRangeDataInserterOptions2D)


@dataclass(frozen=True)
class GridOptions2D:
    grid_type: str = "PROBABILITY_GRID"
    resolution: float = 0.05


@dataclass(frozen=True)
class SubmapsOptions2D:
    """(ref: 2d/submap_2d.h; grid extent is TPU-specific: dense fixed arrays)"""

    num_range_data: int = 90
    grid_options_2d: GridOptions2D = _mkdefault(GridOptions2D)
    range_data_inserter: RangeDataInserterOptions2D = _mkdefault(RangeDataInserterOptions2D)
    # TPU-native: submap grids are fixed-extent dense arrays (cells per side).
    grid_size: int = 512
    # "float32" | "uint16" (reference-parity quantized storage, applied when
    # a submap finishes; ref: probability_values.h:64-92,
    # tsd_value_converter.h:33-73). TSDF grids additionally accept
    # "float16"/"bfloat16" active storage.
    grid_storage_dtype: str = "float32"


@dataclass(frozen=True)
class TrajectoryBuilder2DOptions:
    """(ref: configuration_files/trajectory_builder_2d.lua)"""

    use_imu_data: bool = True
    min_range: float = 0.0
    max_range: float = 30.0
    min_z: float = -0.8
    max_z: float = 2.0
    missing_data_ray_length: float = 5.0
    num_accumulated_range_data: int = 1
    voxel_filter_size: float = 0.025
    adaptive_voxel_filter: AdaptiveVoxelFilterOptions = _mkdefault(AdaptiveVoxelFilterOptions)
    loop_closure_adaptive_voxel_filter: AdaptiveVoxelFilterOptions = field(
        default_factory=lambda: AdaptiveVoxelFilterOptions(max_length=0.9, min_num_points=100, max_range=50.0)
    )
    use_online_correlative_scan_matching: bool = False
    real_time_correlative_scan_matcher: RealTimeCorrelativeScanMatcherOptions = _mkdefault(
        RealTimeCorrelativeScanMatcherOptions
    )
    ceres_scan_matcher: CeresScanMatcher2DOptions = _mkdefault(CeresScanMatcher2DOptions)
    motion_filter: MotionFilterOptions = _mkdefault(MotionFilterOptions)
    imu_gravity_time_constant: float = 10.0
    submaps: SubmapsOptions2D = _mkdefault(SubmapsOptions2D)
    # TPU-native: fixed device batch size for filtered clouds (padding cap).
    max_num_points: int = 2048


# ---------------------------------------------------------------------------
# dict loading / deep replace
# ---------------------------------------------------------------------------


def from_dict(cls, data: Mapping[str, Any]):
    """Build a config dataclass from a nested dict; unknown keys raise
    (mirrors the reference's unused-key check)."""
    if not is_dataclass(cls):
        raise TypeError(f"{cls} is not a config dataclass")
    return merge(cls(), data)


def merge(cfg, overrides: Mapping[str, Any]):
    """Return cfg with nested overrides from a dict applied."""
    kwargs: Dict[str, Any] = {}
    names = {f.name for f in fields(cfg)}
    for key, value in overrides.items():
        if key not in names:
            raise KeyError(f"unknown config key {key!r} for {type(cfg).__name__}")
        current = getattr(cfg, key)
        if isinstance(value, Mapping):
            if not is_dataclass(current):
                raise TypeError(f"config key {key!r} of {type(cfg).__name__} is not a nested config")
            kwargs[key] = merge(current, value)
        else:
            kwargs[key] = value
    return dataclasses.replace(cfg, **kwargs)


def replace_deep(cfg, dotted: Mapping[str, Any]):
    """Apply {"a.b.c": value} style overrides."""
    nested: Dict[str, Any] = {}
    for dotted_key, value in dotted.items():
        parts = dotted_key.split(".")
        cursor = nested
        for part in parts[:-1]:
            cursor = cursor.setdefault(part, {})
        cursor[parts[-1]] = value
    return merge(cfg, nested)
