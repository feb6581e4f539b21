"""Typed configuration tree.

Replacement for the reference's Lua -> LuaParameterDictionary ->
option-proto pipeline (ref: cartographer/common/lua_parameter_dictionary.h,
configuration_files/*.lua). Parameter names and defaults mirror the Lua
files one-to-one so reference configurations translate directly; the loader
accepts nested dicts (e.g. parsed from JSON/TOML or hand-written) and
reports unknown keys, mirroring the reference's unused-key checking
(lua_parameter_dictionary.h:120).

All classes are frozen dataclasses; `replace_deep(cfg, {"a.b": v})` or
`from_dict` produce modified copies; common/lua_config.py loads them from
the reference's Lua files.

Counterpart of hectorgrapher_tpu/common/config.py: the same classes, field
names and defaults, and the same merge, from_dict and to_dict.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field, fields, is_dataclass
import typing
from typing import Any, Dict, Mapping, Optional


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
# 3D trajectory builder
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CeresScanMatcher3DOptions:
    """(ref: internal/3d/scan_matching/ceres_scan_matcher_3d.h)"""

    occupied_space_weight_0: float = 1.0
    occupied_space_weight_1: float = 6.0
    translation_weight: float = 5.0
    rotation_weight: float = 4e2
    only_optimize_yaw: bool = False
    ceres_solver_options: SolverOptions = field(default_factory=lambda: SolverOptions(max_num_iterations=12))


@dataclass(frozen=True)
class ProbabilityGridRangeDataInserterOptions3D:
    """(ref: 3d/range_data_inserter_3d.h)"""

    hit_probability: float = 0.55
    miss_probability: float = 0.49
    num_free_space_voxels: int = 2


@dataclass(frozen=True)
class TSDFRangeDataInserterOptions3D:
    """(ref: 3d/tsdf_range_data_inserter_3d.h)"""

    relative_truncation_distance: float = 2.5
    maximum_weight: float = 1000.0
    num_free_space_voxels: int = 0
    project_sdf_distance_to_scan_normal: bool = False
    weight_function_epsilon: float = 1.0
    weight_function_sigma: float = 4.0
    normal_estimate_max_nn: float = 30.0
    normal_estimate_radius: float = 0.4
    normal_computation_method: str = "CLOUD_STRUCTURE"
    min_range: float = 0.4
    max_range: float = 15.0
    insertion_ratio: float = 1.0
    normal_computation_horizontal_stride: int = 5
    normal_computation_vertical_stride: int = 1


@dataclass(frozen=True)
class RangeDataInserterOptions3D:
    range_data_inserter_type: str = "PROBABILITY_GRID_INSERTER_3D"
    probability_grid_range_data_inserter: ProbabilityGridRangeDataInserterOptions3D = _mkdefault(
        ProbabilityGridRangeDataInserterOptions3D
    )
    tsdf_range_data_inserter: TSDFRangeDataInserterOptions3D = _mkdefault(TSDFRangeDataInserterOptions3D)


@dataclass(frozen=True)
class SubmapsOptions3D:
    """(ref: 3d/submap_3d.h + configuration_files/trajectory_builder_3d.lua
    submaps block). Extra: fixed dense grid sizes per resolution."""

    high_resolution: float = 0.10
    high_resolution_max_range: float = 20.0
    low_resolution: float = 0.45
    num_range_data: int = 160
    grid_type: str = "PROBABILITY_GRID"
    high_resolution_range_data_inserter: RangeDataInserterOptions3D = _mkdefault(RangeDataInserterOptions3D)
    low_resolution_range_data_inserter: RangeDataInserterOptions3D = field(
        default_factory=lambda: RangeDataInserterOptions3D(
            tsdf_range_data_inserter=TSDFRangeDataInserterOptions3D(
                min_range=1.0,
                max_range=60.0,
                insertion_ratio=0.1,
                normal_computation_horizontal_stride=20,
                normal_computation_vertical_stride=4,
            )
        )
    )
    # Cells per side of the dense high/low-resolution grids.
    high_grid_size: int = 256
    low_grid_size: int = 128
    # Storage of the dense grids: "float32", "float16" or "bfloat16" (TSDF
    # only), or "uint16" (quantized on finish); compute is always float32.
    grid_storage_dtype: str = "float32"


@dataclass(frozen=True)
class OptimizingLocalTrajectoryBuilderOptions:
    """(ref: configuration_files/trajectory_builder_3d.lua:120-147, proto
    mapping/proto/3d/optimizing_local_trajectory_builder_options.proto)"""

    high_resolution_grid_weight: float = 1.0
    low_resolution_grid_weight: float = 1.0
    velocity_weight: float = 1.0
    translation_weight: float = 1.0
    rotation_weight: float = 1.0
    odometry_translation_weight: float = 1.0
    odometry_rotation_weight: float = 1.0
    initialize_map_orientation_with_imu: bool = True
    calibrate_imu: bool = False
    ct_window_horizon: float = 0.9
    ct_window_rate: float = 0.1
    imu_integrator: str = "RK4"  # EULER | RK4
    imu_cost_term: str = "PREINTEGRATION"  # DIRECT | PREINTEGRATION
    initialization_duration: float = 3.0
    use_adaptive_odometry_weights: bool = True
    use_per_point_unwarping: bool = False
    use_multi_resolution_matching: bool = False
    num_points_per_subdivision: int = 4
    control_point_sampling: str = "CONSTANT"  # CONSTANT | SYNCED_WITH_RANGE_DATA | ADAPTIVE
    sampling_max_delta_translation: float = 0.2
    sampling_max_delta_rotation: float = 0.1
    sampling_min_delta_time: float = 0.025
    sampling_max_delta_time: float = 0.25
    velocity_in_state: bool = True
    odometry_translation_normalization: float = 2.0e-2
    odometry_rotation_normalization: float = 1.0e-1
    # LM solver knobs (in place of the reference's Ceres loop).
    max_num_iterations: int = 12
    initial_lm_lambda: float = 1e-4
    # Static shape caps of the window solve.
    max_control_points: int = 32
    max_clouds_in_window: int = 32
    points_per_cloud: int = 256


@dataclass(frozen=True)
class TrajectoryBuilder3DOptions:
    """(ref: configuration_files/trajectory_builder_3d.lua)"""

    min_range: float = 1.0
    max_range: float = 60.0
    num_accumulated_range_data: int = 1
    voxel_filter_size: float = 0.15
    high_resolution_adaptive_voxel_filter: AdaptiveVoxelFilterOptions = field(
        default_factory=lambda: AdaptiveVoxelFilterOptions(max_length=2.0, min_num_points=150, max_range=15.0)
    )
    low_resolution_adaptive_voxel_filter: AdaptiveVoxelFilterOptions = field(
        default_factory=lambda: AdaptiveVoxelFilterOptions(max_length=4.0, min_num_points=200, max_range=60.0)
    )
    use_online_correlative_scan_matching: bool = False
    real_time_correlative_scan_matcher: RealTimeCorrelativeScanMatcherOptions = field(
        default_factory=lambda: RealTimeCorrelativeScanMatcherOptions(
            linear_search_window=0.15,
            angular_search_window=math.radians(1.0),
        )
    )
    ceres_scan_matcher: CeresScanMatcher3DOptions = _mkdefault(CeresScanMatcher3DOptions)
    motion_filter: MotionFilterOptions = field(
        default_factory=lambda: MotionFilterOptions(
            max_time_seconds=0.5, max_distance_meters=0.1, max_angle_radians=0.004
        )
    )
    imu_gravity_time_constant: float = 10.0
    rotational_histogram_size: int = 120
    submaps: SubmapsOptions3D = _mkdefault(SubmapsOptions3D)
    optimizing_local_trajectory_builder: OptimizingLocalTrajectoryBuilderOptions = _mkdefault(
        OptimizingLocalTrajectoryBuilderOptions
    )


# ---------------------------------------------------------------------------
# Pose graph and map builder
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FastCorrelativeScanMatcherOptions2D:
    """(ref: internal/2d/scan_matching/fast_correlative_scan_matcher_2d.h)"""

    linear_search_window: float = 7.0
    angular_search_window: float = math.radians(30.0)
    branch_and_bound_depth: int = 7


@dataclass(frozen=True)
class FastCorrelativeScanMatcherOptions3D:
    """(ref: internal/3d/scan_matching/fast_correlative_scan_matcher_3d.h)"""

    branch_and_bound_depth: int = 8
    full_resolution_depth: int = 3
    use_rotational_scan_matcher: bool = True
    min_rotational_score: float = 0.77
    min_low_resolution_score: float = 0.55
    linear_xy_search_window: float = 5.0
    linear_z_search_window: float = 1.0
    angular_search_window: float = math.radians(15.0)


@dataclass(frozen=True)
class ConstraintBuilderOptions:
    """(ref: internal/constraints/constraint_builder.h, pose_graph.lua)"""

    sampling_ratio: float = 0.3
    max_constraint_distance: float = 15.0
    min_score: float = 0.55
    # Device byte budget of the batched constraint search's packs
    # (PoseGraph3D._get_pack_3d, PoseGraph2D._get_pack_2d).
    pack_hbm_budget_bytes: int = 6 << 30
    global_localization_min_score: float = 0.6
    loop_closure_translation_weight: float = 1.1e4
    loop_closure_rotation_weight: float = 1e5
    log_matches: bool = True
    fast_correlative_scan_matcher: FastCorrelativeScanMatcherOptions2D = _mkdefault(
        FastCorrelativeScanMatcherOptions2D
    )
    ceres_scan_matcher: CeresScanMatcher2DOptions = field(
        default_factory=lambda: CeresScanMatcher2DOptions(
            occupied_space_weight=20.0,
            translation_weight=10.0,
            rotation_weight=1.0,
            ceres_solver_options=SolverOptions(use_nonmonotonic_steps=True, max_num_iterations=10),
        )
    )
    fast_correlative_scan_matcher_3d: FastCorrelativeScanMatcherOptions3D = _mkdefault(
        FastCorrelativeScanMatcherOptions3D
    )
    ceres_scan_matcher_3d: CeresScanMatcher3DOptions = field(
        default_factory=lambda: CeresScanMatcher3DOptions(
            occupied_space_weight_0=5.0,
            occupied_space_weight_1=30.0,
            translation_weight=10.0,
            rotation_weight=1.0,
            ceres_solver_options=SolverOptions(max_num_iterations=10),
        )
    )


@dataclass(frozen=True)
class OptimizationProblemOptions:
    """(ref: internal/optimization/optimization_problem_options.h, pose_graph.lua)"""

    huber_scale: float = 1e1
    acceleration_weight: float = 1e3
    rotation_weight: float = 3e5
    local_slam_pose_translation_weight: float = 1e5
    local_slam_pose_rotation_weight: float = 1e5
    odometry_translation_weight: float = 1e5
    odometry_rotation_weight: float = 1e5
    fixed_frame_pose_translation_weight: float = 1e1
    fixed_frame_pose_rotation_weight: float = 1e2
    log_solver_summary: bool = False
    use_online_imu_extrinsics_in_3d: bool = True
    fix_z_in_3d: bool = False
    ceres_solver_options: SolverOptions = field(
        default_factory=lambda: SolverOptions(max_num_iterations=50, num_threads=7)
    )


@dataclass(frozen=True)
class OverlappingSubmapsTrimmerOptions2D:
    fresh_submaps_count: int = 1
    min_covered_area: float = 2.0
    min_added_submaps_count: int = 5


@dataclass(frozen=True)
class PoseGraphOptions:
    """(ref: configuration_files/pose_graph.lua)"""

    optimize_every_n_nodes: int = 90
    # Constraint searches and SPA run on a worker thread (ref:
    # pose_graph_3d.cc AddWorkItem:162-177, DrainWorkQueue:512-535);
    # False runs them inline, deterministically.
    async_work_queue: bool = True
    # Search a work-queue round's candidates at once: one K4 / K5 launch a
    # pyramid level and one packed GN refinement for the round
    # (parallel/constraint_search.py); False searches them one by one.
    use_batched_constraint_search: bool = True
    constraint_builder: ConstraintBuilderOptions = _mkdefault(ConstraintBuilderOptions)
    matcher_translation_weight: float = 5e2
    matcher_rotation_weight: float = 1.6e3
    optimization_problem: OptimizationProblemOptions = _mkdefault(OptimizationProblemOptions)
    max_num_final_iterations: int = 200
    global_sampling_ratio: float = 0.003
    log_residual_histograms: bool = True
    use_global_constraint_search: bool = True
    global_constraint_search_after_n_seconds: float = 10.0
    overlapping_submaps_trimmer_2d: Optional[OverlappingSubmapsTrimmerOptions2D] = None


@dataclass(frozen=True)
class MapBuilderOptions:
    """(ref: configuration_files/map_builder.lua)"""

    use_trajectory_builder_2d: bool = False
    use_trajectory_builder_3d: bool = False
    num_background_threads: int = 4
    pose_graph: PoseGraphOptions = _mkdefault(PoseGraphOptions)
    collate_by_trajectory: bool = False
    trajectory_builder_2d: TrajectoryBuilder2DOptions = _mkdefault(TrajectoryBuilder2DOptions)
    trajectory_builder_3d: TrajectoryBuilder3DOptions = _mkdefault(TrajectoryBuilder3DOptions)


# ---------------------------------------------------------------------------
# dict loading / deep replace
# ---------------------------------------------------------------------------


def from_dict(cls, data: Mapping[str, Any]):
    """Build a config dataclass from a nested dict; unknown keys raise
    (mirrors the reference's unused-key check). A nested Mapping needs a
    dataclass default to merge into: an Optional field left at None raises
    TypeError here (merge builds it)."""
    if not is_dataclass(cls):
        raise TypeError(f"{cls} is not a config dataclass")
    known = {f.name: f for f in fields(cls)}
    kwargs: Dict[str, Any] = {}
    for key, value in data.items():
        if key not in known:
            raise KeyError(f"unknown config key {key!r} for {cls.__name__}")
        if isinstance(value, Mapping):
            f = known[key]
            sub_default = f.default_factory() if f.default_factory is not dataclasses.MISSING else f.default
            if not is_dataclass(sub_default):
                raise TypeError(f"config key {key!r} of {cls.__name__} is not a nested config")
            kwargs[key] = merge(sub_default, value)
        else:
            kwargs[key] = value
    return dataclasses.replace(cls(), **kwargs)


def merge(cfg, overrides: Mapping[str, Any]):
    """Return cfg with nested overrides from a dict applied. A Mapping for
    an Optional[dataclass] field left at None builds that dataclass, so its
    unknown keys still raise; a Mapping for any other field is stored as
    given."""
    kwargs: Dict[str, Any] = {}
    names = {f.name for f in fields(cfg)}
    for key, value in overrides.items():
        if key not in names:
            raise KeyError(f"unknown config key {key!r} for {type(cfg).__name__}")
        current = getattr(cfg, key)
        if isinstance(value, Mapping) and is_dataclass(current):
            kwargs[key] = merge(current, value)
        elif isinstance(value, Mapping) and current is None:
            sub_cls = _optional_dataclass_type(typing.get_type_hints(type(cfg))[key])
            kwargs[key] = value if sub_cls is None else merge(sub_cls(), value)
        else:
            kwargs[key] = value
    return dataclasses.replace(cfg, **kwargs)


def _optional_dataclass_type(annotation):
    """The dataclass X of an Optional[X] or X annotation, else None."""
    if typing.get_origin(annotation) is typing.Union:
        args = [a for a in typing.get_args(annotation) if a is not type(None)]
        annotation = args[0] if len(args) == 1 else None
    return annotation if is_dataclass(annotation) else None


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


def to_dict(cfg) -> Dict[str, Any]:
    """The config as nested plain dicts (dataclasses.asdict)."""
    return dataclasses.asdict(cfg)
