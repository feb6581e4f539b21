"""Sizes a CPU test run can hold: each cell's options, mix and sensors cut
down so that a run and its comparison take seconds. The shapes the checks
read stay those of the cell (the same fields, masks, solvers)."""

DRZ_CT3D = dict(
    extra_options={
        "trajectory_builder_3d.submaps.high_grid_size": 64,
        "trajectory_builder_3d.submaps.low_grid_size": 32,
        "trajectory_builder_3d.submaps.high_resolution": 0.4,
        "trajectory_builder_3d.submaps.low_resolution": 1.2,
        "trajectory_builder_3d.optimizing_local_trajectory_builder.max_control_points": 12,
        "trajectory_builder_3d.optimizing_local_trajectory_builder.max_clouds_in_window": 12,
        "trajectory_builder_3d.optimizing_local_trajectory_builder.points_per_cloud": 64,
        "trajectory_builder_3d.optimizing_local_trajectory_builder.initialization_duration": 0.5,
    },
    extra_mix={"stream_s": 20.0, "trace_scans": 2},
    extra_sensors={"beams": 16, "columns": 64},
)

CARTO2D = dict(
    extra_options={
        "trajectory_builder_2d.submaps.num_range_data": 10,
        "trajectory_builder_2d.submaps.grid_size": 256,
        "pose_graph.optimize_every_n_nodes": 10,
        "pose_graph.constraint_builder.fast_correlative_scan_matcher.linear_search_window": 1.0,
        "pose_graph.constraint_builder.fast_correlative_scan_matcher.angular_search_window": 0.1,
    },
    extra_mix={"stream_s": 60.0, "trace_scans": 3},
    extra_sensors={},
)

CELLS = {"drz_ct3d.solo": DRZ_CT3D, "carto2d.laps": CARTO2D}


def run(cell: str, seed: int, seconds: float, trace: bool = False, fault=None, control: bool = False):
    """One run of `cell` on the CPU at the tiny size: (line, rows)."""
    from hgbench.lib import names
    from hgbench.lib.session import Session, finish

    s = Session(cell, seed, seconds, trace, "cpu", fault=fault, **CELLS[cell])
    names.load_module("drivers", s.mix["driver"]).run(s)
    return finish(s, control=control)
