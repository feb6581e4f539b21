"""The port's typed configuration tree (hectorgrapher_tpu_torch/common/
config.py) against the JAX package's: every case of tests/test_config.py
through both packages, with equal option trees (dataclasses.asdict, so
exact values), and merge, replace_deep, from_dict and to_dict behaving
alike, including an Optional nested config left at None.
"""

import dataclasses
import math

import pytest

from hectorgrapher_tpu.common import config as jcfg
from hectorgrapher_tpu_torch.common import config as tcfg

PACKAGES = [jcfg, tcfg]


def _tree(options):
    return dataclasses.asdict(options)


@pytest.mark.parametrize("name", ["TrajectoryBuilder3DOptions", "TrajectoryBuilder2DOptions", "PoseGraphOptions",
                                  "MapBuilderOptions"])
def test_defaults_equal_the_jax_packages(name):
    assert _tree(getattr(tcfg, name)()) == _tree(getattr(jcfg, name)())


@pytest.mark.parametrize("cfg", PACKAGES, ids=["jax", "port"])
def test_defaults_match_reference_lua(cfg):
    tb3 = cfg.TrajectoryBuilder3DOptions()
    assert tb3.min_range == 1.0
    assert tb3.max_range == 60.0
    assert tb3.submaps.high_resolution == 0.10
    assert tb3.submaps.low_resolution == 0.45
    assert tb3.submaps.num_range_data == 160
    assert tb3.optimizing_local_trajectory_builder.ct_window_horizon == 0.9
    assert tb3.optimizing_local_trajectory_builder.imu_integrator == "RK4"
    assert tb3.motion_filter.max_angle_radians == 0.004

    tb2 = cfg.TrajectoryBuilder2DOptions()
    assert tb2.submaps.num_range_data == 90
    assert tb2.submaps.range_data_inserter.probability_grid_range_data_inserter.hit_probability == 0.55
    assert tb2.real_time_correlative_scan_matcher.angular_search_window == pytest.approx(math.radians(20.0))

    pg = cfg.PoseGraphOptions()
    assert pg.optimize_every_n_nodes == 90
    assert pg.constraint_builder.min_score == 0.55
    assert pg.constraint_builder.fast_correlative_scan_matcher_3d.branch_and_bound_depth == 8
    assert pg.optimization_problem.huber_scale == 1e1


def test_merge_and_replace_deep():
    got, want = (cfg.replace_deep(cfg.TrajectoryBuilder2DOptions(), {"submaps.num_range_data": 10, "max_range": 25.0})
                 for cfg in (tcfg, jcfg))
    assert _tree(got) == _tree(want)
    assert got.submaps.num_range_data == 10
    assert got.max_range == 25.0
    assert tcfg.TrajectoryBuilder2DOptions().submaps.num_range_data == 90  # frozen: the original untouched


@pytest.mark.parametrize("cfg", PACKAGES, ids=["jax", "port"])
def test_unknown_key_raises(cfg):
    with pytest.raises(KeyError):
        cfg.merge(cfg.TrajectoryBuilder2DOptions(), {"not_a_key": 1})
    with pytest.raises(KeyError):
        cfg.merge(cfg.PoseGraphOptions(), {"overlapping_submaps_trimmer_2d": {"not_a_key": 1}})
    with pytest.raises(KeyError):
        cfg.from_dict(cfg.PoseGraphOptions, {"not_a_key": 1})


def test_merge_builds_an_optional_nested_config():
    """The port's merge used to raise TypeError ('is not a nested config')
    on a Mapping for an Optional field left at None; JAX's builds it."""
    overrides = {"overlapping_submaps_trimmer_2d": {"fresh_submaps_count": 2}}
    got = tcfg.merge(tcfg.PoseGraphOptions(), overrides)
    want = jcfg.merge(jcfg.PoseGraphOptions(), overrides)
    assert isinstance(got.overlapping_submaps_trimmer_2d, tcfg.OverlappingSubmapsTrimmerOptions2D)
    assert _tree(got) == _tree(want)
    assert got.overlapping_submaps_trimmer_2d.fresh_submaps_count == 2
    dotted = {"pose_graph.overlapping_submaps_trimmer_2d.fresh_submaps_count": 2,
              "pose_graph.overlapping_submaps_trimmer_2d.min_covered_area": 3.0}
    got = tcfg.replace_deep(tcfg.MapBuilderOptions(), dotted)
    assert _tree(got) == _tree(jcfg.replace_deep(jcfg.MapBuilderOptions(), dotted))
    assert got.pose_graph.overlapping_submaps_trimmer_2d.min_covered_area == 3.0


def test_from_dict_and_to_dict_match_jax():
    data = {"optimize_every_n_nodes": 3, "constraint_builder": {"min_score": 0.6}}
    got, want = tcfg.from_dict(tcfg.PoseGraphOptions, data), jcfg.from_dict(jcfg.PoseGraphOptions, data)
    assert _tree(got) == _tree(want) and got.constraint_builder.min_score == 0.6
    # JAX's from_dict resolves a nested Mapping through the field's default,
    # so a top-level Optional field left at None raises there; so does the port's.
    for cfg in PACKAGES:
        with pytest.raises(TypeError, match="not a nested config"):
            cfg.from_dict(cfg.PoseGraphOptions, {"overlapping_submaps_trimmer_2d": {"fresh_submaps_count": 2}})
        with pytest.raises(TypeError):
            cfg.from_dict(int, {})
    nested = tcfg.from_dict(tcfg.MapBuilderOptions,
                            {"pose_graph": {"overlapping_submaps_trimmer_2d": {"fresh_submaps_count": 4}}})
    assert nested.pose_graph.overlapping_submaps_trimmer_2d.fresh_submaps_count == 4

    options = tcfg.replace_deep(tcfg.MapBuilderOptions(), {"pose_graph.overlapping_submaps_trimmer_2d": {},
                                                           "trajectory_builder_3d.max_range": 30.0})
    assert tcfg.to_dict(options) == jcfg.to_dict(jcfg.replace_deep(jcfg.MapBuilderOptions(), {
        "pose_graph.overlapping_submaps_trimmer_2d": {}, "trajectory_builder_3d.max_range": 30.0}))
    assert tcfg.from_dict(tcfg.MapBuilderOptions, tcfg.to_dict(options)) == options


def test_a_mapping_for_a_plain_field_is_stored_as_given():
    """JAX's merge stores a Mapping for a field that is neither a dataclass
    nor None as it is; the port's raised TypeError there as well."""
    for cfg in PACKAGES:
        out = cfg.merge(cfg.TrajectoryBuilder3DOptions(), {"max_range": {"a": 1}})
        assert out.max_range == {"a": 1}
