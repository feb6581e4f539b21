"""The port's entry points, 3D and 2D, run on the card unless the caller
asks for the CPU, and never fall back to the CPU on a machine without one.

No kernel is built here: ops._build.load_library is replaced by a stub
that records its calls, and nothing is put on the card (the submaps, the
kernels' inputs and the SPA problems are made on the first scan).
"""

import pytest
import torch

from hectorgrapher_tpu_torch.common import config as cfg
from hectorgrapher_tpu_torch.mapping.map_builder import MapBuilder
from hectorgrapher_tpu_torch.mapping.pose_graph.pose_graph import PoseGraph2D, PoseGraph3D
from hectorgrapher_tpu_torch.ops import _build

CUDA = torch.device("cuda")


def _options():
    return cfg.replace_deep(cfg.MapBuilderOptions(), {
        "use_trajectory_builder_3d": True,
        "trajectory_builder_3d.submaps.grid_type": "TSDF",
        "pose_graph.use_batched_constraint_search": False,
        "pose_graph.async_work_queue": False,
    })


@pytest.fixture
def builds(monkeypatch):
    calls = []
    monkeypatch.setattr(_build, "load_library", lambda: calls.append(1))
    return calls


def test_map_builder_defaults_to_the_card(builds):
    mb = MapBuilder(_options())
    assert mb.pose_graph._device == CUDA
    local = mb.get_trajectory_builder(mb.add_trajectory_builder())._local
    assert local._device == CUDA
    assert builds  # the kernels are built before any thread can launch one


def test_pose_graph_defaults_to_the_card(builds):
    pg = PoseGraph3D(_options().pose_graph)
    assert pg._device == CUDA
    assert len(builds) == 1


def test_cpu_only_when_asked(builds):
    mb = MapBuilder(_options(), device="cpu")
    assert mb.pose_graph._device == torch.device("cpu")
    assert mb.get_trajectory_builder(mb.add_trajectory_builder())._local._device == torch.device("cpu")
    assert not builds


def test_no_fallback_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="need a CUDA card"):
        MapBuilder(_options())
    with pytest.raises(RuntimeError, match="need a CUDA card"):
        PoseGraph3D(_options().pose_graph)


def _options_2d():
    """The default MapBuilderOptions (the 2D pipeline), async off."""
    return cfg.replace_deep(cfg.MapBuilderOptions(), {"pose_graph.async_work_queue": False})


def test_2d_entry_points_default_to_the_card(builds):
    mb = MapBuilder(_options_2d())
    assert isinstance(mb.pose_graph, PoseGraph2D) and mb.pose_graph._device == CUDA
    assert mb.get_trajectory_builder(mb.add_trajectory_builder())._local._device == CUDA
    assert PoseGraph2D(_options_2d().pose_graph)._device == CUDA
    assert len(builds) == 2  # the kernels are built before any thread can launch one


def test_2d_cpu_only_when_asked(builds):
    mb = MapBuilder(_options_2d(), device="cpu")
    assert mb.pose_graph._device == torch.device("cpu")
    assert mb.get_trajectory_builder(mb.add_trajectory_builder())._local._device == torch.device("cpu")
    assert PoseGraph2D(_options_2d().pose_graph, device="cpu")._device == torch.device("cpu")
    assert not builds


def _options_2d_tsdf():
    """The 2D pipeline on TSDF submaps stored as uint16 once finished."""
    return cfg.replace_deep(_options_2d(), {"trajectory_builder_2d.submaps.grid_options_2d.grid_type": "TSDF",
                                            "trajectory_builder_2d.submaps.grid_storage_dtype": "uint16"})


def test_2d_tsdf_entry_points_default_to_the_card(builds):
    """MapBuilder, LocalTrajectoryBuilder2D and ActiveSubmaps2D over TSDF
    submaps put their grids on the card by default (none is made before
    the first scan)."""
    from hectorgrapher_tpu_torch.mapping.local_2d import LocalTrajectoryBuilder2D
    from hectorgrapher_tpu_torch.mapping.submap_2d import ActiveSubmaps2D

    opts = _options_2d_tsdf()
    mb = MapBuilder(opts)
    local = mb.get_trajectory_builder(mb.add_trajectory_builder())._local
    assert local._device == CUDA and local.active_submaps._device == CUDA and local._is_tsdf
    assert LocalTrajectoryBuilder2D(opts.trajectory_builder_2d)._device == CUDA
    assert ActiveSubmaps2D(opts.trajectory_builder_2d.submaps)._device == CUDA
    assert builds


def test_2d_tsdf_cpu_only_when_asked(builds):
    """Asked for the CPU, the TSDF submaps and match_gn_2d_tsdf on them
    stay there."""
    import numpy as np

    from hectorgrapher_tpu_torch.evaluation.scan_generator import raycast_rect_room_2d
    from hectorgrapher_tpu_torch.mapping.scan_matching.gn_2d import match_gn_2d_tsdf
    from hectorgrapher_tpu_torch.mapping.submap_2d import ActiveSubmaps2D
    from hectorgrapher_tpu_torch.sensor.types import RangeData, pad_cloud
    from hectorgrapher_tpu_torch.transform.rigid import Rigid2

    cpu = torch.device("cpu")
    submaps = ActiveSubmaps2D(cfg.replace_deep(_options_2d_tsdf().trajectory_builder_2d.submaps, {"grid_size": 128}),
                              device="cpu")
    pts = raycast_rect_room_2d(np.zeros(2), 0.0, half_width=2.4, half_height=1.9, num_rays=360)
    cloud = pad_cloud(pts[~np.isnan(pts[:, 0])].astype(np.float32), 512, cpu)
    submaps.insert_range_data(RangeData(torch.zeros(3), cloud, pad_cloud(np.zeros((0, 3), np.float32), 8, cpu)),
                              np.zeros(3))
    grid = submaps.matching_submap.grid
    assert grid.tsd.device == cpu and bool((grid.weight > 0).any())
    pose, cost = match_gn_2d_tsdf(grid, cloud, Rigid2(torch.tensor([0.02, -0.01]), torch.tensor(0.01)),
                                  torch.tensor([0.02, -0.01]), 1.0, 0.1, 0.1)
    assert pose.translation.device == cpu and bool(torch.isfinite(cost))
    assert not builds


def test_2d_no_fallback_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="need a CUDA card"):
        MapBuilder(_options_2d())
    with pytest.raises(RuntimeError, match="need a CUDA card"):
        PoseGraph2D(_options_2d().pose_graph)
