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


def test_2d_no_fallback_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="need a CUDA card"):
        MapBuilder(_options_2d())
    with pytest.raises(RuntimeError, match="need a CUDA card"):
        PoseGraph2D(_options_2d().pose_graph)
