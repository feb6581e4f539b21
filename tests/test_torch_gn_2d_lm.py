"""Kernel K7's dispatch (hectorgrapher_tpu_torch/ops/gn_2d_lm.py) in the 2D
Gauss-Newton refinement, on the CPU.

gn_2d._lm_grid_2d gathers the wide rows once and launches K7 for CUDA
tensors, and runs its eager twin (_lm_grid_2d_plain) for CPU tensors: on
the CPU it must return the twin's result exactly, count no launch and
refuse other devices; the wrapper refuses inputs it cannot launch on. The
kernel itself runs on the card only; chip_smoke.py phases 5, 6, 20 and
22b hold it to the twin there.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from hectorgrapher_tpu_torch.common import config as cfg
from hectorgrapher_tpu_torch.evaluation.scan_generator import raycast_rect_room_2d
from hectorgrapher_tpu_torch.mapping import local_2d
from hectorgrapher_tpu_torch.mapping.grids import make_probability_grid, make_tsdf_grid
from hectorgrapher_tpu_torch.mapping.inserters_2d import make_probability_inserter_2d, make_tsdf_inserter_2d
from hectorgrapher_tpu_torch.mapping.scan_matching import gn_2d as tgn
from hectorgrapher_tpu_torch.ops.gn_2d_lm import gn_2d_lm
from hectorgrapher_tpu_torch.sensor.types import RangeData, TimedPointCloudData, pad_cloud, pad_timed_cloud
from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3
from hectorgrapher_tpu_torch.transform.rigid import Rigid2

CPU = torch.device("cpu")
WEIGHTS = (1.0, 10.0, 40.0)  # occupied space, translation, rotation: the 2D front end's


@pytest.fixture(scope="module")
def scenes():
    """A 160^2 probability grid and a 160^2 TSDF at 0.05 m, each with three
    inserts of one 360-ray scan of a 7 x 6 m room from the origin, and that
    scan as a 512-slot cloud; the two cost kinds' prepared fields."""
    pts = raycast_rect_room_2d(np.zeros(2), 0.0, half_width=3.5, half_height=3.0, num_rays=360)
    cloud = pad_cloud(pts[~np.isnan(pts[:, 0])].astype(np.float32), 512, CPU)
    rd = RangeData(torch.zeros(3), cloud, pad_cloud(np.zeros((0, 3), np.float32), 8, CPU))
    prob = make_probability_grid(0.05, (160, 160), CPU)
    insert = make_probability_inserter_2d(cfg.ProbabilityGridRangeDataInserterOptions2D(), max_range=8.0,
                                          resolution=0.05)
    tsdf = make_tsdf_grid(0.05, (160, 160), 0.3, 10.0, CPU)
    insert_tsdf = make_tsdf_inserter_2d(cfg.TSDFRangeDataInserterOptions2D(), 0.05)
    for _ in range(3):
        prob, tsdf = insert(prob, rd), insert_tsdf(tsdf, rd)
    return {"probability": (tgn._ProbabilityCost, (tgn.prepare_gn_probability_field(prob),), prob.meta),
            "tsdf": (tgn._TsdfCost, tgn.prepare_gn_tsdf_fields(tsdf), tsdf.meta)}, cloud


def _solve_args(scenes, kind, b, seed=0):
    """_lm_grid_2d's arguments for b lanes of `kind`'s scene: the scan
    from seeded starts within 6 cm / 0.03 rad of the truth (the origin),
    some points masked per lane, the start as the target."""
    fields, cloud = scenes
    cost_fn, planes, meta = fields[kind]
    g = torch.Generator().manual_seed(seed)
    mask = cloud.mask.expand(b, -1) & (torch.rand(b, cloud.mask.shape[0], generator=g) > 0.1)
    pts = cloud.positions[..., :2].expand(b, -1, -1).contiguous()
    start = Rigid2((torch.rand(b, 2, generator=g) - 0.5) * 0.12, (torch.rand(b, generator=g) - 0.5) * 0.06)
    gather = lambda world: tuple(tgn.gather_rows_2d(f, world) for f in planes)
    return (cost_fn, gather, meta.min_corner, meta.resolution, pts, mask, tgn._occupied_scale(mask, WEIGHTS[0]),
            start, start.translation, *WEIGHTS[1:], 20)


CASES = [(kind, b) for kind in ("probability", "tsdf") for b in (1, 3)]


@pytest.mark.parametrize("kind,b", CASES)
def test_lm_grid_2d_on_cpu_is_the_eager_twin(scenes, kind, b):
    args = _solve_args(scenes, kind, b)
    pose, cost = tgn._lm_grid_2d(*args)
    want_pose, want_cost = tgn._lm_grid_2d_plain(*args)
    assert torch.equal(pose.translation, want_pose.translation) and torch.equal(pose.angle, want_pose.angle)
    assert torch.equal(cost, want_cost)
    assert pose.translation.shape == (b, 2) and pose.angle.shape == (b,) and cost.shape == (b,)


@pytest.mark.parametrize("kind", ["probability", "tsdf"])
def test_twin_counts_each_lanes_iterations(scenes, kind):
    """_lm_rows_plain's iteration count: a lane's alone equals its count in
    the batch (a frozen lane stops counting), and no lane passes the
    limit."""
    cost_fn, gather, mc, res, pts, valid, scale, start, target, tw, rw, iters = _solve_args(scenes, kind, 3, seed=1)
    rows, base = tgn._lm_start(gather, mc, res, pts, start, tgn._GN_SLACK)
    _, _, its = tgn._lm_rows_plain(cost_fn, rows, base, mc, res, pts, valid, scale, start, target, tw, rw, iters)
    assert its.dtype == torch.int32 and bool((its >= 1).all()) and bool((its <= iters).all())
    for i in range(3):
        lane = Rigid2(start.translation[i:i + 1], start.angle[i:i + 1])
        _, _, one = tgn._lm_rows_plain(cost_fn, tuple(r[i:i + 1] for r in rows), base[i:i + 1], mc, res,
                                       pts[i:i + 1], valid[i:i + 1], scale[i:i + 1], lane, target[i:i + 1], tw, rw,
                                       iters)
        assert int(one[0]) == int(its[i])


def test_counts_no_launch_on_cpu(scenes):
    before = gn_2d_lm.launches
    for kind, b in CASES:
        tgn._lm_grid_2d(*_solve_args(scenes, kind, b))
    assert gn_2d_lm.launches == before == 0


def test_refuses_other_devices(scenes):
    args = list(_solve_args(scenes, "probability", 1))
    args[4] = args[4].to("meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        tgn._lm_grid_2d(*args)


def _cuda_like(monkeypatch):
    """Every tensor reads as on a CUDA device and K7's launch is recorded,
    not made: the card path's checks run on the CPU. Returns the launches."""
    launched = []
    monkeypatch.setattr("hectorgrapher_tpu_torch.ops.gn_2d_lm._build.launch", lambda *a: launched.append(a))
    cuda = type("CudaLike", (), {"type": "cuda", "__eq__": lambda s, o: True, "__ne__": lambda s, o: False})()
    monkeypatch.setattr(torch.Tensor, "device", property(lambda self: cuda))
    return launched


def test_card_path_refuses_a_cost_its_rows_do_not_serve(scenes, monkeypatch):
    """On the card the number of planes the gather returns names K7's
    cost: a probability solve handed two planes is refused before the
    launch."""
    args = list(_solve_args(scenes, "tsdf", 1))
    args[0] = tgn._ProbabilityCost
    launched = _cuda_like(monkeypatch)
    with pytest.raises(ValueError, match="2 planes of rows for _ProbabilityCost"):
        tgn._lm_grid_2d(*args)
    assert not launched


@pytest.mark.parametrize("kind,b", CASES)
def test_card_path_is_one_launch(scenes, kind, b, monkeypatch):
    """On the card _lm_grid_2d gathers, then makes one K7 launch with the
    twin's rows and base cells (one or two planes by the cost), and
    returns its pose and cost buffers without waiting on them."""
    args = _solve_args(scenes, kind, b)
    rows, base = tgn._lm_start(args[1], args[2], args[3], args[4], args[7], tgn._GN_SLACK)
    monkeypatch.setattr(gn_2d_lm, "launches", 0)
    launched = _cuda_like(monkeypatch)
    pose, cost = tgn._lm_grid_2d(*args)
    assert len(launched) == 1 and gn_2d_lm.launches == 1
    name, _, *ptrs = launched[0]
    assert name == "hg_gn_2d_lm" and (ptrs[1] is None) == (kind == "probability")
    assert ptrs[13:17] == [b, 512, 10, 20]
    assert pose.translation.shape == (b, 2) and pose.angle.shape == (b,) and cost.shape == (b,)
    assert (rows[0].shape, base.shape) == ((b, 512, 100), (b, 512, 2))


def _k7_args(scenes, kind="probability", b=2):
    """gn_2d_lm's arguments for `kind`'s scene, as _lm_grid_2d builds them."""
    cost_fn, gather, mc, res, pts, valid, scale, start, target, tw, rw, iters = _solve_args(scenes, kind, b)
    rows, base = tgn._lm_start(gather, mc, res, pts, start, tgn._GN_SLACK)
    pose0 = torch.cat([start.translation, start.angle[:, None]], dim=-1)
    return [rows, base, mc.reshape(1, 2).expand(b, 2).contiguous(), res.reshape(1).expand(b).contiguous(), pts,
            valid, scale, pose0, target.contiguous(), tw, rw, iters]


def test_wrapper_launches_on_cuda_tensors_only(scenes):
    with pytest.raises(ValueError, match="unsupported device cpu"):
        gn_2d_lm(*_k7_args(scenes))


BAD_INPUTS = {
    "rows_not_a_tuple": (0, lambda x: x[0], ValueError, "tuple of one or two planes"),
    "three_planes": (0, lambda x: x * 3, ValueError, "tuple of one or two planes"),
    "rows_not_square": (0, lambda x: (x[0][..., :99],), ValueError, "unsupported rows"),
    "rows_f64": (0, lambda x: (x[0].double(),), TypeError, "rows has dtype"),
    "rows_not_contiguous": (0, lambda x: (x[0].transpose(0, 1).contiguous().transpose(0, 1),), ValueError,
                            "rows is not contiguous"),
    "weight_rows_shape": (0, lambda x: (x[0], x[0][:, :-1]), ValueError, "weight rows has shape"),
    "base_shape": (1, lambda x: x[:, :-1], ValueError, "base has shape"),
    "valid_dtype": (5, lambda x: x.to(torch.uint8), TypeError, "valid has dtype"),
    "scale_shape": (6, lambda x: x[:1], ValueError, "scale has shape"),
    "pose0_not_contiguous": (7, lambda x: x.t().contiguous().t(), ValueError, "pose0 is not contiguous"),
    "target_f64": (8, lambda x: x.double(), TypeError, "target has dtype"),
}


@pytest.mark.parametrize("case", list(BAD_INPUTS))
def test_wrapper_checks_its_inputs(scenes, case, monkeypatch):
    """On a device the wrapper launches on, each input is checked before
    the launch."""
    slot, bad, error, message = BAD_INPUTS[case]
    args = _k7_args(scenes)
    args[slot] = bad(args[slot])
    launched = _cuda_like(monkeypatch)
    with pytest.raises(error, match=message):
        gn_2d_lm(*args)
    assert not launched


def test_front_end_calls_the_module_global(monkeypatch):
    """LocalTrajectoryBuilder2D's scan match calls match_gn_2d_probability
    through local_2d's module global, which the benchmark's 2D GN check
    (hgbench/checks/gn_2d.py) wraps to sample the refinements: one call a
    matched scan, with the front end's iteration limit."""
    calls = []
    inner = local_2d.match_gn_2d_probability
    monkeypatch.setattr(local_2d, "match_gn_2d_probability",
                        lambda *a, **kw: calls.append(kw["num_iterations"]) or inner(*a, **kw))
    opts = cfg.replace_deep(cfg.TrajectoryBuilder2DOptions(), {
        "use_imu_data": False, "submaps.grid_size": 128, "max_num_points": 512, "max_range": 6.0})
    builder = local_2d.LocalTrajectoryBuilder2D(opts, device=CPU)
    pts = raycast_rect_room_2d(np.zeros(2), 0.0, half_width=2.5, half_height=2.0, num_rays=360).astype(np.float32)
    for i in range(3):
        builder.add_odometry_data(0.1 * i, NpRigid3())
        result = builder.add_range_data(TimedPointCloudData(
            0.1 * i, np.zeros(3, np.float32), pad_timed_cloud(pts, np.zeros(360, np.float32), 512)))
        assert result is not None
    assert calls == [opts.ceres_scan_matcher.ceres_solver_options.max_num_iterations] * 2
