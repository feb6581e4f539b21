"""Kernel K6's dispatch (hectorgrapher_tpu_torch/ops/ct_pair_block.py) in
the CT window solver, on the CPU.

window_solver.pair_residuals and window_solver.cloud_poses launch K6 for
CUDA tensors and run their eager twins (pair_residuals_plain,
cloud_poses_plain) for CPU tensors: on the CPU they must return the
twins' results exactly, count no launch, and refuse other devices. The
kernel itself runs on the card only; chip_smoke.py phase 7 (K = C = 32)
and phase 24a (B = 8) hold it to the twins there.
"""

from __future__ import annotations

import pytest
import torch

from hectorgrapher_tpu_torch.mapping.ct import window_solver as tws
from hectorgrapher_tpu_torch.ops.ct_pair_block import ct_cloud_poses, ct_pair_residuals
from hectorgrapher_tpu_torch.transform.rigid import quat_from_axis_angle, quat_multiply, quat_normalize

K, C = 8, 6


def _window(lead=(), seed=0, direct=False):
    """(state, problem, weights, direct) of a synthetic window: K control
    points 0.1 s apart turning by up to ~0.05 rad a step, C clouds on
    random brackets, some pairs masked out of the IMU and the odometry
    terms; with `direct`, M = 4 DIRECT IMU sub-steps a pair. `lead` is a
    leading window axis (the batched solve's)."""
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*lead, *s, generator=g)
    turns = rnd(K, 3) * 0.03
    q = quat_normalize(quat_from_axis_angle(rnd(3)))
    rotations = []
    for i in range(K):
        q = quat_normalize(quat_multiply(q, quat_from_axis_angle(turns[..., i, :])))
        rotations.append(q)
    state = tws.CtState(torch.cumsum(rnd(K, 3) * 0.05, dim=-2), torch.stack(rotations, dim=-2), rnd(K, 3) * 0.3)
    prev = torch.randint(0, K - 1, lead + (C,), generator=g, dtype=torch.int32)
    mask = lambda: torch.rand(*lead, K - 1, generator=g) > 0.2
    near = lambda: quat_normalize(quat_from_axis_angle(turns[..., 1:, :] + rnd(K - 1, 3) * 1e-3))
    problem = tws.CtProblem(
        cp_mask=torch.ones(lead + (K,), dtype=torch.bool), cp_times=torch.arange(K).expand(lead + (K,)) * 0.1,
        cloud_mask=torch.ones(lead + (C,), dtype=torch.bool), cloud_prev=prev, cloud_next=prev + 1,
        cloud_factor=torch.rand(*lead, C, generator=g), cloud_time=torch.zeros(lead + (C,)),
        hi_points=None, hi_mask=None, hi_times=None, lo_points=None, lo_mask=None, lo_times=None,
        pair_mask=mask(), pair_dt=torch.full(lead + (K - 1,), 0.1), imu_delta_rotation=near(),
        imu_delta_velocity=torch.zeros(lead + (K - 1, 3)), imu_delta_translation=torch.zeros(lead + (K - 1, 3)),
        odom_mask=mask(), odom_delta_translation=rnd(K - 1, 3) * 0.05, odom_delta_rotation=near(),
        odom_translation_weight=torch.rand(*lead, K - 1, generator=g) * 10,
        odom_rotation_weight=torch.rand(*lead, K - 1, generator=g) * 10)
    weights = tws.CtWeights(*(torch.tensor(w) for w in (1.0, 1.0, 3.0, 2.0, 5.0)))
    d = None
    if direct:
        m = 4
        d = tws.DirectImuData(torch.full(lead + (K - 1, m), 0.1 / m), rnd(K - 1, m, 3) * 0.1,
                              rnd(K - 1, m, 3) * 0.2 + torch.tensor([0.0, 0.0, 9.80665]),
                              torch.full(lead, 9.80665))
    return state, problem, weights, d


CASES = {"per_cloud": dict(), "batched": dict(lead=(3,)), "direct": dict(direct=True)}


@pytest.mark.parametrize("case", list(CASES))
def test_pair_residuals_on_cpu_are_the_eager_twin(case):
    state, problem, weights, direct = _window(**CASES[case])
    got = tws.pair_residuals(state, problem, weights, direct)
    want = tws.pair_residuals_plain(state, problem, weights, direct)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    lead = state.translation.shape[:-2]
    assert got[0].shape == lead + (K - 1, 15) and got[1].shape == lead + (K - 1, 15, 18)


@pytest.mark.parametrize("case", list(CASES))
def test_cloud_poses_on_cpu_are_the_eager_twin(case):
    state, problem, _, _ = _window(**CASES[case])
    got = tws.cloud_poses(state, problem)
    want = tws.cloud_poses_plain(state, problem)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    lead = state.translation.shape[:-2]
    assert got[0].shape == lead + (C, 7) and got[1].shape == lead + (C, 7, 18)


@pytest.mark.parametrize("fn", ["pair_residuals", "cloud_poses"])
def test_refuses_other_devices(fn):
    state, problem, weights, _ = _window()
    meta = torch.device("meta")
    moved = lambda nt: type(nt)(*(x.to(meta) if torch.is_tensor(x) else x for x in nt))
    args = (moved(state), moved(problem)) + ((moved(weights),) if fn == "pair_residuals" else ())
    with pytest.raises(ValueError, match="unsupported device"):
        getattr(tws, fn)(*args)
    # The kernel's wrapper itself launches on CUDA tensors only.
    with pytest.raises(ValueError, match="unsupported device cpu"):
        if fn == "pair_residuals":
            ct_pair_residuals(state, problem, weights)
        else:
            ct_cloud_poses(state, problem)


BAD_BUFFERS = {
    "J_shape": ("pair", 1, (K - 1, 18, 15), torch.float32, ValueError),
    "J_dtype": ("pair", 1, (K - 1, 15, 18), torch.float64, TypeError),
    "r_shape": ("pair", 0, (K, 15), torch.float32, ValueError),
    "dpose7_shape": ("cloud", 1, (C, 7, 17), torch.float32, ValueError),
    "dpose7_dtype": ("cloud", 1, (C, 7, 18), torch.float16, TypeError),
    "pose7_shape": ("cloud", 0, (C, 4), torch.float32, ValueError),
}


@pytest.mark.parametrize("case", list(BAD_BUFFERS))
def test_wrapper_checks_its_buffers(case):
    which, slot, shape, dtype, error = BAD_BUFFERS[case]
    state, problem, weights, _ = _window()
    rows = 15 if which == "pair" else 7
    n = K - 1 if which == "pair" else C
    out = [torch.empty(n, rows), torch.empty(n, rows, 18)]
    out[slot] = torch.empty(shape, dtype=dtype)
    with pytest.raises(error, match="r has|J has|pose7 has|dpose7 has"):
        if which == "pair":
            ct_pair_residuals(state, problem, weights, out=out)
        else:
            ct_cloud_poses(state, problem, out=out)


def test_counters_stay_at_zero_on_cpu():
    before = (tws.pair_residuals.launches, tws.pair_residuals.eager_on_card, tws.cloud_poses.launches)
    assert before == (0, 0, 0)
    for case in CASES.values():
        state, problem, weights, direct = _window(**case)
        tws.pair_residuals(state, problem, weights, direct)
        tws.cloud_poses(state, problem)
    assert (tws.pair_residuals.launches, tws.pair_residuals.eager_on_card, tws.cloud_poses.launches) == (0, 0, 0)


def test_assembly_calls_the_module_globals(monkeypatch):
    """An assembly calls cloud_poses and pair_residuals through the
    module's globals, which the benchmark wraps in spans by name."""
    from hectorgrapher_tpu_torch.mapping.grids import make_tsdf_grid

    calls = []
    for name in ("cloud_poses", "pair_residuals"):
        inner = getattr(tws, name)
        monkeypatch.setattr(tws, name, lambda *a, __inner=inner, __name=name, **kw: calls.append(__name)
                            or __inner(*a, **kw))
    state, problem, weights, _ = _window()
    pts = torch.randn(C, 4, 3, generator=torch.Generator().manual_seed(1))
    on = torch.ones(C, 4, dtype=torch.bool)
    problem = problem._replace(hi_points=pts, hi_mask=on, hi_times=torch.zeros(C, 4), lo_points=pts, lo_mask=on,
                               lo_times=torch.zeros(C, 4))
    grid = lambda res: make_tsdf_grid(res, (8, 8, 8), 0.25, 1000.0, torch.device("cpu"))
    JtJ, g, cost = tws.ct_normal_equations(grid(0.1), grid(0.45), problem, state, weights, is_tsdf=True)
    assert calls == ["cloud_poses", "pair_residuals"]
    assert JtJ.shape == (9 * K, 9 * K) and bool(torch.isfinite(cost))
