"""The port's dense 3D correlative search (hectorgrapher_tpu_torch/mapping/
scan_matching/correlative_3d.py) against the JAX package's, on the CPU,
over 48^3 box-room submaps (occupancy and TSDF), k = 2 and a few yaws.

The port gathers each candidate's score directly where JAX builds a
shifted-field table, (n + 2k)^3 x (2k + 1)^3 floats. Held here:

  * every candidate's score against a numpy evaluation through that table
    (JAX's formulation, at this small size), the points' cells computed in
    float32 with the same arithmetic, within 1e-5 * max(1, max|score|);
  * the best score against the JAX search's within the same tolerance,
    and the pose equal to JAX's (1e-6) wherever the port's winner leads
    its runner-up by more than that tolerance: the N-sums run in another
    order, so a closer tie may fall either way;
  * a cloud whose bases fall outside the grid and outside the grid's
    k-cell margin (the table's 0.1 row).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hectorgrapher_tpu.mapping.scan_matching import correlative_3d as jc
from hectorgrapher_tpu.sensor.types import pad_cloud as jpad_cloud
from hectorgrapher_tpu.transform import np_quat as nq
from hectorgrapher_tpu.transform.rigid import Rigid3 as JRigid3
from hectorgrapher_tpu_torch import convert
from hectorgrapher_tpu_torch.mapping.scan_matching import correlative_3d as tc
from hectorgrapher_tpu_torch.mapping.scan_matching.fast_correlative_3d import grid_match_scores
from hectorgrapher_tpu_torch.transform.rigid import Rigid3
from test_pose_graph_3d_integration import scan_at
from torch_parity import CPU, box_room_submap_3d

torch.set_num_threads(1)

REL = 1e-5  # scores, relative to max(1, max |score|)
WINDOW = jc.make_search_window_3d(0.15, 0.1, 0.1, 3.0)  # k = 2, 2 * 3 + 1 = 7 yaws
WEIGHTS = (0.1, 0.1)


def test_make_search_window_3d_matches_jax():
    for args in ((0.15, math.radians(1.0), 0.1, 60.0), (0.15, math.radians(3.0), 0.1, 3.0),
                 (0.3, 0.1, 0.05, 0.01), (0.0, 0.0, 0.1, 25.0), (1.0, math.pi, 0.45, 0.2)):
        assert tuple(tc.make_search_window_3d(*args)) == tuple(jc.make_search_window_3d(*args))
    assert tuple(WINDOW)[0::2] == (3, 2)


@pytest.fixture(scope="module", params=["PROBABILITY_GRID", "TSDF"])
def submap(request):
    s = box_room_submap_3d(hi_shape=(48, 48, 48), lo_shape=(12, 12, 12), grid_type=request.param)
    return s.high_resolution_grid, convert.grid_3d(s.high_resolution_grid, CPU)


def _f32_rotate(q, v):
    """quat_rotate's 15-multiply form in float32, each operation rounded."""
    q, v = q.astype(np.float32), v.astype(np.float32)
    u, w = q[..., 1:], q[..., :1]

    def cross(a, b):
        return np.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1], a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                         a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], axis=-1)

    uv = cross(u, v)
    return v + np.float32(2.0) * (w * uv + cross(u, uv))


def table_scores(field, min_corner, res, pts, mask, t0, q0, window, tw, rw):
    """Every candidate's penalized score through JAX's shifted-field table
    (correlative_3d.py :88-121), in numpy."""
    f32 = np.float32
    n_th, k = 2 * window.num_angles + 1, window.num_linear
    d = 2 * k + 1
    thetas = (np.arange(n_th, dtype=f32) - f32(window.num_angles)) * f32(window.angle_step)
    half = f32(0.5) * thetas
    yaw_q = np.stack([np.cos(half), 0 * half, 0 * half, np.sin(half)], axis=-1).astype(f32)
    base = _f32_rotate(q0[None, :], pts) + t0[None, :]
    rel = base - t0[None, :]
    rot = _f32_rotate(yaw_q[:, None, :], rel[None, :, :]) + t0[None, None, :]
    idx = np.floor((rot - min_corner) / res).astype(np.int64)
    nx, ny, nz = field.shape
    ex, ey, ez = nx + 2 * k, ny + 2 * k, nz + 2 * k
    pad = np.pad(field, 2 * k, constant_values=0.1)
    table = np.stack([pad[dx + k:dx + k + ex, dy + k:dy + k + ey, dz + k:dz + k + ez].reshape(-1)
                      for dx in range(-k, k + 1) for dy in range(-k, k + 1) for dz in range(-k, k + 1)], axis=-1)
    table = np.concatenate([table, np.full((1, d**3), 0.1, f32)])
    c = idx + k
    ok = np.all((c >= 0) & (c < np.array([ex, ey, ez])), axis=-1)
    rows = table[np.where(ok, (c[..., 0] * ey + c[..., 1]) * ez + c[..., 2], ex * ey * ez)]
    rows = np.where(mask[None, :, None], rows, 0.0).astype(np.float64)
    scores = rows.sum(axis=1) / max(int(mask.sum()), 1)
    offs = (np.arange(d, dtype=f32) - f32(k)) * f32(res)
    dist = np.sqrt(offs[:, None, None] ** 2 + offs[None, :, None] ** 2 + offs[None, None, :] ** 2)
    penalty = np.exp(-((dist[None] * tw + np.abs(thetas)[:, None, None, None] * rw) ** 2))
    return (scores.reshape(n_th, d, d, d) * penalty).astype(np.float64)


CASES = {
    # (scan place, scan yaw, initial offset, initial yaw, extra points far outside the grid)
    "near_truth": ((0.2, -0.1, 0.0), 0.02, (0.1, -0.1, 0.05), 0.0, 0),
    "yawed": ((0.0, 0.3, 0.1), -0.05, (-0.1, 0.0, 0.0), 0.03, 0),
    "bases_outside": ((0.1, 0.0, 0.0), 0.0, (2.2, 0.0, 0.0), 0.0, 64),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_match_correlative_3d_matches_jax(submap, case):
    jgrid, grid = submap
    place, yaw, offset, start_yaw, far = CASES[case]
    pts = scan_at(np.asarray(place), yaw, n_az=64, n_el=16)
    if far:  # points 8-12 m out: bases beyond the grid's k-cell margin
        rng = np.random.default_rng(3)
        pts = np.concatenate([pts, rng.uniform(8.0, 12.0, (far, 3)).astype(np.float32)])
    jcloud = jpad_cloud(pts, 1024)
    cloud = convert.point_cloud(jcloud, CPU)
    t0 = (np.asarray(place) + np.asarray(offset)).astype(np.float32)
    q0 = nq.quat_from_axis_angle(np.array([0.0, 0.0, start_yaw])).astype(np.float32)

    want_score, want_pose = jc.match_correlative_3d(jgrid, jcloud, JRigid3(jnp.asarray(t0), jnp.asarray(q0)), WINDOW,
                                                    *WEIGHTS)
    initial = Rigid3(torch.from_numpy(t0), torch.from_numpy(q0))
    scores, _, _ = tc.correlative_scores_3d(grid, cloud, initial, WINDOW, *WEIGHTS)
    got_score, got_pose = tc.match_correlative_3d(grid, cloud, initial, WINDOW, *WEIGHTS)

    field = grid_match_scores(grid).numpy()
    ref = table_scores(field, grid.meta.min_corner.numpy(), np.float32(grid.meta.resolution), pts_pad(jcloud),
                       np.asarray(jcloud.mask), t0, q0, WINDOW, *WEIGHTS)
    tol = REL * max(1.0, float(np.abs(ref).max()))
    assert scores.shape == ref.shape and scores.dtype == torch.float32
    np.testing.assert_allclose(scores.numpy(), ref, rtol=0, atol=tol)
    assert abs(float(got_score) - float(want_score)) <= tol
    assert float(got_score) == float(scores.max())

    top2 = torch.topk(scores.reshape(-1), 2).values
    print(f"{case}: the winner leads by {float(top2[0] - top2[1]):.3e}, tolerance {tol:.1e}")
    if float(top2[0] - top2[1]) > tol:
        np.testing.assert_allclose(got_pose.translation.numpy(), np.asarray(want_pose.translation), atol=1e-6)
        np.testing.assert_allclose(got_pose.rotation.numpy(), np.asarray(want_pose.rotation), atol=1e-6)
    if case == "bases_outside":
        base_cells = np.floor((pts[-far:] + t0 - grid.meta.min_corner.numpy()) / float(grid.meta.resolution))
        assert (np.any((base_cells < -2) | (base_cells >= 48 + 2), axis=-1)).all()


def pts_pad(jcloud):
    return np.asarray(jcloud.positions, np.float32)


def test_match_correlative_3d_builds_no_table(submap, monkeypatch):
    """The search's largest tensor is the T x N x d^3 candidate gather, not
    the (n + 2k)^3 x d^3 table (here 52^3 x 125 floats)."""
    _, grid = submap
    cloud = convert.point_cloud(jpad_cloud(scan_at(np.zeros(3), n_az=64, n_el=16), 1024), CPU)
    largest = []
    real_where = torch.where

    def where(*args):
        out = real_where(*args)
        if len(args) == 3:
            largest.append(out.numel())
        return out

    monkeypatch.setattr(torch, "where", where)
    tc.match_correlative_3d(grid, cloud, Rigid3(torch.zeros(3), torch.tensor([1.0, 0, 0, 0])), WINDOW, *WEIGHTS)
    n_th, d = 2 * WINDOW.num_angles + 1, 2 * WINDOW.num_linear + 1
    assert max(largest) == n_th * 1024 * d**3
    assert max(largest) < (48 + 4) ** 3 * d**3
