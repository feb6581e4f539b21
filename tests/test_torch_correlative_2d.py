"""Parity of the port's correlative matcher (hectorgrapher_tpu_torch,
plain kernel versions on the CPU) with the JAX package's: the batched
Pallas path in interpret mode and the per-match XLA path.

Tolerances: the best score within 2/n_valid — the effect of one flipped
cell (XLA may contract the cell arithmetic into an FMA, and torch's and
XLA's cos/sin differ by an ulp at some angles). Poses are equal wherever
JAX's best-versus-runner-up margin exceeds that.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hectorgrapher_tpu.mapping.scan_matching.correlative_2d import (
    _candidate_thetas,
    _prep_candidates,
    _scores_from_prep,
    _wide_patch_table,
    _window_geometry,
    make_search_window,
    match_correlative_2d,
    match_correlative_2d_batched,
    score_volume_dense,
)
from hectorgrapher_tpu.sensor.types import PointCloud
from hectorgrapher_tpu.transform.rigid import Rigid2
from hectorgrapher_tpu_torch import convert
from hectorgrapher_tpu_torch.mapping.scan_matching import correlative_2d as tcorr
from hectorgrapher_tpu_torch.sensor.types import PointCloud as TPointCloud
from hectorgrapher_tpu_torch.transform.rigid import Rigid2 as TRigid2
from torch_parity import CPU, perturbations, room_grid_and_cloud

torch.set_num_threads(1)

B = 8
TW, RW = 0.1, 0.1  # real-time matcher delta cost weights (config defaults)


@pytest.fixture(scope="module")
def scene():
    grid, cloud, max_range = room_grid_and_cloud(size=256, num_rays=720, capacity=1024)
    return grid, cloud, convert.probability_grid(grid, CPU), convert.point_cloud(cloud, CPU), max_range


def _jax_margin(grid, cloud, pose, window):
    """JAX's best-minus-runner-up penalized score of one match."""
    k, gsz, half, m, pw, n_th, n_groups = _window_geometry(window)
    nx, ny = grid.shape
    valid = cloud.mask
    n_valid = jnp.maximum(jnp.sum(valid), 1)
    table = _wide_patch_table(grid.probability(), k, half)
    flat, dlin = _prep_candidates(grid.meta, cloud.positions[:, :2], pose, window, nx, ny)
    scores = np.asarray(_scores_from_prep(table, flat, dlin, valid, n_valid, window))
    dxy = np.arange(-k, k + 1, dtype=np.float32) * np.float32(0.05)
    dist = np.sqrt(dxy[:, None] ** 2 + dxy[None, :] ** 2)
    thetas = np.asarray(_candidate_thetas(window))
    penalty = np.exp(-((dist[None] * TW + np.abs(thetas)[:, None, None] * RW) ** 2))
    s = np.sort((scores * penalty)[:n_th].reshape(-1))
    return float(s[-1] - s[-2])


def _check_matches(scene, window, score_j, pose_j, score_t, pose_t, inits):
    grid, cloud, _, _, _ = scene
    n_valid = float(np.asarray(cloud.mask).sum())
    np.testing.assert_allclose(np.asarray(score_t), np.asarray(score_j), rtol=0, atol=2.0 / n_valid)
    equal_poses = 0
    for i, (t, a) in enumerate(inits):
        margin = _jax_margin(grid, cloud, Rigid2(jnp.asarray(t), jnp.asarray(a)), window)
        if margin > 2.0 / n_valid:
            equal_poses += 1
            np.testing.assert_allclose(np.asarray(pose_t.translation[i]), np.asarray(pose_j.translation[i]), atol=1e-6)
            np.testing.assert_allclose(float(pose_t.angle[i]), float(pose_j.angle[i]), atol=1e-6)
    assert equal_poses >= len(inits) // 2  # the margin test must not skip most matches


@pytest.mark.parametrize("linear_window", [0.15, 0.1])
def test_batched_matches_pallas_interpret(scene, linear_window):
    grid, cloud, tgrid, tcloud, max_range = scene
    window = make_search_window(linear_window, np.radians(10.0), 0.05, max_range)
    offs, angs = perturbations(5, B)
    clouds = PointCloud(
        positions=jnp.broadcast_to(cloud.positions, (B,) + cloud.positions.shape),
        mask=jnp.broadcast_to(cloud.mask, (B,) + cloud.mask.shape),
    )
    score_j, pose_j = match_correlative_2d_batched(
        grid, clouds, Rigid2(jnp.asarray(offs), jnp.asarray(angs)), window, TW, RW,
        use_pallas=True, interpret=True,
    )
    tclouds = TPointCloud(tcloud.positions.expand(B, -1, -1), tcloud.mask.expand(B, -1))
    score_t, pose_t = tcorr.match_correlative_2d_batched(
        tgrid, tclouds, TRigid2(torch.from_numpy(offs), torch.from_numpy(angs)), window, TW, RW
    )
    assert score_t.shape == (B,) and pose_t.translation.shape == (B, 2) and pose_t.angle.shape == (B,)
    _check_matches(scene, window, score_j, pose_j, score_t, pose_t, list(zip(offs, angs)))


def test_per_match_matches_xla(scene):
    grid, cloud, tgrid, tcloud, max_range = scene
    window = make_search_window(0.15, np.radians(10.0), 0.05, max_range)
    offs, angs = perturbations(9, 3)
    scores_j, scores_t, tj, aj, tt, at = [], [], [], [], [], []
    for t, a in zip(offs, angs):
        s, p = match_correlative_2d(grid, cloud, Rigid2(jnp.asarray(t), jnp.asarray(a)), window, TW, RW)
        scores_j.append(float(s)); tj.append(np.asarray(p.translation)); aj.append(float(p.angle))
        s, p = tcorr.match_correlative_2d(tgrid, tcloud, TRigid2(torch.from_numpy(t), torch.tensor(a)), window, TW, RW)
        assert s.shape == () and p.translation.shape == (2,) and p.angle.shape == ()
        scores_t.append(float(s)); tt.append(p.translation.numpy()); at.append(float(p.angle))
    pose_j = Rigid2(np.stack(tj), np.array(aj))
    pose_t = TRigid2(torch.from_numpy(np.stack(tt)), torch.tensor(at))
    _check_matches(scene, window, np.array(scores_j), pose_j, np.array(scores_t), pose_t, list(zip(offs, angs)))


def test_score_volume_matches_dense_oracles(scene):
    """The port's dense oracle equals JAX's up to flipped cells, and the
    port's kernel-path volume equals the port's oracle on a grid quantized
    to the table's bf16 values."""
    grid, cloud, tgrid, tcloud, max_range = scene
    window = make_search_window(0.15, np.radians(10.0), 0.05, max_range)
    n_valid = float(np.asarray(cloud.mask).sum())
    pose = (np.array([0.12, -0.07], np.float32), np.float32(0.03))
    dense_j = np.asarray(score_volume_dense(grid, cloud, Rigid2(jnp.asarray(pose[0]), jnp.asarray(pose[1])), window))
    tpose = TRigid2(torch.from_numpy(pose[0]), torch.tensor(pose[1]))
    dense_t = tcorr.score_volume_dense(tgrid, tcloud, tpose, window).numpy()
    assert dense_t.shape == dense_j.shape
    np.testing.assert_allclose(dense_t, dense_j, rtol=0, atol=2.0 / n_valid)

    prob = tgrid.probability().to(torch.bfloat16).to(torch.float32)
    qgrid = tgrid._replace(log_odds=torch.where(tgrid.known, torch.log(prob / (1.0 - prob)), tgrid.log_odds))
    oracle = tcorr.score_volume_dense(qgrid, tcloud, tpose, window)
    volume = tcorr.score_volume_batched(
        qgrid, TPointCloud(tcloud.positions[None], tcloud.mask[None]),
        TRigid2(tpose.translation[None], tpose.angle.reshape(1)), window,
    )[0]
    # Unknown and out-of-map cells read bf16(0.1) = 0.10009766 in the table
    # but 0.1 in the oracle: at most ~1e-4 of mean score, plus roundoff.
    np.testing.assert_allclose(volume[: oracle.shape[0]].numpy(), oracle.numpy(), rtol=0, atol=2e-4)
