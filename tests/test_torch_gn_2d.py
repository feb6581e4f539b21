"""Parity of the port's Gauss-Newton refinement (hectorgrapher_tpu_torch)
with the JAX package's match_gn_2d_probability and its batched form, on a
smaller copy of tests/test_scan_matching_2d.py's room fixture.

Tolerance: poses within 1e-4 — f32 sums over the wide lanes and the points
are taken in different orders, and the rotated points may round
differently (XLA may contract them into FMAs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hectorgrapher_tpu.mapping.scan_matching.gn_2d import (
    match_gn_2d_probability,
    match_gn_2d_probability_batched,
)
from hectorgrapher_tpu.sensor.types import PointCloud
from hectorgrapher_tpu.transform.rigid import Rigid2
from hectorgrapher_tpu_torch import convert
from hectorgrapher_tpu_torch.mapping.scan_matching import gn_2d as tgn
from hectorgrapher_tpu_torch.sensor.types import PointCloud as TPointCloud
from hectorgrapher_tpu_torch.transform.rigid import Rigid2 as TRigid2
from torch_parity import CPU, perturbations, room_grid_and_cloud

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene():
    grid, cloud, _ = room_grid_and_cloud(size=256, num_rays=360, capacity=512, inserts=5)
    return grid, cloud, convert.probability_grid(grid, CPU), convert.point_cloud(cloud, CPU)


@pytest.mark.parametrize(
    "offset, weights, iters",
    [
        ((0.06, -0.04, 0.02), (1.0, 0.1, 0.1), 20),  # test_refines_small_offset
        ((0.0, 0.0, 0.0), (1.0, 10.0, 40.0), 10),  # test_stays_at_optimum
        ((0.04, -0.03, 0.01), (1.0, 0.3, 1.0), 15),  # test_final_cost_matches_direct_interpolation
    ],
)
def test_single_matches_jax(scene, offset, weights, iters):
    grid, cloud, tgrid, tcloud = scene
    t = np.array(offset[:2], np.float32)
    a = np.float32(offset[2])
    pose_j, cost_j = match_gn_2d_probability(
        grid, cloud, Rigid2(jnp.asarray(t), jnp.asarray(a)), jnp.asarray(t), *weights, num_iterations=iters
    )
    tt = torch.from_numpy(t)
    pose_t, cost_t = tgn.match_gn_2d_probability(
        tgrid, tcloud, TRigid2(tt, torch.tensor(a)), tt, *weights, num_iterations=iters
    )
    np.testing.assert_allclose(pose_t.translation.numpy(), np.asarray(pose_j.translation), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(pose_t.angle), float(pose_j.angle), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(cost_t), float(cost_j), rtol=1e-4, atol=1e-7)


def test_batched_matches_jax_and_serial(scene):
    """Batched against JAX's vmap, and each frozen lane against the port's
    own serial solve."""
    grid, cloud, tgrid, tcloud = scene
    b = 4
    offs, angs = perturbations(7, b, lin=0.05, ang=0.015)
    clouds = PointCloud(
        positions=jnp.broadcast_to(cloud.positions, (b,) + cloud.positions.shape),
        mask=jnp.broadcast_to(cloud.mask, (b,) + cloud.mask.shape),
    )
    poses_j, costs_j = match_gn_2d_probability_batched(
        grid, clouds, Rigid2(jnp.asarray(offs), jnp.asarray(angs)), jnp.asarray(offs),
        1.0, 10.0, 40.0, num_iterations=8,
    )
    toffs, tangs = torch.from_numpy(offs), torch.from_numpy(angs)
    tclouds = TPointCloud(tcloud.positions.expand(b, -1, -1), tcloud.mask.expand(b, -1))
    poses_t, costs_t = tgn.match_gn_2d_probability_batched(
        tgrid, tclouds, TRigid2(toffs, tangs), toffs, 1.0, 10.0, 40.0, num_iterations=8
    )
    np.testing.assert_allclose(poses_t.translation.numpy(), np.asarray(poses_j.translation), rtol=0, atol=1e-4)
    np.testing.assert_allclose(poses_t.angle.numpy(), np.asarray(poses_j.angle), rtol=0, atol=1e-4)
    np.testing.assert_allclose(costs_t.numpy(), np.asarray(costs_j), rtol=1e-4, atol=1e-7)
    for i in range(b):
        pose_i, cost_i = tgn.match_gn_2d_probability(
            tgrid, tcloud, TRigid2(toffs[i], tangs[i]), toffs[i], 1.0, 10.0, 40.0, num_iterations=8
        )
        np.testing.assert_allclose(poses_t.translation[i].numpy(), pose_i.translation.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(float(poses_t.angle[i]), float(pose_i.angle), rtol=0, atol=1e-6)
