"""Parity of the port's GN3D refinement (hectorgrapher_tpu_torch/mapping/
scan_matching/gn_3d.py) with the JAX package's match_gn_3d, on the CPU
with the same grids, clouds and starting poses, over a TSDF submap and an
occupancy one (the match value 1 - p).

Over the occupancy submap the JAX package's refinement moves away from
the truth in this scene (ROADMAP C15); the port is held to its output.

Tolerances: the refined pose within 1e-4 m / 1e-4 (quaternion entries)
and the final cost within 1e-5 relative. Both read the same eight cells
per point with the same arithmetic (the JAX z-segment tables hold the
grid's values unchanged) and take the same LM steps; the normal equations
sum in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hectorgrapher_tpu.mapping.scan_matching.gn_3d import match_gn_3d as jax_match_gn_3d
from hectorgrapher_tpu.transform import np_quat as nq
from hectorgrapher_tpu.transform.rigid import Rigid3 as JRigid3
from hectorgrapher_tpu_torch import convert
from hectorgrapher_tpu_torch.mapping.scan_matching.gn_3d import match_gn_3d
from hectorgrapher_tpu_torch.transform.rigid import Rigid3
from test_pose_graph_3d_integration import node_clouds, scan_at
from torch_parity import CPU, box_room_submap_3d

torch.set_num_threads(1)

# ConstraintBuilderOptions.ceres_scan_matcher_3d: weights 5 / 30, translation 10, rotation 1.
WEIGHTS = (5.0, 30.0, 10.0, 1.0)


@pytest.fixture(scope="module", params=["TSDF", "PROBABILITY_GRID"])
def scene(request):
    submap = box_room_submap_3d(grid_type=request.param)
    return submap, convert.grid_3d(submap.high_resolution_grid, CPU), convert.grid_3d(
        submap.low_resolution_grid, CPU)


@pytest.mark.parametrize("case", [
    # (truth, truth yaw, start offset, start yaw, only_optimize_yaw)
    ((0.3, -0.2, 0.0), 0.0, (0.04, -0.03, 0.02), 0.03, False),
    ((0.5, 0.2, 0.05), 0.1, (-0.05, 0.02, 0.0), 0.06, False),
    ((0.5, 0.2, 0.05), 0.1, (-0.05, 0.02, 0.0), 0.06, True),
])
def test_match_gn_3d_matches_jax(scene, case):
    submap, hi, lo = scene
    truth, yaw, offset, start_yaw, yaw_only = case
    high, low, _ = node_clouds(scan_at(np.asarray(truth), yaw))
    t0 = (np.asarray(truth) + np.asarray(offset)).astype(np.float32)
    q0 = nq.quat_from_axis_angle(np.array([0.01, -0.01, start_yaw])).astype(np.float32)
    want_pose, want_cost = jax_match_gn_3d(
        submap.high_resolution_grid, submap.low_resolution_grid, high, low,
        JRigid3(jnp.asarray(t0), jnp.asarray(q0)), jnp.asarray(t0), *WEIGHTS, num_iterations=10,
        only_optimize_yaw=yaw_only)
    got_pose, got_cost = match_gn_3d(
        hi, lo, convert.point_cloud(high, CPU), convert.point_cloud(low, CPU),
        Rigid3(torch.from_numpy(t0), torch.from_numpy(q0)), torch.from_numpy(t0), *WEIGHTS, num_iterations=10,
        only_optimize_yaw=yaw_only)
    assert got_pose.translation.dtype == torch.float32 and got_cost.dtype == torch.float32
    np.testing.assert_allclose(got_pose.translation.numpy(), np.asarray(want_pose.translation), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_pose.rotation.numpy(), np.asarray(want_pose.rotation), rtol=0, atol=1e-4)
    assert abs(float(got_cost) - float(want_cost)) <= 1e-5 * abs(float(want_cost))
    # Over the TSDF submap the refinement moves toward the truth.
    if "tsd" in hi._fields:
        assert np.linalg.norm(got_pose.translation.numpy() - np.asarray(truth)) < np.linalg.norm(t0 - np.asarray(truth))
