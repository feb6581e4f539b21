"""Parity of the port's 2D TSDF path (hectorgrapher_tpu_torch) with the JAX
package's, on the CPU with the same seeded numpy inputs: the 2D normals,
the TSDF inserter, the 2D field helpers, the TSDF refinement and the TSDF
front end (LocalTrajectoryBuilder2D on TSDF submaps).

Tolerances, each with its reason:
  * normals: 1e-5 where the tangent is defined (its norm above 1e-6; at
    a tangent near the 1e-9 switch the packages may take different
    branches, ROADMAP C16);
  * inserter: tsd and weight within 1e-5 in all but 1e-4 of the cells
    (ROADMAP C3: the card sums with atomics; C1: under the tests' x64 mode
    the JAX band is float64 and may move a sample across a cell border);
  * field helpers: 1e-5 (the same f32 taps and weights);
  * TSDF refinement: pose within 1e-4 (tests/test_torch_gn_2d.py's
    tolerance), cost within 1e-3 relative;
  * front end: local poses within 1e-3 m and 1e-3 rad
    (tests/test_torch_front_end_2d.py's bound).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hectorgrapher_tpu.common import config as jcfg
from hectorgrapher_tpu.evaluation.scan_generator import raycast_rect_room_2d
from hectorgrapher_tpu.mapping import inserters_2d as jins
from hectorgrapher_tpu.mapping.grids import make_probability_grid, make_tsdf_grid
from hectorgrapher_tpu.mapping.inserters_2d import make_probability_inserter_2d
from hectorgrapher_tpu.mapping.local_2d import LocalTrajectoryBuilder2D
from hectorgrapher_tpu.mapping.scan_matching import gn_2d as jgn
from hectorgrapher_tpu.mapping.scan_matching import interpolated_grid as jig
from hectorgrapher_tpu.sensor.types import PointCloud, RangeData, TimedPointCloudData, pad_cloud, pad_timed_cloud
from hectorgrapher_tpu.transform import np_quat as nq
from hectorgrapher_tpu.transform.np_quat import NpRigid3
from hectorgrapher_tpu.transform.rigid import Rigid2 as JRigid2
from hectorgrapher_tpu_torch import convert
from hectorgrapher_tpu_torch.mapping import inserters_2d as tins
from hectorgrapher_tpu_torch.mapping import local_2d as tlocal
from hectorgrapher_tpu_torch.mapping.scan_matching import gn_2d as tgn
from hectorgrapher_tpu_torch.mapping.scan_matching import interpolated_grid as tig
from hectorgrapher_tpu_torch.sensor import types as ttypes
from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3 as TNpRigid3
from hectorgrapher_tpu_torch.transform.rigid import Rigid2
from torch_parity import CPU

torch.set_num_threads(1)

SCANS = (((0.0, 0.0), 0.0), ((0.3, 0.1), 0.2), ((0.5, -0.2), 0.4))


SMALL_ROOM = (2.4, 1.9)  # half extents that fit a 128^2 grid at 0.05 m


def scan_range_data(seed, xy, yaw, n_rays=720, capacity=1024, drop=0.0, room=(5.02, 3.93)):
    """A scan of a room of half extents `room` from (xy, yaw) in the local
    frame, its returns sorted by scan angle; with `drop`, that share of the
    returns masked out."""
    rng = np.random.default_rng(seed)
    pts = raycast_rect_room_2d(np.asarray(xy), yaw, half_width=room[0], half_height=room[1], num_rays=n_rays,
                               noise_std=0.01, rng=rng)
    pts = pts[~np.isnan(pts[:, 0])]
    c, s = np.cos(yaw), np.sin(yaw)
    world = pts @ np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]]) + np.array([xy[0], xy[1], 0.0])
    returns = pad_cloud(world.astype(np.float32), capacity)
    if drop:
        keep = np.asarray(returns.mask) & (rng.random(capacity) >= drop)
        returns = returns._replace(mask=jnp.asarray(keep))
    return RangeData(origin=jnp.asarray([xy[0], xy[1], 0.0], jnp.float32), returns=returns,
                     misses=pad_cloud(np.zeros((0, 3), np.float32), 8))


def _tangent_norm(returns, sample_radius, num_normal_samples):
    """The tangent's norm of estimate_normals_2d, in f64 numpy."""
    pts = np.asarray(returns.positions, np.float64)[:, :2]
    mask = np.asarray(returns.mask)
    tangent = np.zeros_like(pts)
    for k in range(1, max(1, num_normal_samples // 2) + 1):
        for sign in (-1, 1):
            other = np.roll(pts, sign * k, axis=0)
            d = (other - pts) * -sign
            ok = np.roll(mask, sign * k) & (np.linalg.norm(d, axis=-1) < sample_radius)
            tangent += np.where(ok[:, None], d, 0.0)
    return np.linalg.norm(tangent, axis=-1)


@pytest.mark.parametrize("num_normal_samples", [2, 4, 8])
def test_estimate_normals_match_jax(num_normal_samples):
    """Scans with a fifth of the returns masked out, so some points have
    fewer neighbours and the wrap-around joins the scan's two ends."""
    for i, (xy, yaw) in enumerate(SCANS):
        rd = scan_range_data(20 + i, xy, yaw, drop=0.2)
        want = np.asarray(jins.estimate_normals_2d(rd.returns, rd.origin, 0.5, num_normal_samples=num_normal_samples))
        got = tins.estimate_normals_2d(convert.point_cloud(rd.returns, CPU), convert.tensor(rd.origin, CPU), 0.5,
                                       num_normal_samples=num_normal_samples).numpy()
        defined = np.asarray(rd.returns.mask) & (_tangent_norm(rd.returns, 0.5, num_normal_samples) > 1e-6)
        assert defined.sum() > 400
        np.testing.assert_allclose(got[defined], want[defined], rtol=0, atol=1e-5)
        np.testing.assert_allclose(np.linalg.norm(got[defined], axis=-1), 1.0, rtol=0, atol=1e-5)


def _assert_tsdf_close(tgrid, jgrid, tol=1e-5):
    """tsd and weight within tol in all but 1e-4 of the cells (C3, C1)."""
    bad = np.zeros(tgrid.shape, bool)
    for got, want in ((tgrid.tsd, jgrid.tsd), (tgrid.weight, jgrid.weight)):
        bad |= np.abs(got.to(torch.float32).numpy() - np.asarray(want, np.float32)) > tol
    assert bad.sum() <= max(1, 1e-4 * bad.size), f"{bad.sum()} of {bad.size} cells differ"


@pytest.mark.parametrize("range_exponent", [0, 2])
@pytest.mark.parametrize("project_to_normal", [True, False])
def test_insert_tsdf_2d_matches_jax(project_to_normal, range_exponent):
    """Three scans through both packages' make_tsdf_inserter_2d (normals,
    band, weights, scatter-add) into a 256^2 grid off the origin."""
    opts = jcfg.replace_deep(jcfg.TSDFRangeDataInserterOptions2D(), {
        "project_sdf_distance_to_scan_normal": project_to_normal,
        "update_weight_range_exponent": range_exponent,
    })
    grid = make_tsdf_grid(0.05, (256, 256), opts.truncation_distance, opts.maximum_weight, center=(0.3, -0.2))
    tgrid = convert.tsdf_grid(grid, CPU)
    jinsert = jins.make_tsdf_inserter_2d(opts, 0.05)
    tinsert = tins.make_tsdf_inserter_2d(convert.options(opts), 0.05)
    for i, (xy, yaw) in enumerate(SCANS):
        rd = scan_range_data(i, xy, yaw)
        grid = jinsert(grid, rd)
        tgrid = tinsert(tgrid, convert.range_data(rd, CPU))
    assert tgrid.tsd.dtype == torch.float32
    assert 5000 < int((tgrid.weight > 0).sum()) < 256 * 256 // 2
    _assert_tsdf_close(tgrid, grid)


def _tsdf_scene(dtype=jnp.float32):
    """Three scans of SMALL_ROOM inserted into a 128^2 TSDF (JAX), stored
    in `dtype`."""
    opts = jcfg.TSDFRangeDataInserterOptions2D()
    grid = make_tsdf_grid(0.05, (128, 128), opts.truncation_distance, opts.maximum_weight, center=(0.2, 0.1))
    insert = jins.make_tsdf_inserter_2d(opts, 0.05)
    for i, (xy, yaw) in enumerate(SCANS):
        grid = insert(grid, scan_range_data(i, xy, yaw, room=SMALL_ROOM))
    assert int((np.asarray(grid.weight) > 0).sum()) > 1500
    return grid._replace(tsd=grid.tsd.astype(dtype), weight=grid.weight.astype(dtype))


def _probability_scene():
    grid = make_probability_grid(0.05, (128, 128), center=(0.2, 0.1))
    insert = make_probability_inserter_2d(jcfg.ProbabilityGridRangeDataInserterOptions2D(), 6.4, 0.05)
    for i, (xy, yaw) in enumerate(SCANS):
        grid = insert(grid, scan_range_data(i, xy, yaw, room=SMALL_ROOM))
    return grid


def _query_points():
    """Seeded world points over the grid and 0.5 m past each edge."""
    rng = np.random.default_rng(5)
    return (rng.uniform(-3.7, 3.7, (4000, 2)) + np.array([0.2, 0.1])).astype(np.float32)


_HELPERS = {
    # name: (JAX call, port call), each on (JAX grid, port grid, points)
    "interp_bicubic_2d": (lambda g, p: jig.interp_bicubic_2d(g.tsd, g.meta, p, g.truncation_distance),
                          lambda g, p: tig.interp_bicubic_2d(g.tsd, g.meta, p, g.truncation_distance)),
    "interp_bilinear_2d": (lambda g, p: jig.interp_bilinear_2d(g.weight, g.meta, p, 0.0),
                           lambda g, p: tig.interp_bilinear_2d(g.weight, g.meta, p, 0.0)),
    "tsd_at_2d": (lambda g, p: jig.tsd_at_2d(g, p), lambda g, p: tig.tsd_at_2d(g, p)),
    "tsd_at_2d_bilinear": (lambda g, p: jig.tsd_at_2d(g, p, bicubic=False),
                           lambda g, p: tig.tsd_at_2d(g, p, bicubic=False)),
    "tsd_at_2d_float16": (lambda g, p: jig.tsd_at_2d(g, p), lambda g, p: tig.tsd_at_2d(g, p)),
    "prepare_tsdf_2d": (lambda g, p: [jig.interp_prepared_2d(f, p) for f in jig.prepare_tsdf_2d(g)],
                        lambda g, p: [tig.interp_prepared_2d(f, p) for f in tig.prepare_tsdf_2d(g)]),
    "probability_at_2d": (lambda g, p: jig.probability_at_2d(g, p), lambda g, p: tig.probability_at_2d(g, p)),
    "probability_at_2d_bilinear": (lambda g, p: jig.probability_at_2d(g, p, bicubic=False),
                                   lambda g, p: tig.probability_at_2d(g, p, bicubic=False)),
    "prepare_probability_2d": (lambda g, p: jig.interp_prepared_2d(jig.prepare_probability_2d(g), p),
                               lambda g, p: tig.interp_prepared_2d(tig.prepare_probability_2d(g), p)),
    "prepare_field_2d": (lambda g, p: jig.interp_prepared_2d(jig.prepare_field_2d(g.tsd, g.meta, 0.25), p),
                         lambda g, p: tig.interp_prepared_2d(tig.prepare_field_2d(g.tsd, g.meta, 0.25), p)),
}


@pytest.mark.parametrize("name", sorted(_HELPERS))
def test_field_helpers_2d_match_jax(name):
    """The 2D interpolation API (interpolated_grid.py :100-208, :496-570)
    at points inside, on the border of and outside the grid; the float16
    case reads a grid stored in half, padded with its own rounding of the
    truncation distance."""
    if "probability" in name:
        grid = _probability_scene()
        tgrid = convert.probability_grid(grid, CPU)
    else:
        grid = _tsdf_scene(jnp.float16 if name.endswith("float16") else jnp.float32)
        tgrid = convert.tsdf_grid(grid, CPU)
    pts = _query_points()
    jfn, tfn = _HELPERS[name]
    want = jfn(grid, jnp.asarray(pts))
    got = tfn(tgrid, torch.from_numpy(pts))
    want = list(want) if isinstance(want, (tuple, list)) else [want]
    got = list(got) if isinstance(got, (tuple, list)) else [got]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (len(pts),)
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32), rtol=0, atol=1e-5)


def gn_tsdf_scene():
    """tests/test_scan_matching_2d.py:273's scene: a 512^2 TSDF with five
    inserts of a 720-ray room scan from the origin, and that scan."""
    grid = make_tsdf_grid(0.05, (512, 512), truncation_distance=0.3, max_weight=10.0)
    insert = jins.make_tsdf_inserter_2d(jcfg.TSDFRangeDataInserterOptions2D(), resolution=0.05)
    pts = raycast_rect_room_2d(np.zeros(2), 0.0, num_rays=720)
    cloud = pad_cloud(pts[~np.isnan(pts[:, 0])].astype(np.float32), 1024)
    rd = RangeData(origin=jnp.zeros(3, jnp.float32), returns=cloud, misses=pad_cloud(np.zeros((0, 3), np.float32), 8))
    for _ in range(5):
        grid = insert(grid, rd)
    return grid, cloud


@pytest.fixture(scope="module")
def gn_scene():
    return gn_tsdf_scene()


@pytest.mark.parametrize("start", [(0.05, -0.04, 0.015), (-0.06, 0.03, -0.02), (0.02, 0.07, 0.03)])
def test_match_gn_2d_tsdf_matches_jax(gn_scene, start):
    """match_gn_2d_tsdf from three starts, the first the JAX test's, with
    its weights (1, 0.1, 0.1): the pose within 1e-4 of JAX's, and both
    near the truth (the origin) as the JAX test asks."""
    grid, cloud = gn_scene
    t0, a0 = np.array(start[:2], np.float32), np.float32(start[2])
    want, want_cost = jgn.match_gn_2d_tsdf(grid, cloud, JRigid2(jnp.asarray(t0), jnp.asarray(a0)), jnp.asarray(t0),
                                           occupied_space_weight=1.0, translation_weight=0.1, rotation_weight=0.1,
                                           num_iterations=20)
    got, got_cost = tgn.match_gn_2d_tsdf(convert.tsdf_grid(grid, CPU), convert.point_cloud(cloud, CPU),
                                         Rigid2(torch.from_numpy(t0), torch.tensor(a0)), torch.from_numpy(t0),
                                         1.0, 0.1, 0.1, num_iterations=20)
    np.testing.assert_allclose(got.translation.numpy(), np.asarray(want.translation), rtol=0, atol=1e-4)
    assert abs(float(got.angle) - float(want.angle)) <= 1e-4
    np.testing.assert_allclose(float(got_cost), float(want_cost), rtol=1e-3, atol=1e-9)
    np.testing.assert_allclose(got.translation.numpy(), [0.0, 0.0], atol=0.03)
    assert abs(float(got.angle)) <= 0.01


def test_match_gn_2d_tsdf_on_decoded_and_prepared_fields(gn_scene):
    """The refinement decodes a uint16 grid first (prepare_gn_tsdf_fields,
    as JAX's ensure_f32_grid), and prepared_fields reused across calls
    give the same pose as the grid."""
    from hectorgrapher_tpu.mapping.grids import quantize_tsdf_grid

    grid, cloud = gn_scene
    t0, a0 = np.array([0.04, -0.03], np.float32), np.float32(0.01)
    q = quantize_tsdf_grid(grid)
    want, _ = jgn.match_gn_2d_tsdf(q, cloud, JRigid2(jnp.asarray(t0), jnp.asarray(a0)), jnp.asarray(t0), 1.0, 0.1,
                                   0.1, num_iterations=20)
    tq = convert.tsdf_grid(q, CPU)
    assert tq.tsd.dtype == torch.uint16
    args = (convert.point_cloud(cloud, CPU), Rigid2(torch.from_numpy(t0), torch.tensor(a0)), torch.from_numpy(t0),
            1.0, 0.1, 0.1)
    got, _ = tgn.match_gn_2d_tsdf(tq, *args, num_iterations=20)
    np.testing.assert_allclose(got.translation.numpy(), np.asarray(want.translation), rtol=0, atol=1e-4)
    assert abs(float(got.angle) - float(want.angle)) <= 1e-4
    again, _ = tgn.match_gn_2d_tsdf(None, *args, num_iterations=20, prepared_fields=tgn.prepare_gn_tsdf_fields(tq))
    assert torch.equal(again.translation, got.translation) and torch.equal(again.angle, got.angle)


def _tsdf_front_end_options(storage):
    """tests/test_torch_front_end_2d.py's front-end options on TSDF
    submaps of `storage`, three scans a submap so that submaps finish."""
    return jcfg.replace_deep(jcfg.TrajectoryBuilder2DOptions(), {
        "use_imu_data": False,
        "use_online_correlative_scan_matching": True,
        "max_range": 12.0,
        "submaps.grid_options_2d.grid_type": "TSDF",
        "submaps.grid_storage_dtype": storage,
        "submaps.grid_size": 256,
        "submaps.num_range_data": 3,
        "max_num_points": 1024,
        "motion_filter.max_distance_meters": 0.05,
        "motion_filter.max_time_seconds": 0.1,
    })


@pytest.mark.parametrize("storage", ["float32", "uint16"])
def test_tsdf_front_end_matches_jax(storage):
    """LocalTrajectoryBuilder2D on TSDF submaps over 1.5 s of the slice's
    circle through both packages: the correlative matcher skipped, the
    TSDF refinement; with uint16 the scans after each finish match the
    just-quantized submap. Local poses within 1e-3 m / rad."""
    opts = _tsdf_front_end_options(storage)
    jb = LocalTrajectoryBuilder2D(opts)
    tb = tlocal.LocalTrajectoryBuilder2D(convert.options(opts), device=CPU)
    rng = np.random.default_rng(0)
    radius, center = 1.4, (0.6, 0.5)
    n_inserted = 0
    for i in range(15):
        t = 0.1 * i
        a = 2 * np.pi * i / 60
        xy = np.array([center[0] + radius * np.cos(a), center[1] + radius * np.sin(a)])
        q = nq.quat_from_axis_angle(np.array([0.0, 0.0, a + np.pi / 2]))
        odom_t = np.array([xy[0], xy[1], 0.0]) + rng.normal(0, 0.003, 3)
        jb.add_odometry_data(t, NpRigid3(odom_t, q))
        tb.add_odometry_data(t, TNpRigid3(odom_t, q))
        pts = raycast_rect_room_2d(xy, a + np.pi / 2, num_rays=720, noise_std=0.004, rng=rng)
        pts = pts[~np.isnan(pts[:, 0])].astype(np.float32)
        cloud = pad_timed_cloud(pts, np.zeros(len(pts), np.float32), 1024)
        rj = jb.add_range_data(TimedPointCloudData(time=t, origin=np.zeros(3, np.float32), ranges=cloud))
        rt = tb.add_range_data(ttypes.TimedPointCloudData(
            time=t, origin=np.zeros(3, np.float32), ranges=ttypes.TimedPointCloud(cloud.positions, cloud.times,
                                                                                   cloud.mask)))
        np.testing.assert_allclose(rt.local_pose.t, rj.local_pose.t, rtol=0, atol=1e-3)
        dyaw = nq.quat_yaw(rt.local_pose.q) - nq.quat_yaw(rj.local_pose.q)
        assert abs((dyaw + np.pi) % (2 * np.pi) - np.pi) <= 1e-3
        assert (rt.insertion_result is None) == (rj.insertion_result is None)
        n_inserted += rt.insertion_result is not None
    assert n_inserted >= 7  # two finished submaps at least
    submaps = tb.active_submaps.submaps
    assert all(type(s.grid).__name__ == "TSDFGrid" for s in submaps)
    assert bool((submaps[0].grid.weight.to(torch.float32) > 0).any())
