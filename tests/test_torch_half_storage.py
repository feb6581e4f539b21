"""Parity of the port's half-precision TSDF storage (grid_storage_dtype
"float16" and "bfloat16") with the JAX package's, on the CPU with the same
seeded inputs: convert.py, the TSDF inserter, ActiveSubmaps3D, the TSDF
stencil and the window solve's normal equations and solve at is_tsdf=True
(kernel K3's plain version over half volumes), the fast matcher's score
field and pyramid, serial and packed GN3D, a round of mixed storage
dtypes, the pack's bytes, and a 2 s MapBuilder 3D drive on float16.

Tolerances, each with its reason:
  * convert.py: bit for bit (torch.equal of the planes' bits);
  * inserter and submaps: weights and tsd within 1e-5 plus one ulp of the
    storage dtype in all but 1e-4 of the cells (ROADMAP C3's tolerance:
    under the tests' x64 mode the JAX band points are float64, C1; the
    f32 update rounded to the storage dtype may then land one ulp over);
  * stencil, scan blocks, normal equations, solve, match scores, pyramid,
    GN3D: those of the f32 tests (tests/test_torch_ct_window.py,
    test_torch_fast_correlative_3d.py, test_torch_gn_3d.py,
    test_torch_constraint_search_3d.py): both packages upcast each half
    tap to f32 exactly before any arithmetic, so the f32 arithmetic and
    its tolerances carry over;
  * K3's plain version over half volumes is bit-equal to it over the same
    volumes upcast to f32;
  * the MapBuilder drive: global poses within 1e-3 m
    (tests/test_torch_pose_graph_3d.py's bound).
"""

import copy

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import hectorgrapher_tpu_torch.mapping.pose_graph.pose_graph as pg_mod
from hectorgrapher_tpu.common import config as jcfg
from hectorgrapher_tpu.mapping.ct import window_solver as jws
from hectorgrapher_tpu.mapping.grids import grid_nbytes as jgrid_nbytes
from hectorgrapher_tpu.mapping.grids import make_tsdf_grid
from hectorgrapher_tpu.mapping.inserters_3d import make_tsdf_inserter_3d
from hectorgrapher_tpu.mapping.map_builder import MapBuilder as JMapBuilder
from hectorgrapher_tpu.mapping.scan_matching import fast_correlative_3d as jfc
from hectorgrapher_tpu.mapping.scan_matching import gn_3d as jgn
from hectorgrapher_tpu.mapping.scan_matching.interpolated_grid import (
    gather_rows_3d,
    prepare_grid_3d,
    tsdf_value_and_dfrac,
)
from hectorgrapher_tpu.mapping.submap_3d import ActiveSubmaps3D
from hectorgrapher_tpu.sensor.types import PointCloud as JPointCloud
from hectorgrapher_tpu.sensor.types import RangeData, TimedPointCloudData, pad_cloud, pad_timed_cloud
from hectorgrapher_tpu.transform import np_quat as nq
from hectorgrapher_tpu.transform.np_quat import NpRigid3
from hectorgrapher_tpu.transform.rigid import Rigid3 as JRigid3
from hectorgrapher_tpu_torch import convert
from hectorgrapher_tpu_torch.mapping import grids as tgrids
from hectorgrapher_tpu_torch.mapping import inserters_3d as tins
from hectorgrapher_tpu_torch.mapping import submap_3d as tsub
from hectorgrapher_tpu_torch.mapping.ct import window_solver as tws
from hectorgrapher_tpu_torch.mapping.map_builder import MapBuilder
from hectorgrapher_tpu_torch.mapping.scan_matching import fast_correlative_3d as tfc
from hectorgrapher_tpu_torch.mapping.scan_matching import interpolated_grid as tig
from hectorgrapher_tpu_torch.mapping.scan_matching.gn_3d import match_gn_3d, match_gn_3d_packed, prepare_gn_pack_3d
from hectorgrapher_tpu_torch.ops import ct_scan_block as k3
from hectorgrapher_tpu_torch.parallel import constraint_search as tcs
from hectorgrapher_tpu_torch.sensor import types as ttypes
from hectorgrapher_tpu_torch.sensor.types import PointCloud
from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3 as TNpRigid3
from hectorgrapher_tpu_torch.transform.rigid import Rigid3
from test_batched_constraint_path import options_3d
from test_map_builder_3d import make_options
from test_pose_graph_3d_integration import node_clouds, pose_graph_options, scan_at
from test_torch_constraint_search_3d import _small_node
from test_torch_ct_builder import _room_range_data
from torch_parity import (
    CPU,
    batched_anchors_3d,
    box_room_submap_3d,
    ct_drive,
    ct_example,
    inter_constraints,
    port_drive_3d,
    rotated_state,
)

torch.set_num_threads(1)

DTYPES = ["float16", "bfloat16"]
JAX_DTYPE = {"float16": jnp.float16, "bfloat16": jnp.bfloat16}
TORCH_DTYPE = {"float16": torch.float16, "bfloat16": torch.bfloat16}
MANTISSA_BITS = {"float16": 10, "bfloat16": 7}
WEIGHTS = (5.0, 30.0, 10.0, 1.0)  # ceres_scan_matcher_3d: weights 5 / 30, translation 10, rotation 1


def _half(grid, dtype):
    """A JAX TSDFGrid with its planes cast to the storage dtype."""
    return grid._replace(tsd=grid.tsd.astype(JAX_DTYPE[dtype]), weight=grid.weight.astype(JAX_DTYPE[dtype]))


def _half_submap(submap, dtype):
    out = copy.copy(submap)
    out.high_resolution_grid = _half(submap.high_resolution_grid, dtype)
    out.low_resolution_grid = _half(submap.low_resolution_grid, dtype)
    return out


def _f32(x):
    return x.to(torch.float32).numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _ulp(values, dtype):
    """One unit in the last place of the storage dtype at |values| (f32
    numpy), subnormals at the dtype's smallest step."""
    mag = np.maximum(np.abs(values), np.finfo(np.float32).tiny)
    step = np.exp2(np.floor(np.log2(mag)) - MANTISSA_BITS[dtype])
    return np.maximum(step, 2.0 ** -24 if dtype == "float16" else 2.0 ** -133)


def _assert_planes_close(tgrid, jgrid, dtype):
    """C3's tolerance plus one ulp of the storage dtype, in all but 1e-4 of
    the cells."""
    assert tgrid.tsd.dtype == tgrid.weight.dtype == TORCH_DTYPE[dtype]
    bad = np.zeros(tgrid.tsd.shape, bool)
    for got, want in ((tgrid.tsd, jgrid.tsd), (tgrid.weight, jgrid.weight)):
        g, w = _f32(got), _f32(want)
        bad |= np.abs(g - w) > 1e-5 + _ulp(np.maximum(np.abs(g), np.abs(w)), dtype)
    assert bad.sum() <= max(1, 1e-4 * bad.size), f"{bad.sum()} of {bad.size} cells differ"


def _close(got, want, tol):
    np.testing.assert_allclose(_f32(got), np.asarray(want, np.float32), rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# Storage: convert.py, the inserter, ActiveSubmaps3D
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_convert_carries_half_grids_bit_for_bit(dtype):
    sub = jcfg.SubmapsOptions3D()
    ins = sub.high_resolution_range_data_inserter.tsdf_range_data_inserter
    grid = make_tsdf_grid(0.1, (48,) * 3, ins.relative_truncation_distance * 0.1, ins.maximum_weight,
                          dtype=JAX_DTYPE[dtype])
    grid = make_tsdf_inserter_3d(ins, 0.1)(grid, _room_range_data(3))
    assert np.asarray(grid.tsd).dtype == (np.float16 if dtype == "float16" else ml_dtypes.bfloat16)
    tgrid = convert.tsdf_grid(grid, CPU)
    for got, want in ((tgrid.tsd, grid.tsd), (tgrid.weight, grid.weight)):
        assert got.dtype == TORCH_DTYPE[dtype]
        assert torch.equal(got.view(torch.int16), torch.from_numpy(np.array(want).view(np.int16)))
    assert (np.asarray(grid.weight, np.float32) > 0).sum() > 1000
    assert tgrids.grid_nbytes(tgrid) == jgrid_nbytes(grid) == 2 * 2 * 48**3
    assert tgrids.volume_dtype(tgrid) == TORCH_DTYPE[dtype]


@pytest.mark.parametrize("which", ["high", "low"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_insert_tsdf_3d_half_matches_jax(dtype, which):
    """Three scans through both packages' TSDF inserters into grids stored
    in the half dtype (the port's made by its own make_tsdf_grid)."""
    sub = jcfg.SubmapsOptions3D()
    inserter = (sub.high_resolution_range_data_inserter if which == "high"
                else sub.low_resolution_range_data_inserter).tsdf_range_data_inserter
    res, size = (0.1, 96) if which == "high" else (0.45, 48)
    td = inserter.relative_truncation_distance * res
    grid = make_tsdf_grid(res, (size,) * 3, td, inserter.maximum_weight, dtype=JAX_DTYPE[dtype])
    tgrid = tgrids.make_tsdf_grid(res, (size,) * 3, td, inserter.maximum_weight, CPU, dtype=TORCH_DTYPE[dtype])
    np.testing.assert_array_equal(tgrid.meta.min_corner.numpy(), np.asarray(grid.meta.min_corner))
    insert = make_tsdf_inserter_3d(inserter, res)
    tinsert = tins.make_tsdf_inserter_3d(convert.options(inserter), res)
    for seed in (3, 4, 5):
        rd = _room_range_data(seed)
        grid = insert(grid, rd)
        tgrid = tinsert(tgrid, convert.range_data(rd, CPU))
    assert (_f32(grid.weight) > 0).sum() > 1000
    _assert_planes_close(tgrid, grid, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_active_submaps_half_match_jax(dtype):
    """ActiveSubmaps3D with half storage: TSDF planes in the storage dtype
    from the start, half the bytes of f32 ones, the JAX package's cells;
    occupancy grids refuse half storage in both packages."""
    opts = jcfg.replace_deep(jcfg.SubmapsOptions3D(), {
        "grid_type": "TSDF", "high_grid_size": 48, "low_grid_size": 24, "num_range_data": 2,
        "grid_storage_dtype": dtype})
    jsub = ActiveSubmaps3D(opts)
    tsubmaps = tsub.ActiveSubmaps3D(convert.options(opts), CPU)
    hist = np.ones(120, np.float32)
    for seed, origin in ((3, [0.31, -0.17, 0.05]), (4, [0.63, 0.02, -0.11]), (5, [1.07, 0.4, 0.0])):
        rd = _room_range_data(seed)
        jsub.insert_data(rd, hist, np.asarray(origin))
        tsubmaps.insert_data(convert.range_data(rd, CPU), hist, np.asarray(origin))
    assert len(jsub.submaps) == len(tsubmaps.submaps) == 2
    for js, ts in zip(jsub.submaps, tsubmaps.submaps):
        assert js.num_range_data == ts.num_range_data
        for attr in ("high_resolution_grid", "low_resolution_grid"):
            jg, tg = getattr(js, attr), getattr(ts, attr)
            np.testing.assert_array_equal(tg.meta.min_corner.numpy(), np.asarray(jg.meta.min_corner))
            _assert_planes_close(tg, jg, dtype)
            assert tgrids.grid_nbytes(tg) == jgrid_nbytes(jg) == 2 * 2 * tg.tsd.numel()
        # prepared_grids keeps the half planes: no f32 copy.
        hi, lo = ts.prepared_grids()
        assert hi.tsd is ts.high_resolution_grid.tsd and lo.weight.dtype == TORCH_DTYPE[dtype]
    popts = jcfg.replace_deep(opts, {"grid_type": "PROBABILITY_GRID"})
    with pytest.raises(ValueError, match="only supported for TSDF"):
        ActiveSubmaps3D(popts)
    with pytest.raises(ValueError, match="only supported for TSDF"):
        tsub.ActiveSubmaps3D(convert.options(popts), CPU)


# ---------------------------------------------------------------------------
# K3's plain version, the stencil, the window solve
# ---------------------------------------------------------------------------


def _room_grid(dtype):
    """tests/test_torch_ct_window.py _small_room_grid stored in `dtype`:
    one scan of a 2.5 x 2 x 1.4 m room in a 32^3 grid at 0.1 m, inserted
    by the JAX package's half inserter, and the scan's points."""
    from hectorgrapher_tpu.common.config import TSDFRangeDataInserterOptions3D
    from hectorgrapher_tpu.evaluation.scan_generator import raycast_box_room_3d

    pts = raycast_box_room_3d(np.zeros(3), np.array([1.0, 0, 0, 0]), half_extents=(1.23, 1.01, 0.72))
    pts = pts[~np.isnan(pts[:, 0])]
    opts = TSDFRangeDataInserterOptions3D(normal_computation_method="NONE", min_range=0.1, max_range=30.0)
    rd = RangeData(jnp.zeros(3, jnp.float32), pad_cloud(pts, 1024), pad_cloud(np.zeros((0, 3), np.float32), 4))
    empty = make_tsdf_grid(0.1, (32, 32, 32), 0.25, 1000.0, dtype=JAX_DTYPE[dtype])
    return make_tsdf_inserter_3d(opts, 0.1)(empty, rd), pts


@pytest.mark.parametrize("dtype", DTYPES)
def test_tsdf_stencil_half_matches_jax(dtype):
    """The plain TSDF stencil over half volumes against the JAX stencil
    (which upcasts the planes in its prepare), near the surfaces, on the
    boundary and outside: 1e-5, as in f32."""
    grid, surface = _room_grid(dtype)
    tgrid = convert.tsdf_grid(grid, CPU)
    rng = np.random.default_rng(11)
    res, lo_c = float(grid.meta.resolution), np.asarray(grid.meta.min_corner)
    ext = np.asarray(grid.tsd.shape) * res
    near = surface[rng.choice(len(surface), 768)] + rng.normal(0, 0.5 * res, (768, 3))
    boundary = lo_c + ext - rng.uniform(0.0, 0.1, (64, 3)) * res
    outside = lo_c + rng.choice([-0.2, 1.2], (64, 3)) * ext
    pts = np.concatenate([near, boundary, outside]).astype(np.float32)
    prepared = prepare_grid_3d(grid)
    want_v, want_d = tsdf_value_and_dfrac(prepared, gather_rows_3d(prepared, jnp.asarray(pts)), jnp.asarray(pts))
    got_v, got_d = tig.tsdf_value_and_dfrac_3d(tgrid, torch.from_numpy(pts))
    assert got_v.dtype == got_d.dtype == torch.float32
    assert np.count_nonzero(np.asarray(want_v)[:768]) > 50
    assert not np.asarray(want_v)[768:].any()
    _close(got_v, want_v, 1e-5)
    _close(got_d, want_d, 1e-5)
    # The same volumes upcast to f32 give the same values, bit for bit.
    f32 = tgrid._replace(tsd=tgrid.tsd.float(), weight=tgrid.weight.float())
    for a, b in zip((got_v, got_d), tig.tsdf_value_and_dfrac_3d(f32, torch.from_numpy(pts))):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def ct_fixture():
    return ct_example(grid=32)


@pytest.mark.parametrize("dtype", DTYPES)
def test_window_solve_half_matches_jax(ct_fixture, dtype):
    """The CT fixture's grids stored in `dtype`: K3's plain scan blocks
    bit-equal to them over f32 copies of the same volumes, the window
    solve's normal equations at is_tsdf=True (entry and rotated states)
    within 1e-5 * max(1, max|S|) of JAX's, and an 8-iteration solve within
    1e-5 (tests/test_torch_ct_window.py's tolerances)."""
    hi, lo, problem, state, weights = ct_fixture
    hi, lo = _half(hi, dtype), _half(lo, dtype)
    thi, tlo = convert.tsdf_grid(hi, CPU), convert.tsdf_grid(lo, CPU)
    tproblem, tweights = convert.ct_problem(problem, CPU), convert.ct_weights(weights, CPU)
    assert k3.kernel_mode(thi, tlo, "test") == (k3.MODE_TSDF_F16 if dtype == "float16" else k3.MODE_TSDF_BF16)

    pose7, dpose7 = tws.cloud_poses(convert.ct_state(rotated_state(state, 12), CPU), tproblem)
    scale = torch.full((tproblem.hi_mask.shape[0],), 0.3)
    clouds = (tproblem.hi_points, tproblem.hi_mask, tproblem.lo_points, tproblem.lo_mask, pose7, dpose7, scale, scale)
    up = [g._replace(tsd=g.tsd.float(), weight=g.weight.float()) for g in (thi, tlo)]
    got = k3.ct_scan_block(thi, tlo, *clouds)
    assert all(torch.equal(a, b) for a, b in zip(got, k3.ct_scan_block_plain(*up, *clouds)))
    assert float(got[0].abs().max()) > 0.0

    for st in (state, rotated_state(state, 13)):
        want = [np.asarray(x) for x in jws.ct_normal_equations(hi, lo, problem, st, weights, is_tsdf=True)]
        out = [x.numpy() for x in tws.ct_normal_equations(thi, tlo, tproblem, convert.ct_state(st, CPU), tweights,
                                                           is_tsdf=True)]
        tol = 1e-5 * max(1.0, float(np.abs(want[0]).max()))
        _close(out[0], want[0], tol)
        _close(out[1], want[1], tol)
        np.testing.assert_allclose(out[2], want[2], rtol=1e-5)
    js, jf, ji = jws.solve_ct_window(hi, lo, problem, state, weights, is_tsdf=True, num_iterations=8)
    ts, tf, ti = tws.solve_ct_window(thi, tlo, tproblem, convert.ct_state(state, CPU), tweights, is_tsdf=True,
                                     num_iterations=8)
    assert float(tf) < float(ti)
    np.testing.assert_allclose(float(tf), float(jf), rtol=1e-5)
    for g, w in zip(ts, js):
        _close(g, w, 1e-5)


def test_kernel_mode_refuses_mixed_and_coded_planes(ct_fixture):
    """K3 reads f32, f16 or bf16 planes of one dtype per grid pair; uint16
    codes must be decoded first (prepare_grid_3d)."""
    hi, lo = (convert.tsdf_grid(g, CPU) for g in ct_fixture[:2])
    half = lambda g, dt: g._replace(tsd=g.tsd.to(dt), weight=g.weight.to(dt))
    with pytest.raises(TypeError, match="storage dtype"):
        k3.kernel_mode(half(hi, torch.float16), lo, "test")
    with pytest.raises(TypeError, match="planes"):
        k3.kernel_mode(hi._replace(weight=hi.weight.half()), lo, "test")
    with pytest.raises(TypeError, match="planes"):
        k3.kernel_mode(tgrids.quantize_tsdf_grid(hi), tgrids.quantize_tsdf_grid(lo), "test")
    assert k3.kernel_mode(half(hi, torch.bfloat16), half(lo, torch.bfloat16), "test") == k3.MODE_TSDF_BF16
    pair = (half(hi, torch.float16), half(lo, torch.float16))
    with pytest.raises(TypeError, match="storage dtype"):
        k3.grid_slots([hi, pair[0]], [lo, pair[1]])
    assert k3.grid_slots([pair[0]], [pair[1]]).mode == k3.MODE_TSDF_F16


# ---------------------------------------------------------------------------
# The back end: match scores and pyramid, GN3D, rounds, the pack
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def room_submap():
    return box_room_submap_3d()


@pytest.mark.parametrize("dtype", DTYPES)
def test_match_scores_and_pyramid_half_match_jax(room_submap, dtype):
    """grid_match_scores of a half TSDF is f32 (JAX promotes the quotient by
    the f32 truncation distance) and equal to JAX's; so are the matcher's
    pyramid tables and low-resolution field."""
    submap = _half_submap(room_submap, dtype)
    hi, lo = (convert.tsdf_grid(g, CPU) for g in (submap.high_resolution_grid, submap.low_resolution_grid))
    got = tfc.grid_match_scores(hi)
    want = np.asarray(jfc.grid_match_scores(submap.high_resolution_grid))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    opts = pose_graph_options().constraint_builder.fast_correlative_scan_matcher_3d
    jm = jfc.FastCorrelativeScanMatcher3D(opts, submap.high_resolution_grid, submap.low_resolution_grid,
                                          submap.rotational_histogram, 120)
    tm = tfc.FastCorrelativeScanMatcher3D(convert.options(opts), hi, lo, submap.rotational_histogram, 120)
    assert len(tm._pyramid_levels) == len(jm._pyramid_levels)
    for g, w in zip(tm._pyramid_levels, jm._pyramid_levels):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tm._low_scores.numpy(), np.asarray(jm._low_scores), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_match_gn_3d_half_matches_jax(room_submap, dtype):
    """Serial GN3D over a half submap: pose within 1e-4, cost within 1e-5
    relative (tests/test_torch_gn_3d.py's tolerances)."""
    submap = _half_submap(room_submap, dtype)
    hi, lo = (convert.tsdf_grid(g, CPU) for g in (submap.high_resolution_grid, submap.low_resolution_grid))
    truth, yaw = np.array([0.3, -0.2, 0.0]), 0.0
    high, low, _ = node_clouds(scan_at(truth, yaw))
    t0 = (truth + np.array([0.04, -0.03, 0.02])).astype(np.float32)
    q0 = nq.quat_from_axis_angle(np.array([0.01, -0.01, 0.03])).astype(np.float32)
    want_pose, want_cost = jgn.match_gn_3d(submap.high_resolution_grid, submap.low_resolution_grid, high, low,
                                           JRigid3(jnp.asarray(t0), jnp.asarray(q0)), jnp.asarray(t0), *WEIGHTS,
                                           num_iterations=10)
    got_pose, got_cost = match_gn_3d(hi, lo, convert.point_cloud(high, CPU), convert.point_cloud(low, CPU),
                                     Rigid3(torch.from_numpy(t0), torch.from_numpy(q0)), torch.from_numpy(t0),
                                     *WEIGHTS, num_iterations=10)
    _close(got_pose.translation, want_pose.translation, 1e-4)
    _close(got_pose.rotation, want_pose.rotation, 1e-4)
    assert abs(float(got_cost) - float(want_cost)) <= 1e-5 * abs(float(want_cost))
    assert np.linalg.norm(got_pose.translation.numpy() - truth) < np.linalg.norm(t0 - truth)


@pytest.fixture(scope="module")
def anchors():
    return batched_anchors_3d()


@pytest.mark.parametrize("dtype", DTYPES)
def test_packed_gn_half_matches_jax_and_serial(anchors, dtype):
    """Packed GN3D over two half anchors (three lanes, the first submap
    twice): within 1e-4 of JAX's match_gn_3d_packed, each lane within 1e-5
    of the port's serial match_gn_3d (tests/test_torch_constraint_search_3d.py)."""
    half = [_half_submap(a, dtype) for a in anchors]
    lanes = [(0, [0.3, -0.2, 0.0], 0.0, [0.04, -0.03, 0.02], 0.03),
             (1, [0.5, 0.2, 0.05], 0.1, [-0.05, 0.02, 0.0], 0.06),
             (0, [0.1, 0.1, 0.0], 0.0, [0.03, 0.03, -0.02], -0.02)]
    clouds, t0s, q0s = [], [], []
    for _, truth, yaw, offset, start_yaw in lanes:
        clouds.append(_small_node(truth, yaw, 512)[:2])
        t0s.append((np.asarray(truth) + np.asarray(offset)).astype(np.float32))
        q0s.append(nq.quat_from_axis_angle(np.array([0.01, -0.01, start_yaw])).astype(np.float32))
    t0, q0 = np.stack(t0s), np.stack(q0s)
    lane_d = np.array([d for d, *_ in lanes], np.int32)
    stack = lambda *xs: jnp.stack(xs)
    flat_hi, tmpl_hi, mc_hi, r_hi = jgn.prepare_gn_pack_3d(jax.tree.map(stack, *[a.high_resolution_grid for a in half]))
    flat_lo, tmpl_lo, mc_lo, r_lo = jgn.prepare_gn_pack_3d(jax.tree.map(stack, *[a.low_resolution_grid for a in half]))
    jclouds = [JPointCloud(jnp.stack([c[k].positions for c in clouds]), jnp.stack([c[k].mask for c in clouds]))
               for k in (0, 1)]
    want, _ = jgn.match_gn_3d_packed(flat_hi, flat_lo, tmpl_hi, tmpl_lo, mc_hi, mc_lo, jnp.asarray(lane_d),
                                     *jclouds, JRigid3(jnp.asarray(t0), jnp.asarray(q0)), jnp.asarray(t0), *WEIGHTS,
                                     r_hi=r_hi, r_lo=r_lo, num_iterations=10)
    hi = [convert.tsdf_grid(a.high_resolution_grid, CPU) for a in half]
    lo = [convert.tsdf_grid(a.low_resolution_grid, CPU) for a in half]
    tclouds = [PointCloud(torch.stack([convert.point_cloud(c[k], CPU).positions for c in clouds]),
                          torch.stack([convert.point_cloud(c[k], CPU).mask for c in clouds])) for k in (0, 1)]
    pack = prepare_gn_pack_3d(hi, lo)
    assert pack.mode == (k3.MODE_TSDF_F16 if dtype == "float16" else k3.MODE_TSDF_BF16)
    got, _ = match_gn_3d_packed(pack, torch.from_numpy(lane_d), *tclouds,
                                Rigid3(torch.from_numpy(t0), torch.from_numpy(q0)), torch.from_numpy(t0), *WEIGHTS,
                                num_iterations=10)
    _close(got.translation, want.translation, 1e-4)
    _close(got.rotation, want.rotation, 1e-4)
    for b, (d, *_) in enumerate(lanes):
        one, _ = match_gn_3d(hi[d], lo[d], convert.point_cloud(clouds[b][0], CPU),
                             convert.point_cloud(clouds[b][1], CPU),
                             Rigid3(torch.from_numpy(t0[b]), torch.from_numpy(q0[b])), torch.from_numpy(t0[b]),
                             *WEIGHTS, num_iterations=10)
        _close(got.translation[b], one.translation.numpy(), 1e-5)
        _close(got.rotation[b], one.rotation.numpy(), 1e-5)


def test_mixed_storage_round_falls_back_to_serial(anchors, monkeypatch):
    """A round over an f32 submap and an f16 one (K3's slot table reads one
    storage dtype) takes the serial path, once, counted in
    batched_fallbacks, and finds the serial search's constraints; a round
    of two f16 submaps stays batched."""
    calls = []
    orig = pg_mod._observe_batched_round
    monkeypatch.setattr(pg_mod, "_observe_batched_round", lambda n: (calls.append(n), orig(n)))
    mixed = (anchors[0], _half_submap(anchors[1], "float16"))
    pg = port_drive_3d(mixed, options_3d(True))
    serial = port_drive_3d(mixed, options_3d(False))
    assert calls == [] and pg.batched_fallbacks == 1
    got, want = inter_constraints(pg), inter_constraints(serial)
    assert len(got) >= 1 and [(n, s) for n, s, _ in got] == [(n, s) for n, s, _ in want]
    for (_, _, a), (_, _, b) in zip(got, want):
        np.testing.assert_allclose(a.zbar.t, b.zbar.t, rtol=0, atol=1e-3)
    half = port_drive_3d(tuple(_half_submap(a, "float16") for a in anchors), options_3d(True))
    assert calls and half.batched_fallbacks == 0


def test_pack_of_half_submaps_counts_f32_tables(anchors):
    """The pack of half submaps holds f32 pyramids (grid_match_scores
    upcasts), so its bytes equal an f32 pack's; the pack's byte count is
    the sum of host_arrays_3d_nbytes over its members, and the gauge
    reports it."""
    pgs = {}
    for name, subs in (("f32", anchors), ("f16", tuple(_half_submap(a, "float16") for a in anchors))):
        pgs[name] = port_drive_3d(subs, options_3d(True))
        pack = pgs[name]._pack3d
        assert pack is not None and all(t.dtype == torch.float32 for t in pack["packed"].pyramids)
        assert pack["bytes"] == sum(tcs.host_arrays_3d_nbytes(pack["host"][sid]) for sid in pack["order"])
        assert f"pose_graph_constraint_pack_bytes_3d {pack['bytes']}" in pg_mod.profiling.report()
    assert pgs["f16"]._pack3d["bytes"] == pgs["f32"]._pack3d["bytes"]


# ---------------------------------------------------------------------------
# MapBuilder 3D on float16 TSDF submaps
# ---------------------------------------------------------------------------


def test_map_builder_float16_drive_matches_jax():
    """tests/test_torch_pose_graph_3d.py's 2 s MapBuilder 3D drive with
    grid_storage_dtype="float16" through both packages (async off, serial
    search): equal node and constraint lists, global poses within 1e-3 m,
    the submaps' planes in f16."""
    sync = {"async_work_queue": False, "use_batched_constraint_search": False}
    jopts = jcfg.replace_deep(make_options(), {
        "trajectory_builder_3d.submaps.grid_storage_dtype": "float16",
        **{f"pose_graph.{k}": v for k, v in sync.items()}})
    jmb = JMapBuilder(jopts)
    mb = MapBuilder(convert.options(jopts), device=CPU)
    jtb = jmb.get_trajectory_builder(jmb.add_trajectory_builder())
    tb = mb.get_trajectory_builder(mb.add_trajectory_builder())
    want = ct_drive(jtb, NpRigid3, TimedPointCloudData, pad_timed_cloud, duration=2.0)
    got = ct_drive(tb, TNpRigid3, ttypes.TimedPointCloudData, ttypes.pad_timed_cloud, duration=2.0)
    assert len(got) == len(want)
    for (t, p), (jt, jp) in zip(got, want):
        assert t == jt
        np.testing.assert_allclose(p.t, jp.t, rtol=0, atol=1e-3)
    jpg, pg = jmb.pose_graph, mb.pose_graph
    assert len(pg.nodes) == len(jpg.nodes) >= 8
    assert all(s.submap.high_resolution_grid.tsd.dtype == torch.float16 for s in pg.submaps)
    jpg.run_final_optimization()
    pg.run_final_optimization()
    assert [(c.tag, c.submap_index, c.node_index) for c in pg.constraints] == [
        (c.tag, c.submap_index, c.node_index) for c in jpg.constraints]
    for n, jn in zip(pg.nodes, jpg.nodes):
        np.testing.assert_allclose(n.global_pose.t, jn.global_pose.t, rtol=0, atol=1e-3)
