"""Parity of the port's fast 3D correlative matcher and its kernel K4's
plain version (hectorgrapher_tpu_torch/mapping/scan_matching/
fast_correlative_3d.py, ops/fast_scores_3d.py) with the JAX package's CPU
branch, on the CPU with the same inputs, over a TSDF submap and an
occupancy one.

Tolerances: pyramid levels and flat tables are exact (the same max and
copy ops in f32). score_sum's plain version sums f32 values below 0.8 in
chunks of 32 points, as the JAX CPU branch does, over the same integer
cells, each chunk in another order: within 1e-5 * max(1, max |sum|) of it,
the gate chip_smoke.py holds K4 to. Whole matches land on the same pose with scores
within 1e-5, or on a pose whose score ties JAX's within 1e-6 (the beam
breaks ties by index on both sides, ROADMAP C10).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hectorgrapher_tpu.common.config import FastCorrelativeScanMatcherOptions3D
from hectorgrapher_tpu.mapping.scan_matching import fast_correlative_3d as jfc
from hectorgrapher_tpu.transform import np_quat as nq
from hectorgrapher_tpu.transform.rigid import Rigid3 as JRigid3
from hectorgrapher_tpu_torch import convert
from hectorgrapher_tpu_torch.mapping.scan_matching import fast_correlative_3d as tfc
from hectorgrapher_tpu_torch.ops.fast_scores_3d import fast_scores_3d
from hectorgrapher_tpu_torch.transform.rigid import Rigid3 as TRigid3
from test_pose_graph_3d_integration import node_clouds, pose_graph_options, scan_at
from torch_parity import CPU, box_room_submap_3d

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=["TSDF", "PROBABILITY_GRID"])
def submap(request):
    return box_room_submap_3d(grid_type=request.param)


@pytest.fixture(scope="module")
def matchers(submap):
    """The JAX and the port's matcher over the same finished submap, with
    the loop-closure test's options (depth 4, 2 m / 0.4 m / 20 degrees)."""
    opts = pose_graph_options().constraint_builder.fast_correlative_scan_matcher_3d
    jm = jfc.FastCorrelativeScanMatcher3D(opts, submap.high_resolution_grid, submap.low_resolution_grid,
                                          submap.rotational_histogram, 120)
    tm = tfc.FastCorrelativeScanMatcher3D(convert.options(opts), convert.grid_3d(submap.high_resolution_grid, CPU),
                                          convert.grid_3d(submap.low_resolution_grid, CPU),
                                          submap.rotational_histogram, 120)
    return jm, tm


@pytest.mark.parametrize("shape", [(13, 10, 9), (12, 300, 9), (24, 130, 20)])
def test_pyramid_levels_equal_jax(shape):
    values = np.random.default_rng(3).uniform(0.1, 0.9, shape).astype(np.float32)
    want = jfc.precompute_pyramid_3d(jnp.asarray(values), 4)
    got = tfc.precompute_pyramid_3d(torch.from_numpy(values), 4)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(tfc._level_flat_table(g).numpy(),
                                      np.asarray(jfc._level_flat_table(w, jnp.float32, paired=False)))


def test_submap_tables_equal_jax(matchers, submap):
    jm, tm = matchers
    assert len(tm._pyramid_levels) == len(jm._pyramid_levels)
    for g, w in zip(tm._pyramid_levels, jm._pyramid_levels):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(tm._low_scores.numpy(), np.asarray(jm._low_scores))
    np.testing.assert_array_equal(
        tfc.grid_match_scores(convert.grid_3d(submap.high_resolution_grid, CPU)).numpy(),
        np.asarray(jfc.grid_match_scores(submap.high_resolution_grid)))


@pytest.mark.parametrize("full_submap", [False, True])
@pytest.mark.parametrize("max_range", [5.0, 20.0])
def test_search_config_equal_jax(full_submap, max_range):
    opts = FastCorrelativeScanMatcherOptions3D()
    want = jfc.make_fast_search_3d_config(opts, 0.1, max_range, full_submap, 256, grid_cells=256)
    got = tfc.make_fast_search_3d_config(convert.options(opts), 0.1, max_range, full_submap, 256, grid_cells=256)
    assert tuple(got) == tuple(want)


def _jax_score_sum(table, bx, by, bz, valid, cand_t, off_x, off_y, off_z, level, grid_shape):
    """score_sum of jfc._match_fast_3d_core, its CPU branch (:329-359,
    :414-436), transcribed with base_row 0: the point arrays padded to
    chunks of 32 with out-of-grid cells, one lax.scan step per chunk."""
    nx, ny, nz = grid_shape
    ch = 32
    pad = (-bx.shape[1]) % ch
    nch = (bx.shape[1] + pad) // ch

    def pad_pts(a, fill):
        return jnp.concatenate([a, jnp.full(a.shape[:-1] + (pad,), fill, a.dtype)], axis=-1) if pad else a

    bx, by, bz = pad_pts(bx, nx + 1), pad_pts(by, ny + 1), pad_pts(bz, nz + 1)
    validp = pad_pts(valid, False)
    ix = bx[cand_t][:, :, None] + off_x[:, None, :]
    iy = by[cand_t][:, :, None] + off_y[:, None, :]
    iz = bz[cand_t][:, :, None] + off_z[:, None, :]
    span = 2**level
    my = jfc._y_shift(ny, level)
    y_span = 1 << my
    nx_l, ny_l, nz_l = jfc._level_cells(nx, level), jfc._level_cells(ny, my), jfc._level_cells(nz, level)

    def body(acc, args):
        ixc, iyc, izc, bvc = args
        x_in = (ixc > -span) & (ixc < nx)
        ixg = jnp.maximum(ixc, 0) // span
        z_in = (izc > -span) & (izc < nz)
        izg = jnp.maximum(izc, 0) // span
        rowidx = jnp.where(x_in[..., :, None] & z_in[..., None, :], izg[..., None, :] * nx_l + ixg[..., :, None],
                           nz_l * nx_l)
        y_in = (iyc > -span) & (iyc < ny)
        iyg = jnp.where(y_in & bvc[:, None], jnp.clip(iyc, 0, ny - 1) // y_span, -1)
        flat1d = table.reshape(-1)
        pick = iyg >= 0
        idx = rowidx[..., :, None, :] * ny_l + jnp.maximum(iyg, 0)[..., None, :, None]
        v = jnp.where(pick[..., None, :, None], flat1d[idx].astype(jnp.float32), 0.0)
        return acc + jnp.moveaxis(jnp.sum(v, axis=-4), -2, -1), None

    chunk = lambda a: jnp.moveaxis(a.reshape(a.shape[:-2] + (nch, ch, a.shape[-1])), -3, 0)
    init = jnp.zeros(ix.shape[:-2] + (ix.shape[-1], iz.shape[-1], iy.shape[-1]), jnp.float32)
    acc, _ = jax.lax.scan(body, init, (chunk(ix), chunk(iy), chunk(iz), validp.reshape(nch, ch)))
    return jnp.moveaxis(acc, -1, -2)


def _score_inputs(grid_shape, level, stage, seed, t=41, p=1000):
    """Random point cells over the grid and past its edges (t yaw rows, p
    points, 10% masked), and one call's candidates: the coarse stage's
    (one per yaw row, 7 x 7 x 3 shared offsets at the level's stride) or an
    expansion's (256 beam members, offsets {o, o + 2^level} per axis)."""
    rng = np.random.default_rng(seed)
    nx, ny, nz = grid_shape
    cells = [rng.integers(-12, n + 12, (t, p)).astype(np.int32) for n in grid_shape]
    valid = rng.random(p) > 0.1
    if stage == "coarse":
        stride = 2**level
        off = (np.arange(7, dtype=np.int32) - 3) * stride - stride // 2
        off_z = (np.arange(3, dtype=np.int32) - 1) * stride - stride // 2
        cand_t = np.arange(t, dtype=np.int32)
        offs = (np.tile(off, (t, 1)), np.tile(off, (t, 1)), np.tile(off_z, (t, 1)))
    else:
        cand_t = rng.integers(0, t, 256).astype(np.int32)
        base = rng.integers(-20, 21, (256, 3)).astype(np.int32)
        offs = tuple(np.stack([base[:, a], base[:, a] + 2**level], axis=1).astype(np.int32) for a in range(3))
    return (*cells, valid, cand_t, *offs)


@pytest.mark.parametrize("level,stage", [(3, "coarse"), (2, "expansion"), (1, "expansion"), (0, "expansion")])
def test_score_sum_plain_matches_jax_cpu_branch(matchers, level, stage):
    jm, tm = matchers
    table = convert.pyramid_levels(jm._pyramid_levels, CPU)[level]
    grid_shape = tm._high_grid.shape
    bx, by, bz, valid, cand_t, ox, oy, oz = _score_inputs(grid_shape, level, stage, seed=level)
    want = _jax_score_sum(jnp.asarray(table.numpy()), *(jnp.asarray(a) for a in (bx, by, bz, valid, cand_t, ox, oy,
                                                                                 oz)), level, grid_shape)
    args = [torch.from_numpy(a) for a in (bx, by, bz, valid, cand_t, ox, oy, oz)]
    before = fast_scores_3d.launches
    got = fast_scores_3d(table, *args, level, tfc._y_shift(grid_shape[1], level), grid_shape)
    assert fast_scores_3d.launches == before  # CPU tensors never count a launch
    assert got.shape == want.shape and got.dtype == torch.float32
    assert float(np.abs(np.asarray(want)).max()) > 1.0  # the cells reach observed parts of the map
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * max(1.0, float(np.abs(want).max())))


def test_fast_scores_refuses_other_devices():
    meta = torch.zeros((2, 2), device="meta")
    with pytest.raises(ValueError):
        fast_scores_3d(meta, meta.int(), meta.int(), meta.int(), meta[0].bool(), meta[0].int(), meta.int(),
                       meta.int(), meta.int(), 0, 0, (2, 2, 2))


def _cases():
    """(truth, local pose, truth yaw): the loop-closure test's returning
    node 0.35 m off, and a node seen at yaw 0.1 rad matched from yaw 0."""
    return {
        "drift": (np.array([0.3, -0.2, 0.0]), np.array([0.65, -0.2, 0.0]), 0.0),
        "yaw": (np.array([0.5, 0.2, 0.05]), np.array([0.4, 0.3, 0.0]), 0.1),
    }


def _run_match(matcher, rigid, clouds_of, truth, start, yaw, full_submap):
    high, low, hist = node_clouds(scan_at(truth, yaw))
    high, low = clouds_of(high), clouds_of(low)
    fn = matcher.match_full_submap if full_submap else matcher.match
    return fn(rigid(start), high, low, hist, 0.0, max_scan_range=5.6568542)


@pytest.mark.parametrize("full_submap", [False, True])
@pytest.mark.parametrize("case", ["drift", "yaw"])
def test_match_matches_jax(matchers, case, full_submap):
    jm, tm = matchers
    truth, start, yaw = _cases()[case]
    q0 = np.asarray(nq.quat_identity(), np.float32)
    want = _run_match(jm, lambda t: JRigid3(jnp.asarray(t, jnp.float32), jnp.asarray(q0)), lambda c: c, truth, start,
                      yaw, full_submap)
    tfc.match_fast_3d.score_sums = 0
    got = _run_match(tm, lambda t: TRigid3(torch.tensor(t, dtype=torch.float32), torch.from_numpy(q0)),
                     lambda c: convert.point_cloud(c, CPU), truth, start, yaw, full_submap)
    assert tfc.match_fast_3d.score_sums == len(tm._pyramid_levels)  # coarse + one per expansion level
    w_score, w_low, w_rot, w_pose = want
    g_score, g_low, g_rot, g_pose = got
    same_pose = (np.allclose(g_pose.translation.numpy(), np.asarray(w_pose.translation), atol=1e-5)
                 and np.allclose(g_pose.rotation.numpy(), np.asarray(w_pose.rotation), atol=1e-6))
    if same_pose:
        for g, w in ((g_score, w_score), (g_low, w_low), (g_rot, w_rot)):
            assert abs(float(g) - float(w)) <= 1e-5
    else:
        assert abs(float(g_score) - float(w_score)) <= 1e-6, (g_pose, w_pose)
    if case == "drift" and not full_submap:  # the local search recovers the truth
        np.testing.assert_allclose(g_pose.translation.numpy(), truth, atol=0.15)


def test_decimated_pyramid_admissible_bound():
    """tests/test_fast_correlative_3d.py's admissibility check, on the
    port's pyramid: the value at cell floor(q / 2^l) of level l bounds every
    exact score in [q, q + 2^l)^3, for any query q, aligned or not, and
    where the y axis stops halving at the lane floor."""
    rng = np.random.default_rng(3)
    for shape in ((13, 10, 9), (12, 300, 9)):
        v = rng.uniform(0.1, 0.9, shape).astype(np.float32)
        depth = 4
        levels = [lv.numpy() for lv in tfc.precompute_pyramid_3d(torch.from_numpy(v), depth)]
        np.testing.assert_array_equal(levels[0], v)
        nx, ny, nz = v.shape
        for level in range(1, depth):
            span = 1 << level
            my = tfc._y_shift(ny, level)
            for _ in range(200):
                q = rng.integers(-span + 1, [nx, ny, nz])
                sl = tuple(slice(max(int(q[a]), 0), min(int(q[a]) + span, v.shape[a])) for a in range(3))
                block = v[sl]
                exact = float(block.max()) if block.size else 0.1
                cell = (max(int(q[0]), 0) // span, max(int(q[1]), 0) // (1 << my), max(int(q[2]), 0) // span)
                assert float(levels[level][cell]) >= exact - 1e-6, (shape, level, q.tolist())
