"""Parity of the port's fast 2D correlative matcher (hectorgrapher_tpu_torch/
mapping/scan_matching/fast_correlative_2d.py) and of K5's plain version
(ops/fast_scores_2d.py) with the JAX package, on the CPU with the same
inputs: the pyramid and the search configuration exactly, the prepared
levels exactly, and match_fast_2d on the scenes of
tests/test_fast_correlative_2d.py.

Tolerances: every normalised score of every level within 1e-5 of the JAX
score_sum's (f32 sums of a few hundred values below 0.8 in chunks of 32 on
both sides, the order within a chunk the backends'), the best score within
1e-5, the pose equal to 1e-6 (the same candidate wins: offsets are whole
cells, the angle the same f32 sum).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hectorgrapher_tpu.mapping.scan_matching import fast_correlative_2d as jfc
from hectorgrapher_tpu.transform.rigid import Rigid2 as JRigid2
from hectorgrapher_tpu_torch import convert
from hectorgrapher_tpu_torch.mapping.scan_matching import fast_correlative_2d as tfc
from hectorgrapher_tpu_torch.ops import fast_scores_2d as k5
from hectorgrapher_tpu_torch.transform.rigid import Rigid2
from test_fast_correlative_2d import make_map_and_cloud
from torch_parity import CPU

torch.set_num_threads(2)

# (scan offset, yaw, search window, angular window, depth, top_k): the
# scenes and configurations of tests/test_fast_correlative_2d.py.
SCENES = {
    "large_offset": ((1.3, -0.8), 0.25, 3.0, np.radians(25.0), 6, 256),
    "outside_window": ((5.0, 0.0), 0.0, 1.0, np.radians(10.0), 5, 128),
    "inside_window": ((0.4, 0.2), 0.0, 1.0, np.radians(10.0), 5, 128),
}


def _scene(name):
    xy, yaw, lin, ang, depth, top_k = SCENES[name]
    grid, cloud = make_map_and_cloud(xy, yaw)
    config = jfc.make_fast_search_config(lin, ang, 0.05, 12.0, depth, top_k)
    return grid, cloud, config


def test_pyramid_and_config_match_jax():
    rng = np.random.default_rng(0)
    values = rng.uniform(0.1, 0.9, (37, 29)).astype(np.float32)
    want = jfc.precompute_pyramid_2d(jnp.asarray(values), 5)
    got = tfc.precompute_pyramid_2d(torch.from_numpy(values), 5)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for args in ((3.0, np.radians(25.0), 0.05, 12.0, 6, 256), (7.0, np.radians(30.0), 0.05, 30.0, 7, 256),
                 (16.0, np.pi, 0.05, 5.5, 7, 256), (0.02, 0.1, 0.05, 0.01, 7, 8)):
        assert tuple(tfc.make_fast_search_config(*args)) == tuple(jfc.make_fast_search_config(*args))


def test_prepared_levels_match_jax():
    grid, _, _ = _scene("large_offset")
    want = jfc.prepare_fast_matcher_2d(grid, 6)
    got = tfc.prepare_fast_matcher_2d(convert.probability_grid(grid, CPU), 6)
    assert got.flat_levels.dtype == torch.float32 and got.dims == (640, 640)
    np.testing.assert_array_equal(got.flat_levels.numpy(), np.asarray(want.flat_levels))
    assert not got.flat_levels[:, -1].any()
    converted = convert.prepared_fast_matcher_2d(want, CPU)
    np.testing.assert_array_equal(converted.flat_levels.numpy(), got.flat_levels.numpy())
    np.testing.assert_array_equal(converted.meta.min_corner.numpy(), got.meta.min_corner.numpy())


def _jax_levels(prepared, cloud, config, monkeypatch):
    """Each level's normalised scores of the JAX search and the indices its
    top_k kept, from an eager run of _match_fast_2d_core (eager XLA rounds
    every operation on its own, as the port does: no contraction of the
    rotation into an FMA, ROADMAP C0)."""
    seen = []
    top_k = jax.lax.top_k

    def recording(scores, k):
        out = top_k(scores, k)
        seen.append((np.asarray(scores), np.asarray(out[1])))
        return out

    monkeypatch.setattr(jax.lax, "top_k", recording)
    levels = prepared.flat_levels
    with jax.disable_jit():
        jfc._match_fast_2d_core(levels.reshape(-1, levels.shape[2]), jnp.asarray(0, jnp.int32),
                                prepared.meta.resolution, prepared.meta.min_corner, levels.shape[1] - 1,
                                levels.shape[2], cloud, JRigid2.identity(), config)
    monkeypatch.undo()
    return seen


def _jax_candidates(config, seen):
    """The (cand_t, off_x, off_y) K5 inputs of each level of the JAX search,
    rebuilt from the indices its top_k kept (_match_fast_2d_core's
    bookkeeping, :303-344)."""
    n_th, lc = 2 * config.num_angles + 1, config.linear_cells
    stride = 2 ** (config.depth - 1)
    n_blocks = 2 * ((lc + stride - 1) // stride) + 1
    off = ((np.arange(n_blocks) - n_blocks // 2) * stride - stride // 2).astype(np.int32)
    out = [(np.arange(n_th, dtype=np.int32), np.tile(off, (n_th, 1)), np.tile(off, (n_th, 1)))]
    tt, gx, gy = (a.reshape(-1) for a in np.meshgrid(np.arange(n_th, dtype=np.int32), off, off, indexing="ij"))
    for level, (_, kept) in zip(range(config.depth - 2, -1, -1), seen):
        ct, cox, coy = tt[kept], gx[kept], gy[kept]
        d = np.array([0, 2**level], np.int32)
        cxs, cys = np.clip(cox[:, None] + d, -lc, lc), np.clip(coy[:, None] + d, -lc, lc)
        out.append((ct, cxs, cys))
        kk = len(ct)
        tt, gx, gy = (np.repeat(ct, 4), np.broadcast_to(cxs[:, :, None], (kk, 2, 2)).reshape(-1),
                      np.broadcast_to(cys[:, None, :], (kk, 2, 2)).reshape(-1))
    return out


@pytest.mark.parametrize("name", list(SCENES))
def test_match_fast_2d_matches_jax(name, monkeypatch):
    grid, cloud, config = _scene(name)
    score_j, pose_j = jfc.match_fast_2d(grid, cloud, JRigid2.identity(), config)
    tgrid, tcloud = convert.probability_grid(grid, CPU), convert.point_cloud(cloud, CPU)
    init = Rigid2(torch.zeros(2), torch.zeros(()))
    calls = []

    def recorded(*a):
        out = k5.fast_scores_2d(*a)
        calls.append((a, out))
        return out

    monkeypatch.setattr(tfc, "fast_scores_2d", recorded)
    score_t, pose_t = tfc.match_fast_2d(tgrid, tcloud, init, tfc.FastSearchConfig(*config))
    monkeypatch.undo()
    assert len(calls) == config.depth
    assert abs(float(score_t) - float(score_j)) <= 1e-5
    np.testing.assert_allclose(pose_t.translation.numpy(), np.asarray(pose_j.translation), atol=1e-6, rtol=0)
    assert abs(float(pose_t.angle) - float(pose_j.angle)) <= 1e-6
    if name == "large_offset":  # tests/test_fast_correlative_2d.py's bounds
        assert float(score_t) > 0.4
        np.testing.assert_allclose(pose_t.translation.numpy(), SCENES[name][0], atol=0.1)

    # Each level's scores: K5's plain version on the JAX search's own
    # candidates (near-tied scores can order the two beams differently)
    # and the port's point cells, against the JAX score_sum's.
    seen = _jax_levels(jfc.prepare_fast_matcher_2d(grid, config.depth), cloud, config, monkeypatch)
    assert len(seen) == len(calls)
    n_valid = max(int(np.asarray(cloud.mask).sum()), 1)
    table, bx, by, valid = calls[0][0][:4]
    for level, (cand, (want, _)) in zip(range(config.depth - 1, -1, -1), zip(_jax_candidates(config, seen), seen)):
        ct, ox, oy = (torch.from_numpy(np.ascontiguousarray(a)) for a in cand)
        got = k5.fast_scores_2d_plain(table, bx, by, valid, ct, ox, oy, level, (640, 640))
        np.testing.assert_allclose((0.1 + got / n_valid).reshape(-1).numpy(), want, atol=1e-5, rtol=0)


def _naive_sums(table, bx, by, valid, cand_t, off_x, off_y, level, dims, cand_base):
    """score_sum's rules (fast_correlative_2d.py :249-301) one output at a
    time in float64."""
    nx, ny = dims
    span = 1 << level
    out = np.zeros((len(cand_t), off_x.shape[1], off_y.shape[1]))
    for c, t in enumerate(cand_t):
        base = (0 if cand_base is None else cand_base[c]) + level * (nx + 1)
        for i, ox in enumerate(off_x[c]):
            for j, oy in enumerate(off_y[c]):
                for q in range(bx.shape[1]):
                    ix, iy = bx[t, q] + ox, by[t, q] + oy
                    ok = valid[t, q] if valid.ndim == 2 else valid[q]
                    if ok and -span < ix < nx and -span < iy < ny:
                        out[c, i, j] += table[base + max(ix, 0), min(max(iy, 0), ny - 1)]
    return out


@pytest.mark.parametrize("shape", ["coarse", "expansion", "row_bases"])
def test_fast_scores_2d_plain_rules(shape):
    """fast_scores_2d_plain against score_sum's rules written out, over
    cells inside, across the low edge (within and past the span), past
    the high edge and at the pad cell (nx + 1, ny + 1) of a padded point,
    with valid and invalid points; with row bases, each candidate reads
    its own submap's block of a stacked table."""
    rng = np.random.default_rng({"coarse": 1, "expansion": 2, "row_bases": 3}[shape])
    dims, depth, level = (23, 17), 4, {"coarse": 3, "expansion": 1, "row_bases": 2}[shape]
    slots = 3 if shape == "row_bases" else 1
    table = rng.uniform(0.0, 0.8, (slots, depth, dims[0] + 1, dims[1])).astype(np.float32)
    table[:, :, -1] = 0.0
    table = table.reshape(-1, dims[1])
    r, p = 6, 45  # P not a multiple of the 32-point chunk
    bx = rng.integers(-12, dims[0] + 3, (r, p)).astype(np.int32)
    by = rng.integers(-12, dims[1] + 3, (r, p)).astype(np.int32)
    bx[:, -5:], by[:, -5:] = dims[0] + 1, dims[1] + 1  # padded points, flagged valid
    valid = rng.random((r, p)) < 0.8
    valid[:, -5:] = True
    if shape == "coarse":
        c, nxo = r, 5
        cand_t = np.arange(r, dtype=np.int32)
        offs = ((np.arange(nxo) - nxo // 2) * 8 - 4).astype(np.int32)
        off_x = off_y = np.tile(offs, (c, 1))
        valid = valid[0]
    else:
        c = 9
        cand_t = rng.integers(0, r, c).astype(np.int32)
        off_x = rng.integers(-6, 7, (c, 2)).astype(np.int32)
        off_y = rng.integers(-6, 7, (c, 2)).astype(np.int32)
    cand_base = (rng.integers(0, slots, c) * depth * (dims[0] + 1)).astype(np.int64) if slots > 1 else None
    t = torch.from_numpy
    got = k5.fast_scores_2d(t(table), t(bx), t(by), t(valid), t(cand_t), t(off_x), t(off_y), level, dims,
                            None if cand_base is None else t(cand_base))
    want = _naive_sums(table, bx, by, valid, cand_t, off_x, off_y, level, dims, cand_base)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * max(1.0, np.abs(want).max()), rtol=0)
    assert k5.fast_scores_2d.launches == 0  # CPU tensors take the plain version


@pytest.mark.parametrize("edge", ["no_valid", "all_valid", "tail_only", "shared_rows"])
def test_fast_scores_2d_plain_edge_rows(edge):
    """fast_scores_2d_plain against score_sum's rules written out on the
    rows the kernel's compaction must get right: a row with no valid point
    (all-zero sums), every slot valid, valid points only in the last 32
    slots, and candidates sharing point rows, over row bases."""
    rng = np.random.default_rng(["no_valid", "all_valid", "tail_only", "shared_rows"].index(edge) + 10)
    dims, depth, level, slots = (19, 23), 4, 2, 2
    table = rng.uniform(-0.1, 0.8, (slots, depth, dims[0] + 1, dims[1])).astype(np.float32)
    table[:, :, -1] = 0.0
    table = table.reshape(-1, dims[1])
    r, p = 4, 160
    bx = rng.integers(-8, dims[0] + 8, (r, p)).astype(np.int32)
    by = rng.integers(-8, dims[1] + 8, (r, p)).astype(np.int32)
    valid = {"no_valid": np.zeros((r, p), bool), "all_valid": np.ones((r, p), bool),
             "tail_only": np.arange(p)[None, :].repeat(r, 0) >= p - 32,
             "shared_rows": rng.random((r, p)) < 0.6}[edge]
    c = 12
    cand_t = (np.arange(c) % r if edge != "shared_rows" else rng.integers(0, 2, c)).astype(np.int32)
    off_x = rng.integers(-6, 7, (c, 3)).astype(np.int32)
    off_y = rng.integers(-6, 7, (c, 5)).astype(np.int32)
    cand_base = (rng.integers(0, slots, c) * depth * (dims[0] + 1)).astype(np.int64)
    t = torch.from_numpy
    got = k5.fast_scores_2d_plain(t(table), t(bx), t(by), t(valid), t(cand_t), t(off_x), t(off_y), level, dims,
                                  t(cand_base))
    want = _naive_sums(table, bx, by, valid, cand_t, off_x, off_y, level, dims, cand_base)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * max(1.0, np.abs(want).max()), rtol=0)
    if edge == "no_valid":
        assert not got.any()
    else:
        assert np.abs(want).max() > 0
