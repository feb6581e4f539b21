"""chip_smoke.py's bound arithmetic (bound_ms), pinned at small shapes
worked out by hand, and its written-out gathers held against the kernels'
plain versions. All on the CPU: the bound is a count of bytes and
operations, not a time taken here.
"""

import math

import numpy as np
import pytest
import torch

import chip_smoke as cs
from hectorgrapher_tpu_torch.mapping.grids import make_probability_grid, make_tsdf_grid
from hectorgrapher_tpu_torch.mapping.scan_matching.interpolated_grid import prepare_grid_3d
from hectorgrapher_tpu_torch.ops.correlative_scores_2d import correlative_scores_2d_plain
from hectorgrapher_tpu_torch.ops.ct_scan_block import grid_slots
from hectorgrapher_tpu_torch.ops.fast_scores_3d import fast_scores_3d_plain

CPU = torch.device("cpu")
i32 = lambda a: torch.tensor(a, dtype=torch.int32)


def _k4_args():
    """A 4^3 grid at level 0: table (4*4 + 1 rows, 4 lanes) holding its
    flat index; one candidate, zero offsets, three points: (1, 2, 0) at
    row 0*4 + 1, lane 2 (flat 6, sector 0); (3, 1, 3) at row 3*4 + 3, lane
    1 (flat 61, sector 7); the third not valid."""
    table = torch.arange(17 * 4, dtype=torch.float32).reshape(17, 4)
    bx, by, bz = i32([1, 3, 2]), i32([2, 1, 2]), i32([0, 3, 2])
    return (table, bx[None], by[None], bz[None], torch.tensor([True, True, False]), i32([0]),
            i32([[0]]), i32([[0]]), i32([[0]]), 0, 0, (4, 4, 4))


def test_bound_fast_scores_3d_by_hand():
    args = _k4_args()
    # 2 sectors of the table, the yaw row's 3 x 3 int32 cells, 3 valid
    # flags, cand_t, the three offsets and the one output.
    nbytes = 2 * 32 + 3 * 3 * 4 + 3 + 4 * (1 + 1 + 1 + 1 + 1)
    ms, by, got_bytes, ops = cs.bound_ms("fast_scores_3d", args)
    assert (got_bytes, ops, by) == (nbytes, 2, "bytes")
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3, rel=1e-12)
    assert float(fast_scores_3d_plain(*args).reshape(())) == 6.0 + 61.0


@pytest.mark.parametrize("grid_type", ["TSDF", "PROBABILITY_GRID"])
def test_bound_ct_scan_block_by_hand(grid_type):
    """One hi-res point at cell coordinate 1.7 on every axis of a 4^3 grid
    at 1 m (identity pose): stencil base (1, 1, 1), cells 21 + {0, 1, 4, 5,
    16, 17, 20, 21}, sectors 2..5 of both tsd and weight (TSDF mode) or of
    the one probability field (probability mode, with its own operation
    count); the lo-res point is masked out."""
    prob = grid_type != "TSDF"
    make = ((lambda: prepare_grid_3d(make_probability_grid(1.0, (4, 4, 4), CPU))) if prob
            else (lambda: make_tsdf_grid(1.0, (4, 4, 4), 0.3, 1000.0, CPU)))
    hi, lo = make(), make()
    p = (hi.meta.min_corner + 1.7)[None, None]
    pose7 = torch.tensor([[0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0]])
    args = (hi, lo, p, torch.ones((1, 1), dtype=torch.bool), p.clone(), torch.zeros((1, 1), dtype=torch.bool),
            pose7, torch.zeros((1, 7, 18)), torch.ones(1), torch.ones(1))
    cells, n = cs.k3_stencil_cells(hi, p, args[3], pose7)
    assert sorted(cells.tolist()) == [21, 22, 25, 26, 37, 38, 41, 42] and n == 1
    # Points, pose7, dpose7, scales and the 8 grid parameters (f32), the
    # two masks (bool), S + g + cost, and 4 sectors of each volume read.
    nbytes = 4 * (3 + 3 + 7 + 126 + 2 + 8) + 2 + 4 * (324 + 18 + 1) + (1 if prob else 2) * 4 * 32
    ms, by, got_bytes, ops = cs.bound_ms("ct_scan_block", args)
    assert (got_bytes, ops, by) == (nbytes, cs.K3_PROB_OPS_PER_POINT if prob else cs.K3_OPS_PER_POINT, "bytes")
    assert ms == pytest.approx(max(nbytes / 3.35e12, ops / 67e12) * 1e3, rel=1e-12)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_bound_ct_scan_block_half_by_hand(dtype):
    """test_bound_ct_scan_block_by_hand's point over TSDF planes stored in
    half precision: the same cells 21..42, at 2 bytes a cell in sectors 1
    and 2 of each plane (16 cells a sector), so two sectors a plane where
    f32 planes take four; the operations do not change."""
    hi, lo = (make_tsdf_grid(1.0, (4, 4, 4), 0.3, 1000.0, CPU, dtype=dtype) for _ in range(2))
    p = (hi.meta.min_corner + 1.7)[None, None]
    pose7 = torch.tensor([[0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0]])
    args = (hi, lo, p, torch.ones((1, 1), dtype=torch.bool), p.clone(), torch.zeros((1, 1), dtype=torch.bool),
            pose7, torch.zeros((1, 7, 18)), torch.ones(1), torch.ones(1))
    nbytes = 4 * (3 + 3 + 7 + 126 + 2 + 8) + 2 + 4 * (324 + 18 + 1) + 2 * 2 * 32
    ms, by, got_bytes, ops = cs.bound_ms("ct_scan_block", args)
    assert (got_bytes, ops, by) == (nbytes, cs.K3_OPS_PER_POINT, "bytes")


def test_bound_fast_scores_3d_row_bases_by_hand():
    """A batched round's call: two 4^3 level-0 blocks stacked (17 rows
    each, holding the flat index), two candidates on point rows 0 and 1
    with row bases 0 and 17, one flag row per point row. Row 0's points
    (1, 2, 0) and (3, 1, 3) read flats 6 and 61 (sectors 0 and 7); row 1's
    (0, 0, 0) reads row 17 + 0, lane 0, flat 68 (sector 8), its second
    point not valid."""
    table = torch.arange(2 * 17 * 4, dtype=torch.float32).reshape(34, 4)
    bx, by, bz = i32([[1, 3], [0, 2]]), i32([[2, 1], [0, 3]]), i32([[0, 3], [0, 1]])
    valid = torch.tensor([[True, True], [True, False]])
    zero = i32([[0], [0]])
    args = (table, bx, by, bz, valid, i32([0, 1]), zero, zero, zero, 0, 0, (4, 4, 4),
            torch.tensor([0, 17], dtype=torch.int64))
    # 3 sectors of the table, both point rows' 2 x 3 int32 cells and 2 x 2
    # flags, cand_t, the three offsets and the two outputs (4 bytes each),
    # and the two int64 row bases.
    nbytes = 3 * 32 + 2 * 2 * 3 * 4 + 2 * 2 + 4 * (2 + 2 + 2 + 2 + 2) + 2 * 8
    ms, by, got_bytes, ops = cs.bound_ms("fast_scores_3d", args)
    assert (got_bytes, ops, by) == (nbytes, 3, "bytes")
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3, rel=1e-12)
    assert fast_scores_3d_plain(*args).reshape(-1).tolist() == [6.0 + 61.0, 68.0]


def test_bound_ct_scan_block_slots_by_hand():
    """Two lanes against two distinct 4^3 grid pairs at 1 m (slots 0 and
    1), each with one hi-res point at cell coordinate 1.7 of its own grid:
    4 sectors of tsd and of weight in each lane's grid; the lo-res points
    masked out."""
    pairs = [(make_tsdf_grid(1.0, (4, 4, 4), 0.3, 1000.0, CPU), make_tsdf_grid(1.0, (4, 4, 4), 0.3, 1000.0, CPU))
             for _ in range(2)]
    slots = grid_slots([h for h, _ in pairs], [lo for _, lo in pairs])
    p = torch.stack([(h.meta.min_corner + 1.7)[None] for h, _ in pairs])  # (2, 1, 3)
    pose7 = torch.tensor([[0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0]]).expand(2, 7)
    args = (slots, i32([0, 1]), p, torch.ones((2, 1), dtype=torch.bool), p.clone(),
            torch.zeros((2, 1), dtype=torch.bool), pose7, torch.zeros((2, 7, 18)), torch.ones(2), torch.ones(2))
    # Points, pose7, dpose7 and scales (f32); the slot table: 2 x 4 int64
    # pointers, 2 x 8 f32 parameters and 2 int32 slots; the two masks
    # (bool); S + g + cost per lane; 4 sectors of tsd and weight per lane.
    nbytes = 4 * (6 + 6 + 14 + 252 + 4) + (2 * 4 * 8 + 2 * 8 * 4 + 2 * 4) + 4 + 2 * 4 * (324 + 18 + 1) + 2 * 2 * 4 * 32
    ms, by, got_bytes, ops = cs.bound_ms("ct_scan_block_slots", args)
    assert (got_bytes, ops, by) == (nbytes, 2 * cs.K3_OPS_PER_POINT, "bytes")
    assert ms == pytest.approx(max(nbytes / 3.35e12, ops / 67e12) * 1e3, rel=1e-12)


def test_bound_takes_the_larger_time(monkeypatch):
    """Operations bound a call whose operations take longer than its bytes."""
    args = _k4_args()
    nbytes, _ = cs._work("fast_scores_3d", args)
    ops = math.ceil(nbytes / 3.35e12 * 67e12) + 1000
    monkeypatch.setattr(cs, "_work", lambda kernel, a: (nbytes, ops))
    ms, by, _, _ = cs.bound_ms("fast_scores_3d", args)
    assert by == "operations" and ms == pytest.approx(ops / 67e12 * 1e3, rel=1e-12)


@pytest.mark.parametrize("level", [0, 2])
def test_k4_gather_is_the_plain_sum(level):
    """The library yardstick's indices and weights sum to the plain
    version's scores."""
    rng = np.random.default_rng(level)
    grid_shape = (20, 24, 12)
    span = 1 << level
    nx_l, nz_l = -(-20 // span), -(-12 // span)
    table = torch.from_numpy(rng.uniform(0, 0.8, (nz_l * nx_l + 1, 24)).astype(np.float32))
    table[-1] = 0.0
    cells = [torch.from_numpy(rng.integers(-3, n + 3, (5, 40)).astype(np.int32)) for n in grid_shape]
    valid = torch.from_numpy(rng.random(40) < 0.8)
    cand_t = torch.from_numpy(rng.integers(0, 5, 6).astype(np.int32))
    offs = [torch.from_numpy(rng.integers(-4, 5, (6, k)).astype(np.int32)) for k in (2, 3, 2)]
    args = (table, *cells, valid, cand_t, *offs, level, 0, grid_shape)
    idx, weight = cs.k4_gather(*args)
    got = (table.reshape(-1)[idx] * weight).sum(dim=1).reshape(6, 2, 3, 2)
    torch.testing.assert_close(got, fast_scores_3d_plain(*args), rtol=0, atol=1e-5)
    lib = torch.nn.functional.embedding_bag(idx, table.reshape(-1, 1), mode="sum", per_sample_weights=weight)
    torch.testing.assert_close(lib.reshape(6, 2, 3, 2), fast_scores_3d_plain(*args), rtol=0, atol=1e-5)


def test_k2_gather_is_the_plain_sum():
    """On a table padded to row_stride lanes (25 used of 32)."""
    rng = np.random.default_rng(3)
    b, g, gsz, n, k = 2, 3, 3, 16, 1
    d, pw = 2 * k + 1, 2 * k + gsz
    table = np.zeros((10, 32), np.float32)
    table[:, : pw * pw] = rng.uniform(0, 1, (10, pw * pw))
    table = torch.from_numpy(table).to(torch.bfloat16)
    flat = torch.from_numpy(rng.integers(0, 10, (b, g, n)).astype(np.int32))
    dlin = torch.from_numpy(rng.integers(0, gsz * gsz, (b, g * gsz, n)).astype(np.int32))
    valid = torch.from_numpy((rng.random((b, n)) < 0.7).astype(np.float32))
    args = (table, flat, dlin, valid, g, gsz, pw, k)
    idx, weight = cs.k2_gather(*args)
    got = (table.reshape(-1)[idx].float() * weight.float()).sum(dim=1).reshape(b, g * gsz, d, d)
    torch.testing.assert_close(got, correlative_scores_2d_plain(*args), rtol=0, atol=1e-4)
    nbytes, ops = cs._work("correlative_scores_2d", args)
    assert ops == g * gsz * d * d * int(valid.sum())


def test_bound_correlative_scores_2d_by_hand():
    """One match, one group of gsz = 3 angles, k = 1 (pw = 5: 25 lanes of
    a 32-lane row, 64 bytes = 2 sectors), four points naming table rows 2,
    5, 2, 0, the third not valid: rows {0, 2, 5}, 6 sectors; flat (4),
    delta_lin (3 x 4), valid (4) and the 3 x 3 x 3 outputs, 4 bytes each;
    3 x 9 sums over 3 valid points."""
    table = torch.zeros((6, 32), dtype=torch.bfloat16)
    table[:, :25] = torch.arange(25, dtype=torch.float32) / 32
    flat = i32([[[2, 5, 2, 0]]])
    dlin = torch.full((1, 3, 4), 4, dtype=torch.int32)  # delta (1, 1): the window at lane 6
    valid = torch.tensor([[1.0, 1.0, 0.0, 1.0]])
    args = (table, flat, dlin, valid, 1, 3, 5, 1)
    nbytes = 6 * 32 + 4 * (4 + 12 + 4 + 27)
    ms, by, got_bytes, ops = cs.bound_ms("correlative_scores_2d", args)
    assert (got_bytes, ops, by) == (nbytes, 81, "bytes")
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3, rel=1e-12)
    # Score (ox, oy) of every angle: 3 valid points reading lane 6 + 5 ox + oy.
    lanes = torch.tensor([[6, 7, 8], [11, 12, 13], [16, 17, 18]], dtype=torch.float32)
    torch.testing.assert_close(correlative_scores_2d_plain(*args)[0], (3 * lanes / 32).expand(3, 3, 3))
