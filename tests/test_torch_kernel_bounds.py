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
from hectorgrapher_tpu_torch.ops.ct_scan_block import grid_slots, pair_terms
from hectorgrapher_tpu_torch.ops.fast_scores_2d import fast_scores_2d_plain
from hectorgrapher_tpu_torch.ops.fast_scores_3d import fast_scores_3d_plain
from hectorgrapher_tpu_torch.transform.rigid import Rigid2

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


def _one_point_plan(grid, masked_lo=True):
    """K3 per-point mode's plan of one window of K = 2 control points at
    the identity: one hi-res point at cell coordinate 1.7 on every axis of
    `grid`, factor 0.5, scale 1; a lo-res point of scale 0 (dropped)."""
    from hectorgrapher_tpu_torch.ops.ct_scan_block import point_plan

    p = (grid.meta.min_corner + 1.7)[None, None]
    plan = point_plan(p, torch.zeros((1, 1), dtype=torch.int64), torch.full((1, 1), 0.5), torch.ones(1, 1),
                      p.clone(), torch.zeros((1, 1), dtype=torch.int64), torch.full((1, 1), 0.5),
                      torch.zeros(1, 1), k=2)
    cp7 = torch.tensor([[0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0]] * 2)
    return plan, cp7


@pytest.mark.parametrize("grid_type", ["TSDF", "PROBABILITY_GRID"])
def test_bound_ct_scan_block_points_by_hand(grid_type):
    """K3's per-point mode on test_bound_ct_scan_block_by_hand's point: the
    same stencil cells (sectors 2..5 of both TSDF planes or of the one
    field); the one kept point's position, factor, scale and grid flag
    (21 bytes), the two control points, the two segment starts, one pair
    block's outputs and the 8 grid parameters; the dropped lo-res point is
    not read, and the kernel's segment ticket and scratch are its design's,
    not the function's. Operations: the pair's terms once, then one point's pose on
    the lerp branch (both control points at the identity) and its row."""
    prob = grid_type != "TSDF"
    make = ((lambda: prepare_grid_3d(make_probability_grid(1.0, (4, 4, 4), CPU))) if prob
            else (lambda: make_tsdf_grid(1.0, (4, 4, 4), 0.3, 1000.0, CPU)))
    hi, lo = make(), make()
    plan, cp7 = _one_point_plan(hi)
    assert plan.starts.tolist() == [0, 1] and plan.points.shape[0] == 2
    nbytes = 21 + 4 * (14 + 2 + 324 + 18 + 1) + 4 * 8 + (1 if prob else 2) * 4 * 32
    ms, by, got_bytes, ops = cs.bound_ms("ct_scan_block_points", (hi, lo, plan, cp7))
    want_ops = cs.K3P_OPS_PER_PAIR + cs.K3P_LERP_POSE_OPS + (cs.K3P_PROB_ROW_OPS if prob else cs.K3P_ROW_OPS)
    assert (got_bytes, ops, by) == (nbytes, want_ops, "bytes")
    assert ms == pytest.approx(max(nbytes / 3.35e12, ops / 67e12) * 1e3, rel=1e-12)


def test_bound_ct_scan_block_points_front_end_shape():
    """The bound at phase 7's shape (chip_smoke.ct_point_inputs: C = 32
    clouds of 256 + 224 kept points, K = 32, 256^3 / 128^3 TSDF maps of
    one scan): every kept point is counted once in bytes and operations,
    the pair terms once for each pair with points (no pair on the lerp
    branch), the stencil adds at most two planes' 8 sectors a point, and
    the call is bounded by bytes at 2.0-2.6 MB. The segments: 29 pairs of
    434-484 points, the last pair's 1,483, empty pair 5."""
    hi, lo, scan = cs.ct_production_grids(CPU, n_scans=1)
    args = cs.ct_point_inputs(CPU, hi, lo, scan, outside=16)
    plan = args[2]
    m = int(plan.starts[-1])
    assert m == 32 * (256 + 224) and plan.points.shape[0] == 32 * 512  # the masked ones dropped
    sizes = sorted(torch.diff(plan.starts).tolist())
    assert sizes[0] == 0 and 434 <= sizes[1] and sizes[-2] <= 484 and sizes[-1] == 1483
    fixed = 21 * m + 4 * (32 * 7 + 32 + 31 * 343) + 4 * 8
    ms, by, nbytes, ops = cs.bound_ms("ct_scan_block_points", args[:4])
    used = torch.diff(plan.starts) > 0
    assert int(used.sum()) == 30  # 31 pairs, pair 5 empty
    assert not bool(pair_terms(args[3][:-1], args[3][1:]).lerp[used].any())
    assert ops == cs.K3P_OPS_PER_PAIR * 30 + (cs.K3P_POSE_OPS + cs.K3P_ROW_OPS) * m and by == "bytes"
    assert fixed < nbytes <= fixed + 2 * 8 * 32 * m
    assert 2.0e6 < nbytes < 2.6e6


def test_bound_fast_scores_2d_by_hand():
    """A 4 x 4 grid, one level: table (4 + 1 rows, 4 lanes) holding its
    flat index; one candidate, zero offsets, three points: (1, 2) at row
    1, lane 2 (flat 6, sector 0); (3, 1) at flat 13 (sector 1); the third
    not valid."""
    table = torch.arange(5 * 4, dtype=torch.float32).reshape(5, 4)
    args = (table, i32([[1, 3, 2]]), i32([[2, 1, 2]]), torch.tensor([True, True, False]), i32([0]), i32([[0]]),
            i32([[0]]), 0, (4, 4))
    # 2 sectors of the table; one sector each of bx and by (the two valid
    # points' cells, flats 0 and 1; the invalid third point's cells are
    # not read); 3 valid flags, cand_t, the two offsets and the one output.
    nbytes = 2 * 32 + 2 * 32 + 3 + 4 * (1 + 1 + 1 + 1)
    ms, by, got_bytes, ops = cs.bound_ms("fast_scores_2d", args)
    assert (got_bytes, ops, by) == (nbytes, 2, "bytes")
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3, rel=1e-12)
    assert float(fast_scores_2d_plain(*args).reshape(())) == 6.0 + 13.0


def test_bound_fast_scores_2d_row_bases_by_hand():
    """A batched round's call: two one-level 4 x 4 blocks stacked (5 rows
    each, holding the flat index), two candidates on point rows 0 and 1
    with row bases 0 and 5, one flag row per point row. Row 0's points
    (1, 2) and (3, 1) read flats 6 and 13 (sectors 0 and 1); row 1's (0, 0)
    reads row 5 + 0, lane 0, flat 20 (sector 2), its second point not
    valid."""
    table = torch.arange(2 * 5 * 4, dtype=torch.float32).reshape(10, 4)
    valid = torch.tensor([[True, True], [True, False]])
    zero = i32([[0], [0]])
    args = (table, i32([[1, 3], [0, 2]]), i32([[2, 1], [0, 3]]), valid, i32([0, 1]), zero, zero, 0, (4, 4),
            torch.tensor([0, 5], dtype=torch.int64))
    # 3 sectors of the table; one sector each of bx and by (the three
    # valid points' cells, flats 0, 1 and 2; row 1's invalid second point
    # is not read); both point rows' 2 x 2 flags, cand_t, the two offsets
    # and the two outputs (4 bytes each), and the two int64 row bases.
    nbytes = 3 * 32 + 2 * 32 + 2 * 2 + 4 * (2 + 2 + 2 + 2) + 2 * 8
    ms, by, got_bytes, ops = cs.bound_ms("fast_scores_2d", args)
    assert (got_bytes, ops, by) == (nbytes, 3, "bytes")
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3, rel=1e-12)
    assert fast_scores_2d_plain(*args).reshape(-1).tolist() == [6.0 + 13.0, 20.0]


@pytest.mark.parametrize("last_valid, cell_sectors", [(False, 1), (True, 2)])
def test_bound_fast_scores_2d_counts_valid_cells_only(last_valid, cell_sectors):
    """Ten points at cell (1, 2) (flat 6, one table sector), the first two
    valid: their cells lie in the first 32-byte sector of bx and of by.
    With the tenth point valid too, its cells add the second sector of
    each; points 3-9 add nothing either way."""
    table = torch.arange(5 * 4, dtype=torch.float32).reshape(5, 4)
    valid = torch.tensor([True, True] + [False] * 7 + [last_valid])
    args = (table, i32([[1] * 10]), i32([[2] * 10]), valid, i32([0]), i32([[0]]), i32([[0]]), 0, (4, 4))
    nbytes = 32 + 2 * 32 * cell_sectors + 10 + 4 * (1 + 1 + 1 + 1)
    ms, by, got_bytes, ops = cs.bound_ms("fast_scores_2d", args)
    assert (got_bytes, ops, by) == (nbytes, 2 + last_valid, "bytes")
    assert float(fast_scores_2d_plain(*args).reshape(())) == 6.0 * (2 + last_valid)


@pytest.mark.parametrize("level", [0, 2])
def test_k5_gather_is_the_plain_sum(level):
    """The library yardstick's indices and weights sum to the plain
    version's scores, over two stacked submap blocks of three levels, with
    cells across both edges and past the span."""
    rng = np.random.default_rng(level)
    dims, depth = (20, 24), 3
    table = rng.uniform(0, 0.8, (2, depth, 21, 24)).astype(np.float32)
    table[:, :, -1] = 0.0
    table = torch.from_numpy(table.reshape(-1, 24))
    bx, by = (torch.from_numpy(rng.integers(-6, n + 3, (5, 40)).astype(np.int32)) for n in dims)
    valid = torch.from_numpy(rng.random((5, 40)) < 0.8)
    cand_t = torch.from_numpy(rng.integers(0, 5, 6).astype(np.int32))
    offs = [torch.from_numpy(rng.integers(-4, 5, (6, k)).astype(np.int32)) for k in (2, 3)]
    base = torch.from_numpy(rng.integers(0, 2, 6) * depth * 21)
    args = (table, bx, by, valid, cand_t, *offs, level, dims, base)
    idx, weight = cs.k5_gather(*args)
    got = (table.reshape(-1)[idx] * weight).sum(dim=1).reshape(6, 2, 3)
    torch.testing.assert_close(got, fast_scores_2d_plain(*args), rtol=0, atol=1e-5)
    lib = torch.nn.functional.embedding_bag(idx, table.reshape(-1, 1), mode="sum", per_sample_weights=weight)
    torch.testing.assert_close(lib.reshape(6, 2, 3), fast_scores_2d_plain(*args), rtol=0, atol=1e-5)


@pytest.mark.parametrize("kernel", ["ct_pair_residuals", "ct_cloud_poses"])
def test_bound_ct_pair_block_front_end_shape(kernel):
    """K6's bound at phase 7's shape (chip_smoke.ct_pair_block_inputs: K =
    C = 32): pair residuals read the 32 control points' t, q, v (40 bytes
    each), 58 bytes of terms a pair and the three weights, and write r and
    J (285 floats a pair); cloud poses read t and q (28 bytes a control
    point), two int32 indices and a factor a cloud, and write pose7 and
    dpose7 (133 floats). Both are bounded by bytes."""
    state, problem, weights = cs.ct_pair_block_inputs(CPU)
    if kernel == "ct_pair_residuals":
        args, want = (state, problem, weights), (40 * 32 + 58 * 31 + 12 + 4 * 285 * 31, cs.K6_PAIR_OPS * 31)
    else:
        args, want = (state, problem), (28 * 32 + 12 * 32 + 4 * 133 * 32, cs.K6_CLOUD_OPS * 32)
    ms, by, nbytes, ops = cs.bound_ms(kernel, args)
    assert (nbytes, ops, by) == (*want, "bytes")
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3, rel=1e-12)


def test_ct_pair_block_inputs_take_every_branch():
    """Phase 7's K6 window holds what its gate is for: pairs out of the IMU
    and the odometry terms, a pair whose rotations' dot is below 0 (the
    slerp's sign flip), a lerp pair (two equal rotations) and clouds on
    both, finite eager twins, and unit quaternions."""
    state, problem, weights = cs.ct_pair_block_inputs(CPU)
    q = state.rotation
    assert torch.allclose(torch.linalg.vector_norm(q, dim=-1), torch.ones(32), atol=1e-6)
    dots = torch.sum(q[:-1] * q[1:], dim=-1)
    assert bool((dots[[8, 9]] < 0).all()) and bool((dots.abs() > 0.9).all())
    assert torch.equal(q[19], q[20])
    assert {8, 9, 19} <= set(problem.cloud_prev.tolist())
    assert (~problem.pair_mask).nonzero().flatten().tolist() == [4, 17]
    assert (~problem.odom_mask).nonzero().flatten().tolist() == [4, 25]
    from hectorgrapher_tpu_torch.mapping.ct import window_solver as tws

    for out in tws.pair_residuals_plain(state, problem, weights) + tws.cloud_poses_plain(state, problem):
        assert bool(torch.isfinite(out).all())


def _k7_args(b, iterations):
    """K7's arguments (as gn_2d._lm_grid_2d builds them) at the front end's
    shape for b lanes: phase 6's first scan after the adaptive voxel filter
    (2048 slots) on its 640^2 submap, each lane's start 5 cm / 0.02 rad off
    and a further 1 cm along x per lane; then each lane's iteration count.
    b = 1 is the front end's call; b = 4 over two raw grids of a pack (the
    second the first's copy), through _gather_wide_from_flat, a round's."""
    from hectorgrapher_tpu_torch.mapping.scan_matching import gn_2d as tgn

    grid, clouds, poses, _ = cs.front_end_kernel_inputs(CPU)
    pts = clouds.positions[..., :2].expand(b, -1, -1).contiguous()
    valid = clouds.mask.expand(b, -1).contiguous()
    start = Rigid2(poses.translation + torch.arange(b)[:, None] * torch.tensor([0.01, 0.0]),
                   poses.angle.expand(b).contiguous())
    mc, res = grid.meta.min_corner, grid.meta.resolution
    if b == 1:
        field = tgn.prepare_gn_probability_field(grid)
        gather = lambda world: (tgn.gather_rows_2d(field, world),)
    else:
        values = torch.stack([grid.probability()] * 2)
        nx, ny = values.shape[1:]
        base = (torch.tensor([0, 1, 0, 1]) * nx * ny)[:, None, None]
        gather = lambda world: (tgn._gather_wide_from_flat(values.reshape(-1), base, nx, ny, mc, res, world, 0.1),)
    rows, cells = tgn._lm_start(gather, mc, res, pts, start, tgn._GN_SLACK)
    pose0 = torch.cat([start.translation, start.angle[:, None]], dim=-1)
    return (rows, cells, mc.reshape(1, 2).expand(b, 2).contiguous(), res.reshape(1).expand(b).contiguous(), pts,
            valid, tgn._occupied_scale(valid, 1.0), pose0, start.translation, 10.0, 40.0, 20,
            torch.full((b,), iterations, dtype=torch.int32))


@pytest.mark.parametrize("b,iterations", [(1, 20), (4, 10)])
def test_bound_gn_2d_lm_by_hand(b, iterations):
    """K7's bound at the front end's shape (B = 1, N = 2048, 20 iterations)
    and a round's (B = 4 over a pack, 10 iterations each). Every valid
    point's taps at the start are lanes 3-6 of both axes of its 10 x 10
    row: rows (100 floats, 400 bytes) start on a 32- or a 16-byte boundary,
    and either way the 4 x 4 taps (bytes 132-148, 172-188, 212-228 and
    252-268 of the row, or each 16 further) touch 5 sectors. Then 16 bytes
    of xy and base cell a valid point, a flag a slot, and 56 bytes a lane
    (scale, corner, resolution, pose and target in; pose, cost and count
    out). Operations: a valid point's cost pass once and once an iteration,
    its normal pass once an iteration, a lane's step once an iteration.
    Bounded by operations."""
    from hectorgrapher_tpu_torch.mapping.scan_matching import gn_2d as tgn

    args = _k7_args(b, iterations)
    # u - base at the start, by the twin's arithmetic: its floor is 4, so
    # the taps are lanes 3-6.
    u = (tgn._world_of(Rigid2(args[7][:, :2], args[7][:, 2]), args[4]) - args[2][:, None, :]) / args[3][:, None, None]
    assert bool((torch.floor(u - 0.5 - args[1])[args[5]] == 4).all())
    n_valid = int(args[5].sum())
    assert n_valid == b * 203
    nbytes = 5 * 32 * n_valid + 16 * n_valid + b * 2048 + 56 * b
    ops = n_valid * (120 * (1 + iterations) + 282 * iterations) + b * 100 * iterations
    ms, by, got_bytes, got_ops = cs.bound_ms("gn_2d_lm", args)
    assert (got_bytes, got_ops, by) == (nbytes, ops, "operations")
    assert ms == pytest.approx(ops / 67e12 * 1e3, rel=1e-12)


def test_bound_gn_2d_lm_tsdf_reads_both_planes():
    """The TSDF mode reads the weight plane's taps beside the tsd's (the
    same sectors of a second table) and does the TSDF's operation counts."""
    args = list(_k7_args(1, 20))
    args[0] = (args[0][0], args[0][0].clone())
    _, _, nbytes, ops = cs.bound_ms("gn_2d_lm", tuple(args))
    assert nbytes == 2 * 5 * 32 * 203 + 16 * 203 + 2048 + 56
    assert ops == 203 * (168 * 21 + 331 * 20) + 100 * 20
