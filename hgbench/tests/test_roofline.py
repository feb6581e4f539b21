"""The work counts copied under hgbench/roofline/ give the bounds PERF.md's
kernel table records (chip_smoke.py's `_work` / `bound_ms`): K3 at the CT
front end's and GN3D's shapes, on the TSDF and the occupancy maps of
phase 7 (built here on the CPU from the same scans), and K5 equal to the
original's count on a round's call."""

import numpy as np
import pytest
import torch

from hgbench.lib import names
from hgbench.lib.peaks import bound_s

chip_smoke = pytest.importorskip("chip_smoke")
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def maps():
    hi, lo, scan_pts = chip_smoke.ct_production_grids(CPU)
    return (hi, lo), chip_smoke.ct_production_probability_grids(CPU), scan_pts


# (grids, kernel inputs' keyword arguments, the bound in us PERF.md records)
RECORDED = [
    ("tsdf", dict(), 0.602),
    ("tsdf", dict(c=1), 0.045),
    ("prob", dict(outside=16), 0.336),
    ("prob", dict(c=1, outside=16), 0.023),
]


@pytest.mark.parametrize("grids,kw,recorded_us", RECORDED)
def test_k3_bound_at_recorded_shapes(maps, grids, kw, recorded_us):
    tsdf, prob, scan_pts = maps
    hi, lo = tsdf if grids == "tsdf" else prob
    args = chip_smoke.ct_kernel_inputs(CPU, hi, lo, scan_pts, **kw)[:10]
    work = names.load_module("roofline", "ct_scan_block").work(args, {})
    assert work == chip_smoke._work("ct_scan_block", args)
    assert round(bound_s(*work) * 1e6, 3) == recorded_us


def test_k5_count_equals_the_original():
    rng = np.random.default_rng(0)
    r, p, c, x, y, nx, ny, level = 6, 300, 40, 5, 5, 200, 180, 2
    table = torch.rand((3 * (nx + 1) * 4, ny))
    bx = torch.from_numpy(rng.integers(-20, nx + 20, (r, p)).astype(np.int32))
    by = torch.from_numpy(rng.integers(-20, ny + 20, (r, p)).astype(np.int32))
    valid = torch.from_numpy(rng.random((r, p)) < 0.8)
    cand_t = torch.from_numpy(rng.integers(0, r, c).astype(np.int32))
    off_x = torch.from_numpy(rng.integers(-40, 40, (c, x)).astype(np.int32))
    off_y = torch.from_numpy(rng.integers(-40, 40, (c, y)).astype(np.int32))
    cand_base = torch.from_numpy(rng.integers(0, 3, c) * 4 * (nx + 1)).long()
    args = (table, bx, by, valid, cand_t, off_x, off_y, level, (nx, ny), cand_base)
    assert names.load_module("roofline", "fast_scores_2d").work(args, {}) == chip_smoke._work("fast_scores_2d", args)

