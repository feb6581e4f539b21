"""Occupancy insertion of one scan into a 3D probability grid.

The semantics of range_data_inserter_3d.cc Insert as HectorGrapher states
it: each return's cell (floor((p - min_corner) / res)) is a hit; the
misses are the last `num_free_space_voxels` of the n samples origin_cell
+ floor(delta * i / n), i < n, where delta is the hit's cell less the
origin's and n its largest absolute component; a cell that is a hit in
this scan takes no miss; every touched cell's log-odds gains the hit's
or the miss's log-odds, log(p / (1 - p)), clamped to those of [0.1, 0.9],
and becomes known. Cells outside the grid are dropped. The high-resolution
grid takes only returns within its range of the origin.

Computed in `dtype` (float32 as the configuration states, bfloat16 for
the control): the cell coordinates and the log-odds sums.
"""

from __future__ import annotations

import math

import torch

MIN_LOG_ODDS = math.log(0.1 / 0.9)
MAX_LOG_ODDS = math.log(0.9 / 0.1)


def cell_of(points, min_corner, resolution, dtype):
    return torch.floor((points.to(dtype) - min_corner.to(dtype)) / torch.as_tensor(
        resolution, dtype=dtype, device=points.device)).long()


def insert(log_odds, known, min_corner, resolution, origin, returns, valid, hit_p, miss_p, free_voxels,
           dtype=torch.float32):
    """(log_odds, known) after the insertion; log_odds in float32."""
    shape = log_odds.shape
    size = math.prod(shape)
    dev = log_odds.device

    def flat(cells, ok):
        inside = ok.clone()
        for a in range(3):
            inside &= (cells[..., a] >= 0) & (cells[..., a] < shape[a])
        idx = (cells[..., 0].clamp(0, shape[0] - 1) * shape[1] + cells[..., 1].clamp(0, shape[1] - 1)) * shape[2] \
            + cells[..., 2].clamp(0, shape[2] - 1)
        return idx[inside]

    hit_cells = cell_of(returns, min_corner, resolution, dtype)
    hit = torch.zeros(size, dtype=torch.bool, device=dev)
    hit[flat(hit_cells, valid)] = True
    miss = torch.zeros(size, dtype=torch.bool, device=dev)
    if free_voxels > 0:
        o = cell_of(origin[None, :], min_corner, resolution, dtype)[0]
        delta = hit_cells - o
        n = delta.abs().amax(dim=-1)
        for j in range(free_voxels):
            i = n - free_voxels + j
            ok = valid & (i >= 0) & (i < n)
            cells = o + torch.div(delta * i[:, None], n.clamp(min=1)[:, None], rounding_mode="floor")
            miss[flat(cells, ok)] = True
        miss &= ~hit
    hit_lo = torch.tensor(math.log(hit_p / (1 - hit_p)), dtype=dtype, device=dev)
    miss_lo = torch.tensor(math.log(miss_p / (1 - miss_p)), dtype=dtype, device=dev)
    lo = log_odds.reshape(-1).to(dtype)
    new = torch.clamp(lo + torch.where(hit, hit_lo, torch.where(miss, miss_lo, torch.zeros_like(lo))),
                      MIN_LOG_ODDS, MAX_LOG_ODDS)
    touched = hit | miss
    out = torch.where(touched, new, lo).to(torch.float32).reshape(shape)
    return out, (known.reshape(-1) | touched).reshape(shape)
