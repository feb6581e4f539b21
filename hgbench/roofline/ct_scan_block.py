"""Work of one per-cloud CT scan-block call (kernel K3's call in a window
solve's normal-equation assembly): bytes and float32 operations as the
call's data needs them.

Copied from chip_smoke.py `_work` / `k3_stencil_cells` (the per-cloud
branch): each input and output once; of each grid, the distinct 32-byte
sectors of the 2x2x2 stencils the masked points read inside the grid
(probability mode: one f32 field; TSDF: two volumes of the storage
dtype); operations counted from csrc/ct_scan_block.cu per masked point.
"""

from __future__ import annotations

import torch

from hgbench.lib.peaks import sectors

# f32 operations per masked point, counted from csrc/ct_scan_block.cu:
# 295 for the world point, stencil, quotient rule and dR(q)p/dq, 253 for
# the 18-column projection and the residual, 380 for the 190 products; in
# probability mode the stencil part (128) becomes one blend, 1 - p and the
# scaled negation (58).
OPS_PER_POINT_TSDF = 295 + 253 + 380
OPS_PER_POINT_PROB = 295 - 128 + 58 + 253 + 380


def _rotate(q, v):
    u, w = q[..., 1:], q[..., :1]
    uv = torch.cross(u.expand_as(v), v, dim=-1)
    return v + 2.0 * (w * uv + torch.cross(u.expand_as(v), uv, dim=-1))


def stencil_cells(grid, points, mask, pose7):
    """Flat indices of the stencil cells the masked points read inside the
    grid, and the number of masked points."""
    world = _rotate(pose7[:, None, 3:], points) + pose7[:, None, :3]
    base = torch.floor((world - grid.meta.min_corner) / grid.meta.resolution - 0.5).long()
    nx, ny, nz = grid.shape
    inside = ((base >= 0) & (base < torch.tensor([nx - 1, ny - 1, nz - 1], device=base.device))).all(dim=-1)
    b = base[mask & inside]
    offs = torch.tensor([dx * ny * nz + dy * nz + dz for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)],
                        device=b.device)
    return (((b[:, 0] * ny + b[:, 1]) * nz + b[:, 2])[:, None] + offs).reshape(-1), int(mask.sum())


def grid_work(grid_pairs, lanes, hi_pts, hi_mask, lo_pts, lo_mask, pose7):
    """(bytes, operations) the grids' stencils add: grid pair d read by the
    clouds of lanes[d]."""
    prob = hasattr(grid_pairs[0][0], "prob")
    nbytes, n_masked = 0, 0
    for (hi, lo), lane in zip(grid_pairs, lanes):
        for grid, pts, mask in ((hi, hi_pts, hi_mask), (lo, lo_pts, lo_mask)):
            cells, n = stencil_cells(grid, pts[lane], mask[lane], pose7[lane])
            element = 4 if prob else grid.tsd.element_size()
            nbytes += (1 if prob else 2) * 32 * sectors(cells, element)
            n_masked += n
    return nbytes, (OPS_PER_POINT_PROB if prob else OPS_PER_POINT_TSDF) * n_masked


def io_bytes(c, hi_pts, hi_mask, lo_pts, lo_mask, pose7, dpose7):
    """Every input once (points, masks, poses and their Jacobians, two
    scales a cloud) and the outputs (S, g, cost a cloud)."""
    return (4 * (hi_pts.numel() + lo_pts.numel() + pose7.numel() + dpose7.numel() + 2 * c)
            + hi_mask.numel() + lo_mask.numel() + 4 * c * (18 * 18 + 18 + 1))


def work(args, kwargs):
    hi, lo, hi_pts, hi_mask, lo_pts, lo_mask, pose7, dpose7 = args[:8]
    c = hi_mask.shape[0]
    nbytes, ops = grid_work([(hi, lo)], [torch.ones_like(hi_mask[:, 0])], hi_pts, hi_mask, lo_pts, lo_mask, pose7)
    return io_bytes(c, hi_pts, hi_mask, lo_pts, lo_mask, pose7, dpose7) + 4 * 8 + nbytes, ops
