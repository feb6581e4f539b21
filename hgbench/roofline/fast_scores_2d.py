"""Work of one 2D pyramid-level scoring call (kernel K5's call in a
constraint round's level): bytes and operations as the call's data needs
them.

Copied from chip_smoke.py `_work` / `k5_gather` (the fast_scores_2d
branch): the distinct 32-byte sectors of the table cells the counted
points read; the sectors of the valid points' cells in bx and by; the
flags of the named point rows; offsets, row bases and the output once;
one operation per counted point and offset.
"""

from __future__ import annotations

import torch

from hgbench.lib.peaks import sectors


def gather(bx, by, valid, cand_t, off_x, off_y, level, dims, cand_base=None):
    """Flat table indices (C*X*Y, P) and 0/1 weights of the points that
    count, each candidate's rows from its row base."""
    nx, ny = dims
    span = 1 << level
    t = cand_t.long()
    base = (0 if cand_base is None else cand_base.long()[:, None, None]) + level * (nx + 1)
    ix = bx[t].long()[:, :, None] + off_x[:, None, :]
    iy = by[t].long()[:, :, None] + off_y[:, None, :]
    pick = (iy > -span) & (iy < ny) & valid.expand(bx.shape)[t][:, :, None]
    keep = ((ix > -span) & (ix < nx))[:, :, :, None] & pick[:, :, None, :]
    idx = (base + torch.clamp(ix, min=0))[:, :, :, None] * ny + torch.clamp(iy, 0, ny - 1)[:, :, None, :]
    idx = torch.where(keep, idx, 0)
    p = idx.shape[1]
    rows = lambda x: x.permute(0, 2, 3, 1).reshape(-1, p)
    return rows(idx), rows(keep.to(torch.float32))


def work(args, kwargs):
    names = ("table", "bx", "by", "valid", "cand_t", "off_x", "off_y", "level", "dims", "cand_base")
    a = dict(zip(names, args))
    a.update(kwargs)
    bx, by, valid, cand_t = a["bx"], a["by"], a["valid"], a["cand_t"]
    off_x, off_y, cand_base = a["off_x"], a["off_y"], a.get("cand_base")
    dims = tuple(int(n) for n in a["dims"])
    idx, weight = gather(bx, by, valid, cand_t, off_x, off_y, int(a["level"]), dims, cand_base)
    p, rows = bx.shape[1], torch.unique(cand_t).long()
    named = (rows[:, None] * p + torch.arange(p, device=rows.device))[valid.expand(bx.shape)[rows]]
    nbytes = (32 * sectors(idx[weight > 0]) + 2 * 32 * sectors(named)
              + (p * rows.numel() if valid.dim() == 2 else valid.numel())
              + 4 * (cand_t.numel() + off_x.numel() + off_y.numel() + idx.shape[0])
              + (0 if cand_base is None else 8 * cand_base.numel()))
    return nbytes, int(weight.sum())
