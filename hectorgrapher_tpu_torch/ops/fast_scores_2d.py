"""K5: pyramid-level scoring of the fast 2D correlative matcher.

Replaces score_sum of hectorgrapher_tpu/mapping/scan_matching/
fast_correlative_2d.py _match_fast_2d_core (:249-301), following its CPU
branch (:281-299); it has no Pallas source. The CUDA kernel is
hectorgrapher_tpu_torch/csrc/fast_scores_2d.cu; this module holds its
wrapper and its plain PyTorch version.

One call scores C candidates at one pyramid level: candidate c reads point
row cand_t[c] of the integer point cells bx, by (R, P) (one row per angle,
of one scan or of each scan of a batched round) and adds its own offsets
off_x (C, X), off_y (C, Y). The output (C, X, Y) holds, per offset pair,
the unnormalised sum over valid points of the level's (prob - 0.1) value;
the matcher turns it into 0.1 + sum / n_valid. The table stacks each
submap's levels, depth blocks of nx + 1 rows (the last row of each block
all zero); cand_base (C,) names each candidate's first row (its submap's
slot times depth * (nx + 1)), and a batched constraint round scores all
its scans in one call per level. valid is (R, P), one flag row per point
row, or (P,) for one scan's rows.

The point cells are computed once by the caller, so the kernel and its
plain version read the same cells (ROADMAP C0). The kernel sums each
output in a fixed order (per lane over its share of the row's valid
points, then a warp tree), the plain version in chunks of 32 points as the
JAX CPU branch does: the sums agree to rounding. The wrapper picks the
kernel's instance from the offset grid X x Y (instance()).
"""

from __future__ import annotations

import torch

from hectorgrapher_tpu_torch.ops import _build
from hectorgrapher_tpu_torch.ops.correlative_prep_2d import _check

_CHUNK = 32  # points per step of the plain version (the JAX CPU branch's)

# Offset grids X x Y with a kernel instance of their own: every expansion
# level's 2 x 2, the local coarse stage's 5 x 5 (linear_cells 40, depth 6)
# and the full-submap coarse stage's 11 x 11 (320 cells, depth 7). Any
# other grid takes the generic instance 0. Numbers of csrc/fast_scores_2d.cu.
INSTANCES = {(2, 2): 1, (5, 5): 2, (11, 11): 3}
_INT32_MAX = 2**31 - 1
# The largest C, Y and P: the kernel forms ints up to a staging chunk
# (2048 slots) past them (a block's last candidate, a chunk's end).
_SIZE_MAX = _INT32_MAX - 2048


def instance(nxo: int, nyo: int) -> int:
    """The kernel instance for an X x Y offset grid (0: generic)."""
    return INSTANCES.get((int(nxo), int(nyo)), 0)


def launch_config(c: int, nxo: int, nyo: int, p: int, level: int) -> int:
    """The kernel instance for C candidates of X x Y offsets over P point
    slots at `level`; raises ValueError on sizes the kernel does not take.
    The grid is one-dimensional, ceil(C / candidates a block) blocks, and
    every index past a row start is 64-bit, so C, Y and P only have to stay
    a chunk below 2^31 (_SIZE_MAX), X * Y an int; the level's span 2^level
    an int too."""
    if not (0 < c <= _SIZE_MAX and 0 < nxo and 0 < nyo <= _SIZE_MAX and nxo * nyo <= _INT32_MAX
            and 0 <= p <= _SIZE_MAX and 0 <= level <= 30):
        raise ValueError(f"fast_scores_2d: unsupported sizes C={c} X={nxo} Y={nyo} P={p} level={level}")
    return instance(nxo, nyo)


def fast_scores_2d_plain(table, bx, by, valid, cand_t, off_x, off_y, level: int, dims, cand_base=None):
    """Plain PyTorch version: (C, X, Y) f32."""
    nx, ny = dims
    span = 1 << level
    c, p = cand_t.shape[0], bx.shape[1]
    t = cand_t.long()
    base = torch.zeros(c, dtype=torch.long, device=table.device) if cand_base is None else cand_base.long()
    base = (base + level * (nx + 1))[:, None, None, None]
    flat = table.reshape(-1)
    valid = valid.expand(bx.shape)[t]  # (C, P)
    acc = torch.zeros((c, off_x.shape[1], off_y.shape[1]), dtype=torch.float32, device=table.device)
    for p0 in range(0, p, _CHUNK):
        sl = slice(p0, p0 + _CHUNK)
        ix = bx[t, sl].long()[:, :, None] + off_x[:, None, :]  # (C, CH, X)
        iy = by[t, sl].long()[:, :, None] + off_y[:, None, :]  # (C, CH, Y)
        row = base + torch.where((ix > -span) & (ix < nx), torch.clamp(ix, min=0), nx)[..., None]  # (C, CH, X, 1)
        pick = (iy > -span) & (iy < ny) & valid[:, sl, None]  # (C, CH, Y)
        v = flat[row * ny + torch.clamp(iy, 0, ny - 1)[:, :, None, :]]  # (C, CH, X, Y)
        acc += torch.where(pick[:, :, None, :], v, 0.0).sum(dim=1)
    return acc


def checked_instance(table, bx, by, valid, cand_t, off_x, off_y, level: int, dims, cand_base=None) -> int:
    """The kernel instance for these arguments (launch_config), after
    checking each one's device (the table's), dtype, shape and contiguity;
    raises ValueError or TypeError on what the kernel does not take. Runs
    before any launch and needs no card."""
    device = table.device
    nx, ny = (int(n) for n in dims)
    r, p = bx.shape
    c, nxo, nyo = cand_t.shape[0], off_x.shape[1], off_y.shape[1]
    rows = table.shape[0]
    if cand_base is None and rows < (level + 1) * (nx + 1):
        raise ValueError(f"fast_scores_2d: a table of {rows} rows has no level {level} of {nx + 1} rows")
    _check("table", table, torch.float32, (rows, ny), device)
    for name, x in (("bx", bx), ("by", by)):
        _check(name, x, torch.int32, (r, p), device)
    _check("valid", valid, torch.bool, (r, p) if valid.dim() == 2 else (p,), device)
    _check("cand_t", cand_t, torch.int32, (c,), device)
    if cand_base is not None:
        _check("cand_base", cand_base, torch.int64, (c,), device)
    _check("off_x", off_x, torch.int32, (c, nxo), device)
    _check("off_y", off_y, torch.int32, (c, nyo), device)
    return launch_config(c, nxo, nyo, p, level)


def fast_scores_2d(table, bx, by, valid, cand_t, off_x, off_y, level: int, dims, cand_base=None):
    """Pyramid-level score sums (C, X, Y) f32.

    table: (rows, ny) f32, submap blocks of depth * (nx + 1) rows stacked
    (one block without cand_base); bx, by: (R, P) int32 full-resolution
    point cells; valid: (R, P) or (P,) bool; cand_t: (C,) int32 point rows;
    off_x, off_y: (C, X), (C, Y) int32 cell offsets; level: the pyramid
    level; dims: the grid's (nx, ny); cand_base: (C,) int64 first table row
    of each candidate's submap block, or None for one block. CPU tensors
    take the plain version; CUDA tensors launch the kernel.
    """
    device = table.device
    args = (table, bx, by, valid, cand_t, off_x, off_y, level, dims, cand_base)
    if device.type == "cpu":
        return fast_scores_2d_plain(*args)
    if device.type != "cuda":
        raise ValueError(f"fast_scores_2d: unsupported device {device}")
    inst = checked_instance(*args)
    nx, ny = (int(n) for n in dims)
    c, nxo, nyo, p = cand_t.shape[0], off_x.shape[1], off_y.shape[1], bx.shape[1]
    out = torch.empty((c, nxo, nyo), dtype=torch.float32, device=device)
    _build.launch(
        "hg_fast_scores_2d", device,
        table.data_ptr(), bx.data_ptr(), by.data_ptr(), valid.data_ptr(), cand_t.data_ptr(),
        None if cand_base is None else cand_base.data_ptr(), off_x.data_ptr(), off_y.data_ptr(), out.data_ptr(),
        c, p, p if valid.dim() == 2 else 0, nxo, nyo, nx, ny, level, inst,
    )
    fast_scores_2d.launches += 1
    return out


fast_scores_2d.launches = 0
