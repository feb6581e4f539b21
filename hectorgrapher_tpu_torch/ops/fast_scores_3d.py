"""K4: decimated-pyramid scoring of the fast 3D correlative matcher.

Replaces score_sum of hectorgrapher_tpu/mapping/scan_matching/
fast_correlative_3d.py _match_fast_3d_core (:329-436), following its CPU
branch (:344-359, :415-424); it has no Pallas source. The CUDA kernel is
hectorgrapher_tpu_torch/csrc/fast_scores_3d.cu; this module holds its
wrapper and its plain PyTorch version.

One call scores C candidates: candidate c reads point row cand_t[c] of
the point cells bx, by, bz (R, P) (one row per yaw, of one scan or of each
scan of a batched round) and adds its own offsets off_x (C, X), off_y
(C, Y), off_z (C, Z). The output (C, X, Y, Z) holds, per offset triple,
the unnormalised sum over valid points of the level's (bound - 0.1) value;
the matcher turns it into 0.1 + sum / n_valid. The coarse stage calls it
with one candidate per yaw and shared offsets, each expansion level with
the beam's candidates and two offsets per axis. A batched constraint round
scores all its scans in one call over the submaps' stacked level tables:
cand_base (C,) names each candidate's first table row (its submap's slot
times the rows of one block), and valid is (R, P), one flag row per point
row; with one scan, valid (P,) serves every row.

The point cells are integer inputs, computed once by the caller, so the
kernel and its plain version read the same cells (ROADMAP C0). The kernel
sums each output in point order, the plain version in chunks of 32 points
as the JAX CPU branch does: the sums agree to rounding.
"""

from __future__ import annotations

import torch

from hectorgrapher_tpu_torch.ops import _build
from hectorgrapher_tpu_torch.ops.correlative_prep_2d import _check

_CHUNK = 32  # points per step of the plain version (the JAX CPU branch's)


def fast_scores_3d_plain(table, bx, by, bz, valid, cand_t, off_x, off_y, off_z, level: int, y_shift: int,
                         grid_shape, cand_base=None):
    """Plain PyTorch version: (C, X, Y, Z) f32."""
    nx, ny, nz = grid_shape
    span = 1 << level
    nx_l, nz_l = -(-nx // span), -(-nz // span)
    ny_l = table.shape[1]
    c, p = cand_t.shape[0], bx.shape[1]
    t = cand_t.long()
    base = torch.zeros(c, dtype=torch.long, device=table.device) if cand_base is None else cand_base.long()
    zero_row = (base + nz_l * nx_l)[:, None, None, None]  # each candidate's own block's zero row
    flat = table.reshape(-1)
    valid = valid.expand(bx.shape)[t]  # (C, P)
    acc = torch.zeros((c, off_x.shape[1], off_y.shape[1], off_z.shape[1]), dtype=torch.float32, device=table.device)
    for p0 in range(0, p, _CHUNK):
        sl = slice(p0, p0 + _CHUNK)
        ix = bx[t, sl].long()[:, :, None] + off_x[:, None, :]  # (C, CH, X)
        iy = by[t, sl].long()[:, :, None] + off_y[:, None, :]
        iz = bz[t, sl].long()[:, :, None] + off_z[:, None, :]
        x_in = (ix > -span) & (ix < nx)
        z_in = (iz > -span) & (iz < nz)
        row = torch.where(
            x_in[..., :, None] & z_in[..., None, :],
            base[:, None, None, None] + (torch.clamp(iz, min=0) // span)[..., None, :] * nx_l
            + (torch.clamp(ix, min=0) // span)[..., :, None],
            zero_row,
        )  # (C, CH, X, Z)
        pick = (iy > -span) & (iy < ny) & valid[:, sl, None]  # (C, CH, Y)
        lane = torch.clamp(iy, 0, ny - 1) // (1 << y_shift)
        v = flat[row[:, :, :, None, :] * ny_l + lane[:, :, None, :, None]]  # (C, CH, X, Y, Z)
        acc += torch.where(pick[:, :, None, :, None], v, 0.0).sum(dim=1)
    return acc


def fast_scores_3d(table, bx, by, bz, valid, cand_t, off_x, off_y, off_z, level: int, y_shift: int, grid_shape,
                   cand_base=None):
    """Pyramid-level score sums (C, X, Y, Z) f32.

    table: (S * (nz_l * nx_l + 1), ny_l) f32, S level tables stacked, each
    with its zero row last (S = 1 without cand_base); bx, by, bz: (R, P)
    int32 full-resolution point cells; valid: (R, P) or (P,) bool; cand_t:
    (C,) int32 point rows; off_x, off_y, off_z: (C, X), (C, Y), (C, Z)
    int32 cell offsets; grid_shape: the level-0 grid's (nx, ny, nz);
    cand_base: (C,) int64 first table row of each candidate's block, or
    None for one block. CPU tensors take the plain version; CUDA tensors
    launch the kernel.
    """
    device = table.device
    args = (table, bx, by, bz, valid, cand_t, off_x, off_y, off_z, level, y_shift, grid_shape, cand_base)
    if device.type == "cpu":
        return fast_scores_3d_plain(*args)
    if device.type != "cuda":
        raise ValueError(f"fast_scores_3d: unsupported device {device}")
    nx, ny, nz = (int(n) for n in grid_shape)
    r, p = bx.shape
    c, nxo, nyo, nzo = cand_t.shape[0], off_x.shape[1], off_y.shape[1], off_z.shape[1]
    span = 1 << level
    nx_l, ny_l = -(-nx // span), -(-ny // (1 << y_shift))
    nz_l = -(-nz // span)
    rows = nz_l * nx_l + 1
    n_blocks = table.shape[0] // rows if cand_base is not None else 1
    _check("table", table, torch.float32, (n_blocks * rows, ny_l), device)
    for name, x in (("bx", bx), ("by", by), ("bz", bz)):
        _check(name, x, torch.int32, (r, p), device)
    _check("valid", valid, torch.bool, (r, p) if valid.dim() == 2 else (p,), device)
    _check("cand_t", cand_t, torch.int32, (c,), device)
    if cand_base is not None:
        _check("cand_base", cand_base, torch.int64, (c,), device)
    _check("off_x", off_x, torch.int32, (c, nxo), device)
    _check("off_y", off_y, torch.int32, (c, nyo), device)
    _check("off_z", off_z, torch.int32, (c, nzo), device)
    n_per = nxo * nyo * nzo
    if not 0 < c * n_per < 2**31 or n_per > 32 * 65535 or n_blocks < 1:
        raise ValueError(f"fast_scores_3d: unsupported sizes C={c} X={nxo} Y={nyo} Z={nzo} R={r} P={p} "
                         f"blocks={n_blocks}")
    out = torch.empty((c, nxo, nyo, nzo), dtype=torch.float32, device=device)
    _build.launch(
        "hg_fast_scores_3d", device,
        table.data_ptr(), bx.data_ptr(), by.data_ptr(), bz.data_ptr(), valid.data_ptr(), cand_t.data_ptr(),
        None if cand_base is None else cand_base.data_ptr(), off_x.data_ptr(), off_y.data_ptr(), off_z.data_ptr(),
        out.data_ptr(), c, p, p if valid.dim() == 2 else 0, nxo, nyo, nzo, nx, ny, nz, level, y_shift, nx_l, ny_l,
    )
    fast_scores_3d.launches += 1
    return out


fast_scores_3d.launches = 0
