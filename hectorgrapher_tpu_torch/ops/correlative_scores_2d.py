"""K2: score assembly for the batched 2D correlative matcher.

Port of hectorgrapher_tpu/ops/pallas_corr2d.py correlative_scores_2d_batched
(the Pallas TPU kernel at :64) together with the row gather its caller
runs before it (jnp.take of the wide-patch table,
hectorgrapher_tpu/mapping/scan_matching/correlative_2d.py:391-392). The
CUDA kernel is hectorgrapher_tpu_torch/csrc/correlative_scores_2d.cu; this
module holds its wrapper and its plain PyTorch version.

At the in-window lanes the TPU kernel's one-hot matmul plus lane rolls is

    scores[b, g*gsz+l, ox, oy] =
        sum_n [valid[b,n] > 0] * table[flat[b,g,n], (ox+jx)*pw + (oy+jy)]

with (jx, jy) = divmod(delta_lin[b, g*gsz+l, n], gsz) and ox, oy < d = 2k+1.
The table's rows hold pw*pw lanes and may be padded past them (the kernel
takes rows of a multiple of 8 lanes: row_stride). Scores are unnormalized
f32 sums of bf16 table values; the kernel and the plain version sum in
different orders.
"""

from __future__ import annotations

import torch

from hectorgrapher_tpu_torch.ops import _build
from hectorgrapher_tpu_torch.ops.correlative_prep_2d import _check

LANES = 128  # the TPU kernel's lane tile: the least padded row

# The plain version gathers (chunk, G, gsz, N, d^2) values at once; this
# caps the chunk at 2^26 of them (about 1 GB with the index tensor).
_PLAIN_CHUNK_ELEMENTS = 1 << 26


def row_stride(pw: int) -> int:
    """Lanes of a padded table row: pw*pw rounded up to a multiple of 8 (16
    bytes of bf16), and at least LANES, the layout the TPU kernel gathers."""
    return max(LANES, -(-pw * pw // 8) * 8)


def correlative_scores_2d_plain(table, flat, delta_lin, valid, n_groups: int, gsz: int, pw: int, k: int):
    """Plain PyTorch version: unnormalized scores (B, T, d, d) f32."""
    d = 2 * k + 1
    b, g, n = flat.shape
    stride = table.shape[1]
    j = delta_lin.reshape(b, g, gsz, n).to(torch.int64)
    off = torch.div(j, gsz, rounding_mode="floor") * pw + torch.remainder(j, gsz)  # (B, G, gsz, N)
    r = torch.arange(d, device=flat.device)
    lanes = (r[:, None] * pw + r[None, :]).reshape(-1)  # (d^2,)
    table_flat = table.reshape(-1)
    keep = valid > 0
    out = torch.empty((b, g, gsz, d * d), dtype=torch.float32, device=flat.device)
    chunk = max(1, _PLAIN_CHUNK_ELEMENTS // (g * gsz * n * d * d))
    for s in range(0, b, chunk):
        e = min(b, s + chunk)
        idx = (flat[s:e, :, None, :].to(torch.int64) * stride + off[s:e])[..., None] + lanes
        vals = table_flat[idx].to(torch.float32)  # (c, G, gsz, N, d^2)
        vals = torch.where(keep[s:e, None, None, :, None], vals, 0.0)
        out[s:e] = vals.sum(dim=3)
    return out.reshape(b, g * gsz, d, d)


def correlative_scores_2d(table, flat, delta_lin, valid, n_groups: int, gsz: int, pw: int, k: int):
    """Unnormalized score volume (B, T, d, d) f32, T = n_groups * gsz.

    table: (R, S) bf16 wide-patch table, lanes >= pw*pw unused (the kernel
    needs S a multiple of 8: prepare_correlative_table's row_stride);
    flat: (B, G, N) int32 rows of it; delta_lin: (B, T, N) int32 in
    [0, gsz^2); valid: (B, N) f32 0/1. CPU tensors take the plain version;
    CUDA tensors launch the kernel.
    """
    device = flat.device
    if device.type == "cpu":
        return correlative_scores_2d_plain(table, flat, delta_lin, valid, n_groups, gsz, pw, k)
    if device.type != "cuda":
        raise ValueError(f"correlative_scores_2d: unsupported device {device}")
    d = 2 * k + 1
    b, _, n = flat.shape
    t_pad = n_groups * gsz
    if pw != d + gsz - 1:
        raise ValueError(f"correlative_scores_2d: pw={pw} does not fit k={k}, gsz={gsz}")
    # The kernel is built for the port's one group size, ANGLE_GROUP = 5.
    if not (0 < b <= 65535 and 0 < n_groups <= 65535 and n > 0 and gsz == 5):
        raise ValueError(f"correlative_scores_2d: unsupported B={b}, G={n_groups}, N={n}, gsz={gsz}")
    stride = table.shape[1]
    if stride % 8 or stride < pw * pw or table.data_ptr() % 16:
        raise ValueError(f"correlative_scores_2d: table rows of {stride} lanes; the kernel needs a 16-byte "
                         f"aligned table with a multiple of 8 lanes >= pw*pw = {pw * pw} (row_stride)")
    _check("table", table, torch.bfloat16, (table.shape[0], stride), device)
    _check("flat", flat, torch.int32, (b, n_groups, n), device)
    _check("delta_lin", delta_lin, torch.int32, (b, t_pad, n), device)
    _check("valid", valid, torch.float32, (b, n), device)
    out = torch.empty((b, t_pad, d, d), dtype=torch.float32, device=device)
    _build.launch(
        "hg_correlative_scores_2d", device,
        table.data_ptr(), flat.data_ptr(), delta_lin.data_ptr(), valid.data_ptr(), out.data_ptr(),
        b, n, n_groups, gsz, pw, d, stride,
    )
    correlative_scores_2d.launches += 1
    return out


correlative_scores_2d.launches = 0
