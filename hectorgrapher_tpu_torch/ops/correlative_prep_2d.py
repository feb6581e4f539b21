"""K1: candidate-cell preparation for the batched 2D correlative matcher.

Port of hectorgrapher_tpu/ops/pallas_prep2d.py correlative_prep_2d_batched
(the Pallas TPU kernel at :74). The CUDA kernel is
hectorgrapher_tpu_torch/csrc/correlative_prep_2d.cu; this module holds
its wrapper and its plain PyTorch version. Same signature and outputs as
the TPU kernel, with no alignment rule on B or N.

Arithmetic: the cells are floors, so every operation of
((c*px - s*py + tx) - minx) / res rounds on its own, as the JAX source
writes it. The plain version does that as separate eager ops, the kernel
with round-to-nearest intrinsics and no FMA contraction; on the card the
two agree exactly given the same inputs.
"""

from __future__ import annotations

import torch

from hectorgrapher_tpu_torch.ops import _build


def correlative_prep_2d_plain(params, px, py, ca, sa, n_groups: int, gsz: int, margin: int, ex: int, ey: int):
    """Plain PyTorch version: (flat (B, G, N) int32, delta_lin (B, T, N) int32)."""
    half = gsz // 2
    tx, ty, minx, miny, res = (params[:, i, None, None] for i in range(5))  # (B, 1, 1)
    c = ca[:, :, None]  # (B, T, 1)
    s = sa[:, :, None]
    x = px[:, None, :]  # (B, 1, N)
    y = py[:, None, :]
    ix = torch.floor(((c * x - s * y + tx) - minx) / res).to(torch.int32)  # (B, T, N)
    iy = torch.floor(((s * x + c * y + ty) - miny) / res).to(torch.int32)
    b, t_pad, n = ix.shape
    ix = ix.reshape(b, n_groups, gsz, n)
    iy = iy.reshape(b, n_groups, gsz, n)
    cx = ix[:, :, half]  # (B, G, N)
    cy = iy[:, :, half]
    cxe = cx + margin
    cye = cy + margin
    in_ext = (cxe >= 0) & (cxe < ex) & (cye >= 0) & (cye < ey)
    flat = torch.where(in_ext, cxe * ey + cye, ex * ey).to(torch.int32)
    dx = torch.clamp(ix - cx[:, :, None], -half, half) + half
    dy = torch.clamp(iy - cy[:, :, None], -half, half) + half
    delta_lin = (dx * gsz + dy).reshape(b, t_pad, n).to(torch.int32)
    return flat, delta_lin


def _check(name, x, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def correlative_prep_2d(params, px, py, ca, sa, n_groups: int, gsz: int, margin: int, ex: int, ey: int):
    """Batched prep: (flat (B, G, N) int32, delta_lin (B, T, N) int32).

    params: (B, 8) f32 [tx, ty, min_x, min_y, resolution, 0, 0, 0];
    px, py: (B, N) f32 tracking-frame meters; ca, sa: (B, T) f32 cos/sin of
    the candidate angles, T = n_groups * gsz. CPU tensors take the plain
    version; CUDA tensors launch the kernel.
    """
    device = px.device
    if device.type == "cpu":
        return correlative_prep_2d_plain(params, px, py, ca, sa, n_groups, gsz, margin, ex, ey)
    if device.type != "cuda":
        raise ValueError(f"correlative_prep_2d: unsupported device {device}")
    b, n = px.shape
    t_pad = n_groups * gsz
    _check("params", params, torch.float32, (b, 8), device)
    _check("px", px, torch.float32, (b, n), device)
    _check("py", py, torch.float32, (b, n), device)
    _check("ca", ca, torch.float32, (b, t_pad), device)
    _check("sa", sa, torch.float32, (b, t_pad), device)
    if not (0 < b <= 65535 and 0 < n_groups <= 65535 and n > 0 and gsz % 2 == 1):
        raise ValueError(f"correlative_prep_2d: unsupported B={b}, G={n_groups}, N={n}, gsz={gsz}")
    if ex * ey >= 2**31:
        raise ValueError("correlative_prep_2d: extended grid exceeds int32 row indices")
    flat = torch.empty((b, n_groups, n), dtype=torch.int32, device=device)
    delta_lin = torch.empty((b, t_pad, n), dtype=torch.int32, device=device)
    _build.launch(
        "hg_correlative_prep_2d", device,
        params.data_ptr(), px.data_ptr(), py.data_ptr(), ca.data_ptr(), sa.data_ptr(),
        flat.data_ptr(), delta_lin.data_ptr(),
        b, n, n_groups, gsz, margin, ex, ey,
    )
    correlative_prep_2d.launches += 1
    return flat, delta_lin


correlative_prep_2d.launches = 0
