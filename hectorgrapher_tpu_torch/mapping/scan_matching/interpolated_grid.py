"""Wide bicubic patch fields for 2D scan matching (counterpart of the 2D
wide-field part of hectorgrapher_tpu/mapping/scan_matching/interpolated_grid.py;
ref: internal/2d/scan_matching/occupied_space_cost_function_2d.cc:47-74).

Out-of-grid reads return the pad value, matching the reference's
GridArrayAdapter padding.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from hectorgrapher_tpu_torch.mapping.grids import GridMeta


class PreparedField2D(NamedTuple):
    """One 2D field ready for wide-row bicubic interpolation."""

    patches: torch.Tensor  # (nx*ny + 1, w*w) f32
    meta: GridMeta
    dims: Tuple[int, int]


def gather_rows_2d(field: PreparedField2D, points):
    """One wide row per point at world xy positions (..., 2) -> (..., w*w)
    f32; out-of-grid bases hit the pad row."""
    nx, ny = field.dims
    u = (points - field.meta.min_corner) / field.meta.resolution - 0.5
    i0 = torch.floor(u).to(torch.int64)
    ok = (i0[..., 0] >= 0) & (i0[..., 0] < nx) & (i0[..., 1] >= 0) & (i0[..., 1] < ny)
    flat = torch.where(ok, i0[..., 0] * ny + i0[..., 1], nx * ny)
    return field.patches[flat].to(torch.float32)


def prepare_field_2d_wide(values, meta: GridMeta, pad_value: float, slack: int) -> PreparedField2D:
    """Bicubic patch matrix widened by `slack` cells per side: row c holds
    the (4+2*slack)^2 neighborhood at c + (-1-slack .. 2+slack)^2, lane
    dx*w + dy; the appended last row is all pad_value.

    One wide row serves every bicubic lookup whose base cell lies within
    `slack` cells of c, so the GN solver gathers once and runs all LM
    iterations from carried rows."""
    nx, ny = values.shape
    w = 4 + 2 * slack
    lo = 1 + slack  # window starts at base cell - (1 + slack)
    hi = 2 + slack
    padded = F.pad(values.to(torch.float32), (lo, hi, lo, hi), value=pad_value)
    table = torch.empty((nx * ny + 1, w * w), dtype=torch.float32, device=values.device)
    table[:-1].view(nx, ny, w, w).copy_(padded.unfold(0, w, 1).unfold(1, w, 1))
    table[-1] = pad_value
    return PreparedField2D(patches=table, meta=meta, dims=(nx, ny))
