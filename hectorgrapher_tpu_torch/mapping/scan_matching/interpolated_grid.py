"""Grid interpolation for scan matching (counterpart of
hectorgrapher_tpu/mapping/scan_matching/interpolated_grid.py: the 2D wide
bicubic field, the 2D bicubic and bilinear interpolation API, the 3D
weight-aware TSDF stencil and the 3D occupancy stencil; ref: internal/2d/scan_matching/occupied_space_cost_function_2d.cc
:47-74, internal/3d/scan_matching/interpolated_multi_resolution_tsdf.h
:38-58, interpolated_grid.h).

Out-of-grid reads return the pad value, matching the reference's
GridArrayAdapter padding: 0 weight (unknown) for a TSDF, MIN_PROBABILITY
for an occupancy grid.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from hectorgrapher_tpu_torch.mapping import probability_values as pv
from hectorgrapher_tpu_torch.mapping.grids import GridMeta, ProbabilityGrid, TSDFGrid, ensure_f32_grid


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


def prepare_field_2d_wide(values, meta: GridMeta, pad_value, slack: int) -> PreparedField2D:
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
    # fill_ takes a float or a 0-dim tensor (a grid's truncation distance,
    # read on the device without a host sync).
    padded = torch.empty((nx + lo + hi, ny + lo + hi), dtype=torch.float32, device=values.device).fill_(pad_value)
    padded[lo:lo + nx, lo:lo + ny] = values
    table = torch.empty((nx * ny + 1, w * w), dtype=torch.float32, device=values.device)
    table[:-1].view(nx, ny, w, w).copy_(padded.unfold(0, w, 1).unfold(1, w, 1))
    table[-1].fill_(pad_value)
    return PreparedField2D(patches=table, meta=meta, dims=(nx, ny))


# ---------------------------------------------------------------------------
# 2D bicubic and bilinear interpolation (interpolated_grid.py :100-208,
# :496-570 of the JAX package): the public 2D interpolation API. Nothing in
# either package's pipeline calls it; the GN refinement reads the wide
# fields above.
# ---------------------------------------------------------------------------


def prepare_field_2d(values, meta: GridMeta, pad_value) -> PreparedField2D:
    """The 16-tap bicubic patch matrix of values (nx, ny) (:496): the wide
    table at slack 0, row c the 4x4 cells c + (-1..2)^2, lane dx*4 + dy,
    the last row all pad. The JAX package pads in the values' dtype, so the
    pad value is rounded to it first (a half grid pads with its own
    rounding of the truncation distance)."""
    return prepare_field_2d_wide(values, meta, torch.as_tensor(pad_value).to(values.dtype).to(torch.float32), 0)


def interp_prepared_2d(field: PreparedField2D, points):
    """Bicubic (Catmull-Rom) interpolation of a prepared field at world xy
    positions (..., 2) (:541): one 16-tap row a point, weighted by the
    outer product of the two axes' cubic weights. Out-of-grid base cells
    read the pad row."""
    u = (points - field.meta.min_corner) / field.meta.resolution - 0.5
    frac = u - torch.floor(u)
    wx, wy = _cubic_weights(frac[..., 0]), _cubic_weights(frac[..., 1])
    w = (wx[..., :, None] * wy[..., None, :]).reshape(points.shape[:-1] + (16,))
    return torch.sum(gather_rows_2d(field, points) * w, dim=-1)


def _cubic_weights(t):
    """Catmull-Rom cubic convolution weights for offsets (-1, 0, 1, 2)
    (:23-31)."""
    t2 = t * t
    t3 = t2 * t
    return torch.stack([0.5 * (-t3 + 2 * t2 - t), 0.5 * (3 * t3 - 5 * t2 + 2), 0.5 * (-3 * t3 + 4 * t2 + t),
                        0.5 * (t3 - t2)], dim=-1)


def interp_bicubic_2d(values, meta: GridMeta, points, pad_value):
    """Bicubic interpolation of values (nx, ny) at world positions (...,
    2) (:100); out-of-grid base cells read pad_value."""
    return interp_prepared_2d(prepare_field_2d(values, meta, pad_value), points)


def interp_bilinear_2d(values, meta: GridMeta, points, pad_value):
    """Bilinear interpolation of values (nx, ny) at world positions (...,
    2) (:122), tap by tap in f32; taps outside the grid read pad_value."""
    nx, ny = values.shape
    u = (points - meta.min_corner) / meta.resolution - 0.5
    i0 = torch.floor(u).to(torch.int64)
    frac = u - i0
    out = torch.zeros(points.shape[:-1], dtype=torch.float32, device=points.device)
    for dx in range(2):
        ix = i0[..., 0] + dx
        ok_x = (ix >= 0) & (ix < nx)
        wx = frac[..., 0] if dx else 1.0 - frac[..., 0]
        for dy in range(2):
            iy = i0[..., 1] + dy
            ok = ok_x & (iy >= 0) & (iy < ny)
            wy = frac[..., 1] if dy else 1.0 - frac[..., 1]
            v = values[torch.clamp(ix, 0, nx - 1), torch.clamp(iy, 0, ny - 1)].to(torch.float32)
            out = out + wx * wy * torch.where(ok, v, pad_value)
    return out


def probability_at_2d(grid: ProbabilityGrid, points, bicubic: bool = True):
    """Occupancy probability at world xy positions (:192); unknown and
    outside cells read MIN_PROBABILITY. A uint16 grid is decoded first (the
    JAX package would interpolate its codes)."""
    grid = ensure_f32_grid(grid)
    fn = interp_bicubic_2d if bicubic else interp_bilinear_2d
    return fn(grid.probability(), grid.meta, points, pv.MIN_PROBABILITY)


def tsd_at_2d(grid: TSDFGrid, points, bicubic: bool = True):
    """(tsd, weight) at world xy positions (:201); unknown and outside
    cells read (truncation_distance, 0). A uint16 grid is decoded first."""
    grid = ensure_f32_grid(grid)
    fn = interp_bicubic_2d if bicubic else interp_bilinear_2d
    return fn(grid.tsd, grid.meta, points, grid.truncation_distance), fn(grid.weight, grid.meta, points, 0.0)


def prepare_probability_2d(grid: ProbabilityGrid) -> PreparedField2D:
    """(:555) The bicubic field of the grid's probability."""
    grid = ensure_f32_grid(grid)
    return prepare_field_2d(grid.probability(), grid.meta, pv.MIN_PROBABILITY)


class PreparedTsdf2D(NamedTuple):
    """(:561) The bicubic fields of a 2D TSDF's two planes."""

    tsd_field: PreparedField2D
    weight_field: PreparedField2D


def prepare_tsdf_2d(grid: TSDFGrid) -> PreparedTsdf2D:
    """(:565) A uint16 grid is decoded first; half planes pad in their own
    dtype, as in the JAX package."""
    grid = ensure_f32_grid(grid)
    return PreparedTsdf2D(tsd_field=prepare_field_2d(grid.tsd, grid.meta, grid.truncation_distance),
                          weight_field=prepare_field_2d(grid.weight, grid.meta, 0.0))


# ---------------------------------------------------------------------------
# 3D stencils: TSDF and occupancy
# ---------------------------------------------------------------------------
#
# The JAX package gathers the 2x2x2 stencil from a z-segment row table laid
# out for TPU lanes (interpolated_grid.py:243-329). Here the stencil reads
# the volumes directly: the grid's two for a TSDF, the prepared probability
# field for an occupancy grid. The same eight cells, the same arithmetic;
# csrc/ct_scan_block.cu computes each point the same way.


class PreparedProb3D(NamedTuple):
    """An occupancy grid ready for the 3D stencil (prepare_prob_3d of the
    JAX package, without its z-segment table): its probability, unknown
    cells at MIN_PROBABILITY, as one contiguous f32 volume."""

    prob: torch.Tensor  # (nx, ny, nz) f32
    meta: GridMeta

    @property
    def shape(self):
        return tuple(self.prob.shape)


def prepare_prob_3d(grid: ProbabilityGrid) -> PreparedProb3D:
    """(interpolated_grid.py prepare_prob_3d :311-329.) One pass over the
    grid; kernel K3 and the plain stencil read the result."""
    return PreparedProb3D(prob=grid.probability().contiguous(), meta=grid.meta)


def prepare_grid_3d(grid):
    """A grid as the 3D stencil and kernel K3 read it
    (interpolated_grid.py prepare_grid_3d :469-477): uint16 codes decoded
    first; a TSDFGrid as it is (its volumes are read in place, f32 or
    half), a
    ProbabilityGrid as its PreparedProb3D; a PreparedProb3D passes
    through."""
    grid = ensure_f32_grid(grid)
    if isinstance(grid, ProbabilityGrid):
        return prepare_prob_3d(grid)
    if isinstance(grid, (TSDFGrid, PreparedProb3D)):
        return grid
    raise TypeError(f"prepare_grid_3d: not a 3D grid: {type(grid).__name__}")


def stencil_3d(grid, points):
    """Base-cell decomposition (interpolated_grid.py _stencil_3d :332-361):
    (ok, base, frac). ok (...,) is the interior-only test (the whole
    2x2x2 stencil inside the grid; boundary and outside points read as
    unknown); base (...,) the flat index of the stencil's (0, 0, 0) cell,
    0 where not ok; frac (..., 3).

    u = ((p - min_corner) / resolution) - 0.5, each op rounded on its own,
    as the kernel rounds it: the floor picks the cells."""
    nx, ny, nz = grid.shape
    u = (points - grid.meta.min_corner) / grid.meta.resolution - 0.5
    i0 = torch.floor(u)
    frac = u - i0
    ix, iy, iz = i0[..., 0], i0[..., 1], i0[..., 2]
    ok = (ix >= 0) & (ix < nx - 1) & (iy >= 0) & (iy < ny - 1) & (iz >= 0) & (iz < nz - 1)
    i0 = torch.where(ok[..., None], i0, 0.0).to(torch.int64)
    base = (i0[..., 0] * ny + i0[..., 1]) * nz + i0[..., 2]
    return ok, base, frac


def _field_and_dfrac(r, fx, fy, fz):
    """One field's trilinear value and d/dfrac from its stencil values
    r[(dx, dy)][dz], in the order of interpolated_grid.py
    _field_and_dfrac :421-442: blend x and y per z, then z."""
    gx, gy = 1.0 - fx, 1.0 - fy
    w00, w01, w10, w11 = gx * gy, gx * fy, fx * gy, fx * fy
    m, mdx, mdy = [], [], []
    for z in range(2):
        r0, r1, r2, r3 = r[0][z], r[1][z], r[2][z], r[3][z]
        m.append(w00 * r0 + w01 * r1 + w10 * r2 + w11 * r3)
        mdx.append(gy * (r2 - r0) + fy * (r3 - r1))
        mdy.append(gx * (r1 - r0) + fx * (r3 - r2))
    gz = 1.0 - fz
    val = m[0] * gz + m[1] * fz
    dval = torch.stack([mdx[0] * gz + mdx[1] * fz, mdy[0] * gz + mdy[1] * fz, m[1] - m[0]], dim=-1)
    return val, dval


def tsdf_value_and_dfrac_3d(grid: TSDFGrid, points):
    """Weight-gated match value (...,) and its d/dfrac (..., 3) at world
    points (interpolated_grid.py tsdf_value_and_dfrac :445-459): the
    trilinear blends of w and w*tsd, val = (w*tsd)/w where w > 1e-6 and 0
    elsewhere, and the quotient rule for the derivative. Half planes (f16,
    bf16) are read as f32 before the product w * tsd, as the JAX prepare
    upcasts them (interpolated_grid.py :298-300): tap by tap, as K3 does,
    so no f32 copy of the volumes is made."""
    nx, ny, nz = grid.shape
    ok, base, frac = stencil_3d(grid, points)
    weight = grid.weight.reshape(-1)
    tsd = grid.tsd.reshape(-1)
    okf = ok.to(torch.float32)
    rw, rt = [], []
    for dx, dy in ((0, 0), (0, 1), (1, 0), (1, 1)):
        zw, zt = [], []
        for dz in range(2):
            idx = base + (dx * ny * nz + dy * nz + dz)
            w = weight[idx].to(torch.float32) * okf
            zw.append(w)
            zt.append(w * tsd[idx].to(torch.float32))
        rw.append(zw)
        rt.append(zt)
    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
    w, dw = _field_and_dfrac(rw, fx, fy, fz)
    wtsd, dwtsd = _field_and_dfrac(rt, fx, fy, fz)
    gate = w > 1e-6
    safe = torch.clamp(w, min=1e-6)
    val = torch.where(gate, wtsd / safe, 0.0)
    dval = torch.where(
        gate[..., None], (dwtsd * safe[..., None] - wtsd[..., None] * dw) / (safe * safe)[..., None], 0.0
    )
    return val, dval


def prob_value_and_dfrac_3d(prepared: PreparedProb3D, points):
    """Match value 1 - p (...,) and its d/dfrac -dp (..., 3) at world
    points (interpolated_grid.py prob_value_and_dfrac :462-466): the
    trilinear blend of the prepared probabilities over the interior-only
    stencil. A point whose stencil leaves the interior reads eight
    MIN_PROBABILITY taps, as JAX reads its pad row: a value of about 0.9
    and a derivative of 0, so points outside the grid still cost."""
    _, ny, nz = prepared.shape
    ok, base, frac = stencil_3d(prepared, points)
    prob = prepared.prob.reshape(-1)
    r = []
    for dx, dy in ((0, 0), (0, 1), (1, 0), (1, 1)):
        r.append([torch.where(ok, prob[base + (dx * ny * nz + dy * nz + dz)], pv.MIN_PROBABILITY)
                  for dz in range(2)])
    p, dp = _field_and_dfrac(r, frac[..., 0], frac[..., 1], frac[..., 2])
    return 1.0 - p, -dp


def value_and_dfrac_3d(grid, points):
    """The match value and its d/dfrac of a TSDFGrid
    (tsdf_value_and_dfrac_3d) or a PreparedProb3D
    (prob_value_and_dfrac_3d). An unprepared ProbabilityGrid is an error:
    its field is built once per grid version, by prepare_grid_3d."""
    if isinstance(grid, TSDFGrid):
        return tsdf_value_and_dfrac_3d(grid, points)
    if isinstance(grid, PreparedProb3D):
        return prob_value_and_dfrac_3d(grid, points)
    raise TypeError(f"value_and_dfrac_3d: a {type(grid).__name__}; prepare a ProbabilityGrid with prepare_grid_3d")
