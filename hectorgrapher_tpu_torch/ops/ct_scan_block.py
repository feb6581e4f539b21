"""K3: the CT window solve's per-cloud scan-block assembly.

Replaces the XLA fusion of hectorgrapher_tpu/mapping/ct/window_solver.py
scan_block (:467-513) with the per-block einsums of _make_ct_assemble
(:611-613), over the 3D stencils of
hectorgrapher_tpu/mapping/scan_matching/interpolated_grid.py (:332-466).
It has no Pallas source. The CUDA kernel is
hectorgrapher_tpu_torch/csrc/ct_scan_block.cu; this module holds its
wrapper and its plain PyTorch version.

Modes, by the grids' type and storage: TSDFGrids take the weighted TSDF
value (tsdf_value_and_dfrac_3d), in the kernel's f32, f16 or bf16 TSDF
mode by the dtype of their planes (grid_storage_dtype); PreparedProb3D
fields, the occupancy grids prepared by prepare_grid_3d once per grid
version, take 1 - p (prob_value_and_dfrac_3d). Both grids of a call, and
all the submaps of a slot table, have one type and one storage dtype. A
half plane is read in place: the kernel converts each tap to f32 as it
loads it, and the plain version upcasts the gathered taps, so neither
makes an f32 copy of a volume. An unprepared ProbabilityGrid is an
error: nothing here builds its field.

For each cloud c, with pose7[c] = [t, q] and its Jacobian dpose7[c] on
the cloud's 18-dim control-point pair tangent, every hi-res point (scaled
by hi_scale[c]) and lo-res point (lo_scale[c]) gives one residual
r = val * s and one row J = [dval/dworld, dval/dq] @ dpose7 * s. Returns
S = J^T J (C, 18, 18), g = J^T r (C, 18) and cost = 0.5 * sum r^2 (C,).

Arithmetic: the world point and the cell floor round every operation on
its own (ROADMAP C0), in the plain version as separate eager ops and in
the kernel with round-to-nearest intrinsics under --fmad=false, so on the
card both pick the same cells. The per-point values agree to rounding;
the sums over points run in another order (the kernel's over eight
slices of each cloud, then the slices in order; the plain version's as
matmuls).

ct_scan_block_slots assembles the clouds of a packed GN3D run (one
constraint round's lanes against D distinct submaps): cloud c against
the grids of slot[c]. The kernel reads them through a table of the
submaps' volume pointers (grid_slots), so the round stacks no copy of
the volumes; per cloud it computes what ct_scan_block computes for that
cloud alone, bit for bit, and its plain version calls the plain
ct_scan_block once per cloud.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from hectorgrapher_tpu_torch.mapping.grids import TSDFGrid
from hectorgrapher_tpu_torch.mapping.scan_matching.interpolated_grid import PreparedProb3D, value_and_dfrac_3d
from hectorgrapher_tpu_torch.ops import _build
from hectorgrapher_tpu_torch.ops.correlative_prep_2d import _check
from hectorgrapher_tpu_torch.transform.rigid import cross, quat_rotate


def dquat_rotate_dq(q, p):
    """d(R(q) p)/dq as a free 4-vector (..., 3, 4), wxyz (window_solver.py
    _dquat_rotate_dq :323-345); q (..., 4) broadcasts against p (..., 3).

    R(q)p = (w^2 - v.v) p + 2 (v.p) v + 2 w (v x p); exact for tangents
    orthogonal to q, which the pose chain's final normalize guarantees."""
    w = q[..., 0:1]
    v = q[..., 1:4]
    vb = v.expand(p.shape)
    dw = 2.0 * (w * p + cross(vb, p))
    vdotp = (vb[..., 0] * p[..., 0] + vb[..., 1] * p[..., 1] + vb[..., 2] * p[..., 2])[..., None]
    cols = [dw]
    eye = torch.eye(3, dtype=p.dtype, device=p.device)
    for i in range(3):
        e = eye[i]
        cols.append(
            -2.0 * q[..., 1 + i : 2 + i] * p
            + 2.0 * p[..., i : i + 1] * v
            + 2.0 * vdotp * e
            + 2.0 * w * cross(e.expand(p.shape), p)
        )
    return torch.stack(cols, dim=-1)


def _grid_rows(grid, points, mask, pose7, dpose7, scale):
    """Per-point residuals (C, P) and Jacobian rows (C, P, 18) of one grid
    (a TSDFGrid or a PreparedProb3D)."""
    pose_t, pose_q = pose7[:, None, :3], pose7[:, None, 3:]
    world = quat_rotate(pose_q, points) + pose_t
    val, dval_dfrac = value_and_dfrac_3d(grid, world)
    sm = torch.where(mask, scale[:, None], 0.0)
    dval_dworld = dval_dfrac / grid.meta.resolution
    dval_dq = torch.einsum("cpi,cpij->cpj", dval_dworld, dquat_rotate_dq(pose_q, points))
    row7 = torch.cat([dval_dworld, dval_dq], dim=-1)
    return val * sm, torch.einsum("cpk,ckj->cpj", row7, dpose7) * sm[..., None]


def ct_scan_block_plain(hi_grid, lo_grid, hi_points, hi_mask, lo_points, lo_mask, pose7, dpose7, hi_scale, lo_scale):
    """Plain PyTorch version: (S (C, 18, 18), g (C, 18), cost (C,))."""
    hi_r, hi_j = _grid_rows(hi_grid, hi_points, hi_mask, pose7, dpose7, hi_scale)
    lo_r, lo_j = _grid_rows(lo_grid, lo_points, lo_mask, pose7, dpose7, lo_scale)
    J = torch.cat([hi_j, lo_j], dim=1)
    r = torch.cat([hi_r, lo_r], dim=1)
    S = torch.einsum("cri,crj->cij", J, J)
    g = torch.einsum("cri,cr->ci", J, r)
    return S, g, 0.5 * torch.sum(r * r, dim=1)


def grid_params(hi_grid, lo_grid):
    """The kernel's grid parameters (8,) f32 on the grids' device: [hi
    min_corner (3), hi resolution, lo min_corner (3), lo resolution]. A
    caller that assembles many blocks over the same grids builds it once."""
    return torch.cat([
        hi_grid.meta.min_corner.reshape(3), hi_grid.meta.resolution.reshape(1),
        lo_grid.meta.min_corner.reshape(3), lo_grid.meta.resolution.reshape(1),
    ]).to(dtype=torch.float32).contiguous()


# The kernel's modes (kMode* of csrc/ct_scan_block.cu), by name.
MODE_TSDF, MODE_PROB, MODE_TSDF_F16, MODE_TSDF_BF16 = 0, 1, 2, 3
_TSDF_MODES = {torch.float32: MODE_TSDF, torch.float16: MODE_TSDF_F16, torch.bfloat16: MODE_TSDF_BF16}


def _grid_mode(label: str, grid, where: str) -> int:
    if isinstance(grid, PreparedProb3D):
        return MODE_PROB
    if not isinstance(grid, TSDFGrid):
        raise TypeError(f"{where}: {label} grid is a {type(grid).__name__}, not a TSDFGrid or a "
                        "PreparedProb3D (prepare a ProbabilityGrid with prepare_grid_3d)")
    if grid.tsd.dtype != grid.weight.dtype or grid.tsd.dtype not in _TSDF_MODES:
        raise TypeError(f"{where}: {label} grid's planes are {grid.tsd.dtype} and {grid.weight.dtype}; "
                        "the kernel reads f32, f16 or bf16 planes of one dtype (decode uint16 grids with "
                        "prepare_grid_3d)")
    return _TSDF_MODES[grid.tsd.dtype]


def kernel_mode(hi_grid, lo_grid, where: str) -> int:
    """The kernel mode (MODE_*) of the grid pair: probability mode for
    PreparedProb3D fields, a TSDF mode by the planes' dtype for TSDFGrids.
    Raises on anything else, an unprepared ProbabilityGrid or uint16 codes
    included, and on a pair of two types or two storage dtypes."""
    modes = [_grid_mode(label, g, where) for label, g in (("hi", hi_grid), ("lo", lo_grid))]
    if modes[0] != modes[1]:
        raise TypeError(f"{where}: the hi and lo grids differ in type or storage dtype")
    return modes[0]


def _volumes(label: str, grid, device, where: str):
    """The checked volume pointers (field or tsd, weight or 0) of one 3D
    grid."""
    shape = grid.shape
    if len(shape) != 3 or math.prod(shape) >= 2**31:
        raise ValueError(f"{where}: unsupported {label} grid shape {shape}")
    if isinstance(grid, PreparedProb3D):
        _check(f"{label}.prob", grid.prob, torch.float32, shape, device)
        return grid.prob.data_ptr(), 0
    _check(f"{label}.tsd", grid.tsd, grid.tsd.dtype, shape, device)
    _check(f"{label}.weight", grid.weight, grid.tsd.dtype, shape, device)
    return grid.tsd.data_ptr(), grid.weight.data_ptr()


def _count(fn, mode: int) -> None:
    """One launch of fn in `mode`, counted in total and by mode."""
    fn.launches += 1
    fn.prob_launches += mode == MODE_PROB
    fn.f16_launches += mode == MODE_TSDF_F16
    fn.bf16_launches += mode == MODE_TSDF_BF16


def ct_scan_block(hi_grid, lo_grid, hi_points, hi_mask, lo_points, lo_mask, pose7, dpose7, hi_scale, lo_scale,
                  gparams=None):
    """Per-cloud scan blocks: (S (C, 18, 18), g (C, 18), cost (C,)) f32.

    hi_grid, lo_grid: both TSDFGrids with contiguous (nx, ny, nz) volumes
    of one dtype, f32, f16 or bf16, or both PreparedProb3D fields
    (probability mode);
    hi_points (C, P, 3) f32 and hi_mask (C, P) bool (likewise lo, with its
    own P); pose7 (C, 7) f32 [t, q wxyz]; dpose7 (C, 7, 18) f32; hi_scale,
    lo_scale (C,) f32; gparams: grid_params(hi_grid, lo_grid), built here
    when not given. CPU tensors take the plain version; CUDA tensors
    launch the kernel.
    """
    device = hi_points.device
    args = (hi_grid, lo_grid, hi_points, hi_mask, lo_points, lo_mask, pose7, dpose7, hi_scale, lo_scale)
    if device.type == "cpu":
        return ct_scan_block_plain(*args)
    if device.type != "cuda":
        raise ValueError(f"ct_scan_block: unsupported device {device}")
    c, p_hi = hi_mask.shape
    p_lo = lo_mask.shape[1]
    mode = kernel_mode(hi_grid, lo_grid, "ct_scan_block")
    hi_ptrs = _volumes("hi_grid", hi_grid, device, "ct_scan_block")
    lo_ptrs = _volumes("lo_grid", lo_grid, device, "ct_scan_block")
    _check("hi_points", hi_points, torch.float32, (c, p_hi, 3), device)
    _check("hi_mask", hi_mask, torch.bool, (c, p_hi), device)
    _check("lo_points", lo_points, torch.float32, (c, p_lo, 3), device)
    _check("lo_mask", lo_mask, torch.bool, (c, p_lo), device)
    _check("pose7", pose7, torch.float32, (c, 7), device)
    _check("dpose7", dpose7, torch.float32, (c, 7, 18), device)
    _check("hi_scale", hi_scale, torch.float32, (c,), device)
    _check("lo_scale", lo_scale, torch.float32, (c,), device)
    if gparams is None:
        gparams = grid_params(hi_grid, lo_grid)
    _check("gparams", gparams, torch.float32, (8,), device)
    if not 0 < c <= 65535:
        raise ValueError(f"ct_scan_block: unsupported C={c}")
    out = torch.empty(c * (18 * 18 + 18 + 1), dtype=torch.float32, device=device)  # one allocation: S, g, cost
    S = out[: c * 324].view(c, 18, 18)
    g = out[c * 324 : c * 342].view(c, 18)
    cost = out[c * 342 :]
    _build.launch(
        "hg_ct_scan_block", device, *hi_ptrs, *lo_ptrs,
        gparams.data_ptr(), hi_points.data_ptr(), hi_mask.data_ptr(), lo_points.data_ptr(), lo_mask.data_ptr(),
        pose7.data_ptr(), dpose7.data_ptr(), hi_scale.data_ptr(), lo_scale.data_ptr(),
        S.data_ptr(), g.data_ptr(), cost.data_ptr(),
        c, p_hi, p_lo, *hi_grid.shape, *lo_grid.shape, mode,
    )
    _count(ct_scan_block, mode)
    return S, g, cost


# Launches in all, and in the probability, f16 and bf16 TSDF modes.
ct_scan_block.launches = ct_scan_block.prob_launches = 0
ct_scan_block.f16_launches = ct_scan_block.bf16_launches = 0


class GridSlots(NamedTuple):
    """The grid pairs of D distinct submaps, as the slotted kernel reads
    them: the grids themselves (which keep the volumes alive), their
    volume pointers (D, 4) int64 [hi tsd, hi weight, lo tsd, lo weight],
    or [hi field, 0, lo field, 0] in probability mode, and their
    parameters (D, 8) f32 (grid_params), both on the grids' device; the
    kernel mode of the whole table."""

    hi: Tuple[object, ...]
    lo: Tuple[object, ...]
    ptrs: torch.Tensor
    gparams: torch.Tensor
    mode: int = MODE_TSDF  # MODE_*: one grid type and storage dtype for every submap

    @property
    def prob(self) -> bool:
        """Whether the table takes the kernel's probability mode."""
        return self.mode == MODE_PROB


def grid_slots(hi_grids, lo_grids) -> GridSlots:
    """GridSlots of the grid pairs (hi_grids[d], lo_grids[d]): all
    TSDFGrids of one storage dtype (f32, f16 or bf16) or all
    PreparedProb3D fields. Every hi grid must have one shape, every lo
    grid one shape, all contiguous on one device."""
    hi_grids, lo_grids = tuple(hi_grids), tuple(lo_grids)
    if not hi_grids or len(hi_grids) != len(lo_grids):
        raise ValueError(f"grid_slots: {len(hi_grids)} hi and {len(lo_grids)} lo grids")
    device = hi_grids[0].meta.min_corner.device
    modes = {kernel_mode(h, lo, "grid_slots") for h, lo in zip(hi_grids, lo_grids)}
    if len(modes) != 1:
        raise TypeError("grid_slots: the submaps differ in grid type or storage dtype")
    rows = []
    for d, (h, lo) in enumerate(zip(hi_grids, lo_grids)):
        if h.shape != hi_grids[0].shape or lo.shape != lo_grids[0].shape:
            raise ValueError(f"grid_slots: submap {d}'s grid shapes {h.shape}, {lo.shape} differ from submap 0's")
        rows.append([*_volumes(f"hi_grids[{d}]", h, device, "grid_slots"),
                     *_volumes(f"lo_grids[{d}]", lo, device, "grid_slots")])
    ptrs = torch.tensor(rows, dtype=torch.int64).to(device)
    gparams = torch.stack([grid_params(h, lo) for h, lo in zip(hi_grids, lo_grids)]).contiguous()
    return GridSlots(hi_grids, lo_grids, ptrs, gparams, modes.pop())


def ct_scan_block_slots_plain(slots: GridSlots, slot, hi_points, hi_mask, lo_points, lo_mask, pose7, dpose7,
                              hi_scale, lo_scale):
    """Plain PyTorch version: ct_scan_block_plain of each cloud alone
    against its slot's grids, (S (C, 18, 18), g (C, 18), cost (C,))."""
    per_cloud = []
    for c, d in enumerate(slot.tolist()):
        one = slice(c, c + 1)
        per_cloud.append(ct_scan_block_plain(
            slots.hi[d], slots.lo[d], hi_points[one], hi_mask[one], lo_points[one], lo_mask[one], pose7[one],
            dpose7[one], hi_scale[one], lo_scale[one]))
    return tuple(torch.cat(parts) for parts in zip(*per_cloud))


def ct_scan_block_slots(slots: GridSlots, slot, hi_points, hi_mask, lo_points, lo_mask, pose7, dpose7, hi_scale,
                        lo_scale):
    """Per-cloud scan blocks against each cloud's own submap: (S (C, 18,
    18), g (C, 18), cost (C,)) f32, cloud c against the grids
    slots.hi[slot[c]], slots.lo[slot[c]].

    slots: grid_slots of the D distinct submaps; slot: (C,) int32 in [0,
    D); the clouds, poses and scales as ct_scan_block's. CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    device = hi_points.device
    args = (slots, slot, hi_points, hi_mask, lo_points, lo_mask, pose7, dpose7, hi_scale, lo_scale)
    if device.type == "cpu":
        return ct_scan_block_slots_plain(*args)
    if device.type != "cuda":
        raise ValueError(f"ct_scan_block_slots: unsupported device {device}")
    c, p_hi = hi_mask.shape
    p_lo = lo_mask.shape[1]
    d = len(slots.hi)
    _check("slots.ptrs", slots.ptrs, torch.int64, (d, 4), device)
    _check("slots.gparams", slots.gparams, torch.float32, (d, 8), device)
    _check("slot", slot, torch.int32, (c,), device)
    _check("hi_points", hi_points, torch.float32, (c, p_hi, 3), device)
    _check("hi_mask", hi_mask, torch.bool, (c, p_hi), device)
    _check("lo_points", lo_points, torch.float32, (c, p_lo, 3), device)
    _check("lo_mask", lo_mask, torch.bool, (c, p_lo), device)
    _check("pose7", pose7, torch.float32, (c, 7), device)
    _check("dpose7", dpose7, torch.float32, (c, 7, 18), device)
    _check("hi_scale", hi_scale, torch.float32, (c,), device)
    _check("lo_scale", lo_scale, torch.float32, (c,), device)
    if not 0 < c <= 65535:
        raise ValueError(f"ct_scan_block_slots: unsupported C={c}")
    out = torch.empty(c * (18 * 18 + 18 + 1), dtype=torch.float32, device=device)  # one allocation: S, g, cost
    S = out[: c * 324].view(c, 18, 18)
    g = out[c * 324 : c * 342].view(c, 18)
    cost = out[c * 342 :]
    # slots holds the grids, so their volumes outlive the enqueued launch.
    _build.launch(
        "hg_ct_scan_block_slots", device,
        slots.ptrs.data_ptr(), slot.data_ptr(), slots.gparams.data_ptr(), hi_points.data_ptr(), hi_mask.data_ptr(),
        lo_points.data_ptr(), lo_mask.data_ptr(), pose7.data_ptr(), dpose7.data_ptr(), hi_scale.data_ptr(),
        lo_scale.data_ptr(), S.data_ptr(), g.data_ptr(), cost.data_ptr(),
        c, p_hi, p_lo, *slots.hi[0].shape, *slots.lo[0].shape, slots.mode,
    )
    _count(ct_scan_block_slots, slots.mode)
    return S, g, cost


ct_scan_block_slots.launches = ct_scan_block_slots.prob_launches = 0
ct_scan_block_slots.f16_launches = ct_scan_block_slots.bf16_launches = 0
