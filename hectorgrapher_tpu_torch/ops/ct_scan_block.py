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

ct_scan_block_points is the kernel's per-point mode, the per-point
unwarping family of window_solver.py (point_scan_block, :366-462): every
point is a scalar block on its own control-point pair at its own time,
with its own pose computed in the kernel from the pair's terms
(pair_terms, once a pair) and its factor (point_poses_from_terms), and
the blocks are summed per pair into K - 1 pair blocks. point_plan sorts
the points by pair once per solve; the kernel cuts each pair's segment
into tiles of POINT_TILE points and adds their sums per pair in tile
order, so two launches give the same bits. ct_scan_block_points_slots
assembles B windows at once, window b against the grids of slot[b], each
window's pair blocks bit for bit those of a launch for it alone. A plan's
counters serve one launch at a time: launch a plan on one stream.
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


def _block_outputs(n: int, device):
    """(S (n, 18, 18), g (n, 18), cost (n,)) f32 for n blocks, in one
    allocation."""
    out = torch.empty(n * (18 * 18 + 18 + 1), dtype=torch.float32, device=device)
    return out[: n * 324].view(n, 18, 18), out[n * 324 : n * 342].view(n, 18), out[n * 342 :]


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
    S, g, cost = _block_outputs(c, device)
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
    S, g, cost = _block_outputs(c, device)
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


# ---------------------------------------------------------------------------
# Per-point mode
# ---------------------------------------------------------------------------


# Points a kernel block holds (kPtThreads of csrc/ct_scan_block.cu, which
# refuses a launch whose scratch this does not size).
POINT_TILE = 128


class PointPlan(NamedTuple):
    """The points of B windows' per-point families as the kernel reads
    them, sorted by segment (window b's control-point pair p is segment b *
    (k - 1) + p; points whose scale is 0, masked points and the points of
    masked clouds, go last, past every segment): points (M, 3) f32,
    factor, scale (M,) f32, lo (M,) bool (the point reads the lo-res grid),
    pair (M,) int64 (its segment), starts (B * (k - 1) + 1,) int32 (segment
    j is points starts[j] .. starts[j + 1]), k, the control points a
    window, and counters (B * (k - 1),) int32, the kernel's per-segment
    tickets (zero between launches)."""

    points: torch.Tensor
    factor: torch.Tensor
    scale: torch.Tensor
    lo: torch.Tensor
    pair: torch.Tensor
    starts: torch.Tensor
    k: int
    counters: torch.Tensor

    @property
    def segments(self) -> int:
        return self.starts.shape[0] - 1


def _counters(segments: int, device):
    """A plan's zero tickets: one copy to the device, no kernel."""
    return torch.zeros(segments, dtype=torch.int32).to(device)


def point_plan(hi_points, hi_pair, hi_factor, hi_scale, lo_points, lo_pair, lo_factor, lo_scale, k: int) -> PointPlan:
    """PointPlan of B windows: hi_points (B, Nh, 3), hi_pair (B, Nh) the
    first control point of each point's pair, hi_factor and hi_scale (B,
    Nh) (0 where the point is masked out), likewise lo; a window's hi
    points come before its lo points, each set in its given order, within
    a segment. Built once per solve: the brackets do not move with the
    state."""
    b = hi_points.shape[0]
    segments = b * (k - 1)
    window = torch.arange(b, device=hi_points.device)[:, None] * (k - 1)
    points = torch.cat([hi_points, lo_points], dim=1).reshape(-1, 3)
    factor = torch.cat([hi_factor, lo_factor], dim=1).reshape(-1)
    scale = torch.cat([hi_scale, lo_scale], dim=1).reshape(-1)
    lo = torch.cat([torch.zeros_like(hi_pair, dtype=torch.bool), torch.ones_like(lo_pair, dtype=torch.bool)],
                   dim=1).reshape(-1)
    pair = torch.cat([hi_pair, lo_pair], dim=1).long() + window
    pair = torch.where(scale.reshape(pair.shape) != 0, pair, segments).reshape(-1)
    pair, order = torch.sort(pair, stable=True)
    starts = torch.searchsorted(pair, torch.arange(segments + 1, device=pair.device)).to(torch.int32)
    return PointPlan(points[order].contiguous(), factor[order].contiguous(), scale[order].contiguous(),
                     lo[order].contiguous(), pair, starts, k, _counters(segments, starts.device))


def _dot4(a, b):
    """a . b over the last axis, summed left to right (the kernel's dot4)."""
    return ((a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]) + a[..., 3] * b[..., 3]


def _f64(fn, x):
    """fn evaluated in f64, rounded once to f32 (the kernel's acos64 etc.)."""
    return fn(x.to(torch.float64)).to(torch.float32)


def _half_products(q):
    """(N, 3, 4): q * [0, e_k / 2] for k = 0, 1, 2."""
    h = 0.5 * q
    w, x, y, z = h.unbind(-1)
    return torch.stack([torch.stack([-x, w, z, -y], -1), torch.stack([-y, -z, w, x], -1),
                        torch.stack([-z, y, -x, w], -1)], dim=1)


class PairTerms(NamedTuple):
    """What the poses of a control-point pair's points take from the pair
    alone (n pairs): t0, dt (n, 3) the first translation and the
    difference of the two; a, b (n, 4) the rotations, b flipped onto a's
    hemisphere; ta, tb (n, 3, 4) their half products (tb flipped with b);
    theta, denom (n,); lerp (n,) bool, sin(theta) < 1e-6; dth, ds (n, 6)
    the tangents of theta and sin(theta)."""

    t0: torch.Tensor
    dt: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    ta: torch.Tensor
    tb: torch.Tensor
    theta: torch.Tensor
    denom: torch.Tensor
    lerp: torch.Tensor
    dth: torch.Tensor
    ds: torch.Tensor


def pair_terms(ca, cb) -> PairTerms:
    """PairTerms of the pairs (ca, cb), (n, 7) control points [t, q] each,
    in the kernel's op order (csrc/ct_scan_block.cu pair_terms)."""
    a, b = ca[:, 3:], cb[:, 3:]
    ta, tb = _half_products(a), _half_products(b)
    dot = _dot4(a, b)
    tdot = torch.cat([_dot4(b[:, None, :], ta), _dot4(a[:, None, :], tb)], dim=1)  # (n, 6)
    neg = dot < 0
    b = torch.where(neg[:, None], -b, b)
    tb = torch.where(neg[:, None, None], -tb, tb)
    tdot = torch.where(neg[:, None], -tdot, tdot)
    c = torch.clamp(torch.abs(dot), max=1.0)
    theta = _f64(torch.arccos, c)
    s = _f64(torch.sin, theta)
    lerp = s < 1e-6
    denom = torch.where(lerp, 1.0, s)
    ct = _f64(torch.cos, theta)
    root = torch.where(lerp, 1.0, torch.sqrt(1.0 - c * c))
    dth = torch.where(lerp[:, None], 0.0, -tdot / root[:, None])  # (n, 6)
    return PairTerms(ca[:, :3], cb[:, :3] - ca[:, :3], a, b, ta, tb, theta, denom, lerp, dth, ct[:, None] * dth)


def _normalize_with_tangent(x, tx):
    """x / |x| (N, 4) and its tangent columns tx (N, 6, 4)."""
    n = torch.sqrt(_dot4(x, x))[:, None]
    y = x / n
    return y, (tx - y[:, None, :] * _dot4(y[:, None, :], tx)[..., None]) / n[:, None]


def point_poses_from_terms(P: PairTerms, f):
    """Per-point poses of the per-point family (window_solver.py
    point_scan_block, :388-402) of N points at factors f (N,) on the pairs
    P (N pairs: each point's own, gathered; pair_terms(ca, cb) of its two
    control points [t, q]). Returns (t (N, 3), q (N, 4), dq (N, 6, 4)): the
    lerp of the translations; the slerp of the rotations retracted at a
    zero tangent (not normalized), normalized twice; and q's Jacobian on
    the pair tangent's six rotation columns. Every op of the pose in the
    kernel's order (csrc/ct_scan_block.cu point_pose), acos, sin and cos in
    f64 rounded to f32, so on the card both compute the same pose; dq
    divides where the kernel multiplies by reciprocals."""
    t = P.t0 + f[:, None] * P.dt
    g = 1.0 - f
    ua, ub = g * P.theta, f * P.theta
    sa, sb = _f64(torch.sin, ua), _f64(torch.sin, ub)
    wa = torch.where(P.lerp, g, sa / P.denom)
    wb = torch.where(P.lerp, f, sb / P.denom)
    x = wa[:, None] * P.a + wb[:, None] * P.b
    cua, cub = _f64(torch.cos, ua), _f64(torch.cos, ub)
    denom, denom2, lerp = P.denom[:, None], (P.denom * P.denom)[:, None], P.lerp[:, None]
    dwa = torch.where(lerp, 0.0, (cua[:, None] * (g[:, None] * P.dth)) / denom - (sa[:, None] * P.ds) / denom2)
    dwb = torch.where(lerp, 0.0, (cub[:, None] * (f[:, None] * P.dth)) / denom - (sb[:, None] * P.ds) / denom2)
    own = torch.cat([wa[:, None, None] * P.ta, wb[:, None, None] * P.tb], dim=1)
    tx = (dwa[..., None] * P.a[:, None, :] + dwb[..., None] * P.b[:, None, :]) + own
    q, tq = _normalize_with_tangent(*_normalize_with_tangent(x, tx))
    return t, q, tq


def segment_terms(plan: PointPlan, cp7) -> PairTerms:
    """PairTerms of each of the plan's segments (window b's pair p is
    control points b * k + p and b * k + p + 1 of cp7)."""
    k1 = plan.k - 1
    first = torch.arange(plan.segments, device=cp7.device)
    first = first % k1 + (first // k1) * plan.k
    return pair_terms(cp7[first], cp7[first + 1])


def plan_poses(plan: PointPlan, cp7, m: int):
    """point_poses_from_terms of the plan's first m points (those of some
    segment), the pair terms computed once a segment and gathered."""
    pair = plan.pair[:m]
    return point_poses_from_terms(PairTerms(*(x[pair] for x in segment_terms(plan, cp7))), plan.factor[:m])


def _point_rows(grid, points, q, t, dq, f, s):
    """Residuals (n,) and 18-wide rows (n, 18) of points against one grid."""
    world = quat_rotate(q, points) + t
    val, dval_dfrac = value_and_dfrac_3d(grid, world)
    dvw = dval_dfrac / grid.meta.resolution
    dval_dq = torch.einsum("ni,nij->nj", dvw, dquat_rotate_dq(q, points))
    jrot = torch.einsum("nq,nkq->nk", dval_dq, dq)
    z = torch.zeros_like(dvw)
    g = (1.0 - f)[:, None]
    rows = torch.cat([(g * dvw) * s[:, None], jrot[:, :3] * s[:, None], z,
                      (f[:, None] * dvw) * s[:, None], jrot[:, 3:] * s[:, None], z], dim=1)
    return val * s, rows


def ct_scan_block_points_plain(hi_grid, lo_grid, plan: PointPlan, cp7):
    """Plain PyTorch version of one window (plan.segments == k - 1):
    (S (k-1, 18, 18), g (k-1, 18), cost (k-1,)), the pair blocks summed as
    the JAX package sums them (a one-hot per pair, point_scan_block
    :432-453)."""
    k1 = plan.k - 1
    m = int(plan.starts[-1])  # the points of some segment; the dropped ones follow
    pair, f, s = plan.pair[:m], plan.factor[:m], plan.scale[:m]
    t, q, dq = plan_poses(plan, cp7, m)
    r = torch.empty(m, dtype=torch.float32, device=f.device)
    J = torch.empty((m, 18), dtype=torch.float32, device=f.device)
    for grid, sel in ((hi_grid, ~plan.lo[:m]), (lo_grid, plan.lo[:m])):
        r[sel], J[sel] = _point_rows(grid, plan.points[:m][sel], q[sel], t[sel], dq[sel], f[sel], s[sel])
    onehot = (pair[None, :] == torch.arange(k1, device=pair.device)[:, None]).to(torch.float32)  # (k1, m)
    Jk = onehot[:, :, None] * J[None, :, :]
    S = torch.einsum("kni,nj->kij", Jk, J)
    g = torch.einsum("kni,n->ki", Jk, r)
    return S, g, 0.5 * (onehot @ (r * r))


def _check_plan(plan: PointPlan, cp7, windows: int, device, where: str):
    m = plan.points.shape[0]
    if plan.segments != windows * (plan.k - 1) or not 0 < plan.segments or plan.k < 2:
        raise ValueError(f"{where}: {plan.segments} segments for {windows} windows of k={plan.k}")
    _check("cp7", cp7, torch.float32, (windows * plan.k, 7), device)
    _check("plan.points", plan.points, torch.float32, (m, 3), device)
    _check("plan.factor", plan.factor, torch.float32, (m,), device)
    _check("plan.scale", plan.scale, torch.float32, (m,), device)
    _check("plan.lo", plan.lo, torch.bool, (m,), device)
    _check("plan.starts", plan.starts, torch.int32, (plan.segments + 1,), device)
    _check("plan.counters", plan.counters, torch.int32, (plan.segments,), device)
    if _blocks(plan) >= 2**31:
        raise ValueError(f"{where}: unsupported {m} points in {plan.segments} segments")


def _blocks(plan: PointPlan) -> int:
    """The kernel's blocks for the plan: room for every tile (a segment cut
    into tiles of POINT_TILE points, an empty one a tile); the kernel's
    spare blocks exit."""
    return plan.segments + plan.points.shape[0] // POINT_TILE


def _tile_scratch(plan: PointPlan):
    """Each block's R^T R sums (_blocks, 190) f64, for one launch: the
    caching allocator's memory, no kernel."""
    return torch.empty((_blocks(plan), 190), dtype=torch.float64, device=plan.points.device)


def ct_scan_block_points(hi_grid, lo_grid, plan: PointPlan, cp7, gparams=None):
    """Per-point pair blocks of one window: (S (k-1, 18, 18), g (k-1, 18),
    cost (k-1,)) f32.

    hi_grid, lo_grid as ct_scan_block's; plan: point_plan of this one
    window; cp7 (k, 7) f32 its control points [t, q wxyz]; gparams:
    grid_params(hi_grid, lo_grid), built here when not given. CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
    device = plan.points.device
    if device.type == "cpu":
        return ct_scan_block_points_plain(hi_grid, lo_grid, plan, cp7)
    if device.type != "cuda":
        raise ValueError(f"ct_scan_block_points: unsupported device {device}")
    mode = kernel_mode(hi_grid, lo_grid, "ct_scan_block_points")
    hi_ptrs = _volumes("hi_grid", hi_grid, device, "ct_scan_block_points")
    lo_ptrs = _volumes("lo_grid", lo_grid, device, "ct_scan_block_points")
    _check_plan(plan, cp7, 1, device, "ct_scan_block_points")
    if gparams is None:
        gparams = grid_params(hi_grid, lo_grid)
    _check("gparams", gparams, torch.float32, (8,), device)
    S, g, cost = _block_outputs(plan.segments, device)
    scratch = _tile_scratch(plan)
    _build.launch(
        "hg_ct_scan_block_points", device, *hi_ptrs, *lo_ptrs, gparams.data_ptr(), cp7.data_ptr(),
        plan.points.data_ptr(), plan.factor.data_ptr(), plan.scale.data_ptr(), plan.lo.data_ptr(),
        plan.starts.data_ptr(), plan.counters.data_ptr(), scratch.data_ptr(), S.data_ptr(), g.data_ptr(),
        cost.data_ptr(), plan.segments, plan.points.shape[0], scratch.shape[0], plan.k, *hi_grid.shape,
        *lo_grid.shape, mode,
    )
    _count(ct_scan_block_points, mode)
    return S, g, cost


ct_scan_block_points.launches = ct_scan_block_points.prob_launches = 0
ct_scan_block_points.f16_launches = ct_scan_block_points.bf16_launches = 0


def window_plan(plan: PointPlan, b: int) -> PointPlan:
    """Window b's part of a plan of several windows, as a plan of its own
    (its segments renumbered from 0)."""
    k1 = plan.k - 1
    lo_pt, hi_pt = int(plan.starts[b * k1]), int(plan.starts[(b + 1) * k1])
    starts = plan.starts[b * k1 : (b + 1) * k1 + 1] - lo_pt
    one = slice(lo_pt, hi_pt)
    return PointPlan(plan.points[one], plan.factor[one], plan.scale[one], plan.lo[one], plan.pair[one] - b * k1,
                     starts, plan.k, _counters(k1, starts.device))


def ct_scan_block_points_slots_plain(slots: GridSlots, slot, plan: PointPlan, cp7):
    """Plain PyTorch version: ct_scan_block_points_plain of each window
    alone against its slot's grids."""
    k = plan.k
    per_window = [ct_scan_block_points_plain(slots.hi[d], slots.lo[d], window_plan(plan, b), cp7[b * k:(b + 1) * k])
                  for b, d in enumerate(slot.tolist())]
    return tuple(torch.cat(parts) for parts in zip(*per_window))


def ct_scan_block_points_slots(slots: GridSlots, slot, plan: PointPlan, cp7):
    """Per-point pair blocks of B windows, window b against the grids
    slots.hi[slot[b]], slots.lo[slot[b]]: (S (B*(k-1), 18, 18), g, cost).

    slot: (B,) int32; plan: point_plan of the B windows; cp7 (B*k, 7).
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    device = plan.points.device
    if device.type == "cpu":
        return ct_scan_block_points_slots_plain(slots, slot, plan, cp7)
    if device.type != "cuda":
        raise ValueError(f"ct_scan_block_points_slots: unsupported device {device}")
    b = slot.shape[0]
    d = len(slots.hi)
    _check("slots.ptrs", slots.ptrs, torch.int64, (d, 4), device)
    _check("slots.gparams", slots.gparams, torch.float32, (d, 8), device)
    _check("slot", slot, torch.int32, (b,), device)
    _check_plan(plan, cp7, b, device, "ct_scan_block_points_slots")
    S, g, cost = _block_outputs(plan.segments, device)
    scratch = _tile_scratch(plan)
    _build.launch(
        "hg_ct_scan_block_points_slots", device, slots.ptrs.data_ptr(), slot.data_ptr(), slots.gparams.data_ptr(),
        cp7.data_ptr(), plan.points.data_ptr(), plan.factor.data_ptr(), plan.scale.data_ptr(), plan.lo.data_ptr(),
        plan.starts.data_ptr(), plan.counters.data_ptr(), scratch.data_ptr(), S.data_ptr(), g.data_ptr(),
        cost.data_ptr(), plan.segments, plan.points.shape[0], scratch.shape[0], plan.k, *slots.hi[0].shape,
        *slots.lo[0].shape, slots.mode,
    )
    _count(ct_scan_block_points_slots, slots.mode)
    return S, g, cost


ct_scan_block_points_slots.launches = ct_scan_block_points_slots.prob_launches = 0
ct_scan_block_points_slots.f16_launches = ct_scan_block_points_slots.bf16_launches = 0
