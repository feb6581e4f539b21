"""Gauss-Newton 2D scan-match refinement (counterpart of
hectorgrapher_tpu/mapping/scan_matching/gn_2d.py; ref:
internal/2d/scan_matching/ceres_scan_matcher_2d.cc, the occupied-space cost
via bicubic interpolation, occupied_space_cost_function_2d.cc:47-74, or the
TSDF cost, tsdf_match_cost_function_2d.cc, plus translation/rotation delta
penalties).

ONE wide patch row (the 4x4 bicubic neighborhood widened by SLACK cells per
side) is gathered per point at the initial pose, one a plane (two for a
TSDF: tsd and weight); every LM iteration — current and trial cost,
gradient, Jacobian — is evaluated from the carried rows by evaluating the
Catmull-Rom kernel at every lane offset of the wide row. Exact as long as
the refinement moves the base cell by at most SLACK cells per axis. The
Jacobian is written out analytically.

Every solve is batched: poses (B, 2)/(B,), clouds (B, N, 3). On the card
the whole LM loop is one launch of kernel K7 (ops/gn_2d_lm.py); on the CPU
it is its twin, a Python loop of at most num_iterations steps with a
per-lane `done` mask. A converged lane is frozen and returns what its
serial solve returns. The lanes may refine against one prepared field,
against a prepared field each (match_gn_2d_fields_batched) or against the
slots of a raw grid pack (match_gn_2d_packed_grids, the batched constraint
round's refinement), with either cost (_ProbabilityCost, _TsdfCost).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from hectorgrapher_tpu_torch.mapping import probability_values as pv
from hectorgrapher_tpu_torch.mapping.grids import ProbabilityGrid, TSDFGrid, ensure_f32_grid
from hectorgrapher_tpu_torch.mapping.scan_matching.interpolated_grid import (
    PreparedField2D,
    gather_rows_2d,
    prepare_field_2d_wide,
)
from hectorgrapher_tpu_torch.ops.gn_2d_lm import gn_2d_lm
from hectorgrapher_tpu_torch.sensor.types import PointCloud
from hectorgrapher_tpu_torch.transform.rigid import Rigid2, rot2

_GN_SLACK = 3  # carried-row slack cells per side (0.15 m at 5 cm)


def _solve3_sym(a, g):
    """Solve the symmetric 3x3 systems a (..., 3, 3) @ x = g (..., 3) via
    the adjugate (no LU)."""
    a00, a01, a02 = a[..., 0, 0], a[..., 0, 1], a[..., 0, 2]
    a11, a12, a22 = a[..., 1, 1], a[..., 1, 2], a[..., 2, 2]
    c00 = a11 * a22 - a12 * a12
    c01 = a02 * a12 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c11 = a00 * a22 - a02 * a02
    c12 = a01 * a02 - a00 * a12
    c22 = a00 * a11 - a01 * a01
    det = a00 * c00 + a01 * c01 + a02 * c02
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-20, det, 1e-20)
    g0, g1, g2 = g[..., 0], g[..., 1], g[..., 2]
    x0 = (c00 * g0 + c01 * g1 + c02 * g2) * inv_det
    x1 = (c01 * g0 + c11 * g1 + c12 * g2) * inv_det
    x2 = (c02 * g0 + c12 * g1 + c22 * g2) * inv_det
    return torch.stack([x0, x1, x2], dim=-1)


def _catmull(d):
    """Catmull-Rom convolution kernel K(d) and K'(d), supported on |d|<2.
    K at integer-offset lanes equals the cubic weights of the fractional
    part exactly."""
    t = torch.abs(d)
    k_near = ((1.5 * t - 2.5) * t) * t + 1.0
    k_far = ((-0.5 * t + 2.5) * t - 4.0) * t + 2.0
    k = torch.where(t < 1.0, k_near, torch.where(t < 2.0, k_far, 0.0))
    dk_near = (4.5 * t - 5.0) * t
    dk_far = (-1.5 * t + 5.0) * t - 4.0
    dk = torch.sign(d) * torch.where(t < 1.0, dk_near, torch.where(t < 2.0, dk_far, 0.0))
    return k, dk


def _world_of(pose: Rigid2, pts):
    """World xy (B, N, 2) of the points pts (B, N, 2) at the lanes' poses."""
    return rot2(pose.angle[:, None], pts) + pose.translation[:, None, :]


def _lm_start(gather, min_corner, res, pts, initial_pose: Rigid2, slack: int):
    """What the solve starts from, K7 and its twin alike: the cost's wide
    rows, gather(world) at the initial pose (a tuple of planes, (B, N,
    width^2) each), and the base cells (B, N, 2) f32, the cell of each
    row's (0, 0) lane, i0_init - 1 - slack."""
    res_xy = res.reshape(-1, 1, 1) if res.dim() else res  # against (B, N, 2)
    world0 = _world_of(initial_pose, pts)
    rows = gather(world0)  # gathered ONCE
    i0_init = torch.floor((world0 - min_corner) / res_xy - 0.5).to(torch.int32)
    return rows, (i0_init - (1 + slack)).to(torch.float32)


def _lm_rows_plain(
    cost_fn,
    rows,
    base,
    min_corner,
    res,
    pts,
    valid,
    scale,
    initial_pose: Rigid2,
    target_translation,
    translation_weight: float,
    rotation_weight: float,
    num_iterations: int,
    init_lambda: float = 1e-4,
    min_lambda: float = 1e-10,
    max_lambda: float = 1e6,
    function_tolerance: float = 1e-6,
):
    """The LM loop over (tx, ty, theta) per lane from the carried wide rows
    (_lm_start's rows and base), as eager ops: K7's plain twin
    (ops/gn_2d_lm.py). Returns (pose, cost, iterations (B,) int32, the
    iterations each lane ran)."""
    res_pts = res.reshape(-1, 1) if res.dim() else res  # against (B, N)
    res_xy = res.reshape(-1, 1, 1) if res.dim() else res  # against (B, N, 2)
    b, n = valid.shape
    width = math.isqrt(rows[0].shape[-1])
    device = pts.device
    theta0 = initial_pose.angle
    target = target_translation.to(torch.float32)
    tw2 = torch.tensor(translation_weight, dtype=torch.float32, device=device) ** 2
    rw2 = torch.tensor(rotation_weight, dtype=torch.float32, device=device) ** 2
    scale_pts = torch.where(valid, scale[:, None], 0.0)  # d residual / d value, per point
    lanes = torch.arange(width, device=device).to(torch.float32)

    def lane_kernels(pose):
        """Catmull-Rom kernel values and derivatives at the width lanes of
        each axis: kx, dkx, ky, dky (B, N, width)."""
        u = (_world_of(pose, pts) - min_corner) / res_xy - 0.5
        kx, dkx = _catmull((u[..., 0] - base[..., 0])[..., None] - lanes)
        ky, dky = _catmull((u[..., 1] - base[..., 1])[..., None] - lanes)
        return kx, dkx, ky, dky

    def contract(plane, kx, ky):
        """sum over lanes (a, b) of plane * kx[a] * ky[b] -> (B, N)."""
        w = (kx[..., :, None] * ky[..., None, :]).reshape(b, n, width * width)
        return torch.sum(plane * w, dim=-1)

    def terms(pose):
        kx, _, ky, _ = lane_kernels(pose)
        value, dgate = cost_fn.value(contract, rows, kx, ky)
        r_occ = torch.where(valid, value, 0.0) * scale[:, None]
        dt = pose.translation - target
        dth = pose.angle - theta0
        cost = 0.5 * (
            torch.sum(r_occ * r_occ, dim=-1)
            + tw2 * torch.sum(dt * dt, dim=-1)
            + rw2 * dth * dth
        )
        return cost, r_occ, dgate, dt, dth

    def normal_equations(pose, r_occ, dgate, dt, dth):
        kx, dkx, ky, dky = lane_kernels(pose)
        # d value / d frac from the cost's rows, gated per point (a TSDF's
        # weight gate is carried from the pose's terms, as in the JAX loop).
        gate = scale_pts if dgate is None else scale_pts * dgate
        dv_dfx, dv_dfy = cost_fn.grad(contract, rows, kx, dkx, ky, dky)
        dv_dfx = dv_dfx * gate
        dv_dfy = dv_dfy * gate
        # d frac / d pose: u = (R p + t - min)/res - 0.5.
        dp_dth = rot2(pose.angle[:, None] + math.pi / 2.0, pts)  # dR/dtheta @ p
        jocc = torch.stack(
            [dv_dfx / res_pts, dv_dfy / res_pts, (dv_dfx * dp_dth[..., 0] + dv_dfy * dp_dth[..., 1]) / res_pts],
            dim=-1,
        )  # (B, N, 3)
        # Elementwise products and sums: no matmul, so no TF32 on the card.
        jtj = torch.sum(jocc[..., :, None] * jocc[..., None, :], dim=1)
        g = torch.sum(jocc * r_occ[..., None], dim=1)
        jtj = jtj + torch.diag(torch.stack([tw2, tw2, rw2]))
        g = g + torch.cat([tw2 * dt, (rw2 * dth)[:, None]], dim=-1)
        return jtj, g

    eye = torch.eye(3, dtype=torch.float32, device=device)
    pose = initial_pose
    lam = torch.full((b,), init_lambda, dtype=torch.float32, device=device)
    done = torch.zeros((b,), dtype=torch.bool, device=device)
    iterations = torch.zeros((b,), dtype=torch.int32, device=device)
    cost, r_occ, dgate, dt, dth = terms(pose)
    for _ in range(num_iterations):
        if bool(torch.all(done)):
            break
        iterations += (~done).to(torch.int32)
        jtj, g = normal_equations(pose, r_occ, dgate, dt, dth)
        diag = torch.diagonal(jtj, dim1=-2, dim2=-1)
        damped = jtj + lam[:, None, None] * torch.diag_embed(torch.clamp(diag, min=1e-12)) + 1e-12 * eye
        delta = -_solve3_sym(damped, g)
        pose_new = Rigid2(translation=pose.translation + delta[:, :2], angle=pose.angle + delta[:, 2])
        cost_new, r_occ_new, dgate_new, dt_new, dth_new = terms(pose_new)
        accept = (cost_new < cost) & ~done
        lam_next = torch.where(
            accept, torch.clamp(lam * 0.33, min=min_lambda), torch.clamp(lam * 4.0, max=max_lambda)
        )
        x_norm = torch.sqrt(torch.sum(pose.translation**2, dim=-1) + pose.angle**2)
        done_next = (
            done
            | (accept & (cost - cost_new <= function_tolerance * cost))
            | (torch.linalg.vector_norm(delta, dim=-1) <= 1e-7 * (x_norm + 1e-7))
        )
        # A frozen lane keeps its whole state, as under a vmapped while_loop.
        lam = torch.where(done, lam, lam_next)
        pose = Rigid2(
            translation=torch.where(accept[:, None], pose_new.translation, pose.translation),
            angle=torch.where(accept, pose_new.angle, pose.angle),
        )
        cost = torch.where(accept, cost_new, cost)
        r_occ = torch.where(accept[:, None], r_occ_new, r_occ)
        if dgate is not None:
            dgate = torch.where(accept[:, None], dgate_new, dgate)
        dt = torch.where(accept[:, None], dt_new, dt)
        dth = torch.where(accept, dth_new, dth)
        done = done_next
    return pose, cost, iterations


def _lm_grid_2d_plain(
    cost_fn,
    gather,
    min_corner,
    res,
    pts,
    valid,
    scale,
    initial_pose: Rigid2,
    target_translation,
    translation_weight: float,
    rotation_weight: float,
    num_iterations: int,
    slack: int = _GN_SLACK,
    init_lambda: float = 1e-4,
    min_lambda: float = 1e-10,
    max_lambda: float = 1e6,
    function_tolerance: float = 1e-6,
):
    """_lm_grid_2d as eager ops, the CPU path and K7's twin: the rows
    gathered once (_lm_start), then _lm_rows_plain. Returns (pose, cost)."""
    rows, base = _lm_start(gather, min_corner, res, pts, initial_pose, slack)
    pose, cost, _ = _lm_rows_plain(cost_fn, rows, base, min_corner, res, pts, valid, scale, initial_pose,
                                   target_translation, translation_weight, rotation_weight, num_iterations,
                                   init_lambda, min_lambda, max_lambda, function_tolerance)
    return pose, cost


def _lm_grid_2d(
    cost_fn,
    gather,
    min_corner,
    res,
    pts,
    valid,
    scale,
    initial_pose: Rigid2,
    target_translation,
    translation_weight: float,
    rotation_weight: float,
    num_iterations: int,
    slack: int = _GN_SLACK,
    init_lambda: float = 1e-4,
    min_lambda: float = 1e-10,
    max_lambda: float = 1e6,
    function_tolerance: float = 1e-6,
):
    """Wide-carried-rows LM over (tx, ty, theta) per lane, against the
    per-point residual of cost_fn (_ProbabilityCost or _TsdfCost, gn_2d.py
    :82 _lm_grid_2d(cost, gather, ...) of the JAX package).

    gather(world (B, N, 2)) -> a tuple of the cost's planes' wide rows,
    (B, N, width^2) each, called once, at the initial pose; min_corner: the
    grid corner, (2,) or per lane (B, 1, 2); res: the resolution, a scalar
    tensor or per lane (B,). pts (B, N,
    2), valid (B, N) bool, scale (B,), initial_pose (B, 2)/(B,),
    target_translation (B, 2). Termination mirrors Ceres: at most
    num_iterations, a lane stopping once an accepted step decreases its
    cost by less than function_tolerance * cost. CUDA tensors gather, then
    run the whole solve as one launch of kernel K7 (ops/gn_2d_lm.py), with
    no host sync; CPU tensors run its twin, _lm_grid_2d_plain. Returns
    (pose, cost)."""
    device = pts.device
    if device.type == "cpu":
        return _lm_grid_2d_plain(cost_fn, gather, min_corner, res, pts, valid, scale, initial_pose,
                                 target_translation, translation_weight, rotation_weight, num_iterations, slack,
                                 init_lambda, min_lambda, max_lambda, function_tolerance)
    if device.type != "cuda":
        raise ValueError(f"_lm_grid_2d: unsupported device {device}")
    rows, base = _lm_start(gather, min_corner, res, pts, initial_pose, slack)
    if _COST_OF_PLANES.get(len(rows)) is not cost_fn:
        raise ValueError(f"_lm_grid_2d: {len(rows)} planes of rows for {cost_fn.__name__}")
    b = valid.shape[0]
    f32 = torch.float32
    pose0 = torch.cat([initial_pose.translation.to(f32), initial_pose.angle.to(f32)[:, None]], dim=-1)
    pose, cost, _ = gn_2d_lm(
        tuple(r.contiguous() for r in rows), base, min_corner.to(f32).reshape(-1, 2).expand(b, 2).contiguous(),
        res.to(f32).reshape(-1).expand(b).contiguous(), pts.contiguous(), valid.contiguous(),
        scale.to(f32).contiguous(), pose0, target_translation.to(f32).contiguous(), translation_weight,
        rotation_weight, num_iterations, init_lambda, min_lambda, max_lambda, function_tolerance)
    return Rigid2(translation=pose[:, :2], angle=pose[:, 2]), cost


class _ProbabilityCost:
    """Occupied-space residual 1 - P(T p) (gn_2d.py :222-234; ref:
    occupied_space_cost_function_2d.cc:47-74): rows, one plane of
    probabilities; no gate."""

    @staticmethod
    def value(contract, rows, kx, ky):
        (prob,) = rows
        return 1.0 - contract(prob, kx, ky), None

    @staticmethod
    def grad(contract, rows, kx, dkx, ky, dky):
        # d(1 - sum rows*w)/dfrac = -sum rows*dw.
        (prob,) = rows
        return -contract(prob, dkx, ky), -contract(prob, kx, dky)


class _TsdfCost:
    """Weight-gated TSD residual tsd * [w > 1e-6] (gn_2d.py :237-252; ref:
    tsdf_match_cost_function_2d.cc:30,74: cells never observed carry no
    signal): rows (tsd plane, weight plane); the derivative comes from the
    tsd rows only, times the gate."""

    @staticmethod
    def value(contract, rows, kx, ky):
        tsd_rows, w_rows = rows
        gate = (contract(w_rows, kx, ky) > 1e-6).to(torch.float32)
        return contract(tsd_rows, kx, ky) * gate, gate

    @staticmethod
    def grad(contract, rows, kx, dkx, ky, dky):
        tsd_rows, _ = rows
        return contract(tsd_rows, dkx, ky), contract(tsd_rows, kx, dky)


# The cost a solve's rows serve, by their number of planes (K7 observes it
# from its input).
_COST_OF_PLANES = {1: _ProbabilityCost, 2: _TsdfCost}


def prepare_gn_probability_field(grid: ProbabilityGrid) -> PreparedField2D:
    """Wide carried-row field for repeated refinement against one grid
    version (gn_2d.py :272); a uint16 grid (a just-finished submap) is
    decoded first."""
    grid = ensure_f32_grid(grid)
    return prepare_field_2d_wide(grid.probability(), grid.meta, pv.MIN_PROBABILITY, _GN_SLACK)


def prepare_gn_tsdf_fields(grid: TSDFGrid) -> Tuple[PreparedField2D, PreparedField2D]:
    """Wide carried-row (tsd, weight) fields for repeated refinement
    against one 2D TSDF version (gn_2d.py :348): the tsd padded with the
    truncation distance, the weight with 0; a uint16 grid is decoded first,
    half planes are read as f32."""
    grid = ensure_f32_grid(grid)
    return (prepare_field_2d_wide(grid.tsd, grid.meta, grid.truncation_distance, _GN_SLACK),
            prepare_field_2d_wide(grid.weight, grid.meta, 0.0, _GN_SLACK))


def _occupied_scale(valid, occupied_space_weight):
    """w_o / sqrt(N) per lane, N the lane's valid points (at least 1)."""
    n = torch.clamp(torch.sum(valid, dim=-1), min=1)
    return occupied_space_weight / torch.sqrt(n.to(torch.float32))


def _match_fields(cost_fn, planes, clouds: PointCloud, initial_poses: Rigid2, target_translations,
                  occupied_space_weight: float, translation_weight: float, rotation_weight: float,
                  num_iterations: int):
    """B matches against one grid's prepared fields, one a plane of the
    cost (a tuple)."""
    meta = planes[0].meta
    return _lm_grid_2d(
        cost_fn, lambda world: tuple(gather_rows_2d(f, world) for f in planes),
        meta.min_corner, meta.resolution,
        clouds.positions[..., :2].to(torch.float32), clouds.mask,
        _occupied_scale(clouds.mask, occupied_space_weight), initial_poses, target_translations,
        translation_weight, rotation_weight, num_iterations,
    )


def _as_batch(cloud: PointCloud, initial_pose: Rigid2, target_translation):
    """One match as a batch of one: (clouds, initial poses, targets)."""
    return (PointCloud(positions=cloud.positions[None], mask=cloud.mask[None]),
            Rigid2(translation=initial_pose.translation[None], angle=initial_pose.angle.reshape(1)),
            target_translation.reshape(1, 2))


def _first(poses: Rigid2, costs):
    """Lane 0 of a batched refinement's result: (pose, cost)."""
    return Rigid2(translation=poses.translation[0], angle=poses.angle[0]), costs[0]


def match_gn_2d_probability_batched(
    grid: ProbabilityGrid,
    clouds: PointCloud,
    initial_poses: Rigid2,
    target_translations,
    occupied_space_weight: float,
    translation_weight: float,
    rotation_weight: float,
    num_iterations: int = 20,
    prepared_field: PreparedField2D | None = None,
):
    """Batched CeresScanMatcher2D refinement over B independent matches.

    Residuals (ref: ceres_scan_matcher_2d.cc:84-120):
      * occupied space: w_o/sqrt(N) * (1 - P(T p_i)) per point
      * translation: w_t * (t - target_translation)
      * rotation: w_r * (theta - theta0)
    Returns (poses (B,), costs (B,))."""
    if prepared_field is None:
        prepared_field = prepare_gn_probability_field(grid)
    return _match_fields(_ProbabilityCost, (prepared_field,), clouds, initial_poses, target_translations,
                         occupied_space_weight, translation_weight, rotation_weight, num_iterations)


def match_gn_2d_probability(
    grid: ProbabilityGrid,
    cloud: PointCloud,
    initial_pose: Rigid2,
    target_translation,
    occupied_space_weight: float,
    translation_weight: float,
    rotation_weight: float,
    num_iterations: int = 20,
    prepared_field: PreparedField2D | None = None,
) -> Tuple[Rigid2, torch.Tensor]:
    """Refine one pose against an occupancy grid (or its prepared_field):
    the B=1 call of match_gn_2d_probability_batched. Returns (pose, cost)."""
    return _first(*match_gn_2d_probability_batched(
        grid, *_as_batch(cloud, initial_pose, target_translation), occupied_space_weight, translation_weight,
        rotation_weight, num_iterations=num_iterations, prepared_field=prepared_field))


def match_gn_2d_tsdf(
    grid: TSDFGrid,
    cloud: PointCloud,
    initial_pose: Rigid2,
    target_translation,
    occupied_space_weight: float,
    translation_weight: float,
    rotation_weight: float,
    num_iterations: int = 20,
    prepared_fields: Tuple[PreparedField2D, PreparedField2D] | None = None,
) -> Tuple[Rigid2, torch.Tensor]:
    """Refine one pose against a 2D TSDF (gn_2d.py :360, the fields' solve
    :380; ref: tsdf_match_cost_function_2d.cc): the per-point residual
    w_o/sqrt(N) * tsd(T p_i) where the interpolated weight is above 1e-6,
    0 elsewhere, and the penalties of match_gn_2d_probability_batched.
    prepared_fields: prepare_gn_tsdf_fields(grid), to reuse them across
    calls. Returns (pose, cost)."""
    if prepared_fields is None:
        prepared_fields = prepare_gn_tsdf_fields(grid)
    return _first(*_match_fields(_TsdfCost, prepared_fields, *_as_batch(cloud, initial_pose, target_translation),
                                 occupied_space_weight, translation_weight, rotation_weight, num_iterations))


def match_gn_2d_fields_batched(
    stacked_fields,
    clouds: PointCloud,
    initial_poses: Rigid2,
    target_translations,
    occupied_space_weight: float,
    translation_weight: float,
    rotation_weight: float,
    is_tsdf: bool,
    num_iterations: int = 20,
):
    """Batched refinement where lane b refines against its own prepared
    field (gn_2d.py :449): stacked_fields holds the lanes' fields stacked,
    patches (B, nx*ny + 1, w*w), meta.min_corner (B, 2) and meta.resolution
    (B,), one dims for all; with is_tsdf a (tsd, weight) pair of such
    stacks (prepare_gn_tsdf_fields' pairs stacked plane by plane). Each
    lane returns its serial solve's result. Returns (poses (B,), costs
    (B,))."""
    planes = stacked_fields if is_tsdf else (stacked_fields,)
    meta, (nx, ny) = planes[0].meta, planes[0].dims
    mc, res = meta.min_corner[:, None, :], meta.resolution.reshape(-1)
    lanes = torch.arange(mc.shape[0], device=mc.device)[:, None]

    def gather(world):
        # gather_rows_2d, each lane in its own field.
        i0 = torch.floor((world - mc) / res[:, None, None] - 0.5).to(torch.int64)
        ok = (i0[..., 0] >= 0) & (i0[..., 0] < nx) & (i0[..., 1] >= 0) & (i0[..., 1] < ny)
        flat = torch.where(ok, i0[..., 0] * ny + i0[..., 1], nx * ny)
        return tuple(f.patches[lanes, flat] for f in planes)

    return _lm_grid_2d(
        _TsdfCost if is_tsdf else _ProbabilityCost, gather, mc, res,
        clouds.positions[..., :2].to(torch.float32), clouds.mask,
        _occupied_scale(clouds.mask, occupied_space_weight), initial_poses, target_translations,
        translation_weight, rotation_weight, num_iterations,
    )


def _wide_cells(min_corner, resolution, world, slack: int = _GN_SLACK):
    """The (x, y) cells (..., N, w*w) of each point's wide patch, lane dx * w
    + dy: the base cell floor((world - min) / res - 0.5) - (1 + slack) plus
    the lane's offsets."""
    w = 4 + 2 * slack
    u = (world - min_corner) / resolution - 0.5
    i0 = torch.floor(u).to(torch.int64) - (1 + slack)  # (..., N, 2) patch corner
    lane = torch.arange(w * w, device=world.device)
    return i0[..., 0:1] + lane // w, i0[..., 1:2] + lane % w


def _gather_wide_from_values(values, min_corner, resolution, world, pad_value, slack: int = _GN_SLACK):
    """Wide (..., N, (4+2*slack)^2) rows gathered directly from a raw (nx,
    ny) grid (gn_2d.py :480): the rows prepare_field_2d_wide tabulates for
    a base cell inside the grid, cell by cell, out-of-grid cells read
    pad_value."""
    nx, ny = values.shape
    return _gather_wide_from_flat(values.reshape(-1), 0, nx, ny, min_corner, resolution, world, pad_value, slack)


def _gather_wide_from_flat(flat_values, base, nx: int, ny: int, min_corner, resolution, world, pad_value,
                           slack: int = _GN_SLACK):
    """_gather_wide_from_values with each lane's grid at a row offset base
    (B, 1, 1) into one flat table of stacked grids (gn_2d.py :504)."""
    ix, iy = _wide_cells(min_corner, resolution, world, slack)
    ok = (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
    rows = flat_values[torch.where(ok, base + ix * ny + iy, 0)]
    return torch.where(ok, rows.to(torch.float32), pad_value)


def match_gn_2d_packed_grids(
    values_stack,
    weight_stack,
    min_corners,
    resolution,
    pad_value,
    slots,
    clouds: PointCloud,
    initial_poses: Rigid2,
    target_translations,
    occupied_space_weight: float,
    translation_weight: float,
    rotation_weight: float,
    is_tsdf: bool,
    num_iterations: int = 20,
):
    """Batched refinement against a raw grid pack on the device (gn_2d.py
    :523-590), the batched constraint round's refinement: lane c refines
    against slot slots[c] of values_stack (S, nx, ny), its corner
    min_corners[slots[c]] (S, 2), gathering its wide rows from the grid
    cell by cell once. values_stack holds probabilities (pad_value
    MIN_PROBABILITY), or with is_tsdf the tsd planes (pad_value the
    truncation distance) beside the weight planes of weight_stack (padded
    with 0); resolution and pad_value are shared scalars. Returns (poses
    (C,), costs (C,))."""
    s, nx, ny = values_stack.shape
    res = torch.as_tensor(resolution, dtype=torch.float32, device=values_stack.device)
    mc = min_corners[slots.long()][:, None, :]  # (C, 1, 2)
    base = (slots.long() * (nx * ny))[:, None, None]
    planes = ((values_stack, pad_value), (weight_stack, 0.0))[:2 if is_tsdf else 1]
    return _lm_grid_2d(
        _TsdfCost if is_tsdf else _ProbabilityCost,
        lambda world: tuple(_gather_wide_from_flat(v.reshape(-1), base, nx, ny, mc, res, world, pad)
                            for v, pad in planes),
        mc, res, clouds.positions[..., :2].to(torch.float32), clouds.mask,
        _occupied_scale(clouds.mask, occupied_space_weight), initial_poses, target_translations,
        translation_weight, rotation_weight, num_iterations,
    )
