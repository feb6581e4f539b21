"""A continuous-time sliding window, from raw sensor data to its solve.

The semantics of HectorGrapher's CT window (optimizing_local_trajectory_
builder.cc MaybeOptimize and the cost functors under internal/3d/
scan_matching/), written out plainly:

  * control points (t, q, v) at given times; a cloud's pose is the lerp of
    its two bracketing control points' translations and the slerp of
    their rotations, at the cloud's time;
  * scan residuals: each point, posed into the submap, reads the
    trilinear blend of the occupancy probability over the 2x2x2 cells
    around it (cell centres at min_corner + (i + 1/2) res), every cell
    inside the grid; a point whose cells leave the grid reads 0.1, the
    unknown probability; the residual is w / sqrt(n) * (1 - p), n the
    cloud's points, w the grid's weight;
  * IMU residuals per control-point pair (the live preintegration form):
    t1 - t0 - dt v0, v1 - v0, and the vector part of q1^-1 q0 dq, dq the
    gyro's RK4 rotation over the pair;
  * odometry residuals per pair where odometry covers both ends: the
    relative pose of the pair against the odometry's, translation and
    roll / pitch / yaw, with adaptive weights w / sqrt(|d| + c dt);
  * cost = 1/2 sum r^2; Levenberg-Marquardt on the tangent (dt, dtheta,
    dv) per control point, the first and the unused ones fixed.

Everything is computed in `dtype`: float64 for the reference, bfloat16
for the control (the linear solve in float32: no bfloat16 solver exists).
"""

from __future__ import annotations

import bisect
import math
from dataclasses import dataclass

import numpy as np
import torch

MIN_PROBABILITY = 0.1
MAX_PROBABILITY = 0.9


# -- quaternions (wxyz) -------------------------------------------------------


def qmul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz, aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx, aw * bz + ax * by - ay * bx + az * bw], dim=-1)


def qconj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def qrot(q, v):
    """R(q) v: the vector part of q [0, v] q^-1."""
    pv = torch.cat([torch.zeros_like(v[..., :1]), v], dim=-1)
    return qmul(qmul(q, pv), qconj(q))[..., 1:]


def qnormalize(q):
    return q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))


def qexp(w):
    """exp of an angle-axis vector (..., 3), exact; its first order near 0."""
    a2 = torch.sum(w * w, dim=-1, keepdim=True)
    a = torch.sqrt(torch.clamp(a2, min=1e-30))
    small = a2 < 1e-12
    s = torch.where(small, 0.5 - a2 / 48.0, torch.sin(0.5 * a) / a)
    c = torch.where(small, 1.0 - a2 / 8.0, torch.cos(0.5 * a))
    return torch.cat([c, s * w], dim=-1)


def qslerp(a, b, f):
    """Slerp from a to b at f (...,), the short way; below sin(theta) =
    1e-6 the linear blend; normalized."""
    f = f[..., None]
    dot = torch.sum(a * b, dim=-1, keepdim=True)
    b = torch.where(dot < 0, -b, b)
    c = torch.clamp(torch.abs(dot), 0.0, 1.0)
    theta = torch.arccos(c)
    s = torch.sin(theta)
    lin = s < 1e-6
    d = torch.where(lin, torch.ones_like(s), s)
    wa = torch.where(lin, 1.0 - f, torch.sin((1.0 - f) * theta) / d)
    wb = torch.where(lin, f, torch.sin(f * theta) / d)
    return qnormalize(wa * a + wb * b)


def rpy(q):
    w, x, y, z = q.unbind(-1)
    roll = torch.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return torch.stack([roll, pitch, yaw], dim=-1)


# -- numpy helpers for the pair terms (float64) --------------------------------


def _np_qmul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([aw * bw - ax * bx - ay * by - az * bz, aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx, aw * bz + ax * by - ay * bx + az * bw])


def _np_slerp(a, b, f):
    dot = float(np.dot(a, b))
    if dot < 0:
        b, dot = -b, -dot
    theta = math.acos(min(1.0, dot))
    if math.sin(theta) < 1e-6:
        q = (1 - f) * a + f * b
    else:
        q = (math.sin((1 - f) * theta) * a + math.sin(f * theta) * b) / math.sin(theta)
    return q / np.linalg.norm(q)


def gyro_rk4(imu_t, gyro, t0, t1, max_step=0.01):
    """The rotation (wxyz) the gyro turns through over [t0, t1]: RK4 on
    dq/dt = q [0, w] / 2, w linearly interpolated between samples and held
    beyond the first and last, steps of at most max_step."""

    def w_at(t):
        i = int(np.searchsorted(imu_t, t))
        if i <= 0:
            return gyro[0]
        if i >= len(imu_t):
            return gyro[-1]
        f = (t - imu_t[i - 1]) / max(imu_t[i] - imu_t[i - 1], 1e-12)
        return gyro[i - 1] + f * (gyro[i] - gyro[i - 1])

    def qdot(q, w):
        return 0.5 * _np_qmul(q, np.array([0.0, *w]))

    q = np.array([1.0, 0.0, 0.0, 0.0])
    n = max(1, int(np.ceil((t1 - t0) / max_step)))
    h = (t1 - t0) / n
    t = t0
    for _ in range(n):
        w1, w2, w4 = w_at(t), w_at(t + 0.5 * h), w_at(t + h)
        k1 = qdot(q, w1)
        k2 = qdot(q + 0.5 * h * k1, w2)
        k3 = qdot(q + 0.5 * h * k2, w2)
        k4 = qdot(q + h * k3, w4)
        q = q + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        q = q / np.linalg.norm(q)
        t += h
    return q


def odometry_at(odom_t, odom_xyz, odom_q, t):
    """The odometry pose at t (lerp, slerp between the bracketing samples),
    None outside the samples' span."""
    if not len(odom_t) or t < odom_t[0] or t > odom_t[-1]:
        return None
    i = bisect.bisect_left(list(odom_t), t)
    if odom_t[i] == t:
        return odom_xyz[i], odom_q[i]
    f = (t - odom_t[i - 1]) / max(odom_t[i] - odom_t[i - 1], 1e-12)
    return odom_xyz[i - 1] + f * (odom_xyz[i] - odom_xyz[i - 1]), _np_slerp(odom_q[i - 1], odom_q[i], f)


def _np_rot(q, v):
    u, w = q[1:], q[0]
    uv = np.cross(u, v)
    return v + 2.0 * (w * uv + np.cross(u, uv))


# -- the window --------------------------------------------------------------


@dataclass
class Window:
    """One window as the reference poses it (float64 on `device`)."""

    k: int  # control points in use
    cp_t: np.ndarray  # (k,) absolute times
    cloud_prev: torch.Tensor  # (C,)
    cloud_next: torch.Tensor
    cloud_f: torch.Tensor
    cloud_on: torch.Tensor  # (C,) bool
    hi_pts: torch.Tensor  # (C, P, 3)
    hi_on: torch.Tensor  # (C, P) bool
    lo_pts: torch.Tensor
    lo_on: torch.Tensor
    hi_scale: torch.Tensor  # (C,)
    lo_scale: torch.Tensor
    pair_dt: torch.Tensor  # (k-1,)
    imu_dq: torch.Tensor  # (k-1, 4)
    odom_on: torch.Tensor  # (k-1,) bool
    odom_dt: torch.Tensor  # (k-1, 3)
    odom_dq: torch.Tensor  # (k-1, 4)
    odom_wt: torch.Tensor
    odom_wr: torch.Tensor
    weights: dict  # translation, velocity, rotation


def build_window(cp_t, cloud_t, hi_pts, hi_on, lo_pts, lo_on, imu_t, gyro, odom_t, odom_xyz, odom_q,
                 opts: dict, device) -> Window:
    """The window's terms from the control points' times, the clouds (their
    times and points) and the raw IMU and odometry handed so far; `opts`:
    the grid, IMU and odometry weights and the odometry normalizations."""
    k = len(cp_t)
    f64 = dict(dtype=torch.float64, device=device)
    prev, nxt, fac = [], [], []
    for t in cloud_t:
        j = min(max(int(np.searchsorted(cp_t, t, side="right")), 1), k - 1)
        prev.append(j - 1)
        nxt.append(j)
        fac.append((t - cp_t[j - 1]) / max(cp_t[j] - cp_t[j - 1], 1e-9))
    n_hi = hi_on.sum(dim=1).clamp(min=1).to(torch.float64)
    n_lo = lo_on.sum(dim=1).clamp(min=1).to(torch.float64)
    dq, o_on, o_dt, o_dq, o_wt, o_wr = [], [], [], [], [], []
    for i in range(1, k):
        t0, t1 = float(cp_t[i - 1]), float(cp_t[i])
        dq.append(gyro_rk4(imu_t, gyro, t0, t1))
        a, b = odometry_at(odom_t, odom_xyz, odom_q, t0), odometry_at(odom_t, odom_xyz, odom_q, t1)
        if a is None or b is None:
            o_on.append(False)
            o_dt.append(np.zeros(3))
            o_dq.append(np.array([1.0, 0.0, 0.0, 0.0]))
            o_wt.append(0.0)
            o_wr.append(0.0)
            continue
        ia = np.array([a[1][0], -a[1][1], -a[1][2], -a[1][3]])
        rel_t = _np_rot(ia, b[0] - a[0])
        rel_q = _np_qmul(ia, b[1])
        angle = 2.0 * math.atan2(float(np.linalg.norm(rel_q[1:])), abs(float(rel_q[0])))
        o_on.append(True)
        o_dt.append(rel_t)
        o_dq.append(rel_q)
        o_wt.append(opts["odometry_translation_weight"]
                    / math.sqrt(float(np.linalg.norm(rel_t)) + opts["odometry_translation_normalization"] * (t1 - t0)))
        o_wr.append(opts["odometry_rotation_weight"]
                    / math.sqrt(angle + opts["odometry_rotation_normalization"] * (t1 - t0)))
    t = lambda x: torch.as_tensor(np.asarray(x, np.float64), **f64)
    on = torch.ones(len(cloud_t), dtype=torch.bool, device=device)
    return Window(
        k=k, cp_t=np.asarray(cp_t, np.float64),
        cloud_prev=torch.as_tensor(prev, device=device), cloud_next=torch.as_tensor(nxt, device=device),
        cloud_f=t(fac), cloud_on=on,
        hi_pts=hi_pts.to(**f64), hi_on=hi_on.to(device), lo_pts=lo_pts.to(**f64), lo_on=lo_on.to(device),
        hi_scale=opts["high_resolution_grid_weight"] / torch.sqrt(n_hi.to(device)),
        lo_scale=opts["low_resolution_grid_weight"] / torch.sqrt(n_lo.to(device)),
        pair_dt=t(np.diff(cp_t)), imu_dq=t(dq), odom_on=torch.as_tensor(o_on, device=device),
        odom_dt=t(o_dt), odom_dq=t(o_dq), odom_wt=t(o_wt), odom_wr=t(o_wr),
        weights=dict(translation=opts["translation_weight"], velocity=opts["velocity_weight"],
                     rotation=opts["rotation_weight"]),
    )


def probability_field(log_odds, known, dtype):
    """Occupancy probability of every cell: 1 / (1 + e^-l) clamped to
    [0.1, 0.9] where known, 0.1 where not."""
    p = 1.0 / (1.0 + torch.exp(-log_odds.to(dtype)))
    return torch.where(known, torch.clamp(p, MIN_PROBABILITY, MAX_PROBABILITY),
                       torch.tensor(MIN_PROBABILITY, dtype=dtype, device=p.device))


def trilinear(field, min_corner, resolution, pts):
    """The probability at pts (..., 3): the trilinear blend of the 2x2x2
    cells around each point, 0.1 where they leave the grid."""
    n = field.shape
    u = (pts - min_corner) / resolution - 0.5
    i0 = torch.floor(u)
    f = u - i0
    i0 = i0.long()
    inside = torch.ones(pts.shape[:-1], dtype=torch.bool, device=pts.device)
    for a in range(3):
        inside &= (i0[..., a] >= 0) & (i0[..., a] < n[a] - 1)
    i0 = torch.where(inside[..., None], i0, 0)
    flat = field.reshape(-1)
    out = torch.zeros(pts.shape[:-1], dtype=field.dtype, device=pts.device)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((f[..., 0] if dx else 1 - f[..., 0]) * (f[..., 1] if dy else 1 - f[..., 1])
                     * (f[..., 2] if dz else 1 - f[..., 2]))
                idx = ((i0[..., 0] + dx) * n[1] + (i0[..., 1] + dy)) * n[2] + (i0[..., 2] + dz)
                out = out + w * flat[idx]
    return torch.where(inside, out, torch.tensor(MIN_PROBABILITY, dtype=field.dtype, device=pts.device))


class Grids:
    """The two probability fields a window matches against, in `dtype`."""

    def __init__(self, hi, lo, dtype):
        """hi, lo: (log_odds, known, min_corner (3,), resolution)."""
        self.dtype = dtype
        self.parts = []
        for log_odds, known, mc, res in (hi, lo):
            self.parts.append((probability_field(log_odds, known, dtype), mc.to(dtype), torch.as_tensor(
                res, dtype=dtype, device=log_odds.device)))


def residuals(w: Window, grids: Grids, t, q, v):
    """The window's residual vector at control points (t, q, v) (k, ...)."""
    dt = grids.dtype
    p, n, f = w.cloud_prev, w.cloud_next, w.cloud_f.to(dt)
    ct = t[p] + f[:, None] * (t[n] - t[p])
    cq = qslerp(q[p], q[n], f)
    out = []
    for (field, mc, res), pts, on, scale in ((grids.parts[0], w.hi_pts, w.hi_on, w.hi_scale),
                                             (grids.parts[1], w.lo_pts, w.lo_on, w.lo_scale)):
        world = qrot(cq[:, None, :], pts.to(dt)) + ct[:, None, :]
        val = 1.0 - trilinear(field, mc, res, world)
        out.append((scale.to(dt)[:, None] * val * on).reshape(-1))
    ta, tb, va, vb = t[:-1], t[1:], v[:-1], v[1:]
    q0, q1 = q[:-1], q[1:]
    pdt = w.pair_dt.to(dt)[:, None]
    wts = w.weights
    r_t = wts["translation"] * (tb - ta - pdt * va)
    r_v = wts["velocity"] * (vb - va)
    r_q = wts["rotation"] * qmul(qmul(qconj(q1), q0), w.imu_dq.to(dt))[:, 1:]
    rel_q = qmul(qconj(q0), q1)
    rel_t = qrot(qconj(q0), tb - ta)
    e_q = qmul(qconj(rel_q), w.odom_dq.to(dt))
    e_t = qrot(qconj(rel_q), w.odom_dt.to(dt) - rel_t)
    on = w.odom_on.to(dt)[:, None]
    r_ot = w.odom_wt.to(dt)[:, None] * e_t * on
    r_or = w.odom_wr.to(dt)[:, None] * rpy(e_q) * on
    out.append(torch.cat([r_t, r_v, r_q, r_ot, r_or], dim=-1).reshape(-1))
    return torch.cat(out)


def cost(w, grids, state) -> float:
    """1/2 sum r^2, summed as torch sums in the grids' dtype."""
    r = residuals(w, grids, *state)
    return float(0.5 * torch.sum(r * r))


def retract(state, delta, exact=True):
    """State (t, q, v) moved by the tangent delta (k, 9)."""
    t, q, v = state
    rot = qexp(delta[:, 3:6]) if exact else torch.cat([torch.ones_like(delta[:, :1]), 0.5 * delta[:, 3:6]], dim=-1)
    return t + delta[:, 0:3], qnormalize(qmul(q, rot)), v + delta[:, 6:9]


def jacobian(w, grids, state):
    """(r, J (n, 9k)) at `state`."""
    k = state[0].shape[0]

    def f(d):
        return residuals(w, grids, *retract(state, d.reshape(k, 9), exact=False))

    d0 = torch.zeros(k * 9, dtype=grids.dtype, device=state[0].device)
    return f(d0), torch.func.jacfwd(f)(d0).to(grids.dtype)


def solve(w, grids, state0, iterations: int, init_lambda=1e-4, max_lambda=1e6, function_tolerance=1e-6):
    """Levenberg-Marquardt from state0: damping lambda * diag(J^T J), a
    step taken when it lowers the cost (lambda * 0.33), else lambda * 4;
    stops once a step gains at most function_tolerance of the cost.
    Control point 0 is held. Returns (state, cost, initial cost)."""
    dtype = grids.dtype
    solve_dtype = torch.float64 if dtype == torch.float64 else torch.float32
    k = state0[0].shape[0]
    free = torch.ones(k, 9, dtype=torch.bool, device=state0[0].device)
    free[0] = False
    free = free.reshape(-1)
    state = state0
    r, J = jacobian(w, grids, state)
    c = float(0.5 * torch.sum(r * r))
    c0 = c
    lam = init_lambda
    for _ in range(iterations):
        Jf = J[:, free]
        A = (Jf.T @ Jf).to(solve_dtype)
        g = (Jf.T @ r).to(solve_dtype)
        damp = lam * torch.clamp(torch.diagonal(A), min=1e-12) + 1e-12
        delta = torch.zeros(k * 9, dtype=dtype, device=r.device)
        delta[free] = (-torch.linalg.solve(A + torch.diag(damp), g)).to(dtype)
        trial = retract(state, delta.reshape(k, 9))
        r_new, J_new = jacobian(w, grids, trial)
        c_new = float(0.5 * torch.sum(r_new * r_new))
        if c_new < c:
            done = c - c_new <= function_tolerance * c
            state, r, J, c = trial, r_new, J_new, c_new
            lam = max(lam * 0.33, 1e-10)
            if done:
                break
        else:
            lam = min(lam * 4.0, max_lambda)
    return state, c, c0
