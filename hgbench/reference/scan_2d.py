"""2D scan matching against an occupancy grid.

The semantics of Cartographer's CeresScanMatcher2D (occupied_space_cost_
function_2d.cc, translation and rotation delta costs) and of its fast
correlative matcher's score (fast_correlative_scan_matcher_2d.cc):

  * the probability of a cell: 1 / (1 + e^-l) clamped to [0.1, 0.9] where
    known, 0.1 where not;
  * refinement: residuals w_o / sqrt(n) (1 - P(R(theta) p + t)) per point,
    P the bicubic (Catmull-Rom) interpolation of the cells' probabilities
    around the point (cell centres at min_corner + (i + 1/2) res, 0.1
    outside the grid), w_t (t - target) and w_r (theta - theta0); cost
    1/2 sum r^2; Levenberg-Marquardt on (x, y, theta);
  * a candidate's score: the mean over the points of the probability of
    the cell each point falls in (floor((p - min_corner) / res)), a cell
    outside the grid counting 0.1; the matcher's answer is the best that
    the port's search finds over its window of angles and cell offsets:
    a fixed top-k beam down a max-pool pyramid of upper bounds
    (beam_search).

Computed in `dtype`: float64 for the reference, bfloat16 for the control.
"""

from __future__ import annotations

import math

import torch

MIN_PROBABILITY = 0.1


def probability(log_odds, known, dtype):
    p = 1.0 / (1.0 + torch.exp(-log_odds.to(dtype)))
    return torch.where(known, torch.clamp(p, 0.1, 0.9), torch.tensor(MIN_PROBABILITY, dtype=dtype,
                                                                     device=p.device))


def _cubic(t):
    """Catmull-Rom weights of the taps at offsets -1, 0, 1, 2."""
    t2, t3 = t * t, t * t * t
    return (0.5 * (-t3 + 2 * t2 - t), 0.5 * (3 * t3 - 5 * t2 + 2), 0.5 * (-3 * t3 + 4 * t2 + t), 0.5 * (t3 - t2))


def bicubic(field, min_corner, resolution, xy):
    """P at points xy (..., 2); taps outside the grid read 0.1."""
    nx, ny = field.shape
    u = (xy - min_corner) / resolution - 0.5
    i0 = torch.floor(u)
    f = u - i0
    i0 = i0.long()
    wx, wy = _cubic(f[..., 0]), _cubic(f[..., 1])
    flat = field.reshape(-1)
    out = torch.zeros(xy.shape[:-1], dtype=field.dtype, device=xy.device)
    for a in range(4):
        ix = i0[..., 0] + a - 1
        for b in range(4):
            iy = i0[..., 1] + b - 1
            ok = (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
            v = torch.where(ok, flat[(ix.clamp(0, nx - 1) * ny + iy.clamp(0, ny - 1))],
                            torch.tensor(MIN_PROBABILITY, dtype=field.dtype, device=xy.device))
            out = out + wx[a] * wy[b] * v
    return out


def _rot(theta, p):
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([c * p[..., 0] - s * p[..., 1], s * p[..., 0] + c * p[..., 1]], dim=-1)


class Match:
    """One refinement problem: the field, the cloud and the penalties."""

    def __init__(self, field, min_corner, resolution, pts, valid, target, theta0, w_o, w_t, w_r):
        self.field, self.mc, self.res = field, min_corner, resolution
        self.pts = pts[valid].to(field.dtype)
        self.scale = w_o / float(max(int(valid.sum()), 1)) ** 0.5
        self.target, self.theta0 = target.to(field.dtype), theta0
        self.w_t, self.w_r = w_t, w_r

    def residuals(self, x):
        world = _rot(x[2], self.pts) + x[:2]
        r_o = self.scale * (1.0 - bicubic(self.field, self.mc, self.res, world))
        return torch.cat([r_o, self.w_t * (x[:2] - self.target), (self.w_r * (x[2] - self.theta0)).reshape(1)])

    def cost(self, x) -> float:
        r = self.residuals(x.to(self.field.dtype))
        return float(0.5 * torch.sum(r * r))

    def solve(self, x0, iterations: int, init_lambda=1e-4, max_lambda=1e6, function_tolerance=1e-6):
        """Levenberg-Marquardt from x0 (as the CT reference's). Returns (x, cost)."""
        dtype = self.field.dtype
        solve_dtype = torch.float64 if dtype == torch.float64 else torch.float32
        x = x0.to(dtype)
        r, J = self.residuals(x), torch.func.jacfwd(self.residuals)(x).to(dtype)
        c, lam = float(0.5 * torch.sum(r * r)), init_lambda
        for _ in range(iterations):
            A, g = (J.T @ J).to(solve_dtype), (J.T @ r).to(solve_dtype)
            step = -torch.linalg.solve(A + torch.diag(lam * torch.clamp(torch.diagonal(A), min=1e-12) + 1e-12), g)
            trial = x + step.to(dtype)
            r_new = self.residuals(trial)
            c_new = float(0.5 * torch.sum(r_new * r_new))
            if c_new < c:
                done = c - c_new <= function_tolerance * c
                x, r, c = trial, r_new, c_new
                J = torch.func.jacfwd(self.residuals)(x).to(dtype)
                lam = max(lam * 0.33, 1e-10)
                if done:
                    break
            else:
                lam = min(lam * 4.0, max_lambda)
        return x, c


def score(prob, min_corner, resolution, pts, valid, xy, theta):
    """The matcher's score of the pose (xy, theta)."""
    nx, ny = prob.shape
    world = _rot(torch.as_tensor(theta, dtype=prob.dtype, device=prob.device), pts[valid].to(prob.dtype)) + xy
    cell = torch.floor((world - min_corner) / resolution).long()
    ok = (cell[:, 0] >= 0) & (cell[:, 0] < nx) & (cell[:, 1] >= 0) & (cell[:, 1] < ny)
    p = torch.where(ok, prob.reshape(-1)[cell[:, 0].clamp(0, nx - 1) * ny + cell[:, 1].clamp(0, ny - 1)],
                    torch.tensor(MIN_PROBABILITY, dtype=prob.dtype, device=prob.device))
    return float(p.mean())


def _window_max(prob, span: int):
    """Each cell's bound at a level of span cells: the max of the cells in
    [x, x + span) x [y, y + span), cells past the grid left out."""
    if span == 1:
        return prob
    neg = torch.full((1, 1, prob.shape[0] + span - 1, prob.shape[1] + span - 1), -math.inf, dtype=prob.dtype,
                     device=prob.device)
    neg[0, 0, : prob.shape[0], : prob.shape[1]] = prob
    return torch.nn.functional.max_pool2d(neg, span, stride=1)[0, 0]


def _level_sums(level, span, cells, offs_x, offs_y):
    """For candidates (C) at point-cell rows cells (C, P, 2) and their
    offsets (C, X), (C, Y): the sum over the points of the level's
    prob - 0.1 at cell + offset (C, X, Y). A row or column index in
    (-span, 0) reads the grid's first window (the port's search takes a
    window that starts before the grid for the one that starts at its
    edge); one further out, or past the grid, adds 0."""
    nx, ny = level.shape
    ix = cells[:, :, 0][:, :, None] + offs_x[:, None, :]  # (C, P, X)
    iy = cells[:, :, 1][:, :, None] + offs_y[:, None, :]  # (C, P, Y)
    okx = (ix > -span) & (ix < nx)
    oky = (iy > -span) & (iy < ny)
    v = (level - MIN_PROBABILITY).reshape(-1)[ix.clamp(0, nx - 1)[..., :, None] * ny + iy.clamp(0, ny - 1)[..., None, :]]
    keep = okx[..., :, None] & oky[..., None, :]  # (C, P, X, Y)
    return torch.where(keep, v, torch.zeros((), dtype=v.dtype, device=v.device)).sum(dim=1)


def _top(scores, k: int):
    """The first k of a stable descending sort: the k best, ties to the
    earlier candidate."""
    return torch.sort(scores, descending=True, stable=True).indices[:k]


def beam_search(prob, min_corner, resolution, pts, valid, xy0, theta0, num_angles, angle_step, linear_cells, depth,
                top_k):
    """The port's fast correlative search (a fixed top-k beam down a
    max-pool pyramid, fast_correlative_2d.py), written out: (score, xy,
    theta) of its answer.

    Level d's bound of a candidate: 0.1 + the mean over the valid points
    of max(window of 2^d x 2^d cells at the point's cell + the offset) -
    0.1. Angles theta0 + k step, |k| <= num_angles. At the top level
    (depth - 1, stride s = 2^(depth - 1)) every angle is scored against
    the offsets (i - n // 2) s - s // 2, i < n = 2 ceil(linear_cells / s)
    + 1, per axis, and the top_k candidates kept (in angle, x, y order);
    each lower level scores the 2 x 2 children of the kept ones (offsets
    + 0 or + 2^level per axis, clamped to +-linear_cells; in parent, x, y
    order) and keeps the top_k again; the answer is the first best at
    level 0."""
    dtype, dev = prob.dtype, prob.device
    p = pts[valid].to(dtype)
    n = max(int(p.shape[0]), 1)
    levels = [_window_max(prob, 2**d) for d in range(depth)]
    ks = torch.arange(-num_angles, num_angles + 1, device=dev, dtype=dtype)
    thetas = theta0 + ks * angle_step
    c, sn = torch.cos(thetas)[:, None], torch.sin(thetas)[:, None]
    world = torch.stack([c * p[:, 0] - sn * p[:, 1], sn * p[:, 0] + c * p[:, 1]], dim=-1) + xy0  # (T, P, 2)
    cells = torch.floor((world - min_corner) / resolution).long()
    stride = 2 ** (depth - 1)
    nb = 2 * ((linear_cells + stride - 1) // stride) + 1
    block = (torch.arange(nb, device=dev) - nb // 2) * stride - stride // 2
    t_n = cells.shape[0]
    top = torch.cat([_level_sums(levels[-1], stride, cells[i:i + 16], block.expand(min(16, t_n - i), nb),
                                 block.expand(min(16, t_n - i), nb)) for i in range(0, t_n, 16)])
    scores = (MIN_PROBABILITY + top / n).reshape(-1)
    cand_t = torch.arange(t_n, device=dev).repeat_interleave(nb * nb)
    cand_x = block.repeat_interleave(nb).repeat(t_n)
    cand_y = block.repeat(t_n * nb)
    keep = _top(scores, top_k)
    cand_t, cand_x, cand_y, scores = cand_t[keep], cand_x[keep], cand_y[keep], scores[keep]
    for level in range(depth - 2, -1, -1):
        step = torch.tensor([0, 2**level], device=dev)
        cx = (cand_x[:, None] + step).clamp(-linear_cells, linear_cells)  # (K, 2)
        cy = (cand_y[:, None] + step).clamp(-linear_cells, linear_cells)
        s = MIN_PROBABILITY + _level_sums(levels[level], 2**level, cells[cand_t], cx, cy) / n  # (K, 2, 2)
        kk = cand_t.shape[0]
        cand_t = cand_t.repeat_interleave(4)
        cand_x = cx[:, :, None].expand(kk, 2, 2).reshape(-1)
        cand_y = cy[:, None, :].expand(kk, 2, 2).reshape(-1)
        scores = s.reshape(-1)
        keep = _top(scores, top_k)
        cand_t, cand_x, cand_y, scores = cand_t[keep], cand_x[keep], cand_y[keep], scores[keep]
    i = int(torch.argmax(scores))
    off = torch.stack([cand_x[i], cand_y[i]]).to(dtype) * resolution
    return float(scores[i]), xy0 + off, float(thetas[cand_t[i]])
