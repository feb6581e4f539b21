"""The 2D pose graph's optimization (sparse pose adjustment).

The semantics of Cartographer's OptimizationProblem2D as HectorGrapher's
port states them: poses (x, y, theta) of submaps, nodes and landmarks;
every relative-pose term compares a^-1 b with its measurement: with
h = R(a_theta)^T (b_xy - a_xy), the residual (w_t (m_x - h_x), w_t (m_y -
h_y), w_r wrap(m_theta - (b_theta - a_theta))), the wrap to (-pi, pi].
Submap-node constraints carry the Huber loss as iteratively reweighted
least squares: a residual block of norm |r| above the scale s is weighed
by sqrt(s / |r|) (the weight held while the step is solved). Between
nodes: the odometry and local-SLAM relative poses; fixed-frame priors
w (xy - prior); landmark observations. Cost 1/2 sum (w r)^2;
Levenberg-Marquardt with damping lambda * diag + 1e-8; the poses marked
fixed do not move.

The problem's arrays are the program's (its graph, assembled from its
nodes and constraints): the reference follows it step by step. Computed
in `dtype`: float64 for the reference, bfloat16 for the control.
"""

from __future__ import annotations

import math

import torch


def _wrap(a):
    w = a - 2.0 * math.pi * torch.floor((a + math.pi) / (2.0 * math.pi))
    return torch.where(w <= -math.pi, w + 2.0 * math.pi, w)


def relative(a, b, m, wt, wr):
    c, s = torch.cos(a[:, 2]), torch.sin(a[:, 2])
    d0, d1 = b[:, 0] - a[:, 0], b[:, 1] - a[:, 1]
    h0, h1 = c * d0 + s * d1, -s * d0 + c * d1
    return torch.stack([wt * (m[:, 0] - h0), wt * (m[:, 1] - h1), wr * _wrap(m[:, 2] - (b[:, 2] - a[:, 2]))], dim=-1)


class Spa:
    def __init__(self, problem, extras, dtype):
        self.dtype = dtype
        cast = lambda x: x.to(dtype) if x.is_floating_point() else x
        self.p = type(problem)(*(cast(x) for x in problem))
        self.e = None if extras is None else type(extras)(*(cast(x) for x in extras))
        self.S, self.N = self.p.submap_pose.shape[0], self.p.node_pose.shape[0]
        self.L = 0 if self.e is None else self.e.landmark_pose.shape[0]
        fixed = [self.p.submap_fixed, self.p.node_fixed] + ([~self.e.landmark_mask] if self.e is not None else [])
        self.free = ~torch.repeat_interleave(torch.cat(fixed), 3)

    def start(self):
        parts = [self.p.submap_pose, self.p.node_pose] + ([self.e.landmark_pose] if self.e is not None else [])
        return torch.cat([x.reshape(-1) for x in parts])

    def split(self, x):
        S, N = self.S, self.N
        return x[:3 * S].reshape(S, 3), x[3 * S:3 * (S + N)].reshape(N, 3), x[3 * (S + N):].reshape(-1, 3)

    def _families(self, x):
        """[(r (B, 3), mask (B,), huber scale (B,) or None)]."""
        sp, npo, lp = self.split(x)
        p, e = self.p, self.e
        out = [(relative(sp[p.c_submap], npo[p.c_node], p.c_rel_pose, p.c_translation_weight,
                         p.c_rotation_weight), p.c_mask, p.c_huber_scale)]
        if e is not None:
            out.append((relative(npo[e.nn_a], npo[e.nn_b], e.nn_rel_pose, e.nn_translation_weight,
                                 e.nn_rotation_weight), e.nn_mask, None))
            ff = e.ff_translation_weight[:, None] * (npo[:, :2] - e.ff_pose[:, :2])
            out.append((torch.cat([ff, torch.zeros_like(ff[:, :1])], dim=1), e.ff_mask, None))
            out.append((relative(npo[e.lm_node], lp[e.lm_index], e.lm_rel_pose, e.lm_translation_weight,
                                 e.lm_rotation_weight), e.lm_mask, None))
        return out

    def _weights(self, x):
        """Each residual row's IRLS weight at x (held constant)."""
        ws = []
        for r, m, scale in self._families(x):
            w = torch.ones(r.shape[0], dtype=self.dtype, device=r.device)
            if scale is not None:
                n = torch.linalg.vector_norm(r, dim=-1)
                w = torch.where(n <= scale, w, torch.sqrt(scale / torch.clamp(n, min=1e-12)))
            ws.append((w * m)[:, None].expand(-1, 3).reshape(-1))
        return torch.cat(ws)

    def raw(self, x):
        return torch.cat([r.reshape(-1) for r, _, _ in self._families(x)])

    def cost(self, x) -> float:
        r = self.raw(x) * self._weights(x)
        return float(0.5 * torch.sum(r * r))

    def solve(self, x0, iterations: int, init_lambda=1e-4, max_lambda=1e8, function_tolerance=1e-6,
              parameter_tolerance=1e-7):
        solve_dtype = torch.float64 if self.dtype == torch.float64 else torch.float32
        free = self.free
        x = x0.to(self.dtype)

        def lin(x):
            w = self._weights(x)
            r = self.raw(x) * w
            J = torch.func.jacfwd(lambda d: self.raw(x + d))(torch.zeros_like(x))[:, free].to(self.dtype) * w[:, None]
            return r, J

        r, J = lin(x)
        c, lam = float(0.5 * torch.sum(r * r)), init_lambda
        for _ in range(iterations):
            A, g = (J.T @ J).to(solve_dtype), (J.T @ r).to(solve_dtype)
            step = -torch.linalg.solve(A + torch.diag(lam * torch.clamp(torch.diagonal(A), min=1e-8) + 1e-8), g)
            trial = x.clone()
            trial[free] = x[free] + step.to(self.dtype)
            r_new, J_new = lin(trial)
            c_new = float(0.5 * torch.sum(r_new * r_new))
            small = float(torch.linalg.vector_norm(step)) <= parameter_tolerance * (
                float(torch.linalg.vector_norm(x)) + parameter_tolerance)
            if c_new < c:
                done = c - c_new <= function_tolerance * c
                x, r, J, c = trial, r_new, J_new, c_new
                lam = max(lam * 0.33, 1e-10)
                if done:
                    break
            else:
                lam = min(lam * 4.0, max_lambda)
            if small:
                break
        return x, c
