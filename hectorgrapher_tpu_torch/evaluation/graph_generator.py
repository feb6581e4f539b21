"""Synthetic large pose graphs for the SPA at scale (a numpy copy of
make_scale_spa_problem from hectorgrapher_tpu/evaluation/graph_generator.py
:17-93, and its 2D counterpart make_scale_spa_problem_2d; ref: the
reference's SPA operating point, pose_graph.lua optimize_every_n_nodes=90
over multi-thousand-node graphs)."""

from __future__ import annotations

import numpy as np
import torch

from hectorgrapher_tpu_torch.mapping.pose_graph.optimization import SpaExtras2D, SpaProblem2D, SpaProblem3D


def make_scale_spa_problem(
    num_nodes: int = 5000,
    num_submaps: int = 500,
    num_constraints: int = 20000,
    noise: float = 0.5,
    seed: int = 0,
    device="cuda",
):
    """A SpaProblem3D on `device` whose ground truth is recoverable, the
    JAX package's for the same arguments number for number.

    A snake trajectory with 10 nodes per submap (wrapping over the submap
    set to create revisits), INTRA constraints node -> submap (+ the
    previous submap on even nodes), and random INTER closures up to
    num_constraints. Initial translations are the ground truth +
    N(0, noise), node 0 and submap 0 exact. Returns (problem,
    node_translation_gt (N, 3), submap_translation_gt (S, 3)), the truths
    as float64 numpy arrays."""
    rng = np.random.default_rng(seed)
    n, s_count = num_nodes, num_submaps
    t_gt = np.zeros((n, 3))
    for i in range(1, n):
        t_gt[i] = t_gt[i - 1] + np.array([0.5, 0.02 * np.sin(i * 0.1), 0.0])
    sub_of = np.arange(n) // 10 % s_count
    s_t = np.zeros((s_count, 3))
    seen = set()
    for i in range(n):
        s = int(sub_of[i])
        if s not in seen:
            seen.add(s)
            s_t[s] = t_gt[i]
    cs, cn, crt = [], [], []
    for i in range(n):
        targets = [int(sub_of[i])]
        if sub_of[i] > 0 and i % 2 == 0:
            targets.append(int(sub_of[i]) - 1)
        for s in targets:
            cs.append(s)
            cn.append(i)
            crt.append(t_gt[i] - s_t[s])
    while len(cs) < num_constraints:
        i = int(rng.integers(0, n))
        s = int(rng.integers(0, s_count))
        cs.append(s)
        cn.append(i)
        crt.append(t_gt[i] - s_t[s])
    c = len(cs)
    t0 = t_gt + rng.normal(0, noise, (n, 3))
    t0[0] = t_gt[0]
    st0 = s_t + rng.normal(0, noise, (s_count, 3))
    st0[0] = s_t[0]

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    identity = [1.0, 0.0, 0.0, 0.0]
    problem = SpaProblem3D(
        submap_translation=f32(st0),
        submap_rotation=f32(np.tile(identity, (s_count, 1))),
        node_translation=f32(t0),
        node_rotation=f32(np.tile(identity, (n, 1))),
        submap_fixed=torch.as_tensor(np.arange(s_count) == 0, device=device),
        node_fixed=torch.zeros(n, dtype=torch.bool, device=device),
        c_submap=torch.as_tensor(np.asarray(cs, np.int64), device=device),
        c_node=torch.as_tensor(np.asarray(cn, np.int64), device=device),
        c_mask=torch.ones(c, dtype=torch.bool, device=device),
        c_rel_translation=f32(crt),
        c_rel_rotation=f32(np.tile(identity, (c, 1))),
        c_translation_weight=f32(np.full(c, 100.0)),
        c_rotation_weight=f32(np.full(c, 30.0)),
        c_huber_scale=f32(np.full(c, 1e6)),
    )
    return problem, t_gt, s_t


def _relative_2d(a, b):
    """b in a's frame, (..., 3) poses (x, y, theta)."""
    c, s = np.cos(a[..., 2]), np.sin(a[..., 2])
    d = b[..., :2] - a[..., :2]
    return np.stack([c * d[..., 0] + s * d[..., 1], -s * d[..., 0] + c * d[..., 1], b[..., 2] - a[..., 2]], axis=-1)


def make_scale_spa_problem_2d(
    num_nodes: int = 5000,
    num_submaps: int = 500,
    num_constraints: int = 20000,
    noise: float = 0.5,
    angle_noise: float = 0.02,
    seed: int = 0,
    device="cuda",
):
    """make_scale_spa_problem's graph in 2D: the same snake in the plane,
    the heading swinging as 0.3 sin(0.05 i), submap i's pose its first
    node's; constraints carry the exact relative poses. Initial positions
    are the truth + N(0, noise), headings + N(0, angle_noise), node 0 and
    submap 0 exact. Returns (problem, node_pose_gt (N, 3), submap_pose_gt
    (S, 3)), the truths as float64 numpy arrays."""
    rng = np.random.default_rng(seed)
    n, s_count = num_nodes, num_submaps
    gt = np.zeros((n, 3))
    for i in range(1, n):
        gt[i, :2] = gt[i - 1, :2] + np.array([0.5, 0.02 * np.sin(i * 0.1)])
    gt[:, 2] = 0.3 * np.sin(0.05 * np.arange(n))
    sub_of = np.arange(n) // 10 % s_count
    s_gt = np.zeros((s_count, 3))
    seen = set()
    for i in range(n):
        s = int(sub_of[i])
        if s not in seen:
            seen.add(s)
            s_gt[s] = gt[i]
    cs, cn = [], []
    for i in range(n):
        targets = [int(sub_of[i])]
        if sub_of[i] > 0 and i % 2 == 0:
            targets.append(int(sub_of[i]) - 1)
        for s in targets:
            cs.append(s)
            cn.append(i)
    while len(cs) < num_constraints:
        cs.append(int(rng.integers(0, s_count)))
        cn.append(int(rng.integers(0, n)))
    cs, cn = np.asarray(cs, np.int64), np.asarray(cn, np.int64)
    c = len(cs)
    p0 = gt + np.concatenate([rng.normal(0, noise, (n, 2)), rng.normal(0, angle_noise, (n, 1))], axis=1)
    p0[0] = gt[0]
    sp0 = s_gt + np.concatenate([rng.normal(0, noise, (s_count, 2)), rng.normal(0, angle_noise, (s_count, 1))],
                                axis=1)
    sp0[0] = s_gt[0]

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    problem = SpaProblem2D(
        submap_pose=f32(sp0),
        node_pose=f32(p0),
        submap_fixed=torch.as_tensor(np.arange(s_count) == 0, device=device),
        node_fixed=torch.zeros(n, dtype=torch.bool, device=device),
        c_submap=torch.as_tensor(cs, device=device),
        c_node=torch.as_tensor(cn, device=device),
        c_mask=torch.ones(c, dtype=torch.bool, device=device),
        c_rel_pose=f32(_relative_2d(s_gt[cs], gt[cn])),
        c_translation_weight=f32(np.full(c, 100.0)),
        c_rotation_weight=f32(np.full(c, 30.0)),
        c_huber_scale=f32(np.full(c, 1e6)),
    )
    return problem, gt, s_gt


def odometry_extras_2d(node_gt, translation_weight: float = 10.0, rotation_weight: float = 10.0, device="cuda"):
    """SpaExtras2D holding one exact relative-pose residual between each
    pair of consecutive nodes of node_gt (N, 3), the other families empty:
    the odometry chain a 2D pose graph adds to every solve."""
    n = node_gt.shape[0]
    f32 = dict(dtype=torch.float32, device=device)
    p = max(n - 1, 1)
    ints = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    off = lambda k: torch.zeros(k, dtype=torch.bool, device=device)
    return SpaExtras2D(
        nn_a=ints(np.arange(p)), nn_b=ints(np.arange(1, p + 1)), nn_mask=torch.ones(p, dtype=torch.bool, device=device),
        nn_rel_pose=torch.as_tensor(_relative_2d(node_gt[:-1], node_gt[1:]).astype(np.float32), device=device),
        nn_translation_weight=torch.full((p,), translation_weight, **f32),
        nn_rotation_weight=torch.full((p,), rotation_weight, **f32),
        ff_mask=off(n), ff_pose=torch.zeros((n, 3), **f32), ff_translation_weight=torch.zeros(n, **f32),
        landmark_pose=torch.zeros((1, 3), **f32), landmark_mask=off(1), lm_node=ints([0]), lm_index=ints([0]),
        lm_mask=off(1), lm_rel_pose=torch.zeros((1, 3), **f32), lm_translation_weight=torch.zeros(1, **f32),
        lm_rotation_weight=torch.zeros(1, **f32),
    )
