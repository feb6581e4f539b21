"""The SPA solves sharded over a Mesh (counterpart of
hectorgrapher_tpu/parallel/sharded.py :63-302).

Instead of RPC between processes (ref: cartographer/cloud, the uplink
server holding the global pose graph), the constraint work of the pose
graph is split over the mesh's shards. Like the JAX package's, the solve
is communication-avoiding:

  * each shard builds the residuals and Jacobian blocks of its share of
    the constraints (the closed-form blocks of the local solver,
    optimization.py _pair_blocks / _pair_blocks_2d, masked and
    Huber-weighted by _weighted_blocks, op for op as there);
  * ONE gather per LM evaluation (Mesh.all_gather) moves every shard's
    blocks, J and r packed in one table, to every process;
  * the rest of the LM loop runs replicated on the mesh's first device,
    the local solver's own code (optimization.py _solve_spa): the Schur
    or the PCG solve, chosen by _SCHUR_COUPLING_BUDGET, the accept test
    and the stop test. These read only gathered, replicated values, so
    every process takes the same decisions and makes the same number of
    gathers (a process that diverged would leave the others waiting in a
    collective).

A one-shard mesh computes the local solve's blocks over the same rows in
the same order, so it returns the local solve's result bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from hectorgrapher_tpu_torch.mapping.pose_graph.optimization import (
    SpaProblem2D,
    SpaProblem3D,
    _pair_blocks,
    _pair_blocks_2d,
    _retract_poses,
    _solve_spa,
    _weighted_blocks,
)
from hectorgrapher_tpu_torch.parallel.mesh import Mesh

_INDEX_FIELDS = ("c_submap", "c_node")


def _pad_constraints(problem, axis_size: int):
    """The constraint axis (the c_* leaves) padded with zero rows, masked
    out, to a multiple of the mesh size."""
    c = problem.c_submap.shape[0]
    pad = -c % axis_size
    if pad == 0:
        return problem

    def pad_leaf(name, x):
        if not name.startswith("c_"):
            return x
        return torch.cat([x, torch.zeros((pad,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)])

    return type(problem)(**{k: pad_leaf(k, v) for k, v in problem._asdict().items()})


def _on_device(problem, device):
    """The problem's leaves as tensors on `device` (numpy leaves are how
    the solver plane ships a problem), the constraint indices int64."""
    def leaf(name, x):
        x = (x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))).to(device)
        return x.to(torch.int64) if name in _INDEX_FIELDS else x

    return type(problem)(**{k: leaf(k, v) for k, v in problem._asdict().items()})


def _constraint_shards(problem, mesh: Mesh):
    """(device, the problem's c_* leaves of the shard on it) for each of
    this process's shards: contiguous blocks of the padded constraints,
    shard i of the mesh holding block i."""
    per = problem.c_submap.shape[0] // mesh.size
    out = []
    for device, index in zip(mesh.devices, mesh.local_shards):
        rows = slice(index * per, (index + 1) * per)
        out.append((device, {k: v[rows].to(device) for k, v in problem._asdict().items() if k.startswith("c_")}))
    return out


def _gathered_blocks(mesh: Mesh, blocks):
    """Every shard's (J (c, R, Q), r (c, R)) in constraint order on
    mesh.device, through one gather of a (c, R * Q + R) table a shard."""
    c, rows, cols = blocks[0][0].shape
    table = mesh.all_gather([torch.cat([J.reshape(J.shape[0], -1), r], dim=1) for J, r in blocks])
    return table[:, :rows * cols].reshape(-1, rows, cols), table[:, rows * cols:]


def solve_spa_2d_sharded(problem: SpaProblem2D, mesh: Mesh, num_iterations: int = 20, init_lambda: float = 1e-4):
    """The 2D SPA over `mesh` (see the module docstring). problem: tensors
    or numpy leaves, replicated on every process. Returns (submap_pose,
    node_pose, final_cost) on mesh.device, as solve_spa_2d."""
    problem = _pad_constraints(_on_device(problem, mesh.device), mesh.size)
    S = problem.submap_pose.shape[0]
    shards = _constraint_shards(problem, mesh)

    def weighted_blocks(params):
        out = []
        for device, c in shards:
            sp, np_ = (x.to(device) for x in params)
            out.append(_weighted_blocks(
                *_pair_blocks_2d(sp[c["c_submap"]], np_[c["c_node"]], c["c_rel_pose"], c["c_translation_weight"],
                                 c["c_rotation_weight"]), c["c_mask"], c["c_huber_scale"]))
        return _gathered_blocks(mesh, out)

    def retract(params, delta):
        sp, np_ = params
        return sp + delta[: 3 * S].reshape(-1, 3), np_ + delta[3 * S:].reshape(-1, 3)

    params, cost = _solve_spa(problem, weighted_blocks, retract, (problem.submap_pose, problem.node_pose), 3,
                              num_iterations, init_lambda, "auto")
    return params + (cost,)


def solve_spa_3d_sharded(problem: SpaProblem3D, mesh: Mesh, num_iterations: int = 20, init_lambda: float = 1e-4):
    """The 3D SPA over `mesh` (the 2D solve's structure). Returns
    (submap_translation, submap_rotation, node_translation, node_rotation,
    final_cost) on mesh.device, as solve_spa_3d."""
    problem = _pad_constraints(_on_device(problem, mesh.device), mesh.size)
    S = problem.submap_translation.shape[0]
    shards = _constraint_shards(problem, mesh)

    def weighted_blocks(params):
        out = []
        for device, c in shards:
            st, sq, nt, nq = (x.to(device) for x in params)
            cs, cn = c["c_submap"], c["c_node"]
            out.append(_weighted_blocks(
                *_pair_blocks(st[cs], sq[cs], nt[cn], nq[cn], c["c_rel_translation"], c["c_rel_rotation"],
                              c["c_translation_weight"], c["c_rotation_weight"]), c["c_mask"], c["c_huber_scale"]))
        return _gathered_blocks(mesh, out)

    def retract(params, delta):
        st, sq, nt, nq = params
        return (*_retract_poses(st, sq, delta[: 6 * S]), *_retract_poses(nt, nq, delta[6 * S:]))

    params0 = (problem.submap_translation, problem.submap_rotation, problem.node_translation,
               problem.node_rotation)
    params, cost = _solve_spa(problem, weighted_blocks, retract, params0, 6, num_iterations, init_lambda, "auto")
    return params + (cost,)


def spa_sharded_collective_ops(problem, mesh: Mesh, num_iterations: int = 10) -> dict:
    """The collectives one sharded solve of `problem` makes (the JAX
    package counts the all-gather ops of the compiled program; here the
    mesh counts the gathers the solve runs): {"all_gather": n, "total":
    n}, n = 1 + the LM iterations taken."""
    solver = solve_spa_2d_sharded if isinstance(problem, SpaProblem2D) else solve_spa_3d_sharded
    before = mesh.collectives
    solver(problem, mesh, num_iterations=num_iterations)
    n = mesh.collectives - before
    return {"all_gather": n, "total": n}
