"""CT window solves sharded over a Mesh: multi-robot serving (counterpart
of hectorgrapher_tpu/parallel/ct_windows.py :28-81).

The reference's multi-robot MapBuilderServer runs one local SLAM stack a
trajectory on CPU threads (ref: cloud/internal/map_builder_server.cc; it
scales by adding servers). Here each shard of a mesh solves the CT windows
of its share of the trajectories: solve_ct_window_batched over the shard's
lanes, one slotted K3 launch a shard and assembly. Window solves are
independent, so no collective is made.
"""

from __future__ import annotations

import torch

from hectorgrapher_tpu_torch.mapping.ct.window_solver import solve_ct_window_batched
from hectorgrapher_tpu_torch.parallel.mesh import Mesh


def _to(tree, device):
    """`tree` (a tensor, or a NamedTuple of them and of plain values) with
    its tensors on `device`; the same object when they are there already,
    so that a grid several windows share stays one object (window_slots
    reads each distinct grid once)."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        leaves = [_to(x, device) for x in tree]
        return tree if all(a is b for a, b in zip(leaves, tree)) else type(tree)(*leaves)
    return tree


def _lanes(tree, rows: slice, device):
    """Rows of every leaf of a NamedTuple of batched tensors, on `device`."""
    return type(tree)(*(leaf[rows].to(device) for leaf in tree))


def solve_ct_windows_sharded(mesh: Mesh, high_grids, low_grids, problems, states0, weights, is_tsdf: bool,
                             num_iterations: int = 12, axis: str = "graph", per_point: bool = False, directs=None):
    """B windows solved over `mesh`'s shards, shard i taking lanes
    [i * B / n, (i + 1) * B / n) of n = mesh.size shards; B must divide.

    high_grids, low_grids: B grids each (as solve_ct_window_batched takes
    them); problems, states0 and directs (batched DirectImuData, or None):
    a leading window axis on every leaf; weights shared. Per scan or
    (per_point) per point, with DIRECT when directs are given. Returns
    (states, final costs, initial costs) of this process's lanes, in lane
    order, on mesh.device: all B lanes on a mesh of one process."""
    del axis  # the mesh has one axis
    b = len(high_grids)
    if b % mesh.size != 0:
        raise ValueError(f"{b} windows do not divide over {mesh.size} shards: pad the batch")
    per = b // mesh.size
    outs = []
    for device, index in zip(mesh.devices, mesh.local_shards):
        rows = slice(index * per, (index + 1) * per)
        moved = {}
        grids = [[moved.setdefault(id(g), _to(g, device)) for g in gs[rows]] for gs in (high_grids, low_grids)]
        outs.append(solve_ct_window_batched(
            grids[0], grids[1], _lanes(problems, rows, device), _lanes(states0, rows, device), _to(weights, device),
            is_tsdf=is_tsdf, num_iterations=num_iterations, per_point=per_point,
            directs=None if directs is None else _lanes(directs, rows, device)))
    states = type(states0)(*(torch.cat([o[0][k].to(mesh.device) for o in outs]) for k in range(len(states0))))
    return states, torch.cat([o[1].to(mesh.device) for o in outs]), torch.cat([o[2].to(mesh.device) for o in outs])
