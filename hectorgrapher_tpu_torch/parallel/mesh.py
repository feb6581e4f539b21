"""The port's mesh: the counterpart of a jax.sharding.Mesh over the axis
"graph", and of jax.lax.all_gather over it.

JAX shards with one controller over many devices, and across hosts every
process enters the same program (parallel/multihost.py). A Mesh keeps
both. It holds this process's shard devices, in order; they may repeat
(four shards on cuda:0 of a one-card machine, eight on cpu in the tests).
When the mesh spans processes it also holds a torch.distributed group:
every process holds the same number of shards, and shard k of the process
of rank r is the mesh's shard r * len(devices) + k.

A sharded function (parallel/sharded.py, parallel/constraint_search.py)
computes each of this process's shards on its device, then gathers the
shards' results with Mesh.all_gather, one collective, which the mesh
counts: the counterpart of the all-gather ops that
spa_sharded_collective_ops counts in the JAX package's compiled program
(parallel/sharded.py:285-302).
"""

from __future__ import annotations

from typing import Sequence

import torch


class Mesh:
    """Shards over one axis (see the module docstring).

    devices: this process's shard devices, in order. group: the
    torch.distributed group of the processes the mesh spans, or None for
    a mesh of this process alone. collectives counts all_gather calls."""

    def __init__(self, devices: Sequence, group=None, axis: str = "graph"):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a Mesh needs at least one shard device")
        self.group = group
        if group is not None:
            import torch.distributed as dist

            self.rank, self.world = dist.get_rank(group), dist.get_world_size(group)
            self.backend = dist.get_backend(group)
        else:
            self.rank, self.world, self.backend = 0, 1, None
        self.axis_names = (axis,)
        self.collectives = 0

    @property
    def device(self) -> torch.device:
        """This process's first shard device: where gathered results and
        replicated work live."""
        return self.devices[0]

    @property
    def size(self) -> int:
        """The shards of every process (JAX: mesh.devices.size)."""
        return len(self.devices) * self.world

    @property
    def spans_processes(self) -> bool:
        return self.world > 1

    @property
    def local_shards(self) -> range:
        """The mesh indices of this process's shards."""
        start = self.rank * len(self.devices)
        return range(start, start + len(self.devices))

    def __repr__(self) -> str:
        return (f"Mesh({[str(d) for d in self.devices]}, {self.axis_names[0]!r}, "
                f"rank {self.rank} of {self.world})")

    def all_gather(self, shards: Sequence[torch.Tensor]) -> torch.Tensor:
        """The mesh's shards of one result, concatenated along dim 0 in
        mesh order, on self.device: one collective (jax.lax.all_gather with
        tiled=True). shards: this process's, one tensor a local shard, all
        of one shape and dtype across every process.

        In one process the shards are concatenated on the first device. A
        group that spans processes makes one collective of its backend:
        NCCL gathers on the card (all_gather_into_tensor). Gloo documents
        CUDA tensors only for broadcast and all_reduce, so for a gloo group
        this process's block moves to the host here, and nowhere else, is
        gathered there, and the result moves back to self.device: the
        gather of a few small per-shard tables, while the work on either
        side of it stays on the device."""
        self.collectives += 1
        local = torch.cat([s.to(self.device) for s in shards])
        if self.group is None:
            return local
        import torch.distributed as dist

        if self.backend == "nccl":
            out = torch.empty((self.world * local.shape[0],) + tuple(local.shape[1:]), dtype=local.dtype,
                              device=self.device)
            dist.all_gather_into_tensor(out, local.contiguous(), group=self.group)
            return out
        host = local.cpu()
        parts = [torch.empty_like(host) for _ in range(self.world)]
        dist.all_gather(parts, host, group=self.group)
        return torch.cat(parts).to(self.device)
