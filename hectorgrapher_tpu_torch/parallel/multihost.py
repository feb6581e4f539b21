"""Multi-process distribution: the bootstrap of the solver plane
(counterpart of hectorgrapher_tpu/parallel/multihost.py).

The reference distributes across machines with gRPC only: robots upload
to one MapBuilderServer process that owns the whole pose graph (ref:
cloud/internal/map_builder_server.cc). As in the JAX package, the port
splits two planes:

  * the SENSOR plane (host side): each host runs the gRPC edge
    (cloud/server.py) for its robots; ingestion, collation and local SLAM
    stay host-local, the reference's topology;
  * the SOLVER plane (device side): the sharded SPA and constraint search
    (parallel/sharded.py, parallel/constraint_search.py) run over a Mesh
    that spans every process's shards, the leader's pose graph driving
    them and each follower entering the same programs
    (cloud/solver_plane.py).

Every process calls initialize_process (one coordinator address, a
process id each) before it touches a device; global_mesh() then returns
the Mesh over every process's shards. Nothing downstream cares whether a
Mesh spans processes. No cluster is discovered: the caller gives the
coordinator's address (tcp://host:port), the world size and the rank.
"""

from __future__ import annotations

import datetime
from typing import Optional, Sequence

import torch

from hectorgrapher_tpu_torch.parallel.mesh import Mesh

# The shard devices this process contributes to global_mesh(), set by
# initialize_process (one process-wide group, as jax.distributed's).
_PROCESS_DEVICES: Optional[tuple] = None


def initialize_process(coordinator_address: str, num_processes: int, process_id: int, device="cuda",
                       backend: Optional[str] = None, timeout_s: float = 300.0, **kwargs) -> None:
    """Join the process group: torch.distributed.init_process_group at
    tcp://coordinator_address, one call a process, before any collective.
    device: this process's shard device (a CUDA device, one process a
    card, unless the caller asks for the CPU); backend: "nccl" for a CUDA
    device, "gloo" for the CPU, unless named. Every collective of the
    group fails after timeout_s seconds instead of waiting forever (with
    NCCL, through its asynchronous error handling)."""
    import torch.distributed as dist

    global _PROCESS_DEVICES
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    dist.init_process_group(backend=backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    _PROCESS_DEVICES = (device,)


def global_mesh(axis: str = "graph", devices: Optional[Sequence] = None) -> Mesh:
    """The Mesh over every process's shards. devices: this process's
    shards (every process must give as many); by default the device given
    to initialize_process, or the first CUDA card when this process joined
    no group. Without a group of two or more processes this is the
    single-process mesh the rest of parallel/ uses."""
    import torch.distributed as dist

    if devices is None:
        devices = _PROCESS_DEVICES or (torch.device("cuda"),)
    group = dist.group.WORLD if dist.is_initialized() and dist.get_world_size() > 1 else None
    return Mesh(devices, group=group, axis=axis)


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def local_device_slice(global_batch: int) -> slice:
    """The rows of a leading batch axis this process feeds."""
    count = process_count()
    if global_batch % count != 0:
        raise ValueError(f"global batch {global_batch} not divisible by process count {count} — pad the batch "
                         "(rows would be silently dropped)")
    per = global_batch // count
    start = process_index() * per
    return slice(start, start + per)
