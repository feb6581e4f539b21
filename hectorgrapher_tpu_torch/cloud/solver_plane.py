"""Multi-process solver plane: leader / follower execution of the sharded
solves (counterpart of hectorgrapher_tpu/cloud/solver_plane.py).

Every process joins one torch.distributed group
(parallel/multihost.py initialize_process) and contributes its shards to
the global Mesh. The gRPC sensor edge and the pose graph's host state
live on the LEADER process, the reference's uplink-server role (ref:
cloud/internal/map_builder_server.cc:157-176: one process owns the
global pose graph), while every FOLLOWER process runs a SolverPlane
service that runs the same sharded work whenever the leader reaches it,
so that the collectives of the mesh meet on every process.

Ops (every collective the pose graph's back end makes):
  spa2d / spa3d        the sharded SPA solves (payload: the problem with
                       numpy leaves, the iteration count)
  cs2d_pack / cs3d_pack extend the follower's packs of finished-submap
                       search state (payload: the full slot order and the
                       host arrays of newly shipped submaps; finished
                       grids do not change, so each ships once)
  cs2d / cs3d          one batched loop-closure round (payload: the very
                       candidate arrays the leader launches with)

Payloads are numpy only: the wire (cloud/wire.py) refuses a pickled
tensor. Each process builds its own shards' tensors from them.

Order: ops carry a sequence number from the leader, and the follower runs
them strictly in sequence. Two gRPC handler threads must never enter
collectives in another order than the leader's, or the processes wait on
each other's collectives forever.
"""

from __future__ import annotations

import threading
import time
import traceback
from concurrent import futures
from typing import List, Optional

from hectorgrapher_tpu_torch.cloud import wire

SERVICE = "hectorgrapher.SolverPlane"


class _PackState:
    """A follower's mirror of one of the leader's packs
    (PoseGraph2D._packs2d[depth] / PoseGraph3D._pack3d)."""

    def __init__(self):
        self.host = {}  # submap id -> host arrays
        self.order: List[int] = []
        self.packed = None
        self.meta = {}


class SolverState:
    """What a follower keeps between ops: its packs, and the mesh it runs
    them over (the global mesh unless given)."""

    def __init__(self, mesh=None):
        self.pack2d: dict = {}  # depth -> _PackState (local-window and full-submap rounds differ in depth)
        self.pack3d = _PackState()
        self._mesh = mesh

    @property
    def mesh(self):
        if self._mesh is None:
            from hectorgrapher_tpu_torch.parallel.multihost import global_mesh

            self._mesh = global_mesh()
        return self._mesh


def _sync(mesh) -> None:
    import torch

    for device in set(mesh.devices):
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def execute_op(op: str, payload, state: SolverState) -> None:
    """Run one solver-plane op over state.mesh: the leader runs the same
    work through its pose graph, a follower here."""
    mesh = state.mesh
    if op == "spa2d":
        from hectorgrapher_tpu_torch.parallel.sharded import solve_spa_2d_sharded

        problem, iters = payload
        solve_spa_2d_sharded(problem, mesh, num_iterations=iters)
    elif op == "spa3d":
        from hectorgrapher_tpu_torch.parallel.sharded import solve_spa_3d_sharded

        problem, iters = payload
        solve_spa_3d_sharded(problem, mesh, num_iterations=iters)
    elif op == "cs2d_pack":
        from hectorgrapher_tpu_torch.parallel.constraint_search import pack_submaps_2d_from_arrays

        st = state.pack2d.setdefault(payload["depth"], _PackState())
        st.host.update(payload["new"])
        st.order = list(payload["order"])
        st.host = {sid: st.host[sid] for sid in st.order}
        st.meta = {"res": payload["res"], "dims": tuple(payload["dims"])}
        st.packed = pack_submaps_2d_from_arrays([(st.host[sid]["levels"], st.host[sid]["mc"]) for sid in st.order],
                                                st.meta["res"], st.meta["dims"], mesh)
    elif op == "cs2d":
        from hectorgrapher_tpu_torch.mapping.scan_matching.fast_correlative_2d import FastSearchConfig
        from hectorgrapher_tpu_torch.parallel.constraint_search import launch_fast_matches_2d

        st = state.pack2d.get(payload["depth"])
        if st is None or st.packed is None:
            raise RuntimeError("cs2d before any cs2d_pack at this depth")
        launch_fast_matches_2d(st.packed, payload["arrays"], FastSearchConfig(*payload["config"]))
    elif op == "cs3d_pack":
        from hectorgrapher_tpu_torch.parallel.constraint_search import pack_submaps_3d_from_arrays

        st = state.pack3d
        st.host.update(payload["new"])
        st.order = list(payload["order"])
        st.host = {sid: st.host[sid] for sid in st.order}
        st.packed = pack_submaps_3d_from_arrays([st.host[sid] for sid in st.order], mesh)
    elif op == "cs3d":
        from hectorgrapher_tpu_torch.mapping.scan_matching.fast_correlative_3d import FastSearch3DConfig
        from hectorgrapher_tpu_torch.parallel.constraint_search import launch_fast_matches_3d

        if state.pack3d.packed is None:
            raise RuntimeError("cs3d before any cs3d_pack")
        launch_fast_matches_3d(state.pack3d.packed, payload["arrays"], FastSearch3DConfig(*payload["config"]),
                               use_rotational=bool(payload["use_rotational"]))
    else:
        raise ValueError(f"unknown solver-plane op {op!r}")
    _sync(mesh)


class SolverPlaneFollower:
    """The gRPC service every other process runs: it runs the leader's
    ops so that the mesh's collectives complete. `import grpc` happens
    here, not at import. mesh: the follower's mesh (the global mesh unless
    given)."""

    def __init__(self, address: str = "127.0.0.1:0", mesh=None, seq_timeout_s: float = 300.0):
        import grpc

        from hectorgrapher_tpu_torch.cloud.server import CHANNEL_OPTIONS

        self._shutdown = threading.Event()
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=4), options=CHANNEL_OPTIONS)
        self._state = SolverState(mesh)
        # Strict sequence order (see the module docstring): a handler
        # thread waits its turn, so that collectives start in the leader's
        # order.
        self._seq_cv = threading.Condition(threading.Lock())
        self._next_seq = 0
        self.executed: List[str] = []  # the ops run, in order

        def execute(request, context):
            op, seq, payload = request
            if op == "shutdown":
                self._shutdown.set()
                return True
            with self._seq_cv:
                if not self._seq_cv.wait_for(lambda: seq == self._next_seq, timeout=seq_timeout_s):
                    raise RuntimeError(f"solver-plane sequence stall: waiting for {self._next_seq}, got {seq}")
                try:
                    execute_op(op, payload, self._state)
                    self.executed.append(op)
                except Exception:
                    # In the follower's log too: the leader sees the error
                    # only at its next call, and a silent failure reads as
                    # a hung mesh.
                    traceback.print_exc()
                    raise
                finally:
                    self._next_seq = seq + 1
                    self._seq_cv.notify_all()
            return True

        handler = grpc.unary_unary_rpc_method_handler(execute, request_deserializer=wire.loads,
                                                      response_serializer=wire.dumps)
        self._server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(SERVICE, {"Execute": handler}),))
        self.port = self._server.add_insecure_port(address)

    def start(self) -> "SolverPlaneFollower":
        self._server.start()
        return self

    def wait_for_shutdown(self, timeout: Optional[float] = None) -> bool:
        done = self._shutdown.wait(timeout)
        if done:
            self._server.stop(grace=1.0)
        return done


class SolverPlaneLeader:
    """The leader pose graph's `broadcast` hook (set_solver_mesh): ships
    each op's payload to every follower, then the caller runs the same
    work itself, and all processes meet in its collectives. `import grpc`
    happens here, not at import. collect_stats: record each op's count,
    payload bytes and the milliseconds until each follower acknowledged
    it (measuring the bytes serializes the payload a second time).
    wait_timeout_s bounds each op's round trip, a follower's start-up
    included."""

    def __init__(self, follower_addresses: List[str], collect_stats: bool = False, wait_timeout_s: float = 300.0):
        import grpc

        from hectorgrapher_tpu_torch.cloud.server import CHANNEL_OPTIONS

        self._wait_timeout_s = wait_timeout_s
        self._channels = [grpc.insecure_channel(addr, options=CHANNEL_OPTIONS) for addr in follower_addresses]
        self._calls = [channel.unary_unary(f"/{SERVICE}/Execute", request_serializer=wire.dumps,
                                           response_deserializer=wire.loads) for channel in self._channels]
        self._seq = 0
        self._pending: List[object] = []
        self.stats: Optional[dict] = {} if collect_stats else None

    def __call__(self, op: str, payload, wait: bool = False) -> None:
        """Fire and proceed: the caller enters its own work at once, and a
        follower joins when the RPC lands. An earlier op's failure on a
        follower is raised here (RuntimeError): a dead follower would
        otherwise hang the mesh silently. Futures in flight are kept until
        they complete, because gRPC cancels an RPC whose call object is
        collected: a dropped pack op would leave the follower waiting for
        its sequence number.

        wait=True blocks until every follower has run the op, for the pack
        ops: a pack failure on a follower must surface here, before the
        round whose collective it would otherwise hang."""
        still = []
        for f in self._pending:
            if f.done():
                exc = f.exception(timeout=0)
                if exc is not None:
                    raise RuntimeError(f"solver-plane follower failed: {exc}")
            else:
                still.append(f)
        seq = self._seq
        self._seq += 1
        st = None
        if self.stats is not None:
            st = self.stats.setdefault(op, {"count": 0, "bytes": 0, "ack_ms": []})
            st["count"] += 1
            st["bytes"] += len(wire.dumps((op, seq, payload)))
        t0 = time.perf_counter()
        # wait_for_ready: an op sent before a follower's server is up waits
        # for it, instead of failing while the caller enters the collective.
        futures_now = [call.future((op, seq, payload), timeout=self._wait_timeout_s, wait_for_ready=True)
                       for call in self._calls]
        if wait:
            for f in futures_now:
                try:
                    f.result(timeout=self._wait_timeout_s)
                except Exception as exc:  # noqa: BLE001 - any follower failure ends the mesh's work
                    raise RuntimeError(f"solver-plane follower failed on {op}: {exc}") from exc
                # Here, not in a done callback: gRPC runs those after
                # result() has returned, so the op's stats could lag it.
                if st is not None:
                    st["ack_ms"].append((time.perf_counter() - t0) * 1e3)
        else:
            if st is not None:
                for f in futures_now:
                    f.add_done_callback(
                        lambda _f, st=st, t0=t0: st["ack_ms"].append((time.perf_counter() - t0) * 1e3))
            still.extend(futures_now)
        self._pending = still

    def shutdown(self) -> None:
        """Wait for the ops in flight, tell every follower to stop, close
        the channels."""
        for f in self._pending:
            try:
                f.result(timeout=30)
            except Exception:  # noqa: BLE001 - shutting down; the op's error was the follower's to log
                pass
        for call in self._calls:
            try:
                call(("shutdown", 0, None), timeout=10)
            except Exception:  # noqa: BLE001 - a follower already gone needs no shutdown
                pass
        for channel in self._channels:
            channel.close()
