"""Cross-trajectory batched CT window serving (counterpart of
hectorgrapher_tpu/cloud/ct_batcher.py).

The reference's multi-robot MapBuilderServer runs one SLAM thread that
processes sensor items FIFO, so each trajectory's continuous-time window
solves run one after another (ref: cloud/internal/map_builder_server.cc
ProcessSensorDataQueue:157-176). This batcher puts solve_ct_window_batched
on the serving path: the SLAM loop advances each trajectory on its own
worker thread (per-trajectory order kept, the guarantee the reference's
TrajectoryCollator gives and no stronger one), and when every live worker
is blocked inside a window solve, solves the compatible pending windows
in one batched solve, each LM iteration one slotted K3 launch for all of
them. Windows that cannot share a solve (grid type, storage dtype or
shapes, problem shapes, iteration count, weights, mode, DIRECT payload
shapes) go to the serial solver, unchanged. Grids are passed as one list
per batch, not stacked: the batched solve reads a grid that several
windows share once (window_slots).

With a mesh (a Mesh of this process's shards) the batch is sharded over
it (parallel/ct_windows.py): padded to a multiple of the shard count by
repeating lane 0, each shard solving its lanes, the pad lanes dropped.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List

import torch

from hectorgrapher_tpu_torch.mapping.ct import window_solver
from hectorgrapher_tpu_torch.mapping.ct.window_solver import CtProblem, CtState, DirectImuData
from hectorgrapher_tpu_torch.mapping.grids import TSDFGrid


def _grid_key(grid) -> tuple:
    """A prepared grid's type, storage dtype and shape: what
    solve_ct_window_batched requires to agree across windows."""
    plane = grid.tsd if isinstance(grid, TSDFGrid) else grid.prob
    return type(grid).__name__, plane.dtype, tuple(plane.shape)


def _leaf_shapes(tree) -> tuple:
    return tuple(tuple(leaf.shape) for leaf in tree)


def _batch_key(p) -> tuple:
    """Solves sharing this key run in one solve_ct_window_batched (the
    weights are shared across the batch by that function's contract).
    Reads the weights back from the card: one sync a request."""
    return (
        _grid_key(p.high_grid),
        _grid_key(p.low_grid),
        _leaf_shapes(p.problem),
        p.is_tsdf,
        p.num_iterations,
        tuple(torch.stack(tuple(p.weights)).tolist()),
        bool(p.per_point),
        # DIRECT payloads batch when their leaf shapes agree; a window with
        # one and a window without never share a solve.
        _leaf_shapes(p.direct) if p.direct is not None else None,
    )


def _stack(trees, cls):
    return cls(*(torch.stack(leaves) for leaves in zip(*trees)))


class CtWindowBatcher:
    """Coordinator and per-builder solve hook (see the module docstring).

    Usage: `install(ct_builder)` per trajectory; `begin(n)`, run each
    trajectory's sensor items on its own thread ending with `finish()`;
    the coordinating thread calls `serve()` until every worker finished.
    The server (cloud/server.py, batch_ct_windows) wires this into its
    SLAM loop."""

    def __init__(self, mesh=None):
        self._mesh = mesh
        self._cv = threading.Condition()
        self._requests: List[dict] = []
        self._active_workers = 0
        self._blocked = 0
        self._dead = None  # set by fail_pending: later solves fail fast
        # What the server batched: launches of the batched solve, solves
        # that ran alone, and the size of each batch.
        self.batched_launches = 0
        self.serial_solves = 0
        self.batch_sizes: List[int] = []

    def install(self, builder) -> None:
        builder.window_solve_fn = self._solve

    # -- worker side ---------------------------------------------------------

    def begin(self, n: int) -> None:
        """Register n workers before starting their threads (serve() would
        otherwise see no active worker and return at once)."""
        with self._cv:
            self._active_workers += n

    def finish(self) -> None:
        """Called by each worker thread when its items are done."""
        with self._cv:
            self._active_workers -= 1
            self._cv.notify_all()

    def _solve(self, pending):
        """The builder's hook, on a worker thread: queue the request and
        block until the coordinator solved it."""
        entry = {"pending": pending, "event": threading.Event(), "solved": None, "error": None}
        with self._cv:
            if self._dead is not None:
                raise self._dead
            self._requests.append(entry)
            self._blocked += 1
            self._cv.notify_all()
        entry["event"].wait()
        with self._cv:
            self._blocked -= 1
        if entry["error"] is not None:
            raise entry["error"]
        return entry["solved"]

    def fail_pending(self, error: Exception) -> None:
        """Abort every queued or blocked solve with `error` (the server's
        recovery when serve() dies: blocked workers must wake and finish
        their items, or every RPC joining the sensor queue hangs)."""
        with self._cv:
            self._dead = error
            pending = self._requests
            self._requests = []
        for entry in pending:
            entry["error"] = error
            entry["event"].set()

    # -- coordinator side ----------------------------------------------------

    def serve(self, timeout: float = 300.0) -> None:
        """Run on the coordinating (SLAM) thread until every worker
        exited: whenever all live workers are blocked on solves, flush the
        pending batch. `timeout` bounds time without progress (a flush, a
        new request or a worker exiting resets it): a fixed overall
        deadline would fire on long but healthy drains."""
        last_progress = time.monotonic()
        progress_marker = (0, 0, 0)
        with self._cv:
            while self._active_workers > 0:
                marker = (self._active_workers, self._blocked, len(self._requests))
                if marker != progress_marker:
                    progress_marker = marker
                    last_progress = time.monotonic()
                ready = (
                    self._blocked > 0
                    and len(self._requests) >= self._blocked
                    and self._blocked >= self._active_workers
                )
                if not ready:
                    if not self._cv.wait(timeout=1.0) and time.monotonic() - last_progress > timeout:
                        raise RuntimeError("ct batcher stalled")
                    continue
                batch = self._requests
                self._requests = []
                last_progress = time.monotonic()
                self._cv.release()
                try:
                    self._flush(batch)
                finally:
                    self._cv.acquire()

    def _flush(self, batch: List[dict]) -> None:
        groups: Dict[tuple, List[dict]] = {}
        for entry in batch:
            groups.setdefault(_batch_key(entry["pending"]), []).append(entry)
        serial = []
        for entries in groups.values():
            if len(entries) == 1:
                serial.extend(entries)
                continue
            try:
                self._solve_batched(entries)
            except Exception as e:  # noqa: BLE001 - reported to the waiting workers
                for entry in entries:
                    entry["error"] = e
                    entry["event"].set()
        for entry in serial:
            p = entry["pending"]
            try:
                entry["solved"], _, _ = window_solver.solve_ct_window(
                    p.high_grid, p.low_grid, p.problem, p.state0, p.weights, is_tsdf=p.is_tsdf,
                    num_iterations=p.num_iterations, per_point=p.per_point, direct=p.direct)
                self.serial_solves += 1
            except Exception as e:  # noqa: BLE001 - reported to the waiting worker
                entry["error"] = e
            entry["event"].set()

    def _solve_batched(self, entries: List[dict]) -> None:
        ps = [e["pending"] for e in entries]
        if self._mesh is not None:
            # Pad to a multiple of the shard count by repeating lane 0: the
            # solves are independent, and the pad lanes are dropped below.
            ps = ps + [ps[0]] * (-len(ps) % self._mesh.size)
        directs = _stack([p.direct for p in ps], DirectImuData) if ps[0].direct is not None else None
        args = ([p.high_grid for p in ps], [p.low_grid for p in ps], _stack([p.problem for p in ps], CtProblem),
                _stack([p.state0 for p in ps], CtState), ps[0].weights)
        kwargs = dict(is_tsdf=ps[0].is_tsdf, num_iterations=ps[0].num_iterations, per_point=bool(ps[0].per_point),
                      directs=directs)
        if self._mesh is not None:
            from hectorgrapher_tpu_torch.parallel.ct_windows import solve_ct_windows_sharded

            solved, _, _ = solve_ct_windows_sharded(self._mesh, *args, **kwargs)
        else:
            solved, _, _ = window_solver.solve_ct_window_batched(*args, **kwargs)
        self.batched_launches += 1
        self.batch_sizes.append(len(entries))
        for i, entry in enumerate(entries):
            entry["solved"] = CtState(*(leaf[i] for leaf in solved))
            entry["event"].set()
