"""Server-to-uplink federation: batched sensor upload with recovery
(counterpart of hectorgrapher_tpu/cloud/uploader.py; host and gRPC only).

(ref: cartographer/cloud/internal/local_trajectory_uploader.{h,cc} — a
background thread drains a queue of sensor data into batched
AddSensorDataBatch RPCs against the uplink server; on channel failure it
buffers and runs TryRecovery (reconnect + re-create the uplink
trajectory) before resuming.)
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List, Optional

import grpc

from hectorgrapher_tpu_torch.cloud import wire
from hectorgrapher_tpu_torch.cloud.server import CHANNEL_OPTIONS, SERVICE


class LocalTrajectoryUploader:
    BATCH_SIZE = 10  # (ref: local_trajectory_uploader.cc kBatchSize)
    POP_TIMEOUT = 0.1
    RECOVERY_INTERVAL = 0.5

    def __init__(self, uplink_address: str):
        self._address = uplink_address
        self._channel: Optional[grpc.Channel] = None
        self._queue: "queue.Queue" = queue.Queue()
        self._shutdown = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._local_to_uplink_trajectory: Dict[int, int] = {}
        self._pending_trajectories: Dict[int, None] = {}
        self._inflight_batch = False  # worker holds dequeued-but-unsent items
        self.num_batches_uploaded = 0
        self.num_recoveries = 0

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self._process_queue, daemon=True)
        self._thread.start()

    def shutdown(self) -> None:
        self._shutdown.set()
        if self._thread:
            self._thread.join(timeout=10.0)
        if self._channel:
            self._channel.close()

    def wait_until_idle(self, timeout: float = 10.0) -> None:
        deadline = time.monotonic() + timeout
        while (
            not self._queue.empty() or self._inflight_batch
        ) and time.monotonic() < deadline:
            time.sleep(0.02)

    # -- API used by the serving MapBuilderServer --------------------------

    def add_trajectory(self, local_trajectory_id: int) -> None:
        self._pending_trajectories[local_trajectory_id] = None

    def enqueue_sensor_data(self, local_trajectory_id: int, kind: str, payload) -> None:
        self._queue.put((local_trajectory_id, kind, payload))

    # -- internals ---------------------------------------------------------

    def _call(self, method: str, request: dict):
        if self._channel is None:
            self._channel = grpc.insecure_channel(self._address, options=CHANNEL_OPTIONS)
        fn = self._channel.unary_unary(
            f"/{SERVICE}/{method}",
            request_serializer=wire.dumps,
            response_deserializer=wire.loads,
        )
        return fn(request, timeout=5.0)

    def _ensure_trajectories(self) -> None:
        for local_id in list(self._pending_trajectories):
            # Uplink trajectories ingest local-SLAM RESULTS, not raw range
            # data — the uplink must not build a local trajectory builder
            # (ref: local_trajectory_uploader.cc AddTrajectory announces a
            # LOCAL_SLAM_RESULT sensor id; map_builder.cc:126-133).
            uplink_id = self._call("AddTrajectory", {"local_slam_results": True})["trajectory_id"]
            self._local_to_uplink_trajectory[local_id] = uplink_id
            del self._pending_trajectories[local_id]

    def _try_recovery(self) -> bool:
        """(ref: local_trajectory_uploader.cc TryRecovery — reconnect and
        re-register trajectories)."""
        try:
            if self._channel:
                self._channel.close()
            self._channel = None
            # All known trajectories must exist on the (possibly new) uplink.
            for local_id in list(self._local_to_uplink_trajectory):
                self._pending_trajectories[local_id] = None
            self._ensure_trajectories()
            self.num_recoveries += 1
            return True
        except Exception:
            return False

    def _process_queue(self) -> None:
        batch: List = []

        def send(batch):
            self._ensure_trajectories()
            items = [
                {
                    "trajectory_id": self._local_to_uplink_trajectory[tid],
                    "kind": kind,
                    "payload": payload,
                }
                for tid, kind, payload in batch
                if tid in self._local_to_uplink_trajectory
            ]
            self._call("AddSensorDataBatch", {"items": items})
            self.num_batches_uploaded += 1

        while not self._shutdown.is_set():
            try:
                item = self._queue.get(timeout=self.POP_TIMEOUT)
                batch.append(item)
                self._inflight_batch = True
                self._queue.task_done()
            except queue.Empty:
                pass
            if not batch:
                continue
            if len(batch) < self.BATCH_SIZE and not self._queue.empty():
                continue  # keep batching
            try:
                send(batch)
                batch = []
                self._inflight_batch = False
            except Exception:
                # Buffer and retry after recovery (bounded backoff).
                time.sleep(self.RECOVERY_INTERVAL)
                self._try_recovery()
        if batch:
            # Final flush on shutdown: one attempt, then surface the loss
            # instead of silently dropping the trajectory tail.
            try:
                send(batch)
            except Exception:
                import logging

                logging.getLogger(__name__).warning(
                    "uplink shutdown dropped %d unsent sensor items", len(batch)
                )
