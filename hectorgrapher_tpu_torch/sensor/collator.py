"""Sensor collation: time-ordered merge across sensor queues (counterpart
of hectorgrapher_tpu/sensor/collator.py, host only).

(ref: cartographer/sensor/internal/ordered_multi_queue.{h,cc} — per
(trajectory, sensor) queues; Dispatch pops the globally lowest timestamp
only once every unfinished queue has at least one element, so callbacks
see a single monotonic time series; internal/collator.h — one
OrderedMultiQueue across all trajectories; internal/trajectory_collator.h
— independent per-trajectory queues for multi-robot servers.)

Host-side: this is the streaming front door; the heavy per-scan work the
callbacks trigger runs on the card. The queue core is the JAX package's
pure-Python one: the package's optional C++ core (hectorgrapher_tpu/
native) is a host queue, not a card kernel, and is not loaded here, so
is_native is False.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, Dict, List, Optional, Tuple


@dataclass(frozen=True)
class QueueKey:
    """(ref: ordered_multi_queue.h QueueKey)"""

    trajectory_id: int
    sensor_id: str


@dataclass
class _TimedItem:
    time: float
    data: object


class _PurePythonMultiQueue:
    """The queue core: per-queue deques, merged by lowest head time."""

    def __init__(self):
        self._queues: List[Deque[_TimedItem]] = []
        self._finished: List[bool] = []
        self._last_dispatched_time: Optional[float] = None

    def add_queue(self) -> int:
        self._queues.append(deque())
        self._finished.append(False)
        return len(self._queues) - 1

    def add(self, qid: int, time: float, data: object) -> None:
        self._queues[qid].append(_TimedItem(time, data))

    def mark_finished(self, qid: int) -> None:
        self._finished[qid] = True

    def blocker(self) -> Optional[int]:
        for i, q in enumerate(self._queues):
            if not q and not self._finished[i]:
                return i
        return None

    def dispatch(self):
        out = []
        while True:
            best = None
            best_time = None
            blocked = False
            for i, q in enumerate(self._queues):
                if not q:
                    if not self._finished[i]:
                        blocked = True
                        break
                    continue
                t = q[0].time
                if best_time is None or t < best_time:
                    best_time = t
                    best = i
            if blocked or best is None:
                break
            item = self._queues[best].popleft()
            if self._last_dispatched_time is not None and item.time < self._last_dispatched_time - 1e-9:
                continue  # drop stale data (reference warns + skips)
            self._last_dispatched_time = item.time
            out.append((best, item.time, item.data))
        return out


class OrderedMultiQueue:
    """(ref: ordered_multi_queue.h:44-99)."""

    def __init__(self):
        self._core = _PurePythonMultiQueue()
        self._key_to_id: Dict[QueueKey, int] = {}
        self._id_to_key: Dict[int, QueueKey] = {}
        self._callbacks: Dict[int, Callable[[float, object], None]] = {}

    @property
    def is_native(self) -> bool:
        return False

    def add_queue(self, key: QueueKey, callback: Callable[[float, object], None]) -> None:
        assert key not in self._key_to_id
        qid = self._core.add_queue()
        self._key_to_id[key] = qid
        self._id_to_key[qid] = key
        self._callbacks[qid] = callback

    def mark_queue_as_finished(self, key: QueueKey) -> None:
        self._core.mark_finished(self._key_to_id[key])
        self.dispatch()

    def add(self, key: QueueKey, time: float, data: object) -> None:
        assert key in self._key_to_id, f"unknown queue {key}"
        self._core.add(self._key_to_id[key], time, data)
        self.dispatch()

    def flush(self) -> None:
        """(ref: OrderedMultiQueue::Flush — finish all queues)"""
        for key in list(self._key_to_id):
            self._core.mark_finished(self._key_to_id[key])
        self.dispatch()

    def get_blocker(self) -> Optional[QueueKey]:
        """The queue currently preventing dispatch (ref: GetBlocker)."""
        qid = self._core.blocker()
        return self._id_to_key[qid] if qid is not None else None

    def dispatch(self) -> None:
        for qid, time, data in self._core.dispatch():
            self._callbacks[qid](time, data)


class Collator:
    """One global queue set across all trajectories (ref: collator.h:33-51)."""

    def __init__(self):
        self._queue = OrderedMultiQueue()
        self._queue_keys: Dict[int, List[QueueKey]] = {}

    def add_trajectory(
        self,
        trajectory_id: int,
        expected_sensor_ids: List[str],
        callback: Callable[[str, float, object], None],
    ) -> None:
        keys = []
        for sensor_id in expected_sensor_ids:
            key = QueueKey(trajectory_id, sensor_id)
            self._queue.add_queue(
                key, lambda t, d, s=sensor_id: callback(s, t, d)
            )
            keys.append(key)
        self._queue_keys[trajectory_id] = keys

    def finish_trajectory(self, trajectory_id: int) -> None:
        for key in self._queue_keys.get(trajectory_id, []):
            self._queue.mark_queue_as_finished(key)

    def add_sensor_data(self, trajectory_id: int, sensor_id: str, time: float, data: object) -> None:
        self._queue.add(QueueKey(trajectory_id, sensor_id), time, data)

    def flush(self) -> None:
        self._queue.flush()

    def get_blocking_trajectory_id(self) -> Optional[int]:
        blocker = self._queue.get_blocker()
        return blocker.trajectory_id if blocker else None


class TrajectoryCollator:
    """Independent per-trajectory queues (ref: trajectory_collator.h:38-48
    — no cross-trajectory blocking; for multi-robot server use)."""

    def __init__(self):
        self._queues: Dict[int, OrderedMultiQueue] = {}
        self._keys: Dict[int, List[QueueKey]] = {}

    def add_trajectory(self, trajectory_id, expected_sensor_ids, callback) -> None:
        q = OrderedMultiQueue()
        keys = []
        for sensor_id in expected_sensor_ids:
            key = QueueKey(trajectory_id, sensor_id)
            q.add_queue(key, lambda t, d, s=sensor_id: callback(s, t, d))
            keys.append(key)
        self._queues[trajectory_id] = q
        self._keys[trajectory_id] = keys

    def finish_trajectory(self, trajectory_id: int) -> None:
        for key in self._keys.get(trajectory_id, []):
            self._queues[trajectory_id].mark_queue_as_finished(key)

    def add_sensor_data(self, trajectory_id, sensor_id, time, data) -> None:
        self._queues[trajectory_id].add(QueueKey(trajectory_id, sensor_id), time, data)

    def flush(self) -> None:
        for q in self._queues.values():
            q.flush()


class MapByTime:
    """Per-trajectory time-indexed sensor storage (ref: sensor/map_by_time.h)."""

    def __init__(self):
        self._data: Dict[int, List[Tuple[float, object]]] = {}

    def append(self, trajectory_id: int, time: float, data: object) -> None:
        items = self._data.setdefault(trajectory_id, [])
        assert not items or items[-1][0] < time, "MapByTime requires increasing times"
        items.append((time, data))

    def trajectory_ids(self):
        return list(self._data.keys())

    def trajectory(self, trajectory_id: int):
        return list(self._data.get(trajectory_id, []))

    def has_trajectory(self, trajectory_id: int) -> bool:
        return trajectory_id in self._data
