"""Trajectory connectivity tracking (a copy of
hectorgrapher_tpu/mapping/pose_graph/connectivity.py; host only).

(ref: cartographer/mapping/internal/connected_components.{h,cc} —
union-find over trajectory ids; internal/trajectory_connectivity_state.
{h,cc} — last-connection-time tracking used to choose local vs global
constraint search, pose_graph_3d.cc:269-283.)
"""

from __future__ import annotations

from typing import Dict, List, Optional


class ConnectedComponents:
    """(ref: connected_components.h)"""

    def __init__(self):
        self._parent: Dict[int, int] = {}

    def add(self, trajectory_id: int) -> None:
        self._parent.setdefault(trajectory_id, trajectory_id)

    def _find(self, x: int) -> int:
        self.add(x)
        root = x
        while self._parent[root] != root:
            root = self._parent[root]
        while self._parent[x] != root:
            self._parent[x], x = root, self._parent[x]
        return root

    def connect(self, a: int, b: int) -> None:
        ra, rb = self._find(a), self._find(b)
        if ra != rb:
            self._parent[ra] = rb

    def transitively_connected(self, a: int, b: int) -> bool:
        if a == b:
            return True
        return self._find(a) == self._find(b)

    def connected_components(self) -> List[List[int]]:
        groups: Dict[int, List[int]] = {}
        for t in self._parent:
            groups.setdefault(self._find(t), []).append(t)
        return [sorted(v) for v in groups.values()]


class TrajectoryConnectivityState:
    """(ref: trajectory_connectivity_state.h — connectivity + the last time
    two trajectories were connected)"""

    def __init__(self):
        self._components = ConnectedComponents()
        self._last_connection_time: Dict[frozenset, float] = {}

    def add(self, trajectory_id: int) -> None:
        self._components.add(trajectory_id)

    def connect(self, a: int, b: int, time: float) -> None:
        self._components.connect(a, b)
        key = frozenset((a, b))
        self._last_connection_time[key] = max(self._last_connection_time.get(key, -1e18), time)

    def transitively_connected(self, a: int, b: int) -> bool:
        return self._components.transitively_connected(a, b)

    def last_connection_time(self, a: int, b: int) -> Optional[float]:
        return self._last_connection_time.get(frozenset((a, b)))
