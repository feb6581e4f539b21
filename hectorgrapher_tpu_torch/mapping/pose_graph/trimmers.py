"""Submap trimming for the pose graph (counterpart of
hectorgrapher_tpu/mapping/pose_graph/trimmers.py: trim_submaps,
PureLocalizationTrimmer and OverlappingSubmapsTrimmer2D; ref:
cartographer/mapping/pose_graph_trimmer.{h,cc}, Trimmable::TrimSubmap and
PureLocalizationTrimmer, pose_graph_trimmer.h:69-75;
internal/2d/overlapping_submaps_trimmer_2d.{h,cc}).

trim_submaps serves delete_trajectory and the trimmers, which the pose
graph runs after each optimization (pose_graph.trimmers).
"""

from __future__ import annotations

from typing import Set

import numpy as np


def trim_submaps(pose_graph, submap_indices: Set[int]) -> None:
    """Remove submaps, the constraints touching them, then the nodes left
    without a constraint; remap the positional indices and rebuild the
    stable-id maps, through which queued work items resolve their node
    and submap (or find them gone). Then the pose graph drops what it
    caches of the removed submaps (its _forget_submaps hook: matchers,
    packs). The caller holds the graph's locks."""
    if not submap_indices:
        return
    keep_submaps = [i for i in range(len(pose_graph.submaps)) if i not in submap_indices]
    submap_remap = {old: new for new, old in enumerate(keep_submaps)}
    pose_graph.constraints = [c for c in pose_graph.constraints if c.submap_index not in submap_indices]
    nodes_with_constraints = {c.node_index for c in pose_graph.constraints}
    keep_nodes = [i for i in range(len(pose_graph.nodes)) if i in nodes_with_constraints]
    node_remap = {old: new for new, old in enumerate(keep_nodes)}
    for c in pose_graph.constraints:
        c.submap_index = submap_remap[c.submap_index]
        c.node_index = node_remap[c.node_index]
    removed = [pose_graph.submaps[i] for i in submap_indices]
    pose_graph.submaps = [pose_graph.submaps[i] for i in keep_submaps]
    pose_graph.nodes = [pose_graph.nodes[i] for i in keep_nodes]
    for s in removed:
        pose_graph._submap_ids.pop(id(s.submap), None)
    for new_i, s in enumerate(pose_graph.submaps):
        pose_graph._submap_ids[id(s.submap)] = new_i
    pose_graph._node_index_by_id = {n.node_id: i for i, n in enumerate(pose_graph.nodes)}
    pose_graph._submap_index_by_id = {s.submap_id: i for i, s in enumerate(pose_graph.submaps)}
    pose_graph._forget_submaps({s.submap_id for s in removed})


class PureLocalizationTrimmer:
    """Keep only the last max_submaps_to_keep submaps of a trajectory
    (trimmers.py :89-111; ref: pose_graph_trimmer.h:69-75)."""

    def __init__(self, trajectory_id: int, max_submaps_to_keep: int):
        if max_submaps_to_keep < 2:
            raise ValueError(f"max_submaps_to_keep={max_submaps_to_keep}: at least 2")
        self.trajectory_id = trajectory_id
        self.max_submaps_to_keep = max_submaps_to_keep
        self._finished = False

    def trim(self, pose_graph) -> None:
        if self._finished:
            return
        own = [i for i, s in enumerate(pose_graph.submaps) if s.trajectory_id == self.trajectory_id]
        excess = len(own) - self.max_submaps_to_keep
        if excess > 0:
            trim_submaps(pose_graph, set(own[:excess]))

    def is_finished(self) -> bool:
        return self._finished


class OverlappingSubmapsTrimmer2D:
    """Trim old finished submaps whose area no fresher submap covers falls
    below min_covered_area (trimmers.py :115-166; ref:
    internal/2d/overlapping_submaps_trimmer_2d.cc): per coarse cell of the
    global frame the freshest finished submap that knows it; the
    fresh_submaps_count freshest are kept, and a trim waits for
    min_added_submaps_count new submaps. Reads each submap's known cells
    back to the host."""

    def __init__(self, fresh_submaps_count: int, min_covered_area: float, min_added_submaps_count: int):
        self.fresh_submaps_count = fresh_submaps_count
        self.min_covered_area = min_covered_area
        self.min_added_submaps_count = min_added_submaps_count
        self._current_submap_count = 0

    def trim(self, pose_graph, coverage_resolution: float = 0.5) -> None:
        finished = [(i, s) for i, s in enumerate(pose_graph.submaps) if s.finished]
        if len(finished) <= self.fresh_submaps_count:
            return
        if len(pose_graph.submaps) - self._current_submap_count < self.min_added_submaps_count:
            return
        cells_of = [self._covered_cells(s, coverage_resolution) for _, s in finished]
        coverage = {}
        for order, cells in enumerate(cells_of):
            for c in cells:
                coverage[c] = max(order, coverage.get(c, order))
        to_trim = set()
        for order, (i, _) in enumerate(finished[: -self.fresh_submaps_count]):
            unique = sum(1 for c in cells_of[order] if coverage.get(c) == order)
            if unique * coverage_resolution**2 < self.min_covered_area:
                to_trim.add(i)
        if to_trim:
            trim_submaps(pose_graph, to_trim)
            self._current_submap_count = len(pose_graph.submaps)

    @staticmethod
    def _covered_cells(pg_submap, resolution: float):
        """The coarse global cells of the submap's known cells: the grid's
        cell centres in the local frame, moved by the submap's global
        minus local translation (the JAX package's shift), floored at
        `resolution`."""
        grid = pg_submap.submap.grid
        idx = np.argwhere(grid.known.cpu().numpy())
        if not len(idx):
            return set()
        min_corner = grid.meta.min_corner.cpu().numpy()
        res = float(grid.meta.resolution)
        world = min_corner[None, :] + (idx + 0.5) * res
        world = world + (pg_submap.global_pose.t[:2] - pg_submap.submap.local_pose.t[:2])[None, :]
        cells = np.floor(world / resolution).astype(np.int64)
        return {(int(a), int(b)) for a, b in cells}
