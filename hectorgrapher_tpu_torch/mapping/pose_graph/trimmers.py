"""Submap trimming for the pose graph (counterpart of
hectorgrapher_tpu/mapping/pose_graph/trimmers.py :16-111: trim_submaps
and PureLocalizationTrimmer; ref: cartographer/mapping/
pose_graph_trimmer.{h,cc}, Trimmable::TrimSubmap and
PureLocalizationTrimmer, pose_graph_trimmer.h:69-75).

trim_submaps serves delete_trajectory and the trimmers, which the pose
graph runs after each optimization (pose_graph.trimmers).
OverlappingSubmapsTrimmer2D waits for PoseGraph2D.
"""

from __future__ import annotations

from typing import Set


def trim_submaps(pose_graph, submap_indices: Set[int]) -> None:
    """Remove submaps, the constraints touching them, then the nodes left
    without a constraint; remap the positional indices and rebuild the
    stable-id maps, through which queued work items resolve their node
    and submap (or find them gone). The caller holds the graph's locks.

    The batched search's pack (PoseGraph3D._pack3d) is dropped when a
    trimmed submap is a member, so that trimmed tables leave the card and
    stop counting against pack_hbm_budget_bytes; the trimmed ids leave
    its host cache and the most-recently-used record, and the pack-bytes
    gauge reads 0 until the next round packs again. The surviving
    members' matchers hold their tables on the host (to_host), so that
    rebuild only uploads, as in the JAX package."""
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

    removed_sids = {s.submap_id for s in removed}
    pack = getattr(pose_graph, "_pack3d", None)
    if pack is not None and removed_sids & set(pack["slots"]):
        from hectorgrapher_tpu_torch.mapping.pose_graph.pose_graph import _set_pack_bytes_gauge

        for sid in removed_sids:
            pack["host"].pop(sid, None)
        pose_graph._pack3d = None
        _set_pack_bytes_gauge("3d", 0)
    used = getattr(pose_graph, "_pack3d_used", None)
    if used:
        for sid in removed_sids:
            used.pop(sid, None)


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
