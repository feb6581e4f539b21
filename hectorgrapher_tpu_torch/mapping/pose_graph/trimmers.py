"""Submap trimming for the pose graph (counterpart of trim_submaps in
hectorgrapher_tpu/mapping/pose_graph/trimmers.py :16-49; ref:
cartographer/mapping/pose_graph_trimmer.h Trimmable::TrimSubmap).

Used by delete_trajectory. The trimmer classes (PureLocalizationTrimmer,
OverlappingSubmapsTrimmer2D) and the batched search's pack bookkeeping are
not ported.
"""

from __future__ import annotations

from typing import Set


def trim_submaps(pose_graph, submap_indices: Set[int]) -> None:
    """Remove submaps, the constraints touching them, then the nodes left
    without a constraint; remap the positional indices and rebuild the
    stable-id maps, through which queued work items resolve their node
    and submap (or find them gone). The caller holds the graph's locks."""
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
