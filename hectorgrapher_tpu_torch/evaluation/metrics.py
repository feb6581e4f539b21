"""Trajectory evaluation metrics (counterpart of
hectorgrapher_tpu/evaluation/metrics.py; host code, numpy only).

(ref: cartographer/ground_truth/compute_relations_metrics_main.cc:74-113 —
relation-based abs/sqr translational (m, m^2) and rotational (deg, deg^2)
errors, mean +- std, after Kuemmerle et al.;
ground_truth/autogenerate_ground_truth.cc — relations from loop-closure
constraints with min covered distance and outlier gates;
generate_ground_truth_from_mocap_main.cc — relations from mocap poses at
fixed pose_time_delta.)

Plus the standard ATE RMSE. autogenerate_relations_from_pose_graph reads a
PoseGraph2D or PoseGraph3D of this package (its nodes, submaps and
constraints on the host).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from hectorgrapher_tpu_torch.common.time import from_universal
from hectorgrapher_tpu_torch.transform import np_quat as nq
from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3


@dataclass
class Relation:
    """Ground-truth relative pose between two times
    (ref: ground_truth/proto/relations.proto Relation)."""

    time1: float
    time2: float
    expected: NpRigid3  # pose of frame(time2) in frame(time1)


@dataclass
class RelationMetrics:
    """(ref: compute_relations_metrics_main.cc:188-232 output format)"""

    abs_translational_error_mean: float
    abs_translational_error_std: float
    sqr_translational_error_mean: float
    sqr_translational_error_std: float
    abs_rotational_error_deg_mean: float
    abs_rotational_error_deg_std: float
    sqr_rotational_error_deg_mean: float
    sqr_rotational_error_deg_std: float
    num_relations: int

    def __str__(self) -> str:
        return (
            f"Abs translational error {self.abs_translational_error_mean:.5f} "
            f"+/- {self.abs_translational_error_std:.5f} m\n"
            f"Sqr translational error {self.sqr_translational_error_mean:.5f} "
            f"+/- {self.sqr_translational_error_std:.5f} m^2\n"
            f"Abs rotational error {self.abs_rotational_error_deg_mean:.5f} "
            f"+/- {self.abs_rotational_error_deg_std:.5f} deg\n"
            f"Sqr rotational error {self.sqr_rotational_error_deg_mean:.5f} "
            f"+/- {self.sqr_rotational_error_deg_std:.5f} deg^2"
        )


class TrajectoryInterpolator:
    """Lookup poses at arbitrary times by interpolation."""

    def __init__(self, times: Sequence[float], poses: Sequence[NpRigid3]):
        order = np.argsort(times)
        self._times = np.asarray(times)[order]
        self._poses = [poses[i] for i in order]

    @property
    def min_time(self) -> float:
        return float(self._times[0])

    @property
    def max_time(self) -> float:
        return float(self._times[-1])

    def lookup(self, time: float) -> NpRigid3:
        i = int(np.searchsorted(self._times, time))
        if i <= 0:
            return self._poses[0]
        if i >= len(self._times):
            return self._poses[-1]
        t0, t1 = self._times[i - 1], self._times[i]
        f = (time - t0) / max(t1 - t0, 1e-12)
        a, b = self._poses[i - 1], self._poses[i]
        return NpRigid3(a.t + f * (b.t - a.t), nq.quat_slerp(a.q, b.q, f))


def compute_relation_metrics(
    trajectory: TrajectoryInterpolator, relations: Sequence[Relation]
) -> RelationMetrics:
    """(ref: compute_relations_metrics_main.cc ComputeRelationMetrics)"""
    t_errs: List[float] = []
    r_errs: List[float] = []
    for rel in relations:
        pose1 = trajectory.lookup(rel.time1)
        pose2 = trajectory.lookup(rel.time2)
        estimated = pose1.inverse().compose(pose2)
        error = rel.expected.inverse().compose(estimated)
        t_errs.append(float(np.linalg.norm(error.t)))
        r_errs.append(float(np.degrees(nq.quat_angle(error.q))))
    t = np.asarray(t_errs)
    r = np.asarray(r_errs)
    return RelationMetrics(
        abs_translational_error_mean=float(t.mean()),
        abs_translational_error_std=float(t.std()),
        sqr_translational_error_mean=float((t**2).mean()),
        sqr_translational_error_std=float((t**2).std()),
        abs_rotational_error_deg_mean=float(r.mean()),
        abs_rotational_error_deg_std=float(r.std()),
        sqr_rotational_error_deg_mean=float((r**2).mean()),
        sqr_rotational_error_deg_std=float((r**2).std()),
        num_relations=len(relations),
    )


def relations_from_ground_truth(
    times: Sequence[float],
    poses: Sequence[NpRigid3],
    pose_time_delta: float = 0.1,
) -> List[Relation]:
    """Consecutive relations every pose_time_delta seconds
    (ref: generate_ground_truth_from_mocap_main.cc:33-43, default 0.1 s)."""
    interp = TrajectoryInterpolator(times, poses)
    relations = []
    t = interp.min_time
    while t + pose_time_delta <= interp.max_time:
        p1 = interp.lookup(t)
        p2 = interp.lookup(t + pose_time_delta)
        relations.append(Relation(t, t + pose_time_delta, p1.inverse().compose(p2)))
        t += pose_time_delta
    return relations


def autogenerate_relations_from_pose_graph(
    pose_graph,
    min_covered_distance: float = 100.0,
    outlier_threshold_meters: float = 0.15,
    outlier_threshold_radians: float = 0.02,
) -> List[Relation]:
    """Select loop-closure constraints as ground-truth relations
    (ref: ground_truth/autogenerate_ground_truth.cc:39-77 — INTER
    constraints whose trajectory covered >= min_covered_distance between
    the two poses, excluding outliers where the optimized solution
    disagrees strongly with the constraint)."""
    # Covered distance along the node sequence.
    covered = [0.0]
    for a, b in zip(pose_graph.nodes[:-1], pose_graph.nodes[1:]):
        covered.append(covered[-1] + float(np.linalg.norm(b.global_pose.t - a.global_pose.t)))

    # The node nearest to each submap origin stands in for the submap
    # time: one vectorized argmin per submap, not one scan of every node
    # per constraint.
    node_ts = np.stack([n.global_pose.t for n in pose_graph.nodes])
    nearest_node = [
        int(np.argmin(np.linalg.norm(node_ts - s.global_pose.t[None, :], axis=1)))
        for s in pose_graph.submaps
    ]

    relations = []
    for c in pose_graph.constraints:
        if c.tag != "INTER":
            continue
        node = pose_graph.nodes[c.node_index]
        submap = pose_graph.submaps[c.submap_index]
        submap_node_idx = nearest_node[c.submap_index]
        if abs(covered[c.node_index] - covered[submap_node_idx]) < min_covered_distance:
            continue
        expected = c.zbar  # submap frame <- node
        solution = submap.global_pose.inverse().compose(node.global_pose)
        err = expected.inverse().compose(solution)
        if (
            np.linalg.norm(err.t) > outlier_threshold_meters
            or nq.quat_angle(err.q) > outlier_threshold_radians
        ):
            continue
        relations.append(
            Relation(
                time1=pose_graph.nodes[submap_node_idx].time,
                time2=node.time,
                expected=expected,
            )
        )
    return relations


def autogenerate_relations_from_pbstream_state(
    state,
    min_covered_distance: float = 100.0,
    outlier_threshold_meters: float = 0.15,
    outlier_threshold_radians: float = 0.02,
) -> List[Relation]:
    """Same selection as autogenerate_relations_from_pose_graph, operating
    on a decoded reference `.pbstream` (io/pbstream.py PbState), the exact
    input of the reference tool (ref:
    ground_truth/autogenerate_ground_truth_main.cc:77 reads a pbstream's
    PoseGraph proto). Times are converted from universal ticks to seconds."""

    nodes = sorted(state.nodes, key=lambda n: (n.trajectory_id, n.node_index))
    node_by_id = {(n.trajectory_id, n.node_index): n for n in nodes}
    submap_pose = {
        (s["trajectory_id"], s["submap_index"]): s["pose"] for s in state.submap_poses
    }
    covered_by_id = {}
    covered = 0.0
    prev = None
    for n in nodes:
        if prev is not None and prev.trajectory_id == n.trajectory_id:
            covered += float(np.linalg.norm(n.pose.t - prev.pose.t))
        covered_by_id[(n.trajectory_id, n.node_index)] = covered
        prev = n

    node_ts = np.stack([n.pose.t for n in nodes]) if nodes else np.zeros((0, 3))

    def nearest_node(pose):
        return nodes[int(np.argmin(np.linalg.norm(node_ts - pose.t[None, :], axis=1)))]

    relations = []
    for c in state.constraints:
        if c.tag != "INTER_SUBMAP":
            continue
        node = node_by_id.get((c.node_trajectory_id, c.node_index))
        spose = submap_pose.get((c.submap_trajectory_id, c.submap_index))
        if node is None or spose is None:
            continue
        anchor = nearest_node(spose)
        d = abs(
            covered_by_id[(node.trajectory_id, node.node_index)]
            - covered_by_id[(anchor.trajectory_id, anchor.node_index)]
        )
        if d < min_covered_distance:
            continue
        expected = c.relative_pose
        solution = spose.inverse().compose(node.pose)
        err = expected.inverse().compose(solution)
        if (
            np.linalg.norm(err.t) > outlier_threshold_meters
            or nq.quat_angle(err.q) > outlier_threshold_radians
        ):
            continue
        relations.append(
            Relation(
                time1=from_universal(anchor.timestamp),
                time2=from_universal(node.timestamp),
                expected=expected,
            )
        )
    return relations


def ate_rmse(
    est_times: Sequence[float],
    est_poses: Sequence[NpRigid3],
    gt_times: Sequence[float],
    gt_poses: Sequence[NpRigid3],
    align: bool = True,
) -> float:
    """Absolute trajectory error RMSE with optional SE(3) Umeyama alignment."""
    gt = TrajectoryInterpolator(gt_times, gt_poses)
    est_pts = np.stack([p.t for p in est_poses])
    gt_pts = np.stack([gt.lookup(t).t for t in est_times])
    if align and len(est_pts) >= 3:
        mu_e = est_pts.mean(0)
        mu_g = gt_pts.mean(0)
        H = (est_pts - mu_e).T @ (gt_pts - mu_g)
        U, _, Vt = np.linalg.svd(H)
        d = np.sign(np.linalg.det(Vt.T @ U.T))
        R = Vt.T @ np.diag([1.0, 1.0, d]) @ U.T
        est_pts = (R @ (est_pts - mu_e).T).T + mu_g
    return float(np.sqrt(np.mean(np.sum((est_pts - gt_pts) ** 2, axis=1))))
