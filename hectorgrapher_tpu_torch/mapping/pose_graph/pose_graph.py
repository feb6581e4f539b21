"""Pose graph back end, 3D and 2D: constraints, loop closure, global
optimization (counterpart of hectorgrapher_tpu/mapping/pose_graph/
pose_graph.py, PoseGraphBase :240-884, PoseGraph2D :886-1600 and
PoseGraph3D :1602-2484; ref: mapping/internal/{2d,3d}/pose_graph_{2d,3d}.cc,
internal/constraints/constraint_builder_{2d,3d}.cc).

Bookkeeping (node and submap tables, constraint lists, sampling and
distance gates, trajectory lifecycle) lives on the host. With
async_work_queue the constraint searches and the SPA solves run on a
worker thread (ref: pose_graph_3d.cc AddWorkItem:162-177,
DrainWorkQueue:512-535) while the front end streams; _lock guards the
bookkeeping and _opt_lock serializes optimizations, the reference's
structure.

With use_batched_constraint_search (the default) a round of two or more
gated candidates (local-window ones, then full-submap ones) is searched
together: one fast-matcher search of the whole round over the finished
submaps' pack on the card (kernel K4, one launch per pyramid level), then
one packed GN3D refinement of the survivors (kernel K3, one launch per LM
iteration). A round of one candidate, and every candidate with the option
off, takes the serial path: one fast-matcher search (through the pack
when its submap is packed) and one GN3D refinement.

Trimmers (trimmers.py: PureLocalizationTrimmer) run after each
optimization; a trim drops the batched search's pack when it held a
trimmed submap. A round that a trim overtakes between its fast match and
its refinement refines the submaps it captured and adds no constraint to
a trimmed one.

PoseGraph2D (at the end of this module) follows the same structure over
2D submaps: the fast 2D matcher (kernel K5, one launch per pyramid level
of a batched round) and the 2D GN refinement, the 2D SPA. Finished uint16
submaps are decoded to f32 where a matcher or the pack is built. A 2D TSDF
submap cannot be searched, in the reference as here (ROADMAP C20): the
search raises, the worker logs it, and no INTER constraint is added.

With a solver mesh (set_solver_mesh, parallel/mesh.py) the batched
rounds run over the mesh's shards, the finished submaps partitioned over
them (one K4 or K5 launch a shard and pyramid level), and an SPA solve
without extras runs sharded (parallel/sharded.py). On a mesh that spans
processes the leader's pose graph calls its broadcast hook before each
pack change, round and solve, so that every follower enters the same
collectives (cloud/solver_plane.py).
"""

from __future__ import annotations

import math
import queue as queue_mod
import threading
import time
import traceback
from dataclasses import dataclass
from enum import Enum
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from hectorgrapher_tpu_torch.common import profiling
from hectorgrapher_tpu_torch.mapping.ct import imu_integration
from hectorgrapher_tpu_torch.mapping import probability_values as pv
from hectorgrapher_tpu_torch.mapping.grids import ensure_f32_grid, volume_dtype
from hectorgrapher_tpu_torch.mapping.pose_graph.connectivity import TrajectoryConnectivityState
from hectorgrapher_tpu_torch.mapping.pose_graph.optimization import (
    SpaExtras2D,
    SpaExtras3D,
    SpaProblem2D,
    SpaProblem3D,
    empty_extras_2d,
    empty_extras_3d,
    solve_spa_2d,
    solve_spa_2d_full,
    solve_spa_3d,
    solve_spa_3d_full,
)
from hectorgrapher_tpu_torch.parallel.sharded import solve_spa_2d_sharded, solve_spa_3d_sharded
from hectorgrapher_tpu_torch.mapping.pose_graph.trimmers import trim_submaps
from hectorgrapher_tpu_torch.mapping.scan_matching.fast_correlative_2d import (
    make_fast_search_config,
    match_fast_2d_prepared,
    prepare_fast_matcher_2d,
)
from hectorgrapher_tpu_torch.mapping.scan_matching.fast_correlative_3d import FastCorrelativeScanMatcher3D
from hectorgrapher_tpu_torch.mapping.scan_matching.gn_2d import (
    match_gn_2d_packed_grids,
    match_gn_2d_probability,
    prepare_gn_probability_field,
)
from hectorgrapher_tpu_torch.mapping.scan_matching.gn_3d import (
    match_gn_3d,
    match_gn_3d_packed,
    prepare_gn_pack_3d,
)
from hectorgrapher_tpu_torch.ops import _build
from hectorgrapher_tpu_torch.parallel.constraint_search import (
    MeshPackedSubmaps3D,
    host_arrays_3d_nbytes,
    matcher_arrays_3d,
    matcher_host_arrays_3d,
    pack_submaps_2d_from_arrays,
    pack_submaps_3d_from_arrays,
    sharded_fast_matches_2d_packed,
    sharded_fast_matches_3d_packed,
)
from hectorgrapher_tpu_torch.sensor.types import PointCloud
from hectorgrapher_tpu_torch.transform import np_quat as nq
from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3
from hectorgrapher_tpu_torch.transform.rigid import Rigid2, Rigid3


class TrajectoryState(Enum):
    """(ref: pose_graph_interface.h:85)"""

    ACTIVE = 0
    FINISHED = 1
    FROZEN = 2
    DELETED = 3


@dataclass
class Constraint:
    """(ref: pose_graph_interface.h:33-53 Constraint)"""

    submap_index: int
    node_index: int
    zbar: NpRigid3  # pose of the node in the submap's frame
    translation_weight: float
    rotation_weight: float
    tag: str  # "INTRA" | "INTER"


@dataclass
class PgNode:
    time: float
    local_pose: NpRigid3
    global_pose: NpRigid3
    trajectory_id: int = 0
    cloud: Optional[PointCloud] = None  # 2D: the gravity-aligned filtered cloud
    high_cloud: Optional[PointCloud] = None  # 3D loop-closure clouds, tracking frame
    low_cloud: Optional[PointCloud] = None
    histogram: Optional[np.ndarray] = None
    gravity_alignment: Optional[np.ndarray] = None
    # Stable identity surviving trims (ref: mapping/id.h NodeId): work
    # items reference nodes by it, never by position.
    node_id: int = -1


@dataclass
class PgSubmap:
    submap: object  # Submap3D
    global_pose: NpRigid3
    trajectory_id: int = 0
    finished: bool = False
    matcher: object = None  # built when the submap finishes
    submap_id: int = -1  # stable identity (ref: mapping/id.h SubmapId)


_metric_lock = threading.Lock()
_METRICS: Dict[str, object] = {}


def _metric(key: str, make):
    """The registry's metric for key, registered on first use."""
    with _metric_lock:
        if key not in _METRICS:
            _METRICS[key] = make(profiling.global_factory())
        return _METRICS[key]


def _observe_constraint_score(kind: str, score: float) -> None:
    """Loop-closure matcher scores, found and rejected (ref:
    constraint_builder_3d.cc:303-315 score histograms)."""
    _metric(f"score_{kind}", lambda f: f.new_histogram_family(
        f"pose_graph_constraint_scores_{kind}", "loop-closure matcher scores (found + rejected candidates)",
        boundaries=[i / 20.0 for i in range(1, 21)]).add({})).observe(score)


def _set_pack_bytes_gauge(kind: str, value: int) -> None:
    """Device bytes of the constraint-search pack (see _get_pack_3d)."""
    _metric(f"pack_bytes_{kind}", lambda f: f.new_gauge_family(
        f"pose_graph_constraint_pack_bytes_{kind}",
        "device-resident constraint-search pack residency in bytes").add({})).set(value)


def _observe_batched_round(num_candidates: int) -> None:
    """Count batched loop-closure rounds and the candidates of each."""
    _metric("rounds", lambda f: f.new_counter_family(
        "pose_graph_batched_constraint_rounds_total",
        "loop-closure rounds scored by one batched matcher search").add({})).increment()
    _metric("round_candidates", lambda f: f.new_histogram_family(
        "pose_graph_batched_constraint_candidates", "gate-passing candidates per batched loop-closure round",
        boundaries=[2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0, 512.0, 1024.0]).add({})).observe(
        float(num_candidates))


# Per-stage profiling of a batched constraint round: with ROUND_PROFILING
# set, each round writes LAST_ROUND_BREAKDOWN (seconds per stage: pack,
# initials, cand_build, fm_launch, fm_readback, gn_prepare, gn_launch,
# gn_readback); device stages end in a synchronize, so they measure
# completion, not enqueue.
ROUND_PROFILING = False
LAST_ROUND_BREAKDOWN: Dict[str, float] = {}


class _SamplerState:
    """(ref: common/fixed_ratio_sampler.h FixedRatioSampler)"""

    def __init__(self, ratio: float):
        self.ratio = ratio
        self.num_pulses = 0
        self.num_samples = 0

    def pulse(self) -> bool:
        self.num_pulses += 1
        if self.num_samples * 1.0 < self.ratio * self.num_pulses:
            self.num_samples += 1
            return True
        return False


_GRAPH_MESH = None


def constraint_search_mesh():
    """The Mesh the batched constraint rounds run over, installed by
    set_solver_mesh (or set_constraint_search_mesh), for every pose graph
    of the process, as in the JAX package (pose_graph.py:184-203). None,
    the default, searches each graph's finished submaps on its own device
    (the JAX default is a mesh of the local devices; one card is the
    port's). A mesh over devices that no follower drives would deadlock at
    the first round, so nothing installs one but the caller."""
    return _GRAPH_MESH


def set_constraint_search_mesh(mesh) -> None:
    global _GRAPH_MESH
    _GRAPH_MESH = mesh


class PoseGraphBase:
    """Bookkeeping shared by the pose graphs."""

    def __init__(self, options):
        self._options = options  # PoseGraphOptions
        self.nodes: List[PgNode] = []
        self.submaps: List[PgSubmap] = []
        self.constraints: List[Constraint] = []
        self._submap_ids: Dict[int, int] = {}  # id(submap object) -> index
        self._next_node_id = 0
        self._next_submap_id = 0
        self._node_index_by_id: Dict[int, int] = {}
        self._submap_index_by_id: Dict[int, int] = {}
        self._num_nodes_since_last_optimization = 0
        self._sampler = _SamplerState(options.constraint_builder.sampling_ratio)
        self._global_sampler = _SamplerState(options.global_sampling_ratio)
        self._trajectory_states: Dict[int, TrajectoryState] = {0: TrajectoryState.ACTIVE}
        self.connectivity = TrajectoryConnectivityState()
        self.trimmers: List[object] = []
        self.num_optimizations = 0
        self._global_optimization_callbacks: List[object] = []
        self._landmark_pose_overrides: Dict[str, object] = {}
        # Sensor buffers for the optimization problem (ref:
        # optimization_problem_{2d,3d}.h; MapByTime per trajectory).
        self._odometry: Dict[int, List[Tuple[float, NpRigid3]]] = {}
        self._fixed_frame: Dict[int, List[Tuple[float, NpRigid3]]] = {}
        self._landmark_ids: Dict[str, int] = {}
        self._landmark_observations: List[dict] = []
        # _lock guards the host bookkeeping; _opt_lock serializes
        # optimizations (the solve itself runs without _lock so the front
        # end keeps streaming); _constraint_lock serializes whole constraint
        # rounds (samplers and matchers), re-entrant for the optimization
        # a round may run.
        self._lock = threading.RLock()
        self._opt_lock = threading.Lock()
        self._constraint_lock = threading.RLock()
        # The solver mesh (set_solver_mesh): the sharded SPA and the
        # batched rounds run over it, and `_solver_broadcast` (if any)
        # ships each of their inputs to the followers of a mesh that spans
        # processes. The shipped-pack bookkeeping records what the
        # followers hold: the (submap id, depth) pairs and order of each 2D
        # pack, the ids and order of the 3D pack.
        self._solver_mesh = None
        self._solver_broadcast = None
        self._shipped_pack2d: set = set()
        self._shipped_order2d: Dict[int, list] = {}
        self._shipped_pack3d: set = set()
        self._shipped_order3d = None
        self._cloud_range_cache: Dict[int, float] = {}
        self._async = bool(options.async_work_queue)
        self._work_queue: Optional[queue_mod.Queue] = None
        self._worker: Optional[threading.Thread] = None
        if self._async:
            self._work_queue = queue_mod.Queue()
            self._worker = threading.Thread(target=self._drain_work_queue, name="pose-graph-work-queue", daemon=True)
            self._worker.start()

    # -- submap bookkeeping -------------------------------------------------

    def _get_or_add_submap(self, submap, trajectory_id: int) -> int:
        key = id(submap)
        if key not in self._submap_ids:
            # The global pose starts as the local pose corrected by the
            # trajectory's current local-to-global transform.
            local_to_global = self.local_to_global(trajectory_id)
            self._submap_ids[key] = len(self.submaps)
            self._submap_index_by_id[self._next_submap_id] = len(self.submaps)
            self.submaps.append(PgSubmap(
                submap=submap,
                global_pose=local_to_global.compose(submap.local_pose),
                trajectory_id=trajectory_id,
                submap_id=self._next_submap_id,
            ))
            self._next_submap_id += 1
        idx = self._submap_ids[key]
        if getattr(submap, "insertion_finished", False) and not self.submaps[idx].finished:
            self.submaps[idx].finished = True
            if self._async:
                # The matcher is built off the front end's thread (ref:
                # DispatchScanMatcherConstruction, constraint_builder_3d.cc:162-189).
                self._work_queue.put(("finish_submap", self.submaps[idx].submap_id))
            else:
                self._on_submap_finished(self.submaps[idx])
        return idx

    def local_to_global(self, trajectory_id: int = 0) -> NpRigid3:
        """Correction from the trajectory's local SLAM frame to the global
        frame (ref: pose_graph GetLocalToGlobalTransform)."""
        with self._lock:
            for node in reversed(self.nodes):
                if node.trajectory_id == trajectory_id:
                    return node.global_pose.compose(node.local_pose.inverse())
            return NpRigid3.identity()

    def register_trajectory(self, trajectory_id: int) -> None:
        """Mark a trajectory ACTIVE (idempotent)."""
        self._trajectory_states.setdefault(trajectory_id, TrajectoryState.ACTIVE)

    def freeze_trajectory(self, trajectory_id: int) -> None:
        self._trajectory_states[trajectory_id] = TrajectoryState.FROZEN

    def finish_trajectory(self, trajectory_id: int) -> None:
        self._trajectory_states[trajectory_id] = TrajectoryState.FINISHED

    def is_frozen(self, trajectory_id: int) -> bool:
        return self._trajectory_states.get(trajectory_id) == TrajectoryState.FROZEN

    def is_finished(self, trajectory_id: int) -> bool:
        return self._trajectory_states.get(trajectory_id) == TrajectoryState.FINISHED

    def trajectory_states(self) -> Dict[int, TrajectoryState]:
        with self._lock:
            return dict(self._trajectory_states)

    def delete_trajectory(self, trajectory_id: int) -> None:
        """Remove a trajectory's submaps, nodes, constraints and sensor
        buffers (ref: pose_graph_3d.cc DeleteTrajectory). Holds _opt_lock
        throughout: an optimization's writeback would otherwise race the
        index remapping."""
        self.wait_for_all_computations()
        with self._opt_lock, self._lock:
            self._trajectory_states[trajectory_id] = TrajectoryState.DELETED
            own = {i for i, s in enumerate(self.submaps) if s.trajectory_id == trajectory_id}
            if own:
                trim_submaps(self, own)
            keep = [i for i, n in enumerate(self.nodes) if n.trajectory_id != trajectory_id]
            if len(keep) != len(self.nodes):
                node_remap = {old: new for new, old in enumerate(keep)}
                self.constraints = [c for c in self.constraints if c.node_index in node_remap]
                for c in self.constraints:
                    c.node_index = node_remap[c.node_index]
                self.nodes = [self.nodes[i] for i in keep]
                self._node_index_by_id = {n.node_id: i for i, n in enumerate(self.nodes)}
            for attr in ("_odometry", "_fixed_frame", "_imu"):
                buf = getattr(self, attr, None)
                if isinstance(buf, dict):
                    buf.pop(trajectory_id, None)
            obs = getattr(self, "_landmark_observations", None)
            if obs is not None:
                self._landmark_observations = [o for o in obs if o["trajectory_id"] != trajectory_id]

    def set_landmark_pose(self, landmark_id: str, global_pose) -> None:
        """Seed a landmark's pose for the next solve (ref: pose_graph
        SetLandmarkPose)."""
        with self._lock:
            self._landmark_pose_overrides[landmark_id] = global_pose
            ids = getattr(self, "_landmark_ids", None)
            if ids is not None and landmark_id not in ids:
                ids[landmark_id] = len(ids)

    def landmark_poses(self) -> Dict[str, NpRigid3]:
        """Optimized landmark poses, shadowed by overrides not yet consumed."""
        with self._lock:
            out = dict(getattr(self, "_landmark_poses", {}))
            out.update(self._landmark_pose_overrides)
            return out

    def _consume_landmark_overrides(self, optimized_ids) -> None:
        with self._lock:
            ids = getattr(self, "_landmark_ids", {})
            for name in list(self._landmark_pose_overrides):
                if ids.get(name) in optimized_ids:
                    self._landmark_pose_overrides.pop(name)

    def set_solver_mesh(self, mesh, broadcast=None) -> None:
        """Install a Mesh for the back end's device work (JAX
        pose_graph.py:449-478): the batched constraint rounds run over it,
        and SPA solves without extras run sharded (parallel/sharded.py).
        `broadcast(op, payload, wait=False)`, if given, is called before
        each sharded solve, pack change and round, so that the follower
        processes of a mesh that spans processes enter the same
        collectives (cloud/solver_plane.py). None reverts to the graph's
        own device.

        A mesh that spans processes without a broadcast hook is refused
        (ValueError): the leader's first collective would wait forever for
        processes that nothing drives."""
        if mesh is not None and broadcast is None and mesh.spans_processes:
            raise ValueError("set_solver_mesh: mesh spans multiple processes but no broadcast hook was given — "
                             "followers could never enter the collective programs (wire cloud/solver_plane.py)")
        self._solver_mesh = mesh
        self._solver_broadcast = broadcast
        self._shipped_pack2d = set()
        self._shipped_order2d = {}
        self._shipped_pack3d = set()
        self._shipped_order3d = None
        set_constraint_search_mesh(mesh)

    def add_global_slam_optimization_callback(self, callback) -> None:
        """callback(num_optimizations) runs after every optimization."""
        self._global_optimization_callbacks.append(callback)

    def _notify_global_optimization(self) -> None:
        for cb in list(self._global_optimization_callbacks):
            try:
                cb(self.num_optimizations)
            except Exception:  # noqa: BLE001 - a client callback must not stop the back end
                traceback.print_exc()

    # -- sensor ingestion (ref: pose_graph_{2d,3d}.cc AddOdometryData,
    #    AddFixedFramePoseData, AddLandmarkData) --------------------------------

    def add_odometry_data(self, trajectory_id: int, time: float, pose: NpRigid3) -> None:
        self._odometry.setdefault(trajectory_id, []).append((time, pose))

    def add_fixed_frame_pose_data(self, trajectory_id: int, time: float, pose: NpRigid3) -> None:
        self._fixed_frame.setdefault(trajectory_id, []).append((time, pose))

    def add_landmark_data(self, trajectory_id: int, time: float, landmark_id: str, landmark_to_tracking: NpRigid3,
                          translation_weight: float, rotation_weight: float) -> None:
        if landmark_id not in self._landmark_ids:
            self._landmark_ids[landmark_id] = len(self._landmark_ids)
        self._landmark_observations.append(dict(
            trajectory_id=trajectory_id, time=time, landmark_index=self._landmark_ids[landmark_id],
            transform=landmark_to_tracking, translation_weight=translation_weight,
            rotation_weight=rotation_weight))

    @staticmethod
    def _lookup_buffer(buf: List[Tuple[float, NpRigid3]], time: float) -> Optional[NpRigid3]:
        """The buffered pose at `time` (an odometry or fixed-frame buffer),
        interpolated; None outside the buffer."""
        if not buf or time < buf[0][0] or time > buf[-1][0]:
            return None
        j = int(np.searchsorted([t for t, _ in buf], time))
        if j == 0:
            return buf[0][1]
        if j >= len(buf):
            return buf[-1][1]
        t0, p0 = buf[j - 1]
        t1, p1 = buf[j]
        f = (time - t0) / max(t1 - t0, 1e-9)
        return NpRigid3(p0.t + f * (p1.t - p0.t), nq.quat_slerp(p0.q, p1.q, f))

    # -- hooks of the 3D and 2D graphs ----------------------------------------

    def _on_submap_finished(self, pg_submap: PgSubmap) -> None:
        raise NotImplementedError

    def _forget_submaps(self, removed_sids) -> None:
        """Drop what the graph caches of trimmed submaps (stable ids);
        called by trim_submaps under the graph's locks."""
        raise NotImplementedError

    def _compute_constraint(self, node: PgNode, pg_submap: PgSubmap, global_search: bool = False):
        raise NotImplementedError

    def _compute_constraints_batched(self, gated, global_search: bool = False):
        """A round's constraints, aligned with gated, or NotImplementedError
        to take the serial path."""
        raise NotImplementedError

    def _run_optimization(self, num_iterations: int) -> None:
        raise NotImplementedError

    # -- main entry -----------------------------------------------------------

    def add_node(self, node: PgNode, insertion_submaps, newly_finished=()) -> int:
        """(ref: pose_graph_3d.cc AddNode:142-160, then
        ComputeConstraintsForNode:313-395 inline or on the worker.)"""
        with self._lock:
            local_to_global = self.local_to_global(node.trajectory_id)
            node.global_pose = local_to_global.compose(node.local_pose)
            node_index = len(self.nodes)
            node.node_id = self._next_node_id
            self._node_index_by_id[node.node_id] = node_index
            self._next_node_id += 1
            self.nodes.append(node)
            # INTRA constraints against the submaps the node went into.
            self.connectivity.add(node.trajectory_id)
            for submap in insertion_submaps:
                si = self._get_or_add_submap(submap, node.trajectory_id)
                self.constraints.append(Constraint(
                    submap_index=si,
                    node_index=node_index,
                    zbar=submap.local_pose.inverse().compose(node.local_pose),
                    translation_weight=self._options.matcher_translation_weight,
                    rotation_weight=self._options.matcher_rotation_weight,
                    tag="INTRA",
                ))
                self.connectivity.connect(node.trajectory_id, self.submaps[si].trajectory_id, node.time)
            inserted_ids = {self.submaps[self._submap_ids[id(s)]].submap_id for s in insertion_submaps}
            finished_ids = [self.submaps[self._submap_ids[id(s)]].submap_id
                            for s in newly_finished if id(s) in self._submap_ids]
            node_id = node.node_id
        if self._async:
            self._work_queue.put(("node", node_id, inserted_ids, finished_ids))
        else:
            self._compute_constraints_for_node(node_id, inserted_ids, finished_ids)
        return node_index

    def _compute_constraints_for_node(self, node_id, inserted_ids, finished_ids) -> None:
        """INTER searches and the optimization cadence (the reference's
        ComputeConstraintsForNode). Candidates in the reference's dispatch
        order: this node against every finished submap, then each newly
        finished submap against every older node; each is gated, then
        matched. All arguments are stable ids."""
        pairs: List[Tuple[int, int]] = []
        with self._lock:
            pairs.extend((node_id, s.submap_id) for s in self.submaps
                         if s.finished and s.submap_id not in inserted_ids)
        for sid in finished_ids:
            with self._lock:
                intra: Dict[int, set] = {}
                for c in self.constraints:
                    if c.tag == "INTRA":
                        nid = self.nodes[c.node_index].node_id
                        if nid < node_id:
                            intra.setdefault(nid, set()).add(self.submaps[c.submap_index].submap_id)
                old_node_ids = [n.node_id for n in self.nodes if n.node_id < node_id]
            pairs.extend((nid, sid) for nid in old_node_ids if sid not in intra.get(nid, ()))

        with profiling.section("constraint_search"), self._constraint_lock:
            gated_local: List[tuple] = []
            gated_global: List[tuple] = []
            for nid, sid in pairs:
                gated = self._gate_candidate(nid, sid)
                if gated is not None:
                    node, pg_submap, global_search = gated
                    (gated_global if global_search else gated_local).append((nid, sid, node, pg_submap))
            # Local-window and full-submap candidates each form their own
            # round; a round of two or more takes the batched search.
            for gated, global_search in ((gated_local, False), (gated_global, True)):
                results = None
                if self._options.use_batched_constraint_search and len(gated) >= 2:
                    try:
                        results = self._compute_constraints_batched(gated, global_search=global_search)
                    except NotImplementedError:  # mixed candidate shapes: the serial path, as the reference
                        self.batched_fallbacks += 1
                        results = None
                if results is not None:
                    _observe_batched_round(len(gated))
                else:
                    results = [self._compute_constraint(node, pg_submap, global_search=global_search)
                               for _, _, node, pg_submap in gated]
                for (nid, sid, node, pg_submap), constraint in zip(gated, results):
                    if constraint is not None:
                        self._append_constraint(nid, sid, node, pg_submap, constraint)

        with self._constraint_lock:
            self._num_nodes_since_last_optimization += 1
            run_opt = self._num_nodes_since_last_optimization >= self._options.optimize_every_n_nodes > 0
        if run_opt:
            self.run_final_optimization(self._options.optimization_problem.ceres_solver_options.max_num_iterations)

    # -- async work queue -----------------------------------------------------

    def _drain_work_queue(self) -> None:
        """(ref: pose_graph_3d.cc DrainWorkQueue:512-535.)"""
        while True:
            item = self._work_queue.get()
            try:
                if item is None:
                    return
                if item[0] == "node":
                    _, node_id, inserted_ids, finished_ids = item
                    self._compute_constraints_for_node(node_id, inserted_ids, finished_ids)
                elif item[0] == "finish_submap":
                    with self._lock:
                        idx = self._submap_index_by_id.get(item[1])
                        pg_submap = self.submaps[idx] if idx is not None else None
                    if pg_submap is not None:
                        self._on_submap_finished(pg_submap)
            except Exception:  # noqa: BLE001 - a dead worker would deadlock wait_for_all_computations
                traceback.print_exc()
            finally:
                self._work_queue.task_done()

    def wait_for_all_computations(self) -> None:
        """Block until the work queue is drained (ref: WaitForAllComputations)."""
        if self._async:
            self._work_queue.join()

    def _gate_candidate(self, node_id: int, submap_id: int):
        """Local or global search, and the distance and sampling gates
        (ref: pose_graph ComputeConstraint :248-311): trajectories connected
        recently search a local window within max_constraint_distance, the
        others a full submap through the global sampler. Returns (node,
        pg_submap, global_search) or None."""
        with self._lock:
            ni = self._node_index_by_id.get(node_id)
            si = self._submap_index_by_id.get(submap_id)
            if ni is None or si is None:
                return None  # trimmed while the work item waited
            node = self.nodes[ni]
            pg_submap = self.submaps[si]
            last = self.connectivity.last_connection_time(node.trajectory_id, pg_submap.trajectory_id)
            recently_connected = (
                node.trajectory_id == pg_submap.trajectory_id
                or (last is not None and node.time - last < self._options.global_constraint_search_after_n_seconds)
                or not self._options.use_global_constraint_search
            )
            if recently_connected:
                d = np.linalg.norm(node.global_pose.t - pg_submap.global_pose.t)
                if d > self._options.constraint_builder.max_constraint_distance:
                    return None
                if not self._sampler.pulse():
                    return None
                return node, pg_submap, False
            if not self._global_sampler.pulse():
                return None
            return node, pg_submap, True

    def _scan_range_bucket(self, node) -> float:
        """The angular step's range: the node's own max scan range, rounded
        up to a power of sqrt(2), capped by max_scan_range (ref:
        fast_correlative_scan_matcher GenerateRotatedScans uses the cloud's
        own extent). One cloud read per node lifetime."""
        r = self._cloud_range_cache.get(node.node_id)
        if r is None:
            cloud = node.cloud if node.cloud is not None else node.high_cloud
            pos = cloud.positions.cpu().numpy()
            mask = cloud.mask.cpu().numpy()
            rmax = float(np.sqrt(np.max(np.where(mask, np.sum(pos**2, axis=-1), 0.0), initial=0.0)))
            bucket = 1.0
            while bucket < rmax and bucket < self._max_scan_range:
                bucket *= math.sqrt(2.0)
            r = min(bucket, self._max_scan_range)
            self._cloud_range_cache[node.node_id] = r
        return r

    def _append_constraint(self, node_id: int, submap_id: int, node, pg_submap, constraint) -> None:
        """Merge a found constraint, its indices resolved by stable id now
        (ref: pose_graph_3d.cc:436-510)."""
        with self._lock:
            ni = self._node_index_by_id.get(node_id)
            si = self._submap_index_by_id.get(submap_id)
            if ni is None or si is None:
                return  # trimmed during the search
            constraint.node_index = ni
            constraint.submap_index = si
            self.constraints.append(constraint)
            self.connectivity.connect(node.trajectory_id, pg_submap.trajectory_id, node.time)

    def run_final_optimization(self, num_iterations: Optional[int] = None) -> None:
        """(ref: RunFinalOptimization; also the periodic optimization, called
        from the worker, which must not wait for its own queue.)"""
        if threading.current_thread() is not self._worker:
            self.wait_for_all_computations()
        if num_iterations is None:
            num_iterations = self._options.max_num_final_iterations
        if not self.nodes or not self.submaps:
            return
        with self._opt_lock, profiling.section("pose_graph_optimization"):
            self._run_optimization(num_iterations)
            self.num_optimizations += 1
            self._num_nodes_since_last_optimization = 0
            if self._options.log_residual_histograms:
                self._log_residual_histograms()
            with self._lock:
                for trimmer in self.trimmers:
                    trimmer.trim(self)
        self._notify_global_optimization()

    def _log_residual_histograms(self) -> None:
        """Constraint residuals after the solve, by tag (ref:
        pose_graph.lua log_residual_histograms)."""
        hists = {
            "trans": _metric("residual_trans", lambda f: f.new_histogram_family(
                "hg_pose_graph_residual_translation_m", "post-optimization constraint translation residuals",
                boundaries=[0.001, 0.003, 0.01, 0.03, 0.1, 0.3, 1.0, 3.0])),
            "rot": _metric("residual_rot", lambda f: f.new_histogram_family(
                "hg_pose_graph_residual_rotation_deg", "post-optimization constraint rotation residuals",
                boundaries=[0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0, 30.0])),
        }
        with self._lock:
            snapshot = [(c.tag, self.submaps[c.submap_index].global_pose, self.nodes[c.node_index].global_pose, c.zbar)
                        for c in self.constraints]
        for tag, submap_pose, node_pose, zbar in snapshot:
            actual = submap_pose.inverse().compose(node_pose)
            dq = nq.quat_multiply(nq.quat_conjugate(zbar.q), actual.q)
            hists["trans"].add({"tag": tag}).observe(float(np.linalg.norm(actual.t - zbar.t)))
            hists["rot"].add({"tag": tag}).observe(2.0 * math.degrees(math.acos(min(1.0, abs(float(dq[0]))))))

    # -- solve snapshot helpers -------------------------------------------------

    def _snapshot_lists(self):
        """The solve's inputs, captured under the lock while add_node keeps
        appending (ref: pose_graph_3d.cc HandleWorkQueue:436-510)."""
        with self._lock:
            return list(self.nodes), list(self.submaps), list(self.constraints)

    def _correct_post_snapshot(self, snap_nodes, snap_submaps) -> None:
        """Re-anchor nodes and submaps added while the solve ran on the last
        optimized node of their trajectory. The caller holds _lock."""
        l2g: Dict[int, NpRigid3] = {}
        for node in reversed(snap_nodes):
            if node.trajectory_id not in l2g:
                l2g[node.trajectory_id] = node.global_pose.compose(node.local_pose.inverse())
        for node in self.nodes[len(snap_nodes):]:
            corr = l2g.get(node.trajectory_id)
            if corr is not None:
                node.global_pose = corr.compose(node.local_pose)
        for sub in self.submaps[len(snap_submaps):]:
            corr = l2g.get(sub.trajectory_id)
            if corr is not None:
                sub.global_pose = corr.compose(sub.submap.local_pose)

    @staticmethod
    def _pad_to(n: int) -> int:
        """Capacities in powers of two from 8, as the JAX package pads them
        (its jitted solve compiles per shape)."""
        p = 8
        while p < n:
            p *= 2
        return p


def _numpy_arrays_3d(h: dict) -> dict:
    """A matcher_host_arrays_3d dict with numpy leaves: what the wire
    carries to a follower (it refuses tensors)."""
    return dict(h, pyr=[t.numpy() for t in h["pyr"]], hi_res=float(h["hi_res"]), lo_res=float(h["lo_res"]),
                grid_shape=tuple(int(v) for v in h["grid_shape"]),
                **{k: h[k].numpy() for k in ("hmc", "low", "lmc", "hist")})


def _identity_quats(n: int) -> np.ndarray:
    return np.tile(np.array([1.0, 0.0, 0.0, 0.0], np.float32), (n, 1))


class PoseGraph3D(PoseGraphBase):
    """(ref: mapping/internal/3d/pose_graph_3d.cc)"""

    def __init__(self, options, histogram_size: int = 120, max_scan_range: float = 20.0, device="cuda"):
        """Runs on the card unless `device` says otherwise; without one it
        raises."""
        self._device = torch.device(device)
        if self._device.type == "cuda":
            _build.load_library()  # before the worker thread can launch a kernel
        self._histogram_size = histogram_size
        self._max_scan_range = max_scan_range
        self._imu: Dict[int, List[Tuple[float, np.ndarray, np.ndarray]]] = {}  # IMU for the optimization problem
        # The finished submaps' search state on the card for the batched
        # search (see _get_pack_3d): the pack, the round counter and each
        # submap's last round, for most-recently-used retention.
        self._pack3d: Optional[dict] = None
        self._pack3d_round = 0
        self._pack3d_used: Dict[int, int] = {}
        self.batched_fallbacks = 0  # rounds of mixed shapes sent to the serial path
        super().__init__(options)

    # -- IMU ingestion (ref: pose_graph_3d.cc AddImuData) -----------------------

    def add_imu_data(self, trajectory_id: int, time: float, linear_acceleration, angular_velocity) -> None:
        self._imu.setdefault(trajectory_id, []).append(
            (time, np.asarray(linear_acceleration, float), np.asarray(angular_velocity, float)))

    def _build_extras(self, N_cap: int, nodes=None):
        """SpaExtras3D on the device from the buffered sensors, or None when
        every family is empty (ref: optimization_problem_3d.cc :353-530)."""
        nodes = self.nodes if nodes is None else nodes
        opt = self._options.optimization_problem
        by_traj: Dict[int, List[int]] = {}
        for i, n in enumerate(nodes):
            by_traj.setdefault(n.trajectory_id, []).append(i)

        # Odometry and consecutive local-pose residuals, only under
        # fix_z_in_3d (ref: :450-503); both families are added.
        nn = []
        if opt.fix_z_in_3d:
            for tid, idxs in by_traj.items():
                if self.is_frozen(tid):
                    continue
                odom = self._odometry.get(tid, [])
                for a, b in zip(idxs[:-1], idxs[1:]):
                    na, nb = nodes[a], nodes[b]
                    oa, ob = self._lookup_buffer(odom, na.time), self._lookup_buffer(odom, nb.time)
                    if oa is not None and ob is not None:
                        nn.append((a, b, oa.inverse().compose(ob), opt.odometry_translation_weight,
                                   opt.odometry_rotation_weight))
                    nn.append((a, b, na.local_pose.inverse().compose(nb.local_pose),
                               opt.local_slam_pose_translation_weight, opt.local_slam_pose_rotation_weight))

        # IMU rotation and acceleration residuals between consecutive nodes
        # (ref: :353-447).
        ir, ia = [], []
        traj_slots: Dict[int, int] = {}
        if not opt.fix_z_in_3d and (opt.rotation_weight > 0 or opt.acceleration_weight > 0):
            for tid, idxs in by_traj.items():
                imu = self._imu.get(tid, [])
                if len(imu) < 2:
                    continue
                slot = traj_slots.setdefault(tid, len(traj_slots))
                imu_t = np.asarray([x[0] for x in imu])
                imu_a = np.asarray([x[1] for x in imu])
                imu_g = np.asarray([x[2] for x in imu])
                for j in range(len(idxs) - 1):
                    a, b = idxs[j], idxs[j + 1]
                    ta, tb = nodes[a].time, nodes[b].time
                    if tb <= ta:
                        continue
                    dq, _, _ = imu_integration.integrate_imu(imu_t, imu_a, imu_g, ta, tb)
                    ir.append((a, b, slot, dq, opt.rotation_weight))
                    if opt.acceleration_weight > 0 and j + 2 < len(idxs):
                        c = idxs[j + 2]
                        tc = nodes[c].time
                        if tc <= tb:
                            continue
                        dt1, dt2 = tb - ta, tc - tb
                        c1, c2 = ta + dt1 / 2, tb + dt2 / 2
                        dq_c1, _, _ = imu_integration.integrate_imu(imu_t, imu_a, imu_g, ta, c1)
                        _, dv_cc, _ = imu_integration.integrate_imu(imu_t, imu_a, imu_g, c1, c2)
                        # The velocity change in the IMU frame at the middle node (ref: :420-428).
                        dv = nq.quat_rotate(nq.quat_multiply(nq.quat_conjugate(dq), dq_c1), dv_cc)
                        ia.append((a, b, c, slot, dv, dt1, dt2, opt.acceleration_weight))

        has_ff = any(self._fixed_frame.values())
        has_lm = bool(self._landmark_observations)
        if not nn and not has_ff and not has_lm and not ir and not ia:
            return None

        P = self._pad_to(max(len(nn), 1))
        L = max(len(self._landmark_ids), 1)
        O = self._pad_to(max(len(self._landmark_observations), 1))
        R = self._pad_to(max(len(ir), 1))
        A = self._pad_to(max(len(ia), 1))
        Tj = max(len(traj_slots), 1)
        fields = {k: v.numpy() for k, v in empty_extras_3d(N_cap, p=P, l=L, o=O, r=R, a=A, tj=Tj,
                                                                device="cpu")._asdict().items()}
        for i, (a, b, slot, dq, w) in enumerate(ir):
            for name, v in (("ir_a", a), ("ir_b", b), ("ir_traj", slot), ("ir_mask", True),
                            ("ir_delta_rotation", dq), ("ir_weight", w)):
                fields[name][i] = v
        for i, (a, b, c, slot, dv, dt1, dt2, w) in enumerate(ia):
            for name, v in (("ia_a", a), ("ia_b", b), ("ia_c", c), ("ia_traj", slot), ("ia_mask", True),
                            ("ia_delta_velocity", dv), ("ia_dt1", dt1), ("ia_dt2", dt2), ("ia_weight", w)):
                fields[name][i] = v
        if traj_slots:
            fields["traj_mask"][: len(traj_slots)] = True
            fields["calibration_fixed"] = np.asarray(not opt.use_online_imu_extrinsics_in_3d)
        for i, (a, b, rel, wt, wr) in enumerate(nn):
            for name, v in (("nn_a", a), ("nn_b", b), ("nn_mask", True), ("nn_rel_translation", rel.t),
                            ("nn_rel_rotation", rel.q), ("nn_translation_weight", wt), ("nn_rotation_weight", wr)):
                fields[name][i] = v
        if has_ff:
            for i, n in enumerate(nodes):
                pose = self._lookup_buffer(self._fixed_frame.get(n.trajectory_id, []), n.time)
                if pose is not None:
                    fields["ff_mask"][i] = True
                    fields["ff_translation"][i] = pose.t
                    fields["ff_translation_weight"][i] = opt.fixed_frame_pose_translation_weight
        if has_lm:
            # Each observation binds to the node of its own trajectory at or
            # before its time; client overrides seed the landmark poses.
            times_by_traj: Dict[int, Tuple[list, list]] = {}
            for i, n in enumerate(nodes):
                times_by_traj.setdefault(n.trajectory_id, ([], []))[0].append(n.time)
                times_by_traj[n.trajectory_id][1].append(i)
            lm_init: Dict[int, NpRigid3] = {}
            for name, pose in self._landmark_pose_overrides.items():
                li = self._landmark_ids.get(name)
                if li is not None:
                    lm_init[li] = pose
            count = 0
            for obs in self._landmark_observations:
                times_t, idx_t = times_by_traj.get(obs["trajectory_id"], (None, None))
                if times_t is None:
                    continue
                j = idx_t[min(max(int(np.searchsorted(times_t, obs["time"])) - 1, 0), len(idx_t) - 1)]
                if count >= O:
                    break
                for name, v in (("lm_node", j), ("lm_index", obs["landmark_index"]), ("lm_mask", True),
                                ("lm_rel_translation", obs["transform"].t), ("lm_rel_rotation", obs["transform"].q),
                                ("lm_translation_weight", obs["translation_weight"]),
                                ("lm_rotation_weight", obs["rotation_weight"])):
                    fields[name][count] = v
                if obs["landmark_index"] not in lm_init:
                    lm_init[obs["landmark_index"]] = nodes[j].global_pose.compose(obs["transform"])
                count += 1
            for li, pose in lm_init.items():
                fields["landmark_translation"][li] = pose.t
                fields["landmark_rotation"][li] = pose.q
                fields["landmark_mask"][li] = True
        return SpaExtras3D(**{k: torch.from_numpy(np.asarray(v)).to(self._device) for k, v in fields.items()})

    def _forget_submaps(self, removed_sids) -> None:
        """The batched search's pack is dropped when a trimmed submap is a
        member, so that trimmed tables leave the card and stop counting
        against pack_hbm_budget_bytes; the trimmed ids leave its host cache
        and the most-recently-used record, and the pack-bytes gauge reads 0
        until the next round packs again. The surviving members' matchers
        hold their tables on the host (to_host), so that rebuild only
        uploads, as in the JAX package."""
        pack = self._pack3d
        if pack is not None and removed_sids & set(pack["slots"]):
            for sid in removed_sids:
                pack["host"].pop(sid, None)
            self._pack3d = None
            _set_pack_bytes_gauge("3d", 0)
        for sid in removed_sids:
            self._pack3d_used.pop(sid, None)

    def _on_submap_finished(self, pg_submap: PgSubmap) -> None:
        """Build the submap's loop-closure matcher (ref: constraint_builder_3d.cc
        DispatchScanMatcherConstruction:162-189)."""
        pg_submap.matcher = FastCorrelativeScanMatcher3D(
            self._options.constraint_builder.fast_correlative_scan_matcher_3d,
            pg_submap.submap.high_resolution_grid,
            pg_submap.submap.low_resolution_grid,
            pg_submap.submap.rotational_histogram,
            self._histogram_size,
        )

    def _get_pack_3d(self, needed_matchers: Dict[int, object], mesh=None):
        """The finished submaps' search state on the card for the batched
        search (PoseGraph3D._get_pack_3d of the JAX package, :1930-2019):
        rebuilt only when a needed submap is not packed. This round's
        submaps are always members; the other finished submaps stay most
        recently used first while the pack fits
        constraint_builder.pack_hbm_budget_bytes. A CPU copy of each
        member's state is cached per submap id, and the matcher's own copy
        is demoted to it (to_host), so the pack is the only device copy;
        an evicted submap is re-admitted from the cache. Unlike the JAX
        rebuild, members that stay are copied from the old pack on the
        card, and only new members are uploaded. With a mesh the pack is
        partitioned over its shards (a MeshPackedSubmaps3D), and a change
        of mesh rebuilds it. Returns (slot by submap id, the pack)."""
        self._pack3d_round += 1
        for sid in needed_matchers:
            self._pack3d_used[sid] = self._pack3d_round
        state = self._pack3d
        if state is not None and state["mesh"] is not mesh:
            state = dict(state, packed=None, slots={})  # the host cache stays; the layout does not
        if state is not None and all(sid in state["slots"] for sid in needed_matchers):
            return state["slots"], state["packed"]
        with self._lock:
            live = {s.submap_id: s.matcher for s in self.submaps if s.matcher is not None}
        live.update(needed_matchers)
        host = {sid: h for sid, h in (state["host"] if state is not None else {}).items() if sid in live}
        fresh = {sid: matcher_host_arrays_3d(m) for sid, m in live.items() if sid not in host}
        per_bytes = {sid: host_arrays_3d_nbytes(h) for sid, h in {**host, **fresh}.items()}
        # Membership: the needed submaps, then the others most recently
        # used first while under the budget.
        budget = int(self._options.constraint_builder.pack_hbm_budget_bytes)
        members = set(needed_matchers)
        total = sum(per_bytes[sid] for sid in members)
        for sid in sorted((s for s in live if s not in members), key=lambda s: -self._pack3d_used.get(s, 0)):
            if total + per_bytes[sid] > budget:
                break
            members.add(sid)
            total += per_bytes[sid]
        prev_order = state["order"] if state is not None else []
        order = [sid for sid in prev_order if sid in members]
        order += [sid for sid in members if sid not in order]
        arrays = {**host, **fresh}
        if len({(tuple(tuple(t.shape) for t in arrays[sid]["pyr"]), tuple(arrays[sid]["low"].shape))
                for sid in order}) != 1:
            raise NotImplementedError("mixed pyramid shapes")
        # A new member's tables come from its matcher while still on the
        # card; a re-admitted one's from the host cache.
        old_slots = state["slots"] if state is not None else {}
        sources = [matcher_arrays_3d(live[sid]) if sid in fresh else host[sid] for sid in order]
        previous = state["packed"] if state is not None else None
        packed = pack_submaps_3d_from_arrays(sources, self._device if mesh is None else mesh, previous,
                                             [old_slots.get(sid) if previous is not None else None for sid in order])
        for sid, h in fresh.items():
            live[sid].to_host(h["pyr"], h["low"], h["hist"])
        host.update(fresh)
        _set_pack_bytes_gauge("3d", total)
        self._pack3d = {"order": order, "slots": {sid: i for i, sid in enumerate(order)}, "packed": packed,
                        "host": host, "bytes": total, "mesh": mesh}
        return self._pack3d["slots"], packed

    def _cs_broadcast_3d(self, config, mesh, use_rotational: bool):
        """The solver plane's hook of a batched 3D round (JAX
        pose_graph.py:2021-2052): None unless the round runs over the
        solver mesh with a broadcast hook. Else ships the pack's change
        first, one cs3d_pack op a newly shipped submap (each op bounded to
        one submap's tables, the full order on the last), waiting for the
        followers, and returns the callable that ships the round's
        candidate arrays (cs3d)."""
        bc = self._solver_broadcast
        if bc is None or mesh is not self._solver_mesh:
            return None
        state = self._pack3d
        self._shipped_pack3d &= set(state["order"])  # a follower drops what leaves the order
        new_sids = [sid for sid in state["order"] if sid not in self._shipped_pack3d]
        if new_sids or self._shipped_order3d != state["order"]:
            for j, sid in enumerate(new_sids or [None]):
                last = j == len(new_sids or [None]) - 1
                order = (list(state["order"]) if last else
                         [s for s in state["order"] if s in self._shipped_pack3d or s in new_sids[:j + 1]])
                bc("cs3d_pack", {"order": order, "new": {} if sid is None else {sid: _numpy_arrays_3d(
                    state["host"][sid])}}, wait=True)
            self._shipped_pack3d.update(new_sids)
            self._shipped_order3d = list(state["order"])
        return lambda arrays: bc("cs3d", {"arrays": arrays, "config": tuple(config),
                                          "use_rotational": use_rotational})

    @staticmethod
    def _node_in_grid(node: PgNode, pg_submap: PgSubmap):
        """The node's current global pose in the submap's grid frame, as an
        f32 numpy Rigid3, and its yaw there."""
        node_in_grid = pg_submap.submap.local_pose.compose(pg_submap.global_pose.inverse().compose(node.global_pose))
        return (Rigid3(node_in_grid.t.astype(np.float32), node_in_grid.q.astype(np.float32)),
                float(nq.quat_yaw(node_in_grid.q)))

    def _candidate(self, node: PgNode, pg_submap: PgSubmap, slot: int):
        """One candidate of sharded_fast_matches_3d_packed: (pack slot,
        clouds, histogram, initial pose, initial yaw)."""
        return (slot, node.high_cloud, node.low_cloud, node.histogram, *self._node_in_grid(node, pg_submap))

    def _inter_constraint(self, pg_submap: PgSubmap, t, q) -> Constraint:
        """The INTER constraint of a refined pose (t, q) in the submap's grid
        frame; the caller fills in its indices."""
        cb = self._options.constraint_builder
        return Constraint(
            submap_index=-1,
            node_index=-1,
            zbar=pg_submap.submap.local_pose.inverse().compose(NpRigid3(np.asarray(t, np.float64),
                                                                        np.asarray(q, np.float64))),
            translation_weight=cb.loop_closure_translation_weight,
            rotation_weight=cb.loop_closure_rotation_weight,
            tag="INTER",
        )

    def _passes_gates(self, score: float, low_score: float, global_search: bool) -> bool:
        """The score and low-resolution gates (ref: constraint_builder_3d.cc
        :228-250), after observing the score."""
        cb = self._options.constraint_builder
        _observe_constraint_score("global" if global_search else "local", score)
        min_score = cb.global_localization_min_score if global_search else cb.min_score
        return not (score < min_score or low_score < cb.fast_correlative_scan_matcher_3d.min_low_resolution_score)

    def _compute_constraint(self, node: PgNode, pg_submap: PgSubmap, global_search: bool = False):
        """(ref: constraint_builder_3d.cc ComputeConstraint:191-296.) The
        fast match from the node's current global pose in the submap's grid
        frame (a full-submap search when global_search), the score and
        low-resolution gates, then GN3D refinement. A submap in the pack is
        searched through it, as a batched round of one; any other through
        its matcher (which uploads demoted tables for the search). The
        returned constraint's indices are filled in by the caller."""
        cb = self._options.constraint_builder
        if pg_submap.matcher is None:
            self._on_submap_finished(pg_submap)
        scan_range = self._scan_range_bucket(node)
        packed = None if self._pack3d is None else self._pack3d["packed"]
        # A mesh pack is searched by whole rounds only (a round of one
        # would be a collective the followers never join).
        slot = (None if packed is None or isinstance(packed, MeshPackedSubmaps3D)
                else self._pack3d["slots"].get(pg_submap.submap_id))
        if slot is not None:
            config = pg_submap.matcher.search_config(scan_range, global_search)
            [(score, low_score, pose)] = sharded_fast_matches_3d_packed(
                self._pack3d["packed"], [self._candidate(node, pg_submap, slot)], config,
                bool(cb.fast_correlative_scan_matcher_3d.use_rotational_scan_matcher))
        else:
            initial, initial_yaw = self._node_in_grid(node, pg_submap)
            f32 = dict(dtype=torch.float32, device=self._device)
            initial = Rigid3(torch.tensor(initial.translation, **f32), torch.tensor(initial.rotation, **f32))
            match_fn = pg_submap.matcher.match_full_submap if global_search else pg_submap.matcher.match
            score, low_score, _, pose = match_fn(initial, node.high_cloud, node.low_cloud, node.histogram,
                                                 initial_yaw, max_scan_range=scan_range)
            score, low_score = torch.stack([score, low_score.to(score.dtype)]).tolist()
        if not self._passes_gates(score, low_score, global_search):
            return None
        cm = cb.ceres_scan_matcher_3d
        refined, _ = match_gn_3d(
            *pg_submap.submap.prepared_grids(),
            node.high_cloud, node.low_cloud, pose, pose.translation,
            cm.occupied_space_weight_0, cm.occupied_space_weight_1, cm.translation_weight, cm.rotation_weight,
            num_iterations=cm.ceres_solver_options.max_num_iterations,
        )
        tq = torch.cat([refined.translation, refined.rotation]).cpu().numpy()
        return self._inter_constraint(pg_submap, tq[:3], tq[3:])

    def _compute_constraints_batched(self, gated, global_search: bool = False):
        """Every candidate of a round (local-window, or full-submap when
        global_search) in one batched fast-matcher search over the pack and
        one packed GN3D refinement of the survivors (the JAX package's
        PoseGraph3D._compute_constraints_batched, :2115-2387, on one card).
        The same gates and refinement parameters as _compute_constraint,
        but one search configuration for the round: its scan range is the
        largest of its nodes' (the serial path uses each node's own).
        Returns a list of Optional[Constraint] aligned with gated; raises
        NotImplementedError on mixed candidate shapes, submap grid types or
        storage dtypes (K3's slot table reads one), for the serial path.

        The JAX package splits the refinement into blocks of at most 8
        distinct submaps (_GN3D_MAX_DISTINCT) to bound its prepared
        tables; K3 reads the grids in place, so the port refines all the
        survivors in one run."""
        cb = self._options.constraint_builder
        fc = cb.fast_correlative_scan_matcher_3d
        matcher_by_sid: Dict[int, object] = {}
        for _, sid, _, p in gated:
            if sid not in matcher_by_sid:
                if p.matcher is None:
                    self._on_submap_finished(p)
                matcher_by_sid[sid] = p.matcher
        matchers = list(matcher_by_sid.values())
        shapes = [
            {tuple(tuple(t.shape) for t in m._pyramid_levels) for m in matchers},
            {tuple(m._low_scores.shape) for m in matchers},
            {m._resolution for m in matchers},
            {tuple(n.high_cloud.positions.shape) for _, _, n, _ in gated},
            {tuple(n.low_cloud.positions.shape) for _, _, n, _ in gated},
            {np.asarray(n.histogram).shape for _, _, n, _ in gated},
            {type(p.submap.high_resolution_grid) for _, _, _, p in gated},
            {volume_dtype(p.submap.high_resolution_grid) for _, _, _, p in gated},
        ]
        if any(len(x) != 1 for x in shapes):
            raise NotImplementedError("mixed candidate shapes, grid types or storage dtypes")
        scan_range = max(self._scan_range_bucket(n) for _, _, n, _ in gated)
        config = matchers[0].search_config(scan_range, global_search)

        prof = {} if ROUND_PROFILING else None

        def stage(name, t0):
            if prof is not None:
                if self._device.type == "cuda":
                    torch.cuda.synchronize(self._device)
                prof[name] = prof.get(name, 0.0) + time.perf_counter() - t0
            return time.perf_counter()

        t0 = time.perf_counter()
        mesh = constraint_search_mesh()
        use_rotational = bool(fc.use_rotational_scan_matcher)
        slot_by_sid, packed = self._get_pack_3d(matcher_by_sid, mesh)
        broadcast = self._cs_broadcast_3d(config, mesh, use_rotational)
        t0 = stage("pack", t0)
        candidates = [self._candidate(node, p, slot_by_sid[sid]) for _, sid, node, p in gated]
        stage("initials", t0)
        matches = sharded_fast_matches_3d_packed(packed, candidates, config, use_rotational, profile=prof,
                                                 broadcast=broadcast)
        survivors = [i for i, (score, low_score, _) in enumerate(matches)
                     if self._passes_gates(score, low_score, global_search)]
        results: List[Optional[Constraint]] = [None] * len(gated)
        if survivors:
            t0 = time.perf_counter()
            # The submaps captured at the gate, not looked up again: a trim
            # since the fast match would have dropped them from
            # self.submaps (a KeyError in the JAX package, ROADMAP C6);
            # _append_constraint then adds nothing to a trimmed one.
            submap_by_sid = {gated[i][1]: gated[i][3].submap for i in survivors}
            distinct = list(submap_by_sid)
            grids = [submap_by_sid[sid].prepared_grids() for sid in distinct]
            pack = prepare_gn_pack_3d([hi for hi, _ in grids], [lo for _, lo in grids])
            lane_d = torch.tensor([distinct.index(gated[i][1]) for i in survivors], dtype=torch.int32,
                                  device=self._device)
            nodes = [gated[i][2] for i in survivors]
            poses = Rigid3(torch.stack([matches[i][2].translation for i in survivors]).to(self._device),
                           torch.stack([matches[i][2].rotation for i in survivors]).to(self._device))
            hi = PointCloud(torch.stack([n.high_cloud.positions for n in nodes]),
                            torch.stack([n.high_cloud.mask for n in nodes]))
            lo = PointCloud(torch.stack([n.low_cloud.positions for n in nodes]),
                            torch.stack([n.low_cloud.mask for n in nodes]))
            t0 = stage("gn_prepare", t0)
            cm = cb.ceres_scan_matcher_3d
            refined, _ = match_gn_3d_packed(
                pack, lane_d, hi, lo, poses, poses.translation, cm.occupied_space_weight_0,
                cm.occupied_space_weight_1, cm.translation_weight, cm.rotation_weight,
                num_iterations=cm.ceres_solver_options.max_num_iterations)
            t0 = stage("gn_launch", t0)
            tq = torch.cat([refined.translation, refined.rotation], dim=1).cpu().numpy()
            stage("gn_readback", t0)
            for k, i in enumerate(survivors):
                results[i] = self._inter_constraint(gated[i][3], tq[k, :3], tq[k, 3:])
        if prof is not None:
            LAST_ROUND_BREAKDOWN.clear()
            LAST_ROUND_BREAKDOWN.update(prof)
        return results

    def _run_optimization(self, num_iterations: int) -> None:
        """(ref: optimization_problem_3d.cc Solve:257-530.) The first submap
        and frozen trajectories are held fixed; INTER constraints carry the
        Huber loss. With any extras family (IMU or odometry routed to the
        graph, as MapBuilder routes them) the full solve runs, else the
        plain Schur solve."""
        nodes, submaps, constraints = self._snapshot_lists()
        S = self._pad_to(len(submaps))
        N = self._pad_to(len(nodes))
        C = self._pad_to(max(len(constraints), 1))
        st = np.zeros((S, 3), np.float32)
        sq = _identity_quats(S)
        nt = np.zeros((N, 3), np.float32)
        nqr = _identity_quats(N)
        s_fixed = np.ones(S, bool)
        n_fixed = np.ones(N, bool)
        for i, s in enumerate(submaps):
            st[i], sq[i] = s.global_pose.t, s.global_pose.q
            s_fixed[i] = i == 0 or self.is_frozen(s.trajectory_id)
        for i, n in enumerate(nodes):
            nt[i], nqr[i] = n.global_pose.t, n.global_pose.q
            n_fixed[i] = self.is_frozen(n.trajectory_id)
        cs = np.zeros(C, np.int64)
        cn = np.zeros(C, np.int64)
        cmask = np.zeros(C, bool)
        crt = np.zeros((C, 3), np.float32)
        crq = _identity_quats(C)
        cwt = np.zeros(C, np.float32)
        cwr = np.zeros(C, np.float32)
        chub = np.full(C, 1e6, np.float32)
        for i, c in enumerate(constraints):
            cs[i], cn[i], cmask[i] = c.submap_index, c.node_index, True
            crt[i], crq[i] = c.zbar.t, c.zbar.q
            cwt[i], cwr[i] = c.translation_weight, c.rotation_weight
            if c.tag == "INTER":
                chub[i] = self._options.optimization_problem.huber_scale
        host = SpaProblem3D(st, sq, nt, nqr, s_fixed, n_fixed, cs, cn, cmask, crt, crq, cwt, cwr, chub)
        problem = SpaProblem3D(*(torch.from_numpy(a).to(self._device) for a in host))
        iterations = min(num_iterations, 50)
        extras = self._build_extras(N, nodes)
        if extras is not None:
            st_o, sq_o, nt_o, nq_o, lt_o, lq_o, _, _, _ = solve_spa_3d_full(problem, extras, num_iterations=iterations)
            lt_o, lq_o = lt_o.cpu().numpy(), lq_o.cpu().numpy()
            self._landmark_poses = {name: NpRigid3(lt_o[idx].astype(np.float64), lq_o[idx].astype(np.float64))
                                    for name, idx in self._landmark_ids.items()}
            self._consume_landmark_overrides(set(self._landmark_ids.values()))
        elif self._solver_mesh is not None:
            # The constraints sharded over the mesh (JAX :2463-2473); the
            # extras-augmented solve above stays on one device. The
            # followers get the problem as numpy.
            if self._solver_broadcast is not None:
                self._solver_broadcast("spa3d", (host, iterations))
            st_o, sq_o, nt_o, nq_o, _ = solve_spa_3d_sharded(host, self._solver_mesh, num_iterations=iterations)
        else:
            st_o, sq_o, nt_o, nq_o, _ = solve_spa_3d(problem, num_iterations=iterations)
        sub = torch.cat([st_o, sq_o], dim=1).cpu().numpy().astype(np.float64)
        nod = torch.cat([nt_o, nq_o], dim=1).cpu().numpy().astype(np.float64)
        with self._lock:
            for i, s in enumerate(submaps):
                s.global_pose = NpRigid3(sub[i, :3], sub[i, 3:])
            for i, n in enumerate(nodes):
                n.global_pose = NpRigid3(nod[i, :3], nod[i, 3:])
            self._correct_post_snapshot(nodes, submaps)


def _pose2_of(p: NpRigid3) -> np.ndarray:
    """(x, y, yaw) f32 of a host pose."""
    return np.array([p.t[0], p.t[1], nq.quat_yaw(p.q)], np.float32)


def _rigid_of_pose2(v) -> NpRigid3:
    """The host pose of (x, y, yaw)."""
    return NpRigid3(np.array([v[0], v[1], 0.0]), nq.quat_from_axis_angle(np.array([0.0, 0.0, float(v[2])])))


class PoseGraph2D(PoseGraphBase):
    """(ref: mapping/internal/2d/pose_graph_2d.cc; the JAX package's
    PoseGraph2D, pose_graph.py :896-1600.)

    Each finished submap's fast matcher is prepared on first use, once per
    search depth (local-window and full-submap searches differ in depth),
    and kept by stable submap id (_submap_matcher); the serial refinement's
    wide-row field likewise, on first serial use (_gn_field; the JAX
    package builds it with the matcher, the batched round never reads
    it). With use_batched_constraint_search a round of two or more gated
    candidates is searched over the finished submaps' pack of its depth
    (_get_pack_2d): one K5 launch per pyramid level for the round, then
    one packed GN refinement of the survivors against the pack's raw
    grids. Every SPA solve with a trajectory of two or more nodes runs
    solve_spa_2d_full, since the local-SLAM relative poses between
    consecutive nodes are always a family; otherwise solve_spa_2d.

    Submaps hold probability grids, f32 or uint16 codes. A TSDF submap's
    matcher raises TypeError (ROADMAP C20, mirrored): the reference's
    TSDF branches of _submap_matcher and _get_pack_2d (pose_graph.py
    :1082-1083, :1134-1137) are never reached there and are not ported."""

    def __init__(self, options, max_scan_range: float = 30.0, device="cuda"):
        """Runs on the card unless `device` says otherwise; without one it
        raises."""
        self._device = torch.device(device)
        if self._device.type == "cuda":
            _build.load_library()  # before the worker thread can launch a kernel
        self._max_scan_range = max_scan_range
        # submap_id -> {depth: PreparedFastMatcher2D, "gn": the serial
        # refinement's prepared field}.
        self._matcher_cache: Dict[int, dict] = {}
        # The packs of the batched search, one per search depth (see
        # _get_pack_2d): the round counter and each submap's last round,
        # for most-recently-used retention.
        self._packs2d: Dict[int, dict] = {}
        self._pack2d_round = 0
        self._pack2d_used: Dict[int, int] = {}
        self.batched_fallbacks = 0  # rounds of mixed shapes sent to the serial path
        super().__init__(options)

    def _build_extras(self, N_cap: int, nodes=None):
        """SpaExtras2D on the device from the buffered sensors, or None when
        every family is empty (ref: optimization_problem_2d.cc :278-298).
        Each pair of consecutive nodes of a trajectory that is not frozen
        gets the local-SLAM relative pose, and the odometry one where the
        buffer covers both times."""
        nodes = self.nodes if nodes is None else nodes
        opt = self._options.optimization_problem
        nn = []
        by_traj: Dict[int, List[int]] = {}
        for i, n in enumerate(nodes):
            by_traj.setdefault(n.trajectory_id, []).append(i)
        for tid, idxs in by_traj.items():
            if self.is_frozen(tid):
                continue
            odom = self._odometry.get(tid, [])
            for a, b in zip(idxs[:-1], idxs[1:]):
                na, nb = nodes[a], nodes[b]
                oa, ob = self._lookup_buffer(odom, na.time), self._lookup_buffer(odom, nb.time)
                if oa is not None and ob is not None:
                    nn.append((a, b, _pose2_of(oa.inverse().compose(ob)), opt.odometry_translation_weight,
                               opt.odometry_rotation_weight))
                nn.append((a, b, _pose2_of(na.local_pose.inverse().compose(nb.local_pose)),
                           opt.local_slam_pose_translation_weight, opt.local_slam_pose_rotation_weight))
        has_ff = any(self._fixed_frame.values())
        has_lm = bool(self._landmark_observations)
        if not nn and not has_ff and not has_lm:
            return None

        P = self._pad_to(max(len(nn), 1))
        L = max(len(self._landmark_ids), 1)
        O = self._pad_to(max(len(self._landmark_observations), 1))
        fields = {k: v.numpy() for k, v in empty_extras_2d(N_cap, p=P, l=L, o=O, device="cpu")._asdict().items()}
        for i, (a, b, rel, wt, wr) in enumerate(nn):
            for name, v in (("nn_a", a), ("nn_b", b), ("nn_mask", True), ("nn_rel_pose", rel),
                            ("nn_translation_weight", wt), ("nn_rotation_weight", wr)):
                fields[name][i] = v
        if has_ff:
            for i, n in enumerate(nodes):
                pose = self._lookup_buffer(self._fixed_frame.get(n.trajectory_id, []), n.time)
                if pose is not None:
                    fields["ff_mask"][i] = True
                    fields["ff_pose"][i] = _pose2_of(pose)
                    fields["ff_translation_weight"][i] = opt.fixed_frame_pose_translation_weight
        if has_lm:
            # Each observation binds to the node of its own trajectory at or
            # before its time; client overrides seed the landmark poses.
            times_by_traj: Dict[int, Tuple[list, list]] = {}
            for i, n in enumerate(nodes):
                times_by_traj.setdefault(n.trajectory_id, ([], []))[0].append(n.time)
                times_by_traj[n.trajectory_id][1].append(i)
            lm_init: Dict[int, np.ndarray] = {}
            for name, pose in self._landmark_pose_overrides.items():
                li = self._landmark_ids.get(name)
                if li is not None:
                    lm_init[li] = _pose2_of(pose)
            count = 0
            for obs in self._landmark_observations:
                if count >= O:
                    break
                times_t, idx_t = times_by_traj.get(obs["trajectory_id"], (None, None))
                if times_t is None:
                    continue
                j = idx_t[min(max(int(np.searchsorted(times_t, obs["time"])) - 1, 0), len(idx_t) - 1)]
                for name, v in (("lm_node", j), ("lm_index", obs["landmark_index"]), ("lm_mask", True),
                                ("lm_rel_pose", _pose2_of(obs["transform"])),
                                ("lm_translation_weight", obs["translation_weight"]),
                                ("lm_rotation_weight", obs["rotation_weight"])):
                    fields[name][count] = v
                if obs["landmark_index"] not in lm_init:
                    lm_init[obs["landmark_index"]] = _pose2_of(nodes[j].global_pose.compose(obs["transform"]))
                count += 1
            for li, pose in lm_init.items():
                fields["landmark_pose"][li] = pose
                fields["landmark_mask"][li] = True
        return SpaExtras2D(**{k: torch.from_numpy(np.asarray(v)).to(self._device) for k, v in fields.items()})

    def _on_submap_finished(self, pg_submap: PgSubmap) -> None:
        pass  # the matcher is prepared on its first candidate, per search depth

    def _forget_submaps(self, removed_sids) -> None:
        """The trimmed submaps' matchers and refinement fields leave the
        cache, and a pack of either search depth that holds one is dropped,
        as in the JAX package."""
        for sid in removed_sids:
            self._matcher_cache.pop(sid, None)
            self._pack2d_used.pop(sid, None)
        for depth in [d for d, state in self._packs2d.items() if removed_sids & set(state["slots"])]:
            del self._packs2d[depth]

    def _submap_matcher(self, pg_submap: PgSubmap, depth: int):
        """The submap's fast matcher at `depth`, prepared once per finished
        submap and depth (ref: constraint_builder_2d.cc
        DispatchScanMatcherConstruction), kept by stable submap id."""
        per_sid = self._matcher_cache.setdefault(pg_submap.submap_id, {})
        if depth not in per_sid:
            per_sid[depth] = prepare_fast_matcher_2d(pg_submap.submap.grid, depth)
        return per_sid[depth]

    def _gn_field(self, pg_submap: PgSubmap):
        """The serial refinement's prepared probability field of the
        submap, built on first use, kept by stable submap id."""
        per_sid = self._matcher_cache.setdefault(pg_submap.submap_id, {})
        if "gn" not in per_sid:
            per_sid["gn"] = prepare_gn_probability_field(pg_submap.submap.grid)
        return per_sid["gn"]

    def _get_pack_2d(self, needed: Dict[int, PgSubmap], depth: int, mesh=None):
        """The finished submaps' search state on the card for a batched
        round of `depth` (PoseGraph2D._get_pack_2d of the JAX package,
        :1089-1218): the fast matchers' levels and corners, and the raw
        probability grids the packed refinement reads. Rebuilt only when a
        needed submap is not packed. Membership: this round's submaps, then
        the previous pack's other members most recently used first while
        the pack fits constraint_builder.pack_hbm_budget_bytes (the levels
        and the grid a submap). With a mesh the levels are partitioned over
        its shards (a MeshPackedSubmaps2D; the grid pack stays on the
        graph's device, as the JAX package replicates it), and a change of
        mesh rebuilds them. Returns (slot by submap id, the pack, the grid
        pack).

        ROADMAP C6, fixed rather than mirrored: the JAX package drops an
        evicted submap's host copies, so re-admitting it downloads them
        again. Here the pack is built on the card from each submap's
        prepared matcher and grid, which stay on the card: eviction only
        frees the submap's slot, and re-admission copies from the device
        again, the same bits as before."""
        self._pack2d_round += 1
        for sid in needed:
            self._pack2d_used[sid] = self._pack2d_round
        state = self._packs2d.get(depth)
        if state is not None and state["mesh"] is mesh and all(sid in state["slots"] for sid in needed):
            return state["slots"], state["packed"], state["gn"]
        prev_order = state["order"] if state is not None else []
        with self._lock:
            live = {s.submap_id: s for s in self.submaps}
        order = [sid for sid in prev_order if depth in self._matcher_cache.get(sid, {}) and sid in live]
        order += [sid for sid in needed if sid not in order]
        pg_by_sid = {**live, **needed}
        grids = {sid: ensure_f32_grid(pg_by_sid[sid].submap.grid) for sid in order}
        fast = {sid: self._matcher_cache[sid][depth] for sid in order}
        # A uint16 submap is packed decoded: its f32 levels and f32 plane.
        bytes_of = {sid: fast[sid].flat_levels.numel() * 4 + grids[sid].log_odds.numel() * 4 for sid in order}
        budget = int(self._options.constraint_builder.pack_hbm_budget_bytes)
        members = {sid for sid in order if sid in needed}
        total = sum(bytes_of[sid] for sid in members)
        for sid in sorted((s for s in order if s not in members), key=lambda s: -self._pack2d_used.get(s, 0)):
            if total + bytes_of[sid] > budget:
                break
            members.add(sid)
            total += bytes_of[sid]
        order = [sid for sid in order if sid in members]
        _set_pack_bytes_gauge("2d", total)
        if len({tuple(fast[sid].flat_levels.shape) for sid in order}) != 1:
            raise NotImplementedError("mixed pyramid shapes")
        p0 = fast[order[0]]
        packed = pack_submaps_2d_from_arrays([(fast[sid].flat_levels, fast[sid].meta.min_corner) for sid in order],
                                             float(p0.meta.resolution), p0.dims,
                                             self._device if mesh is None else mesh)
        gn = {
            "values": torch.stack([grids[sid].probability() for sid in order]),
            "min_corners": (packed.min_corners if mesh is None else torch.stack(
                [fast[sid].meta.min_corner for sid in order]).to(device=self._device, dtype=torch.float32)),
            "resolution": float(p0.meta.resolution),
            "pad_value": float(pv.MIN_PROBABILITY),
        }
        self._packs2d[depth] = {"order": order, "slots": {sid: i for i, sid in enumerate(order)}, "packed": packed,
                                "gn": gn, "bytes": total, "mesh": mesh, "res": float(p0.meta.resolution),
                                "dims": tuple(p0.dims)}
        return self._packs2d[depth]["slots"], packed, gn

    def _cs_broadcast_2d(self, config, mesh):
        """The solver plane's hook of a batched 2D round (JAX
        pose_graph.py:1292-1330): None unless the round runs over the
        solver mesh with a broadcast hook. Else ships the pack's change
        (the levels and corner of each newly shipped submap, once: finished
        grids do not change; the full order), waiting for the followers,
        and returns the callable that ships the round's candidate arrays
        (cs2d)."""
        bc = self._solver_broadcast
        if bc is None or mesh is not self._solver_mesh:
            return None
        depth = config.depth
        state = self._packs2d[depth]
        # A follower drops what leaves the order.
        self._shipped_pack2d -= {(sid, d) for sid, d in self._shipped_pack2d
                                 if d == depth and sid not in state["slots"]}
        new = {}
        for sid in state["order"]:
            if (sid, depth) not in self._shipped_pack2d:
                fast = self._matcher_cache[sid][depth]
                new[sid] = {"levels": fast.flat_levels.cpu().numpy(),
                            "mc": fast.meta.min_corner.to(torch.float32).cpu().numpy()}
        if new or self._shipped_order2d.get(depth) != state["order"]:
            bc("cs2d_pack", {"depth": depth, "order": list(state["order"]), "new": new, "res": state["res"],
                             "dims": state["dims"]}, wait=True)
            self._shipped_pack2d.update((sid, depth) for sid in new)
            self._shipped_order2d[depth] = list(state["order"])
        return lambda arrays: bc("cs2d", {"depth": depth, "arrays": arrays, "config": tuple(config)})

    @staticmethod
    def _initial_in_grid(node: PgNode, pg_submap: PgSubmap):
        """The node's current global pose in the submap's grid frame (the
        local SLAM frame the grid was built in) as f32 numpy (x, y, yaw)."""
        node_in_grid = pg_submap.submap.local_pose.compose(pg_submap.global_pose.inverse().compose(node.global_pose))
        return node_in_grid.t[:2].astype(np.float32), np.float32(nq.quat_yaw(node_in_grid.q))

    def _search_config(self, pg_submap: PgSubmap, scan_range: float, global_search: bool):
        """(config, min_score): the full-submap search (ref:
        MatchFullSubmap: a window of half the grid, the full angular range)
        or the local window."""
        cb = self._options.constraint_builder
        fm = cb.fast_correlative_scan_matcher
        res = float(pg_submap.submap.grid.meta.resolution)
        if global_search:
            return (make_fast_search_config(pg_submap.submap.grid.shape[0] * res / 2.0, math.pi, res, scan_range,
                                            fm.branch_and_bound_depth), cb.global_localization_min_score)
        return (make_fast_search_config(fm.linear_search_window, fm.angular_search_window, res, scan_range,
                                        fm.branch_and_bound_depth), cb.min_score)

    def _inter_constraint(self, pg_submap: PgSubmap, pose2) -> Constraint:
        """The INTER constraint of a refined grid-frame pose (x, y, yaw);
        the caller fills in its indices."""
        cb = self._options.constraint_builder
        return Constraint(submap_index=-1, node_index=-1,
                          zbar=pg_submap.submap.local_pose.inverse().compose(_rigid_of_pose2(pose2)),
                          translation_weight=cb.loop_closure_translation_weight,
                          rotation_weight=cb.loop_closure_rotation_weight, tag="INTER")

    def _compute_constraint(self, node: PgNode, pg_submap: PgSubmap, global_search: bool = False):
        """(ref: constraint_builder_2d.cc ComputeConstraint.) The fast match
        from the node's current global pose in the submap's grid frame (a
        full-submap search when global_search), gated by min_score
        (global_localization_min_score for full-submap searches), then the
        GN refinement. The returned constraint's indices are filled in by
        the caller."""
        config, min_score = self._search_config(pg_submap, self._scan_range_bucket(node), global_search)
        fast = self._submap_matcher(pg_submap, config.depth)
        t, yaw = self._initial_in_grid(node, pg_submap)
        f32 = dict(dtype=torch.float32, device=self._device)
        initial = Rigid2(torch.tensor(t, **f32), torch.tensor(yaw, **f32))
        score, pose = match_fast_2d_prepared(fast, node.cloud, initial, config)
        score = float(score)
        _observe_constraint_score("global" if global_search else "local", score)
        if score < min_score:
            return None
        cm = self._options.constraint_builder.ceres_scan_matcher
        refined, _ = match_gn_2d_probability(
            None, node.cloud, pose, pose.translation, cm.occupied_space_weight, cm.translation_weight,
            cm.rotation_weight, num_iterations=cm.ceres_solver_options.max_num_iterations,
            prepared_field=self._gn_field(pg_submap))
        return self._inter_constraint(pg_submap, torch.cat([refined.translation, refined.angle[None]]).cpu().numpy())

    def _compute_constraints_batched(self, gated, global_search: bool = False):
        """Every candidate of a round (local-window, or full-submap when
        global_search) in one batched fast-matcher search over the pack of
        its depth and one packed GN refinement of the survivors (the JAX
        package's PoseGraph2D._compute_constraints_batched, :1327-1507, on
        one card). The same gates and refinement parameters as
        _compute_constraint, but one search configuration for the round:
        its scan range is the largest of its nodes' (the serial path uses
        each node's own). Returns a list of Optional[Constraint] aligned
        with gated; raises NotImplementedError on mixed resolutions, cloud
        sizes or grid extents, for the serial path."""
        shapes = [
            {float(p.submap.grid.meta.resolution) for _, _, _, p in gated},
            {n.cloud.mask.shape[0] for _, _, n, _ in gated},
            {p.submap.grid.shape[0] for _, _, _, p in gated},
        ]
        if any(len(x) != 1 for x in shapes):
            raise NotImplementedError("mixed candidate shapes")
        scan_range = max(self._scan_range_bucket(n) for _, _, n, _ in gated)
        config, min_score = self._search_config(gated[0][3], scan_range, global_search)
        prof = {} if ROUND_PROFILING else None

        def stage(name, t0):
            if prof is not None:
                if self._device.type == "cuda":
                    torch.cuda.synchronize(self._device)
                prof[name] = prof.get(name, 0.0) + time.perf_counter() - t0
            return time.perf_counter()

        t0 = time.perf_counter()
        needed: Dict[int, PgSubmap] = {}
        for _, sid, _, p in gated:
            if sid not in needed:
                self._submap_matcher(p, config.depth)
                needed[sid] = p
        mesh = constraint_search_mesh()
        slot_by_sid, packed, gn = self._get_pack_2d(needed, config.depth, mesh)
        broadcast = self._cs_broadcast_2d(config, mesh)
        t0 = stage("pack", t0)
        candidates = [(slot_by_sid[sid], node.cloud, Rigid2(*self._initial_in_grid(node, p)))
                      for _, sid, node, p in gated]
        stage("initials", t0)
        matches = sharded_fast_matches_2d_packed(packed, candidates, config, profile=prof, broadcast=broadcast)
        survivors = []
        for i, (score, _) in enumerate(matches):
            _observe_constraint_score("global" if global_search else "local", score)
            if score >= min_score:
                survivors.append(i)
        results: List[Optional[Constraint]] = [None] * len(gated)
        if survivors:
            t0 = time.perf_counter()
            slots = torch.tensor([slot_by_sid[gated[i][1]] for i in survivors], dtype=torch.int64,
                                 device=self._device)
            poses = Rigid2(torch.stack([matches[i][1].translation for i in survivors]).to(self._device),
                           torch.stack([matches[i][1].angle for i in survivors]).to(self._device))
            clouds = [gated[i][2].cloud for i in survivors]
            if all(c is clouds[0] for c in clouds):  # one node against many submaps
                clouds = PointCloud(clouds[0].positions.expand(len(clouds), -1, -1),
                                    clouds[0].mask.expand(len(clouds), -1))
            else:
                clouds = PointCloud(torch.stack([c.positions for c in clouds]), torch.stack([c.mask for c in clouds]))
            t0 = stage("gn_prepare", t0)
            cm = self._options.constraint_builder.ceres_scan_matcher
            refined, _ = match_gn_2d_packed_grids(
                gn["values"], None, gn["min_corners"], gn["resolution"], gn["pad_value"], slots, clouds, poses,
                poses.translation, cm.occupied_space_weight, cm.translation_weight, cm.rotation_weight,
                is_tsdf=False, num_iterations=cm.ceres_solver_options.max_num_iterations)
            t0 = stage("gn_launch", t0)
            out = torch.cat([refined.translation, refined.angle[:, None]], dim=1).cpu().numpy()
            stage("gn_readback", t0)
            for k, i in enumerate(survivors):
                results[i] = self._inter_constraint(gated[i][3], out[k])
        if prof is not None:
            LAST_ROUND_BREAKDOWN.clear()
            LAST_ROUND_BREAKDOWN.update(prof)
        return results

    def _run_optimization(self, num_iterations: int) -> None:
        """(ref: optimization_problem_2d.cc Solve.) The first submap and
        frozen trajectories are held fixed; INTER constraints carry the
        Huber loss. With any extras family the full solve runs, else the
        plain one (Schur or PCG by size)."""
        nodes, submaps, constraints = self._snapshot_lists()
        S = self._pad_to(len(submaps))
        N = self._pad_to(len(nodes))
        C = self._pad_to(max(len(constraints), 1))
        submap_pose = np.zeros((S, 3), np.float32)
        node_pose = np.zeros((N, 3), np.float32)
        submap_fixed = np.ones(S, bool)
        node_fixed = np.ones(N, bool)
        for i, s in enumerate(submaps):
            submap_pose[i] = _pose2_of(s.global_pose)
            submap_fixed[i] = i == 0 or self.is_frozen(s.trajectory_id)
        for i, n in enumerate(nodes):
            node_pose[i] = _pose2_of(n.global_pose)
            node_fixed[i] = self.is_frozen(n.trajectory_id)
        cs = np.zeros(C, np.int64)
        cn = np.zeros(C, np.int64)
        cmask = np.zeros(C, bool)
        crel = np.zeros((C, 3), np.float32)
        cwt = np.zeros(C, np.float32)
        cwr = np.zeros(C, np.float32)
        chub = np.full(C, 1e6, np.float32)
        for i, c in enumerate(constraints):
            cs[i], cn[i], cmask[i] = c.submap_index, c.node_index, True
            crel[i] = _pose2_of(c.zbar)
            cwt[i], cwr[i] = c.translation_weight, c.rotation_weight
            if c.tag == "INTER":
                chub[i] = self._options.optimization_problem.huber_scale
        host = SpaProblem2D(submap_pose, node_pose, submap_fixed, node_fixed, cs, cn, cmask, crel, cwt, cwr, chub)
        problem = SpaProblem2D(*(torch.from_numpy(a).to(self._device) for a in host))
        iterations = min(num_iterations, 50)
        extras = self._build_extras(N, nodes)
        if extras is not None:
            sub_out, node_out, lm_out, _ = solve_spa_2d_full(problem, extras, num_iterations=iterations)
            lm_out = lm_out.cpu().numpy()
            self._landmark_poses = {name: _rigid_of_pose2(lm_out[idx]) for name, idx in self._landmark_ids.items()}
            self._consume_landmark_overrides(set(self._landmark_ids.values()))
        elif self._solver_mesh is not None:
            # The constraints sharded over the mesh (JAX :1570-1589); the
            # extras-augmented solve above stays on one device.
            if self._solver_broadcast is not None:
                self._solver_broadcast("spa2d", (host, iterations))
            sub_out, node_out, _ = solve_spa_2d_sharded(host, self._solver_mesh, num_iterations=iterations)
        else:
            sub_out, node_out, _ = solve_spa_2d(problem, num_iterations=iterations)
        sub_out, node_out = sub_out.cpu().numpy(), node_out.cpu().numpy()
        with self._lock:
            for i, s in enumerate(submaps):
                s.global_pose = _rigid_of_pose2(sub_out[i])
            for i, n in enumerate(nodes):
                n.global_pose = _rigid_of_pose2(node_out[i])
            self._correct_post_snapshot(nodes, submaps)
