"""The port's pose-graph trimming (hectorgrapher_tpu_torch/mapping/
pose_graph/trimmers.py and its use in pose_graph.py) against the JAX
package's, on the CPU:

- PureLocalizationTrimmer against the JAX one on
  tests/test_trimmers_connectivity.py's graph (:99-107): the same submaps,
  nodes and constraints kept, indices remapped alike;
- a trim between constraint rounds (tests/test_pack_budget.py:131
  test_trim_between_rounds_keeps_rounds_correct) over the port's own
  pack: the trimmed ids leave the pack, its host cache, the
  most-recently-used record and the gauge, and the next round finds the
  constraints of a fresh pose graph that never had the trimmed submap;
- the trimmer run by an optimization, which drops the pack;
- a trim between a round's fast match and its refinement (ROADMAP C6),
  forced by a hook: no KeyError, the round whole, no constraint added to
  the trimmed submap.

Tolerances: constraints (zbar) within 1e-3 m and |1 - |dq0|| < 1e-6, the
batched search's own (tests/test_torch_constraint_search_3d.py); the
bookkeeping exactly.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import hectorgrapher_tpu_torch.mapping.pose_graph.pose_graph as pg_mod
from hectorgrapher_tpu.mapping.pose_graph.trimmers import PureLocalizationTrimmer as JPureLocalizationTrimmer
from hectorgrapher_tpu.transform import np_quat as nq
from hectorgrapher_tpu_torch import convert
from hectorgrapher_tpu_torch.mapping.pose_graph.pose_graph import Constraint, PgNode, PgSubmap, PoseGraph3D
from hectorgrapher_tpu_torch.mapping.pose_graph.trimmers import PureLocalizationTrimmer, trim_submaps
from hectorgrapher_tpu_torch.parallel.constraint_search import host_arrays_3d_nbytes
from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3
from test_batched_constraint_path import HIST, active_submap_3d, build_finished_submap_3d, node_3d, options_3d
from test_trimmers_connectivity import build_graph
from torch_parity import CPU

torch.set_num_threads(1)


def _port_graph(num_submaps=5, nodes_per=2):
    """tests/test_trimmers_connectivity.py build_graph in the port's
    PoseGraph3D: finished submaps 1 m apart, each with nodes_per nodes
    INTRA to it (the submaps' grids are never read by a trim)."""
    pg = PoseGraph3D(convert.options(options_3d(False)), device=CPU)
    for si in range(num_submaps):
        submap = SimpleNamespace(local_pose=NpRigid3(np.array([si * 1.0, 0, 0])), insertion_finished=True)
        pg.submaps.append(PgSubmap(submap=submap, global_pose=NpRigid3(np.array([si * 1.0, 0, 0])), finished=True,
                                   submap_id=si))
        pg._submap_ids[id(submap)] = si
        pg._submap_index_by_id[si] = si
        pg._next_submap_id = si + 1
        for k in range(nodes_per):
            ni = len(pg.nodes)
            pose = NpRigid3(np.array([si + 0.5 * k, 0, 0]))
            pg.nodes.append(PgNode(time=float(ni), local_pose=pose, global_pose=pose, node_id=ni))
            pg._node_index_by_id[ni] = ni
            pg._next_node_id = ni + 1
            pg.constraints.append(Constraint(si, ni, NpRigid3.identity(), 1.0, 1.0, "INTRA"))
    return pg


def _bookkeeping(pg):
    return ([float(s.submap.local_pose.t[0]) for s in pg.submaps], [n.node_id for n in pg.nodes],
            [(c.submap_index, c.node_index) for c in pg.constraints], dict(pg._submap_index_by_id),
            dict(pg._node_index_by_id))


def test_pure_localization_trimmer_matches_jax():
    jpg, pg = build_graph(num_submaps=6), _port_graph(num_submaps=6)
    assert _bookkeeping(pg) == _bookkeeping(jpg)
    JPureLocalizationTrimmer(trajectory_id=0, max_submaps_to_keep=3).trim(jpg)
    trimmer = PureLocalizationTrimmer(trajectory_id=0, max_submaps_to_keep=3)
    trimmer.trim(pg)
    assert _bookkeeping(pg) == _bookkeeping(jpg)
    assert len(pg.submaps) == 3 and [x for x in _bookkeeping(pg)[0]] == [3.0, 4.0, 5.0]
    assert not trimmer.is_finished()
    trimmer.trim(pg)  # nothing left in excess
    assert _bookkeeping(pg) == _bookkeeping(jpg)
    # Another trajectory's submaps are not its business.
    other = PureLocalizationTrimmer(trajectory_id=1, max_submaps_to_keep=2)
    other.trim(pg)
    assert len(pg.submaps) == 3
    with pytest.raises(ValueError):
        PureLocalizationTrimmer(trajectory_id=0, max_submaps_to_keep=1)


@pytest.fixture(scope="module")
def anchors4():
    """tests/test_pack_budget.py's four finished anchors around one room."""
    return [
        build_finished_submap_3d([np.zeros(3), np.array([0.4, 0.3, 0.0])]),
        build_finished_submap_3d([np.array([0.3, -0.3, 0.0]), np.array([0.7, 0.0, 0.0])]),
        build_finished_submap_3d([np.array([-0.3, 0.2, 0.0]), np.array([0.0, 0.4, 0.0])]),
        build_finished_submap_3d([np.array([0.2, 0.2, 0.0]), np.array([-0.4, 0.0, 0.0])]),
    ]


def _drive(anchors, returning=((1.0, [0.25, -0.15, 0.0], [0.3, 0.0, 0.0]),)):
    """tests/test_pack_budget.py drive through the port's PoseGraph3D
    (batched search, no budget): one node INTRA to each anchor, then
    returning nodes (time, truth, drift) INTRA only to an active
    submap, each starting a round over every anchor."""
    pg = PoseGraph3D(convert.options(options_3d(True)), histogram_size=HIST, device=CPU)
    for i, a in enumerate(anchors):
        t = [0.1 * i, 0.05 * i, 0.0]
        pg.add_node(convert.pg_node(node_3d(0.1 * i, t, t), CPU), [convert.submap_3d(a, CPU)])
    for time, truth, drift in returning:
        _return(pg, time, truth, drift)
    return pg


def _return(pg, time, truth, drift):
    truth = np.asarray(truth)
    pg.add_node(convert.pg_node(node_3d(time, truth + np.asarray(drift), truth), CPU),
                [convert.submap_3d(active_submap_3d(), CPU)])
    pg.wait_for_all_computations()


def _inter_of_last_node(pg):
    """The last node's INTER constraints as (anchor position in the
    graph's submap list, zbar), sorted."""
    last = len(pg.nodes) - 1
    return sorted(((c.submap_index, c.zbar) for c in pg.constraints if c.tag == "INTER" and c.node_index == last),
                  key=lambda x: x[0])


def _assert_same_inter(got, want):
    assert len(got) >= 1 and [s for s, _ in got] == [s for s, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a.t, b.t, rtol=0, atol=1e-3)
        dq = nq.quat_multiply(nq.quat_conjugate(a.q), b.q)
        assert abs(1.0 - abs(dq[0])) < 1e-6


def _gauge():
    line = next(line for line in pg_mod.profiling.report().splitlines()
                if line.startswith("pose_graph_constraint_pack_bytes_3d "))
    return float(line.split()[-1])


def test_trim_between_rounds_keeps_rounds_correct(anchors4):
    pg = _drive(anchors4)
    pack = pg._pack3d
    trimmed_sid = pg.submaps[0].submap_id
    assert pack is not None and trimmed_sid in pack["slots"] and trimmed_sid in pg._pack3d_used
    assert _gauge() == pack["bytes"] > 0
    trim_submaps(pg, {0})
    assert all(s.submap_id != trimmed_sid for s in pg.submaps)
    assert pg._pack3d is None and trimmed_sid not in pack["host"] and trimmed_sid not in pg._pack3d_used
    assert _gauge() == 0
    second = (2.0, [0.2, -0.1, 0.0], [0.25, 0.0, 0.0])
    _return(pg, *second)
    pack = pg._pack3d
    assert trimmed_sid not in pack["order"] and trimmed_sid not in pack["host"]
    assert pack["bytes"] == sum(host_arrays_3d_nbytes(pack["host"][sid]) for sid in pack["order"]) == _gauge()
    # A graph that never had the trimmed anchor finds the same constraints.
    fresh = _drive(anchors4[1:], returning=((1.0, [0.25, -0.15, 0.0], [0.3, 0.0, 0.0]), second))
    _assert_same_inter(_inter_of_last_node(pg), _inter_of_last_node(fresh))


def test_optimization_runs_the_trimmer_and_drops_the_pack(anchors4):
    """A PureLocalizationTrimmer in pose_graph.trimmers trims after the
    optimization: 5 submaps (4 anchors + the active one) down to 3, the
    pack dropped, and the next round packs only survivors."""
    pg = _drive(anchors4)
    pg.trimmers.append(PureLocalizationTrimmer(trajectory_id=0, max_submaps_to_keep=3))
    trimmed = {s.submap_id for s in pg.submaps[:2]}
    pg.run_final_optimization()
    assert len(pg.submaps) == 3 and not trimmed & {s.submap_id for s in pg.submaps}
    assert pg._pack3d is None and not trimmed & set(pg._pack3d_used)
    pg.trimmers.clear()
    _return(pg, 2.0, [0.2, -0.1, 0.0], [0.25, 0.0, 0.0])
    assert pg._pack3d is not None and not trimmed & (set(pg._pack3d["order"]) | set(pg._pack3d["host"]))


def test_trim_during_round_adds_no_constraint_to_the_trimmed_submap(anchors4, monkeypatch):
    """ROADMAP C6: a trim between a round's fast match and its refinement
    (here forced by a hook on the fast match; on the card a trimmer on
    the optimization path can do it) used to re-resolve the survivors'
    submaps by id and raise KeyError. The round now refines the submaps it
    captured and adds no constraint to the trimmed one; the others are the
    untrimmed round's."""
    want = _drive(anchors4)
    want_inter = _inter_of_last_node(want)
    assert 0 in [s for s, _ in want_inter]  # the anchor to be trimmed survives the gates
    orig = pg_mod.sharded_fast_matches_3d_packed
    state = {"pg": None, "armed": False}

    def hook(packed, candidates, *args, **kwargs):
        out = orig(packed, candidates, *args, **kwargs)
        if state["armed"] and len(candidates) >= 2:
            state["armed"] = False
            pg = state["pg"]
            with pg._lock:
                trim_submaps(pg, {0})
        return out

    monkeypatch.setattr(pg_mod, "sharded_fast_matches_3d_packed", hook)
    pg = _drive(anchors4, returning=())
    state.update(pg=pg, armed=True)
    trimmed_sid = pg.submaps[0].submap_id
    _return(pg, 1.0, [0.25, -0.15, 0.0], [0.3, 0.0, 0.0])
    assert not state["armed"]  # the hook fired
    assert all(s.submap_id != trimmed_sid for s in pg.submaps)
    got = _inter_of_last_node(pg)
    # Positions shift by one: the trimmed anchor was position 0.
    _assert_same_inter([(s + 1, z) for s, z in got], [(s, z) for s, z in want_inter if s != 0])
