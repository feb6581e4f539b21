"""The port's evaluation metrics and relations files
(hectorgrapher_tpu_torch/evaluation/{metrics,relations_text_file}.py)
against the JAX package's, on the same inputs: the cases of
tests/test_evaluation_metrics.py through both packages, relations
generated from one pose graph (and from one decoded pbstream state) by
both, and relations files written by one package and read by the other.

Tolerance: equal results. Both are numpy in float64, op for op.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

from hectorgrapher_tpu.evaluation import metrics as jm
from hectorgrapher_tpu.evaluation import relations_text_file as jr
from hectorgrapher_tpu.io import pbstream as jpb
from hectorgrapher_tpu.transform import np_quat as jnq
from hectorgrapher_tpu.transform.np_quat import NpRigid3 as JRigid3
from hectorgrapher_tpu_torch.evaluation import metrics as tm
from hectorgrapher_tpu_torch.evaluation import relations_text_file as tr
from hectorgrapher_tpu_torch.io import pbstream as tpb
from hectorgrapher_tpu_torch.transform import np_quat as tnq
from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3 as TRigid3

PACKAGES = {"jax": (jm, JRigid3, jnq), "port": (tm, TRigid3, tnq)}


def line_trajectory(rigid, nq, n=20, speed=0.5, dt=0.1):
    times = [i * dt for i in range(n)]
    return times, [rigid(np.array([speed * t, 0.0, 0.0]), nq.quat_identity()) for t in times]


def _rel(r):
    return (r.time1, r.time2, tuple(r.expected.t), tuple(r.expected.q))


def _metrics(m):
    return dataclasses.astuple(m)


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_evaluation_metrics_cases(package):
    """tests/test_evaluation_metrics.py's four cases."""
    m, rigid, nq = PACKAGES[package]
    times, poses = line_trajectory(rigid, nq)
    relations = m.relations_from_ground_truth(times, poses, 0.2)
    assert len(relations) > 5
    perfect = m.compute_relation_metrics(m.TrajectoryInterpolator(times, poses), relations)
    assert perfect.abs_translational_error_mean < 1e-9 and perfect.abs_rotational_error_deg_mean < 1e-6

    slow = [rigid(p.t * 0.9, p.q) for p in poses]
    biased = m.compute_relation_metrics(m.TrajectoryInterpolator(times, slow), relations)
    np.testing.assert_allclose(biased.abs_translational_error_mean, 0.01, atol=1e-6)

    shifted = [rigid(p.t + np.array([5.0, -3.0, 1.0]), p.q) for p in poses]
    assert m.ate_rmse(times, shifted, times, poses, align=True) < 1e-6
    assert m.ate_rmse(times, shifted, times, poses, align=False) > 5.0

    rng = np.random.default_rng(0)
    times50, poses50 = line_trajectory(rigid, nq, n=50)
    noisy = [rigid(p.t + rng.normal(0, 0.05, 3), p.q) for p in poses50]
    assert 0.03 < m.ate_rmse(times50, noisy, times50, poses50) < 0.15


def _curvy(rigid, nq, n=40, seed=1):
    rng = np.random.default_rng(seed)
    times = np.sort(rng.uniform(0.0, 10.0, n)).tolist()
    poses = [rigid(np.array([np.cos(t), np.sin(0.7 * t), 0.1 * t]),
                   nq.quat_from_axis_angle(np.array([0.02 * t, -0.01 * t, 0.3 * t]))) for t in times]
    return times, poses


def test_metrics_equal_on_one_trajectory():
    rng = np.random.default_rng(2)
    noise = rng.normal(0, 0.03, (40, 3))
    out = {}
    for name, (m, rigid, nq) in PACKAGES.items():
        times, gt = _curvy(rigid, nq)
        est = [rigid(p.t + e, nq.quat_multiply(p.q, nq.quat_from_axis_angle(0.1 * e))) for p, e in zip(gt, noise)]
        relations = m.relations_from_ground_truth(times, gt, 0.35)
        interp = m.TrajectoryInterpolator(times, est)
        out[name] = ([_rel(r) for r in relations], _metrics(m.compute_relation_metrics(interp, relations)),
                     m.ate_rmse(times, est, times, gt), m.ate_rmse(times, est, times, gt, align=False),
                     [tuple(interp.lookup(t).t) + tuple(interp.lookup(t).q) for t in (-1.0, 0.5, 3.3, 11.0)],
                     str(m.compute_relation_metrics(interp, relations)))
    assert out["port"] == out["jax"]


def _pose_graph(rigid, nq):
    """A pose graph as the relation generator reads it: a 60-node loop of
    radius 20 m (covered distance ~120 m), 12 submaps, INTER constraints
    whose zbar agrees with the solution but for a few outliers."""
    rng = np.random.default_rng(3)
    angles = np.linspace(0.0, 2 * np.pi * 0.95, 60)
    nodes = [SimpleNamespace(time=0.5 * i, global_pose=rigid(np.array([20 * np.cos(a), 20 * np.sin(a), 0.0]),
                                                             nq.quat_from_axis_angle(np.array([0.0, 0.0, a]))))
             for i, a in enumerate(angles)]
    submaps = [SimpleNamespace(global_pose=nodes[5 * j].global_pose) for j in range(12)]
    constraints = []
    for i, node in enumerate(nodes):
        for j in (0, (i // 5 + 6) % 12):
            truth = submaps[j].global_pose.inverse().compose(node.global_pose)
            err = rng.normal(0, 0.05 if rng.uniform() < 0.2 else 0.002, 6)
            zbar = rigid(truth.t + err[:3], nq.quat_multiply(truth.q, nq.quat_from_axis_angle(err[3:] * 0.1)))
            constraints.append(SimpleNamespace(tag="INTER" if j else "INTRA", node_index=i, submap_index=j,
                                               zbar=zbar))
    return SimpleNamespace(nodes=nodes, submaps=submaps, constraints=constraints)


@pytest.mark.parametrize("min_covered", [10.0, 50.0])
def test_relations_from_one_pose_graph(min_covered):
    out = {name: [_rel(r) for r in m.autogenerate_relations_from_pose_graph(_pose_graph(rigid, nq), min_covered)]
           for name, (m, rigid, nq) in PACKAGES.items()}
    assert out["port"] == out["jax"]
    assert 0 < len(out["port"]) < 60  # some pass, the outliers and the near pairs do not


def _pb_state(pb, rigid, nq):
    graph = _pose_graph(rigid, nq)
    state = pb.PbState()
    for i, n in enumerate(graph.nodes):
        state.nodes.append(pb.PbNodePose(trajectory_id=i // 30, node_index=i % 30,
                                         timestamp=int(1e7 * (1000 + n.time)), pose=n.global_pose))
    state.submap_poses = [{"trajectory_id": 0, "submap_index": j, "pose": s.global_pose}
                          for j, s in enumerate(graph.submaps)]
    for c in graph.constraints:
        state.constraints.append(pb.PbConstraint(
            submap_trajectory_id=0, submap_index=c.submap_index, node_trajectory_id=c.node_index // 30,
            node_index=c.node_index % 30, relative_pose=c.zbar, translation_weight=1.0, rotation_weight=1.0,
            tag="INTER_SUBMAP" if c.tag == "INTER" else "INTRA_SUBMAP"))
    return state


def test_relations_from_one_pbstream_state():
    out = {}
    for name, (m, rigid, nq) in PACKAGES.items():
        pb = jpb if name == "jax" else tpb
        out[name] = [_rel(r) for r in m.autogenerate_relations_from_pbstream_state(_pb_state(pb, rigid, nq), 10.0)]
    assert out["port"] == out["jax"]
    assert out["port"]


def test_relations_files_cross_packages(tmp_path):
    """A relations file written by either package reads back the same in
    both."""
    rng = np.random.default_rng(4)
    rows = [(float(t), float(t) + 0.5, rng.normal(size=3), rng.normal(0, 0.3, 3)) for t in np.arange(0.0, 5.0, 0.5)]
    for writer, reader in ((tr, jr), (jr, tr), (tr, tr)):
        relation, rigid, nq = ((tm.Relation, TRigid3, tnq) if writer is tr else (jm.Relation, JRigid3, jnq))
        rels = [relation(t1, t2, rigid(t, nq.quat_from_axis_angle(aa))) for t1, t2, t, aa in rows]
        path = tmp_path / f"{writer.__name__}.txt"
        writer.write_relations_text_file(str(path), rels)
        back = reader.read_relations_text_file(str(path))
        again = (jr if reader is tr else tr).read_relations_text_file(str(path))
        assert [_rel(r) for r in back] == [_rel(r) for r in again]
        for a, b in zip(rels, back):
            assert (a.time1, a.time2) == (b.time1, b.time2)
            np.testing.assert_allclose(b.expected.t, a.expected.t, atol=1e-12)
            np.testing.assert_allclose(np.abs(np.dot(b.expected.q, a.expected.q)), 1.0, atol=1e-12)
    assert (tmp_path / f"{tr.__name__}.txt").read_text() == (tmp_path / f"{jr.__name__}.txt").read_text()
