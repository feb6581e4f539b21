"""Parity of the port's distribution over a Mesh (hectorgrapher_tpu_torch/
parallel/{mesh,sharded,constraint_search,ct_windows}.py and the pose
graphs' set_solver_mesh) with the JAX package's sharded functions on its
8-device CPU mesh (tests/conftest.py), and with the port's own unsharded
paths, on a port Mesh of 8 cpu shards (and of 1, and of 3 where a count
must not divide).

Tolerances, with their reasons:
- SPA: poses within 1e-4 of the JAX package's sharded solve, the final
  cost within 1e-4 of it relative (tests/test_torch_spa_*.py's, the
  closed-form blocks against jacfwd). Against the port's local solve:
  bit-equal, on any shard count: each shard builds its constraints'
  blocks with the local solve's ops, the gather puts them back in
  constraint order, and the rest is the local solve's code on the same
  tensors; padded rows are masked out of every sum.
- Rounds: against the JAX package's sharded round, scores within 1e-5 and
  poses within 1e-5 (tests/test_sharded.py's, which holds its sharded
  round to single searches; the port's K4 / K5 plain versions sum in
  another order). Against the port's unsharded round: bit-equal, since
  every candidate is searched with its own arithmetic, whichever shard
  and batch it lands in.
- CT windows: the JAX test's (translation 2e-5, costs 2e-4 relative)
  against its sharded solve; 1e-5 against the port's batched solve of all
  the lanes (each lane's own LM steps, up to the rounding of a batched
  linear solve over fewer lanes).
- Pose graphs: the constraints and poses bit-equal to the port's graph
  without a mesh; within 1e-3 of the JAX graph's on the same drive
  (tests/test_torch_pose_graph_*.py's).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import hectorgrapher_tpu_torch.mapping.pose_graph.pose_graph as tpg_mod
from hectorgrapher_tpu.evaluation.graph_generator import make_scale_spa_problem
from hectorgrapher_tpu.parallel import constraint_search as jcs
from hectorgrapher_tpu.parallel import ct_windows as jctw
from hectorgrapher_tpu.parallel import sharded as jsharded
from hectorgrapher_tpu.transform import np_quat as nq
from hectorgrapher_tpu_torch import convert
from hectorgrapher_tpu_torch.mapping.ct import window_solver as tws
from hectorgrapher_tpu_torch.mapping.pose_graph import optimization as topt
from hectorgrapher_tpu_torch.mapping.pose_graph.pose_graph import PoseGraph2D, PoseGraph3D
from hectorgrapher_tpu_torch.mapping.scan_matching import fast_correlative_2d as tfc2
from hectorgrapher_tpu_torch.mapping.scan_matching import fast_correlative_3d as tfc3
from hectorgrapher_tpu_torch.parallel import constraint_search as tcs
from hectorgrapher_tpu_torch.parallel import ct_windows as tctw
from hectorgrapher_tpu_torch.parallel import sharded as tsharded
from hectorgrapher_tpu_torch.parallel.mesh import Mesh
from hectorgrapher_tpu_torch.transform.rigid import Rigid3
from test_batched_constraint_path import HIST, active_submap_3d, drive_2d, drive_3d, node_3d, options_2d, options_3d
from test_sharded import _make_submaps_and_candidates, build_problem
from torch_parity import CPU, batched_anchors_2d, batched_anchors_3d, ct_example, inter_constraints, port_drive_2d

torch.set_num_threads(2)


def jax_mesh(n=8):
    return JMesh(np.array(jax.devices()[:n]), ("graph",))


def cpu_mesh(n=8):
    return Mesh([CPU] * n)


@pytest.fixture(autouse=True)
def _no_global_mesh():
    """set_solver_mesh installs the constraint-search mesh process-wide,
    as the JAX package does: each test leaves none behind."""
    yield
    tpg_mod.set_constraint_search_mesh(None)


def _port_problem(jproblem, cls):
    return cls(*(torch.from_numpy(np.array(x)).to(torch.int64 if name in ("c_submap", "c_node") else None)
                 for name, x in zip(cls._fields, jproblem)))


# ---------------------------------------------------------------------------
# SPA
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("constraints", [128, 126], ids=["even", "uneven"])
def test_sharded_spa_2d_matches_jax_and_local(constraints):
    """solve_spa_2d_sharded on 8 shards against the JAX package's on 8
    devices and against the port's local solve, on tests/test_sharded.py's
    problem (the uneven case: 126 constraint rows, padded to 128); then a
    3-shard and a 1-shard mesh. One gather per LM evaluation."""
    jproblem, _, gt_node = build_problem(np.random.default_rng(0), C=constraints)
    problem = _port_problem(jproblem, topt.SpaProblem2D)
    want = jsharded.solve_spa_2d_sharded(jproblem, jax_mesh(), num_iterations=20)
    local = topt.solve_spa_2d(problem, num_iterations=20)
    for n in (8, 3, 1):
        mesh = cpu_mesh(n)
        got = tsharded.solve_spa_2d_sharded(problem, mesh, num_iterations=20)
        assert mesh.collectives == topt.LAST_SOLVE_STATS["lm_iterations"] + 1
        for g, w, lo in zip(got[:2], want[:2], local[:2]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)
            assert torch.equal(g, lo)
        assert abs(float(got[2]) - float(want[2])) <= max(1e-4 * abs(float(want[2])), 1e-7)
        np.testing.assert_allclose(got[1].numpy()[:, :2], gt_node[:, :2], atol=0.02)  # the JAX test's bound


@pytest.mark.parametrize("solver", ["schur", "cg"])
def test_sharded_spa_3d_matches_jax_and_local(solver, monkeypatch):
    """solve_spa_3d_sharded on 8 shards against the JAX package's and the
    port's local solve, through the Schur path and (below a lowered
    _SCHUR_COUPLING_BUDGET in both packages) the PCG path, on 60 nodes, 6
    submaps and 203 constraints (padded to 208 over 8 shards); the numpy
    problem, as the solver plane ships it, gives the same result."""
    nodes = 60 if solver == "schur" else 64  # another shape: the JAX solve traced once per shape
    jproblem, t_gt, _ = make_scale_spa_problem(num_nodes=nodes, num_submaps=6, num_constraints=203, noise=0.3,
                                               seed=2)
    if solver == "cg":
        monkeypatch.setattr(jsharded, "_SCHUR_COUPLING_BUDGET", 10)
        monkeypatch.setattr(topt, "_SCHUR_COUPLING_BUDGET", 10)
    problem = _port_problem(jproblem, topt.SpaProblem3D)
    want = jsharded.solve_spa_3d_sharded(jproblem, jax_mesh(), num_iterations=15)
    local = topt.solve_spa_3d(problem, num_iterations=15)
    mesh = cpu_mesh()
    got = tsharded.solve_spa_3d_sharded(problem, mesh, num_iterations=15)
    assert topt.LAST_SOLVE_STATS["linear_solver"] == solver
    assert mesh.collectives == topt.LAST_SOLVE_STATS["lm_iterations"] + 1
    for g, w, lo in zip(got[:4], want[:4], local[:4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)
        assert torch.equal(g, lo)
    assert abs(float(got[4]) - float(want[4])) <= max(1e-4 * abs(float(want[4])), 1e-7)
    assert np.linalg.norm(got[2].numpy() - t_gt, axis=1).max() < 0.01
    host = tsharded.solve_spa_3d_sharded(topt.SpaProblem3D(*(np.asarray(x) for x in jproblem)), cpu_mesh(),
                                         num_iterations=15)
    assert all(torch.equal(a, b) for a, b in zip(host[:4], got[:4]))
    assert tsharded.spa_sharded_collective_ops(problem, cpu_mesh(), num_iterations=15)["all_gather"] == (
        topt.LAST_SOLVE_STATS["lm_iterations"] + 1)


# ---------------------------------------------------------------------------
# Rounds
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def submaps_2d():
    """tests/test_sharded.py's six distinct 256^2 submaps and 18
    candidates (JAX), and their port counterparts. The JAX matchers are
    prepared at depth 5 and searched at the config's depth 3, over the
    first three levels of each block; the port's matcher holds exactly
    its search depth, those three levels."""
    prepared, candidates, config = _make_submaps_and_candidates()
    tprepared = [convert.prepared_fast_matcher_2d(p, CPU) for p in prepared]
    tprepared = [p._replace(flat_levels=p.flat_levels[:config.depth].contiguous()) for p in tprepared]
    tcands = [(s, convert.point_cloud(c, CPU), convert.rigid2(init, CPU)) for s, c, init in candidates]
    return prepared, candidates, config, tprepared, tcands, tfc2.FastSearchConfig(*tuple(config))


def _assert_same_2d(got, want):
    assert len(got) == len(want)
    for (gs, gp), (ws, wp) in zip(got, want):
        assert gs == ws and torch.equal(gp.translation, wp.translation) and torch.equal(gp.angle, wp.angle)


def test_sharded_rounds_2d_match_jax_and_unsharded(submaps_2d):
    """The sharded 2D round on 8 shards against the JAX package's on 8
    devices and bit-equal to the port's unsharded round; one K5 call a
    level on each shard that got candidates (six, one submap each)."""
    prepared, candidates, config, tprepared, tcands, tconfig = submaps_2d
    want = jcs.sharded_fast_matches_2d(prepared, candidates, config, jax_mesh())
    unsharded = tcs.sharded_fast_matches_2d(tprepared, tcands, tconfig, CPU)
    before = tfc2.match_fast_2d_batched.score_sums
    mesh = cpu_mesh()
    got = tcs.sharded_fast_matches_2d(tprepared, tcands, tconfig, mesh)
    assert tfc2.match_fast_2d_batched.score_sums - before == 6 * tconfig.depth
    assert mesh.collectives == 1
    _assert_same_2d(got, unsharded)
    for (score, pose), (wscore, wpose) in zip(got, want):
        assert abs(score - wscore) <= 1e-5
        np.testing.assert_allclose(pose.translation.numpy(), np.asarray(wpose.translation), atol=1e-5, rtol=0)
        assert abs(float(pose.angle) - float(wpose.angle)) <= 1e-5
        assert score > 0.3  # the JAX test's sanity bound


@pytest.mark.parametrize("shards", [8, 1])
def test_sharded_rounds_2d_uneven_empty_and_one_shard(submaps_2d, shards):
    """Two candidates over three submaps (lopsided routing), the empty
    round, and a 1-shard mesh whose pack is the single-card pack, bit for
    bit; the JAX package's sharded round on as many devices agrees."""
    prepared, candidates, config, tprepared, tcands, tconfig = submaps_2d
    picks = [0, 3]  # submaps 0 and 1
    mesh = cpu_mesh(shards)
    got = tcs.sharded_fast_matches_2d(tprepared[:3], [tcands[i] for i in picks], tconfig, mesh)
    _assert_same_2d(got, tcs.sharded_fast_matches_2d(tprepared[:3], [tcands[i] for i in picks], tconfig, CPU))
    want = jcs.sharded_fast_matches_2d(prepared[:3], [candidates[i] for i in picks], config, jax_mesh(shards))
    for (score, _), (wscore, _) in zip(got, want):
        assert abs(score - wscore) <= 1e-5
    assert tcs.sharded_fast_matches_2d(tprepared[:3], [], tconfig, mesh) == []
    packed = tcs.pack_submaps_2d(tprepared[:3], mesh)
    if shards == 1:
        single = tcs.pack_submaps_2d(tprepared[:3], CPU)
        shard = packed.shards[0]
        assert torch.equal(shard.levels, single.levels) and torch.equal(shard.min_corners, single.min_corners)
        assert (shard.count, shard.dims, shard.depth) == (single.count, single.dims, single.depth)
    else:
        assert packed.s_per_dev == 1 and [s is None for s in packed.shards] == [False] * 3 + [True] * 5


@pytest.fixture(scope="module")
def scene_3d():
    """tests/test_sharded.py's 3D scene: three 64 x 64 x 32 TSDF submaps,
    two candidates each, built with the JAX package; port matchers of the
    same grids."""
    from hectorgrapher_tpu.common.config import FastCorrelativeScanMatcherOptions3D, TSDFRangeDataInserterOptions3D
    from hectorgrapher_tpu.evaluation.scan_generator import raycast_box_room_3d
    from hectorgrapher_tpu.mapping.grids import make_tsdf_grid
    from hectorgrapher_tpu.mapping.inserters_3d import make_tsdf_inserter_3d
    from hectorgrapher_tpu.mapping.scan_matching.fast_correlative_3d import (
        FastCorrelativeScanMatcher3D,
        make_fast_search_3d_config,
    )
    from hectorgrapher_tpu.mapping.scan_matching.rotational_histogram import compute_histogram
    from hectorgrapher_tpu.sensor.types import RangeData, pad_cloud
    from hectorgrapher_tpu.sensor.voxel_filter import compact_cloud, voxel_filter
    from hectorgrapher_tpu.transform.rigid import Rigid3 as JRigid3

    options = FastCorrelativeScanMatcherOptions3D(branch_and_bound_depth=4, linear_xy_search_window=1.0,
                                                  linear_z_search_window=0.3, angular_search_window=np.radians(15.0),
                                                  min_rotational_score=0.2)
    ins_opts = TSDFRangeDataInserterOptions3D(normal_computation_method="NONE", min_range=0.4, max_range=30.0)
    ins_hi, ins_lo = make_tsdf_inserter_3d(ins_opts, 0.15), make_tsdf_inserter_3d(ins_opts, 0.45)
    rng = np.random.default_rng(5)
    jms, tms, candidates, tcands = [], [], [], []
    for s in range(3):
        hi = make_tsdf_grid(0.15, (64, 64, 32), truncation_distance=0.45, max_weight=1000.0)
        lo = make_tsdf_grid(0.45, (24, 24, 12), truncation_distance=1.0, max_weight=1000.0)
        center = np.array([0.3 * s, -0.2 * s, 0.0], np.float32)
        pts = raycast_box_room_3d(center, nq.quat_identity(), half_extents=(3.0 + 0.2 * s, 2.5, 1.2), num_azimuth=96,
                                  num_elevation=20, noise_std=0.003, rng=rng)
        pts = (pts[~np.isnan(pts[:, 0])] + center).astype(np.float32)
        rd = RangeData(origin=jnp.asarray(center), returns=pad_cloud(pts, 4096),
                       misses=pad_cloud(np.zeros((0, 3), np.float32), 4))
        hi, lo = ins_hi(hi, rd), ins_lo(lo, rd)
        hc = pad_cloud(pts, 4096)
        hist = np.asarray(compute_histogram(hc.positions, hc.mask, 120))
        jms.append(FastCorrelativeScanMatcher3D(options, hi, lo, hist))
        tms.append(tfc3.FastCorrelativeScanMatcher3D(convert.options(options), convert.grid_3d(hi, CPU),
                                                     convert.grid_3d(lo, CPU), hist))
        scan = compact_cloud(voxel_filter(pad_cloud(pts, 4096), 0.2), 512)
        low_c = compact_cloud(voxel_filter(pad_cloud(pts, 4096), 0.45), 256)
        scan_hist = np.asarray(compute_histogram(scan.positions, scan.mask, 120))
        for _ in range(2):
            candidates.append((s, scan, low_c, scan_hist, JRigid3.identity(), 0.0))
            tcands.append((s, convert.point_cloud(scan, CPU), convert.point_cloud(low_c, CPU), scan_hist,
                           Rigid3(np.zeros(3, np.float32), np.array([1, 0, 0, 0], np.float32)), 0.0))
    config = make_fast_search_3d_config(options, 0.15, 8.0, False, 256)
    return jms, tms, candidates, tcands, config, tfc3.FastSearch3DConfig(*tuple(config))


def test_sharded_rounds_3d_match_jax_and_unsharded(scene_3d):
    """The sharded 3D round on 8 shards against the JAX package's on 8
    devices and bit-equal to the port's unsharded round (one K4 call a
    level on each of the three shards that own a submap); an uneven
    round of three candidates on 3 shards and on 1, and the empty round."""
    jms, tms, candidates, tcands, config, tconfig = scene_3d
    want = jcs.sharded_fast_matches_3d(jms, candidates, config, jax_mesh())
    unsharded = tcs.sharded_fast_matches_3d(tms, tcands, tconfig, CPU)
    before = tfc3.match_fast_3d.score_sums
    mesh = cpu_mesh()
    got = tcs.sharded_fast_matches_3d(tms, tcands, tconfig, mesh)
    levels = min(tconfig.depth, len(tms[0]._pyramid_levels))
    assert tfc3.match_fast_3d.score_sums - before == 3 * levels and mesh.collectives == 1
    for (gs, gl, gp), (us, ul, up), (ws, wl, wp) in zip(got, unsharded, want):
        assert (gs, gl) == (us, ul) and torch.equal(gp.translation, up.translation)
        assert torch.equal(gp.rotation, up.rotation)
        assert abs(gs - ws) <= 1e-5 and abs(gl - wl) <= 1e-5
        np.testing.assert_allclose(gp.translation.numpy(), np.asarray(wp.translation), atol=1e-5, rtol=0)
        assert gs > 0.3
    uneven = tcands[1:4]
    for n in (3, 1):
        out = tcs.sharded_fast_matches_3d(tms, uneven, tconfig, cpu_mesh(n))
        assert [(s, l) for s, l, _ in out] == [(s, l) for s, l, _ in unsharded[1:4]]
        assert all(torch.equal(p.translation, q.translation) for (_, _, p), (_, _, q) in zip(out, unsharded[1:4]))
    assert tcs.sharded_fast_matches_3d(tms, [], tconfig, mesh) == []
    one = tcs.pack_submaps_3d(tms, cpu_mesh(1)).shards[0]
    single = tcs.pack_submaps_3d(tms, CPU)
    assert all(torch.equal(a, b) for a, b in zip(one.pyramids, single.pyramids))
    assert torch.equal(one.low_fields, single.low_fields) and torch.equal(one.histograms, single.histograms)


# ---------------------------------------------------------------------------
# CT windows
# ---------------------------------------------------------------------------


def test_sharded_ct_windows_match_jax_and_batched():
    """tests/test_sharded.py:191's case: B = 8 windows of the entry
    fixture, each lane's start translation perturbed, 4 LM iterations,
    sharded over 8 (and 2) shards against the JAX package's sharded solve
    and the port's batched solve; one batched assembly a shard and LM
    evaluation (each a slotted K3 call)."""
    hi, lo, problem, state, weights = ct_example(grid=32)
    b = 8
    bcast = lambda t: jax.tree.map(lambda x: jnp.broadcast_to(x, (b,) + x.shape), t)
    noise = np.random.default_rng(0).normal(0, 0.01, (b,) + state.translation.shape).astype(np.float32)
    states = bcast(state)._replace(translation=bcast(state).translation + jnp.asarray(noise))
    want = jctw.solve_ct_windows_sharded(jax_mesh(), bcast(hi), bcast(lo), bcast(problem), states, weights,
                                         is_tsdf=True, num_iterations=4)
    raw = [convert.grid_3d(g, CPU) for g in (hi, lo)]
    tproblem = convert.ct_problem(problem, CPU)
    tproblems = tws.CtProblem(*(torch.stack([x] * b) for x in tproblem))
    tstates = tws.CtState(*(torch.from_numpy(np.array(x)) for x in states))
    tweights = convert.ct_weights(weights, CPU)
    batched = tws.solve_ct_window_batched([raw[0]] * b, [raw[1]] * b, tproblems, tstates, tweights, is_tsdf=True,
                                          num_iterations=4)
    for shards in (8, 2):
        before = tws.solve_ct_window_batched.assemblies
        got = tctw.solve_ct_windows_sharded(cpu_mesh(shards), [raw[0]] * b, [raw[1]] * b, tproblems, tstates,
                                            tweights, is_tsdf=True, num_iterations=4)
        assert tws.solve_ct_window_batched.assemblies - before == shards * 5
        np.testing.assert_allclose(got[0].translation.numpy(), np.asarray(want[0].translation), atol=2e-5, rtol=0)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=2e-4)
        for g, w in zip(got[0], batched[0]):
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(got[1].numpy(), batched[1].numpy(), rtol=1e-5)
    with pytest.raises(ValueError, match="divide"):
        tctw.solve_ct_windows_sharded(cpu_mesh(3), [raw[0]] * b, [raw[1]] * b, tproblems, tstates, tweights,
                                      is_tsdf=True, num_iterations=4)


# ---------------------------------------------------------------------------
# Pose graphs
# ---------------------------------------------------------------------------


def _assert_pose_close(got, want, atol=1e-3):
    np.testing.assert_allclose(got.t, want.t, rtol=0, atol=atol)
    assert nq.quat_angle(nq.quat_multiply(nq.quat_conjugate(want.q), got.q)) < atol


def _assert_same_graph(pg, other, atol=None):
    """Constraints and poses of two graphs: equal, or within atol."""
    assert [(c.tag, c.submap_index, c.node_index) for c in pg.constraints] == [
        (c.tag, c.submap_index, c.node_index) for c in other.constraints]
    pairs = ([(c.zbar, o.zbar) for c, o in zip(pg.constraints, other.constraints)]
             + [(n.global_pose, o.global_pose) for n, o in zip(pg.nodes, other.nodes)]
             + [(s.global_pose, o.global_pose) for s, o in zip(pg.submaps, other.submaps)])
    for got, want in pairs:
        if atol is None:
            assert np.array_equal(got.t, want.t) and np.array_equal(got.q, want.q)
        else:
            _assert_pose_close(got, want, atol)


def test_pose_graph_2d_on_a_mesh_matches_jax_and_no_mesh():
    """tests/test_batched_constraint_path.py's 2D drive (its returning
    node's round has both anchors as candidates), work queue synchronous,
    through a PoseGraph2D with set_solver_mesh on 8 cpu shards: the round
    runs over the mesh pack (one gather), and the graph equals the port's
    without a mesh and, within 1e-3, the JAX graph; the same after the
    final optimization (the 2D graph's extras keep it on one device)."""
    anchors = batched_anchors_2d()
    options = convert.options(options_2d(True))
    pg = PoseGraph2D(options, device=CPU)
    mesh = cpu_mesh()
    pg.set_solver_mesh(mesh)
    port_drive_2d(anchors, None, pose_graph=pg)
    assert tpg_mod.constraint_search_mesh() is mesh and mesh.collectives == 1
    assert isinstance(pg._packs2d[next(iter(pg._packs2d))]["packed"], tcs.MeshPackedSubmaps2D)
    tpg_mod.set_constraint_search_mesh(None)
    plain = port_drive_2d(anchors, options_2d(True))
    jpg = drive_2d(anchors, batched=True)
    assert len(inter_constraints(pg)) >= 2
    _assert_same_graph(pg, plain)
    _assert_same_graph(pg, jpg, atol=1e-3)
    tpg_mod.set_constraint_search_mesh(mesh)
    pg.run_final_optimization()
    plain.run_final_optimization()
    jpg.run_final_optimization()
    _assert_same_graph(pg, plain)
    _assert_same_graph(pg, jpg, atol=1e-3)


def test_pose_graph_3d_on_a_mesh_matches_jax_and_no_mesh():
    """The 3D drive of the same test through a PoseGraph3D with
    set_solver_mesh on 8 cpu shards: the round over the mesh pack, then
    the final optimization through the sharded SPA (no extras on this
    drive), equal to the port's graph without a mesh and, within 1e-3,
    to the JAX graph."""
    anchors = batched_anchors_3d()
    options = convert.options(options_3d(True))

    def drive(pg):
        subs = [convert.submap_3d(a, CPU) for a in (*anchors, active_submap_3d())]
        truth = np.array([0.3, -0.2, 0.0])
        for time, local, true, k in ((0.0, np.zeros(3), np.zeros(3), 0), (0.1, [0.4, 0.3, 0.0], [0.4, 0.3, 0.0], 1),
                                     (0.2, truth + [0.3, 0.0, 0.0], truth, 2)):
            pg.add_node(convert.pg_node(node_3d(time, local, true), CPU), [subs[k]])
        pg.wait_for_all_computations()
        return pg

    mesh = cpu_mesh()
    pg = PoseGraph3D(options, histogram_size=HIST, device=CPU)
    pg.set_solver_mesh(mesh)
    drive(pg)
    assert mesh.collectives == 1 and isinstance(pg._pack3d["packed"], tcs.MeshPackedSubmaps3D)
    tpg_mod.set_constraint_search_mesh(None)
    plain = drive(PoseGraph3D(options, histogram_size=HIST, device=CPU))
    jpg = drive_3d(anchors, batched=True)
    assert len(inter_constraints(pg)) >= 2
    _assert_same_graph(pg, plain)
    _assert_same_graph(pg, jpg, atol=1e-3)
    tpg_mod.set_constraint_search_mesh(mesh)
    pg.run_final_optimization()
    assert mesh.collectives == 2 + topt.LAST_SOLVE_STATS["lm_iterations"]
    plain.run_final_optimization()
    jpg.run_final_optimization()
    _assert_same_graph(pg, plain)
    _assert_same_graph(pg, jpg, atol=1e-3)


def test_set_solver_mesh_refuses_a_multi_process_mesh_without_broadcast():
    """JAX pose_graph.py:461-470: a mesh that spans processes needs the
    broadcast hook; a local one does not, and None reverts."""
    for cls in (PoseGraph2D, PoseGraph3D):
        pg = cls(convert.options(options_2d(True)), device=CPU)
        spanning = types.SimpleNamespace(spans_processes=True)
        with pytest.raises(ValueError, match="broadcast"):
            pg.set_solver_mesh(spanning)
        pg.set_solver_mesh(spanning, broadcast=lambda *a, **k: None)
        assert pg._solver_mesh is spanning
        pg.set_solver_mesh(cpu_mesh(2))
        pg.set_solver_mesh(None)
        assert pg._solver_mesh is None and tpg_mod.constraint_search_mesh() is None
