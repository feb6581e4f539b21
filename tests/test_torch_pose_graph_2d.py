"""Parity of the port's 2D back end (hectorgrapher_tpu_torch/mapping/
pose_graph/pose_graph.py PoseGraph2D, parallel/constraint_search.py's 2D
half, the packed 2D GN refinement, OverlappingSubmapsTrimmer2D and
mapping/map_builder.py over 2D) with the JAX package's, on the CPU with the
same inputs and async_work_queue=False on both sides.

- The anchors_2d scene of tests/test_batched_constraint_path.py through
  both graphs, serial and batched: the same INTER constraints, zbar within
  1e-3, the port's batched round within 1e-4 of its serial one (the JAX
  test's bound), then the final optimization.
- match_gn_2d_packed_grids, its wide-row gathers and
  match_gn_2d_fields_batched against the JAX package's on the anchors.
- sharded_fast_matches_2d against one search a candidate.
- A round of mixed grid extents falls back to the serial path.
- C6: a pack budget that evicts a submap, then a round that re-admits it.
- OverlappingSubmapsTrimmer2D against the JAX trimmer.
- A short MapBuilder 2D drive through both packages, and the default
  MapBuilderOptions building a PoseGraph2D.

Tolerances: the fast matches are the same (tests/test_torch_fast_correlative_2d.py)
and the 2D GN refinement agrees to 1e-4 (tests/test_torch_gn_2d.py); the
SPA then sums in another order, and the JAX solve computes some residuals
in float64 under the tests' x64 mode (ROADMAP C1). 1e-3 holds that with
room.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hectorgrapher_tpu.mapping.pose_graph.pose_graph as jpg_mod
from hectorgrapher_tpu.common.config import replace_deep
from hectorgrapher_tpu.mapping.map_builder import MapBuilder as JMapBuilder
from hectorgrapher_tpu.mapping.pose_graph.trimmers import OverlappingSubmapsTrimmer2D as JTrimmer
from hectorgrapher_tpu.mapping.scan_matching.gn_2d import match_gn_2d_packed_grids as jax_packed_grids
from hectorgrapher_tpu.sensor.types import TimedPointCloudData, pad_timed_cloud
from hectorgrapher_tpu.transform import np_quat as nq
from hectorgrapher_tpu.transform.np_quat import NpRigid3
from hectorgrapher_tpu.transform.rigid import Rigid2 as JRigid2
from hectorgrapher_tpu_torch import convert
from hectorgrapher_tpu_torch.common import config as tcfg
from hectorgrapher_tpu_torch.mapping.map_builder import MapBuilder
from hectorgrapher_tpu_torch.mapping.pose_graph import pose_graph as tpg_mod
from hectorgrapher_tpu_torch.mapping.pose_graph.pose_graph import PoseGraph2D
from hectorgrapher_tpu_torch.mapping.pose_graph.trimmers import OverlappingSubmapsTrimmer2D
from hectorgrapher_tpu_torch.mapping.scan_matching import gn_2d as tgn
from hectorgrapher_tpu_torch.ops import fast_scores_2d as k5
from hectorgrapher_tpu_torch.sensor import types as ttypes
from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3 as TNpRigid3
from hectorgrapher_tpu_torch.transform.rigid import Rigid2
from test_batched_constraint_path import drive_2d, options_2d
from test_map_builder_2d import circle_trajectory, make_options
from torch_parity import CPU, batched_anchors_2d, batched_tsdf_anchor_grids_2d, inter_constraints, port_drive_2d

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def anchors():
    return batched_anchors_2d()


def _assert_pose_close(got, want, atol=1e-3):
    np.testing.assert_allclose(got.t, want.t, rtol=0, atol=atol)
    assert nq.quat_angle(nq.quat_multiply(nq.quat_conjugate(want.q), got.q)) < atol


def _assert_same_graph(pg, jpg, atol=1e-3):
    assert len(pg.nodes) == len(jpg.nodes) and len(pg.submaps) == len(jpg.submaps)
    assert [(c.tag, c.submap_index, c.node_index) for c in pg.constraints] == [
        (c.tag, c.submap_index, c.node_index) for c in jpg.constraints]
    for c, jc in zip(pg.constraints, jpg.constraints):
        _assert_pose_close(c.zbar, jc.zbar, atol)
    for n, jn in zip(pg.nodes, jpg.nodes):
        _assert_pose_close(n.global_pose, jn.global_pose, atol)
    for s, js in zip(pg.submaps, jpg.submaps):
        _assert_pose_close(s.global_pose, js.global_pose, atol)


@pytest.mark.parametrize("batched", [False, True])
def test_rounds_match_jax(anchors, batched, monkeypatch):
    """drive_2d's returning node has both anchors as candidates: one
    batched round (one K5 call per level) or two serial searches, in both
    packages; the same INTER constraints, then the final optimization
    corrects the drift in both alike."""
    rounds = []
    orig = tpg_mod._observe_batched_round
    monkeypatch.setattr(tpg_mod, "_observe_batched_round", lambda n: (rounds.append(n), orig(n)))
    jpg = drive_2d(anchors, batched=batched)
    pg = port_drive_2d(anchors, options_2d(batched))
    assert rounds == ([2] if batched else [])
    assert len(inter_constraints(pg)) >= 2
    _assert_same_graph(pg, jpg)
    jpg.run_final_optimization()
    pg.run_final_optimization()
    _assert_same_graph(pg, jpg)
    truth = np.array([0.3, -0.2, 0.0])
    assert np.linalg.norm(pg.nodes[-1].global_pose.t - truth) < 0.12  # the JAX test's bound


def test_batched_round_matches_serial(anchors, monkeypatch):
    """The port's batched round against its own serial path (the JAX
    test's bounds: zbar within 1e-4), and one K5 call a pyramid level."""
    from hectorgrapher_tpu_torch.mapping.scan_matching import fast_correlative_2d as tfc

    calls, rounds = [], []
    orig = tfc.fast_scores_2d
    monkeypatch.setattr(tfc, "fast_scores_2d", lambda *a: (calls.append((a[7], a[9] is not None)), orig(*a))[1])
    pg_b = PoseGraph2D(convert.options(options_2d(True)), device=CPU)
    batched = pg_b._compute_constraints_batched
    pg_b._compute_constraints_batched = lambda gated, **kw: (rounds.append(len(calls)), batched(gated, **kw))[1]
    port_drive_2d(anchors, None, pose_graph=pg_b)
    depth = next(iter(pg_b._packs2d))
    # One K5 call a level for the round's two candidates, over row bases.
    assert len(rounds) == 1 and calls[rounds[0]:] == [(level, True) for level in range(depth - 1, -1, -1)]
    assert pg_b._packs2d[depth]["packed"].count == 2
    pg_s = port_drive_2d(anchors, options_2d(False))
    ib, isr = inter_constraints(pg_b), inter_constraints(pg_s)
    assert [(n, s) for n, s, _ in ib] == [(n, s) for n, s, _ in isr] and len(ib) >= 2
    for (_, _, cb), (_, _, cs) in zip(ib, isr):
        np.testing.assert_allclose(cb.zbar.t, cs.zbar.t, atol=1e-4)
        assert abs(nq.quat_yaw(cb.zbar.q) - nq.quat_yaw(cs.zbar.q)) < 1e-4
    assert k5.fast_scores_2d.launches == 0  # CPU tensors take the plain version


@pytest.fixture(scope="module")
def tsdf_grids():
    return batched_tsdf_anchor_grids_2d()


def _anchor_planes(anchors, tsdf_grids, grid_type):
    """(values, weights, pad value, JAX grids) of the anchors' submaps:
    their probabilities, or their TSDF grids' tsd and weight planes."""
    if grid_type == "TSDF":
        return (np.stack([np.asarray(g.tsd) for g in tsdf_grids]), np.stack([np.asarray(g.weight) for g in tsdf_grids]),
                float(tsdf_grids[0].truncation_distance), tsdf_grids)
    grids = [a.grid for a in anchors]
    values = np.stack([np.asarray(g.probability()) for g in grids]).astype(np.float32)
    return values, values, 0.1, grids


def _serial_solve(grid, cloud, t0, a0, weights):
    """The port's single refinement of one lane against its own grid."""
    t = torch.from_numpy
    fn = tgn.match_gn_2d_tsdf if hasattr(grid, "tsd") else tgn.match_gn_2d_probability
    tgrid = convert.tsdf_grid(grid, CPU) if hasattr(grid, "tsd") else convert.probability_grid(grid, CPU)
    return fn(tgrid, ttypes.PointCloud(t(np.asarray(cloud[0])), t(np.asarray(cloud[1]))),
              Rigid2(t(t0), torch.tensor(a0)), t(t0), *weights, num_iterations=20)[0]


@pytest.mark.parametrize("grid_type", ["PROBABILITY_GRID", "TSDF"])
def test_packed_gn_matches_jax(anchors, tsdf_grids, grid_type):
    """match_gn_2d_packed_grids over the anchors' raw grids (probabilities,
    or with is_tsdf the TSDF grids' tsd and weight planes), lanes in both
    slots from poses up to 0.1 m / 0.05 rad off, against the JAX package's
    and against each lane's serial solve: poses within 1e-4
    (tests/test_torch_gn_2d.py's tolerance)."""
    from test_batched_constraint_path import node_2d

    is_tsdf = grid_type == "TSDF"
    values, weights, pad, grids = _anchor_planes(anchors, tsdf_grids, grid_type)
    mcs = np.stack([np.asarray(g.meta.min_corner) for g in grids]).astype(np.float32)
    clouds = [node_2d(0.0, np.zeros(3), t).cloud for t in ([0.0, 0.0, 0.0], [0.4, 0.3, 0.0])]
    rng = np.random.default_rng(4)
    slots = np.array([0, 1, 1, 0, 1], np.int32)
    truth = np.array([[0.0, 0.0], [0.4, 0.3], [0.4, 0.3], [0.0, 0.0], [0.4, 0.3]], np.float32)
    init_t = (truth + rng.uniform(-0.1, 0.1, (5, 2))).astype(np.float32)
    init_a = rng.uniform(-0.05, 0.05, 5).astype(np.float32)
    pos = np.stack([np.asarray(clouds[s].positions) for s in slots])
    mask = np.stack([np.asarray(clouds[s].mask) for s in slots])
    from hectorgrapher_tpu.sensor.types import PointCloud as JPointCloud

    want, want_cost = jax_packed_grids(values, weights, mcs, np.float32(0.05), np.float32(pad), slots,
                                       JPointCloud(pos, mask), JRigid2(init_t, init_a), init_t, 1.0, 10.0, 40.0,
                                       is_tsdf=is_tsdf, num_iterations=20)
    t = torch.from_numpy
    got, got_cost = tgn.match_gn_2d_packed_grids(
        t(values), t(weights) if is_tsdf else None, t(mcs), 0.05, pad, t(slots.astype(np.int64)),
        ttypes.PointCloud(t(pos), t(mask)), Rigid2(t(init_t), t(init_a)), t(init_t), 1.0, 10.0, 40.0,
        is_tsdf=is_tsdf, num_iterations=20)
    np.testing.assert_allclose(got.translation.numpy(), np.asarray(want.translation), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.angle.numpy(), np.asarray(want.angle), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_cost.numpy(), np.asarray(want_cost), rtol=1e-3, atol=1e-6)
    for c, slot in enumerate(slots):
        serial = _serial_solve(grids[slot], (pos[c], mask[c]), init_t[c], init_a[c], (1.0, 10.0, 40.0))
        np.testing.assert_allclose(got.translation[c].numpy(), serial.translation.numpy(), atol=1e-4, rtol=0)
        assert abs(float(got.angle[c]) - float(serial.angle)) <= 1e-4


def test_mixed_grid_extents_take_the_serial_path(anchors):
    """A round whose submaps differ in grid extent cannot share a pack: it
    falls back to the serial path (as in the JAX package) and finds the
    serial path's constraints."""
    from test_batched_constraint_path import build_finished_submap_2d

    small = build_finished_submap_2d([np.array([0.3, -0.3, 0.0]), np.array([0.7, 0.0, 0.0])])
    small.grid = small.grid._replace(log_odds=small.grid.log_odds[32:224, 32:224],
                                     known=small.grid.known[32:224, 32:224],
                                     meta=small.grid.meta._replace(min_corner=small.grid.meta.min_corner + 1.6))
    mixed = (anchors[0], small)
    pg_b = port_drive_2d(mixed, options_2d(True))
    pg_s = port_drive_2d(mixed, options_2d(False))
    assert pg_b.batched_fallbacks == 1 and not pg_b._packs2d
    ib, isr = inter_constraints(pg_b), inter_constraints(pg_s)
    assert [(n, s) for n, s, _ in ib] == [(n, s) for n, s, _ in isr] and len(ib) >= 1
    for (_, _, cb), (_, _, cs) in zip(ib, isr):
        _assert_pose_close(cb.zbar, cs.zbar, 1e-6)


def test_evicted_submap_is_readmitted_unchanged(anchors):
    """ROADMAP C6: with a pack budget of two submaps, a third finished
    submap's rounds evict one from the pack, and a later round re-admits
    it: every round finds the constraints of a graph whose budget never
    evicts, bit for bit."""
    from test_batched_constraint_path import build_finished_submap_2d, node_2d

    third = build_finished_submap_2d([np.array([0.2, 0.1, 0.0]), np.array([0.5, -0.1, 0.0])])

    def drive(budget):
        pg = port_drive_2d(anchors, replace_deep(options_2d(True),
                                                 {"constraint_builder.pack_hbm_budget_bytes": budget}))
        t = [0.3, 0.0, 0.0]
        pg.add_node(convert.pg_node(node_2d(0.3, t, t), CPU), [convert.submap_2d(third, CPU)])
        subs = {s.submap_id: s for s in pg.submaps if s.finished}
        node = pg.nodes[-1]
        out = []
        for sids in ((3, 0), (1, 1), (0, 3), (1, 0)):
            gated = [(node.node_id, sid, node, subs[sid]) for sid in sids]
            out.append((pg._compute_constraints_batched(gated), sorted(next(iter(pg._packs2d.values()))["order"])))
        return out

    big = drive(6 << 30)
    one_submap = next(iter(port_drive_2d(anchors, options_2d(True))._packs2d.values()))["bytes"] // 2
    small = drive(2 * one_submap + 1)  # the levels and the grids of two submaps
    assert [order for _, order in big] == [[0, 1, 3]] * 4
    # (3, 0) evicts 1; (1, 1) re-admits it beside the most recently used 0
    # or 3; (0, 3) and (1, 0) each rebuild from the cards' matchers again.
    orders = [order for _, order in small]
    assert orders[0] == [0, 3] and 1 in orders[1] and len(set(map(tuple, orders))) > 1
    assert all(len(o) == 2 for o in orders)
    found = 0
    for (rb, _), (rs, _) in zip(big, small):
        for cb, cs in zip(rb, rs):
            assert (cb is None) == (cs is None)
            if cb is not None:
                found += 1
                np.testing.assert_array_equal(cb.zbar.t, cs.zbar.t)
                np.testing.assert_array_equal(cb.zbar.q, cs.zbar.q)
    assert found >= 4


def test_overlapping_submaps_trimmer_matches_jax(anchors):
    """OverlappingSubmapsTrimmer2D over a graph of three finished submaps
    (the anchors and a third one over a1's area) and an active one:
    the JAX trimmer's and the port's trim the same submaps, and both graphs
    keep the same constraints."""
    from test_batched_constraint_path import build_finished_submap_2d

    third = build_finished_submap_2d([np.zeros(3), np.array([0.4, 0.3, 0.0])])
    jsubs = (*anchors, third)
    opts = options_2d(False)
    jpg = jpg_mod.PoseGraph2D(opts)
    pg = PoseGraph2D(convert.options(opts), device=CPU)
    port_subs = [convert.submap_2d(s, CPU) for s in jsubs]
    from test_batched_constraint_path import node_2d

    for k in range(3):
        node = node_2d(0.1 * k, [0.1 * k, 0.0, 0.0], [0.1 * k, 0.0, 0.0])
        jpg.add_node(node, [jsubs[k]])
        pg.add_node(convert.pg_node(node, CPU), [port_subs[k]])
    for trimmer, graph in ((JTrimmer(1, 40.0, 1), jpg), (OverlappingSubmapsTrimmer2D(1, 40.0, 1), pg)):
        before = len(graph.submaps)
        trimmer.trim(graph)
        graph.trimmed = before - len(graph.submaps)
    assert pg.trimmed == jpg.trimmed >= 1
    assert [s.submap_id for s in pg.submaps] == [s.submap_id for s in jpg.submaps]
    assert [(c.tag, c.submap_index, c.node_index) for c in pg.constraints] == [
        (c.tag, c.submap_index, c.node_index) for c in jpg.constraints]


def _drive_2d_builder(tb, rigid, data_type, pad, poses, seed=0):
    """test_map_builder_2d.py's drive: odometry and 1440-ray scans along
    `poses` at 10 Hz."""
    from hectorgrapher_tpu.evaluation.scan_generator import raycast_rect_room_2d

    rng = np.random.default_rng(seed)
    for i, (xy, yaw) in enumerate(poses):
        t = 0.1 * i
        noise = rng.normal(0, 0.003, 3)
        tb.add_odometry_data(t, rigid(np.array([xy[0], xy[1], 0.0]) + noise,
                                      nq.quat_from_axis_angle(np.array([0.0, 0.0, yaw + rng.normal(0, 0.002)]))))
        pts = raycast_rect_room_2d(xy, yaw, num_rays=1440, noise_std=0.004, rng=rng)
        pts = pts[~np.isnan(pts[:, 0])].astype(np.float32)
        tb.add_range_data(data_type(time=t, origin=np.zeros(3, np.float32),
                                    ranges=pad(pts, np.zeros(len(pts), np.float32), 2048)))


def test_map_builder_2d_matches_jax():
    """MapBuilder 2D -> TrajectoryBuilder -> LocalTrajectoryBuilder2D ->
    PoseGraph2D over 2.8 s of test_map_builder_2d.py's circle (256^2
    submaps of 12 scans, async off, batched search), through both packages:
    equal node, submap and constraint lists and INTER constraints found.

    The front ends differ by up to 1e-3 a scan (a flipped correlative cell,
    ROADMAP C0; tests/test_torch_front_end_2d.py), and along the drive the
    local poses by up to 2.1e-3 m (measured): local poses and INTRA zbar
    within 5e-3 m. A start that moved by a cell can move a loop closure's
    fast match by one 0.05 m cell, and its refinement, pulled to its start,
    lands within 9.5e-3 m of the JAX one (measured): INTER zbar within
    2e-2 m. After the final optimization global poses within 5e-3 m / rad
    (1.3e-3 m, 1.8e-3 rad measured)."""
    jopts = replace_deep(make_options(), {"pose_graph.async_work_queue": False,
                                          "trajectory_builder_2d.submaps.grid_size": 256})
    jmb, mb = JMapBuilder(jopts), MapBuilder(convert.options(jopts), device=CPU)
    assert isinstance(mb.pose_graph, PoseGraph2D)
    poses = circle_trajectory()[:28]
    _drive_2d_builder(jmb.get_trajectory_builder(jmb.add_trajectory_builder()), NpRigid3, TimedPointCloudData,
                      pad_timed_cloud, poses)
    _drive_2d_builder(mb.get_trajectory_builder(mb.add_trajectory_builder()), TNpRigid3, ttypes.TimedPointCloudData,
                      ttypes.pad_timed_cloud, poses)
    jpg, pg = jmb.pose_graph, mb.pose_graph
    assert len(pg.nodes) == len(jpg.nodes) >= 25
    assert pg.num_optimizations == jpg.num_optimizations >= 2
    assert sum(c.tag == "INTER" for c in pg.constraints) >= 1
    assert [(c.tag, c.submap_index, c.node_index) for c in pg.constraints] == [
        (c.tag, c.submap_index, c.node_index) for c in jpg.constraints]
    for n, jn in zip(pg.nodes, jpg.nodes):
        _assert_pose_close(n.local_pose, jn.local_pose, 5e-3)
    for c, jc in zip(pg.constraints, jpg.constraints):
        _assert_pose_close(c.zbar, jc.zbar, 5e-3 if c.tag == "INTRA" else 2e-2)
    jpg.run_final_optimization()
    pg.run_final_optimization()
    for n, jn in zip(pg.nodes, jpg.nodes):
        _assert_pose_close(n.global_pose, jn.global_pose, 5e-3)


def test_default_map_builder_runs_the_2d_pipeline():
    """MapBuilder(MapBuilderOptions()) builds the 2D pipeline (the default
    options: use_trajectory_builder_3d False) on the CPU when asked."""
    mb = MapBuilder(tcfg.MapBuilderOptions(), device="cpu")
    assert isinstance(mb.pose_graph, PoseGraph2D) and mb.pose_graph._device == torch.device("cpu")
    tb = mb.get_trajectory_builder(mb.add_trajectory_builder())
    assert type(tb._local).__name__ == "LocalTrajectoryBuilder2D"
    mb.finish_trajectory(0)


def test_wide_gathers_match_jax(anchors):
    """_gather_wide_from_values and _gather_wide_from_flat (the packed
    refinement's row gathers, gn_2d.py :480, :504) against the JAX
    package's, over points inside, across the edges and off the grid:
    the same values exactly (the same f32 floors, then plain reads)."""
    from hectorgrapher_tpu.mapping.scan_matching import gn_2d as jgn

    rng = np.random.default_rng(9)
    grids = [a.grid for a in anchors]
    values = np.stack([np.asarray(g.probability()) for g in grids]).astype(np.float32)
    mc = np.asarray(grids[1].meta.min_corner, np.float32)
    world = rng.uniform(-7.0, 7.0, (64, 2)).astype(np.float32)
    want = jgn._gather_wide_from_values(jnp.asarray(values[1]), jnp.asarray(mc), np.float32(0.05), jnp.asarray(world),
                                        np.float32(0.1))
    got = tgn._gather_wide_from_values(torch.from_numpy(values[1]), torch.from_numpy(mc), torch.tensor(0.05),
                                       torch.from_numpy(world), 0.1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    nx, ny = values.shape[1:]
    want = jgn._gather_wide_from_flat(jnp.asarray(values.reshape(-1)), nx * ny, nx, ny, jnp.asarray(mc),
                                      np.float32(0.05), jnp.asarray(world), np.float32(0.1))
    got = tgn._gather_wide_from_flat(torch.from_numpy(values.reshape(-1)), nx * ny, nx, ny, torch.from_numpy(mc),
                                     torch.tensor(0.05), torch.from_numpy(world), 0.1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("grid_type", ["PROBABILITY_GRID", "TSDF"])
def test_fields_batched_matches_jax(anchors, tsdf_grids, grid_type):
    """match_gn_2d_fields_batched (gn_2d.py :449), lanes refining against
    their own prepared fields (the probability field, or with is_tsdf the
    TSDF grid's (tsd, weight) field pair), against the JAX package's and
    against each lane's serial solve: poses within 1e-4
    (tests/test_torch_gn_2d.py's tolerance)."""
    import jax

    from hectorgrapher_tpu.mapping.scan_matching import gn_2d as jgn
    from hectorgrapher_tpu.sensor.types import PointCloud as JPointCloud
    from test_batched_constraint_path import node_2d

    is_tsdf = grid_type == "TSDF"
    grids = _anchor_planes(anchors, tsdf_grids, grid_type)[3]
    jprepare = jgn.prepare_gn_tsdf_fields if is_tsdf else jgn.prepare_gn_probability_field
    fields = [jprepare(g) for g in grids]
    lanes = [0, 1, 1]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *[fields[k] for k in lanes])
    clouds = [node_2d(0.0, np.zeros(3), t).cloud for t in ([0.0, 0.0, 0.0], [0.4, 0.3, 0.0], [0.4, 0.3, 0.0])]
    pos = np.stack([np.asarray(c.positions) for c in clouds])
    mask = np.stack([np.asarray(c.mask) for c in clouds])
    init_t = np.array([[0.04, -0.03], [0.43, 0.26], [0.37, 0.33]], np.float32)
    init_a = np.array([0.02, -0.01, 0.015], np.float32)
    want, _ = jgn.match_gn_2d_fields_batched(stacked, JPointCloud(pos, mask), JRigid2(init_t, init_a), init_t,
                                            1.0, 10.0, 40.0, is_tsdf=is_tsdf, num_iterations=20)
    if is_tsdf:
        tfields = [tgn.prepare_gn_tsdf_fields(convert.tsdf_grid(g, CPU)) for g in grids]
    else:
        tfields = [(tgn.prepare_gn_probability_field(convert.probability_grid(g, CPU)),) for g in grids]

    def stack(plane):
        f = [tfields[k][plane] for k in lanes]
        return tgn.PreparedField2D(
            torch.stack([x.patches for x in f]),
            f[0].meta._replace(min_corner=torch.stack([x.meta.min_corner for x in f]),
                               resolution=torch.stack([x.meta.resolution for x in f])), f[0].dims)

    tstacked = (stack(0), stack(1)) if is_tsdf else stack(0)
    t = torch.from_numpy
    args = (ttypes.PointCloud(t(pos), t(mask)), Rigid2(t(init_t), t(init_a)), t(init_t), 1.0, 10.0, 40.0)
    got, _ = tgn.match_gn_2d_fields_batched(tstacked, *args, is_tsdf=is_tsdf, num_iterations=20)
    np.testing.assert_allclose(got.translation.numpy(), np.asarray(want.translation), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.angle.numpy(), np.asarray(want.angle), atol=1e-4, rtol=0)
    for c, k in enumerate(lanes):
        serial = _serial_solve(grids[k], (pos[c], mask[c]), init_t[c], init_a[c], (1.0, 10.0, 40.0))
        np.testing.assert_allclose(got.translation[c].numpy(), serial.translation.numpy(), atol=1e-4, rtol=0)
        assert abs(float(got.angle[c]) - float(serial.angle)) <= 1e-4


def test_sharded_fast_matches_2d_match_single_searches(anchors):
    """sharded_fast_matches_2d packs the prepared submaps on the fly and
    searches every candidate in one batched search (one K5 call a level):
    each candidate's score and pose those of its own search against its
    own submap."""
    from hectorgrapher_tpu_torch.mapping.scan_matching import fast_correlative_2d as tfc
    from hectorgrapher_tpu_torch.parallel.constraint_search import sharded_fast_matches_2d
    from test_batched_constraint_path import node_2d

    config = tfc.make_fast_search_config(0.8, np.radians(15.0), 0.05, 8.0, 7)
    prepared = [tfc.prepare_fast_matcher_2d(convert.probability_grid(a.grid, CPU), config.depth) for a in anchors]
    clouds = [convert.point_cloud(node_2d(0.0, np.zeros(3), t).cloud, CPU) for t in ([0.3, -0.2, 0.0], [0.5, 0.1, 0.0])]
    candidates = [(k, cloud, Rigid2(torch.tensor([0.3 + 0.1 * k, -0.1]), torch.tensor(0.02 * k)))
                  for cloud in clouds for k in (0, 1)]
    out = sharded_fast_matches_2d(prepared, candidates, config, CPU)
    assert len(out) == 4
    for (k, cloud, init), (score, pose) in zip(candidates, out):
        want_score, want_pose = tfc.match_fast_2d_prepared(prepared[k], cloud, init, config)
        assert abs(score - float(want_score)) <= 1e-6
        np.testing.assert_allclose(pose.translation.numpy(), want_pose.translation.numpy(), atol=1e-6, rtol=0)
        assert abs(float(pose.angle) - float(want_pose.angle)) <= 1e-6
