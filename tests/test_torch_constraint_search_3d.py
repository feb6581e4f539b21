"""Parity of the port's batched 3D constraint search (hectorgrapher_tpu_torch/
parallel/constraint_search.py, the packed GN3D of mapping/scan_matching/
gn_3d.py, PoseGraph3D._get_pack_3d and _compute_constraints_batched) with
the JAX package's and with the port's serial search, on the CPU over
tests/test_batched_constraint_path.py's scene: two finished 96 x 96 x 32 /
32 x 32 x 12 anchors and three nodes, with TSDF anchors and with occupancy
anchors of the same scans. The JAX side runs as its own tests run it, on
the CPU, with a one-device mesh.

Tolerances, with their reasons:
- Constraints (zbar) within 1e-3 m and |1 - |dq0|| < 1e-6, the JAX test's
  own: a batched round and the serial search take the same matches (K4's
  plain version sums each candidate alone), and GN3D's lanes then differ
  only in the order of the batched 6 x 6 normal equations' sums.
- Fast matches: scores and low-resolution scores within 1e-5 of JAX's;
  the same pose, or a pose whose score ties JAX's within 1e-6 (the beam
  breaks ties by index on both sides, ROADMAP C10), as
  tests/test_torch_fast_correlative_3d.py holds the serial matcher.
- Packed GN3D: poses within 1e-4 of JAX's match_gn_3d_packed (the
  tolerance of tests/test_torch_gn_3d.py), and within 1e-5 of the port's
  serial match_gn_3d for the same lane.
- The plain versions of K4 with row bases and of K3 with slots: exactly
  equal to one call per candidate or lane.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import hectorgrapher_tpu.mapping.pose_graph.pose_graph as jpg_mod
import hectorgrapher_tpu_torch.mapping.pose_graph.pose_graph as pg_mod
from hectorgrapher_tpu.common.config import replace_deep
from hectorgrapher_tpu.mapping.pose_graph.pose_graph import PoseGraph3D as JPoseGraph3D
from hectorgrapher_tpu.mapping.scan_matching import fast_correlative_3d as jfc
from hectorgrapher_tpu.mapping.scan_matching import gn_3d as jgn
from hectorgrapher_tpu.parallel import constraint_search as jcs
from hectorgrapher_tpu.sensor.types import PointCloud as JPointCloud
from hectorgrapher_tpu.sensor.voxel_filter import compact_cloud, voxel_filter
from hectorgrapher_tpu.sensor.types import pad_cloud as jpad_cloud
from hectorgrapher_tpu.transform import np_quat as nq
from hectorgrapher_tpu.transform.rigid import Rigid3 as JRigid3
from hectorgrapher_tpu_torch import convert
from hectorgrapher_tpu_torch.common import config as tcfg
from hectorgrapher_tpu_torch.mapping.map_builder import MapBuilder
from hectorgrapher_tpu_torch.mapping.pose_graph.pose_graph import PoseGraph3D
from hectorgrapher_tpu_torch.mapping.scan_matching import fast_correlative_3d as tfc
from hectorgrapher_tpu_torch.mapping.scan_matching.interpolated_grid import prepare_grid_3d
from hectorgrapher_tpu_torch.mapping.scan_matching.gn_3d import (
    match_gn_3d,
    match_gn_3d_batched,
    match_gn_3d_packed,
    prepare_gn_pack_3d,
)
from hectorgrapher_tpu_torch.ops.ct_scan_block import (
    ct_scan_block,
    ct_scan_block_plain,
    ct_scan_block_slots,
    ct_scan_block_slots_plain,
    grid_slots,
)
from hectorgrapher_tpu_torch.ops.fast_scores_3d import fast_scores_3d, fast_scores_3d_plain
from hectorgrapher_tpu_torch.parallel import constraint_search as tcs
from hectorgrapher_tpu_torch.sensor.types import PointCloud
from hectorgrapher_tpu_torch.transform.rigid import Rigid3
from test_batched_constraint_path import HIST, drive_3d, options_3d, scan_3d
from torch_parity import CPU, batched_anchors_3d, batched_probability_anchors_3d, inter_constraints, port_drive_3d

torch.set_num_threads(1)

# ConstraintBuilderOptions.ceres_scan_matcher_3d: weights 5 / 30, translation 10, rotation 1.
WEIGHTS = (5.0, 30.0, 10.0, 1.0)


def one_device_mesh():
    return Mesh(np.array(jax.devices()[:1]), ("graph",))


GRID_TYPES = ["TSDF", "PROBABILITY_GRID"]


@pytest.fixture(scope="module")
def anchors():
    return batched_anchors_3d()


@pytest.fixture(scope="module")
def anchors_probability():
    return batched_probability_anchors_3d()


def _anchors(request, grid_type):
    return request.getfixturevalue("anchors" if grid_type == "TSDF" else "anchors_probability")


def _port_batched(anchors):
    """The port's graph over the scene with the batched search, and the
    candidate counts of its batched rounds."""
    calls = []
    orig = pg_mod._observe_batched_round
    pg_mod._observe_batched_round = lambda n: (calls.append(n), orig(n))
    try:
        pg = port_drive_3d(anchors, options_3d(True))
    finally:
        pg_mod._observe_batched_round = orig
    return pg, calls


@pytest.fixture(scope="module")
def port_batched(anchors):
    return _port_batched(anchors)


@pytest.fixture(scope="module")
def port_batched_probability(anchors_probability):
    return _port_batched(anchors_probability)


def _port_batched_of(request, grid_type):
    return request.getfixturevalue("port_batched" if grid_type == "TSDF" else "port_batched_probability")


def _assert_same_inter(got, want):
    """The same INTER (node, submap) pairs, zbar within 1e-3 m and
    |1 - |dq0|| < 1e-6 (tests/test_batched_constraint_path.py:322-326)."""
    assert len(got) >= 1
    assert [(n, s) for n, s, _ in got] == [(n, s) for n, s, _ in want]
    for (_, _, a), (_, _, b) in zip(got, want):
        np.testing.assert_allclose(a.zbar.t, b.zbar.t, rtol=0, atol=1e-3)
        dq = nq.quat_multiply(nq.quat_conjugate(a.zbar.q), b.zbar.q)
        assert abs(1.0 - abs(dq[0])) < 1e-6


@pytest.mark.parametrize("grid_type", GRID_TYPES)
def test_batched_round_matches_serial(request, grid_type):
    """(a) The batched round runs (a round of >= 2 candidates, no fallback)
    and gives the serial search's constraints."""
    anchors = _anchors(request, grid_type)
    pg, calls = _port_batched_of(request, grid_type)
    assert calls and max(calls) >= 2, "no batched round ran"
    assert pg.batched_fallbacks == 0
    serial = port_drive_3d(anchors, options_3d(False))
    assert serial.batched_fallbacks == 0 and serial._pack3d is None
    _assert_same_inter(inter_constraints(pg), inter_constraints(serial))


@pytest.mark.parametrize("grid_type", GRID_TYPES)
def test_batched_round_matches_jax(request, grid_type, monkeypatch):
    """(b) The port's batched round against the JAX package's, same scene."""
    monkeypatch.setattr(jpg_mod, "constraint_search_mesh", one_device_mesh)
    jax_pg = drive_3d(_anchors(request, grid_type), batched=True)
    _assert_same_inter(inter_constraints(_port_batched_of(request, grid_type)[0]), inter_constraints(jax_pg))


def _scene_matchers(anchors, opts):
    jms = [jfc.FastCorrelativeScanMatcher3D(opts, a.high_resolution_grid, a.low_resolution_grid,
                                            a.rotational_histogram, HIST) for a in anchors]
    tms = [tfc.FastCorrelativeScanMatcher3D(convert.options(opts), convert.grid_3d(a.high_resolution_grid, CPU),
                                            convert.grid_3d(a.low_resolution_grid, CPU), a.rotational_histogram,
                                            HIST) for a in anchors]
    return jms, tms


def _small_node(true_t, yaw, capacity, n_valid=None):
    """A node's clouds (tests/test_batched_constraint_path.py node_3d at a
    smaller capacity, so that the full-submap search stays short; only the
    first n_valid high-res points valid, when given) and its histogram."""
    from hectorgrapher_tpu.mapping.scan_matching.rotational_histogram import compute_histogram

    pts = scan_3d(np.asarray(true_t), yaw)
    high = compact_cloud(voxel_filter(jpad_cloud(pts, 4096), 0.15), capacity)
    if n_valid is not None:
        high = high._replace(mask=jnp.asarray(np.asarray(high.mask) & (np.arange(capacity) < n_valid)))
    low = compact_cloud(voxel_filter(jpad_cloud(pts, 4096), 0.45), capacity // 2)
    return high, low, np.asarray(compute_histogram(high.positions, high.mask, HIST))


@pytest.mark.parametrize("grid_type", GRID_TYPES)
@pytest.mark.parametrize("full_submap", [False, True])
def test_sharded_fast_matches_match_jax(request, full_submap, grid_type):
    """(c) sharded_fast_matches_3d_packed against the JAX function: two
    submaps x two nodes with different valid counts, local window and full
    submap."""
    anchors = _anchors(request, grid_type)
    opts = options_3d(True).constraint_builder.fast_correlative_scan_matcher_3d
    jms, tms = _scene_matchers(anchors, opts)
    nodes = [_small_node([0.3, -0.2, 0.0], 0.0, 256), _small_node([0.5, 0.2, 0.05], 0.1, 256, n_valid=200)]
    assert int(np.sum(nodes[0][0].mask)) != int(np.sum(nodes[1][0].mask))
    starts = [np.array([0.6, -0.2, 0.0], np.float32), np.array([0.4, 0.3, 0.0], np.float32)]
    q0 = np.asarray(nq.quat_identity(), np.float32)
    jax_cands, port_cands = [], []
    for (high, low, hist), start in zip(nodes, starts):
        for slot in range(2):
            init = JRigid3(start, q0)
            jax_cands.append((slot, high, low, hist, init, 0.0))
            port_cands.append((slot, convert.point_cloud(high, CPU), convert.point_cloud(low, CPU), hist,
                               Rigid3(start, q0), 0.0))
    cfg = dict(max_scan_range=5.6568542, full_submap=full_submap, top_k=256, grid_cells=96)
    jconfig = jfc.make_fast_search_3d_config(opts, 0.1, cfg["max_scan_range"], full_submap, 256, grid_cells=96)
    tconfig = tfc.make_fast_search_3d_config(convert.options(opts), 0.1, cfg["max_scan_range"], full_submap, 256,
                                             grid_cells=96)
    assert tuple(jconfig) == tuple(tconfig)
    mesh = one_device_mesh()
    want = jcs.sharded_fast_matches_3d_packed(jcs.pack_submaps_3d(jms, mesh), jax_cands, jconfig, mesh)
    tfc.match_fast_3d.score_sums = 0
    got = tcs.sharded_fast_matches_3d(tms, port_cands, tconfig, CPU)
    assert tfc.match_fast_3d.score_sums == min(tconfig.depth, len(tms[0]._pyramid_levels))  # one K4 call a level
    assert len(got) == len(want) == 4
    for (g_score, g_low, g_pose), (w_score, w_low, w_pose) in zip(got, want):
        same_pose = (np.allclose(g_pose.translation.numpy(), np.asarray(w_pose.translation), atol=1e-5)
                     and np.allclose(g_pose.rotation.numpy(), np.asarray(w_pose.rotation), atol=1e-6))
        if same_pose:
            assert abs(g_score - w_score) <= 1e-5 and abs(g_low - w_low) <= 1e-5
        else:
            assert abs(g_score - w_score) <= 1e-6, (g_pose, w_pose)
    # Each candidate alone through its own matcher: the same result.
    for (slot, high, low, hist, init, yaw), (score, low_score, pose) in zip(port_cands, got):
        fn = tms[slot].match_full_submap if full_submap else tms[slot].match
        s, ls, _, p = fn(Rigid3(torch.from_numpy(init.translation), torch.from_numpy(init.rotation)), high, low,
                         hist, yaw, max_scan_range=cfg["max_scan_range"])
        assert (float(s), float(ls)) == (score, low_score)
        assert torch.equal(p.translation, pose.translation) and torch.equal(p.rotation, pose.rotation)


@pytest.mark.parametrize("grid_type", GRID_TYPES)
def test_packed_gn_matches_jax_and_serial(request, grid_type):
    """(d) The packed GN3D against the JAX match_gn_3d_packed, three lanes
    over two distinct submaps (the first repeated), and each lane against
    the port's serial match_gn_3d; the unpacked match_gn_3d_batched against
    JAX's and the packed run."""
    anchors = _anchors(request, grid_type)
    lanes = [(0, [0.3, -0.2, 0.0], 0.0, [0.04, -0.03, 0.02], 0.03), (1, [0.5, 0.2, 0.05], 0.1, [-0.05, 0.02, 0.0],
                                                                        0.06), (0, [0.1, 0.1, 0.0], 0.0,
                                                                                [0.03, 0.03, -0.02], -0.02)]
    clouds, t0s, q0s = [], [], []
    for _, truth, yaw, offset, start_yaw in lanes:
        high, low, _ = _small_node(truth, yaw, 512)
        clouds.append((high, low))
        t0s.append((np.asarray(truth) + np.asarray(offset)).astype(np.float32))
        q0s.append(nq.quat_from_axis_angle(np.array([0.01, -0.01, start_yaw])).astype(np.float32))
    t0, q0 = np.stack(t0s), np.stack(q0s)
    lane_d = np.array([d for d, *_ in lanes], np.int32)
    stack = lambda *xs: jnp.stack(xs)
    hi_d = jax.tree.map(stack, *[a.high_resolution_grid for a in anchors])
    lo_d = jax.tree.map(stack, *[a.low_resolution_grid for a in anchors])
    flat_hi, tmpl_hi, mc_hi, r_hi = jgn.prepare_gn_pack_3d(hi_d)
    flat_lo, tmpl_lo, mc_lo, r_lo = jgn.prepare_gn_pack_3d(lo_d)
    jclouds = [JPointCloud(jnp.stack([c[k].positions for c in clouds]), jnp.stack([c[k].mask for c in clouds]))
               for k in (0, 1)]
    want, _ = jgn.match_gn_3d_packed(flat_hi, flat_lo, tmpl_hi, tmpl_lo, mc_hi, mc_lo, jnp.asarray(lane_d),
                                     *jclouds, JRigid3(jnp.asarray(t0), jnp.asarray(q0)), jnp.asarray(t0), *WEIGHTS,
                                     r_hi=r_hi, r_lo=r_lo, num_iterations=10)
    hi = [convert.grid_3d(a.high_resolution_grid, CPU) for a in anchors]
    lo = [convert.grid_3d(a.low_resolution_grid, CPU) for a in anchors]
    tclouds = [PointCloud(torch.stack([convert.point_cloud(c[k], CPU).positions for c in clouds]),
                          torch.stack([convert.point_cloud(c[k], CPU).mask for c in clouds])) for k in (0, 1)]
    got, cost = match_gn_3d_packed(prepare_gn_pack_3d(hi, lo), torch.from_numpy(lane_d), *tclouds,
                                   Rigid3(torch.from_numpy(t0), torch.from_numpy(q0)), torch.from_numpy(t0), *WEIGHTS,
                                   num_iterations=10)
    assert got.translation.shape == (3, 3) and cost.shape == (3,)
    np.testing.assert_allclose(got.translation.numpy(), np.asarray(want.translation), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.rotation.numpy(), np.asarray(want.rotation), rtol=0, atol=1e-4)
    # The unpacked form, one grid pair per lane: JAX's vmapped
    # match_gn_3d_batched, and the port's packed run bit for bit (lanes
    # that share a grid share its slot).
    per_lane = lambda grids: jax.tree.map(stack, *[grids[d] for d in lane_d])
    want_b, _ = jgn.match_gn_3d_batched(per_lane([a.high_resolution_grid for a in anchors]),
                                        per_lane([a.low_resolution_grid for a in anchors]), *jclouds,
                                        JRigid3(jnp.asarray(t0), jnp.asarray(q0)), jnp.asarray(t0), *WEIGHTS,
                                        num_iterations=10)
    got_b, cost_b = match_gn_3d_batched([hi[d] for d in lane_d], [lo[d] for d in lane_d], *tclouds,
                                        Rigid3(torch.from_numpy(t0), torch.from_numpy(q0)), torch.from_numpy(t0),
                                        *WEIGHTS, num_iterations=10)
    np.testing.assert_allclose(got_b.translation.numpy(), np.asarray(want_b.translation), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_b.rotation.numpy(), np.asarray(want_b.rotation), rtol=0, atol=1e-4)
    assert torch.equal(got_b.translation, got.translation) and torch.equal(got_b.rotation, got.rotation)
    assert torch.equal(cost_b, cost)
    for b, (d, *_) in enumerate(lanes):
        one, _ = match_gn_3d(hi[d], lo[d], convert.point_cloud(clouds[b][0], CPU),
                             convert.point_cloud(clouds[b][1], CPU), Rigid3(torch.from_numpy(t0[b]),
                                                                             torch.from_numpy(q0[b])),
                             torch.from_numpy(t0[b]), *WEIGHTS, num_iterations=10)
        np.testing.assert_allclose(got.translation[b].numpy(), one.translation.numpy(), rtol=0, atol=1e-5)
        np.testing.assert_allclose(got.rotation[b].numpy(), one.rotation.numpy(), rtol=0, atol=1e-5)


def test_get_pack_matches_jax(anchors):
    """(e) _get_pack_3d against the JAX one over one sequence of needed
    sets, under a budget that holds two of three submaps: the same order,
    slots and gauge bytes. A demoted matcher gives the serial search's
    result through the pack, and an evicted submap is re-admitted."""
    from test_batched_constraint_path import node_3d

    subs = [anchors[0], anchors[1], copy.copy(anchors[0])]
    jopts = options_3d(True)
    per = jcs.host_arrays_3d_nbytes(jcs.matcher_host_arrays_3d(jfc.FastCorrelativeScanMatcher3D(
        jopts.constraint_builder.fast_correlative_scan_matcher_3d, subs[0].high_resolution_grid,
        subs[0].low_resolution_grid, subs[0].rotational_histogram, HIST)))
    jopts = replace_deep(jopts, {"constraint_builder.pack_hbm_budget_bytes": int(2.5 * per)})
    jpg = JPoseGraph3D(jopts, histogram_size=HIST)
    pg = PoseGraph3D(convert.options(jopts), histogram_size=HIST, device=CPU)
    # The serial search of a node against submap 0 before any pack (the
    # node comes first, so that adding it starts no round).
    node = node_3d(0.2, np.array([0.6, -0.2, 0.0]), np.array([0.3, -0.2, 0.0]))
    pg.add_node(convert.pg_node(node, CPU), [])
    port_subs = [convert.submap_3d(s, CPU) for s in subs]
    for a, b in zip(subs, port_subs):
        jpg._get_or_add_submap(a, 0)
        pg._get_or_add_submap(b, 0)
    want = pg._compute_constraint(pg.nodes[0], pg.submaps[0])
    assert pg._pack3d is None
    mesh = one_device_mesh()
    for needed in ([0], [1], [2], [0, 2], [1], [0]):
        jslots, _ = jpg._get_pack_3d({sid: jpg.submaps[sid].matcher for sid in needed}, mesh)
        slots, packed = pg._get_pack_3d({sid: pg.submaps[sid].matcher for sid in needed})
        assert pg._pack3d["order"] == jpg._pack3d["order"]
        assert slots == jslots and pg._pack3d["bytes"] == jpg._pack3d["bytes"] <= 2.5 * per
        assert packed.count == len(slots)
        for sid, slot in slots.items():  # each member's block holds its tables
            for level, table in enumerate(pg._pack3d["host"][sid]["pyr"]):
                rows = packed.rows[level]
                assert torch.equal(packed.pyramids[level][slot * rows:(slot + 1) * rows], table)
    assert "pose_graph_constraint_pack_bytes_3d" in pg_mod.profiling.report()
    assert set(pg._pack3d["slots"]) != {0, 1, 2}  # the budget evicted one
    # Submap 0, evicted by [2], was re-admitted from the host cache by [0, 2];
    # every matcher holds the cache's tensors (demoted).
    assert 0 in pg._pack3d["slots"]
    assert all(s.matcher._pyramid_levels[0] is pg._pack3d["host"][s.submap_id]["pyr"][0] for s in pg.submaps)
    got = pg._compute_constraint(pg.nodes[0], pg.submaps[0])  # through the pack, as a round of one
    assert (got is None) == (want is None)
    if want is not None:
        np.testing.assert_allclose(got.zbar.t, want.zbar.t, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got.zbar.q, want.zbar.q, rtol=0, atol=1e-6)


@pytest.mark.parametrize("grid_type", GRID_TYPES)
def test_plain_versions_with_row_bases_and_slots_equal_single_calls(request, grid_type):
    """(f) K4's plain version over stacked tables with row bases, and K3's
    with slots (TSDF or probability mode), exactly equal one call per
    candidate or lane."""
    anchors = _anchors(request, grid_type)
    rng = np.random.default_rng(5)
    grid_shape, level, y_shift = (20, 24, 12), 1, 0
    rows, ny_l = 6 * 10 + 1, 24
    blocks = rng.uniform(0.0, 0.8, (3, rows, ny_l)).astype(np.float32)
    blocks[:, -1] = 0.0
    table = torch.from_numpy(blocks.reshape(-1, ny_l))
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))
    r, p, c = 8, 70, 12
    cells = [i32(rng.integers(-4, n + 4, (r, p))) for n in grid_shape]
    valid = torch.from_numpy(rng.random((r, p)) < 0.8)
    cand_t = i32(rng.integers(0, r, c))
    slot = rng.integers(0, 3, c)
    offs = [i32(rng.integers(-4, 5, (c, k))) for k in (2, 3, 2)]
    got = fast_scores_3d(table, *cells, valid, cand_t, *offs, level, y_shift, grid_shape,
                         torch.from_numpy(slot * rows))
    for k in range(c):
        one = fast_scores_3d_plain(torch.from_numpy(blocks[slot[k]]), *cells, valid, cand_t[k:k + 1],
                                   *(o[k:k + 1] for o in offs), level, y_shift, grid_shape)
        assert torch.equal(got[k:k + 1], one)
    # One flag row for every point row: the (P,) form.
    shared = fast_scores_3d_plain(table, *cells, valid[0], cand_t, *offs, level, y_shift, grid_shape,
                                  torch.from_numpy(slot * rows))
    assert torch.equal(shared, fast_scores_3d_plain(table, *cells, valid[:1].expand(r, p), cand_t, *offs, level,
                                                    y_shift, grid_shape, torch.from_numpy(slot * rows)))

    hi = [prepare_grid_3d(convert.grid_3d(a.high_resolution_grid, CPU)) for a in anchors]
    lo = [prepare_grid_3d(convert.grid_3d(a.low_resolution_grid, CPU)) for a in anchors]
    slots = grid_slots(hi, lo)
    assert slots.ptrs.shape == (2, 4) and slots.gparams.shape == (2, 8)
    assert slots.prob == (grid_type != "TSDF")
    lanes = torch.tensor([0, 1, 0, 1], dtype=torch.int32)
    pts = torch.from_numpy(scan_3d(np.array([0.3, -0.2, 0.0]))[rng.choice(1000, (4, 2, 64))].astype(np.float32))
    mask = torch.from_numpy(rng.random((4, 2, 64)) < 0.9)
    q = torch.tensor([[1.0, 0.0, 0.0, 0.0]]).expand(4, 4)
    pose7 = torch.cat([torch.from_numpy(rng.uniform(-0.1, 0.1, (4, 3)).astype(np.float32)), q], dim=1)
    dpose7 = torch.from_numpy(rng.normal(0, 1, (4, 7, 18)).astype(np.float32))
    scale = torch.full((4,), 0.2)
    args = (pts[:, 0].contiguous(), mask[:, 0].contiguous(), pts[:, 1].contiguous(), mask[:, 1].contiguous(),
            pose7, dpose7, scale, scale)
    got = ct_scan_block_slots(slots, lanes, *args)
    assert all(torch.equal(a, b) for a, b in zip(got, ct_scan_block_slots_plain(slots, lanes, *args)))
    assert float(got[0].abs().max()) > 0.0
    for k, d in enumerate(lanes.tolist()):
        one = ct_scan_block(hi[d], lo[d], *(a[k:k + 1] for a in args))
        assert all(torch.equal(a[k:k + 1], b) for a, b in zip(got, one))
        assert all(torch.equal(a, b) for a, b in zip(one, ct_scan_block_plain(hi[d], lo[d],
                                                                              *(a[k:k + 1] for a in args))))


def test_mixed_grid_shapes_fall_back_to_serial(anchors, monkeypatch):
    """(g) A round over submaps of two grid shapes takes the serial path,
    once, as the JAX package's does; both find the same constraints."""
    small = copy.copy(anchors[1])
    grid = anchors[1].high_resolution_grid
    small.high_resolution_grid = grid._replace(tsd=grid.tsd[:, :, :28], weight=grid.weight[:, :, :28])
    mixed = (anchors[0], small)
    calls = []
    for mod in (pg_mod, jpg_mod):
        orig = mod._observe_batched_round
        monkeypatch.setattr(mod, "_observe_batched_round", lambda n, orig=orig: (calls.append(n), orig(n)))
    monkeypatch.setattr(jpg_mod, "constraint_search_mesh", one_device_mesh)
    pg = port_drive_3d(mixed, options_3d(True))
    jax_pg = drive_3d(mixed, batched=True)
    assert calls == [] and pg.batched_fallbacks == 1
    assert [(n, s) for n, s, _ in inter_constraints(pg)] == [(n, s) for n, s, _ in inter_constraints(jax_pg)]


def test_mixed_grid_types_fall_back_to_serial(anchors, anchors_probability, monkeypatch):
    """(g') A round over a TSDF submap and an occupancy one takes the
    serial path, once, and finds the constraints of the serial search
    (each candidate refined against its own grid type)."""
    calls = []
    orig = pg_mod._observe_batched_round
    monkeypatch.setattr(pg_mod, "_observe_batched_round", lambda n: (calls.append(n), orig(n)))
    mixed = (anchors[0], anchors_probability[1])
    pg = port_drive_3d(mixed, options_3d(True))
    serial = port_drive_3d(mixed, options_3d(False))
    assert calls == [] and pg.batched_fallbacks == 1
    _assert_same_inter(inter_constraints(pg), inter_constraints(serial))
    grids = [prepare_grid_3d(convert.grid_3d(a.high_resolution_grid, CPU)) for a in mixed]
    with pytest.raises(TypeError, match="grid type"):
        grid_slots(grids, grids)


_CT = "trajectory_builder_3d.optimizing_local_trajectory_builder."


@pytest.mark.parametrize("grid_type", ["PROBABILITY_GRID", "TSDF"])
def test_map_builder_default_options_run_batched_rounds(monkeypatch, grid_type):
    """(h) MapBuilder with the default pose-graph options (the batched
    search on the async worker, default samplers, gates and matcher) and
    the default submap grid (PROBABILITY_GRID; the TSDF case overrides
    it): only the trajectory builder is cut to a short CPU scene (grids of
    48^3 / 16^3, submaps of 4 range data, a small CT window). At least one
    batched round runs, none falls back, and every pose is finite."""
    from hectorgrapher_tpu_torch.evaluation.scan_generator import raycast_box_room_3d
    from hectorgrapher_tpu_torch.sensor.types import TimedPointCloudData, pad_timed_cloud
    from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3

    calls = []
    orig = pg_mod._observe_batched_round
    monkeypatch.setattr(pg_mod, "_observe_batched_round", lambda n: (calls.append(n), orig(n)))
    overrides = {
        "use_trajectory_builder_3d": True, "trajectory_builder_3d.min_range": 0.4,
        "trajectory_builder_3d.submaps.high_grid_size": 48,
        "trajectory_builder_3d.submaps.low_grid_size": 16, "trajectory_builder_3d.submaps.num_range_data": 4,
        "trajectory_builder_3d.motion_filter.max_time_seconds": 0.05, _CT + "initialization_duration": 0.45,
        _CT + "max_control_points": 12, _CT + "max_clouds_in_window": 12, _CT + "points_per_cloud": 64,
        _CT + "max_num_iterations": 2}
    if grid_type == "TSDF":
        overrides["trajectory_builder_3d.submaps.grid_type"] = "TSDF"
    opts = tcfg.replace_deep(tcfg.MapBuilderOptions(), overrides)
    assert opts.pose_graph == tcfg.PoseGraphOptions()
    assert opts.trajectory_builder_3d.submaps.grid_type == grid_type
    mb = MapBuilder(opts, device="cpu")
    tb = mb.get_trajectory_builder(mb.add_trajectory_builder())
    for i in range(301):
        t = 0.01 * i
        x = np.array([0.2 * max(0.0, t - 0.6), 0.0, 0.0])
        tb.add_imu_data(t, np.array([0.0, 0.0, 9.80665]), np.zeros(3))
        if i % 5 == 0:
            tb.add_odometry_data(t, NpRigid3(x))
        if i % 10 == 5:
            pts = raycast_box_room_3d(x, np.array([1.0, 0, 0, 0]), num_azimuth=64, num_elevation=16)
            pts = pts[~np.isnan(pts[:, 0])]
            tb.add_range_data(TimedPointCloudData(t, np.zeros(3, np.float32),
                                                  pad_timed_cloud(pts, np.zeros(len(pts), np.float32), 1024)))
    pg = mb.pose_graph
    pg.wait_for_all_computations()
    assert calls and max(calls) >= 2, f"no batched round ({len(pg.nodes)} nodes)"
    assert pg.batched_fallbacks == 0 and pg._pack3d is not None
    assert all(np.all(np.isfinite(n.global_pose.t)) for n in pg.nodes)
