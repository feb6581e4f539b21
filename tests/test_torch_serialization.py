"""The port's state I/O (hectorgrapher_tpu_torch.io.serialization,
io.pbstream_state, and cloud.local_slam_result's grid packing) against the
JAX package's.

The same pose graph is built in both packages from seeded numpy draws: a
JAX PoseGraph2D or PoseGraph3D with three nodes (clouds, histograms,
gravity) on two submaps, and the port's from convert.py's copies of the
same submaps and nodes. Grids cover every storage the submaps use: 2D and
3D occupancy in float32 or uint16 codes, 2D TSDF in float32 or float16,
3D TSDF in float32, float16, bfloat16 or uint16 codes.

The npz file keeps the JAX layout: float planes as float16, uint16 codes
as they are, the same `__index__` JSON. So the port's round trip is
bit-equal to the graph rounded through float16, a JAX file loads in the
port and a port file in JAX, and the two packages' files hold the same
arrays bit for bit. The pbstream codecs are held the same way, each
package's records decoded by the other.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hectorgrapher_tpu.cloud import local_slam_result as jlsr
from hectorgrapher_tpu.common import time as jtime
from hectorgrapher_tpu.common.config import MapBuilderOptions, replace_deep
from hectorgrapher_tpu.io import pbstream as jpbstream
from hectorgrapher_tpu.io import pbstream_state as jpbs
from hectorgrapher_tpu.io import serialization as jser
from hectorgrapher_tpu.mapping import grids as jgrids
from hectorgrapher_tpu.mapping.pose_graph.pose_graph import PgNode as JPgNode
from hectorgrapher_tpu.mapping.pose_graph.pose_graph import PoseGraph2D as JPoseGraph2D
from hectorgrapher_tpu.mapping.pose_graph.pose_graph import PoseGraph3D as JPoseGraph3D
from hectorgrapher_tpu.mapping.submap_2d import Submap2D as JSubmap2D
from hectorgrapher_tpu.mapping.submap_3d import Submap3D as JSubmap3D
from hectorgrapher_tpu.sensor import compression as jcompression
from hectorgrapher_tpu.sensor.types import pad_cloud as jpad_cloud
from hectorgrapher_tpu.transform.np_quat import NpRigid3 as JNpRigid3
from hectorgrapher_tpu_torch import convert
from hectorgrapher_tpu_torch.cloud import local_slam_result as tlsr
from hectorgrapher_tpu_torch.common import time as ttime
from hectorgrapher_tpu_torch.io import pbstream as tpbstream
from hectorgrapher_tpu_torch.io import pbstream_state as tpbs
from hectorgrapher_tpu_torch.io import serialization as tser
from hectorgrapher_tpu_torch.mapping.pose_graph.pose_graph import PoseGraph2D, PoseGraph3D, TrajectoryState
from hectorgrapher_tpu_torch.sensor import compression as tcompression
from torch_parity import CPU, bf16_to_torch

# (dim, grid type, storage) of every case.
CASES = [
    ("2d", "probability", "float32"),
    ("2d", "probability", "uint16"),
    ("2d", "tsdf", "float32"),
    ("2d", "tsdf", "float16"),
    ("3d", "probability", "float32"),
    ("3d", "probability", "uint16"),
    ("3d", "tsdf", "float32"),
    ("3d", "tsdf", "float16"),
    ("3d", "tsdf", "bfloat16"),
    ("3d", "tsdf", "uint16"),
]
CASE_IDS = ["-".join(c) for c in CASES]
# The pbstream codecs decode uint16 codes to f32 first, where XLA's fused
# arithmetic and the port's can part by an ulp (ROADMAP C0); their
# exactness is held on the float planes.
PBSTREAM_CASES = [c for c in CASES if c[2] != "uint16"]


def _pose_graph_options():
    return replace_deep(MapBuilderOptions(), {
        "pose_graph.optimize_every_n_nodes": 0,
        "pose_graph.async_work_queue": False,
        "pose_graph.constraint_builder.sampling_ratio": 0.0,
    }).pose_graph


def _jax_grid(dim, grid_type, storage, seed, center):
    """A JAX grid of seeded random cells on the submap's lattice."""
    rng = np.random.default_rng(seed)
    shape = (24, 20) if dim == "2d" else (16, 12, 8)
    if grid_type == "probability":
        grid = jgrids.make_probability_grid(0.05 if dim == "2d" else 0.1, shape, center=center[:len(shape)])
        known = rng.uniform(size=shape) < 0.6
        grid = grid._replace(log_odds=jnp.asarray(np.where(known, rng.normal(0, 2, shape), 0.0), jnp.float32),
                             known=jnp.asarray(known))
        return jgrids.quantize_probability_grid(grid) if storage == "uint16" else grid
    grid = jgrids.make_tsdf_grid(0.1, shape, truncation_distance=0.3, max_weight=50.0, center=center[:len(shape)])
    weight = np.where(rng.uniform(size=shape) < 0.5, rng.uniform(0, 50, shape), 0.0)
    tsd = np.where(weight > 0, rng.uniform(-0.3, 0.3, shape), 0.3)
    grid = grid._replace(tsd=jnp.asarray(tsd, jnp.float32), weight=jnp.asarray(weight, jnp.float32))
    if storage == "uint16":
        return jgrids.quantize_tsdf_grid(grid)
    if storage in ("float16", "bfloat16"):
        return grid._replace(tsd=grid.tsd.astype(storage), weight=grid.weight.astype(storage))
    return grid


def _jax_graph(dim, grid_type, storage):
    """A JAX pose graph: two submaps (the first finished), three nodes,
    INTRA constraints, seeded clouds, histograms and gravity."""
    rng = np.random.default_rng(7)
    submaps = []
    for k in range(2):
        t = np.array([0.05 + 0.1 * k, -0.05, 0.05])
        grids = [_jax_grid(dim, grid_type, storage, 10 * k + j, t) for j in range(2)]
        if dim == "2d":
            submaps.append(JSubmap2D(local_pose=JNpRigid3(t), grid=grids[0], num_range_data=3 - k,
                                     insertion_finished=k == 0))
        else:
            submaps.append(JSubmap3D(local_pose=JNpRigid3(t), high_resolution_grid=grids[0],
                                     low_resolution_grid=grids[1],
                                     rotational_histogram=rng.uniform(0, 1, 16).astype(np.float32),
                                     num_range_data=3 - k, insertion_finished=k == 0))
    pg = _empty_graph(dim, port=False)
    for i in range(3):
        pose = JNpRigid3(np.array([0.1 * i, 0.02 * i, 0.0]),
                         np.array([np.cos(0.05 * i), 0.0, 0.0, np.sin(0.05 * i)]))
        gravity = np.array([1.0, 0.01 * i, 0.0, 0.0]) / np.linalg.norm([1.0, 0.01 * i, 0.0, 0.0])
        cloud = lambda n, cap: jpad_cloud(rng.uniform(-3, 3, (n, 3)).astype(np.float32), cap)
        if dim == "2d":
            node = JPgNode(time=0.1 * i, local_pose=pose, global_pose=JNpRigid3.identity(), cloud=cloud(50, 64),
                           gravity_alignment=gravity)
        else:
            node = JPgNode(time=0.1 * i, local_pose=pose, global_pose=JNpRigid3.identity(), high_cloud=cloud(60, 64),
                           low_cloud=cloud(20, 32), histogram=rng.uniform(0, 1, 16).astype(np.float32),
                           gravity_alignment=gravity)
        pg.add_node(node, submaps)
    return pg


def _empty_graph(dim, port):
    """An empty pose graph of either package."""
    options = _pose_graph_options()
    if port:
        options = convert.options(options)
        return PoseGraph2D(options, device=CPU) if dim == "2d" else PoseGraph3D(options, histogram_size=16, device=CPU)
    return JPoseGraph2D(options) if dim == "2d" else JPoseGraph3D(options, histogram_size=16)


def _port_graph(jpg, dim):
    """The port's pose graph over convert.py's copies of the JAX graph's
    submaps (storage dtype kept) and nodes, in the same order."""
    pg = _empty_graph(dim, port=True)
    copy = convert.submap_2d if dim == "2d" else convert.submap_3d
    submaps = [copy(s.submap, CPU) for s in jpg.submaps]
    for node in jpg.nodes:
        pg.add_node(convert.pg_node(node, CPU), submaps)
    return pg


@pytest.fixture(scope="module", params=CASES, ids=CASE_IDS)
def graphs(request):
    dim, grid_type, storage = request.param
    jpg = _jax_graph(dim, grid_type, storage)
    return dict(case=request.param, jax=jpg, port=_port_graph(jpg, dim))


def _planes(grid):
    return ("tsd", "weight") if hasattr(grid, "tsd") else ("log_odds", "known")


def _grids(submap):
    return [submap.grid] if hasattr(submap, "grid") else [submap.high_resolution_grid, submap.low_resolution_grid]


def _as_stored(plane: torch.Tensor) -> torch.Tensor:
    """A plane as a state file gives it back: float planes through
    float16 into float32, uint16 codes and masks as they are."""
    return plane if plane.dtype in (torch.uint16, torch.bool) else plane.to(torch.float16).to(torch.float32)


def _assert_port_graphs_equal(pg, loaded, stored=True):
    """Nodes, constraints and submaps equal bit for bit; grids as stored."""
    assert len(loaded.nodes) == len(pg.nodes) and len(loaded.submaps) == len(pg.submaps)
    for a, b in zip(pg.nodes, loaded.nodes):
        assert a.time == b.time and a.trajectory_id == b.trajectory_id
        for pa, pb in ((a.local_pose, b.local_pose), (a.global_pose, b.global_pose)):
            np.testing.assert_array_equal(pa.t, pb.t)
            np.testing.assert_array_equal(pa.q, pb.q)
        for key in ("cloud", "high_cloud", "low_cloud"):
            ca, cb = getattr(a, key), getattr(b, key)
            assert (ca is None) == (cb is None)
            if ca is not None:
                assert torch.equal(ca.positions, cb.positions) and torch.equal(ca.mask, cb.mask)
        assert (a.histogram is None) == (b.histogram is None)
        if a.histogram is not None:
            np.testing.assert_array_equal(a.histogram, b.histogram)
        np.testing.assert_array_equal(a.gravity_alignment, b.gravity_alignment)
    assert [(c.submap_index, c.node_index, c.tag, c.translation_weight, c.rotation_weight) for c in pg.constraints] \
        == [(c.submap_index, c.node_index, c.tag, c.translation_weight, c.rotation_weight) for c in loaded.constraints]
    for a, b in zip(pg.constraints, loaded.constraints):
        np.testing.assert_array_equal(a.zbar.t, b.zbar.t)
        np.testing.assert_array_equal(a.zbar.q, b.zbar.q)
    for a, b in zip(pg.submaps, loaded.submaps):
        assert a.finished == b.finished and a.trajectory_id == b.trajectory_id
        assert a.submap.num_range_data == b.submap.num_range_data
        np.testing.assert_array_equal(a.submap.local_pose.t, b.submap.local_pose.t)
        np.testing.assert_array_equal(a.global_pose.t, b.global_pose.t)
        if hasattr(a.submap, "rotational_histogram"):
            np.testing.assert_array_equal(a.submap.rotational_histogram, b.submap.rotational_histogram)
        for ga, gb in zip(_grids(a.submap), _grids(b.submap)):
            assert torch.equal(ga.meta.min_corner, gb.meta.min_corner)
            for name in _planes(ga):
                want = _as_stored(getattr(ga, name)) if stored else getattr(ga, name)
                assert getattr(gb, name).dtype == want.dtype, name
                assert torch.equal(getattr(gb, name), want), name


def _assert_port_matches_jax_graph(pg, jpg):
    """A port graph against a JAX graph after convert.py: the same nodes,
    constraints and grids (each grid plane bit for bit)."""
    assert len(pg.nodes) == len(jpg.nodes) and len(pg.submaps) == len(jpg.submaps)
    assert len(pg.constraints) == len(jpg.constraints)
    for n, jn in zip(pg.nodes, jpg.nodes):
        assert n.time == float(jn.time)
        np.testing.assert_array_equal(n.global_pose.t, jn.global_pose.t)
        np.testing.assert_array_equal(n.local_pose.q, jn.local_pose.q)
    for c, jc in zip(pg.constraints, jpg.constraints):
        assert (c.submap_index, c.node_index, c.tag) == (jc.submap_index, jc.node_index, jc.tag)
        np.testing.assert_array_equal(c.zbar.t, jc.zbar.t)
    copy = convert.submap_2d if hasattr(jpg.submaps[0].submap, "grid") else convert.submap_3d
    for s, js in zip(pg.submaps, jpg.submaps):
        for g, jg in zip(_grids(s.submap), _grids(copy(js.submap, CPU))):
            for name in _planes(g):
                assert torch.equal(getattr(g, name), getattr(jg, name)), name


def test_round_trip_is_bit_equal(graphs, tmp_path):
    """save_state -> load_state in the port: every node, constraint and
    submap back, grids bit-equal to the served ones through float16; a
    frozen load marks the trajectory FROZEN, a full one keeps its state."""
    pg = graphs["port"]
    path = str(tmp_path / "state.npz")
    tser.save_state(pg, path)
    dim = graphs["case"][0]
    loaded = _empty_graph(dim, port=True)
    remap = tser.load_state(loaded, path, load_frozen_state=False)
    assert remap == {0: 1} and loaded._trajectory_states[1] == TrajectoryState.ACTIVE
    for n in loaded.nodes:
        n.trajectory_id = 0  # the remap, undone for the comparison
    for s in loaded.submaps:
        s.trajectory_id = 0
    _assert_port_graphs_equal(pg, loaded)
    frozen = _empty_graph(dim, port=True)
    assert frozen.is_frozen(tser.load_state(frozen, path)[0])


def test_files_cross_packages(graphs, tmp_path):
    """A JAX state file loads in the port to the JAX graph's own load, and
    the port's file loads in JAX to the same; both files hold the same
    arrays bit for bit and the same index."""
    jpg, pg = graphs["jax"], graphs["port"]
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jser.save_state(jpg, jpath)
    tser.save_state(pg, tpath)
    with np.load(jpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files)
        assert json.loads(bytes(a["__index__"]).decode()) == json.loads(bytes(b["__index__"]).decode())
        for key in a.files:
            assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, key
            np.testing.assert_array_equal(a[key].view(np.uint8), b[key].view(np.uint8), err_msg=key)

    dim = graphs["case"][0]
    jax_of_jax, jax_of_port, port_of_jax = _empty_graph(dim, False), _empty_graph(dim, False), _empty_graph(dim, True)
    jser.load_state(jax_of_jax, jpath)
    jser.load_state(jax_of_port, tpath)
    tser.load_state(port_of_jax, jpath)
    _assert_port_matches_jax_graph(port_of_jax, jax_of_jax)
    _assert_port_matches_jax_graph(port_of_jax, jax_of_port)


def test_migrate_state_v1_to_v2(tmp_path):
    """A version-1 3D file (no submap histograms): the port's migration
    writes JAX's arrays, and loading the v1 file recomputes the same
    histograms from the INTRA-constrained nodes."""
    pg = _port_graph(_jax_graph("3d", "tsdf", "float32"), "3d")
    v2, v1 = str(tmp_path / "v2.npz"), str(tmp_path / "v1.npz")
    tser.save_state(pg, v2)
    with np.load(v2) as data:
        arrays = {k: data[k] for k in data.files if not k.endswith("_histogram") or k.startswith("node")}
        index = json.loads(bytes(data["__index__"]).decode())
    index["version"] = 1
    arrays["__index__"] = np.frombuffer(json.dumps(index).encode(), np.uint8)
    np.savez_compressed(v1, **arrays)
    out_t, out_j = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    assert tser.migrate_state_v1_to_v2(v1, out_t) == jser.migrate_state_v1_to_v2(v1, out_j) == 2
    with np.load(out_t) as a, np.load(out_j) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        want = a["node0_histogram"] + a["node1_histogram"] + a["node2_histogram"]
        np.testing.assert_array_equal(a["submap0_histogram"], want)
    with pytest.raises(ValueError, match="already at version"):
        tser.migrate_state_v1_to_v2(out_t, str(tmp_path / "again.npz"))
    loaded = _empty_graph("3d", port=True)
    tser.load_state(loaded, v1)
    with np.load(out_j) as b:
        for i, s in enumerate(loaded.submaps):
            np.testing.assert_array_equal(s.submap.rotational_histogram, b[f"submap{i}_histogram"])


@pytest.mark.parametrize("case", PBSTREAM_CASES, ids=["-".join(c) for c in PBSTREAM_CASES])
def test_pbstream_cross_packages(case, tmp_path):
    """write_pbstream_state: the port's records are JAX's records byte for
    byte; load_pbstream_state in the port gives JAX's load of the same
    file (grids over the known voxels' box, in the submap frame), and the
    port reads its own file back to the same graph."""
    jpg = _jax_graph(*case)
    pg = _port_graph(jpg, case[0])
    jpath, tpath = str(tmp_path / "jax.pbstream"), str(tmp_path / "port.pbstream")
    jpbs.write_pbstream_state(jpg, jpath)
    tpbs.write_pbstream_state(pg, tpath)
    assert list(tpbstream.read_records(tpath)) == list(jpbstream.read_records(jpath))

    jloaded = _empty_graph(case[0], port=False)
    jpbs.load_pbstream_state(jloaded, jpath)
    for path in (jpath, tpath):
        loaded = _empty_graph(case[0], port=True)
        assert loaded.is_frozen(tpbs.load_pbstream_state(loaded, path)[0])
        _assert_port_matches_jax_graph(loaded, jloaded)
        for n, jn in zip(loaded.nodes, jloaded.nodes):
            for key in ("cloud", "high_cloud", "low_cloud"):
                c, jc = getattr(n, key), getattr(jn, key)
                assert (c is None) == (jc is None)
                if c is not None:
                    np.testing.assert_array_equal(c.positions.numpy(), np.asarray(jc.positions))


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_pack_and_unpack_grid_match_jax(case):
    """_pack_grid gives JAX's dict (float planes as float16 bit for bit,
    uint16 codes as they are), with and without arrays; _unpack_grid and
    _fill_grid give JAX's grids after convert.py."""
    jgrid = _jax_grid(*case, seed=3, center=np.array([0.05, -0.05, 0.05]))
    grid = convert.grid_3d(jgrid, CPU)
    for include in (True, False):
        want, got = jlsr._pack_grid(jgrid, include), tlsr._pack_grid(grid, include)
        assert sorted(got) == sorted(want)
        for key, value in want.items():
            if isinstance(value, np.ndarray):
                assert got[key].dtype == value.dtype, key
                np.testing.assert_array_equal(got[key], value, err_msg=key)
            else:
                assert got[key] == value, key
        unpacked, junpacked = tlsr._unpack_grid(got, CPU), convert.grid_3d(jlsr._unpack_grid(want), CPU)
        for name in _planes(unpacked):
            assert torch.equal(getattr(unpacked, name), getattr(junpacked, name)), name
    full = tlsr._pack_grid(grid, True)
    empty = tlsr._unpack_grid(tlsr._pack_grid(grid, False), CPU)
    filled, jfilled = tlsr._fill_grid(empty, full, CPU), jlsr._fill_grid(jlsr._unpack_grid(
        jlsr._pack_grid(jgrid, False)), jlsr._pack_grid(jgrid, True))
    for name in _planes(filled):
        assert torch.equal(getattr(filled, name), getattr(convert.grid_3d(jfilled, CPU), name)), name
        if name != "known":
            want = getattr(grid, name)
            assert torch.equal(getattr(filled, name), want if want.dtype == torch.uint16 else _as_stored(want))
    if case[2] == "bfloat16":  # the port's bf16 planes are JAX's bits
        assert torch.equal(grid.tsd, bf16_to_torch(jgrid.tsd))


def test_host_copies_match_jax():
    """common/time.py and sensor/compression.py are the JAX package's."""
    rng = np.random.default_rng(2)
    pts = rng.uniform(-20, 20, (300, 3))
    stream, n = tcompression.compress(pts)
    jstream, jn = jcompression.compress(pts)
    assert n == jn and np.array_equal(stream, jstream)
    np.testing.assert_array_equal(tcompression.decompress(stream, n), jcompression.decompress(jstream, jn))
    for t in (0.0, 0.1, 1234.5678901, 1.7e9):
        assert ttime.to_universal(t) == jtime.to_universal(t)
        assert ttime.from_universal(ttime.to_universal(t)) == jtime.from_universal(jtime.to_universal(t))
        assert tpbs.seconds_to_ticks(t) == jpbs.seconds_to_ticks(t)
        assert tpbs.ticks_to_seconds(tpbs.seconds_to_ticks(t)) == jpbs.ticks_to_seconds(jpbs.seconds_to_ticks(t))


def test_pure_localization_against_frozen_map(tmp_path):
    """tests/test_serialization.py's frozen-map localization in the port
    (256^2 submaps in place of 512^2, for time): a map saved, loaded frozen into a new MapBuilder, a second trajectory
    driven on it. The pose graph's async worker computes the constraints
    after add_node returns, so they are read after
    wait_for_all_computations (ROADMAP C23: the JAX test reads them
    without waiting, and finds 0 when its worker lags)."""
    from hectorgrapher_tpu_torch.evaluation.scan_generator import raycast_rect_room_2d
    from hectorgrapher_tpu_torch.mapping.map_builder import MapBuilder
    from hectorgrapher_tpu_torch.sensor.types import TimedPointCloudData, pad_timed_cloud
    from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3
    from test_serialization import make_options

    def drive_line(mb, n):
        tb = mb.get_trajectory_builder(mb.num_trajectory_builders() - 1)
        for i in range(n):
            t, x = 0.1 * i, 0.08 * i
            tb.add_odometry_data(t, NpRigid3(np.array([x, 0.0, 0.0])))
            pts = raycast_rect_room_2d(np.array([x, 0.0]), 0.0, num_rays=1440)
            pts = pts[~np.isnan(pts[:, 0])].astype(np.float32)
            tb.add_range_data(TimedPointCloudData(time=t, origin=np.zeros(3, np.float32),
                                                  ranges=pad_timed_cloud(pts, np.zeros(len(pts), np.float32), 2048)))

    options = convert.options(replace_deep(make_options(), {"trajectory_builder_2d.submaps.grid_size": 256}))
    assert options.pose_graph.async_work_queue
    mb = MapBuilder(options, device=CPU)
    mb.add_trajectory_builder()
    drive_line(mb, 18)
    mb.pose_graph.wait_for_all_computations()
    for s in mb.pose_graph.submaps:
        s.submap.insertion_finished = True
        s.finished = True
    path = str(tmp_path / "map.npz")
    tser.save_state(mb.pose_graph, path)

    mb2 = MapBuilder(options, device=CPU)
    frozen_id = tser.load_state(mb2.pose_graph, path, load_frozen_state=True)[0]
    pg2 = mb2.pose_graph
    assert pg2.is_frozen(frozen_id)
    frozen_before = [n.global_pose.t.copy() for n in pg2.nodes]
    mb2.add_trajectory_builder()
    drive_line(mb2, 8)
    pg2.wait_for_all_computations()
    inter = [c for c in pg2.constraints if c.tag == "INTER" and pg2.submaps[c.submap_index].trajectory_id == frozen_id]
    assert len(inter) >= 1, "localization constraints against the frozen map expected"
    pg2.run_final_optimization()
    for n, before in zip(pg2.nodes, frozen_before):
        np.testing.assert_allclose(n.global_pose.t, before, rtol=0, atol=1e-9)
    new_nodes = [n for n in pg2.nodes if n.trajectory_id != frozen_id]
    assert new_nodes
    for i, n in enumerate(new_nodes):
        assert np.linalg.norm(n.global_pose.t[:2] - np.array([0.08 * i, 0.0])) < 0.25, i


def test_jax_frozen_map_count_races_the_worker(tmp_path, monkeypatch):
    """ROADMAP C23: tests/test_serialization.py's frozen-map test counts the
    INTER constraints right after driving, while the JAX pose graph's
    async worker computes them. With the worker's searches held until the
    count is read (a loaded machine, at the limit), the count is 0 and
    that test's `>= 1` fails; after wait_for_all_computations it holds.
    The JAX package's code runs unchanged; only its search is wrapped."""
    import threading

    from hectorgrapher_tpu.mapping.map_builder import MapBuilder as JMapBuilder
    from hectorgrapher_tpu.mapping.pose_graph import pose_graph as jpg_mod
    from test_serialization import drive_line, make_options

    mb = JMapBuilder(make_options())
    mb.add_trajectory_builder()
    drive_line(mb, n=18)
    for s in mb.pose_graph.submaps:
        s.submap.insertion_finished = True
        s.finished = True
    path = str(tmp_path / "map.npz")
    jser.save_state(mb.pose_graph, path)

    release = threading.Event()
    search = jpg_mod.PoseGraph2D._compute_constraint

    def held(self, *a, **kw):
        assert release.wait(timeout=120)
        return search(self, *a, **kw)

    monkeypatch.setattr(jpg_mod.PoseGraph2D, "_compute_constraint", held)
    mb2 = JMapBuilder(make_options())
    frozen_id = list(jser.load_state(mb2.pose_graph, path, load_frozen_state=True).values())[0]
    mb2.add_trajectory_builder()
    drive_line(mb2, n=8, rng=np.random.default_rng(1))
    pg2 = mb2.pose_graph
    count = lambda: sum(c.tag == "INTER" and pg2.submaps[c.submap_index].trajectory_id == frozen_id
                        for c in pg2.constraints)
    assert count() == 0
    release.set()
    pg2.wait_for_all_computations()
    assert count() >= 1
