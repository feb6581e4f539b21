"""Parity of the port's 2D grid storage with the JAX package's, on the CPU
with the same seeded inputs: convert.py over 2D grids in their storage
dtype, ActiveSubmaps2D for each grid type and grid_storage_dtype, the
refusal of half probability grids, half TSDF planes through the inserter
(ROADMAP C21), and MapBuilder 2D on uint16 and on TSDF submaps (C20).

Tolerances, each with its reason:
  * convert.py: bit for bit;
  * f32 grids: tsd, weight and log-odds within 1e-5 in all but 1e-4 of
    the cells (ROADMAP C3 and C1, as tests/test_torch_tsdf_2d.py);
  * uint16 codes after finish: at most one code apart (the f32 values
    they encode differ within the f32 tolerance, and a value on a rounding
    boundary may round to the next code);
  * half TSDF planes (C21): the JAX package returns f32 planes after one
    insert, so the port is held to the JAX inserter driven with a cast back
    to the storage dtype after each insert, within two ulps of the storage
    dtype at the truncation distance (tsd) and at the cell's value
    (weight): the JAX package multiplies tsd * weight in the half dtype,
    the port in f32;
  * MapBuilder on uint16 submaps: every global error within max(2x, +0.05
    m) of the JAX package's (chip_smoke.py's SLAM bound), INTER constraints
    found in both.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from hectorgrapher_tpu.common import config as jcfg
from hectorgrapher_tpu.mapping import inserters_2d as jins
from hectorgrapher_tpu.mapping.grids import grid_nbytes as jgrid_nbytes
from hectorgrapher_tpu.mapping.grids import make_tsdf_grid, quantize_probability_grid, quantize_tsdf_grid
from hectorgrapher_tpu.mapping.map_builder import MapBuilder as JMapBuilder
from hectorgrapher_tpu.mapping.submap_2d import ActiveSubmaps2D
from hectorgrapher_tpu.sensor.types import TimedPointCloudData, pad_timed_cloud
from hectorgrapher_tpu.transform.np_quat import NpRigid3
from hectorgrapher_tpu_torch import convert
from hectorgrapher_tpu_torch.mapping import grids as tgrids
from hectorgrapher_tpu_torch.mapping import inserters_2d as tins
from hectorgrapher_tpu_torch.mapping import submap_2d as tsubmap
from hectorgrapher_tpu_torch.mapping.map_builder import MapBuilder
from hectorgrapher_tpu_torch.sensor import types as ttypes
from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3 as TNpRigid3
from test_map_builder_2d import circle_trajectory, make_options
from test_torch_pose_graph_2d import _drive_2d_builder
from test_torch_tsdf_2d import SCANS, SMALL_ROOM, scan_range_data
from torch_parity import CPU

torch.set_num_threads(1)

JAX_DTYPE = {"float32": jnp.float32, "float16": jnp.float16, "bfloat16": jnp.bfloat16}
TORCH_DTYPE = {"float32": torch.float32, "float16": torch.float16, "bfloat16": torch.bfloat16}
EPS = {"float16": 2.0**-10, "bfloat16": 2.0**-7}  # the storage dtype's ulp at 1


def _f32(x):
    return x.to(torch.float32).numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _ulp(v, dtype):
    """One ulp of the storage dtype at |v| (normal numbers)."""
    return EPS[dtype] * 2.0 ** np.floor(np.log2(np.maximum(np.abs(v), 2.0**-14)))


def _bits(x):
    a = np.array(x)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


def _tsdf_grid(dtype="float32", inserts=3, quantize=False):
    """A 96^2 JAX TSDF of `dtype` with `inserts` scans, cast back after
    each insert (C21), quantized to uint16 with `quantize`."""
    opts = jcfg.TSDFRangeDataInserterOptions2D()
    grid = make_tsdf_grid(0.05, (96, 96), opts.truncation_distance, opts.maximum_weight, center=(0.3, -0.1),
                          dtype=JAX_DTYPE[dtype])
    insert = jins.make_tsdf_inserter_2d(opts, 0.05)
    for i in range(inserts):
        grid = insert(grid, scan_range_data(i, *SCANS[i % 3], room=SMALL_ROOM))
        grid = grid._replace(tsd=grid.tsd.astype(JAX_DTYPE[dtype]), weight=grid.weight.astype(JAX_DTYPE[dtype]))
    return quantize_tsdf_grid(grid) if quantize else grid


def _probability_grid_u16():
    from hectorgrapher_tpu.mapping.grids import make_probability_grid
    from hectorgrapher_tpu.mapping.inserters_2d import make_probability_inserter_2d

    grid = make_probability_grid(0.05, (96, 96), center=(0.3, -0.1))
    insert = make_probability_inserter_2d(jcfg.ProbabilityGridRangeDataInserterOptions2D(), 4.8, 0.05)
    for i in range(3):
        grid = insert(grid, scan_range_data(i, *SCANS[i], room=SMALL_ROOM))
    return quantize_probability_grid(grid)


_CONVERT_CASES = {
    "tsdf_float32": lambda: _tsdf_grid("float32"),
    "tsdf_float16": lambda: _tsdf_grid("float16"),
    "tsdf_bfloat16": lambda: _tsdf_grid("bfloat16"),
    "tsdf_uint16": lambda: _tsdf_grid("float32", quantize=True),
    "probability_uint16": _probability_grid_u16,
}


@pytest.mark.parametrize("kind", sorted(_CONVERT_CASES))
def test_convert_carries_2d_grids_in_their_storage_dtype(kind):
    """convert.submap_2d (and convert.grid_2d under it) carries a finished
    2D submap of each grid type and storage dtype bit for bit, its dtype
    and quantize_on_finish kept; the grid's bytes are the JAX grid's."""
    from hectorgrapher_tpu.mapping.submap_2d import Submap2D

    grid = _CONVERT_CASES[kind]()
    assert int((np.asarray(grid.known if kind.startswith("probability") else grid.weight) > 0).sum()) > 1000
    sub = convert.submap_2d(Submap2D(local_pose=NpRigid3(np.array([0.3, -0.1, 0.0])), grid=grid, num_range_data=3,
                                     insertion_finished=True, quantize_on_finish=kind.endswith("uint16")), CPU)
    assert sub.insertion_finished and sub.num_range_data == 3 and sub.quantize_on_finish == kind.endswith("uint16")
    planes = ("log_odds", "known") if kind.startswith("probability") else ("tsd", "weight")
    want_dtype = {"float32": torch.float32, "float16": torch.float16, "bfloat16": torch.bfloat16,
                  "uint16": torch.uint16}[kind.split("_")[1]]
    assert getattr(sub.grid, planes[0]).dtype == want_dtype
    for name in planes:
        got, want = getattr(sub.grid, name), getattr(grid, name)
        got = got.view(torch.int16) if got.element_size() == 2 else got
        np.testing.assert_array_equal(got.numpy().view(_bits(want).dtype), _bits(want))
    np.testing.assert_array_equal(sub.grid.meta.min_corner.numpy(), np.asarray(grid.meta.min_corner))
    assert tgrids.grid_nbytes(sub.grid) == jgrid_nbytes(grid)
    assert tgrids.volume_dtype(sub.grid) == (torch.float32 if want_dtype == torch.uint16 else want_dtype)


def test_matchers_decode_uint16_grids():
    """A finished uint16 probability submap is decoded wherever the 2D
    matchers read it (correlative_2d.py :216-218, :272-274, :333-335,
    gn_2d.py :279-281 of the JAX package): the correlative table, the dense
    score volume, the GN field and the fast matcher's levels from the codes
    equal those from the decoded f32 grid, and the dense scores equal the
    JAX package's on the codes within 1e-6."""
    from hectorgrapher_tpu.mapping.scan_matching.correlative_2d import score_volume_dense as jscores
    from hectorgrapher_tpu.sensor.types import PointCloud
    from hectorgrapher_tpu.transform.rigid import Rigid2 as JRigid2
    from hectorgrapher_tpu_torch.mapping.scan_matching import correlative_2d as tcorr
    from hectorgrapher_tpu_torch.mapping.scan_matching import fast_correlative_2d as tfc
    from hectorgrapher_tpu_torch.mapping.scan_matching import gn_2d as tgn
    from hectorgrapher_tpu_torch.transform.rigid import Rigid2

    grid = _probability_grid_u16()
    codes = convert.probability_grid(grid, CPU)
    decoded = tgrids.ensure_f32_grid(codes)
    assert codes.log_odds.dtype == torch.uint16 and decoded.log_odds.dtype == torch.float32
    window = tcorr.make_search_window(0.1, 0.05, 0.05, 2.5)
    assert torch.equal(tcorr.prepare_correlative_table(codes, window),
                       tcorr.prepare_correlative_table(decoded, window))
    assert torch.equal(tgn.prepare_gn_probability_field(codes).patches,
                       tgn.prepare_gn_probability_field(decoded).patches)
    assert torch.equal(tfc.prepare_fast_matcher_2d(codes, 4).flat_levels,
                       tfc.prepare_fast_matcher_2d(decoded, 4).flat_levels)
    rd = scan_range_data(0, *SCANS[0], room=SMALL_ROOM)
    pose = (np.array([0.02, -0.03], np.float32), np.float32(0.01))
    got = tcorr.score_volume_dense(codes, convert.point_cloud(rd.returns, CPU),
                                   Rigid2(torch.from_numpy(pose[0]), torch.tensor(pose[1])), window)
    want = jscores(grid, PointCloud(rd.returns.positions, rd.returns.mask),
                   JRigid2(jnp.asarray(pose[0]), jnp.asarray(pose[1])), window)
    assert 0.3 < float(got.max()) < 0.9
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def _cast_back(insert, dtype):
    """The JAX inserter with its planes cast back to `dtype` after each
    insert: the storage the JAX package documents (C21)."""
    def run(grid, rd):
        grid = insert(grid, rd)
        return grid._replace(tsd=grid.tsd.astype(dtype), weight=grid.weight.astype(dtype))

    return run


def _assert_grids_close(tgrid, jgrid, storage):
    """The submap grid tolerances of the module docstring."""
    if tgrid.shape != tuple(jgrid.shape):
        raise AssertionError(f"shapes {tgrid.shape} != {jgrid.shape}")
    if isinstance(tgrid, tgrids.ProbabilityGrid):
        planes = (("log_odds", tgrid.log_odds, jgrid.log_odds),)
        np.testing.assert_array_equal(tgrid.known.numpy(), np.asarray(jgrid.known))
    else:
        planes = (("tsd", tgrid.tsd, jgrid.tsd), ("weight", tgrid.weight, jgrid.weight))
    bad = np.zeros(tgrid.shape, bool)
    for name, got, want in planes:
        if got.dtype == torch.uint16:
            assert np.asarray(want).dtype == np.uint16
            bad |= np.abs(got.to(torch.int32).numpy() - np.asarray(want, np.int32)) > 1
            continue
        g, w = _f32(got), _f32(want)
        if storage in EPS:
            at = float(jgrid.truncation_distance) if name == "tsd" else np.maximum(np.abs(g), np.abs(w))
            bad |= np.abs(g - w) > 2 * _ulp(at, storage)
        else:
            bad |= np.abs(g - w) > 1e-5
    assert bad.sum() <= max(1, 1e-4 * bad.size), f"{bad.sum()} of {bad.size} cells differ"


@pytest.mark.parametrize("grid_type,storage", [
    ("PROBABILITY_GRID", "float32"), ("PROBABILITY_GRID", "uint16"), ("TSDF", "float32"), ("TSDF", "float16"),
    ("TSDF", "bfloat16"), ("TSDF", "uint16"),
])
def test_active_submaps_2d_match_jax(grid_type, storage):
    """ActiveSubmaps2D of each grid type and storage dtype over 7 inserts
    of two scans a submap, through both packages: the same spawn and
    finish sequence; every grid in its storage dtype (a finished uint16
    submap's codes at most one apart from JAX's); the active grids within
    the tolerance of their dtype; clipped returns counted on either grid
    type."""
    opts = jcfg.replace_deep(jcfg.SubmapsOptions2D(), {
        "num_range_data": 2, "grid_size": 96, "grid_options_2d.grid_type": grid_type,
        "grid_storage_dtype": storage})
    jsub = ActiveSubmaps2D(opts, max_ray_length=5.0)
    if storage in EPS:
        jsub._inserter = _cast_back(jsub._inserter, JAX_DTYPE[storage])
    tsub = tsubmap.ActiveSubmaps2D(convert.options(opts), CPU, max_ray_length=5.0)
    finished = 0
    clipped = tsubmap.clipped_points_counter()
    before = clipped.value
    for i in range(8):
        xy = (0.1 * i, 0.05 * i)
        rd = scan_range_data(10 + i, xy, 0.1 * i, room=(2.4, 2.6))
        origin = np.array([xy[0], xy[1], 0.0])
        jl = jsub.insert_range_data(rd, origin)
        tl = tsub.insert_range_data(convert.range_data(rd, CPU), origin)
        assert len(tl) == len(jl)
        for a, b in zip(tl, jl):
            assert (a.num_range_data, a.insertion_finished) == (b.num_range_data, b.insertion_finished)
            assert a.quantize_on_finish == (storage == "uint16")
            np.testing.assert_array_equal(a.local_pose.t, b.local_pose.t)
            np.testing.assert_array_equal(a.grid.meta.min_corner.numpy(), np.asarray(b.grid.meta.min_corner))
            planes = a.grid.log_odds if grid_type == "PROBABILITY_GRID" else a.grid.tsd
            if a.insertion_finished and storage == "uint16":
                assert planes.dtype == torch.uint16
            else:
                assert planes.dtype == TORCH_DTYPE["float32" if storage == "uint16" else storage]
            finished += a.insertion_finished
            _assert_grids_close(a.grid, b.grid, storage)
    assert finished >= 3
    weight = a.grid.known if grid_type == "PROBABILITY_GRID" else a.grid.weight.to(torch.float32) > 0
    assert int(weight.sum()) > 1000
    assert clipped.value > before  # 96^2 cells at 0.05 m clip the room's 5.2 m side


@pytest.mark.parametrize("storage", ["float16", "bfloat16"])
def test_half_probability_storage_raises_as_jax(storage):
    """Half probability grids are refused with the JAX package's
    ValueError and message, by ActiveSubmaps2D and by MapBuilder's 2D
    trajectory builder."""
    opts = jcfg.replace_deep(jcfg.SubmapsOptions2D(), {"grid_storage_dtype": storage})
    with pytest.raises(ValueError) as want:
        ActiveSubmaps2D(opts)
    with pytest.raises(ValueError) as got:
        tsubmap.ActiveSubmaps2D(convert.options(opts), CPU)
    assert str(got.value) == str(want.value) and "only supported for TSDF" in str(got.value)
    mb = MapBuilder(convert.options(jcfg.replace_deep(
        make_options(), {"trajectory_builder_2d.submaps.grid_storage_dtype": storage,
                         "pose_graph.async_work_queue": False})), device=CPU)
    with pytest.raises(ValueError, match="only supported for TSDF"):
        mb.add_trajectory_builder()


@pytest.mark.parametrize("storage", ["float16", "bfloat16"])
def test_half_tsdf_keeps_its_dtype(storage):
    """ROADMAP C21, fixed and not mirrored: the JAX 2D inserter returns f32
    planes after one insert; the port's keeps the storage dtype, and stays
    within two ulps of the JAX inserter cast back after each insert, over
    six inserts of both project_sdf_distance_to_scan_normal settings."""
    for project in (True, False):
        opts = jcfg.replace_deep(jcfg.TSDFRangeDataInserterOptions2D(),
                                 {"project_sdf_distance_to_scan_normal": project})
        grid = make_tsdf_grid(0.05, (128, 128), opts.truncation_distance, opts.maximum_weight, center=(0.3, -0.1),
                              dtype=JAX_DTYPE[storage])
        tgrid = convert.tsdf_grid(grid, CPU)
        jinsert = jins.make_tsdf_inserter_2d(opts, 0.05)
        assert np.asarray(jinsert(grid, scan_range_data(0, *SCANS[0])).tsd).dtype == np.float32  # C21
        jinsert = _cast_back(jinsert, JAX_DTYPE[storage])
        tinsert = tins.make_tsdf_inserter_2d(convert.options(opts), 0.05)
        for i in range(6):
            rd = scan_range_data(30 + i, *SCANS[i % 3], room=SMALL_ROOM)
            grid = jinsert(grid, rd)
            tgrid = tinsert(tgrid, convert.range_data(rd, CPU))
            assert tgrid.tsd.dtype == tgrid.weight.dtype == TORCH_DTYPE[storage]
        assert int((tgrid.weight.to(torch.float32) > 0).sum()) > 2000
        _assert_grids_close(tgrid, grid, storage)


def _global_errors(pg, poses):
    """test_quantized_grids.py's error: each node's global position against
    the truth in the first pose's frame."""
    xy0, yaw0 = poses[0]
    c0, s0 = np.cos(yaw0), np.sin(yaw0)
    errs = []
    for node in pg.nodes:
        gt_xy, _ = poses[int(round(node.time / 0.1))]
        d = gt_xy - xy0
        errs.append(float(np.linalg.norm(node.global_pose.t[:2] - np.array([c0 * d[0] + s0 * d[1],
                                                                           -s0 * d[0] + c0 * d[1]]))))
    return np.array(errs)


def _drive_both(overrides):
    """tests/test_map_builder_2d.py's circle through the MapBuilder of both
    packages at make_options() with `overrides`, each pose graph drained."""
    jopts = jcfg.replace_deep(make_options(), overrides)
    jmb, mb = JMapBuilder(jopts), MapBuilder(convert.options(jopts), device=CPU)
    poses = circle_trajectory()
    _drive_2d_builder(jmb.get_trajectory_builder(jmb.add_trajectory_builder()), NpRigid3, TimedPointCloudData,
                      pad_timed_cloud, poses)
    _drive_2d_builder(mb.get_trajectory_builder(mb.add_trajectory_builder()), TNpRigid3, ttypes.TimedPointCloudData,
                      ttypes.pad_timed_cloud, poses)
    jmb.pose_graph.wait_for_all_computations()
    mb.pose_graph.wait_for_all_computations()
    return jmb.pose_graph, mb.pose_graph, poses


def test_map_builder_2d_on_uint16_submaps_matches_jax():
    """tests/test_quantized_grids.py:79's drive (make_options with
    grid_storage_dtype uint16, the async queue, the batched search) through
    both packages: every finished submap holds uint16 codes, INTER
    constraints are found against them, and after the final optimization
    the port's largest and median global errors are within max(2x, +0.05
    m) of the JAX package's (and below the JAX test's 0.5 m)."""
    jpg, pg, poses = _drive_both({"trajectory_builder_2d.submaps.grid_storage_dtype": "uint16"})
    finished = [s for s in pg.submaps if s.finished]
    assert finished and all(s.submap.grid.log_odds.dtype == torch.uint16 for s in finished)
    assert len(pg.nodes) == len(jpg.nodes) >= 20
    assert sum(c.tag == "INTER" for c in pg.constraints) > 0 and sum(c.tag == "INTER" for c in jpg.constraints) > 0
    jpg.run_final_optimization()
    pg.run_final_optimization()
    got, want = _global_errors(pg, poses), _global_errors(jpg, poses)
    for f in (np.max, np.median):
        assert f(got) <= max(2 * f(want), f(want) + 0.05), f"{f.__name__}: {f(got):.5f} m vs JAX {f(want):.5f} m"
    assert got.max() < 0.5


def test_map_builder_2d_on_tsdf_submaps_finds_no_inter_constraint(capfd):
    """ROADMAP C20, mirrored: on 2D TSDF submaps (grid_size 256) every
    constraint search of either package fails on its TSDF submap, the
    worker logs the error and goes on; the runs complete with the same
    nodes and no INTER constraint, and the port's error names C20."""
    jpg, pg, _ = _drive_both({"trajectory_builder_2d.submaps.grid_options_2d.grid_type": "TSDF",
                              "trajectory_builder_2d.submaps.grid_size": 256})
    err = capfd.readouterr().err
    assert len(pg.nodes) == len(jpg.nodes) >= 20
    assert sum(s.finished for s in pg.submaps) == sum(s.finished for s in jpg.submaps) >= 1
    assert all(type(s.submap.grid).__name__ == "TSDFGrid" for s in pg.submaps)
    assert not any(c.tag == "INTER" for c in pg.constraints)
    assert not any(c.tag == "INTER" for c in jpg.constraints)
    assert "AttributeError" in err and "TypeError" in err and "ROADMAP C20" in err
