"""The port's submap painting and trajectory drawing (hectorgrapher_tpu_torch/
io/drawing.py) against the JAX package's, with the cases of
tests/test_drawing.py.

Tolerance: the per-trajectory colors, the trajectory strokes and every
occupancy mask (alpha of known cells) equal; intensities and the
probability alpha ramp within 1e-6 (the two packages' exp may part by an
ulp); a painted pose graph's RGB image within one level, on at most a
thousandth of its pixels. Grids go through convert.py, in every storage
(f32, uint16 codes, float16 / bfloat16 TSDF planes); pose graphs through
one npz state file that both packages load.
"""

import math

import numpy as np
import pytest

import jax.numpy as jnp
from hectorgrapher_tpu.io import drawing as jdrawing
from hectorgrapher_tpu.mapping import grids as jgrids
from hectorgrapher_tpu.transform import np_quat as jnq
from hectorgrapher_tpu.transform.np_quat import NpRigid3 as JRigid
from hectorgrapher_tpu_torch import convert
from hectorgrapher_tpu_torch.io import drawing
from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3
from torch_parity import CPU


def _band_grid(resolution=0.05, size=64):
    """tests/test_drawing.py's probability grid: an occupied band at local
    x in [0.5, 1.0] (JAX)."""
    grid = jgrids.make_probability_grid(resolution, (size, size))
    prob = np.full((size, size), 0.5, np.float32)
    known = np.zeros((size, size), bool)
    x0, x1 = size // 2 + int(0.5 / resolution), size // 2 + int(1.0 / resolution)
    known[x0:x1, :] = True
    prob[x0:x1, :] = 0.95
    return grid._replace(log_odds=jnp.asarray(np.log(prob / (1 - prob)), jnp.float32), known=jnp.asarray(known))


def _random_grid(kind, shape, storage, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "probability":
        grid = jgrids.make_probability_grid(0.1, shape)
        known = rng.uniform(size=shape) < 0.5
        grid = grid._replace(log_odds=jnp.asarray(np.where(known, rng.normal(0, 2, shape), 0.0), jnp.float32),
                             known=jnp.asarray(known))
        return jgrids.quantize_probability_grid(grid) if storage == "uint16" else grid
    grid = jgrids.make_tsdf_grid(0.1, shape, truncation_distance=0.3, max_weight=50.0)
    weight = np.where(rng.uniform(size=shape) < 0.4, rng.uniform(0, 50, shape), 0.0)
    tsd = np.where(weight > 0, rng.uniform(-0.3, 0.3, shape), 0.3)
    grid = grid._replace(tsd=jnp.asarray(tsd, jnp.float32), weight=jnp.asarray(weight, jnp.float32))
    if storage == "uint16":
        return jgrids.quantize_tsdf_grid(grid)
    if storage in ("float16", "bfloat16"):
        return grid._replace(tsd=grid.tsd.astype(storage), weight=grid.weight.astype(storage))
    return grid


def _port(grid):
    return (convert.probability_grid if hasattr(grid, "log_odds") else convert.tsdf_grid)(grid, CPU)


GRIDS = {
    "prob2d_band": lambda: _band_grid(),
    "prob2d_random": lambda: _random_grid("probability", (24, 20), "float32"),
    "prob2d_uint16": lambda: _random_grid("probability", (24, 20), "uint16"),
    "prob3d": lambda: _random_grid("probability", (16, 12, 8), "float32"),
    "prob3d_uint16": lambda: _random_grid("probability", (16, 12, 8), "uint16"),
    "tsdf2d": lambda: _random_grid("tsdf", (24, 20), "float32"),
    "tsdf3d": lambda: _random_grid("tsdf", (16, 12, 8), "float32"),
    "tsdf3d_uint16": lambda: _random_grid("tsdf", (16, 12, 8), "uint16"),
    "tsdf3d_float16": lambda: _random_grid("tsdf", (16, 12, 8), "float16"),
    "tsdf3d_bfloat16": lambda: _random_grid("tsdf", (16, 12, 8), "bfloat16"),
}


def _assert_images(ours, theirs):
    (i, a), (ji, ja) = ours, theirs
    assert i.shape == ji.shape and i.dtype == ji.dtype == np.float32 and a.dtype == ja.dtype == np.float32
    np.testing.assert_array_equal(a > 0, ja > 0)
    np.testing.assert_allclose(a, ja, rtol=0, atol=1e-6)
    np.testing.assert_allclose(i, ji, rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", sorted(GRIDS))
def test_grid_images_match_jax(case):
    grid = GRIDS[case]()
    _assert_images(drawing._grid_images(_port(grid)), jdrawing._grid_images(grid))


class _Submap2D:
    def __init__(self, grid):
        self.grid = grid


class _Submap3D:
    def __init__(self, high):
        self.high_resolution_grid = high


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_submap_to_slice_matches_jax(dim):
    grid = _band_grid() if dim == "2d" else _random_grid("tsdf", (16, 12, 8), "float32")
    wrap = _Submap2D if dim == "2d" else _Submap3D
    q = jnq.quat_from_axis_angle(np.array([0.0, 0.0, 0.3]))
    ours = drawing.submap_to_slice(wrap(_port(grid)), NpRigid3(np.array([1.0, -0.5, 0.2]), q))
    theirs = jdrawing.submap_to_slice(wrap(grid), JRigid(np.array([1.0, -0.5, 0.2]), q))
    _assert_images((ours.intensity, ours.alpha), (theirs.intensity, theirs.alpha))
    assert ours.resolution == theirs.resolution
    np.testing.assert_array_equal(ours.min_corner, theirs.min_corner)
    assert ours.min_corner.dtype == np.float64


PAINTS = {
    "single": [(np.array([2.0, 0.0, 0.0]), 0.0)],
    "rotated": [(np.zeros(3), math.pi / 2)],
    "overlapping": [(np.zeros(3), 0.0), (np.array([0.25, 0.0, 0.0]), 0.0)],
    "three_rotated": [(np.zeros(3), 0.2), (np.array([0.7, -0.3, 0.0]), -0.5), (np.array([-1.0, 0.4, 0.0]), 2.0)],
    "empty": [],
}


@pytest.mark.parametrize("case", sorted(PAINTS))
def test_paint_submap_slices_matches_jax(case):
    grid = _band_grid()
    slices, jslices = [], []
    for t, yaw in PAINTS[case]:
        q = jnq.quat_from_axis_angle(np.array([0.0, 0.0, yaw]))
        slices.append(drawing.submap_to_slice(_Submap2D(_port(grid)), NpRigid3(t, q)))
        jslices.append(jdrawing.submap_to_slice(_Submap2D(grid), JRigid(t, q)))
    ours, theirs = drawing.paint_submap_slices(slices, 0.05), jdrawing.paint_submap_slices(jslices, 0.05)
    np.testing.assert_array_equal(ours.origin, theirs.origin)
    _assert_images((ours.intensity, ours.alpha), (theirs.intensity, theirs.alpha))
    np.testing.assert_array_equal(ours.to_rgb(), theirs.to_rgb())
    probe = NpRigid3(np.array([0.75, 0.1, 0.0]))
    assert ours.pose_to_pixel(probe) == theirs.pose_to_pixel(JRigid(probe.t))
    if case == "single":  # tests/test_drawing.py: the band lands at world x in [2.5, 3.0]
        col, row = ours.pose_to_pixel(NpRigid3(np.array([2.55, 0.0, 0.0])))
        assert ours.alpha[row, col] > 0.5 and ours.intensity[row, col] < 0.3
    if case == "empty":
        assert ours.alpha.max() == 0.0


TRAJECTORIES = {
    "polyline": ([(10, 10), (50, 10), (50, 50)], (0.0, 0.0, 1.0), {}),
    "wide": ([(5, 60), (30, 20), (60, 58)], (0.8, 0.3, 0.1), {"width": 7.0, "alpha": 0.4, "end_marker_radius": 3.0}),
    "off_canvas": ([(-10, 5), (70, 30)], (1.0, 0.0, 0.0), {}),
    "single_point": ([(8, 8)], (1.0, 0.0, 0.0), {}),
    "empty": ([], (1.0, 0.0, 0.0), {}),
}


@pytest.mark.parametrize("case", sorted(TRAJECTORIES))
def test_draw_trajectory_matches_jax(case):
    pts, color, kw = TRAJECTORIES[case]
    base = np.random.default_rng(0).integers(0, 256, (64, 64, 3)).astype(np.uint8)
    ours, theirs = base.copy(), base.copy()
    drawing.draw_trajectory(ours, pts, color, **kw)
    jdrawing.draw_trajectory(theirs, pts, color, **kw)
    np.testing.assert_array_equal(ours, theirs)
    assert (case == "empty") == np.array_equal(ours, base)


def test_colors_match_jax():
    colors = [drawing.get_color(t) for t in range(8)]
    assert colors == [jdrawing.get_color(t) for t in range(8)]
    assert len(set(colors)) == 8 and all(0.0 <= v <= 1.0 for c in colors for v in c)


@pytest.mark.parametrize("case", ["2d-probability-float32", "2d-tsdf-uint16", "3d-probability-uint16",
                                  "3d-tsdf-float16"])
def test_paint_pose_graph_of_one_state_file(case, tmp_path):
    """One npz state file (saved by the JAX package), loaded into both
    packages' pose graphs, paints to the same RGB image."""
    from test_torch_serialization import _empty_graph, _jax_graph

    from hectorgrapher_tpu.io.serialization import load_state as jload_state
    from hectorgrapher_tpu.io.serialization import save_state as jsave_state
    from hectorgrapher_tpu_torch.io.serialization import load_state

    dim, grid_type, storage = case.split("-")
    path = str(tmp_path / "state.npz")
    jsave_state(_jax_graph(dim, grid_type, storage), path)
    jpg, pg = _empty_graph(dim, port=False), _empty_graph(dim, port=True)
    jload_state(jpg, path, load_frozen_state=False)
    load_state(pg, path, load_frozen_state=False)
    for include_unfinished in (True, False):
        ours = drawing.paint_pose_graph(pg, resolution=0.05, include_unfinished=include_unfinished)
        theirs = jdrawing.paint_pose_graph(jpg, resolution=0.05, include_unfinished=include_unfinished)
        assert ours.shape == theirs.shape and ours.dtype == np.uint8
        diff = np.abs(ours.astype(np.int16) - theirs.astype(np.int16)).max(axis=-1)
        assert diff.max() <= 1 and int((diff > 0).sum()) <= ours.shape[0] * ours.shape[1] // 1000
        assert (ours != np.array([127, 0, 0], np.uint8)).any(axis=-1).sum() > 0
