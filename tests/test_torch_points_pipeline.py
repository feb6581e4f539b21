"""The port's points processor pipeline (hectorgrapher_tpu_torch/io/
points_pipeline.py) against the JAX package's, with the cases of
tests/test_points_pipeline.py.

Each case builds the same pipeline in both packages (the port's on the
CPU), streams the same batches (made from a numpy seed) through
run_pipeline, and compares what comes out. Tolerance: written files byte
for byte (xyz, PLY, PCD, the X-ray and probability-grid PNGs), counts and
colors equal; the hybrid grid's log-odds within 1e-5 and its known cells
equal.
"""

import copy

import numpy as np
import pytest

from hectorgrapher_tpu.evaluation.scan_generator import raycast_box_room_3d, raycast_rect_room_2d
from hectorgrapher_tpu.io import points_pipeline as jpp
from hectorgrapher_tpu_torch.io import points_pipeline as tpp
from torch_parity import CPU


def _batches(pp, seed=0):
    """Three batches: a 2D room scan (frame "lidar", intensities), a random
    cloud of another frame, and a 3D room scan seen from (0.3, -0.2, 0)."""
    rng = np.random.default_rng(seed)
    room = raycast_rect_room_2d(np.zeros(2), 0.0, num_rays=720)
    room = room[~np.isnan(room[:, 0])]
    box = raycast_box_room_3d(np.array([0.3, -0.2, 0.0]), np.array([1.0, 0, 0, 0]), num_azimuth=64,
                              num_elevation=16)
    box = box[~np.isnan(box[:, 0])] + np.array([0.3, -0.2, 0.0])
    return [
        pp.PointsBatch(points=room.astype(np.float64), origin=np.zeros(3), frame_id="lidar",
                       intensities=rng.uniform(0, 40, len(room))),
        pp.PointsBatch(points=rng.uniform(-5, 5, (200, 3)), origin=np.zeros(3), frame_id="other"),
        pp.PointsBatch(points=box.astype(np.float64), origin=np.array([0.3, -0.2, 0.0]), frame_id="lidar",
                       start_time=0.1),
    ]


CASES = {
    "filters_and_count": [{"action": "min_max_range_filter", "min_range": 1.0, "max_range": 6.0},
                          {"action": "count"}, {"action": "write_xyz", "filename": "out.xyz"}],
    "ply_and_pcd": [{"action": "write_ply", "filename": "cloud.ply"}, {"action": "write_pcd", "filename": "cloud.pcd"}],
    "frame_filter_and_sampler": [{"action": "frame_id_filter", "keep_frames": ["lidar"]},
                                 {"action": "fixed_ratio_sampler", "sampling_ratio": 0.5},
                                 {"action": "frame_id_filter", "drop_frames": ["other"]},
                                 {"action": "count"}, {"action": "write_xyz", "filename": "f.xyz"}],
    "voxel_filter": [{"action": "voxel_filter_and_remove_moving_objects", "voxel_size": 0.2},
                     {"action": "count"}, {"action": "write_ply", "filename": "v.ply"}],
    "xray": [{"action": "write_xray_image", "filename": "xray_z.png", "voxel_size": 0.1},
             {"action": "write_xray_image", "filename": "xray_x.png", "voxel_size": 0.05, "axis": "x"}],
    "probability_grid": [{"action": "write_probability_grid", "filename": "grid.png", "resolution": 0.1,
                          "size": 256}],
    "outlier_multipass": [{"action": "voxel_filter_and_remove_moving_objects_multipass", "voxel_size": 0.5,
                           "miss_per_hit_limit": 3.0}, {"action": "count"},
                          {"action": "write_xyz", "filename": "kept.xyz"}],
    "hybrid_grid": [{"action": "write_hybrid_grid", "filename": "grid.npz", "voxel_size": 0.1, "size": 64}],
    "colors": [{"action": "color_points", "color": [1.0, 0.0, 0.0], "frame_id": "other"},
               {"action": "intensity_to_color", "min_intensity": 10.0, "max_intensity": 20.0,
                "frame_id": "lidar"}, {"action": "count"}],
}


def _run(pp, configs, out_dir, **kw):
    configs = copy.deepcopy(configs)
    for c in configs:
        if "filename" in c:
            c["filename"] = str(out_dir / c["filename"])
    pipeline = pp.build_pipeline(configs, **kw)
    batches = _batches(pp)
    pp.run_pipeline(pipeline, lambda: batches)
    counts, node = [], pipeline
    while node is not None:
        if isinstance(node, pp.CountingPointsProcessor):
            counts.append((node.num_points, node.num_batches))
        node = node.next
    return batches, counts


@pytest.mark.parametrize("case", sorted(CASES))
def test_pipeline_matches_jax(tmp_path, case):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    ours, counts = _run(tpp, CASES[case], tmp_path / "port", device=CPU)
    theirs, jcounts = _run(jpp, CASES[case], tmp_path / "jax")
    assert counts == jcounts
    for cfg in CASES[case]:
        if "filename" not in cfg:
            continue
        a, b = tmp_path / "port" / cfg["filename"], tmp_path / "jax" / cfg["filename"]
        if cfg["filename"].endswith(".npz"):
            da, db = np.load(a), np.load(b)
            np.testing.assert_array_equal(da["known"], db["known"])
            np.testing.assert_allclose(da["log_odds"], db["log_odds"], rtol=0, atol=1e-5)
            np.testing.assert_array_equal(da["min_corner"], db["min_corner"])
            assert float(da["resolution"]) == float(db["resolution"]) == np.float32(0.1)
            assert da["log_odds"].shape == (64, 64, 64) and da["known"].sum() >= 2
        else:
            assert a.read_bytes() == b.read_bytes(), cfg["filename"]
            assert a.stat().st_size > 0
    for x, y in zip(ours, theirs):
        assert (x.colors is None) == (y.colors is None)
        if x.colors is not None:
            np.testing.assert_array_equal(x.colors, y.colors)
    if case == "filters_and_count":
        r = np.linalg.norm(ours[0].points, axis=-1)
        assert counts[0][0] > int(((r >= 1.0) & (r <= 6.0)).sum())  # the other batches add points
    if case == "colors":
        assert ours[1].colors is not None and ours[0].colors is not None and ours[2].colors is None


def test_outlier_removal_drops_the_moving_point():
    """tests/test_points_pipeline.py's three-pass case: a point hit once
    whose voxel 20 later beams pass through is dropped, the wall stays; the
    reference's endpoint behavior is kept (the same count as JAX's)."""
    def source(pp):
        return lambda: [pp.PointsBatch(points=np.array([[2.0, 0.0, 0.0]]), origin=np.zeros(3))] + [
            pp.PointsBatch(points=np.array([[10.0, 0.0, 0.0]]), origin=np.zeros(3)) for _ in range(20)]

    counts = []
    for pp in (tpp, jpp):
        counter = pp.CountingPointsProcessor(pp.NullPointsProcessor())
        pp.run_pipeline(pp.OutlierRemovingPointsProcessor(counter, voxel_size=0.5, miss_per_hit_limit=3.0),
                        source(pp))
        counts.append(counter.num_points)
    assert counts == [20, 20]


def test_unknown_action_raises():
    with pytest.raises(KeyError):
        tpp.build_pipeline([{"action": "no_such_processor"}], device=CPU)
