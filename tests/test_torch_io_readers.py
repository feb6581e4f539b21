"""The port's file readers and image output (hectorgrapher_tpu_torch/io/
readers.py and io/image.py) against the JAX package's, with the cases of
tests/test_io_interop.py TestCloudFileReaders and tests/test_points_pipeline.py.

Tolerance: equal. Writers give the JAX package's bytes (PLY, PNG), each
package reads the other's files to equal arrays, and a grid renders to the
same pixels.
"""

import numpy as np
import pytest
import torch

from hectorgrapher_tpu.io import image as jimage
from hectorgrapher_tpu.io import readers as jreaders
from hectorgrapher_tpu_torch.io import image as timage
from hectorgrapher_tpu_torch.io import readers as treaders
from torch_parity import CPU, room_grid_and_cloud

PLY_ASCII = ("ply\nformat ascii 1.0\nelement vertex 2\n"
             "property float x\nproperty float y\nproperty float z\n"
             "property float intensity\nend_header\n"
             "1.0 2.0 3.0 0.5\n4.0 5.0 6.0 0.25\n")
PCD_ASCII = ("# .PCD v0.7\nVERSION 0.7\nFIELDS x y z intensity ring\n"
             "SIZE 4 4 4 4 2\nTYPE F F F F U\nCOUNT 1 1 1 1 1\n"
             "WIDTH 2\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS 2\nDATA ascii\n"
             "1 2 3 10 0\n4 5 6 20 1\n")


def _binary_pcd(path):
    dtype = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("intensity", "<f4"), ("ring", "<u2")])
    rows = np.array([(1, 2, 3, 10, 0), (4, 5, 6, 20, 1)], dtype=dtype)
    with open(path, "wb") as f:
        f.write(b"VERSION 0.7\nFIELDS x y z intensity ring\nSIZE 4 4 4 4 2\n"
                b"TYPE F F F F U\nCOUNT 1 1 1 1 1\nWIDTH 2\nHEIGHT 1\nPOINTS 2\nDATA binary\n")
        f.write(rows.tobytes())


def _binary_ply_with_properties(path):
    dtype = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("intensity", "<u1"), ("t", "<f8")])
    rows = np.zeros(3, dtype)
    rows["x"], rows["y"], rows["z"] = [1, 2, 3], [4, 5, 6], [7, 8, 9]
    rows["intensity"], rows["t"] = [10, 20, 30], [0.1, 0.2, 0.3]
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\ncomment made by a test\nelement vertex 3\n"
                b"property float x\nproperty float y\nproperty float z\nproperty uchar intensity\n"
                b"property double t\nelement face 0\nproperty list uchar int vertex_indices\nend_header\n")
        f.write(rows.tobytes())


FILES = {
    "ply_ascii.ply": lambda p: p.write_text(PLY_ASCII),
    "ply_binary_props.ply": lambda p: _binary_ply_with_properties(str(p)),
    "pcd_ascii.pcd": lambda p: p.write_text(PCD_ASCII),
    "pcd_binary.pcd": lambda p: _binary_pcd(str(p)),
    "cloud.xyz": lambda p: p.write_text("1 2 3 9\n4 5 6 9\n"),
    "cloud.txt": lambda p: p.write_text("0.5 0.25 0.125\n"),
}


@pytest.mark.parametrize("name", sorted(FILES))
def test_cloud_files_read_as_jax_reads_them(tmp_path, name):
    """read_ply / read_pcd give the JAX readers' columns, and
    read_cloud_file the same (N, 3) float32 xyz."""
    path = tmp_path / name
    FILES[name](path)
    if name.startswith("ply"):
        ours, theirs = treaders.read_ply(str(path)), jreaders.read_ply(str(path))
    elif name.startswith("pcd"):
        ours, theirs = treaders.read_pcd(str(path)), jreaders.read_pcd(str(path))
    else:
        ours = theirs = {}
    assert sorted(ours) == sorted(theirs)
    for key in ours:
        np.testing.assert_array_equal(ours[key], theirs[key])
        assert ours[key].dtype == theirs[key].dtype
    xyz = treaders.read_cloud_file(str(path))
    np.testing.assert_array_equal(xyz, jreaders.read_cloud_file(str(path)))
    assert xyz.dtype == np.float32 and xyz.shape[1] == 3


def test_unsupported_files_raise(tmp_path):
    (tmp_path / "x.obj").write_text("v 1 2 3\n")
    (tmp_path / "big.ply").write_text("ply\nformat binary_big_endian 1.0\nelement vertex 0\nend_header\n")
    (tmp_path / "no.ply").write_text("not a ply\n")
    for path in ("x.obj", "big.ply", "no.ply"):
        for module in (treaders, jreaders):
            with pytest.raises(ValueError):
                module.read_cloud_file(str(tmp_path / path))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_write_ply_bytes_and_cross_reads(tmp_path, writer):
    """write_ply writes the JAX writer's bytes; either package reads the
    other's file to the same points."""
    pts = np.random.default_rng(0).normal(0, 1, (57, 3)).astype(np.float32)
    ours, theirs = tmp_path / "cloud_1.250.ply", tmp_path / "jax_1.250.ply"
    treaders.write_ply(str(ours), pts)
    jreaders.write_ply(str(theirs), pts)
    assert ours.read_bytes() == theirs.read_bytes()
    path = str(ours if writer == "port" else theirs)
    reader = jreaders if writer == "port" else treaders
    np.testing.assert_array_equal(reader.read_cloud_file(path), pts)


def test_sensor_csvs_and_sequence_dir(tmp_path):
    """The IMU, odometry and mocap CSVs and a sequence directory read to
    the JAX readers' events, in the same order."""
    np.savetxt(tmp_path / "imu.csv", [[0.1, 0, 0, 9.81, 0.01, 0, 0], [0.2, 0.1, 0, 9.8, 0, 0.02, 0]], delimiter=",")
    np.savetxt(tmp_path / "odometry.csv", [[0.15, 1, 2, 3, 1, 0, 0, 0]], delimiter=",")
    np.savetxt(tmp_path / "mocap.csv", [[0.1, 0.5, 0, 0, 1, 0, 0, 0], [0.3, 0.7, 0, 0, 0, 0, 0, 1]], delimiter=",")
    rng = np.random.default_rng(3)
    treaders.write_ply(str(tmp_path / "scan_0.200.ply"), rng.normal(0, 1, (5, 3)).astype(np.float32))
    treaders.write_ply(str(tmp_path / "scan_0.100.ply"), rng.normal(0, 1, (4, 3)).astype(np.float32))
    (tmp_path / "scan_0.300.pcd").write_text(PCD_ASCII)
    for fn in ("read_imu_csv", "read_odometry_csv"):
        a, b = getattr(treaders, fn)(str(tmp_path / f"{fn[5:-4]}.csv")), getattr(jreaders, fn)(str(tmp_path / f"{fn[5:-4]}.csv"))
        assert [(e.time, e.kind) for e in a] == [(e.time, e.kind) for e in b]
    mocap, jmocap = treaders.read_mocap_csv(str(tmp_path / "mocap.csv")), jreaders.read_mocap_csv(str(tmp_path / "mocap.csv"))
    assert [t for t, _ in mocap] == [t for t, _ in jmocap]
    for (_, p), (_, q) in zip(mocap, jmocap):
        np.testing.assert_array_equal(p.t, q.t)
        np.testing.assert_array_equal(p.q, q.q)
    events, jevents = treaders.read_sequence_dir(str(tmp_path)), jreaders.read_sequence_dir(str(tmp_path))
    assert [e.kind for e in events] == ["imu", "range", "odometry", "imu", "range", "range"]
    assert [(e.time, e.kind) for e in events] == [(e.time, e.kind) for e in jevents]
    for a, b in zip(events, jevents):
        if a.kind == "range":
            np.testing.assert_array_equal(a.payload, b.payload)
        elif a.kind == "imu":
            np.testing.assert_array_equal(np.concatenate(a.payload), np.concatenate(b.payload))
        else:
            np.testing.assert_array_equal(a.payload.t, b.payload.t)
    with pytest.raises(ValueError):
        treaders._stamp_of("scan.ply")


IMAGES = {
    "gray": lambda: (np.arange(64 * 32).reshape(64, 32) % 256).astype(np.uint8),
    "rgb": lambda: np.random.default_rng(0).integers(0, 256, (17, 9, 3)).astype(np.uint8),
    "float_clipped": lambda: np.random.default_rng(1).uniform(-50, 300, (5, 7)),
}


@pytest.mark.parametrize("case", sorted(IMAGES))
def test_write_png_bytes_equal_jax(tmp_path, case):
    img = IMAGES[case]()
    timage.write_png(str(tmp_path / "a.png"), img)
    jimage.write_png(str(tmp_path / "b.png"), img)
    data = (tmp_path / "a.png").read_bytes()
    assert data == (tmp_path / "b.png").read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and b"IHDR" in data and b"IEND" in data
    with pytest.raises(ValueError):
        timage.write_png(str(tmp_path / "c.png"), np.zeros((2, 2, 4), np.uint8))


@pytest.mark.parametrize("quantized", [False, True])
def test_probability_grid_to_image_equals_jax(quantized):
    """A room grid renders to the JAX image's pixels, also uint16-coded
    (decoded through ensure_f32_grid first)."""
    from hectorgrapher_tpu.mapping.grids import quantize_probability_grid as jq
    from hectorgrapher_tpu_torch import convert
    from hectorgrapher_tpu_torch.mapping.grids import quantize_probability_grid

    grid, _, _ = room_grid_and_cloud(size=128)
    ours = convert.probability_grid(grid, CPU)
    if quantized:
        grid, ours = jq(grid), quantize_probability_grid(ours)
        assert ours.log_odds.dtype == torch.uint16
    img = timage.probability_grid_to_image(ours)
    np.testing.assert_array_equal(img, jimage.probability_grid_to_image(grid))
    assert img.dtype == np.uint8 and (img != 128).any()
