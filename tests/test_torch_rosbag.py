"""The port's ROS bag reader and writer (hectorgrapher_tpu_torch/io/rosbag.py)
against the JAX package's, with the cases of tests/test_rosbag.py and
tests/test_drz_rehearsal.py.

Tolerance: bytes equal (every encoder and the writer), decoded arrays
equal (each package reads the other's bags to the same events, bit for
bit). The DRZ-shaped rehearsal bag then runs through the port's CLI on
the CPU at the rehearsal's overrides and at the default windows, to the
rehearsal's bound (ATE RMSE below 0.25 m).
"""

import bz2
import struct

import numpy as np
import pytest

from hectorgrapher_tpu.io import rosbag as jrb
from hectorgrapher_tpu.transform.np_quat import NpRigid3 as JRigid
from hectorgrapher_tpu_torch.io import rosbag as trb
from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3


def make_messages(rb, rigid):
    """tests/test_rosbag.py's fixture, encoded by `rb` (either package)."""
    rng = np.random.default_rng(0)
    clouds = [rng.uniform(-5, 5, (8 * 4, 3)).astype(np.float32) for _ in range(2)]
    msgs = [("/imu", "sensor_msgs/Imu", 0.05, rb.encode_imu(0.05, [0.1, 0.2, 9.8], [0.01, 0.02, 0.03])),
            ("/odom", "nav_msgs/Odometry", 0.08, rb.encode_odometry(0.08, rigid(np.array([1.0, 2.0, 0.5]))))]
    for k, pts in enumerate(clouds):
        msgs.append(("/points", "sensor_msgs/PointCloud2", 0.1 * (k + 1),
                     rb.encode_point_cloud2(0.1 * (k + 1), pts, width=8)))
    return msgs, clouds


def _rich_cloud(seed, n=1000):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-5, 5, (n, 3)).astype(np.float32), rng.uniform(-0.1, 0, n).astype(np.float32),
            (np.arange(n) % 16).astype(np.uint16), rng.uniform(0, 100, n).astype(np.float32))


ENCODER_CASES = {
    "pc2_xyz": lambda rb: rb.encode_point_cloud2(12.75, _rich_cloud(1, 24)[0], width=6),
    "pc2_unorganized": lambda rb: rb.encode_point_cloud2(3.0, _rich_cloud(2, 37)[0]),
    "pc2_rich_padded": lambda rb: rb.encode_point_cloud2(1.5, *_rich_cloud(3)[:1], width=64,
                                                         times=_rich_cloud(3)[1], rings=_rich_cloud(3)[2],
                                                         intensities=_rich_cloud(3)[3]),
    "pc2_times_only": lambda rb: rb.encode_point_cloud2(0.45, _rich_cloud(4, 64)[0], width=16,
                                                        times=_rich_cloud(4, 64)[1]),
    "imu": lambda rb: rb.encode_imu(3.25, [0.1, -0.2, 9.81], [0.5, 0.0, -0.1]),
    "odometry": lambda rb: rb.encode_odometry(
        7.5, NpRigid3(np.array([1.0, -2.0, 0.25]), np.array([0.9, 0.1, 0.2, 0.3]) / np.linalg.norm([0.9, 0.1, 0.2, 0.3]))),
}


@pytest.mark.parametrize("case", sorted(ENCODER_CASES))
def test_encoders_bytes_equal_jax(case):
    """Every message encoder writes the JAX package's bytes, and the port
    decodes them to the JAX decoder's values."""
    raw = ENCODER_CASES[case](trb)
    assert raw == ENCODER_CASES[case](jrb)
    if case.startswith("pc2"):
        ours, theirs = trb.decode_point_cloud2(raw), jrb.decode_point_cloud2(raw)
        assert ours[0] == theirs[0] and ours[2] == theirs[2]
        np.testing.assert_array_equal(ours[1], theirs[1])
        assert (ours[3] is None) == (theirs[3] is None)
        if ours[3] is not None:
            np.testing.assert_array_equal(ours[3], theirs[3])
            assert ours[3].dtype == theirs[3].dtype
    elif case == "imu":
        for a, b in zip(trb.decode_imu(raw), jrb.decode_imu(raw)):
            np.testing.assert_array_equal(a, b)
    else:
        (sa, pa), (sb, pb) = trb.decode_odometry(raw), jrb.decode_odometry(raw)
        assert sa == sb
        np.testing.assert_array_equal(pa.t, pb.t)
        np.testing.assert_array_equal(pa.q, pb.q)


def _events_equal(a, b):
    assert [(e.time, e.kind) for e in a] == [(e.time, e.kind) for e in b]
    for x, y in zip(a, b):
        if x.kind == "odometry":
            np.testing.assert_array_equal(x.payload.t, y.payload.t)
            np.testing.assert_array_equal(x.payload.q, y.payload.q)
        elif x.kind == "imu":
            for u, v in zip(x.payload, y.payload):
                np.testing.assert_array_equal(u, v)
        else:
            np.testing.assert_array_equal(x.payload, y.payload)
            assert (x.times is None) == (y.times is None)
            if x.times is not None:
                np.testing.assert_array_equal(x.times, y.times)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_bag_written_by_either_package_reads_the_same(tmp_path, writer):
    """write_bag's bytes equal the JAX writer's; each package reads the
    other's bag to the same messages and events (tests/test_rosbag.py
    test_write_read_round_trip)."""
    rb, rigid = (trb, NpRigid3) if writer == "port" else (jrb, JRigid)
    msgs, clouds = make_messages(rb, rigid)
    path, other = str(tmp_path / "mini.bag"), str(tmp_path / "other.bag")
    rb.write_bag(path, msgs)
    (jrb if writer == "port" else trb).write_bag(other, msgs)
    assert open(path, "rb").read() == open(other, "rb").read()
    ours, theirs = list(trb.read_bag(path)), list(jrb.read_bag(path))
    assert [(m.topic, m.msg_type, m.time, m.raw) for m in ours] == [(m.topic, m.msg_type, m.time, m.raw) for m in theirs]
    assert [m.topic for m in trb.read_bag(path, topics=["/points"])] == ["/points", "/points"]
    events = trb.read_bag_sequence(path)
    _events_equal(events, jrb.read_bag_sequence(path))
    assert [e.kind for e in events] == ["imu", "odometry", "range", "range"]
    np.testing.assert_array_equal(events[2].payload, clouds[0])


def test_bz2_chunked_bag(tmp_path):
    """Real recorders wrap records in bz2-compressed chunks
    (tests/test_rosbag.py test_bz2_chunked_bag); both readers agree."""
    msgs, clouds = make_messages(trb, NpRigid3)
    inner = bytearray()

    def rec(header, data):
        h = trb._emit_header(header)
        inner.extend(struct.pack("<I", len(h)) + h + struct.pack("<I", len(data)) + data)

    conn_by_topic = {}
    for topic, msg_type, stamp, raw in msgs:
        if topic not in conn_by_topic:
            conn_by_topic[topic] = len(conn_by_topic)
            rec({b"op": bytes([trb.OP_CONNECTION]), b"conn": struct.pack("<I", conn_by_topic[topic]),
                 b"topic": topic.encode()}, trb._emit_header({b"topic": topic.encode(), b"type": msg_type.encode()}))
        secs = int(stamp)
        rec({b"op": bytes([trb.OP_MESSAGE_DATA]), b"conn": struct.pack("<I", conn_by_topic[topic]),
             b"time": struct.pack("<II", secs, int(round((stamp - secs) * 1e9)))}, raw)
    compressed = bz2.compress(bytes(inner))
    chunk_header = trb._emit_header({b"op": bytes([trb.OP_CHUNK]), b"compression": b"bz2",
                                     b"size": struct.pack("<I", len(inner))})
    path = tmp_path / "chunked.bag"
    path.write_bytes(trb.MAGIC + struct.pack("<I", len(chunk_header)) + chunk_header
                     + struct.pack("<I", len(compressed)) + compressed)
    events = trb.read_bag_sequence(str(path))
    _events_equal(events, jrb.read_bag_sequence(str(path)))
    assert [e.kind for e in events] == ["imu", "odometry", "range", "range"]
    np.testing.assert_array_equal(events[3].payload, clouds[1])


def test_ouster_uint32_nanosecond_time_field():
    """An Ouster 't' field (uint32 nanoseconds) decodes to float seconds,
    as the JAX decoder gives them (tests/test_rosbag.py)."""
    n = 4
    pts = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    t_ns = np.array([0, 25_000_000, 50_000_000, 99_000_000], np.uint32)
    out = struct.pack("<III", 0, 7, 0) + struct.pack("<I", 0) + struct.pack("<II", 1, n)
    fields = [("x", 0, 7), ("y", 4, 7), ("z", 8, 7), ("t", 12, 6)]
    out += struct.pack("<I", len(fields))
    for name, off, dtc in fields:
        out += struct.pack("<I", len(name)) + name.encode() + struct.pack("<IBI", off, dtc, 1)
    out += b"\x00" + struct.pack("<II", 16, 16 * n)
    rows = np.zeros((n, 16), np.uint8)
    rows[:, 0:12] = pts.view(np.uint8).reshape(n, 12)
    rows[:, 12:16] = t_ns.view(np.uint8).reshape(n, 4)
    out += struct.pack("<I", rows.nbytes) + rows.tobytes() + b"\x01"
    _, decoded, _, times = trb.decode_point_cloud2(out)
    np.testing.assert_array_equal(decoded, pts)
    np.testing.assert_array_equal(times, jrb.decode_point_cloud2(out)[3])
    np.testing.assert_allclose(times, t_ns.astype(np.float64) * 1e-9, atol=1e-9)


def test_rejects_what_the_reference_rejects(tmp_path):
    """Not a bag, an unknown chunk compression and a big-endian cloud raise
    ValueError in both packages."""
    bad = tmp_path / "bad.bag"
    bad.write_bytes(b"not a bag")
    header = trb._emit_header({b"op": bytes([trb.OP_CHUNK]), b"compression": b"lz4"})
    lz4 = tmp_path / "lz4.bag"
    lz4.write_bytes(trb.MAGIC + struct.pack("<I", len(header)) + header + struct.pack("<I", 0))
    raw = bytearray(trb.encode_point_cloud2(1.0, np.zeros((4, 3), np.float32)))
    big_endian_at = len(raw) - 1 - 4 - 48 - 8 - 1  # is_bigendian, before point_step / row_step / data / is_dense
    raw[big_endian_at] = 1
    for rb in (trb, jrb):
        for path in (bad, lz4):
            with pytest.raises(ValueError):
                list(rb.read_bag(str(path)))
        with pytest.raises(ValueError):
            rb.decode_point_cloud2(bytes(raw))


def test_drz_rehearsal_bag_through_the_port_cli(tmp_path, capsys):
    """tests/test_drz_rehearsal.py's bag (2 s: 20 organized scans of 64 x 16
    rays with intensity, ring and time fields, 100 Hz IMU, 20 Hz odometry,
    mocap beside it): both packages decode it to the same events, bit for
    bit, the per-point times reach the range events, and the port's
    mapping-evaluation --use_3d at the rehearsal's overrides reaches its
    bound (ATE RMSE < 0.25 m) on the CPU. The JAX run of the same bag is
    slow-marked in its package, so only the decoded stream is compared.

    At the rehearsal's windows (K = C = 8) both packages keep one node
    (ROADMAP C33: the cloud cap drops each scan before it is
    marginalized), so the bound holds at 0.0000 m; the run is repeated at
    the default windows (K = C = 32), where the JAX CLI keeps 10 nodes at
    0.0243 m, and must keep several nodes within the same bound."""
    from test_drz_rehearsal import synthesize_drz_bag

    from hectorgrapher_tpu_torch.tools.cli import main as cli_main

    bag, mocap = str(tmp_path / "rehearsal.bag"), str(tmp_path / "rehearsal.mocap.csv")
    synthesize_drz_bag(bag, mocap)
    events = trb.read_bag_sequence(bag)
    _events_equal(events, jrb.read_bag_sequence(bag))
    ranges = [e for e in events if e.kind == "range"]
    assert ranges and float(np.ptp(ranges[0].times)) > 0.05

    overrides = [
        "trajectory_builder_3d.submaps.high_grid_size=64",
        "trajectory_builder_3d.submaps.low_grid_size=32",
        "trajectory_builder_3d.optimizing_local_trajectory_builder.initialization_duration=0.45",
        "trajectory_builder_3d.optimizing_local_trajectory_builder.max_control_points=8",
        "trajectory_builder_3d.optimizing_local_trajectory_builder.max_clouds_in_window=8",
        "trajectory_builder_3d.optimizing_local_trajectory_builder.points_per_cloud=128",
        "trajectory_builder_3d.optimizing_local_trajectory_builder.max_num_iterations=6",
        "pose_graph.optimize_every_n_nodes=8",
    ]
    argv = ["--device", "cpu", "mapping-evaluation", "--use_3d", "--sequence_dir", bag]
    for o in overrides:
        argv += ["--config_overrides", o]
    ct = "trajectory_builder_3d.optimizing_local_trajectory_builder."
    for windows in ([], ["--config_overrides", ct + "max_control_points=32",
                         "--config_overrides", ct + "max_clouds_in_window=32"]):
        rc = cli_main(argv + windows)
        out = capsys.readouterr().out
        assert rc == 0, out
        assert "ATE RMSE" in out, out
        assert float(out.split("ATE RMSE:")[1].split("m")[0]) < 0.25, out
        nodes = int(out.split("nodes:")[1].split()[0])
        assert nodes == 1 if not windows else nodes >= 8, out
