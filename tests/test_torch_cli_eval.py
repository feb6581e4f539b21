"""The port's mapping-evaluation (hectorgrapher_tpu_torch/tools/cli.py)
against the JAX package's CLI, with the cases of tests/test_tools.py,
tests/test_sequence_evaluation.py and tests/test_rosbag.py
(tests/test_torch_cli_builders.py holds the two other evaluation
subcommands).

Both CLIs run in this process (the port's with --device cpu) on the same
seeds and files. Tolerance: ATE and every printed error within 1e-3 m
(1e-3 deg for rotations), node, submap and constraint counts equal.
"""

import re

import numpy as np
import pytest

from hectorgrapher_tpu.evaluation.scan_generator import raycast_rect_room_2d
from hectorgrapher_tpu.io import rosbag as jrb
from hectorgrapher_tpu.io.readers import write_ply
from hectorgrapher_tpu.tools import cli as jcli
from hectorgrapher_tpu.transform.np_quat import NpRigid3
from hectorgrapher_tpu_torch.tools import cli as tcli

NUMBER = re.compile(r"-?\d+\.\d+")


def _reports(capsys, argv):
    assert tcli.main(["--device", "cpu", *argv]) == 0
    ours = capsys.readouterr().out
    assert jcli.main(list(argv)) == 0
    return ours, capsys.readouterr().out


def _assert_reports_close(ours, theirs, atol=1e-3):
    """The same report, every decimal number within atol (counts equal)."""
    assert NUMBER.sub("#", ours) == NUMBER.sub("#", theirs), (ours, theirs)
    np.testing.assert_allclose([float(x) for x in NUMBER.findall(ours)],
                               [float(x) for x in NUMBER.findall(theirs)], rtol=0, atol=atol)


@pytest.fixture(scope="module")
def sequence_dir(tmp_path_factory):
    """tests/test_sequence_evaluation.py's 8-scan recorded 2D sequence:
    PLY scans named by their times, odometry and mocap CSVs."""
    path = tmp_path_factory.mktemp("seq")
    rng = np.random.default_rng(7)
    odom_rows, mocap_rows = [], []
    for i in range(8):
        t, x = 0.1 * i, 0.08 * i
        pts = raycast_rect_room_2d(np.array([x, 0.0]), 0.0, num_rays=720)
        write_ply(str(path / f"scan_{t:0.3f}.ply"), pts[~np.isnan(pts[:, 0])].astype(np.float32))
        noisy = np.array([x, 0, 0]) + rng.normal(0, 0.002, 3)
        odom_rows.append([t - 0.001, noisy[0], noisy[1], noisy[2], 1, 0, 0, 0])
        mocap_rows.append([t, x, 0, 0, 1, 0, 0, 0])
    np.savetxt(path / "odometry.csv", odom_rows, delimiter=",")
    np.savetxt(path / "mocap.csv", mocap_rows, delimiter=",")
    return str(path)


def test_mapping_evaluation_over_a_sequence_dir(capsys, sequence_dir):
    """The file-driven 2D evaluation: ATE within 1e-3 m of the JAX CLI's,
    under tests/test_sequence_evaluation.py's bound."""
    argv = ["mapping-evaluation", "--sequence_dir", sequence_dir,
            "--config_overrides", "trajectory_builder_2d.submaps.num_range_data=4",
            "--config_overrides", "trajectory_builder_2d.motion_filter.max_distance_meters=0.05",
            "--config_overrides", "trajectory_builder_2d.motion_filter.max_time_seconds=0.1",
            "--config_overrides", "pose_graph.optimize_every_n_nodes=0"]
    ours, theirs = _reports(capsys, argv)
    _assert_reports_close(ours, theirs)
    assert float(ours.split("ATE RMSE:")[1].split("m")[0]) < 0.1


def test_mapping_evaluation_over_a_2d_bag(capsys, tmp_path):
    """tests/test_rosbag.py's 2D bag (no ground truth beside it): the same
    trajectory report from both CLIs."""
    msgs = []
    for k in range(10):
        t, x = 0.1 * (k + 1), 0.05 * k
        msgs.append(("/odom", "nav_msgs/Odometry", t, jrb.encode_odometry(t, NpRigid3(np.array([x, 0.0, 0.0])))))
        pts = raycast_rect_room_2d(np.array([x, 0.0]), 0.0, num_rays=360)
        msgs.append(("/points", "sensor_msgs/PointCloud2", t,
                     jrb.encode_point_cloud2(t, pts[~np.isnan(pts[:, 0])].astype(np.float32))))
    path = str(tmp_path / "drive2d.bag")
    jrb.write_bag(path, msgs)
    ours, theirs = _reports(capsys, ["mapping-evaluation", "--sequence_dir", path])
    assert ours == theirs and "no mocap.csv ground truth" in ours


def test_mapping_evaluation_synthetic_2d(capsys):
    """tests/test_tools.py's short synthetic 2D run."""
    ours, theirs = _reports(capsys, ["mapping-evaluation", "--duration", "1.2", "--noise", "0"])
    _assert_reports_close(ours, theirs)
    assert "ATE RMSE" in ours
