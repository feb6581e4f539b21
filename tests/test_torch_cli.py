"""The port's command-line tools (hectorgrapher_tpu_torch/tools/cli.py)
against the JAX package's CLI: the state tools, the configuration dump,
the ground-truth and relations tools, paint-map and map-builder-server
(tests/test_torch_cli_eval.py holds the three evaluation subcommands).

Both CLIs run in this process on the same files (the port's with
--device cpu). Tolerance: printed reports and written files equal, paths
aside; a painted map within one level on at most a thousandth of its
pixels (the packages' exp may part by an ulp). map-builder-server runs as
a child process on the CPU: it serves a GetSubmap above gRPC's 4 MB
default (ROADMAP C24) and exits 0 on SIGINT; the reference's server
cannot start (ROADMAP C32), the port's starts with and without its
multihost flags.
"""

import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from hectorgrapher_tpu.tools import cli as jcli
from hectorgrapher_tpu_torch.tools import cli as tcli

REPO = Path(__file__).resolve().parent.parent
SUBCOMMANDS = ["state-info", "state-migrate", "state-convert", "print-configuration", "autogenerate-ground-truth",
               "ground-truth-from-mocap", "compute-relations-metrics", "scan-matching-evaluation",
               "mapping-evaluation", "trajectory-builder-evaluation", "paint-map", "map-builder-server"]


def _run(capsys, argv, port=True):
    rc = tcli.main(["--device", "cpu", *argv]) if port else jcli.main(list(argv))
    return rc, capsys.readouterr().out


def _both(capsys, argv, tmp_path, outputs=()):
    """Run the port's and the JAX CLI on argv; `outputs` (file names in
    argv) are written under tmp_path/port and tmp_path/jax. Returns the two
    reports with those directories written as <out>."""
    reports = []
    for side, port in (("port", True), ("jax", False)):
        d = tmp_path / side
        d.mkdir(exist_ok=True)
        args = [str(d / a) if a in outputs else a for a in argv]
        rc, out = _run(capsys, args, port)
        assert rc == 0, out
        reports.append(out.replace(str(d), "<out>"))
    return reports


@pytest.fixture(scope="module")
def states(tmp_path_factory):
    """State files written by the JAX package: a 2D MapBuilder drive of 20
    scans (tests/test_serialization.py drive_line: a finished submap and
    INTER constraints), a 3D occupancy and a 3D TSDF
    graph (tests/test_torch_serialization.py), their pbstreams, and a
    mocap CSV of the 2D drive."""
    from test_serialization import drive_line, make_options
    from test_torch_serialization import _jax_graph

    from hectorgrapher_tpu.io.pbstream_state import write_pbstream_state
    from hectorgrapher_tpu.io.serialization import save_state
    from hectorgrapher_tpu.mapping.map_builder import MapBuilder

    d = tmp_path_factory.mktemp("states")
    mb = MapBuilder(make_options())
    mb.add_trajectory_builder()
    drive_line(mb, n=20)
    mb.pose_graph.run_final_optimization()
    graphs = {"2d": mb.pose_graph, "3d": _jax_graph("3d", "probability", "float32"),
              "3d_tsdf": _jax_graph("3d", "tsdf", "float32")}
    out = {}
    for name, pg in graphs.items():
        out[name] = str(d / f"{name}.npz")
        save_state(pg, out[name])
        out[name + "_pbstream"] = str(d / f"{name}.pbstream")
        write_pbstream_state(pg, out[name + "_pbstream"])
    rows = [[0.1 * i, 0.08 * i, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0] for i in range(20)]
    out["mocap"] = str(d / "mocap.csv")
    np.savetxt(out["mocap"], rows, delimiter=",")
    return out


def test_help_lists_the_jax_subcommands(capsys):
    for module in (tcli, jcli):
        with pytest.raises(SystemExit):
            module.main(["--help"])
        text = capsys.readouterr().out
        assert all(name in text for name in SUBCOMMANDS)
    assert sorted(tcli.build_parser()._subparsers._group_actions[0].choices) == sorted(SUBCOMMANDS)


@pytest.mark.parametrize("state", ["2d", "3d", "3d_tsdf", "2d_pbstream", "3d_pbstream"])
def test_state_info_matches_jax(capsys, tmp_path, states, state):
    ours, theirs = _both(capsys, ["state-info", states[state]], tmp_path)
    assert ours == theirs
    assert ("nodes" in ours) and ("trajectories: [0]" in ours or "pose graph" in ours)


def test_state_migrate_matches_jax(capsys, tmp_path, states):
    """A version-1 3D state (its submap histograms dropped): the migrated
    files are equal, array for array."""
    import json

    v1 = str(tmp_path / "v1.npz")
    with np.load(states["3d"]) as data:
        arrays = {k: data[k] for k in data.files if not k.endswith("_histogram") or k.startswith("node")}
        index = json.loads(bytes(data["__index__"]).decode())
    index["version"] = 1
    arrays["__index__"] = np.frombuffer(json.dumps(index).encode(), np.uint8)
    np.savez_compressed(v1, **arrays)
    ours, theirs = _both(capsys, ["state-migrate", v1, "v2.npz"], tmp_path, outputs=("v2.npz",))
    assert ours == theirs and "2 submap histograms recomputed" in ours
    with np.load(tmp_path / "port" / "v2.npz") as a, np.load(tmp_path / "jax" / "v2.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("state", ["2d", "3d", "3d_tsdf"])
def test_state_convert_matches_jax(capsys, tmp_path, states, state):
    """npz -> pbstream: the JAX CLI's records byte for byte; pbstream ->
    npz (the dimension from sniff_dim): the JAX CLI's arrays."""
    from hectorgrapher_tpu.io import pbstream as jpbstream
    from hectorgrapher_tpu.io.pbstream_state import sniff_dim as jsniff
    from hectorgrapher_tpu_torch.io import pbstream
    from hectorgrapher_tpu_torch.io.pbstream_state import sniff_dim

    ours, theirs = _both(capsys, ["state-convert", states[state], "s.pbstream"], tmp_path, outputs=("s.pbstream",))
    assert ours == theirs
    port_pbs, jax_pbs = str(tmp_path / "port" / "s.pbstream"), str(tmp_path / "jax" / "s.pbstream")
    assert list(pbstream.read_records(port_pbs)) == list(jpbstream.read_records(jax_pbs))
    assert sniff_dim(port_pbs) == jsniff(port_pbs) == (2 if state == "2d" else 3)
    ours, theirs = _both(capsys, ["state-convert", states[state + "_pbstream"], "back.npz"], tmp_path,
                         outputs=("back.npz",))
    assert ours == theirs
    with np.load(tmp_path / "port" / "back.npz") as a, np.load(tmp_path / "jax" / "back.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_sniff_dim_of_a_stream_without_submaps(tmp_path):
    """A stream of a header and a pose graph alone reads as 2D in both."""
    from hectorgrapher_tpu.io.pbstream_state import sniff_dim as jsniff
    from hectorgrapher_tpu_torch.io import pbstream
    from hectorgrapher_tpu_torch.io import protowire as pw
    from hectorgrapher_tpu_torch.io.pbstream_state import sniff_dim

    path = str(tmp_path / "empty.pbstream")
    pbstream.write_records(path, [pw.emit_int(1, 2), pw.emit_message(1, pbstream.encode_pose_graph(pbstream.PbState()))])
    assert sniff_dim(path) == jsniff(path) == 2


PRINT_CONFIGURATIONS = {
    "defaults": [],
    "override": ["--override", "pose_graph.optimize_every_n_nodes=42",
                 "--override", 'trajectory_builder_3d.submaps.grid_type="TSDF"'],
    "subdictionary": ["--subdictionary", "trajectory_builder_2d.submaps"],
    "lua": ["--configuration_basename", "map_builder_server.lua", "--subdictionary", "pose_graph.constraint_builder"],
}


@pytest.mark.parametrize("case", sorted(PRINT_CONFIGURATIONS))
def test_print_configuration_matches_jax(capsys, tmp_path, case):
    import json

    argv = ["print-configuration", *PRINT_CONFIGURATIONS[case]]
    if case == "lua":
        reports = []
        for package, port in (("hectorgrapher_tpu_torch", True), ("hectorgrapher_tpu", False)):
            dirs = str(REPO / package / "configuration_files")
            rc, out = _run(capsys, argv + ["--configuration_directories", dirs], port)
            assert rc == 0
            reports.append(out)
        ours, theirs = reports
    else:
        ours, theirs = _both(capsys, argv, tmp_path)
    assert json.loads(ours) == json.loads(theirs)
    if case == "override":
        assert json.loads(ours)["pose_graph"]["optimize_every_n_nodes"] == 42


@pytest.mark.parametrize("fmt", ["text", "proto"])
@pytest.mark.parametrize("state", ["2d", "2d_pbstream"])
def test_autogenerate_ground_truth_matches_jax(capsys, tmp_path, states, fmt, state):
    """Relations from the same state file, loaded into each package's pose
    graph (or decoded from the pbstream), write the same file."""
    out = "rel.pb" if fmt == "proto" else "rel.txt"
    ours, theirs = _both(capsys, ["autogenerate-ground-truth", states[state], out, "--min_covered_distance", "0.2",
                                  "--outlier_threshold_meters", "0.5", "--outlier_threshold_radians", "0.2"],
                         tmp_path, outputs=(out,))
    assert ours == theirs
    assert (tmp_path / "port" / out).read_bytes() == (tmp_path / "jax" / out).read_bytes()
    assert int(ours.split()[1]) > 0


@pytest.mark.parametrize("fmt", ["text", "proto"])
def test_ground_truth_from_mocap_matches_jax(capsys, tmp_path, states, fmt):
    out = "gt.txt"
    ours, theirs = _both(capsys, ["ground-truth-from-mocap", states["mocap"], out, "--pose_time_delta", "0.2",
                                  "--format", fmt], tmp_path, outputs=(out,))
    assert ours == theirs and f"({fmt})" in ours
    assert (tmp_path / "port" / out).read_bytes() == (tmp_path / "jax" / out).read_bytes()


@pytest.mark.parametrize("state", ["2d", "2d_pbstream"])
@pytest.mark.parametrize("fmt", ["text", "proto"])
def test_compute_relations_metrics_matches_jax(capsys, tmp_path, states, state, fmt):
    """tests/test_sequence_evaluation.py's chain: mocap relations (text or
    the reference's proto), then the metrics of a state against them."""
    rel = str(tmp_path / ("gt.pb" if fmt == "proto" else "gt.txt"))
    assert jcli.main(["ground-truth-from-mocap", states["mocap"], rel, "--pose_time_delta", "0.2"]) == 0
    capsys.readouterr()
    ours, theirs = _both(capsys, ["compute-relations-metrics", states[state], rel], tmp_path)
    assert ours == theirs and "Abs translational error" in ours


@pytest.mark.parametrize("state", ["2d", "3d", "3d_tsdf"])
def test_paint_map_matches_jax(capsys, tmp_path, states, state):
    """paint-map of one state file in each package: the same image size
    and report, pixels within one level on at most a thousandth of them."""
    import chip_smoke

    args = ["paint-map", states[state], "map.png", "--resolution", "0.05"]
    for extra in ([], ["--finished_only"]):
        ours, theirs = _both(capsys, args + extra, tmp_path, outputs=("map.png",))
        assert ours == theirs
        a, b = (chip_smoke.read_png(str(tmp_path / side / "map.png")) for side in ("port", "jax"))
        assert a.shape == b.shape and a.shape[0] >= 20
        diff = np.abs(a.astype(np.int16) - b.astype(np.int16)).max(axis=-1)
        assert diff.max() <= 1 and int((diff > 0).sum()) <= a.shape[0] * a.shape[1] // 1000


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Server:
    """The port's map-builder-server as a child process on the CPU; its
    output lines collected as they come."""

    def __init__(self, *args, timeout=120.0):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "hectorgrapher_tpu_torch.tools.cli", "--device", "cpu", "map-builder-server",
             "--monitoring_port", "-1", "--address", "127.0.0.1:0", *args],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.lines = []
        threading.Thread(target=lambda: self.lines.extend(iter(self.proc.stdout.readline, "")), daemon=True).start()
        t0, self.port = time.monotonic(), None
        while self.port is None and time.monotonic() - t0 < timeout and self.proc.poll() is None:
            found = [re.search(r"listening on port (\d+)", line) for line in list(self.lines)]
            self.port = next((int(m.group(1)) for m in found if m), None)
            time.sleep(0.05)

    def stop(self):
        """SIGINT, then the exit code (None if it did not exit in 30 s)."""
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGINT)
        try:
            return self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
            return None


def test_map_builder_server_serves_a_submap_above_grpc_default(tmp_path):
    """The CLI's server on the CPU, a 2D submap of 1280^2 cells (its
    GetSubmap payload 4.9 MB): three scans in through the port's client,
    local SLAM results back, GetSubmap(0) above 4 MB with known cells, exit
    code 0 on SIGINT."""
    from hectorgrapher_tpu_torch.cloud.client import MapBuilderStub
    from hectorgrapher_tpu_torch.evaluation.scan_generator import raycast_rect_room_2d
    from hectorgrapher_tpu_torch.sensor.types import TimedPointCloudData, pad_timed_cloud
    from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3

    server = _Server("--config_overrides", "trajectory_builder_2d.submaps.grid_size=1280",
                     "--config_overrides", "trajectory_builder_2d.use_imu_data=false")
    try:
        assert server.port is not None, "".join(server.lines)
        stub = MapBuilderStub(f"127.0.0.1:{server.port}")
        tb = stub.get_trajectory_builder(stub.add_trajectory_builder())
        for i in range(3):
            t = 0.1 * i
            pts = raycast_rect_room_2d(np.array([0.05 * i, 0.0]), 0.0, num_rays=720)
            pts = pts[~np.isnan(pts[:, 0])].astype(np.float32)
            tb.add_odometry_data(t, NpRigid3(np.array([0.05 * i, 0.0, 0.0])))
            tb.add_range_data(TimedPointCloudData(t, np.zeros(3, np.float32),
                                                  pad_timed_cloud(pts, np.zeros(len(pts), np.float32), 1024)))
        stub.pose_graph.run_final_optimization()
        results = stub.get_local_slam_results(0)
        sub = stub.get_submap(0)
        stub.close()
        assert len(results) >= 1
        assert sub["grid"]["shape"] == (1280, 1280)
        assert sub["grid"]["log_odds"].nbytes + sub["grid"]["known"].nbytes > 4 * 1024 * 1024
        assert sub["grid"]["known"].any()
    finally:
        rc = server.stop()
    assert rc == 0, "".join(server.lines)


def test_jax_map_builder_server_lacks_its_multihost_flags(capsys):
    """ROADMAP C32: the JAX subcommand reads five flags its parser never
    defines, so it stops before serving."""
    with pytest.raises(AttributeError, match="multihost_coordinator"):
        jcli.main(["map-builder-server", "--monitoring_port", "-1"])


def test_port_map_builder_server_parses_its_multihost_flags():
    """C32 fixed, not mirrored: the five flags parse, and their defaults
    leave multihost off."""
    defaults = tcli.build_parser().parse_args(["map-builder-server"])
    assert (defaults.multihost_coordinator, defaults.multihost_num_processes, defaults.multihost_process_id,
            defaults.follower_addresses) == ("", 1, 0, "")
    args = tcli.build_parser().parse_args([
        "map-builder-server", "--multihost_coordinator", "127.0.0.1:1234", "--multihost_num_processes", "2",
        "--multihost_process_id", "1", "--solver_plane_address", "127.0.0.1:5678",
        "--follower_addresses", "127.0.0.1:1,127.0.0.1:2", "--ct_mesh_devices", "2", "--batch_ct_windows"])
    assert (args.multihost_coordinator, args.multihost_num_processes, args.multihost_process_id,
            args.solver_plane_address, args.follower_addresses) == (
        "127.0.0.1:1234", 2, 1, "127.0.0.1:5678", "127.0.0.1:1,127.0.0.1:2")


def test_port_map_builder_server_starts_as_one_multihost_process():
    """--multihost_num_processes 1 on gloo (the CPU), with a CT mesh of 2
    shards: the group forms, the mesh is reported, the server listens and
    exits 0 on SIGINT."""
    server = _Server("--use_3d", "--batch_ct_windows", "--ct_mesh_devices", "2",
                     "--multihost_coordinator", f"127.0.0.1:{_free_port()}", "--multihost_num_processes", "1",
                     "--multihost_process_id", "0")
    try:
        assert server.port is not None, "".join(server.lines)
    finally:
        rc = server.stop()
    text = "".join(server.lines)
    assert rc == 0, text
    assert "multihost mesh: 1 devices across 1 processes" in text and "ct mesh: 2 devices" in text


def test_cli_without_a_card_fails_instead_of_falling_back():
    """With no card and no --device cpu the CLI stops at the kernels'
    build (ops/_build.py): it never falls back to the CPU."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, "-m", "hectorgrapher_tpu_torch.tools.cli", "mapping-evaluation",
                           "--duration", "0.3"], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "need a CUDA card" in proc.stderr and "ATE RMSE" not in proc.stdout
