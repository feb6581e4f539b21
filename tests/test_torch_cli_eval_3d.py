"""The port's synthetic 3D mapping-evaluation (hectorgrapher_tpu_torch/
tools/cli.py, the CT front end at the CLI's 96^3 / 48^3 TSDF options)
against the JAX package's CLI over the same 2 s drive.

Both CLIs run in this process (the port's with --device cpu) on the same
seed. Tolerance: the same report, ATE and every printed error within
1e-3 m (1e-3 deg for rotations), node, submap and constraint counts equal.
"""

from test_torch_cli_eval import _assert_reports_close, _reports


def test_mapping_evaluation_synthetic_3d(capsys):
    ours, theirs = _reports(capsys, ["mapping-evaluation", "--use_3d", "--duration", "2.0"])
    _assert_reports_close(ours, theirs)
    assert int(ours.split("nodes:")[1].split()[0]) >= 3 and "ATE RMSE" in ours
