"""The port's scan-matching-evaluation and trajectory-builder-evaluation
(hectorgrapher_tpu_torch/tools/cli.py) against the JAX package's CLI, with
tests/test_tools.py's case.

Both CLIs run in this process (the port's with --device cpu) on the same
seeds. Tolerance: every printed error within 1e-3 m, result counts equal;
the match and wall times differ.
"""

import re

from test_torch_cli_eval import _assert_reports_close, _reports


def test_scan_matching_evaluation(capsys):
    """Perturbed starts recovered by the correlative + Gauss-Newton
    matcher: the same mean and max translation errors (the match time
    differs)."""
    ours, theirs = _reports(capsys, ["scan-matching-evaluation", "--num_trials", "2", "--seed", "1"])
    cut = lambda text: text.split("mean match time")[0]
    _assert_reports_close(cut(ours), cut(theirs))
    assert "mean translation error" in ours


def test_trajectory_builder_evaluation(capsys):
    """The CT and the classic 3D builders over the synthetic 0.8 s drive:
    the same result counts, errors within 1e-3 m (the wall times differ)."""
    ours, theirs = _reports(capsys, ["trajectory-builder-evaluation", "--duration", "0.8"])
    cut = lambda text: re.sub(r"wall \S+ s", "", text)
    _assert_reports_close(cut(ours), cut(theirs))
    assert "continuous-time" in ours and "classic discrete-time" in ours
