"""On a machine with a card: one short run of every cell through the
benchmark's command, its last line correct. Skips without a card."""

import json
import subprocess
import sys

import pytest

from hgbench.lib import names


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the cells run on the card only")


@pytest.mark.chip
@pytest.mark.parametrize("cell", [w["name"] for w in names.benchmark()["workloads"]])
def test_cell_runs_correct_on_the_card(card, cell):
    out = subprocess.run([sys.executable, "hgbench/run.py", "--workload", cell, "--seed", "2147483659",
                          "--seconds", "5", "--trace", "0"], capture_output=True, text=True, timeout=1200,
                         cwd=names.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
