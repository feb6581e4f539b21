"""The per-layer metrics read from the program's own sections
(hg_section_seconds over the window): each reads a number in a --trace 1
run of each of its cells, at a test's size on the CPU."""

import math

import pytest

import tiny
from hgbench.lib import names

SPEC = names.benchmark()
PROGRAM = {m["name"]: m["workloads"] for m in SPEC["per_layer"]
           if m["name"] in ("ct_window_build_ms", "scan_match_2d_ms", "pg_worker_busy_pct", "pg_queue_wait_ms")}
SECONDS = {"drz_ct3d.solo": 3.0, "carto2d.laps": 6.0}


@pytest.mark.parametrize("cell", sorted(SECONDS))
def test_program_metrics_read_a_number(cell):
    line, _ = tiny.run(cell, 2147483659, SECONDS[cell], trace=True)
    wanted = sorted(name for name, cells in PROGRAM.items() if cell in cells)
    assert wanted and line["correct"]
    for name in wanted:
        value = line["metrics"][name]["value"]
        assert math.isfinite(value) and value >= 0, (name, value)
    if "pg_worker_busy_pct" in wanted:
        assert line["metrics"]["pg_worker_busy_pct"]["value"] <= 100.0 * 1.05
