"""The fleet cell (drz_ct3d_server.fleet8) through its whole run on the
CPU at a test's size: three robots in the load generator's child
process, the server on gRPC loopback in this one, batch_ct_windows on. A
sound run is correct; the control (the plain reference one precision
lower in the program's place) is not, nor is a run whose served path is
broken underneath, once for each fault of the fleet (half the lanes of
each batched solve handing back their start; a robot's result dropped;
two robots' results swapped). A --trace 1 run reads the cell's program
metrics. No chip is looked for: the run is the harness's own, past its
check for a card. The cell's entries in BENCHMARK.json are held by
test_spec.py with the other cells'."""

import math

import pytest

import tiny
from hgbench.lib import names
from hgbench.lib.session import Session, finish

CELL = "drz_ct3d_server.fleet8"
SEED = 2147483659
SECONDS = 6.0


def run_fleet(seed, seconds, trace=False, fault=None, control=False, samples=8):
    """One run of the fleet cell at a test's size, three robots: (line, rows)."""
    s = Session(CELL, seed, seconds, trace, "cpu", fault=fault,
                extra_options=tiny.DRZ_CT3D["extra_options"],
                extra_sensors=tiny.DRZ_CT3D["extra_sensors"],
                extra_mix={"stream_s": 30.0, "trace_scans": 2, "check": {"ct_window_samples": samples}})
    s.config["server"]["robots"] = 3
    names.load_module("drivers", s.mix["driver"]).run(s)
    return finish(s, control=control)


@pytest.mark.parametrize("case", ["sound", "control", "half", "drop", "swap"])
def test_correct_only_when_sound(case):
    fault = None if case in ("sound", "control") else case
    # The half fault breaks every other lane of the batched solves: a
    # larger sample is sure to hold one.
    line, rows = run_fleet(SEED + len(case), SECONDS, fault=fault, control=case == "control",
                           samples=12 if case == "half" else 8)
    assert line["attempted"] > 0 and line["failed"] == 0
    assert all(limit is not None for _, _, limit in rows)
    assert line["correct"] == (case == "sound"), rows
    wrong = {name for name, value, limit in rows if value > limit}
    if case in ("drop", "swap"):
        assert "fleet_results_lost" in wrong, rows
    if case == "half":
        assert wrong & {"ct_cost_rel", "ct_lm_excess"}, rows


def test_program_metrics_read_a_number():
    line, _ = run_fleet(SEED, SECONDS, trace=True)
    assert line["correct"]
    for name in ("fleet_scan_p95_ms", "ct_batch_windows_mean", "ct_batch_wait_ms", "ct_batched_solve_ms",
                 "server_queue_wait_ms"):
        value = line["metrics"][name]["value"]
        assert math.isfinite(value) and value > 0, (name, value)
    assert line["metrics"]["ct_batch_windows_mean"]["value"] >= 1.0

