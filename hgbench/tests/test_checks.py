"""The comparisons that decide `correct`, driven through a whole run on
the CPU at a test's size: a sound run is correct; the control (the plain
reference one precision lower in the program's place) is not; nor is a
run whose timed path is broken underneath, once for each fault the cell
can have (a step that returns its state unchanged; an answer altered
where it is produced; a local pose returned that is not the one solved;
in the 2D rounds, a search that keeps its start). No chip is looked for:
the run is the harness's own, past its check for a card."""

import pytest

import tiny

CASES = [(cell, case) for cell in ("drz_ct3d.solo", "carto2d.laps")
         for case in ("sound", "control", "unchanged", "altered", "writeback")] + [("carto2d.laps", "start")]
SECONDS = {"drz_ct3d.solo": 3.0, "carto2d.laps": 6.0}


@pytest.mark.parametrize("cell,case", CASES)
def test_correct_only_when_sound(cell, case):
    fault = None if case in ("sound", "control") else case
    line, rows = tiny.run(cell, 20240 + len(case), SECONDS[cell], fault=fault, control=case == "control")
    assert line["attempted"] > 0 and line["failed"] == 0
    assert all(limit is not None for _, _, limit in rows)
    assert line["correct"] == (case == "sound"), rows
