"""BENCHMARK.json against the contract's shape, and every name it holds
found as a file of its own."""

import json
import re

import pytest

from hgbench.lib import names

SPEC = names.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_paths():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["hgbench"] and not SPEC["paths"][0].endswith("_torch")
    assert len(SPEC["command"]) <= 32 and all(_line(w) for w in SPEC["command"])
    assert SPEC["command"][1].startswith("hgbench/")
    assert len(json.dumps(SPEC)) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(ENTRY_KEYS))
def test_entries_names_and_units(section):
    seen = set()
    for e in SPEC[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert ENTRY_KEYS[section] <= set(e) <= ENTRY_KEYS[section] | extra, e
        assert NAME.match(e["name"]) and e["name"] not in seen
        seen.add(e["name"])
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer"):
            if key in e:
                assert _line(e[key]), (section, key)
        if section == "configs":
            assert _line(e["source"]) and e["source"].startswith("https://")
            assert all(NAME.match(k) for k in e["reduced"]) and len(e["reduced"]) <= 16
        if section == "workloads":
            assert NAME.match(e["config"]) and NAME.match(e["traffic"]) and e["chips"] in (1, 4)


def test_metric_sources_and_bounds():
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def _applies(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_each_cell_reports_what_its_metrics_move():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for w in SPEC["workloads"]:
        mine = [m["name"] for m in SPEC["end_to_end"] if _applies(m, w["name"])]
        assert "setup_s" in mine and len(mine) >= 2, w["name"]
        assert any(_applies(m, w["name"]) for m in SPEC["per_layer"]), w["name"]
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for cell in m.get("workloads", [w["name"] for w in SPEC["workloads"]]):
            assert _applies(e2e[m["moves"]], cell), (m["name"], cell)


def test_layers_name_one_layer_each():
    layers = {}
    for m in SPEC["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_every_config_keeps_a_cell_and_its_file():
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert c["name"] in used
        assert c["file"] == f"hgbench/configs/{c['name']}.json"
        data = names.load_json("configs", c["name"])
        assert data["name"] == c["name"] and data["source"] == c["source"] and data["reduced"] == c["reduced"]
    assert used <= {c["name"] for c in SPEC["configs"]}


def test_four_chip_cells_are_few():
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


def test_run_seconds_fit_the_check():
    rs = SPEC["run_seconds"]
    assert 1 <= rs <= 51 and (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_parts_are_found_by_name(cell):
    w = names.workload(SPEC, cell)
    config, mix = names.load_json("configs", w["config"]), names.load_json("traffic", w["traffic"])
    assert (names.HGBENCH / "drivers" / f"{mix['driver']}.py").exists()
    for c in config["checks"]:
        assert (names.HGBENCH / "checks" / f"{c}.py").exists()
    limits = names.load_json("limits", cell)
    assert limits and all(isinstance(v, (int, float)) for v in limits.values())
    for m in SPEC["per_layer"]:
        if _applies(m, cell):
            assert hasattr(names.load_module("metrics", m["name"]), "read")


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_frozen_options_match_the_programs_lua(config):
    """A cell runs its configuration's frozen "options"; this fails once
    the program's ported Lua files or option defaults stop giving the same
    values, so that the change shows here and not silently in the cell."""
    from hectorgrapher_tpu_torch.common import config as cfg

    from hgbench.lib.session import lua_options, resolve_options

    data = names.load_json("configs", config)
    assert cfg.to_dict(resolve_options(data)) == cfg.to_dict(lua_options(data))
