"""Everything a cell is made of is found by name, one file each:

  hgbench/configs/<config>.json     a configuration (options, sensors)
  hgbench/traffic/<mix>.json        a traffic mix (drive, room, loop, warm-up)
  hgbench/drivers/<driver>.py       a traffic driver, named by the mix
  hgbench/checks/<check>.py         a comparison with the plain reference,
                                    named by the configuration
  hgbench/limits/<cell>.json        the limits of a cell's compared numbers
  hgbench/metrics/<metric>.py       a per-layer metric's reader
  hgbench/roofline/<call>.py        a layer call's work count

so that a new cell, mix, driver, check, metric or work count is a new
file and never an edit of one that exists."""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

HGBENCH = Path(__file__).resolve().parent.parent
ROOT = HGBENCH.parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def _checked(name: str) -> str:
    if not NAME_RE.match(name):
        raise ValueError(f"not a name: {name!r}")
    return name


def load_json(kind: str, name: str) -> dict:
    path = HGBENCH / kind / f"{_checked(name)}.json"
    if not path.exists():
        raise FileNotFoundError(f"no {kind[:-1] if kind.endswith('s') else kind} named {name!r}: {path}")
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """The module hgbench/<kind>/<name>.py, imported once."""
    path = HGBENCH / kind / f"{_checked(name)}.py"
    key = f"hgbench_{kind}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}"
    if key in sys.modules:
        return sys.modules[key]
    if not path.exists():
        raise FileNotFoundError(f"no {kind} module named {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    spec.loader.exec_module(module)
    return module


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def workload(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
