"""One run of one cell: the configuration, mix and driver found by name,
the checks installed, the window driven, the result line composed."""

from __future__ import annotations

import contextlib
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

from hgbench.lib import names

FORBIDDEN = ("jax", "jaxlib", "flax", "hectorgrapher_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def lua_options(config: dict):
    """MapBuilderOptions from the configuration's Lua, evaluated against the
    program's ported configuration files, and its overrides: what the
    frozen "options" were made from (hgbench/tests/test_spec.py holds the
    two equal)."""
    import hectorgrapher_tpu_torch
    from hectorgrapher_tpu_torch.common import config as cfg
    from hectorgrapher_tpu_torch.common import lua_config

    files = Path(hectorgrapher_tpu_torch.__file__).resolve().parent / "configuration_files"
    globals_, returned = lua_config.run_lua(config["lua"], [str(files)])
    options = lua_config.map_builder_options_from_lua(globals_, returned).map_builder
    overrides = config.get("overrides", {})
    return cfg.replace_deep(options, overrides) if overrides else options


def resolve_options(config: dict, extra=None):
    """MapBuilderOptions from the configuration's frozen "options" (every
    value as the cell runs it, so that a change of the program's defaults
    does not change the cell), then `extra` (for runs at a size a test can
    hold)."""
    from hectorgrapher_tpu_torch.common import config as cfg

    options = cfg.from_dict(cfg.MapBuilderOptions, config["options"])
    return cfg.replace_deep(options, extra) if extra else options


def power_limit_w():
    """The card's power limit from nvidia-smi, None where it cannot say."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20).stdout.split()
        return float(out[0]) if out else None
    except (OSError, ValueError, subprocess.TimeoutExpired):
        return None


class Session:
    """The state of one run, shared by the driver, the checks and the
    metric readers."""

    def __init__(self, workload: str, seed: int, seconds: float, trace: bool, device, spec=None,
                 extra_options=None, extra_mix=None, extra_sensors=None, fault=None, t_start=None):
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.spec = spec if spec is not None else names.benchmark()
        self.workload = names.workload(self.spec, workload)
        self.config = names.load_json("configs", self.workload["config"])
        self.mix = names.load_json("traffic", self.workload["traffic"])
        self.mix.update(extra_mix or {})
        self.config["sensors"].update(extra_sensors or {})
        # A mix may sample more of the window's answers than its configuration does.
        self.config["check"] = dict(self.config.get("check", {}), **self.mix.get("check", {}))
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device = torch.device(device)
        self.fault = fault
        self.options = resolve_options(self.config, extra_options)
        self.checks = [names.load_module("checks", c).make(self) for c in self.config["checks"]]
        self.readings = {}
        self.e2e = {}
        self.attempted = self.completed = self.failed = 0
        self.setup_s = None
        self.memory_peak = 0
        self.tracer = None
        self.timing = False  # the window of a --trace 1 run: layer calls timed to the device's finish
        self.release = lambda: None  # set by the driver: stops the program, frees its state
        self._patched = []

    def patch(self, owner, attr, value):
        """Set owner.attr for this run; finish() puts the old one back."""
        self._patched.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    def unpatch(self):
        while self._patched:
            owner, attr, old = self._patched.pop()
            setattr(owner, attr, old)

    # -- driver callbacks ------------------------------------------------------

    def install(self, robot):
        for c in self.checks:
            c.install(robot)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup_done(self):
        """The window starts: set-up ends here and the checks start to sample."""
        self.sync()
        self.setup_s = time.perf_counter() - self.t_start
        self.timing = self.trace
        for c in self.checks:
            c.open()

    def window_done(self):
        self.timing = False
        for c in self.checks:
            c.close()

    @contextlib.contextmanager
    def timed(self, name: str):
        """In the window of a --trace 1 run, the host clock around the
        block, ending in a synchronize, into readings["layer_s"][name]. A
        --trace 0 run's window is left as it is."""
        if not self.timing:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.sync()
            self.readings.setdefault("layer_s", {}).setdefault(name, []).append(time.perf_counter() - t0)

    # -- after the run ---------------------------------------------------------

    def _metric_applies(self, m: dict) -> bool:
        return "workloads" not in m or self.workload["name"] in m["workloads"]

    def per_layer(self) -> dict:
        out = {}
        for m in self.spec["per_layer"]:
            if not self._metric_applies(m):
                continue
            value = names.load_module("metrics", m["name"]).read(self.readings)
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out

    def end_to_end(self) -> dict:
        out = {}
        for m in self.spec["end_to_end"]:
            if not self._metric_applies(m):
                continue
            value = self.setup_s if m["name"] == "setup_s" else self.e2e.get(m["name"])
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out

    def compare(self, control: bool = False):
        """[(name, value, limit)]: the failed scans against 0, then every
        check's numbers against the cell's limits (None where the cell has
        none yet)."""
        path = names.HGBENCH / "limits" / f"{self.workload['name']}.json"
        limits = json.loads(path.read_text()) if path.exists() else {}
        rows = [("failed_scans", self.failed, 0)]
        for c in self.checks:
            for name, value in c.numbers(control).items():
                rows.append((name, value, limits.get(name)))
        return rows


def finish(session: Session, control: bool = False):
    """After the driver: read the peak, free the program, compare, and
    compose the result line. Returns (line, rows)."""
    s = session
    if s.device.type == "cuda":
        s.memory_peak = int(torch.cuda.max_memory_allocated(s.device))
    s.release()
    s.unpatch()
    gc.collect()
    rows = s.compare(control)
    correct = s.attempted > 0 and all(limit is not None and math.isfinite(v) and v <= limit for _, v, limit in rows)
    device = {"platform": "gpu" if s.device.type == "cuda" else s.device.type,
              "kind": torch.cuda.get_device_name(s.device) if s.device.type == "cuda" else "cpu",
              "count": 1, "memory_peak_bytes": s.memory_peak}
    if s.device.type == "cuda":
        device["power_limit_w"] = power_limit_w()
    line = {"correct": bool(correct), "attempted": s.attempted, "failed": s.failed}
    if s.trace:
        line["metrics"] = s.per_layer()
        data = s.tracer.data if s.tracer is not None else None
        if data is not None:
            device["busy_s"] = data.busy_s()
            device["window_s"] = data.window_s
            line["breakdown"] = data.breakdown()
    else:
        line["metrics"] = s.end_to_end()
    line["device"] = device
    line["compared"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    return line, rows
