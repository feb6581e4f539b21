#!/usr/bin/env python3
"""K3 and K4 against an earlier version of themselves, on one CUDA card.

    python3 kernel_ab.py PARENT_DIR

PARENT_DIR holds a checkout of an earlier commit, for example made with
`git archive <commit> hectorgrapher_tpu_torch | tar -x -C PARENT_DIR`. Its
kernels (csrc/*.cu) are built into a second library (same nvcc flags), and
its ops/ct_scan_block.py and ops/fast_scores_3d.py wrappers are loaded
against that library. At every main-path shape of the two kernels (K3: the CT
front end's C=32 and GN3D's C=1 at 256^3 / 128^3; K4: chip_smoke.py phase
10's coarse call, first expansion and level-0 expansion) both versions run
on the same inputs, in turns: earlier, this, this, earlier. Each turn
prints per-call time (CUDA events around the call), the kernel's device
time (torch.profiler) and the wrapper's host time per call (enqueue only);
then the outputs' largest difference and the bound (chip_smoke.bound_ms).
Writes everything to chiprun_out/kernel_ab.json.

Imports torch, numpy and hectorgrapher_tpu_torch only; needs one card.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

import chip_smoke as cs
from hectorgrapher_tpu_torch.ops import _build
from hectorgrapher_tpu_torch.ops import ct_scan_block as k3
from hectorgrapher_tpu_torch.ops import fast_scores_3d as k4


def build_parent(parent: Path):
    """The earlier checkout's kernels built into a second library (same
    entry points and nvcc flags), and a stand-in for ops._build that
    serves it to the earlier wrappers."""
    target = parent / "_build_ab" / "libhg_kernels_earlier.so"
    _build.build(sorted((parent / "hectorgrapher_tpu_torch" / "csrc").glob("*.cu")), target)
    lib = _build.bind(target)
    return SimpleNamespace(load_library=lambda: lib, check_launch=_build.check_launch)


def load_parent_wrapper(parent: Path, name: str, build):
    """The earlier ops/<name>.py, its kernel calls served by `build`."""
    spec = importlib.util.spec_from_file_location(f"earlier_{name}",
                                                  parent / "hectorgrapher_tpu_torch" / "ops" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod._build = build
    return getattr(mod, name)


def host_us(fn, n=200):
    """Host microseconds per call of fn(), enqueue only (no synchronize
    inside the window)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def turns(name, label, old, new, args):
    """earlier, this, this, earlier: per-call, device and host time of each
    turn; then the bound."""
    kernel = f"{name}_kernel"
    out = {"turns": []}
    for which, fn in (("earlier", old), ("this", new), ("this", new), ("earlier", old)):
        rec = {"version": which, "ms": cs.cuda_ms(fn, reps=50), "device_ms": cs.device_ms(fn, reps=50, match=kernel),
               "host_us": host_us(fn)}
        out["turns"].append(rec)
        print(f"{name} {label} {which}: per call {rec['ms']:.4f} ms, device {cs._fmt(rec['device_ms'])}, host "
              f"{rec['host_us']:.1f} us", flush=True)
    b_ms, b_by, nbytes, ops = cs.bound_ms(name, args)
    out.update(bound_ms=b_ms, bound_by=b_by, bytes=nbytes, ops=ops)
    for which in ("earlier", "this"):
        dev = [t["device_ms"] for t in out["turns"] if t["version"] == which]
        out[f"{which}_device_ms"] = sum(dev) / len(dev)
        print(f"{name} {label} {which}: mean device {out[f'{which}_device_ms']:.4f} ms, bound {b_ms * 1e3:.3f} us "
              f"by {b_by}: {100 * b_ms / out[f'{which}_device_ms']:.2f}% of bound", flush=True)
    return out


def host_parts(device, args):
    """Host microseconds of the pieces a wrapper may spend per call."""
    hi, lo, pts = args[0], args[1], args[2]

    def device_context():
        with torch.cuda.device(device):
            pass

    parts = {
        "torch.cuda.current_stream(device).cuda_stream": lambda: torch.cuda.current_stream(device).cuda_stream,
        "torch.cuda.current_device()": torch.cuda.current_device,
        "with torch.cuda.device(device)": device_context,
        "grid_params(hi, lo)": lambda: k3.grid_params(hi, lo),
        "torch.empty((32, 18, 18))": lambda: torch.empty((32, 18, 18), device=device),
        "one argument check": lambda: k3._check("hi_points", pts, torch.float32, tuple(pts.shape), device),
    }
    out = {}
    for label, fn in parts.items():
        out[label] = host_us(fn, n=2000)
        print(f"host part {label}: {out[label]:.2f} us", flush=True)
    return out


def main() -> int:
    if len(sys.argv) != 2:
        sys.exit(__doc__.split("\n\n")[1])
    if not torch.cuda.is_available():
        sys.exit("kernel_ab: FAIL: torch.cuda.is_available() is false: this script needs a CUDA card")
    parent = Path(sys.argv[1]).resolve()
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load_library()
    print(" | ".join(l.strip() for l in _build.build_log.splitlines() if "registers" in l or "Compiling entry" in l),
          flush=True)
    scratch = torch.zeros(1, device=device)
    floor_ms = cs.device_ms(lambda: scratch.fill_(1.0), reps=50)
    print(f"smallest kernel (a one-element fill): device {floor_ms:.4f} ms", flush=True)
    build = build_parent(parent)
    old_k3 = load_parent_wrapper(parent, "ct_scan_block", build)
    old_k4 = load_parent_wrapper(parent, "fast_scores_3d", build)
    result = {"card": card, "fill_device_ms": floor_ms, "k3": {}, "k4": {}}

    hi, lo, scan_pts = cs.ct_production_grids(device)
    for label, c in (("front_end", 32), ("gn3d", 1)):
        args = cs.ct_kernel_inputs(device, hi, lo, scan_pts, c=c)
        new = lambda a=args: k3.ct_scan_block(*a[:10], gparams=a[10])
        old = lambda a=args: old_k3(*a[:10])
        got, want = new(), old()
        torch.cuda.synchronize()
        bound = 1e-4 * max(1.0, float(want[0].abs().max()))
        diff = max(float((x - y).abs().max()) for x, y in zip(got, want))
        print(f"ct_scan_block {label}: this vs earlier max |d| {diff:.3e} (gate {bound:.3e})", flush=True)
        if not diff <= bound:
            sys.exit(f"kernel_ab: FAIL: ct_scan_block {label} differs from the earlier kernel by {diff:.3e}")
        result["k3"][label] = {"max_abs_diff": diff, **turns("ct_scan_block", label, old, new, args)}
        if label == "front_end":
            result["host_parts"] = host_parts(device, args)
    del hi, lo

    _, match = cs.fast_match_setup(device, *cs.fast_match_submap(device))
    calls, _ = cs.recorded_score_sums(match)
    for label, (a, _) in cs.fast_score_shapes(calls).items():
        new = lambda a=a: k4.fast_scores_3d(*a)
        old = lambda a=a: old_k4(*a)
        same = bool(torch.equal(new(), old()))
        print(f"fast_scores_3d {label} level {a[9]} C={a[5].shape[0]} outputs {new().shape}: bit-equal to the "
              f"earlier kernel: {same}", flush=True)
        if not same:
            sys.exit(f"kernel_ab: FAIL: fast_scores_3d {label} is not bit-equal to the earlier kernel")
        result["k4"][label] = {"bit_equal": same, **turns("fast_scores_3d", label, old, new, a)}

    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "kernel_ab.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({"ok": True, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
