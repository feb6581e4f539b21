#!/usr/bin/env python3
"""K1-K5 against an earlier version of themselves, on one CUDA card.

    python3 kernel_ab.py PARENT_DIR [--kernels k1 k2 k3 k3p k4 k5] [--out kernel_ab.json]

    python3 kernel_ab.py --designs DIR [DIR ...] [--out kernel_ab_designs.json]

PARENT_DIR holds a checkout of an earlier commit, for example made with
`git archive <commit> hectorgrapher_tpu_torch | tar -x -C PARENT_DIR`. Its
kernels (csrc/*.cu) are built into a second library by its own
ops/_build.py (same nvcc flags), and its ops/ wrappers are loaded against
that library. At every main-path shape of each kernel both versions run on
the same inputs, in turns: earlier, this, this, earlier. The shapes: K1 and
K2 at chip_smoke.py phases 3-4's front end (B=1, T=425, N=2048) and batched
point (B=1024, T=40, N=512), the earlier K2 on its pw*pw-lane table and
this one on the padded table (prepare_correlative_table), both built from
one grid; K3 at the CT front end's C=32 and GN3D's C=1 at 256^3 / 128^3,
and slotted at a packed GN3D's shape (8 lanes over two grid pairs), in
its TSDF mode, then in its probability mode at the same two shapes on
chip_smoke.py phase 7's occupancy maps (this tree's kernel alone when the
earlier version has no probability mode), then this tree's f16 and bf16
TSDF modes (phase 7's maps of the same scans stored in half precision) at
the three shapes in turns with the earlier kernel's f32 TSDF mode on the
f32 maps (the same work at half the stencil's bytes); K3's per-point mode
(k3p) at phase 7's shape, alone and slotted over 8 windows, on f32 and
f16 maps (this tree's kernel alone where the earlier one lacks the mode);
K4 at
chip_smoke.py phase 10's coarse call, first expansion and level-0
expansion, and with row bases at a batched round's coarse call (four scans
over a pack of two submaps); K5 at a local 2D search's coarse call and
first expansion, a full-submap search's coarse call and, with row bases, a
round's coarse call and first expansion over a pack of four submaps
(k5_scene: chip_smoke.py phase 20's grids, clouds and search
configurations, without its drive), each first held to two launches'
bits and to the plain tolerance of both the plain version and the
earlier kernel.
Where the earlier version lacks the input a shape needs (K3's slots, K4's
row bases) or the kernel (K5), this tree's kernel runs its two turns
alone. Each turn prints per-call time (CUDA events around the call),
the kernel's device time (torch.profiler; beside it the CUDA-event time of
the call with the stream kept busy ahead of it, chip_smoke.event_ms) and
the wrapper's host time per call (enqueue only); then the outputs'
largest difference and the bound (chip_smoke.bound_ms). Writes everything to chiprun_out/kernel_ab.json.

With --designs, each DIR holds a copy of this package whose K2 source is a
design variant (same wrapper and table layout). Each variant's K2 is first
held against the plain version by chip_smoke.py's K2 gates (the front
end's and the batched shape, ragged and misaligned inputs, wide windows);
then every variant that passed and this tree's K2 run in turns on the same
inputs at the front end's and the batched shape, and print their device
time and largest difference from this tree's.

Imports torch, numpy and hectorgrapher_tpu_torch only; needs one card.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

import chip_smoke as cs
from hectorgrapher_tpu_torch.mapping.scan_matching import correlative_2d as corr
from hectorgrapher_tpu_torch.ops import _build
from hectorgrapher_tpu_torch.ops import correlative_prep_2d as k1
from hectorgrapher_tpu_torch.ops import correlative_scores_2d as k2
from hectorgrapher_tpu_torch.ops import ct_scan_block as k3
from hectorgrapher_tpu_torch.ops import fast_scores_2d as k5
from hectorgrapher_tpu_torch.ops import fast_scores_3d as k4


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_parent(parent: Path):
    """The earlier checkout's kernels built into a second library by its
    own ops/_build.py (its entry points and nvcc flags), and a stand-in for
    ops._build that serves it to the earlier wrappers."""
    pkg = parent / "hectorgrapher_tpu_torch"
    earlier = _load(pkg / "ops" / "_build.py", "earlier__build")
    target = parent / "_build_ab" / "libhg_kernels_earlier.so"
    log = earlier.build(sorted((pkg / "csrc").glob("*.cu")), target)
    lib = earlier.bind(target)

    def launch(name, device, *args):
        stream = torch.cuda.current_stream(device).cuda_stream
        _build.check_launch(getattr(lib, name)(*args, stream), name)

    return SimpleNamespace(load_library=lambda: lib, check_launch=_build.check_launch, launch=launch, build_log=log)


def load_parent_module(parent: Path, name: str, build):
    """The earlier ops/<name>.py, its kernel calls served by `build`."""
    mod = _load(parent / "hectorgrapher_tpu_torch" / "ops" / f"{name}.py", f"earlier_{name}")
    mod._build = build
    return mod


def load_parent_wrapper(parent: Path, name: str, build):
    """The earlier ops/<name>.py's function `name`."""
    return getattr(load_parent_module(parent, name, build), name)


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


def turns(name, label, old, new, args, kernel_name=None, old_args=None):
    """earlier, this, this, earlier (this, this without an earlier
    version): per-call, device and host time of each turn; then the
    bound of each version's inputs (old_args: the earlier version's, where
    they differ from this one's)."""
    kernel = kernel_name or f"{name}_kernel"
    out = {"turns": []}
    order = (("earlier", old), ("this", new), ("this", new), ("earlier", old)) if old else (("this", new),) * 2
    for which, fn in order:
        rec = {"version": which, "ms": cs.cuda_ms(fn, reps=50), "device_ms": cs.device_ms(fn, reps=50, match=kernel),
               "event_ms": cs.event_ms(fn, reps=50), "host_us": host_us(fn)}
        out["turns"].append(rec)
        print(f"{name} {label} {which}: per call {rec['ms']:.4f} ms, device {cs._fmt(rec['device_ms'])} (events "
              f"{rec['event_ms']:.4f} ms), host {rec['host_us']:.1f} us", flush=True)
    b_ms, b_by, nbytes, ops = cs.bound_ms(name, args)
    out.update(bound_ms=b_ms, bound_by=b_by, bytes=nbytes, ops=ops)
    if old_args is not None:
        out["earlier_bound_ms"] = cs.bound_ms(name, old_args)[0]
    for which in ("earlier", "this") if old else ("this",):
        dev = [t["device_ms"] for t in out["turns"] if t["version"] == which]
        out[f"{which}_device_ms"] = sum(dev) / len(dev)
        b_ms = out["earlier_bound_ms"] if which == "earlier" and old_args is not None else out["bound_ms"]
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


def run_2d(device, parent, build, result, kernels):
    """K1 and K2 (those in `kernels`), earlier against this, at the front
    end's and the batched shape."""
    old_k1 = load_parent_wrapper(parent, "correlative_prep_2d", build)
    old_k2 = load_parent_wrapper(parent, "correlative_scores_2d", build)
    result.update({name: {} for name in ("k1", "k2") if name in kernels})
    for label, (grid, clouds, poses, window) in (("front_end", cs.front_end_kernel_inputs(device)),
                                                 ("batched", cs.batched_scene(device))):
        k, gsz, half, m, pw, n_th, n_groups = corr._window_geometry(window)
        args, kw = corr.prep_inputs(grid, clouds, poses, window)
        args = (*args, *(kw[key] for key in ("n_groups", "gsz", "margin", "ex", "ey")))
        new1 = lambda a=args: k1.correlative_prep_2d(*a)
        old1 = lambda a=args: old_k1(*a)
        (flat, dlin), (flat_o, dlin_o) = new1(), old1()
        same = bool(torch.equal(flat, flat_o) and torch.equal(dlin, dlin_o))
        print(f"correlative_prep_2d {label} B={flat.shape[0]} T={dlin.shape[1]} N={flat.shape[2]}: equal to the "
              f"earlier kernel: {same}", flush=True)
        if not same:
            sys.exit(f"kernel_ab: FAIL: correlative_prep_2d {label} differs from the earlier kernel")
        if "k1" in kernels:
            result["k1"][label] = {"equal": same, **turns("correlative_prep_2d", label, old1, new1, args)}
        if "k2" not in kernels:
            continue

        table = corr.prepare_correlative_table(grid, window)
        table_old = corr._wide_patch_table(grid.probability(), k, half)  # pw*pw lanes, the earlier layout
        valid = clouds.mask.to(torch.float32).contiguous()
        sargs = (table, flat, dlin, valid, n_groups, gsz, pw, k)
        new2 = lambda a=sargs: k2.correlative_scores_2d(*a)
        old2 = lambda a=sargs: old_k2(table_old, *a[1:])
        diff = float((new2() - old2()).abs().max())
        gate = 1e-4 * float(valid.sum(dim=1).max())
        print(f"correlative_scores_2d {label} G={n_groups} rows {table.shape[1]} (earlier {table_old.shape[1]}) "
              f"lanes: this vs earlier max |d| {diff:.3e} (gate {gate:.3e})", flush=True)
        if not diff <= gate:
            sys.exit(f"kernel_ab: FAIL: correlative_scores_2d {label} differs from the earlier kernel by {diff:.3e}")
        result["k2"][label] = {"max_abs_diff": diff, **turns("correlative_scores_2d", label, old2, new2, sargs)}


def run_designs(device, dirs, result):
    """K2 of each design directory against this tree's, in turns, after
    chip_smoke.py's K2 gates."""
    shapes = {}
    for label, (grid, clouds, poses, window) in (("front_end", cs.front_end_kernel_inputs(device)),
                                                 ("batched", cs.batched_scene(device))):
        k, gsz, half, m, pw, n_th, n_groups = corr._window_geometry(window)
        args, kw = corr.prep_inputs(grid, clouds, poses, window)
        flat, dlin = k1.correlative_prep_2d(*args, **kw)
        table = corr.prepare_correlative_table(grid, window)
        shapes[label] = (table, flat, dlin, clouds.mask.to(torch.float32).contiguous(), n_groups, gsz, pw, k)
    fns = {"this": k2.correlative_scores_2d}
    result["designs"] = {"gates": {}}
    for d in dirs:
        build = build_parent(d.resolve())
        print(f"{d}: " + " | ".join(l.strip() for l in build.build_log.splitlines() if "registers" in l), flush=True)
        fn = load_parent_wrapper(d.resolve(), "correlative_scores_2d", build)
        try:
            for label, sargs in shapes.items():
                err = cs.check_k2(label, sargs, fn)
                print(f"correlative_scores_2d {label} {d}: max |d| from plain {err:.3e}, two launches bit-equal",
                      flush=True)
            cs.check_k2_cases(device, kernel=fn)
        except SystemExit as e:
            print(f"design {d} failed a gate: {e}", flush=True)
            result["designs"]["gates"][str(d)] = str(e)
            continue
        result["designs"]["gates"][str(d)] = "passed"
        fns[str(d)] = fn
    for label, sargs in shapes.items():
        ref = fns["this"](*sargs)
        rec = result["designs"][label] = {}
        for which in list(fns) + list(fns)[::-1]:
            ms = cs.device_ms(lambda: fns[which](*sargs), reps=30, match="correlative_scores_2d_kernel")
            diff = float((fns[which](*sargs) - ref).abs().max())
            rec.setdefault(which, []).append(ms)
            print(f"correlative_scores_2d {label} {which}: device {cs._fmt(ms)}, max |d| from this tree's "
                  f"{diff:.3e}", flush=True)


def run_3d(device, parent, build, result, kernels):
    """K3 and K4 (those in `kernels`), earlier against this, at their
    main-path shapes."""
    old_k3 = load_parent_wrapper(parent, "ct_scan_block", build)
    old_k4 = load_parent_wrapper(parent, "fast_scores_3d", build)
    result.update({name: {} for name in ("k3", "k4") if name in kernels})
    hi, lo, scan_pts = cs.ct_production_grids(device)
    for label, c in (("front_end", 32), ("gn3d", 1)) if "k3" in kernels else ():
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
    if "k3" in kernels:
        # A packed GN3D's shape: 8 lanes over two grid pairs (the production
        # grids and a copy of them), alternating.
        hi2, lo2 = (g._replace(tsd=g.tsd.clone(), weight=g.weight.clone()) for g in (hi, lo))
        a = cs.ct_kernel_inputs(device, hi, lo, scan_pts, c=8)
        args = (k3.grid_slots([hi, hi2], [lo, lo2]), torch.arange(8, dtype=torch.int32, device=device) % 2, *a[2:10])
        old_slots = getattr(load_parent_module(parent, "ct_scan_block", build), "ct_scan_block_slots", None)
        new = lambda a=args: k3.ct_scan_block_slots(*a)
        old = None if old_slots is None else (lambda a=args: old_slots(*a))
        result["k3"]["gn3d_packed"] = turns("ct_scan_block_slots", "gn3d_packed", old, new, args,
                                            kernel_name="ct_scan_block_kernel")
        del hi2, lo2
    del hi, lo
    if "k3" in kernels:
        # Probability mode, on phase 7's occupancy maps (16 points of each
        # cloud outside both grids). An earlier kernel takes it only if its
        # wrapper knows the prepared field.
        hi, lo = cs.ct_production_probability_grids(device)
        old_module = load_parent_module(parent, "ct_scan_block", build)
        old_takes_prob = hasattr(old_module, "is_probability_pair") or hasattr(old_module, "kernel_mode")
        for label, c in (("prob_front_end", 32), ("prob_gn3d", 1)):
            args = cs.ct_kernel_inputs(device, hi, lo, scan_pts, c=c, outside=16)
            new = lambda a=args: k3.ct_scan_block(*a[:10], gparams=a[10])
            old = (lambda a=args: old_module.ct_scan_block(*a[:10])) if old_takes_prob else None
            result["k3"][label] = turns("ct_scan_block", label, old, new, args)
        del hi, lo
        # The f16 and bf16 TSDF modes on maps of the same scans stored in
        # half precision, in turns with the earlier kernel's f32 TSDF mode
        # on the f32 maps; their outputs differ by the storage's rounding.
        hi, lo, _ = cs.ct_production_grids(device)
        hi2, lo2 = (g._replace(tsd=g.tsd.clone(), weight=g.weight.clone()) for g in (hi, lo))
        old_slots = getattr(old_module, "ct_scan_block_slots", None)
        for dtype, tag in ((torch.float16, "f16"), (torch.bfloat16, "bf16")):
            hh, lh, _ = cs.ct_production_grids(device, dtype)
            hh2, lh2 = (g._replace(tsd=g.tsd.clone(), weight=g.weight.clone()) for g in (hh, lh))
            for label, c in (("front_end", 32), ("gn3d", 1), ("gn3d_packed", 8)):
                a32 = cs.ct_kernel_inputs(device, hi, lo, scan_pts, c=c)
                ah = cs.ct_kernel_inputs(device, hh, lh, scan_pts, c=c)
                if label == "gn3d_packed":
                    lanes = torch.arange(8, dtype=torch.int32, device=device) % 2
                    args = (k3.grid_slots([hh, hh2], [lh, lh2]), lanes, *ah[2:10])
                    args32 = (k3.grid_slots([hi, hi2], [lo, lo2]), lanes, *a32[2:10])
                    new = lambda a=args: k3.ct_scan_block_slots(*a)
                    old = None if old_slots is None else (lambda a=args32: old_slots(*a))
                    name, old_args = "ct_scan_block_slots", args32
                else:
                    args, old_args = ah, a32
                    new = lambda a=ah: k3.ct_scan_block(*a[:10], gparams=a[10])
                    old = lambda a=a32: old_k3(*a[:10])
                    name = "ct_scan_block"
                diff = max(float((x - y).abs().max()) for x, y in zip(new(), old())) if old else None
                print(f"ct_scan_block {tag}_{label}: this ({tag} maps) vs earlier (f32 maps) max |d| "
                      f"{'not compared' if diff is None else f'{diff:.3e}'}", flush=True)
                result["k3"][f"{tag}_{label}"] = {"max_abs_diff_from_f32": diff, **turns(
                    name, f"{tag}_{label}", old, new, args, kernel_name="ct_scan_block_kernel",
                    old_args=old_args)}
            del hh, lh, hh2, lh2
        del hi, lo, hi2, lo2

    if "k3p" in kernels:
        run_points(device, parent, build, result, scan_pts)
    if "k4" not in kernels:
        return
    _, match = cs.fast_match_setup(device, *cs.fast_match_submap(device))
    calls, _ = cs.recorded_score_sums(match)
    # An earlier kernel without row bases takes the calls without their
    # trailing cand_base (None for one submap).
    takes_bases = "cand_base" in inspect.signature(old_k4).parameters
    for label, (a, _) in cs.fast_score_shapes(calls).items():
        new = lambda a=a: k4.fast_scores_3d(*a)
        old = lambda a=a: old_k4(*(a if takes_bases else a[:12]))
        same = bool(torch.equal(new(), old()))
        print(f"fast_scores_3d {label} level {a[9]} C={a[5].shape[0]} outputs {new().shape}: bit-equal to the "
              f"earlier kernel: {same}", flush=True)
        if not same:
            sys.exit(f"kernel_ab: FAIL: fast_scores_3d {label} is not bit-equal to the earlier kernel")
        result["k4"][label] = {"bit_equal": same, **turns("fast_scores_3d", label, old, new, a)}
    a = round_coarse_call(device)
    result["k4"]["round_coarse"] = turns("fast_scores_3d", "round_coarse",
                                         (lambda: old_k4(*a)) if takes_bases else None, lambda: k4.fast_scores_3d(*a), a)


def run_points(device, parent, build, result, scan_pts):
    """K3's per-point mode at chip_smoke.py phase 7's shape (K = 32, C =
    32, 256 + 256 points), alone and slotted over 8 windows and three grid
    pairs, on f32 and f16 TSDF maps; the earlier kernel takes turns only
    if it has the mode."""
    old_module = load_parent_module(parent, "ct_scan_block", build)
    old_points = getattr(old_module, "ct_scan_block_points", None)
    old_slots = getattr(old_module, "ct_scan_block_points_slots", None)
    result["k3p"] = {}
    for dtype, tag in ((torch.float32, ""), (torch.float16, "f16_")):
        pairs = [cs.ct_production_grids(device, dtype, n)[:2] for n in (3, 2, 1)]
        a = cs.ct_point_inputs(device, *pairs[0], scan_pts, outside=16)
        new = lambda a=a: k3.ct_scan_block_points(*a[:4], gparams=a[4])
        old = None if old_points is None else (lambda a=a: old_points(*a[:4]))
        result["k3p"][f"{tag}front_end"] = turns("ct_scan_block_points", f"{tag}front_end", old, new, a[:4],
                                                  kernel_name="ct_scan_block_points_kernel")
        sargs = cs.ct_points_slots_inputs(device, pairs, scan_pts, windows=8)
        new = lambda a=sargs: k3.ct_scan_block_points_slots(*a)
        old = None if old_slots is None else (lambda a=sargs: old_slots(*a))
        result["k3p"][f"{tag}front_end_slotted_b8"] = turns(
            "ct_scan_block_points_slots", f"{tag}front_end_slotted_b8", old, new, sargs,
            kernel_name="ct_scan_block_points_kernel")
        del pairs


def round_coarse_call(device, n_scans=4):
    """K4's arguments at a batched round's coarse call: n_scans scans of
    the box room (chip_smoke.py phase 10's scan poses, moved 0.2 m apart)
    searched together over a pack of two copies of phase 10's submap, one
    scan each in turn."""
    from hectorgrapher_tpu_torch.evaluation.scan_generator import raycast_box_room_3d
    from hectorgrapher_tpu_torch.parallel import constraint_search as pcs
    from hectorgrapher_tpu_torch.transform import np_quat as nq
    from hectorgrapher_tpu_torch.transform.rigid import Rigid3

    matcher, _ = cs.fast_match_setup(device, *cs.fast_match_submap(device))
    packed = pcs.pack_submaps_3d([matcher, matcher], device)
    truth_t, truth_yaw = cs.FM_TRUTH
    rng = np.random.default_rng(cs.SEED)
    candidates = []
    for i in range(n_scans):
        pts = raycast_box_room_3d(truth_t + [0.2 * i, 0.0, 0.0], nq.quat_from_axis_angle(np.array([0.0, 0.0, truth_yaw])),
                                  num_azimuth=96, num_elevation=24, noise_std=0.004, rng=rng)
        high, low, hist = cs.node_clouds(pts[~np.isnan(pts[:, 0])], device)
        candidates.append((i % 2, high, low, hist, Rigid3(cs.FM_START.astype(np.float32) + [0.2 * i, 0.0, 0.0],
                                                          np.array([1.0, 0.0, 0.0, 0.0], np.float32)), 0.0))
    config = matcher._options
    config = cs.fast_correlative_3d.make_fast_search_3d_config(config, matcher._resolution, 20.0, False, 256)
    calls = []
    with cs.score_sums_through(lambda *a: calls.append(a) or k4.fast_scores_3d(*a)):
        pcs.sharded_fast_matches_3d_packed(packed, candidates, config)
    return calls[0]


def k5_scene(device, n_submaps=4):
    """K5's calls at chip_smoke.py phase 20's shapes without its drive:
    n_submaps 640^2 submaps at 0.05 m, submap k filled with the 12 scans
    12k .. 12k + 11 of phase 20's drive (chip_smoke.slam2d_scans) at their
    true poses, and three scans of the second lap as node clouds (the front
    end's voxel filter, 2048 points), searched from 5 cm / 0.02 rad off
    their true poses at phase 20's search configurations. Returns {shape:
    K5 arguments}: a local search's coarse call and first expansion, a
    full-submap search's coarse call, and a round's coarse call and first
    expansion over the pack of the n_submaps submaps."""
    import math

    from hectorgrapher_tpu_torch.mapping.grids import make_probability_grid
    from hectorgrapher_tpu_torch.mapping.inserters_2d import make_probability_inserter_2d
    from hectorgrapher_tpu_torch.mapping.scan_matching import fast_correlative_2d as fc2
    from hectorgrapher_tpu_torch.parallel import constraint_search as pcs
    from hectorgrapher_tpu_torch.sensor.types import RangeData, pad_cloud
    from hectorgrapher_tpu_torch.sensor.voxel_filter import voxel_filter
    from hectorgrapher_tpu_torch.transform import np_quat as nq
    from hectorgrapher_tpu_torch.transform.rigid import Rigid2

    opts = cs.slam2d_options()
    fm = opts.pose_graph.constraint_builder.fast_correlative_scan_matcher
    insert = make_probability_inserter_2d(
        opts.trajectory_builder_2d.submaps.range_data_inserter.probability_grid_range_data_inserter, max_range=32.0,
        resolution=0.05)
    scans = cs.slam2d_scans()
    grids = []
    for k in range(n_submaps):
        grid = make_probability_grid(0.05, (640, 640), device)
        for _, pose, _, cloud in scans[12 * k:12 * (k + 1)]:
            world = nq.quat_rotate(pose.q, cloud.positions[cloud.mask]) + pose.t
            grid = insert(grid, RangeData(torch.tensor(pose.t, dtype=torch.float32, device=device),
                                          pad_cloud(world.astype(np.float32), 2048, device),
                                          pad_cloud(np.zeros((0, 3), np.float32), 8, device)))
        grids.append(grid)
    nodes = []
    for _, pose, _, cloud in scans[cs.N_SCANS + 5:cs.N_SCANS + 8]:
        pc = voxel_filter(pad_cloud(cloud.positions[cloud.mask], 2048, device), 0.025)
        init = Rigid2(torch.tensor(pose.t[:2] + [0.05, -0.03], dtype=torch.float32, device=device),
                      torch.tensor(nq.quat_yaw(pose.q) + 0.02, dtype=torch.float32, device=device))
        nodes.append((pc, init))
    rmax = float(torch.linalg.vector_norm(nodes[0][0].positions[nodes[0][0].mask], dim=-1).max())
    bucket = 1.0
    while bucket < rmax and bucket < opts.trajectory_builder_2d.max_range:
        bucket *= math.sqrt(2.0)
    scan_range = min(bucket, opts.trajectory_builder_2d.max_range)
    local = fc2.make_fast_search_config(fm.linear_search_window, fm.angular_search_window, 0.05, scan_range,
                                        fm.branch_and_bound_depth)
    full = fc2.make_fast_search_config(640 * 0.05 / 2.0, math.pi, 0.05, scan_range, fm.branch_and_bound_depth)
    out = {}
    for label, config in (("local", local), ("global", full)):
        prepared = fc2.prepare_fast_matcher_2d(grids[0], config.depth)
        calls, _ = cs.recorded_k5(lambda: fc2.match_fast_2d_prepared(prepared, nodes[0][0], nodes[0][1], config))
        out[f"{label}_coarse"] = calls[0][0]
        if label == "local":
            out["local_expansion"] = calls[1][0]
    packed = pcs.pack_submaps_2d([fc2.prepare_fast_matcher_2d(g, local.depth) for g in grids], device)
    candidates = [(k, pc, init) for pc, init in nodes for k in range(n_submaps)]
    calls, _ = cs.recorded_k5(lambda: pcs.sharded_fast_matches_2d_packed(packed, candidates, local))
    out["rows_coarse"] = calls[0][0]
    out["rows_expansion"] = calls[1][0]
    return out


def run_k5(device, parent, build, result):
    """K5 at k5_scene's shapes; the earlier kernel takes turns where its
    checkout has one (ops/fast_scores_2d.py). Before the turns, this
    kernel must give the same bits on two launches and lie within
    chip_smoke.k5_gates' tolerance, 1e-5 * max(1, max|sum|), of both the
    plain version and the earlier kernel (a redesign may sum in another
    order)."""
    old_k5 = None
    if (parent / "hectorgrapher_tpu_torch" / "ops" / "fast_scores_2d.py").exists():
        old_k5 = load_parent_wrapper(parent, "fast_scores_2d", build)
    result["k5"] = {}
    for label, a in k5_scene(device).items():
        new = lambda a=a: k5.fast_scores_2d(*a)
        old = None if old_k5 is None else (lambda a=a: old_k5(*a))
        got, want = new(), k5.fast_scores_2d_plain(*a)
        tol = 1e-5 * max(1.0, float(want.abs().max()))
        errs = {"plain": float((got - want).abs().max())}
        if old is not None:
            errs["earlier"] = float((got - old()).abs().max())
        if not torch.equal(got, new()):
            sys.exit(f"kernel_ab: FAIL: fast_scores_2d {label} differs between two launches")
        if not bool(torch.isfinite(got).all()) or max(errs.values()) > tol:
            sys.exit(f"kernel_ab: FAIL: fast_scores_2d {label} differs by {errs} (tolerance {tol:.3e})")
        print(f"fast_scores_2d {label} level {a[7]} C={a[4].shape[0]} X={a[5].shape[1]} Y={a[6].shape[1]} "
              f"P={a[1].shape[1]} instance {k5.instance(a[5].shape[1], a[6].shape[1])}: max |d| from the plain "
              f"version {errs['plain']:.3e}, from the earlier kernel {errs.get('earlier', float('nan')):.3e} "
              f"(tolerance {tol:.3e})", flush=True)
        result["k5"][label] = {"max_abs_err": errs, "tolerance": tol, **turns("fast_scores_2d", label, old, new, a)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("parent", type=Path, nargs="?", help="directory holding the earlier checkout")
    parser.add_argument("--designs", type=Path, nargs="+", default=[], help="directories holding K2 variants")
    parser.add_argument("--kernels", nargs="+", choices=("k1", "k2", "k3", "k3p", "k4", "k5"),
                        default=["k1", "k2", "k3", "k3p", "k4", "k5"])
    parser.add_argument("--out", default=None, help="file name under chiprun_out/")
    opts = parser.parse_args()
    if (opts.parent is None) == (not opts.designs):
        parser.error("give either PARENT_DIR or --designs")
    if not torch.cuda.is_available():
        sys.exit("kernel_ab: FAIL: torch.cuda.is_available() is false: this script needs a CUDA card")
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
    result = {"card": card, "fill_device_ms": floor_ms}
    if opts.designs:
        run_designs(device, opts.designs, result)
    else:
        parent = opts.parent.resolve()
        build = build_parent(parent)
        result["parent"] = str(opts.parent)
        if {"k1", "k2"} & set(opts.kernels):
            run_2d(device, parent, build, result, opts.kernels)
        if {"k3", "k3p", "k4"} & set(opts.kernels):
            run_3d(device, parent, build, result, opts.kernels)
        if "k5" in opts.kernels:
            run_k5(device, parent, build, result)

    out = opts.out or ("kernel_ab_designs.json" if opts.designs else "kernel_ab.json")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", out), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({"ok": True, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
