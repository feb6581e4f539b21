"""Readings the limits of a cell are set from (not run by the benchmark's
own runs).

    python3 hgbench/calibrate.py --workload <cell> --seconds <s> --seeds <n> ... [--control <k>]

For each seed, in one process: the cell's set-up and a window of
`seconds` at the cell's own load, then its compared numbers as the
program gives them, and for the first `k` seeds also with the control in
the program's place: the plain reference one precision below the
configuration's (bfloat16 for float32), computed for the same sampled
answers. Prints one JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from hgbench.lib import names
    from hgbench.lib.session import Session

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        s = Session(args.workload, seed, args.seconds, False, "cuda:0")
        names.load_module("drivers", s.mix["driver"]).run(s)
        s.release()
        s.unpatch()
        rec = {"seed": seed, "attempted": s.attempted, "failed": s.failed, "rate": s.e2e,
               "program": {n: v for n, v, _ in s.compare(False)}}
        if i < args.control:
            rec["control"] = {n: v for n, v, _ in s.compare(True)}
        rec["seconds"] = time.perf_counter() - t0
        print(json.dumps(rec), flush=True)
        del s
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
