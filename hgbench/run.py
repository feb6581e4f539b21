"""Run one cell of the benchmark once.

    python3 hgbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints, as the last line of standard output,
one JSON object: correct, attempted, failed, metrics (the cell's
end-to-end metrics, or with --trace 1 its per-layer metrics), device,
optionally breakdown, and last `compared`, each number compared with the
plain reference beside its limit; the same numbers end standard error.
Exits non-zero with no result where no card (or fewer than the cell
asks for) is present, where the program cannot be loaded, or where JAX
or the JAX package was loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "_hgbench_cache"


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def print_rows(rows):
    """Each compared number beside its limit, the last lines on stderr."""
    for name, value, limit in rows:
        print(f"compared {name} = {value!r} (limit {limit!r})", file=sys.stderr)


def main(argv=None) -> int:
    args = parse(argv)
    # Build and kernel caches live in the checkout, at fixed paths.
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))
    import torch

    from hgbench.lib import names
    from hgbench.lib.session import Session, finish, forbidden_modules

    spec = names.benchmark()
    workload = names.workload(spec, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < workload["chips"]:
        print(f"hgbench: the cell needs {workload['chips']} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    session = Session(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0", spec=spec,
                      t_start=T_START)
    names.load_module("drivers", session.mix["driver"]).run(session)
    line, rows = finish(session)
    loaded = forbidden_modules()
    if loaded:
        print(f"hgbench: modules of JAX or the JAX package were loaded: {loaded}", file=sys.stderr)
        return 3
    print_rows(rows)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
