"""Where a sharded 3D pose graph parts from the unsharded one, on the card.

Phase 24b of chip_smoke.py compares a 3D pose graph solved through the
solver plane with the same graph solved without it. This script separates
the two things that can make them differ, and prints one line each:

  scene  builds 24b's TSDF rooms (chip_smoke.solver_plane_rooms) twice and
         counts the cells whose planes differ: the inserter sums with
         atomics on the card, so two builds need not agree bit for bit;
  graph  solves 24b's graph without a mesh three times on rooms rebuilt
         each time, twice more on one scene, and three times each over a
         one-process Mesh of 2 and of 4 shards on that scene, and prints
         the node-pose gaps;
  ops    computes each small batched op of the sharded paths (3 x 3 and
         6 x 6 matmuls, a 6 x 6 matvec, the batched solve_ex, the inverse
         right Jacobian, vector_norm) over a batch of B, lane by lane and
         in quarters, and prints whether the bits agree, for B from 1 to
         1000;
  24b    runs chip_smoke's phase 24b twice.

    python3 shard_probe.py [scene] [graph] [ops] [24b]

Needs one CUDA card; with no argument it runs all four.
"""
import sys

import numpy as np
import torch

import chip_smoke as cs
from hectorgrapher_tpu_torch.ops import _build
from hectorgrapher_tpu_torch.parallel.mesh import Mesh
from hectorgrapher_tpu_torch.transform.rigid import inverse_right_jacobian


def grid_diff(a, b):
    """(cells that differ, largest difference) for each float leaf of the
    grids a and b."""
    out = []
    for ga, gb in zip(a, b):
        for x, y in zip(ga, gb):
            if isinstance(x, torch.Tensor) and x.is_floating_point():
                out.append((int((x != y).sum()), float((x - y).abs().max())))
    return out


def gap(a, b):
    """(largest node-pose gap m, same INTER constraints) of two graph runs."""
    return float(np.abs(a[1] - b[1]).max()), [(s, n) for s, n, _ in a[0]] == [(s, n) for s, n, _ in b[0]]


def main():
    if not torch.cuda.is_available():
        sys.exit("shard_probe.py needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load_library()
    print(cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                            capture_output=True, text=True).stdout.strip(), flush=True)
    what = sys.argv[1:] or ["scene", "graph", "ops", "24b"]

    if "scene" in what:
        r1, r2 = cs.solver_plane_rooms(dev), cs.solver_plane_rooms(dev)
        for i in range(5):
            print(f"scene room {i}: (differing cells, max |diff|) of the hi / lo grids' leaves "
                  f"{grid_diff([r1[0][i][0], r1[0][i][1]], [r2[0][i][0], r2[0][i][1]])}", flush=True)

    if "graph" in what:
        runs = [cs.solver_plane_graph_3d(dev, None, None, cs.solver_plane_rooms(dev)) for _ in range(3)]
        print(f"plain graph, rooms rebuilt each run: gaps {[gap(runs[0], r) for r in runs[1:]]}", flush=True)
        rooms = cs.solver_plane_rooms(dev)
        base = cs.solver_plane_graph_3d(dev, None, None, rooms)
        same = [cs.solver_plane_graph_3d(dev, None, None, rooms) for _ in range(2)]
        print(f"plain graph, one scene: gaps {[gap(base, r) for r in same]}", flush=True)
        for n in (2, 4):
            meshed = [cs.solver_plane_graph_3d(dev, Mesh([dev] * n), None, rooms) for _ in range(3)]
            print(f"{n}-shard local mesh vs plain, one scene: gaps {[gap(base, r) for r in meshed]}", flush=True)

    if "ops" in what:
        g = torch.Generator(device="cpu").manual_seed(0)
        for B in (1, 2, 3, 4, 5, 7, 8, 12, 16, 31, 64, 100, 1000):
            a3, b3 = torch.randn(B, 3, 3, generator=g).to(dev), torch.randn(B, 3, 3, generator=g).to(dev)
            a6 = torch.randn(B, 6, 6, generator=g).to(dev)
            spd = a6 @ a6.transpose(1, 2) + 6 * torch.eye(6, device=dev)
            v6 = torch.randn(B, 6, generator=g).to(dev)
            phi = torch.randn(B, 3, generator=g).to(dev) * 0.3
            ops = {
                "bmm3": lambda s: a3[s] @ b3[s],
                "bmm6": lambda s: a6[s].transpose(1, 2) @ a6[s],
                "matvec6": lambda s: (a6[s].transpose(1, 2) @ v6[s][:, :, None])[:, :, 0],
                "solve_ex6": lambda s: torch.linalg.solve_ex(spd[s], v6[s])[0],
                "inv_right_jac": lambda s: inverse_right_jacobian(phi[s]),
                "norm6": lambda s: torch.linalg.vector_norm(v6[s], dim=-1),
            }
            res = {}
            for name, f in ops.items():
                whole = f(slice(0, B))
                ones = torch.cat([f(slice(i, i + 1)) for i in range(B)])
                q = max(1, B // 4)
                quarters = torch.cat([f(slice(i, min(i + q, B))) for i in range(0, B, q)])
                res[name] = (bool(torch.equal(whole, ones)), bool(torch.equal(whole, quarters)))
            print(f"ops B={B}: (whole == lane by lane, whole == quarters) {res}", flush=True)

    if "24b" in what:
        for _ in range(2):
            cs.run_phase_24b()


if __name__ == "__main__":
    main()
