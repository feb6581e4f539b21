"""The JAX package's MapBuilder over chip_smoke.py's 3D SLAM drive, on the
CPU: the reference errors that chip_smoke.py holds phases 11 and 12 to.

    JAX_PLATFORMS=cpu python tests/jax_slam_reference.py [--batched] [--probability] [--storage float16] [--runs 2]

The drive (chip_smoke.slam_drive) and the options (chip_smoke.
slam_overrides, applied to the JAX package's MapBuilderOptions) are those
of the chip phase: serial constraint search, or with --batched the default
batched search (phase 12); --probability drops the TSDF override, so the
submaps keep the default grid_type, PROBABILITY_GRID (with --batched,
phase 13); --storage float16 stores the TSDF submaps' planes in float16
(with --batched, phase 14). Each run prints one JSON line with the counts
and errors of chip_smoke.slam_result; with the async work queue the
worker's timing against the front end moves the solves' starting poses,
so the constants chip_smoke.py records are the larger of each over the
runs. A full-width run holds a few GiB and takes a few minutes.

    JAX_PLATFORMS=cpu python tests/jax_slam_reference.py --ct-drift

runs tests/test_ct_builder.py's straight 3 s drive (96^3 / 48^3 grids,
seed 0) through the JAX OptimizingLocalTrajectoryBuilder once with TSDF
and once with PROBABILITY_GRID submaps, and prints each one's result count
and max translation error (ROADMAP C15).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import chip_smoke  # noqa: E402
from hectorgrapher_tpu.common.config import MapBuilderOptions, replace_deep  # noqa: E402
from hectorgrapher_tpu.mapping.map_builder import MapBuilder  # noqa: E402
from hectorgrapher_tpu.sensor.types import TimedPointCloud, TimedPointCloudData  # noqa: E402
from hectorgrapher_tpu.transform.np_quat import NpRigid3  # noqa: E402


def run(batched: bool, probability: bool, storage=None) -> dict:
    mb = MapBuilder(replace_deep(MapBuilderOptions(), chip_smoke.slam_overrides(batched, probability, storage)))
    tb = mb.get_trajectory_builder(mb.add_trajectory_builder())
    t0 = time.perf_counter()
    for kind, t, *payload in chip_smoke.slam_drive():
        if kind == "imu":
            tb.add_imu_data(t, *payload)
        elif kind == "odom":
            tb.add_odometry_data(t, NpRigid3(payload[0].t, payload[0].q))
        else:
            data = payload[0]
            r = data.ranges
            tb.add_range_data(TimedPointCloudData(
                time=jnp.asarray(data.time), origin=jnp.zeros(3, jnp.float32),
                ranges=TimedPointCloud(positions=r.positions, times=r.times, mask=r.mask), width=data.width))
    mb.pose_graph.wait_for_all_computations()
    return dict(chip_smoke.slam_result(mb.pose_graph), seconds=time.perf_counter() - t0)


def ct_drift() -> None:
    """ROADMAP C15: test_straight_drive_tracks_pose's drive and error, on
    either grid type."""
    import numpy as np

    from hectorgrapher_tpu.mapping.ct.builder import OptimizingLocalTrajectoryBuilder
    from test_ct_builder import drive_ct, gt_pose, make_options

    for grid_type in ("TSDF", "PROBABILITY_GRID"):
        builder = OptimizingLocalTrajectoryBuilder(replace_deep(make_options(), {"submaps.grid_type": grid_type}))
        results = drive_ct(builder, duration=3.0, speed=0.2, odom_noise=0.002, seed=0)
        errs = [float(np.linalg.norm(r.local_pose.t - gt_pose(r.time)[0])) for r in results[2:]]
        print(json.dumps({"grid_type": grid_type, "results": len(results), "max_error": max(errs)}), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batched", action="store_true", help="the batched constraint search (phase 12)")
    parser.add_argument("--probability", action="store_true",
                        help="the default PROBABILITY_GRID submaps in place of TSDF (with --batched, phase 13)")
    parser.add_argument("--storage", choices=("float16", "bfloat16"), default=None,
                        help="the TSDF submaps' grid_storage_dtype (with --batched, phase 14)")
    parser.add_argument("--runs", type=int, default=2)
    parser.add_argument("--ct-drift", action="store_true",
                        help="the CT front end's drift on either grid type instead (ROADMAP C15)")
    opts = parser.parse_args()
    if opts.ct_drift:
        ct_drift()
        return 0
    for _ in range(opts.runs):
        print(json.dumps(dict(run(opts.batched, opts.probability, opts.storage), batched=opts.batched,
                              probability=opts.probability, storage=opts.storage)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
