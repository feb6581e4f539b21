"""The JAX package's MapBuilder over chip_smoke.py's 3D SLAM drive, on the
CPU: the reference errors that chip_smoke.py holds phases 11 and 12 to.

    JAX_PLATFORMS=cpu python tests/jax_slam_reference.py [--batched] [--runs 2]

The drive (chip_smoke.slam_drive) and the options (chip_smoke.
slam_overrides, applied to the JAX package's MapBuilderOptions) are those
of the chip phase: serial constraint search, or with --batched the default
batched search (phase 12). Each run prints one JSON line with the counts
and errors of chip_smoke.slam_result; with the async work queue the
worker's timing against the front end moves the solves' starting poses,
so the constants chip_smoke.py records are the larger of each over the
runs. A full-width run holds a few GiB and takes tens of minutes.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from hectorgrapher_tpu.common.config import MapBuilderOptions, replace_deep  # noqa: E402
from hectorgrapher_tpu.mapping.map_builder import MapBuilder  # noqa: E402
from hectorgrapher_tpu.sensor.types import TimedPointCloud, TimedPointCloudData  # noqa: E402
from hectorgrapher_tpu.transform.np_quat import NpRigid3  # noqa: E402


def run(batched: bool) -> dict:
    mb = MapBuilder(replace_deep(MapBuilderOptions(), chip_smoke.slam_overrides(batched)))
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batched", action="store_true", help="the batched constraint search (phase 12)")
    parser.add_argument("--runs", type=int, default=2)
    opts = parser.parse_args()
    for _ in range(opts.runs):
        print(json.dumps(dict(run(opts.batched), batched=opts.batched)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
