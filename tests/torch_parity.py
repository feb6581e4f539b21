"""Shared inputs for the parity tests of hectorgrapher_tpu_torch against
hectorgrapher_tpu (tests/test_torch_*.py).

Inputs are made with numpy from a seed and built once with the JAX
package; convert.py carries them into the port. Everything runs on the
CPU, where the port's kernel wrappers take their plain PyTorch versions.
"""

from __future__ import annotations

import numpy as np
import torch

from hectorgrapher_tpu.common.config import ProbabilityGridRangeDataInserterOptions2D
from hectorgrapher_tpu.evaluation.scan_generator import raycast_rect_room_2d
from hectorgrapher_tpu.mapping.grids import make_probability_grid
from hectorgrapher_tpu.mapping.inserters_2d import make_probability_inserter_2d
from hectorgrapher_tpu.sensor.types import RangeData, pad_cloud

CPU = torch.device("cpu")


def room_grid_and_cloud(size=256, num_rays=720, capacity=1024, inserts=3):
    """A 0.05 m probability grid (JAX) built from `inserts` scans of a
    rectangular room seen from the origin, and that scan as a cloud."""
    import jax.numpy as jnp

    grid = make_probability_grid(0.05, (size, size))
    insert = make_probability_inserter_2d(
        ProbabilityGridRangeDataInserterOptions2D(), max_range=size * 0.05, resolution=0.05
    )
    half = size * 0.05 / 2
    pts = raycast_rect_room_2d(
        np.zeros(2), 0.0, half_width=0.8 * half, half_height=0.66 * half, num_rays=num_rays
    )
    pts = pts[~np.isnan(pts[:, 0])].astype(np.float32)
    cloud = pad_cloud(pts, capacity)
    rd = RangeData(
        origin=jnp.zeros(3, jnp.float32),
        returns=cloud,
        misses=pad_cloud(np.zeros((0, 3), np.float32), 8),
    )
    for _ in range(inserts):
        grid = insert(grid, rd)
    return grid, cloud, float(np.linalg.norm(pts[:, :2], axis=-1).max())


def perturbations(seed, b, lin=0.1, ang=0.05):
    """(B, 2) translations and (B,) angles, f32, uniform in +-lin / +-ang."""
    rng = np.random.default_rng(seed)
    offs = rng.uniform(-lin, lin, (b, 2)).astype(np.float32)
    angs = rng.uniform(-ang, ang, b).astype(np.float32)
    return offs, angs


def bf16_to_torch(x) -> torch.Tensor:
    """A JAX/ml_dtypes bfloat16 array as a torch bfloat16 tensor, bit for bit."""
    return torch.from_numpy(np.asarray(x).view(np.uint16).copy()).view(torch.bfloat16)
