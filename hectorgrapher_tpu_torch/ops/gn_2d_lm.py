"""K7: the whole Levenberg-Marquardt solve of the 2D scan matcher's
Gauss-Newton refinement, for B lanes in one launch.

Replaces the eager loop of
hectorgrapher_tpu_torch/mapping/scan_matching/gn_2d.py, _lm_rows_plain,
which is this kernel's plain twin (the JAX package runs it as a
jax.lax.while_loop in XLA, gn_2d.py :82-219; no Pallas source). The CUDA
kernel is hectorgrapher_tpu_torch/csrc/gn_2d_lm.cu; this module holds its
wrapper. gn_2d._lm_grid_2d gathers the wide rows once, as before, and
calls it for CUDA tensors; CPU tensors run the twin.

gn_2d_lm takes the twin's inputs: the wide rows (a tuple of one plane for
the occupied-space cost, or two, tsd and weight, for the TSDF cost), the
base cells, the points, their mask, the per-lane scale, grid corner and
resolution, the initial pose and the translation target, the weights, the
iteration limit and the LM constants. It returns (pose (B, 3) f32 as tx,
ty, theta; cost (B,) f32; iterations (B,) int32, the iterations each lane
ran). A call is one launch and reads nothing back to the host; its
results agree with the twin's to rounding, not bit for bit
(csrc/gn_2d_lm.cu says where the arithmetic differs), and each lane's
result does not depend on the other lanes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from hectorgrapher_tpu_torch.ops import _build
from hectorgrapher_tpu_torch.ops.correlative_prep_2d import _check


def _squared(w: float) -> float:
    """w^2 as the twin takes it: w rounded to f32, then squared in f32."""
    w = np.float32(w)
    return float(w * w)


def gn_2d_lm(rows, base, min_corner, res, pts, valid, scale, pose0, target, translation_weight: float,
             rotation_weight: float, num_iterations: int, init_lambda: float = 1e-4, min_lambda: float = 1e-10,
             max_lambda: float = 1e6, function_tolerance: float = 1e-6):
    """K7's solve: (pose (B, 3), cost (B,), iterations (B,) int32).

    rows: a tuple of one or two (B, N, W*W) f32 planes (W = 4 + 2 * slack);
    base, pts (B, N, 2) f32; valid (B, N) bool; scale, res (B,) f32;
    min_corner (B, 2) f32; pose0 (B, 3) f32 (tx, ty, theta); target (B, 2)
    f32; all contiguous, on one CUDA device. The weights and constants are
    Python numbers. Counts its launches in gn_2d_lm.launches."""
    if not isinstance(rows, tuple) or len(rows) not in (1, 2):
        raise ValueError(f"gn_2d_lm: rows must be a tuple of one or two planes, got {type(rows).__name__} "
                         f"of {len(rows) if isinstance(rows, tuple) else '?'}")
    device = rows[0].device
    if device.type != "cuda":
        raise ValueError(f"gn_2d_lm: unsupported device {device}")
    if rows[0].dim() != 3:
        raise ValueError(f"gn_2d_lm: rows must be (B, N, W*W), got shape {tuple(rows[0].shape)}")
    b, n, w2 = rows[0].shape
    w = math.isqrt(w2)
    if w * w != w2 or w < 4 or b < 1 or n < 1:
        raise ValueError(f"gn_2d_lm: unsupported rows of shape {tuple(rows[0].shape)}")
    for name, x in zip(("rows", "weight rows"), rows):
        _check(name, x, torch.float32, (b, n, w2), device)
    for name, x, dtype, shape in (("base", base, torch.float32, (b, n, 2)), ("pts", pts, torch.float32, (b, n, 2)),
                                  ("valid", valid, torch.bool, (b, n)), ("scale", scale, torch.float32, (b,)),
                                  ("min_corner", min_corner, torch.float32, (b, 2)),
                                  ("res", res, torch.float32, (b,)), ("pose0", pose0, torch.float32, (b, 3)),
                                  ("target", target, torch.float32, (b, 2))):
        _check(name, x, dtype, shape, device)
    if num_iterations < 0 or b * n * w2 >= 2**31:
        raise ValueError(f"gn_2d_lm: unsupported num_iterations={num_iterations} or {b * n} slots")
    out = rows[0].new_empty(4 * b)
    pose, cost = out[:3 * b].view(b, 3), out[3 * b:]
    iterations = rows[0].new_empty(b, dtype=torch.int32)
    weight = rows[1].data_ptr() if len(rows) == 2 else None
    _build.launch("hg_gn_2d_lm", device, rows[0].data_ptr(), weight, base.data_ptr(), pts.data_ptr(),
                  valid.data_ptr(), scale.data_ptr(), min_corner.data_ptr(), res.data_ptr(), pose0.data_ptr(),
                  target.data_ptr(), pose.data_ptr(), cost.data_ptr(), iterations.data_ptr(), b, n, w,
                  int(num_iterations), _squared(translation_weight), _squared(rotation_weight), init_lambda,
                  min_lambda, max_lambda, function_tolerance)
    gn_2d_lm.launches += 1
    return pose, cost, iterations


gn_2d_lm.launches = 0
