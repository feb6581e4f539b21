"""K6: the pair residuals and cloud poses of a CT window solve's LM
assembly.

Replaces the eager forward-mode chains of
hectorgrapher_tpu_torch/mapping/ct/window_solver.py, pair_residuals_plain
and cloud_poses_plain, which are this kernel's plain twins (the JAX
package takes these Jacobians with jax.jacfwd inside an XLA fusion,
window_solver.py :488 and :566; no Pallas source). The CUDA kernel is
hectorgrapher_tpu_torch/csrc/ct_pair_block.cu; this module holds its
wrapper. window_solver.pair_residuals and window_solver.cloud_poses call
it for CUDA tensors and run the twins for CPU tensors.

ct_pair_residuals: (r (..., K-1, 15), J (..., K-1, 15, 18)), the live
preintegration IMU and the odometry residuals of each control-point pair
and their Jacobian on the pair tangent, as pair_residuals_plain without
`direct` returns them. ct_cloud_poses: (pose7 (..., C, 7), dpose7 (...,
C, 7, 18)), as cloud_poses_plain returns them. A leading window axis B on
every leaf of the state and the problem (the batched solve) gives each
output the same leading axis; the weights are shared.

The kernel reads the state, the problem and the weights where they lie:
the CtWeights scalars are read on the device, so a call adds no host
sync, and a call is one launch, whatever B. Its outputs agree with the
twins' to rounding, not bit for bit (csrc/ct_pair_block.cu says where
the arithmetic differs).
"""

from __future__ import annotations

import torch

from hectorgrapher_tpu_torch.ops import _build
from hectorgrapher_tpu_torch.ops.correlative_prep_2d import _check


def _outputs(out, lead, n: int, rows: int, device, names):
    """(values (*lead, n, rows), Jacobian (*lead, n, rows, 18)) f32: the
    caller's buffers `out`, checked, or both in one new allocation."""
    shapes = (lead + (n, rows), lead + (n, rows, 18))
    if out is None:
        flat = torch.empty(torch.Size(lead).numel() * n * rows * 19, dtype=torch.float32, device=device)
        split = flat.numel() // 19
        return flat[:split].view(shapes[0]), flat[split:].view(shapes[1])
    for name, x, shape in zip(names, out, shapes):
        _check(name, x, torch.float32, shape, device)
    return tuple(out)


def _weight(name, w, device):
    """The device pointer of a CtWeights scalar: one f32 on `device`."""
    if not torch.is_tensor(w) or w.numel() != 1:
        raise TypeError(f"{name} must be a one-element tensor on the device, got {type(w).__name__}")
    _check(name, w.reshape(()), torch.float32, (), device)
    return w.data_ptr()


def ct_pair_residuals(state, problem, weights, out=None):
    """K6's pair residuals: (r (..., K-1, 15), J (..., K-1, 15, 18)) f32.

    state: a CtState (translation (..., K, 3), rotation (..., K, 4),
    velocity (..., K, 3)); problem: a CtProblem (its pair fields: pair_dt,
    pair_mask, imu_delta_rotation, odom_mask, odom_delta_translation,
    odom_delta_rotation, odom_translation_weight, odom_rotation_weight;
    masks bool); weights: a CtWeights of one-element f32 tensors; out:
    optional (r, J) buffers of those shapes. CUDA tensors only."""
    t = state.translation.contiguous()
    device = t.device
    lead, k = tuple(t.shape[:-2]), t.shape[-2]
    r, J = _outputs(out, lead, k - 1, 15, device, ("r", "J"))
    if device.type != "cuda":
        raise ValueError(f"ct_pair_residuals: unsupported device {device}")
    if k < 2:
        raise ValueError(f"ct_pair_residuals: unsupported K={k}")
    q, v = state.rotation.contiguous(), state.velocity.contiguous()
    pairs = lead + (k - 1,)
    fields = {
        "pair_dt": (problem.pair_dt, torch.float32, pairs),
        "pair_mask": (problem.pair_mask, torch.bool, pairs),
        "imu_delta_rotation": (problem.imu_delta_rotation, torch.float32, pairs + (4,)),
        "odom_mask": (problem.odom_mask, torch.bool, pairs),
        "odom_delta_translation": (problem.odom_delta_translation, torch.float32, pairs + (3,)),
        "odom_delta_rotation": (problem.odom_delta_rotation, torch.float32, pairs + (4,)),
        "odom_translation_weight": (problem.odom_translation_weight, torch.float32, pairs),
        "odom_rotation_weight": (problem.odom_rotation_weight, torch.float32, pairs),
    }
    _check("translation", t, torch.float32, lead + (k, 3), device)
    _check("rotation", q, torch.float32, lead + (k, 4), device)
    _check("velocity", v, torch.float32, lead + (k, 3), device)
    ptrs = []
    for name, (x, dtype, shape) in fields.items():
        x = x.contiguous()
        _check(name, x, dtype, shape, device)
        ptrs.append(x.data_ptr())
    w = [_weight(name, getattr(weights, name), device)
         for name in ("translation_weight", "velocity_weight", "rotation_weight")]
    n = r.numel() // 15
    if n >= 2**31 // 270:
        raise ValueError(f"ct_pair_residuals: unsupported {n} pairs")
    _build.launch("hg_ct_pair_residuals", device, t.data_ptr(), q.data_ptr(), v.data_ptr(), *ptrs, *w,
                  r.data_ptr(), J.data_ptr(), n, k)
    return r, J


def ct_cloud_poses(state, problem, out=None):
    """K6's cloud poses: (pose7 (..., C, 7), dpose7 (..., C, 7, 18)) f32.

    state: a CtState (translation (..., K, 3), rotation (..., K, 4));
    problem: anything with cloud_prev, cloud_next ((..., C) int32 or
    int64, each window's own control-point indices) and cloud_factor
    ((..., C) f32); out: optional (pose7, dpose7) buffers of those shapes.
    CUDA tensors only."""
    t = state.translation.contiguous()
    device = t.device
    lead, k = tuple(t.shape[:-2]), t.shape[-2]
    c = problem.cloud_factor.shape[-1]
    pose7, dpose7 = _outputs(out, lead, c, 7, device, ("pose7", "dpose7"))
    if device.type != "cuda":
        raise ValueError(f"ct_cloud_poses: unsupported device {device}")
    if k < 2 or c < 1:
        raise ValueError(f"ct_cloud_poses: unsupported K={k}, C={c}")
    q = state.rotation.contiguous()
    prev, nxt, factor = (x.contiguous() for x in (problem.cloud_prev, problem.cloud_next, problem.cloud_factor))
    _check("translation", t, torch.float32, lead + (k, 3), device)
    _check("rotation", q, torch.float32, lead + (k, 4), device)
    idx = prev.dtype
    if idx not in (torch.int32, torch.int64):
        raise TypeError(f"cloud_prev has dtype {idx}, expected torch.int32 or torch.int64")
    _check("cloud_prev", prev, idx, lead + (c,), device)
    _check("cloud_next", nxt, idx, lead + (c,), device)
    _check("cloud_factor", factor, torch.float32, lead + (c,), device)
    n = pose7.numel() // 7
    if n >= 2**31 // 126:
        raise ValueError(f"ct_cloud_poses: unsupported {n} clouds")
    _build.launch("hg_ct_cloud_poses", device, t.data_ptr(), q.data_ptr(), prev.data_ptr(), nxt.data_ptr(),
                  factor.data_ptr(), pose7.data_ptr(), dpose7.data_ptr(), n, c, k, int(idx == torch.int64))
    return pose7, dpose7
