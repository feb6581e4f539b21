"""Poses as tensors (counterpart of hectorgrapher_tpu/transform/rigid.py;
ref: transform/rigid_transform.h Rigid2<T>/Rigid3<T>, transform/transform.h).

Conventions, as in the JAX package:
  * Quaternions are (..., 4) tensors in (w, x, y, z) order, normalized.
  * Rigid3(translation=(..., 3), rotation=(..., 4)) acts as x -> R(q) x + t.
  * Rigid2(translation=(..., 2), angle=(...,)).
  * Tangent/rotation vectors are angle-axis (..., 3).

Every product and sum below is its own tensor op, so each rounds on its
own: no fused multiply-add, on the CPU or the card. The CT scan-block
kernel (csrc/ct_scan_block.cu) floors world coordinates computed the same
way, and its plain version must pick the same cells (ROADMAP C0).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Rigid2(NamedTuple):
    """SE(2) pose: translation (..., 2) and angle (...,), float32."""

    translation: torch.Tensor
    angle: torch.Tensor


def rot2(angle, v):
    """Rotate 2D vectors (..., 2) by angles, broadcasting."""
    c, s = torch.cos(angle), torch.sin(angle)
    x, y = v[..., 0], v[..., 1]
    return torch.stack([c * x - s * y, s * x + c * y], dim=-1)


# ---------------------------------------------------------------------------
# Quaternion ops (w, x, y, z)
# ---------------------------------------------------------------------------


def cross(a, b):
    """a x b over the last axis, broadcasting; a1*b2 - a2*b1 etc., each
    product rounded on its own."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def quat_normalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_conjugate(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_multiply(a, b):
    """Hamilton product a*b, batched."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_rotate(q, v):
    """Rotate vectors v (..., 3) by quaternions q (..., 4), broadcasting.

    The 15-mul form: v' = v + 2*(w*(u x v) + u x (u x v)).
    """
    u = q[..., 1:]
    w = q[..., :1]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def quat_from_axis_angle(aa):
    """Exponential map: angle-axis (..., 3) -> quaternion, with the Taylor
    branch near zero (ref: transform.h AngleAxisVectorToRotationQuaternion)."""
    angle_sq = torch.sum(aa * aa, dim=-1, keepdim=True)
    angle = torch.sqrt(torch.clamp(angle_sq, min=1e-24))
    half = 0.5 * angle
    small = angle_sq < 1e-12
    # sin(x/2)/x -> 1/2 - x^2/48 as x -> 0
    k = torch.where(small, 0.5 - angle_sq / 48.0, torch.sin(half) / angle)
    w = torch.where(small, 1.0 - angle_sq / 8.0, torch.cos(half))
    return torch.cat([w, k * aa], dim=-1)


def quat_to_axis_angle(q):
    """Log map: quaternion (..., 4) -> angle-axis (..., 3), angle in [0, pi],
    with the small-angle branch 2 v / w below |v| = 1e-8, as the JAX
    version selects it."""
    q = torch.where(q[..., :1] < 0, -q, q)  # the short way around
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    vec = q[..., 1:]
    sin_half = torch.linalg.vector_norm(vec, dim=-1)
    angle = 2.0 * torch.atan2(sin_half, w)
    small = sin_half < 1e-8
    scale = torch.where(small, 2.0 / torch.clamp(w, min=1e-12), angle / torch.clamp(sin_half, min=1e-24))
    return scale[..., None] * vec


def skew(v):
    """[v]x (..., 3, 3), so that skew(a) @ b = a x b."""
    zero = torch.zeros_like(v[..., 0])
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([torch.stack([zero, -z, y], dim=-1), torch.stack([z, zero, -x], dim=-1),
                        torch.stack([-y, x, zero], dim=-1)], dim=-2)


def quat_left_matrix(p):
    """L(p) (..., 4, 4): p q = L(p) q."""
    w, x, y, z = p.unbind(-1)
    return torch.stack([torch.stack([w, -x, -y, -z], -1), torch.stack([x, w, -z, y], -1),
                        torch.stack([y, z, w, -x], -1), torch.stack([z, -y, x, w], -1)], -2)


def quat_right_matrix(q):
    """R(q) (..., 4, 4): p q = R(q) p."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([torch.stack([w, -x, -y, -z], -1), torch.stack([x, w, z, -y], -1),
                        torch.stack([y, -z, w, x], -1), torch.stack([z, y, -x, w], -1)], -2)


def quat_to_rotation_matrix(q):
    """R(q) (..., 3, 3), column k = R e_k."""
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    return torch.stack([quat_rotate(q, eye[k].expand(q.shape[:-1] + (3,))) for k in range(3)], dim=-1)


def inverse_right_jacobian(phi):
    """Jr^-1(phi) (..., 3, 3) of SO(3), d log(exp(phi) exp(d)) / dd at d = 0:
    I + [phi]x / 2 + c [phi]x^2 with c = 1 / t^2 - (1 + cos t) / (2 t sin t),
    t = |phi|, by its Taylor series below t = 0.1 (the closed form cancels
    in f32 there)."""
    t2 = torch.sum(phi * phi, dim=-1)
    t = torch.sqrt(t2)
    big = t > 0.1
    tb = torch.where(big, t, 1.0)
    c = torch.where(big, 1.0 / (tb * tb) - (1.0 + torch.cos(tb)) / (2.0 * tb * torch.sin(tb)),
                    1.0 / 12.0 + t2 / 720.0 + t2 * t2 / 30240.0)
    k = skew(phi)
    return torch.eye(3, dtype=phi.dtype, device=phi.device) + 0.5 * k + c[..., None, None] * (k @ k)


def quat_from_yaw(yaw):
    """Rotation by `yaw` (...,) about z: (..., 4)."""
    half = 0.5 * yaw
    zeros = torch.zeros_like(half)
    return torch.stack([torch.cos(half), zeros, zeros, torch.sin(half)], dim=-1)


def quat_angle(q):
    """Rotation angle in [0, pi] (ref: transform.h GetAngle)."""
    w = torch.abs(q[..., 0])
    sin_half = torch.linalg.vector_norm(q[..., 1:], dim=-1)
    return 2.0 * torch.atan2(sin_half, torch.clamp(w, 0.0, 1.0))


def quat_slerp(a, b, t):
    """Spherical linear interpolation, batched; t broadcastable to the batch.

    Below sin(theta) = 1e-6 it blends linearly; the where() keeps the
    slerp branch's tangents (infinite at theta = 0) out of forward-mode
    Jacobians, as jnp.where does in the JAX package.
    """
    if not isinstance(t, torch.Tensor):
        t = torch.tensor(t, dtype=a.dtype, device=a.device)
    t = t[..., None]
    dot = torch.sum(a * b, dim=-1, keepdim=True)
    b = torch.where(dot < 0, -b, b)
    dot = torch.abs(dot)
    dot = torch.clamp(dot, -1.0, 1.0)
    theta = torch.arccos(torch.clamp(dot, 0.0, 1.0))
    sin_theta = torch.sin(theta)
    use_lerp = sin_theta < 1e-6
    denom = torch.where(use_lerp, torch.ones_like(sin_theta), sin_theta)
    wa = torch.where(use_lerp, 1.0 - t, torch.sin((1.0 - t) * theta) / denom)
    wb = torch.where(use_lerp, t, torch.sin(t * theta) / denom)
    return quat_normalize(wa * a + wb * b)


def quat_to_matrix(q):
    """Quaternion (..., 4) -> rotation matrix (..., 3, 3) from its entries
    (rigid.py quat_to_matrix :133-151)."""
    w, x, y, z = q.unbind(-1)
    rows = [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def matrix_to_quat(m):
    """Rotation matrix (..., 3, 3) -> quaternion (..., 4), branch-free
    (rigid.py matrix_to_quat :154-181): of four unnormalized candidates,
    the one with the largest pivot (the first of equal ones), normalized."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
    pivots = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1)
    best = torch.argmax(pivots, dim=-1)[..., None]
    q = torch.where(best == 0, qw, torch.where(best == 1, qx, torch.where(best == 2, qy, qz)))
    return quat_normalize(q)


# ---------------------------------------------------------------------------
# Rigid3
# ---------------------------------------------------------------------------


class Rigid3(NamedTuple):
    """SE(3) pose: x -> R(rotation) x + translation."""

    translation: torch.Tensor  # (..., 3)
    rotation: torch.Tensor  # (..., 4) wxyz


def compose(a: Rigid3, b: Rigid3) -> Rigid3:
    """a * b (apply b first, then a)."""
    return Rigid3(
        translation=quat_rotate(a.rotation, b.translation) + a.translation,
        rotation=quat_normalize(quat_multiply(a.rotation, b.rotation)),
    )


def inverse(p: Rigid3) -> Rigid3:
    inv_rot = quat_conjugate(p.rotation)
    return Rigid3(translation=-quat_rotate(inv_rot, p.translation), rotation=inv_rot)


def apply(p: Rigid3, points):
    """Apply the pose to points (..., 3); pose batch dims broadcast against
    the points' leading dims."""
    q, t = p.rotation, p.translation
    if points.ndim > q.ndim:
        q, t = q[..., None, :], t[..., None, :]
    return quat_rotate(q, points) + t


def log(p: Rigid3):
    """SE(3)-as-product log: [translation, angle-axis] (..., 6) (rigid.py
    :244-246)."""
    return torch.cat([p.translation, quat_to_axis_angle(p.rotation)], dim=-1)


def exp(xi) -> Rigid3:
    """Inverse of `log` (the product manifold, not the true SE(3) exp;
    rigid.py :249-251)."""
    return Rigid3(translation=xi[..., :3], rotation=quat_from_axis_angle(xi[..., 3:]))
