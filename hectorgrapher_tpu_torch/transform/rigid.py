"""SE(2) poses as tensors (counterpart of hectorgrapher_tpu/transform/rigid.py,
2D part only; ref: transform/rigid_transform.h Rigid2<T>)."""

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
