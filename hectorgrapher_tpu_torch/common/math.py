"""Math helpers (counterpart of hectorgrapher_tpu/common/math.py; ref:
cartographer/common/math.h)."""

from __future__ import annotations

import math

import torch


def normalize_angle_difference(angle):
    """Wrap angles (tensor) to (-pi, pi] (ref: common/math.h
    NormalizeAngleDifference, whose while-loop form leaves +pi as is)."""
    two_pi = 2.0 * math.pi
    wrapped = angle - two_pi * torch.floor((angle + math.pi) / two_pi)
    # floor() puts the boundary at -pi; the reference keeps it at +pi.
    return torch.where(wrapped <= -math.pi, wrapped + two_pi, wrapped)
