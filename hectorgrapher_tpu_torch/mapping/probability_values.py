"""Occupancy probability math (counterpart of
hectorgrapher_tpu/mapping/probability_values.py; ref:
cartographer/mapping/probability_values.h).

Grids store float32 log-odds plus a `known` mask: odds multiply ==
log-odds add, clamped to [0.1, 0.9] in probability.
"""

from __future__ import annotations

import math

import torch

MIN_PROBABILITY = 0.1
MAX_PROBABILITY = 1.0 - MIN_PROBABILITY

MIN_LOG_ODDS = math.log(MIN_PROBABILITY / (1.0 - MIN_PROBABILITY))
MAX_LOG_ODDS = math.log(MAX_PROBABILITY / (1.0 - MAX_PROBABILITY))


def log_odds(probability):
    return torch.log(probability) - torch.log1p(-probability)


def probability_from_log_odds(lo):
    # Spelled out as the JAX package writes it (not torch.sigmoid), so both
    # round the same way.
    return 1.0 / (1.0 + torch.exp(-lo))


def clamp_probability(p):
    return torch.clamp(p, MIN_PROBABILITY, MAX_PROBABILITY)


def clamp_log_odds(lo):
    return torch.clamp(lo, MIN_LOG_ODDS, MAX_LOG_ODDS)
