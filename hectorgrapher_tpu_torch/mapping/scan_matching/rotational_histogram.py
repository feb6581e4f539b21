"""Rotational scan-matcher histogram of a cloud (counterpart of
compute_histogram in hectorgrapher_tpu/mapping/scan_matching/
rotational_histogram.py; ref: cartographer/mapping/internal/3d/
scan_matching/rotational_scan_matcher.cc).

The scan is sliced by z (0.2 m slices); within each slice points are
sorted by angle around the slice centroid; each consecutive pair of kept
points contributes the angle of its 2D delta (folded to [0, pi)) with
weight max(0, 1 - |delta_hat . direction_hat|), unless the pair is too
close (< 0.2 m), the point too close to the centroid (< 0.2 m), or the gap
too large (> 0.9 m). One pass of stable sorts and segment sums over the
padded cloud, in the JAX package's order.
"""

from __future__ import annotations

import math

import torch

MIN_DISTANCE = 0.2
MAX_DISTANCE = 0.9
SLICE_HEIGHT = 0.2
_SENTINEL = 1 << 24


def _lexsort(minor, major):
    """Stable order by (major, minor), as jnp.lexsort((minor, major))."""
    order = torch.sort(minor, stable=True).indices
    return order[torch.sort(major[order], stable=True).indices]


def _roll1(x):
    return torch.roll(x, 1, dims=0)


def compute_histogram(positions, mask, histogram_size: int = 120):
    """Histogram of a padded cloud in the gravity-aligned frame.

    positions: (N, 3) f32; mask: (N,) bool. Returns (histogram_size,) f32.
    """
    n = positions.shape[0]
    device = positions.device
    z_slice = torch.floor(positions[:, 2] / SLICE_HEIGHT).to(torch.int32)
    z_slice = torch.where(mask, z_slice, _SENTINEL)

    # Compact slice ids: rank the slice keys.
    order0 = torch.sort(z_slice, stable=True).indices
    sorted_slices = z_slice[order0]
    new_slice_start = torch.cat(
        [torch.ones(1, dtype=torch.bool, device=device), sorted_slices[1:] != sorted_slices[:-1]]
    )
    compact_id_sorted = torch.cumsum(new_slice_start.to(torch.int64), dim=0) - 1
    compact_id = torch.empty(n, dtype=torch.int64, device=device)
    compact_id[order0] = compact_id_sorted

    valid = mask
    w = valid.to(torch.float32)
    sums = torch.zeros((n, 3), dtype=torch.float32, device=device).index_add_(0, compact_id, positions * w[:, None])
    counts = torch.zeros(n, dtype=torch.float32, device=device).index_add_(0, compact_id, w)
    centroids = sums / torch.clamp(counts, min=1.0)[:, None]
    centroid_per_point = centroids[compact_id]

    # Sort points within their slice by angle around the slice centroid;
    # points too close to the centroid are dropped (ref SortSlice).
    delta_c = positions[:, :2] - centroid_per_point[:, :2]
    angle_around = torch.atan2(delta_c[:, 1], delta_c[:, 0])
    near_centroid = torch.linalg.vector_norm(delta_c, dim=-1) < MIN_DISTANCE
    valid = valid & ~near_centroid

    sort_key_angle = torch.where(valid, angle_around, 1e9)
    order = _lexsort(sort_key_angle, torch.where(valid, compact_id, _SENTINEL))
    p_sorted = positions[order]
    v_sorted = valid[order]
    s_sorted = torch.where(valid, compact_id, -1)[order]
    c_sorted = centroid_per_point[order]

    # Keep the first point of each ~MIN_DISTANCE bucket of arc length
    # within a slice, then pair consecutive kept points.
    not_first = torch.arange(n, device=device) > 0  # roll wraps row 0 onto row N-1
    step = torch.linalg.vector_norm(p_sorted[:, :2] - _roll1(p_sorted[:, :2]), dim=-1)
    same_slice_step = (s_sorted == _roll1(s_sorted)) & v_sorted & _roll1(v_sorted) & not_first
    step = torch.where(same_slice_step, step, 0.0)
    cum = torch.cumsum(step, dim=0)
    slice_start_cum = torch.where(same_slice_step, 0.0, cum)
    start_marker = torch.cummax(slice_start_cum, dim=0).values
    arc = cum - start_marker
    bucket = torch.floor(arc / MIN_DISTANCE).to(torch.int32)
    key_change = torch.cat(
        [torch.ones(1, dtype=torch.bool, device=device), (bucket[1:] != bucket[:-1]) | (s_sorted[1:] != s_sorted[:-1])]
    )
    kept = key_change & v_sorted

    # Bring each slice's kept points together, in angle order.
    order2 = _lexsort(sort_key_angle[order], torch.where(kept, s_sorted, _SENTINEL))
    p2 = p_sorted[order2]
    s2 = torch.where(kept, s_sorted, -1)[order2]
    c2 = c_sorted[order2]
    k2 = kept[order2]

    same_slice = (s2 == _roll1(s2)) & k2 & _roll1(k2) & not_first
    delta = (p2 - _roll1(p2))[:, :2]
    direction = (p2 - c2)[:, :2]
    dist = torch.linalg.vector_norm(delta, dim=-1)
    dnorm = torch.linalg.vector_norm(direction, dim=-1)
    ok = same_slice & (dist >= MIN_DISTANCE) & (dist <= MAX_DISTANCE) & (dnorm >= MIN_DISTANCE)

    angle = torch.remainder(torch.atan2(delta[:, 1], delta[:, 0]), math.pi)  # fold to [0, pi)
    value = torch.clamp(
        1.0 - torch.abs(torch.sum(delta * direction, dim=-1) / torch.clamp(dist * dnorm, min=1e-9)), min=0.0
    )
    bucket = torch.clamp(torch.round(histogram_size * angle / math.pi - 0.5).to(torch.int64), 0, histogram_size - 1)
    hist = torch.zeros(histogram_size + 1, dtype=torch.float32, device=device)
    hist.index_add_(0, torch.where(ok, bucket, histogram_size), torch.where(ok, value, 0.0))
    return hist[:histogram_size]


def rotate_histogram(histogram, angle):
    """The histogram (size,) rotated by each angle (A,), with linear
    interpolation between buckets (ref: rotational_scan_matcher.cc
    RotateHistogram): (A, size)."""
    size = histogram.shape[-1]
    rotate_by_buckets = -angle * size / math.pi
    full = torch.floor(rotate_by_buckets).to(torch.int64)
    frac = (rotate_by_buckets - full)[..., None]
    idx = torch.remainder(torch.arange(size, device=histogram.device) + full[..., None], size)
    idx2 = torch.remainder(idx + 1, size)
    return (1.0 - frac) * histogram[idx] + frac * histogram[idx2]


def match_histograms(submap_histogram, scan_histogram, angles):
    """Cosine similarity of the scan histogram rotated by each angle (A,)
    against the submap histogram; 1 where either histogram is empty."""
    rotated = rotate_histogram(scan_histogram, angles)
    norm = torch.linalg.vector_norm(rotated, dim=-1) * torch.linalg.vector_norm(submap_histogram)
    scores = (rotated @ submap_histogram) / torch.clamp(norm, min=1e-3)
    return torch.where(norm < 1e-3, 1.0, scores)
