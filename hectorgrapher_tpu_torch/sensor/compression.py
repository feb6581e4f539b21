"""Lossy point-cloud compression by block quantization (a host-only copy
of hectorgrapher_tpu/sensor/compression.py).

(ref: cartographer/sensor/compressed_point_cloud.{h,cc} — points encoded
on a 1 mm grid; grouped into 2^10-cell blocks; each point stored as one
int32 with 10 bits per coordinate relative to its block origin; per-block
header = count + 3 block coordinates.)

Vectorized numpy implementation producing the same precision trade-off
(float -> 1 mm grid) with the same block layout.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

PRECISION = 0.001  # meters (ref kPrecision)
BITS_PER_COORDINATE = 10  # ref kBitsPerCoordinate
COORDINATE_MASK = (1 << BITS_PER_COORDINATE) - 1
MAX_BITS_PER_DIRECTION = 23


def compress(points: np.ndarray) -> Tuple[np.ndarray, int]:
    """Compress (N, 3) float points -> (int32 stream, num_points)."""
    points = np.asarray(points, np.float64)
    n = len(points)
    if n == 0:
        return np.zeros(0, np.int32), 0
    grid = np.round(points / PRECISION).astype(np.int64)
    assert np.all(np.abs(grid) < (1 << MAX_BITS_PER_DIRECTION)), "point out of range"
    block = grid >> BITS_PER_COORDINATE
    local = (grid & COORDINATE_MASK).astype(np.int64)
    encoded = (
        local[:, 0] | (local[:, 1] << BITS_PER_COORDINATE) | (local[:, 2] << (2 * BITS_PER_COORDINATE))
    )

    # Group by block (sorted; stable order within block).
    order = np.lexsort((block[:, 2], block[:, 1], block[:, 0]))
    block_s = block[order]
    encoded_s = encoded[order]
    new_block = np.ones(n, bool)
    new_block[1:] = np.any(block_s[1:] != block_s[:-1], axis=1)
    starts = np.flatnonzero(new_block)
    counts = np.diff(np.append(starts, n))

    stream = []
    for s, c in zip(starts, counts):
        stream.extend([int(c), int(block_s[s, 0]), int(block_s[s, 1]), int(block_s[s, 2])])
        stream.extend(int(v) for v in encoded_s[s : s + c])
    return np.asarray(stream, np.int32), n


def decompress(stream: np.ndarray, num_points: int) -> np.ndarray:
    """Inverse of compress -> (N, 3) float32 on the 1 mm grid."""
    out = np.zeros((num_points, 3), np.float32)
    i = 0
    p = 0
    stream = np.asarray(stream, np.int64)
    while p < num_points:
        count = int(stream[i])
        bx, by, bz = (int(stream[i + 1]), int(stream[i + 2]), int(stream[i + 3]))
        i += 4
        enc = stream[i : i + count]
        i += count
        x = (bx << BITS_PER_COORDINATE) + (enc & COORDINATE_MASK)
        y = (by << BITS_PER_COORDINATE) + ((enc >> BITS_PER_COORDINATE) & COORDINATE_MASK)
        z = (bz << BITS_PER_COORDINATE) + (enc >> (2 * BITS_PER_COORDINATE))
        out[p : p + count, 0] = x * PRECISION
        out[p : p + count, 1] = y * PRECISION
        out[p : p + count, 2] = z * PRECISION
        p += count
    return out
