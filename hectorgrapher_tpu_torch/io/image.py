"""Minimal image output: PNG encoding and grayscale canvases (counterpart
of hectorgrapher_tpu/io/image.py).

(ref: cartographer/io/image.{h,cc} — cairo-backed surfaces used by the
X-ray and probability-grid writers. No cairo here: a dependency-free PNG
encoder over numpy arrays.)
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png(path: str, image: np.ndarray) -> None:
    """Write (H, W) grayscale or (H, W, 3) RGB uint8 image as PNG."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        image = np.clip(image, 0, 255).astype(np.uint8)
    if image.ndim == 2:
        color_type = 0  # grayscale
        raw = image[:, :, None]
    elif image.ndim == 3 and image.shape[2] == 3:
        color_type = 2  # RGB
        raw = image
    else:
        raise ValueError(f"unsupported image shape {image.shape}")
    h, w = raw.shape[:2]

    # Filter byte 0 per scanline.
    scanlines = b"".join(b"\x00" + raw[y].tobytes() for y in range(h))
    compressed = zlib.compress(scanlines, 6)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", compressed)
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)


def probability_grid_to_image(grid) -> np.ndarray:
    """Render a 2D occupancy grid like the reference's submap images:
    occupied dark, free light, unknown mid-gray
    (ref: io/probability_grid_points_processor.cc color mapping). The grid
    is read on its device (uint16 codes decoded first), then brought to
    the host."""
    from hectorgrapher_tpu_torch.mapping.grids import ensure_f32_grid

    grid = ensure_f32_grid(grid)  # finished submaps may be uint16-quantized
    prob = grid.probability().cpu().numpy()
    known = grid.known.cpu().numpy()
    img = np.full(prob.shape, 128, np.uint8)
    img[known] = (255.0 * (1.0 - prob[known])).astype(np.uint8)
    return img.T[::-1]  # x right, y up
