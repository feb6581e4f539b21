"""Submap painting and trajectory drawing (counterpart of
hectorgrapher_tpu/io/drawing.py).

(ref: cartographer/io/submap_painter.{h,cc} — PaintSubmapSlices composites
per-submap cairo surfaces into one global map image; io/draw_trajectories.cc
strokes each trajectory's node chain on top; io/color.cc GetColor hands out
golden-ratio HSV colors per trajectory.)

No cairo here: slices are (intensity, alpha) numpy images and compositing
is a vectorized inverse-map resample per submap — every output pixel inside
a submap's footprint is pulled from the slice by bilinear interpolation and
alpha-blended with the cairo OVER operator the reference uses. A grid is
read on its device (uint16 codes decoded, half planes widened to f32; a 3D
grid projected over z there), and the images are painted on the host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3, quat_yaw

# (ref: io/submap_painter.cc PaintSubmapSlices kPaddingPixel)
PADDING_PIXELS = 5

# (ref: io/color.cc kInitialHue/kSaturation/kValue + GetColor)
_INITIAL_HUE = 0.69
_SATURATION = 0.85
_VALUE = 0.77
_GOLDEN_RATIO_CONJUGATE = 0.6180339887498949


def _hsv_to_rgb(h: float, s: float, v: float) -> Tuple[float, float, float]:
    h6 = 0.0 if h == 1.0 else 6.0 * h
    i = int(math.floor(h6))
    f = h6 - i
    p, q, t = v * (1 - s), v * (1 - f * s), v * (1 - (1 - f) * s)
    return [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)][i % 6]


def get_color(trajectory_id: int) -> Tuple[float, float, float]:
    """Distinct per-trajectory color via golden-ratio hue sampling
    (ref: io/color.cc GetColor:60-67)."""
    hue = math.fmod(_INITIAL_HUE + _GOLDEN_RATIO_CONJUGATE * trajectory_id, 1.0)
    return _hsv_to_rgb(hue, _SATURATION, _VALUE)


@dataclass
class SubmapSlice:
    """A rendered submap texture with enough geometry to place it globally
    (ref: submap_painter.h SubmapSlice — width/height/resolution +
    slice_pose, with pose folded in by the painter)."""

    intensity: np.ndarray  # (nx, ny) f32 in [0, 1]; 1 = free/light, 0 = occupied/dark
    alpha: np.ndarray  # (nx, ny) f32 in [0, 1]; 0 = unknown
    resolution: float
    min_corner: np.ndarray  # (2,) submap-frame position of cell (0, 0) corner
    global_pose: NpRigid3  # submap frame -> global frame


def _grid_images(grid) -> Tuple[np.ndarray, np.ndarray]:
    """Render one grid to (intensity, alpha) in its own cell layout. A 3D
    grid is projected over z on its device (max and any are exact, so the
    host images equal the JAX package's numpy projection)."""
    from hectorgrapher_tpu_torch.mapping.grids import ensure_f32_grid

    grid = ensure_f32_grid(grid)  # finished submaps may be uint16-quantized
    if hasattr(grid, "log_odds"):  # ProbabilityGrid
        prob = grid.probability().to(torch.float32)
        known = grid.known
        if prob.ndim == 3:  # 3D occupancy: project strongest evidence over z
            alpha = known.any(dim=2).cpu().numpy().astype(np.float32)
            prob = torch.where(known, prob, 0.0).amax(dim=2).cpu().numpy()
            return 1.0 - prob, alpha
        prob, known = prob.cpu().numpy(), known.cpu().numpy()
        intensity = 1.0 - prob
        # Match the reference's probability-grid alpha ramp: confident free
        # cells stay translucent so trajectories remain visible underneath
        # (ref: submap_2d.cc ToResponseProto alpha = odds-derived value).
        alpha = np.where(known, np.clip(2.0 * np.abs(prob - 0.5) + 0.35, 0.0, 1.0), 0.0)
        return intensity.astype(np.float32), alpha.astype(np.float32)
    # TSDF: surface cells (|tsd| small) dark, far cells light.
    tsd = grid.tsd.to(torch.float32)
    known = grid.weight.to(torch.float32) > 0.0
    trunc = float(grid.truncation_distance)
    if tsd.ndim == 3:
        alpha = known.any(dim=2).cpu().numpy().astype(np.float32)
        dist = torch.where(known, tsd.abs(), trunc).amin(dim=2).cpu().numpy()
    else:
        known = known.cpu().numpy()
        alpha = known.astype(np.float32)
        dist = np.where(known, np.abs(tsd.cpu().numpy()), trunc)
    intensity = np.clip(dist / max(trunc, 1e-6), 0.0, 1.0)
    return intensity.astype(np.float32), alpha


def submap_to_slice(submap, global_pose: NpRigid3) -> SubmapSlice:
    """Render a Submap2D or Submap3D into a SubmapSlice
    (ref: submap_painter.cc FillSubmapSlice — 3D submaps use the
    high-resolution grid's projection)."""
    grid = getattr(submap, "grid", None)
    if grid is None:  # Submap3D
        grid = submap.high_resolution_grid
    intensity, alpha = _grid_images(grid)
    return SubmapSlice(
        intensity=intensity,
        alpha=alpha,
        resolution=float(grid.meta.resolution),
        min_corner=grid.meta.min_corner.cpu().numpy().astype(np.float64)[:2],
        global_pose=global_pose,
    )


@dataclass
class PaintedMap:
    """(ref: submap_painter.h PaintSubmapSlicesResult)"""

    intensity: np.ndarray  # (H, W) f32 rows = +y down? No: row 0 = top (max y)
    alpha: np.ndarray  # (H, W) f32
    origin: np.ndarray  # (2,) pixel coords of global (0, 0): (col, row)
    resolution: float

    def pose_to_pixel(self, pose: NpRigid3) -> Tuple[int, int]:
        """Global pose -> (col, row) pixel (ref: draw_trajectories.h
        PoseToPixelFunction)."""
        x, y = float(pose.t[0]), float(pose.t[1])
        col = self.origin[0] + x / self.resolution
        row = self.origin[1] - y / self.resolution
        return int(round(col)), int(round(row))

    def to_rgb(self) -> np.ndarray:
        """Composite over the reference's dark-red unknown background
        (ref: submap_painter.cc cairo_set_source_rgba(0.5, 0, 0, 1))."""
        bg = np.array([0.5, 0.0, 0.0], np.float32)
        rgb = self.intensity[..., None] * self.alpha[..., None] + bg * (
            1.0 - self.alpha[..., None]
        )
        return (np.clip(rgb, 0.0, 1.0) * 255.0).astype(np.uint8)


def _slice_world_corners(s: SubmapSlice) -> np.ndarray:
    nx, ny = s.intensity.shape
    ext = np.array(
        [
            [0.0, 0.0],
            [nx * s.resolution, 0.0],
            [0.0, ny * s.resolution],
            [nx * s.resolution, ny * s.resolution],
        ]
    )
    local = s.min_corner[None, :] + ext
    yaw = quat_yaw(s.global_pose.q)
    c, sn = math.cos(yaw), math.sin(yaw)
    rot = np.array([[c, -sn], [sn, c]])
    return local @ rot.T + np.asarray(s.global_pose.t[:2])[None, :]


def paint_submap_slices(slices: Sequence[SubmapSlice], resolution: float) -> PaintedMap:
    """Composite slices into one global image at `resolution` m/px
    (ref: submap_painter.cc PaintSubmapSlices:72-119 — bounding-box pass,
    5 px padding, then OVER-composite each slice under its global pose).

    Rotation uses the pose's yaw projection, as the reference's 2D cairo
    matrix does with the full 3D pose's rotation block."""
    if not slices:
        return PaintedMap(
            intensity=np.ones((1, 1), np.float32),
            alpha=np.zeros((1, 1), np.float32),
            origin=np.zeros(2),
            resolution=resolution,
        )
    corners = np.concatenate([_slice_world_corners(s) for s in slices], axis=0)
    lo = corners.min(axis=0)
    hi = corners.max(axis=0)
    width = int(math.ceil((hi[0] - lo[0]) / resolution)) + 2 * PADDING_PIXELS
    height = int(math.ceil((hi[1] - lo[1]) / resolution)) + 2 * PADDING_PIXELS
    # origin: pixel of global (0,0); row 0 is the TOP of the image (max y).
    origin = np.array(
        [-lo[0] / resolution + PADDING_PIXELS, hi[1] / resolution + PADDING_PIXELS]
    )

    canvas_i = np.zeros((height, width), np.float32)
    canvas_a = np.zeros((height, width), np.float32)

    cols = (np.arange(width, dtype=np.float64) - origin[0]) * resolution
    rows = (origin[1] - np.arange(height, dtype=np.float64)) * resolution

    for s in slices:
        wc = _slice_world_corners(s)
        c0 = np.clip(
            np.floor((wc[:, 0].min() / resolution) + origin[0]).astype(int) - 1, 0, width
        )
        c1 = np.clip(
            np.ceil((wc[:, 0].max() / resolution) + origin[0]).astype(int) + 1, 0, width
        )
        r0 = np.clip(
            np.floor(origin[1] - (wc[:, 1].max() / resolution)).astype(int) - 1, 0, height
        )
        r1 = np.clip(
            np.ceil(origin[1] - (wc[:, 1].min() / resolution)).astype(int) + 1, 0, height
        )
        if c1 <= c0 or r1 <= r0:
            continue
        # World coords of the covered pixel centers.
        wx, wy = np.meshgrid(cols[c0:c1], rows[r0:r1])
        # Into the submap frame (inverse yaw + translation).
        yaw = quat_yaw(s.global_pose.q)
        cth, sth = math.cos(yaw), math.sin(yaw)
        dx = wx - float(s.global_pose.t[0])
        dy = wy - float(s.global_pose.t[1])
        lx = cth * dx + sth * dy - s.min_corner[0]
        ly = -sth * dx + cth * dy - s.min_corner[1]
        # Continuous cell coords (cell centers at index + 0.5).
        fx = lx / s.resolution - 0.5
        fy = ly / s.resolution - 0.5
        nx, ny = s.intensity.shape
        x0 = np.floor(fx).astype(int)
        y0 = np.floor(fy).astype(int)
        tx = (fx - x0).astype(np.float32)
        ty = (fy - y0).astype(np.float32)
        valid = (x0 >= -1) & (x0 < nx) & (y0 >= -1) & (y0 < ny)

        def samp(img, xi, yi):
            ok = (xi >= 0) & (xi < nx) & (yi >= 0) & (yi < ny)
            return img[np.clip(xi, 0, nx - 1), np.clip(yi, 0, ny - 1)] * ok

        # Alpha-weighted bilinear: unknown texels don't bleed into known ones.
        si = np.zeros(wx.shape, np.float32)
        sa = np.zeros(wx.shape, np.float32)
        for ddx, ddy, w in (
            (0, 0, (1 - tx) * (1 - ty)),
            (1, 0, tx * (1 - ty)),
            (0, 1, (1 - tx) * ty),
            (1, 1, tx * ty),
        ):
            a = samp(s.alpha, x0 + ddx, y0 + ddy) * w
            si += samp(s.intensity, x0 + ddx, y0 + ddy) * a
            sa += a
        si = np.where(sa > 1e-6, si / np.maximum(sa, 1e-6), 0.0) * valid
        sa = sa * valid
        # cairo OVER: new over existing.
        ci = canvas_i[r0:r1, c0:c1]
        ca = canvas_a[r0:r1, c0:c1]
        out_a = sa + ca * (1.0 - sa)
        out_i = np.where(
            out_a > 1e-6, (si * sa + ci * ca * (1.0 - sa)) / np.maximum(out_a, 1e-6), 0.0
        )
        canvas_i[r0:r1, c0:c1] = out_i
        canvas_a[r0:r1, c0:c1] = out_a

    return PaintedMap(intensity=canvas_i, alpha=canvas_a, origin=origin, resolution=resolution)


def _blend_pixels(rgb: np.ndarray, mask: np.ndarray, color, alpha: float) -> None:
    c = (np.asarray(color, np.float32) * 255.0)[None, :]
    rgb[mask] = (1.0 - alpha) * rgb[mask].astype(np.float32) + alpha * c


def _disk_mask(shape, center, radius) -> np.ndarray:
    rr, cc = np.ogrid[: shape[0], : shape[1]]
    return (rr - center[1]) ** 2 + (cc - center[0]) ** 2 <= radius**2


def draw_trajectory(
    rgb: np.ndarray,
    pixel_points: Sequence[Tuple[int, int]],
    color: Tuple[float, float, float],
    width: float = 4.0,
    alpha: float = 0.7,
    end_marker_radius: float = 6.0,
) -> None:
    """Stroke a trajectory polyline onto an RGB uint8 image, with green
    start / red end markers (ref: draw_trajectories.cc kTrajectoryWidth=4,
    kTrajectoryEndMarkers=6, kAlpha=0.7). In-place."""
    pts = [p for p in pixel_points]
    if not pts:
        return
    h, w = rgb.shape[:2]
    mask = np.zeros((h, w), bool)
    half = width / 2.0
    for (x0, y0), (x1, y1) in zip(pts[:-1], pts[1:]):
        n = max(abs(x1 - x0), abs(y1 - y0), 1)
        xs = np.round(np.linspace(x0, x1, n + 1)).astype(int)
        ys = np.round(np.linspace(y0, y1, n + 1)).astype(int)
        for dx in range(-int(half), int(half) + 1):
            for dy in range(-int(half), int(half) + 1):
                if dx * dx + dy * dy <= half * half:
                    cx = np.clip(xs + dx, 0, w - 1)
                    cy = np.clip(ys + dy, 0, h - 1)
                    mask[cy, cx] = True
    if len(pts) == 1:
        x, y = pts[0]
        if 0 <= x < w and 0 <= y < h:
            mask[y, x] = True
    _blend_pixels(rgb, mask, color, alpha)
    _blend_pixels(rgb, _disk_mask(rgb.shape, pts[0], end_marker_radius), (0.0, 1.0, 0.0), alpha)
    _blend_pixels(rgb, _disk_mask(rgb.shape, pts[-1], end_marker_radius), (1.0, 0.0, 0.0), alpha)


def paint_pose_graph(pose_graph, resolution: float = 0.05, include_unfinished: bool = True) -> np.ndarray:
    """One-call map render: composite every submap at its optimized global
    pose, then stroke each trajectory (ref: the pbstream-to-image pipeline
    built from submap_painter.cc + draw_trajectories.cc)."""
    slices = [
        submap_to_slice(p.submap, p.global_pose)
        for p in pose_graph.submaps
        if include_unfinished or p.finished
    ]
    painted = paint_submap_slices(slices, resolution)
    rgb = painted.to_rgb()
    by_traj: Dict[int, List[Tuple[int, int]]] = {}
    for node in pose_graph.nodes:
        by_traj.setdefault(node.trajectory_id, []).append(
            painted.pose_to_pixel(node.global_pose)
        )
    for traj_id, pixels in sorted(by_traj.items()):
        draw_trajectory(rgb, pixels, get_color(traj_id))
    return rgb
