"""Offline points processor pipeline (counterpart of
hectorgrapher_tpu/io/points_pipeline.py).

(ref: cartographer/io/points_processor.h:29-48 — composable
Process(PointsBatch)/Flush chain; points_processor_pipeline_builder.cc:81
registers ~15 built-in processors; io/*_points_processor.cc.)

Processors are built from a config list of dicts (the Lua pipeline list's
equivalent), last-to-first so each wraps its successor, exactly like the
reference builder. The two grid writers insert on a device
(write_probability_grid into a 2D probability grid, write_hybrid_grid into
a 3D one): build_pipeline's `device`, the card unless the caller asks for
the CPU. Every other processor runs on the host in numpy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from hectorgrapher_tpu_torch.io.image import probability_grid_to_image, write_png


@dataclass
class PointsBatch:
    """(ref: io/points_batch.h — points + origin + frame + color/intensity)"""

    points: np.ndarray  # (N, 3)
    origin: np.ndarray  # (3,)
    frame_id: str = ""
    start_time: float = 0.0
    colors: Optional[np.ndarray] = None  # (N, 3) float [0,1]
    intensities: Optional[np.ndarray] = None  # (N,)

    def keep(self, mask: np.ndarray) -> "PointsBatch":
        return PointsBatch(
            points=self.points[mask],
            origin=self.origin,
            frame_id=self.frame_id,
            start_time=self.start_time,
            colors=self.colors[mask] if self.colors is not None else None,
            intensities=self.intensities[mask] if self.intensities is not None else None,
        )


FLUSH_FINISHED = "finished"
FLUSH_RESTART = "restart"  # (ref: points_processor.h FlushResult::kRestartStream)


class PointsProcessor:
    """(ref: points_processor.h:29-48 — Process/Flush chain; Flush returns
    FLUSH_RESTART when the processor needs the stream replayed, e.g. the
    multi-pass outlier remover.)"""

    def __init__(self, next_processor: Optional["PointsProcessor"]):
        self.next = next_processor

    def process(self, batch: PointsBatch) -> None:
        if self.next:
            self.next.process(batch)

    def flush(self) -> str:
        if self.next:
            return self.next.flush()
        return FLUSH_FINISHED


class NullPointsProcessor(PointsProcessor):
    """(ref: io/null_points_processor.h)"""

    def __init__(self):
        super().__init__(None)

    def process(self, batch: PointsBatch) -> None:
        pass


class CountingPointsProcessor(PointsProcessor):
    """(ref: io/counting_points_processor.cc)"""

    def __init__(self, next_processor):
        super().__init__(next_processor)
        self.num_points = 0
        self.num_batches = 0

    def process(self, batch: PointsBatch) -> None:
        self.num_points += len(batch.points)
        self.num_batches += 1
        super().process(batch)


class MinMaxRangeFilteringPointsProcessor(PointsProcessor):
    """(ref: io/min_max_range_filtering_points_processor.cc)"""

    def __init__(self, next_processor, min_range: float, max_range: float):
        super().__init__(next_processor)
        self.min_range = min_range
        self.max_range = max_range

    def process(self, batch: PointsBatch) -> None:
        r = np.linalg.norm(batch.points - batch.origin[None, :], axis=-1)
        super().process(batch.keep((r >= self.min_range) & (r <= self.max_range)))


class FixedRatioSamplingPointsProcessor(PointsProcessor):
    """(ref: io/fixed_ratio_sampling_points_processor.cc)"""

    def __init__(self, next_processor, sampling_ratio: float):
        super().__init__(next_processor)
        self.ratio = sampling_ratio
        self._pulses = 0
        self._samples = 0

    def process(self, batch: PointsBatch) -> None:
        keep = np.zeros(len(batch.points), bool)
        for i in range(len(batch.points)):
            self._pulses += 1
            if self._samples < self.ratio * self._pulses:
                self._samples += 1
                keep[i] = True
        super().process(batch.keep(keep))


class FrameIdFilteringPointsProcessor(PointsProcessor):
    """(ref: io/frame_id_filtering_points_processor.cc)"""

    def __init__(self, next_processor, keep_frames=(), drop_frames=()):
        super().__init__(next_processor)
        self.keep_frames = set(keep_frames)
        self.drop_frames = set(drop_frames)

    def process(self, batch: PointsBatch) -> None:
        if self.keep_frames and batch.frame_id not in self.keep_frames:
            return
        if batch.frame_id in self.drop_frames:
            return
        super().process(batch)


class VoxelFilterAndRemoveMovingObjectsPointsProcessor(PointsProcessor):
    """Simplified outlier removal: keep one point per voxel, drop voxels
    seen as free more often than occupied (ref: io/outlier_removing_points_
    processor.cc's voting idea, single-pass variant)."""

    def __init__(self, next_processor, voxel_size: float = 0.05):
        super().__init__(next_processor)
        self.voxel_size = voxel_size
        self._seen = set()

    def process(self, batch: PointsBatch) -> None:
        cells = np.floor(batch.points / self.voxel_size).astype(np.int64)
        keys = [tuple(c) for c in cells]
        keep = np.zeros(len(keys), bool)
        for i, k in enumerate(keys):
            if k not in self._seen:
                self._seen.add(k)
                keep[i] = True
        super().process(batch.keep(keep))


class XyzWriterPointsProcessor(PointsProcessor):
    """(ref: io/xyz_writing_points_processor.cc)"""

    def __init__(self, next_processor, filename: str):
        super().__init__(next_processor)
        self._file = open(filename, "w")

    def process(self, batch: PointsBatch) -> None:
        for p in batch.points:
            self._file.write(f"{p[0]} {p[1]} {p[2]}\n")
        super().process(batch)

    def flush(self) -> str:
        self._file.close()
        return super().flush()


class PlyWriterPointsProcessor(PointsProcessor):
    """(ref: io/ply_writing_points_processor.cc — binary little-endian PLY
    with a header patched after flush to carry the final count)"""

    def __init__(self, next_processor, filename: str):
        super().__init__(next_processor)
        self._filename = filename
        self._points: List[np.ndarray] = []

    def process(self, batch: PointsBatch) -> None:
        if len(batch.points):
            self._points.append(np.asarray(batch.points, np.float32))
        super().process(batch)

    def flush(self) -> str:
        pts = np.concatenate(self._points, axis=0) if self._points else np.zeros((0, 3), np.float32)
        header = (
            "ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(pts)}\n"
            "property float x\nproperty float y\nproperty float z\nend_header\n"
        )
        with open(self._filename, "wb") as f:
            f.write(header.encode())
            f.write(pts.astype("<f4").tobytes())
        return super().flush()


class PcdWriterPointsProcessor(PointsProcessor):
    """(ref: io/pcd_writing_points_processor.cc — ASCII PCD)"""

    def __init__(self, next_processor, filename: str):
        super().__init__(next_processor)
        self._filename = filename
        self._points: List[np.ndarray] = []

    def process(self, batch: PointsBatch) -> None:
        if len(batch.points):
            self._points.append(np.asarray(batch.points, np.float32))
        super().process(batch)

    def flush(self) -> str:
        pts = np.concatenate(self._points, axis=0) if self._points else np.zeros((0, 3), np.float32)
        with open(self._filename, "w") as f:
            f.write(
                "# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
                "FIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
                f"WIDTH {len(pts)}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
                f"POINTS {len(pts)}\nDATA ascii\n"
            )
            for p in pts:
                f.write(f"{p[0]} {p[1]} {p[2]}\n")
        return super().flush()


class XRayPointsProcessor(PointsProcessor):
    """(ref: io/xray_points_processor.cc — project all points along an axis
    into a pixel grid; brightness = saturated point count.)"""

    def __init__(self, next_processor, filename: str, voxel_size: float = 0.05, axis: str = "z"):
        super().__init__(next_processor)
        self._filename = filename
        self._voxel = voxel_size
        self._axis = {"x": 0, "y": 1, "z": 2}[axis]
        self._cells: Dict[tuple, int] = {}

    def process(self, batch: PointsBatch) -> None:
        keep_axes = [a for a in range(3) if a != self._axis]
        cells = np.floor(batch.points[:, keep_axes] / self._voxel).astype(np.int64)
        for c in cells:
            k = (int(c[0]), int(c[1]))
            self._cells[k] = self._cells.get(k, 0) + 1
        super().process(batch)

    def flush(self) -> str:
        if self._cells:
            ks = np.asarray(list(self._cells.keys()))
            vs = np.asarray(list(self._cells.values()), np.float32)
            mn = ks.min(axis=0)
            size = ks.max(axis=0) - mn + 1
            img = np.zeros(size, np.float32)
            img[ks[:, 0] - mn[0], ks[:, 1] - mn[1]] = vs
            # saturate like the reference (counts compress via sqrt)
            img = np.sqrt(img)
            img = 255.0 * img / max(img.max(), 1e-6)
            write_png(self._filename, img.T[::-1].astype(np.uint8))
        return super().flush()


def _range_data(batch: PointsBatch, device):
    """A batch as RangeData on `device`: its points padded to a power of
    two (at least 1024), no misses."""
    from hectorgrapher_tpu_torch.sensor.types import RangeData, pad_cloud

    cap = max(1024, 1 << int(np.ceil(np.log2(max(len(batch.points), 2)))))
    return RangeData(
        origin=torch.as_tensor(np.asarray(batch.origin, np.float32), device=device),
        returns=pad_cloud(np.asarray(batch.points, np.float32), cap, device),
        misses=pad_cloud(np.zeros((0, 3), np.float32), 8, device),
    )


class ProbabilityGridPointsProcessor(PointsProcessor):
    """(ref: io/probability_grid_points_processor.cc — ray-cast all batches
    into a 2D probability grid, write as PNG.)"""

    def __init__(self, next_processor, filename: str, resolution: float = 0.05, size: int = 1024,
                 device="cuda"):
        super().__init__(next_processor)
        self._filename = filename
        self._resolution = resolution
        self._size = size
        self._device = torch.device(device)
        self._batches: List[PointsBatch] = []

    def process(self, batch: PointsBatch) -> None:
        self._batches.append(batch)
        super().process(batch)

    def flush(self) -> str:
        from hectorgrapher_tpu_torch.common.config import ProbabilityGridRangeDataInserterOptions2D
        from hectorgrapher_tpu_torch.mapping.grids import make_probability_grid
        from hectorgrapher_tpu_torch.mapping.inserters_2d import make_probability_inserter_2d

        grid = make_probability_grid(self._resolution, (self._size, self._size), self._device)
        insert = make_probability_inserter_2d(
            ProbabilityGridRangeDataInserterOptions2D(),
            max_range=self._size * self._resolution / 2,
            resolution=self._resolution,
        )
        for batch in self._batches:
            grid = insert(grid, _range_data(batch, self._device))
        write_png(self._filename, probability_grid_to_image(grid))
        return super().flush()


class ColoringPointsProcessor(PointsProcessor):
    """(ref: io/coloring_points_processor.cc — paint every point of a given
    frame_id with a fixed color.)"""

    def __init__(self, next_processor, color, frame_id: str = ""):
        super().__init__(next_processor)
        self._color = np.asarray(color, np.float32)  # (3,) in [0,1]
        self._frame_id = frame_id

    def process(self, batch: PointsBatch) -> None:
        if batch.frame_id == self._frame_id:
            batch.colors = np.tile(self._color, (len(batch.points), 1))
        super().process(batch)


class IntensityToColorPointsProcessor(PointsProcessor):
    """(ref: io/intensity_to_color_points_processor.cc — gray =
    clamp((intensity - min) / (max - min), 0, 1) per point.)"""

    def __init__(self, next_processor, min_intensity: float, max_intensity: float, frame_id: str = ""):
        super().__init__(next_processor)
        self._min = min_intensity
        self._max = max_intensity
        self._frame_id = frame_id

    def process(self, batch: PointsBatch) -> None:
        if batch.intensities is not None and (not self._frame_id or batch.frame_id == self._frame_id):
            gray = np.clip(
                (np.asarray(batch.intensities, np.float32) - self._min) / (self._max - self._min),
                0.0,
                1.0,
            )
            batch.colors = np.stack([gray, gray, gray], axis=-1)
        super().process(batch)


class OutlierRemovingPointsProcessor(PointsProcessor):
    """Three-pass moving-object removal (ref:
    io/outlier_removing_points_processor.cc). Phase 1 counts hits per voxel,
    phase 2 counts rays passing through hit voxels (sampled every voxel_size
    along each beam), phase 3 drops points whose voxel has
    rays >= miss_per_hit_limit * hits. Flush returns FLUSH_RESTART after
    phases 1 and 2 so that run_pipeline replays the stream."""

    def __init__(self, next_processor, voxel_size: float, miss_per_hit_limit: float = 3.0):
        super().__init__(next_processor)
        self._voxel = voxel_size
        self._limit = miss_per_hit_limit
        self._phase = 1
        self._hits: Dict[tuple, int] = {}
        self._rays: Dict[tuple, int] = {}

    def _cell(self, p) -> tuple:
        c = np.floor(np.asarray(p) / self._voxel + 0.5).astype(np.int64)
        return (int(c[0]), int(c[1]), int(c[2]))

    def process(self, batch: PointsBatch) -> None:
        if self._phase == 1:
            cells = np.floor(batch.points / self._voxel + 0.5).astype(np.int64)
            for c in cells:
                k = (int(c[0]), int(c[1]), int(c[2]))
                self._hits[k] = self._hits.get(k, 0) + 1
        elif self._phase == 2:
            # Sample each beam every voxel_size; count rays through hit
            # voxels. Faithful to the reference INCLUDING its endpoint
            # behavior (outlier_removing_points_processor.cc:107 samples
            # x in [0, length) so ~half of rays count a pass-through in
            # their own hit voxel — upstream carries a TODO about it; we
            # keep identical semantics rather than 'fixing' parity).
            for p in batch.points:
                delta = np.asarray(p, np.float64) - batch.origin
                length = float(np.linalg.norm(delta))
                if length == 0.0:
                    continue
                ts = np.arange(0.0, length, self._voxel) / length
                samples = batch.origin[None, :] + ts[:, None] * delta[None, :]
                cells = np.floor(samples / self._voxel + 0.5).astype(np.int64)
                for c in cells:
                    k = (int(c[0]), int(c[1]), int(c[2]))
                    if self._hits.get(k, 0) > 0:
                        self._rays[k] = self._rays.get(k, 0) + 1
        else:
            keep = np.ones(len(batch.points), bool)
            for i, p in enumerate(batch.points):
                k = self._cell(p)
                hits = self._hits.get(k, 0)
                rays = self._rays.get(k, 0)
                if rays >= self._limit * hits:
                    keep[i] = False
            super().process(batch.keep(keep))

    def flush(self) -> str:
        if self._phase in (1, 2):
            self._phase += 1
            return FLUSH_RESTART
        return super().flush()


class HybridGridPointsProcessor(PointsProcessor):
    """(ref: io/hybrid_grid_points_processor.cc — insert every batch into a
    3D probability grid and serialize it at flush.) The analog here
    inserts into the dense 3D ProbabilityGrid and writes an .npz with
    log_odds/known/meta instead of a HybridGrid proto."""

    def __init__(self, next_processor, filename: str, voxel_size: float, size: int = 256,
                 hit_probability: float = 0.55, miss_probability: float = 0.49, device="cuda"):
        super().__init__(next_processor)
        self._filename = filename
        self._voxel = voxel_size
        self._size = size
        self._hit_p = hit_probability
        self._miss_p = miss_probability
        self._device = torch.device(device)
        self._batches: List[PointsBatch] = []
        self.grid = None  # the flushed grid, on the device

    def process(self, batch: PointsBatch) -> None:
        self._batches.append(batch)
        super().process(batch)

    def flush(self) -> str:
        from hectorgrapher_tpu_torch.common.config import ProbabilityGridRangeDataInserterOptions3D
        from hectorgrapher_tpu_torch.mapping.grids import make_probability_grid
        from hectorgrapher_tpu_torch.mapping.inserters_3d import make_probability_inserter_3d

        opts = ProbabilityGridRangeDataInserterOptions3D(
            hit_probability=self._hit_p, miss_probability=self._miss_p
        )
        grid = make_probability_grid(self._voxel, (self._size,) * 3, self._device)
        insert = make_probability_inserter_3d(opts)
        for batch in self._batches:
            grid = insert(grid, _range_data(batch, self._device))
        self.grid = grid
        np.savez_compressed(
            self._filename,
            log_odds=grid.log_odds.cpu().numpy(),
            known=grid.known.cpu().numpy(),
            resolution=np.float32(self._voxel),
            min_corner=grid.meta.min_corner.cpu().numpy(),
        )
        return super().flush()


def run_pipeline(pipeline: PointsProcessor, batch_source) -> None:
    """Stream batches through the chain, replaying on FLUSH_RESTART (ref:
    assets_writer.cc main loop — re-reads the bag per restart).

    batch_source: callable returning an iterable of PointsBatch; it is
    invoked once per pass so multi-pass processors see identical streams.
    """
    while True:
        for batch in batch_source():
            pipeline.process(batch)
        if pipeline.flush() != FLUSH_RESTART:
            return


# ---------------------------------------------------------------------------
# pipeline builder (ref: points_processor_pipeline_builder.cc:81-144)
# ---------------------------------------------------------------------------

_REGISTRY = {
    "write_xyz": lambda nxt, a, device: XyzWriterPointsProcessor(nxt, a["filename"]),
    "write_ply": lambda nxt, a, device: PlyWriterPointsProcessor(nxt, a["filename"]),
    "write_pcd": lambda nxt, a, device: PcdWriterPointsProcessor(nxt, a["filename"]),
    "write_xray_image": lambda nxt, a, device: XRayPointsProcessor(
        nxt, a["filename"], a.get("voxel_size", 0.05), a.get("axis", "z")
    ),
    "write_probability_grid": lambda nxt, a, device: ProbabilityGridPointsProcessor(
        nxt, a["filename"], a.get("resolution", 0.05), a.get("size", 1024), device
    ),
    "min_max_range_filter": lambda nxt, a, device: MinMaxRangeFilteringPointsProcessor(
        nxt, a.get("min_range", 0.0), a.get("max_range", 1e9)
    ),
    "fixed_ratio_sampler": lambda nxt, a, device: FixedRatioSamplingPointsProcessor(
        nxt, a["sampling_ratio"]
    ),
    "frame_id_filter": lambda nxt, a, device: FrameIdFilteringPointsProcessor(
        nxt, a.get("keep_frames", ()), a.get("drop_frames", ())
    ),
    "voxel_filter_and_remove_moving_objects": lambda nxt, a, device: VoxelFilterAndRemoveMovingObjectsPointsProcessor(
        nxt, a.get("voxel_size", 0.05)
    ),
    "count": lambda nxt, a, device: CountingPointsProcessor(nxt),
    "color_points": lambda nxt, a, device: ColoringPointsProcessor(
        nxt, a["color"], a.get("frame_id", "")
    ),
    "intensity_to_color": lambda nxt, a, device: IntensityToColorPointsProcessor(
        nxt, a["min_intensity"], a["max_intensity"], a.get("frame_id", "")
    ),
    "voxel_filter_and_remove_moving_objects_multipass": lambda nxt, a, device: OutlierRemovingPointsProcessor(
        nxt, a["voxel_size"], a.get("miss_per_hit_limit", 3.0)
    ),
    "write_hybrid_grid": lambda nxt, a, device: HybridGridPointsProcessor(
        nxt, a["filename"], a["voxel_size"], a.get("size", 256),
        a.get("hit_probability", 0.55), a.get("miss_probability", 0.49), device,
    ),
}


def build_pipeline(configs: List[Dict], device="cuda") -> PointsProcessor:
    """Build the chain last-to-first (ref: builder CreatePipeline). The
    grid writers insert on `device`."""
    nxt: PointsProcessor = NullPointsProcessor()
    for cfg in reversed(configs):
        action = cfg["action"]
        if action not in _REGISTRY:
            raise KeyError(f"unknown points processor action {action!r}")
        nxt = _REGISTRY[action](nxt, cfg, device)
    return nxt
