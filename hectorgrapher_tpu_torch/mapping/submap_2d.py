"""2D submaps: two overlapping fixed-extent dense grids (counterpart of
hectorgrapher_tpu/mapping/submap_2d.py, probability grids only; ref:
cartographer/mapping/2d/submap_2d.{h,cc} — ActiveSubmaps2D keeps two
submaps; a new one is started every num_range_data inserts and the old
one is finished after 2*num_range_data).

Each submap's grid is a fixed dense tensor centered on the submap origin
(the tracking position at creation), so there is no grow-by-doubling.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from hectorgrapher_tpu_torch.common.profiling import global_factory
from hectorgrapher_tpu_torch.mapping.grids import ProbabilityGrid, cell_index, in_bounds, make_probability_grid
from hectorgrapher_tpu_torch.mapping.inserters_2d import make_probability_inserter_2d
from hectorgrapher_tpu_torch.sensor.types import RangeData
from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3

_CLIPPED = None


def clipped_points_counter():
    """Counter of scan returns outside the fixed submap extent
    (submap_2d.py :21-43): the reference grows its grids on demand
    (grid_2d.h GrowLimits:79-94), fixed-extent tensors clip instead, and
    this counter makes a misconfigured extent visible."""
    global _CLIPPED
    if _CLIPPED is None:
        _CLIPPED = global_factory().new_counter_family(
            "mapping_points_clipped_total", "scan returns outside the fixed submap grid extent").add({})
    return _CLIPPED


def count_clipped(grid, range_data: RangeData) -> None:
    """Sampled accounting of out-of-extent returns (submap_2d.py :46-60):
    the masked returns whose cell lies outside `grid` (2D or 3D, any grid
    type) are added to clipped_points_counter; one host read of a scalar,
    so callers run it at a sampled cadence."""
    pts = range_data.returns.positions[..., : grid.meta.min_corner.shape[0]]
    idx = cell_index(grid.meta, pts)
    n = int(torch.sum(range_data.returns.mask & ~in_bounds(idx, grid.shape)))
    if n:
        clipped_points_counter().increment(n)


@dataclass
class Submap2D:
    """(ref: submap_2d.h Submap2D; local_pose is the submap frame in the
    local SLAM frame)"""

    local_pose: NpRigid3
    grid: ProbabilityGrid
    num_range_data: int = 0
    insertion_finished: bool = False

    def insert(self, range_data_in_submap: RangeData, inserter) -> None:
        assert not self.insertion_finished
        self.grid = inserter(self.grid, range_data_in_submap)
        self.num_range_data += 1

    def finish(self) -> None:
        self.insertion_finished = True


class ActiveSubmaps2D:
    """(ref: submap_2d.cc ActiveSubmaps2D::InsertRangeData/AddSubmap)"""

    def __init__(self, options, device, max_ray_length: float = 0.0):
        grid_type = options.grid_options_2d.grid_type
        if grid_type != "PROBABILITY_GRID":
            raise NotImplementedError(
                f"grid_type {grid_type!r}: only PROBABILITY_GRID is ported (2D TSDF: ROADMAP A5b)")
        if options.grid_storage_dtype != "float32":
            raise NotImplementedError(
                f"grid_storage_dtype {options.grid_storage_dtype!r}: only float32 is ported (2D storage: ROADMAP A5b)"
            )
        self._options = options
        self._device = device
        self._submaps: List[Submap2D] = []
        self._resolution = options.grid_options_2d.resolution
        size = options.grid_size
        # The free-space sampling budget must cover the LONGEST inserted ray
        # (hits up to max_range, misses shortened to missing_data_ray_length).
        max_range = max(size * self._resolution, max_ray_length)
        self._inserter = make_probability_inserter_2d(
            options.range_data_inserter.probability_grid_range_data_inserter,
            max_range=max_range,
            resolution=self._resolution,
        )

    @property
    def submaps(self) -> List[Submap2D]:
        return list(self._submaps)

    def insert_range_data(self, range_data_in_local: RangeData, origin_local: np.ndarray) -> List[Submap2D]:
        """Insert into both active submaps; manage spawn/finish.

        range_data_in_local: scan already in the local SLAM frame.
        origin_local: scan origin (used as a new submap's center).
        Returns the current submap list (after possible finish/spawn).
        """
        if not self._submaps or self._submaps[-1].num_range_data == self._options.num_range_data:
            self._add_submap(origin_local)
        for submap in self._submaps:
            # Grids are stored in the local SLAM frame (min_corner is
            # shifted to center the array on the submap origin).
            submap.insert(range_data_in_local, self._inserter)
        # Sampled clip accounting (one host scalar every 8 inserts).
        if self._submaps[0].num_range_data % 8 == 1:
            count_clipped(self._submaps[0].grid, range_data_in_local)
        if self._submaps[0].num_range_data == 2 * self._options.num_range_data:
            self._submaps[0].finish()
        return list(self._submaps)

    def _add_submap(self, origin_local: np.ndarray) -> None:
        if len(self._submaps) >= 2:
            self._submaps[0].finish()
            self._submaps.pop(0)
        size = self._options.grid_size
        grid = make_probability_grid(self._resolution, (size, size), self._device)
        # Center the fixed grid on the new submap origin.
        center = np.array([origin_local[0], origin_local[1]], dtype=np.float32)
        meta = grid.meta._replace(min_corner=grid.meta.min_corner + torch.from_numpy(center).to(self._device))
        self._submaps.append(
            Submap2D(
                local_pose=NpRigid3(np.array([origin_local[0], origin_local[1], 0.0])),
                grid=grid._replace(meta=meta),
            )
        )

    @property
    def matching_submap(self) -> Optional[Submap2D]:
        return self._submaps[0] if self._submaps else None
