"""2D submaps: two overlapping fixed-extent dense grids (counterpart of
hectorgrapher_tpu/mapping/submap_2d.py; ref:
cartographer/mapping/2d/submap_2d.{h,cc} — ActiveSubmaps2D keeps two
submaps; a new one is started every num_range_data inserts and the old
one is finished after 2*num_range_data).

Each submap's grid is a fixed dense tensor centered on the submap origin
(the tracking position at creation), so there is no grow-by-doubling. The
grid is a ProbabilityGrid or, with grid_type "TSDF", a TSDFGrid. Its
grid_storage_dtype: "float32"; "uint16", the reference's quantized
storage, computed in f32 while active and quantized when the submap
finishes, for either grid type; or, for a TSDF only, "float16" /
"bfloat16" planes throughout.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from hectorgrapher_tpu_torch.common.profiling import global_factory
from hectorgrapher_tpu_torch.mapping.grids import (
    STORAGE_DTYPES,
    ProbabilityGrid,
    cell_index,
    in_bounds,
    make_probability_grid,
    make_tsdf_grid,
    quantize_probability_grid,
    quantize_tsdf_grid,
)
from hectorgrapher_tpu_torch.mapping.inserters_2d import make_probability_inserter_2d, make_tsdf_inserter_2d
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
    grid: object  # ProbabilityGrid | TSDFGrid
    num_range_data: int = 0
    insertion_finished: bool = False
    quantize_on_finish: bool = False

    def insert(self, range_data_in_submap: RangeData, inserter) -> None:
        assert not self.insertion_finished
        self.grid = inserter(self.grid, range_data_in_submap)
        self.num_range_data += 1

    def finish(self) -> None:
        """(submap_2d.py :77-91.) With quantize_on_finish (the uint16
        storage option; ref: probability_values.h:64-92,
        tsd_value_converter.h:33-73) the grid becomes uint16 codes, which
        every consumer decodes with ensure_f32_grid."""
        self.insertion_finished = True
        if self.quantize_on_finish:
            if isinstance(self.grid, ProbabilityGrid):
                self.grid = quantize_probability_grid(self.grid)
            else:
                self.grid = quantize_tsdf_grid(self.grid)


class ActiveSubmaps2D:
    """(ref: submap_2d.cc ActiveSubmaps2D::InsertRangeData/AddSubmap)"""

    def __init__(self, options, device="cuda", max_ray_length: float = 0.0):
        """Grids go on `device`, the card unless the caller asks for the
        CPU; none is made before the first insert."""
        grid_type = options.grid_options_2d.grid_type
        storage_name = options.grid_storage_dtype
        if grid_type != "TSDF" and storage_name in ("float16", "bfloat16"):
            # Probability grids store f32 log-odds + bool mask; a silent
            # no-op here would fake the documented memory saving.
            raise ValueError(
                f"grid_storage_dtype={storage_name!r} is only supported for TSDF "
                "grids (use 'uint16' for quantize-on-finish of probability grids)"
            )
        self._options = options
        self._device = torch.device(device)
        self._submaps: List[Submap2D] = []
        self._quantize_on_finish = storage_name == "uint16"
        resolution = options.grid_options_2d.resolution
        size = options.grid_size
        ins_opts = options.range_data_inserter
        if grid_type == "TSDF":
            tsdf_opts = ins_opts.tsdf_range_data_inserter
            storage = STORAGE_DTYPES["float32" if self._quantize_on_finish else storage_name]
            self._make_grid = lambda: make_tsdf_grid(
                resolution, (size, size), truncation_distance=tsdf_opts.truncation_distance,
                max_weight=tsdf_opts.maximum_weight, device=self._device, dtype=storage)
            self._inserter = make_tsdf_inserter_2d(tsdf_opts, resolution)
        else:
            # The free-space sampling budget must cover the LONGEST inserted
            # ray (hits up to max_range, misses shortened to
            # missing_data_ray_length).
            max_range = max(size * resolution, max_ray_length)
            self._make_grid = lambda: make_probability_grid(resolution, (size, size), self._device)
            self._inserter = make_probability_inserter_2d(
                ins_opts.probability_grid_range_data_inserter, max_range=max_range, resolution=resolution)

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
        grid = self._make_grid()
        # Center the fixed grid on the new submap origin.
        center = np.array([origin_local[0], origin_local[1]], dtype=np.float32)
        meta = grid.meta._replace(min_corner=grid.meta.min_corner + torch.from_numpy(center).to(self._device))
        self._submaps.append(
            Submap2D(
                local_pose=NpRigid3(np.array([origin_local[0], origin_local[1], 0.0])),
                grid=grid._replace(meta=meta),
                quantize_on_finish=self._quantize_on_finish,
            )
        )

    @property
    def matching_submap(self) -> Optional[Submap2D]:
        return self._submaps[0] if self._submaps else None
