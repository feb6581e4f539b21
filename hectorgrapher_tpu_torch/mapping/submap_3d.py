"""3D submaps: paired high/low-resolution TSDF grids + rotational histogram
(counterpart of hectorgrapher_tpu/mapping/submap_3d.py, TSDF grids; ref:
cartographer/mapping/3d/submap_3d.{h,cc} — ActiveSubmaps3D keeps two
submaps with the 2D spawn/finish cadence, InsertData :492-515).

Grids are fixed-extent dense tensors in the local SLAM frame, centered on
the submap origin. The probability-grid submaps, the uint16
quantize-on-finish option and the sampled clip accounting (count_clipped)
are not ported: the constructor raises on the first two.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from hectorgrapher_tpu_torch.mapping.grids import TSDFGrid, make_tsdf_grid
from hectorgrapher_tpu_torch.mapping.inserters_3d import make_tsdf_inserter_3d
from hectorgrapher_tpu_torch.sensor.types import RangeData
from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3


@dataclass
class Submap3D:
    local_pose: NpRigid3  # identity rotation: grids are axis-aligned in the local frame
    high_resolution_grid: TSDFGrid
    low_resolution_grid: TSDFGrid
    rotational_histogram: np.ndarray
    num_range_data: int = 0
    insertion_finished: bool = False

    def finish(self) -> None:
        self.insertion_finished = True


class ActiveSubmaps3D:
    """(ref: submap_3d.cc ActiveSubmaps3D)"""

    def __init__(self, options, device, histogram_size: int = 120):
        if options.grid_type != "TSDF":
            raise NotImplementedError(f"grid_type={options.grid_type!r}: only TSDF submaps are ported")
        if options.grid_storage_dtype != "float32":
            raise NotImplementedError(f"grid_storage_dtype={options.grid_storage_dtype!r}: only float32 is ported")
        self._options = options
        self._device = torch.device(device)
        self._histogram_size = histogram_size
        self._submaps: List[Submap3D] = []
        hi_res, lo_res = options.high_resolution, options.low_resolution
        hi_t = options.high_resolution_range_data_inserter.tsdf_range_data_inserter
        lo_t = options.low_resolution_range_data_inserter.tsdf_range_data_inserter
        self._make_high = lambda: make_tsdf_grid(
            hi_res, (options.high_grid_size,) * 3,
            truncation_distance=hi_t.relative_truncation_distance * hi_res,
            max_weight=hi_t.maximum_weight, device=self._device,
        )
        self._make_low = lambda: make_tsdf_grid(
            lo_res, (options.low_grid_size,) * 3,
            truncation_distance=lo_t.relative_truncation_distance * lo_res,
            max_weight=lo_t.maximum_weight, device=self._device,
        )
        self._insert_high = make_tsdf_inserter_3d(hi_t, hi_res)
        self._insert_low = make_tsdf_inserter_3d(lo_t, lo_res)

    @property
    def submaps(self) -> List[Submap3D]:
        return list(self._submaps)

    @property
    def matching_submap(self) -> Optional[Submap3D]:
        return self._submaps[0] if self._submaps else None

    def insert_data(
        self,
        range_data_in_local: RangeData,
        rotational_histogram: np.ndarray,
        origin_local: np.ndarray,
    ) -> List[Submap3D]:
        """(ref: submap_3d.cc ActiveSubmaps3D::InsertData :492-515; the
        high-resolution grid takes only points within
        high_resolution_max_range of the origin, :427-452)."""
        if not self._submaps or self._submaps[-1].num_range_data == self._options.num_range_data:
            self._add_submap(origin_local)
        returns = range_data_in_local.returns
        r = torch.linalg.vector_norm(returns.positions - range_data_in_local.origin[None, :], dim=-1)
        hi_rd = range_data_in_local._replace(
            returns=returns._replace(mask=returns.mask & (r <= self._options.high_resolution_max_range))
        )
        for submap in self._submaps:
            submap.high_resolution_grid = self._insert_high(submap.high_resolution_grid, hi_rd)
            submap.low_resolution_grid = self._insert_low(submap.low_resolution_grid, range_data_in_local)
            submap.rotational_histogram = submap.rotational_histogram + np.asarray(rotational_histogram)
            submap.num_range_data += 1
        if self._submaps[0].num_range_data == 2 * self._options.num_range_data:
            self._submaps[0].finish()
        return list(self._submaps)

    def _add_submap(self, origin_local: np.ndarray) -> None:
        if len(self._submaps) >= 2:
            self._submaps[0].finish()
            self._submaps.pop(0)
        origin_t = np.asarray(origin_local[:3], np.float64)

        def place(grid: TSDFGrid) -> TSDFGrid:
            """Center the empty grid on the submap origin, snapped so that
            voxel centers land on the index*resolution lattice of the
            submap frame (ref: hybrid_grid.h GetCenterOfCell). Snapped in
            float64 and then cast to float32, as the JAX package does:
            every cell floor depends on this corner."""
            res = float(grid.meta.resolution.cpu().numpy())
            mc = grid.meta.min_corner.cpu().numpy().astype(np.float64) + origin_t
            k = np.round((mc - origin_t) / res + 0.5)
            mc_snapped = origin_t + (k - 0.5) * res
            return grid._replace(
                meta=grid.meta._replace(
                    min_corner=torch.from_numpy(mc_snapped.astype(np.float32)).to(self._device)
                )
            )

        self._submaps.append(
            Submap3D(
                local_pose=NpRigid3(origin_t.copy()),
                high_resolution_grid=place(self._make_high()),
                low_resolution_grid=place(self._make_low()),
                rotational_histogram=np.zeros(self._histogram_size, np.float32),
            )
        )
