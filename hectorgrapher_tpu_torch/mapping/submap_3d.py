"""3D submaps: paired high/low-resolution grids + rotational histogram
(counterpart of hectorgrapher_tpu/mapping/submap_3d.py; ref:
cartographer/mapping/3d/submap_3d.{h,cc} — ActiveSubmaps3D keeps two
submaps with the 2D spawn/finish cadence, InsertData :492-515; the grid
type switches between PROBABILITY_GRID, the default, and TSDF,
CreateGrid :516-547).

Grids are fixed-extent dense tensors in the local SLAM frame, centered on
the submap origin. grid_storage_dtype "uint16" quantizes a submap's grids
when it finishes, as the JAX package does; "float16" and "bfloat16" store
a TSDF submap's planes in half precision from the start (half the bytes
on the card), and are a ValueError for occupancy grids, as in the JAX
package. The sampled clip accounting (count_clipped) is not ported.

Submap3D.prepared_grids() is what the scan matchers read (K3 and the
stencils): uint16 grids decoded to f32, half TSDF planes as they are (K3
and the stencils upcast each tap), an occupancy grid as its probability
field. It is cached under the submap's version, which every insertion
and the finish bump, so a consumer never reads a stale field.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from hectorgrapher_tpu_torch.mapping.grids import (
    STORAGE_DTYPES,
    ProbabilityGrid,
    make_probability_grid,
    make_tsdf_grid,
    quantize_probability_grid,
    quantize_tsdf_grid,
)
from hectorgrapher_tpu_torch.mapping.inserters_3d import make_probability_inserter_3d, make_tsdf_inserter_3d
from hectorgrapher_tpu_torch.mapping.scan_matching.interpolated_grid import prepare_grid_3d
from hectorgrapher_tpu_torch.sensor.types import RangeData
from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3


@dataclass
class Submap3D:
    local_pose: NpRigid3  # identity rotation: grids are axis-aligned in the local frame
    high_resolution_grid: object  # ProbabilityGrid | TSDFGrid
    low_resolution_grid: object
    rotational_histogram: np.ndarray
    num_range_data: int = 0
    insertion_finished: bool = False
    quantize_on_finish: bool = False
    version: int = 0  # bumped by every change of the grids
    _prepared: tuple = field(default=None, repr=False, compare=False)

    def finish(self) -> None:
        """(submap_3d.py Submap3D.finish :41-62.) With uint16 storage the
        long-lived finished grids become codes; consumers decode them."""
        self.insertion_finished = True
        if self.quantize_on_finish:
            for attr in ("high_resolution_grid", "low_resolution_grid"):
                g = getattr(self, attr)
                setattr(self, attr, quantize_probability_grid(g) if isinstance(g, ProbabilityGrid)
                        else quantize_tsdf_grid(g))
            self.version += 1

    def prepared_grids(self):
        """(hi, lo) as kernel K3 and the 3D stencils read them
        (prepare_grid_3d), built once per version (and grid objects, in
        case a caller replaced a grid without bumping the version). A
        uint16 submap's are decoded on every call, as the JAX package
        decodes them per use: caching them would keep the f32 copy that
        the codes exist to drop."""
        hi, lo = self.high_resolution_grid, self.low_resolution_grid
        key = (self.version, id(hi), id(lo))
        if self._prepared is not None and self._prepared[0] == key:
            return self._prepared[1]
        prepared = (prepare_grid_3d(hi), prepare_grid_3d(lo))
        self._prepared = None if self.quantize_on_finish and self.insertion_finished else (key, prepared)
        return prepared


class ActiveSubmaps3D:
    """(ref: submap_3d.cc ActiveSubmaps3D)"""

    def __init__(self, options, device, histogram_size: int = 120):
        storage = options.grid_storage_dtype
        if storage not in STORAGE_DTYPES:
            raise ValueError(f"grid_storage_dtype={storage!r}: one of {sorted(STORAGE_DTYPES)}")
        if options.grid_type != "TSDF" and storage in ("float16", "bfloat16"):
            raise ValueError(f"grid_storage_dtype={storage!r} is only supported for TSDF grids (use 'uint16' "
                             "for quantize-on-finish of probability grids)")
        self._options = options
        self._device = torch.device(device)
        self._histogram_size = histogram_size
        self._submaps: List[Submap3D] = []
        self._is_tsdf = options.grid_type == "TSDF"
        self._quantize_on_finish = storage == "uint16"  # active grids compute in f32
        dtype = STORAGE_DTYPES["float32" if self._quantize_on_finish else storage]
        hi_res, lo_res = options.high_resolution, options.low_resolution
        hi_size, lo_size = (options.high_grid_size,) * 3, (options.low_grid_size,) * 3
        hi_opts = options.high_resolution_range_data_inserter
        lo_opts = options.low_resolution_range_data_inserter
        if self._is_tsdf:
            hi_t, lo_t = hi_opts.tsdf_range_data_inserter, lo_opts.tsdf_range_data_inserter
            self._make_high = lambda: make_tsdf_grid(
                hi_res, hi_size, truncation_distance=hi_t.relative_truncation_distance * hi_res,
                max_weight=hi_t.maximum_weight, device=self._device, dtype=dtype,
            )
            self._make_low = lambda: make_tsdf_grid(
                lo_res, lo_size, truncation_distance=lo_t.relative_truncation_distance * lo_res,
                max_weight=lo_t.maximum_weight, device=self._device, dtype=dtype,
            )
            self._insert_high = make_tsdf_inserter_3d(hi_t, hi_res)
            self._insert_low = make_tsdf_inserter_3d(lo_t, lo_res)
        else:
            self._make_high = lambda: make_probability_grid(hi_res, hi_size, self._device)
            self._make_low = lambda: make_probability_grid(lo_res, lo_size, self._device)
            self._insert_high = make_probability_inserter_3d(hi_opts.probability_grid_range_data_inserter)
            self._insert_low = make_probability_inserter_3d(lo_opts.probability_grid_range_data_inserter)

    @property
    def is_tsdf(self) -> bool:
        return self._is_tsdf

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
            submap.version += 1
        if self._submaps[0].num_range_data == 2 * self._options.num_range_data:
            self._submaps[0].finish()
        return list(self._submaps)

    def _add_submap(self, origin_local: np.ndarray) -> None:
        if len(self._submaps) >= 2:
            self._submaps[0].finish()
            self._submaps.pop(0)
        origin_t = np.asarray(origin_local[:3], np.float64)

        def place(grid):
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
                quantize_on_finish=self._quantize_on_finish,
            )
        )
