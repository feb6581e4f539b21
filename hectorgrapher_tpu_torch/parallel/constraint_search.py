"""The batched 3D constraint search on one card (counterpart of the 3D
half of hectorgrapher_tpu/parallel/constraint_search.py, :412-840, without
the mesh: the port runs on one card and set_solver_mesh refuses a mesh).

A PackedSubmaps3D holds the search state of many finished submaps on the
card: per pyramid level one stacked flat table whose blocks (one per
submap, each ending in its own zero row) a candidate addresses by its row
base, the stacked low-resolution score fields, the grids' min corners and
the rotational histograms. One constraint round's candidates (node,
submap) are searched together: one K4 launch per pyramid level for the
whole round (match_fast_3d_batched), one readback of the round's scores.

The pose graph keeps the pack across rounds and rebuilds it only when a
needed submap is missing (PoseGraph3D._get_pack_3d): the members that stay
are copied from the old pack on the card, only new members are uploaded.
The tables are f32 whatever the submaps' grid_storage_dtype: the
matcher's score field upcasts a half TSDF (grid_match_scores), so a
pack of f16 or bf16 submaps takes the bytes of an f32 one.
"""

from __future__ import annotations

import time
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from hectorgrapher_tpu_torch.mapping.scan_matching.fast_correlative_3d import (
    FastSearch3DConfig,
    match_fast_3d_batched,
    yaw_scores_3d,
)
from hectorgrapher_tpu_torch.sensor.types import PointCloud
from hectorgrapher_tpu_torch.transform.rigid import Rigid3


class PackedSubmaps3D(NamedTuple):
    """Search state of `count` finished submaps, stacked on one device."""

    pyramids: Tuple[torch.Tensor, ...]  # per level: (count * rows_l, ny_l) f32
    rows: Tuple[int, ...]  # per level: rows_l = nz_l * nx_l + 1, one submap's block
    hi_min_corners: torch.Tensor  # (count, 3)
    low_fields: torch.Tensor  # (count,) + low_shape
    lo_min_corners: torch.Tensor  # (count, 3)
    histograms: torch.Tensor  # (count, H)
    hi_resolution: torch.Tensor  # scalar f32
    lo_resolution: torch.Tensor  # scalar f32
    grid_shape: Tuple[int, int, int]
    low_shape: Tuple[int, int, int]
    count: int


def matcher_arrays_3d(matcher) -> dict:
    """One FastCorrelativeScanMatcher3D's pack state, as the tensors it
    holds (no copy): "pyr" is the list of its per-level flat tables."""
    return {
        "pyr": list(matcher._pyramid_levels),
        "hmc": matcher._high_grid.meta.min_corner,
        "low": matcher._low_scores,
        "lmc": matcher._low_grid.meta.min_corner,
        "hist": matcher._histogram,
        "hi_res": matcher._resolution,
        "lo_res": float(matcher._low_grid.meta.resolution),
        "grid_shape": tuple(matcher._high_grid.shape),
    }


def matcher_host_arrays_3d(matcher) -> dict:
    """CPU copies of one matcher's pack state (matcher_arrays_3d), taken
    once per finished submap by the pose graph's pack cache (finished
    submaps do not change)."""
    a = matcher_arrays_3d(matcher)
    return dict(a, pyr=[t.cpu() for t in a["pyr"]], **{k: a[k].cpu() for k in ("hmc", "low", "lmc", "hist")})


def host_arrays_3d_nbytes(a: dict) -> int:
    """Device bytes one submap's packed state takes: its pyramid levels,
    low field and histogram (the corners are negligible)."""
    return int(sum(t.numel() * t.element_size() for t in a["pyr"])
               + a["low"].numel() * a["low"].element_size() + a["hist"].numel() * a["hist"].element_size())


def pack_submaps_3d_from_arrays(arrays: Sequence[dict], device, previous: Optional[PackedSubmaps3D] = None,
                                previous_slots: Sequence[Optional[int]] = ()) -> PackedSubmaps3D:
    """Pack the submaps `arrays` (matcher_arrays_3d dicts, on any device)
    in their order. Member i whose previous_slots[i] is not None is copied
    from that slot of `previous` on the card; the others are copied from
    their arrays. Raises ValueError on mixed pyramid or field shapes."""
    device = torch.device(device)
    a0 = arrays[0]
    pshapes = [tuple(t.shape) for t in a0["pyr"]]
    lshape = tuple(a0["low"].shape)
    count = len(arrays)
    reuse = list(previous_slots) + [None] * (count - len(previous_slots))
    f32 = dict(dtype=torch.float32, device=device)
    pyr = [torch.empty((count * rows, ny), **f32) for rows, ny in pshapes]
    hmc, lmc = torch.empty((count, 3), **f32), torch.empty((count, 3), **f32)
    low = torch.empty((count,) + lshape, **f32)
    hist = torch.empty((count, a0["hist"].shape[0]), **f32)
    for i, a in enumerate(arrays):
        if [tuple(t.shape) for t in a["pyr"]] != pshapes or tuple(a["low"].shape) != lshape:
            raise ValueError("pack_submaps_3d: mixed pyramid shapes")
        j = reuse[i]
        for level, (rows, _) in enumerate(pshapes):
            src = a["pyr"][level] if j is None else previous.pyramids[level][j * rows:(j + 1) * rows]
            pyr[level][i * rows:(i + 1) * rows].copy_(src, non_blocking=True)
        for dst, key, field in ((hmc, "hmc", "hi_min_corners"), (low, "low", "low_fields"),
                                (lmc, "lmc", "lo_min_corners"), (hist, "hist", "histograms")):
            dst[i].copy_(a[key] if j is None else getattr(previous, field)[j], non_blocking=True)
    return PackedSubmaps3D(
        pyramids=tuple(pyr), rows=tuple(rows for rows, _ in pshapes), hi_min_corners=hmc, low_fields=low,
        lo_min_corners=lmc, histograms=hist, hi_resolution=torch.tensor(a0["hi_res"], **f32),
        lo_resolution=torch.tensor(a0["lo_res"], **f32), grid_shape=tuple(a0["grid_shape"]), low_shape=lshape,
        count=count,
    )


def pack_submaps_3d(matchers, device) -> PackedSubmaps3D:
    """Stack FastCorrelativeScanMatcher3D state on `device`."""
    return pack_submaps_3d_from_arrays([matcher_arrays_3d(m) for m in matchers], device)


class CandidateBatch3D(NamedTuple):
    """One round's candidates, stacked on the card."""

    hi_positions: torch.Tensor  # (B, N, 3)
    hi_mask: torch.Tensor  # (B, N)
    lo_positions: torch.Tensor  # (B, Nl, 3)
    lo_mask: torch.Tensor  # (B, Nl)
    init_translation: torch.Tensor  # (B, 3)
    init_rotation: torch.Tensor  # (B, 4)
    scan_histogram: torch.Tensor  # (B, H)
    initial_yaw: torch.Tensor  # (B,) f64, the yaw scoring's angle offsets
    submap_slot: torch.Tensor  # (B,) int64 pack slot


def build_candidate_arrays_3d(candidates, device) -> CandidateBatch3D:
    """candidates: [(pack slot, hi_cloud, lo_cloud, scan_histogram,
    initial Rigid3, initial_yaw)]. The clouds, already on the card, are
    stacked there; the host values (initial poses as numpy or tensors,
    yaws, slots, histograms) go up in one f64 copy, exact for each: a copy
    blocks its thread, and on the pose graph's worker each wait can cost a
    GIL hand-off to the front end."""
    as_np = lambda x: x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    host = np.stack([np.concatenate([as_np(c[4].translation), as_np(c[4].rotation), [c[5], c[0]], as_np(c[3])])
                     for c in candidates]).astype(np.float64)
    rows = torch.from_numpy(host).to(device)
    return CandidateBatch3D(
        hi_positions=torch.stack([c[1].positions for c in candidates]),
        hi_mask=torch.stack([c[1].mask for c in candidates]),
        lo_positions=torch.stack([c[2].positions for c in candidates]),
        lo_mask=torch.stack([c[2].mask for c in candidates]),
        init_translation=rows[:, 0:3].to(torch.float32),
        init_rotation=rows[:, 3:7].to(torch.float32),
        scan_histogram=rows[:, 9:].to(torch.float32),
        initial_yaw=rows[:, 7],
        submap_slot=rows[:, 8].to(torch.int64),
    )


def launch_fast_matches_3d(packed: PackedSubmaps3D, batch: CandidateBatch3D, config: FastSearch3DConfig,
                           use_rotational: bool = True):
    """The round's search on the card: each candidate's yaw scores, then
    match_fast_3d_batched over the pack (one K4 launch per level). Returns
    device (scores, low_scores, pose_t, pose_q)."""
    slots = batch.submap_slot
    histograms = packed.histograms[slots]
    yaw_scores = torch.stack([
        yaw_scores_3d(use_rotational, histograms[i], batch.scan_histogram[i], config, batch.initial_yaw[i])
        for i in range(slots.shape[0])])
    score, low_score, _, pose = match_fast_3d_batched(
        packed.pyramids, tuple(slots * rows for rows in packed.rows), packed.grid_shape, packed.hi_resolution,
        packed.hi_min_corners[slots], packed.low_fields, slots, packed.lo_resolution, packed.lo_min_corners[slots],
        PointCloud(batch.hi_positions, batch.hi_mask), PointCloud(batch.lo_positions, batch.lo_mask),
        Rigid3(batch.init_translation, batch.init_rotation), yaw_scores, config)
    return score, low_score, pose.translation, pose.rotation


def sharded_fast_matches_3d_packed(packed: PackedSubmaps3D, candidates, config: FastSearch3DConfig,
                                   use_rotational: bool = True, profile: Optional[dict] = None):
    """One round's candidates in one batched search over the pack.
    Returns [(score, low_score, Rigid3 pose on the card)] in candidate
    order, after one readback of the scores; the caller applies the score
    and low-resolution gates. `profile`, if given, receives the seconds of
    cand_build, fm_launch (ending in a device sync) and fm_readback."""
    if not candidates:
        return []
    device = packed.pyramids[0].device
    t0 = time.perf_counter()
    batch = build_candidate_arrays_3d(candidates, device)
    if profile is not None:
        profile["cand_build"] = time.perf_counter() - t0
        t0 = time.perf_counter()
    scores, low_scores, pose_t, pose_q = launch_fast_matches_3d(packed, batch, config, use_rotational)
    if profile is not None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        profile["fm_launch"] = time.perf_counter() - t0
        t0 = time.perf_counter()
    host = torch.stack([scores, low_scores.to(scores.dtype)]).tolist()
    if profile is not None:
        profile["fm_readback"] = time.perf_counter() - t0
    return [(host[0][i], host[1][i], Rigid3(pose_t[i], pose_q[i])) for i in range(len(candidates))]


def sharded_fast_matches_3d(matchers, candidates, config: FastSearch3DConfig, device,
                            use_rotational: bool = True) -> List[tuple]:
    """Every candidate of a round (candidates index `matchers`, which share
    their grid shapes) in one batched search, packing the submaps on the
    fly; a caller that searches often packs once (pack_submaps_3d) and
    calls sharded_fast_matches_3d_packed."""
    if not candidates:
        return []
    return sharded_fast_matches_3d_packed(pack_submaps_3d(matchers, device), candidates, config, use_rotational)
