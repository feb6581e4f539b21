"""The batched constraint searches, 3D and 2D, on one card or over a Mesh
(counterpart of hectorgrapher_tpu/parallel/constraint_search.py, the 3D
half :412-840 and the 2D half :41-405).

A PackedSubmaps3D holds the search state of many finished submaps on one
device: per pyramid level one stacked flat table whose blocks (one per
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

Over a Mesh (parallel/mesh.py) the finished submaps are partitioned over
the shards, as in the JAX package: submap i is owned by shard
i // s_per_dev, s_per_dev a power of two (_pow2_pad), and each shard of
this process holds a PackedSubmaps3D / PackedSubmaps2D of the submaps it
owns (MeshPackedSubmaps3D / MeshPackedSubmaps2D; a shard that owns none
holds nothing, and no padding slot is allocated). A round routes each
candidate to the shard that owns its submap (build_candidate_arrays_* with
a mesh: host arrays in the JAX package's layout, c_max rows a shard, which
the leader of a multi-process mesh ships to its followers), launches the
batched search once per shard (one K4 or K5 launch per shard and pyramid
level) and gathers every shard's scores and poses in one collective,
back into candidate order. Each candidate is searched with the same
arithmetic as in a single-card round, so its score and pose are the same
bits; a one-shard mesh packs exactly the single-card pack.
"""

from __future__ import annotations

import time
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from hectorgrapher_tpu_torch.mapping.scan_matching.fast_correlative_2d import (
    FastSearchConfig,
    PreparedFastMatcher2D,
    match_fast_2d_batched,
)
from hectorgrapher_tpu_torch.mapping.scan_matching.fast_correlative_3d import (
    FastSearch3DConfig,
    match_fast_3d_batched,
    yaw_scores_3d,
)
from hectorgrapher_tpu_torch.parallel.mesh import Mesh
from hectorgrapher_tpu_torch.sensor.types import PointCloud
from hectorgrapher_tpu_torch.transform.rigid import Rigid2, Rigid3


def _pow2_pad(n: int) -> int:
    """The next power of two: per-shard counts grow through O(log n) sizes
    (the JAX package's reason is recompiles; here it keeps a submap's
    owner stable while the pack grows)."""
    p = 1
    while p < n:
        p *= 2
    return p


def _owned(count: int, s_per_dev: int, mesh: Mesh):
    """(local shard k, its device, the pack slots it owns) for each of this
    process's shards."""
    return [(k, device, range(min(i * s_per_dev, count), min((i + 1) * s_per_dev, count)))
            for k, (device, i) in enumerate(zip(mesh.devices, mesh.local_shards))]


def _as_numpy(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rows_on(arrays: dict, rows: slice, device, keys) -> dict:
    """The rows of the host arrays `keys` as tensors on `device`."""
    return {k: torch.from_numpy(np.ascontiguousarray(arrays[k][rows])).to(device) for k in keys}


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


def _pack_3d(arrays: Sequence[dict], device, reuse) -> PackedSubmaps3D:
    """PackedSubmaps3D of `arrays` on `device`; member i is copied from
    reuse[i] = (an earlier pack, its slot) when given, else from arrays[i]."""
    a0 = arrays[0]
    pshapes = [tuple(t.shape) for t in a0["pyr"]]
    lshape = tuple(a0["low"].shape)
    count = len(arrays)
    f32 = dict(dtype=torch.float32, device=device)
    pyr = [torch.empty((count * rows, ny), **f32) for rows, ny in pshapes]
    hmc, lmc = torch.empty((count, 3), **f32), torch.empty((count, 3), **f32)
    low = torch.empty((count,) + lshape, **f32)
    hist = torch.empty((count, a0["hist"].shape[0]), **f32)
    for i, a in enumerate(arrays):
        src = reuse[i]
        for level, (rows, _) in enumerate(pshapes):
            t = (torch.as_tensor(a["pyr"][level]) if src is None
                 else src[0].pyramids[level][src[1] * rows:(src[1] + 1) * rows])
            pyr[level][i * rows:(i + 1) * rows].copy_(t, non_blocking=True)
        for dst, key, field in ((hmc, "hmc", "hi_min_corners"), (low, "low", "low_fields"),
                                (lmc, "lmc", "lo_min_corners"), (hist, "hist", "histograms")):
            dst[i].copy_(torch.as_tensor(a[key]) if src is None else getattr(src[0], field)[src[1]],
                         non_blocking=True)
    return PackedSubmaps3D(
        pyramids=tuple(pyr), rows=tuple(rows for rows, _ in pshapes), hi_min_corners=hmc, low_fields=low,
        lo_min_corners=lmc, histograms=hist, hi_resolution=torch.tensor(a0["hi_res"], **f32),
        lo_resolution=torch.tensor(a0["lo_res"], **f32), grid_shape=tuple(a0["grid_shape"]), low_shape=lshape,
        count=count,
    )


class MeshPackedSubmaps3D(NamedTuple):
    """Search state of `count` finished submaps partitioned over a mesh:
    submap i is owned by shard i // s_per_dev. shards: for each of this
    process's shards, a PackedSubmaps3D of the submaps it owns, in order,
    on its device, or None when it owns none."""

    shards: Tuple[Optional[PackedSubmaps3D], ...]
    s_per_dev: int
    count: int
    mesh: Mesh


def pack_submaps_3d_from_arrays(arrays: Sequence[dict], device, previous=None,
                                previous_slots: Sequence[Optional[int]] = ()):
    """Pack the submaps `arrays` (matcher_arrays_3d dicts, on any device,
    or their numpy copies) in their order: on `device`, or, when `device`
    is a Mesh, over its shards (a MeshPackedSubmaps3D, of which this
    process packs only its own shards' submaps). Member i whose
    previous_slots[i] is not None is copied from that slot of `previous`
    (a pack of the same kind; over a mesh, where this process holds it)
    on the card; the others are copied from their arrays. Raises
    ValueError on mixed pyramid or field shapes."""
    pshapes = [tuple(t.shape) for t in arrays[0]["pyr"]]
    lshape = tuple(arrays[0]["low"].shape)
    for a in arrays:
        if [tuple(t.shape) for t in a["pyr"]] != pshapes or tuple(a["low"].shape) != lshape:
            raise ValueError("pack_submaps_3d: mixed pyramid shapes")
    reuse = list(previous_slots) + [None] * (len(arrays) - len(previous_slots))
    if not isinstance(device, Mesh):
        return _pack_3d(arrays, torch.device(device), [None if j is None else (previous, j) for j in reuse])
    mesh, count = device, len(arrays)
    s_per_dev = _pow2_pad(-(-count // mesh.size))
    held = {}  # an old slot this process holds -> (its shard's pack, its slot there)
    if previous is not None:
        for k, _, slots in _owned(previous.count, previous.s_per_dev, mesh):
            held.update({j: (previous.shards[k], local) for local, j in enumerate(slots)})
    shards = tuple(_pack_3d([arrays[i] for i in slots], dev, [held.get(reuse[i]) for i in slots]) if len(slots)
                   else None for _, dev, slots in _owned(count, s_per_dev, mesh))
    return MeshPackedSubmaps3D(shards=shards, s_per_dev=s_per_dev, count=count, mesh=mesh)


def pack_submaps_3d(matchers, device):
    """Stack FastCorrelativeScanMatcher3D state on `device`, or over a
    Mesh's shards."""
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


def _route(slots: Sequence[int], s_per_dev: int, n_shards: int):
    """(c_max, row of each candidate): candidate i goes to the shard that
    owns pack slot slots[i], rows d * c_max + k of shard d in candidate
    order, c_max a power of two."""
    per: List[List[int]] = [[] for _ in range(n_shards)]
    for ci, si in enumerate(slots):
        per[si // s_per_dev].append(ci)
    c_max = _pow2_pad(max(1, max(len(lst) for lst in per)))
    row_of = np.full(len(slots), -1, np.int64)
    for d, lst in enumerate(per):
        row_of[lst] = d * c_max + np.arange(len(lst))
    return c_max, row_of


class _HostCache:
    """Host copies by object: a round's candidates share one node's clouds
    and histogram, each copied once."""

    def __init__(self):
        self._got = {}

    def __call__(self, x):
        got = self._got.get(id(x))
        if got is None:
            got = self._got[id(x)] = _as_numpy(x)
        return got


def build_candidate_arrays_3d(candidates, device, s_per_dev: int = 0):
    """candidates: [(pack slot, hi_cloud, lo_cloud, scan_histogram,
    initial Rigid3, initial_yaw)].

    On a device: one CandidateBatch3D. The clouds, already on the card,
    are stacked there; the host values (initial poses as numpy or tensors,
    yaws, slots, histograms) go up in one f64 copy, exact for each: a copy
    blocks its thread, and on the pose graph's worker each wait can cost a
    GIL hand-off to the front end.

    Over a Mesh (with the pack's s_per_dev): the round's host arrays
    routed to the shards that own the candidates' submaps, as the JAX
    package builds them for a leader to ship (numpy, c_max rows a shard,
    valid rows first, the others zero; submap_slot is the slot on the
    owner; initial_yaw stays f64 as in a single-card batch), and the row
    of each candidate: (arrays, row_of_candidate)."""
    if isinstance(device, Mesh):
        return _routed_arrays_3d(candidates, device.size, s_per_dev)
    host = np.stack([np.concatenate([_as_numpy(c[4].translation), _as_numpy(c[4].rotation), [c[5], c[0]],
                                     _as_numpy(c[3])])
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


def _routed_arrays_3d(candidates, n_shards: int, s_per_dev: int):
    to_np = _HostCache()
    c_max, row_of = _route([c[0] for c in candidates], s_per_dev, n_shards)
    c_pad = n_shards * c_max
    n_hi, n_lo = to_np(candidates[0][1].positions).shape[0], to_np(candidates[0][2].positions).shape[0]
    arrays = {
        "hi_positions": np.zeros((c_pad, n_hi, 3), np.float32), "hi_mask": np.zeros((c_pad, n_hi), bool),
        "lo_positions": np.zeros((c_pad, n_lo, 3), np.float32), "lo_mask": np.zeros((c_pad, n_lo), bool),
        "init_translation": np.zeros((c_pad, 3), np.float32),
        "init_rotation": np.tile(np.array([1, 0, 0, 0], np.float32), (c_pad, 1)),
        "scan_histogram": np.zeros((c_pad, to_np(candidates[0][3]).shape[0]), np.float32),
        "initial_yaw": np.zeros(c_pad, np.float64), "submap_slot": np.zeros(c_pad, np.int64),
        "valid": np.zeros(c_pad, bool),
    }
    for (si, hi, lo, hist, init, yaw), row in zip(candidates, row_of):
        for key, value in (("hi_positions", hi.positions), ("hi_mask", hi.mask), ("lo_positions", lo.positions),
                           ("lo_mask", lo.mask), ("init_translation", init.translation),
                           ("init_rotation", init.rotation), ("scan_histogram", hist)):
            arrays[key][row] = to_np(value)
        arrays["initial_yaw"][row] = float(yaw)
        arrays["submap_slot"][row] = si - (row // c_max) * s_per_dev
        arrays["valid"][row] = True
    return arrays, row_of


def _launch_on_device_3d(packed: PackedSubmaps3D, batch: CandidateBatch3D, config: FastSearch3DConfig,
                         use_rotational: bool):
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


def _shard_batches(packed, arrays: dict, make_batch):
    """(c_max, for each of this process's shards its candidates' batch on
    its device, or None when it has none)."""
    mesh = packed.mesh
    c_max = arrays["valid"].shape[0] // mesh.size
    batches = []
    for device, index in zip(mesh.devices, mesh.local_shards):
        n = int(arrays["valid"][index * c_max:(index + 1) * c_max].sum())
        batches.append(make_batch(arrays, slice(index * c_max, index * c_max + n), device) if n else None)
    return c_max, tuple(batches)


def _batch_3d(arrays: dict, rows: slice, device) -> CandidateBatch3D:
    t = _rows_on(arrays, rows, device, CandidateBatch3D._fields)
    return CandidateBatch3D(**t)


def _gather_rows(packed, batches, c_max: int, width: int, launch):
    """Every shard's candidates searched by launch(shard pack, batch) ->
    (c, width) rows, padded to c_max rows a shard (score -inf, else 0) and
    gathered over the mesh in one collective: (mesh.size * c_max, width)
    on mesh.device, in routed-row order."""
    tables = []
    for pack, batch, device in zip(packed.shards, batches, packed.mesh.devices):
        table = torch.zeros((c_max, width), dtype=torch.float32, device=device)
        table[:, 0] = -torch.inf
        if batch is not None:
            rows = launch(pack, batch)
            table[:rows.shape[0]] = rows
        tables.append(table)
    return packed.mesh.all_gather(tables)


def _sharded_scores_3d(packed: MeshPackedSubmaps3D, batches, c_max: int, config: FastSearch3DConfig,
                       use_rotational: bool):
    def launch(pack, batch):
        score, low_score, t, q = _launch_on_device_3d(pack, batch, config, use_rotational)
        return torch.cat([score[:, None], low_score.to(score.dtype)[:, None], t, q], dim=1)

    g = _gather_rows(packed, batches, c_max, 9, launch)
    return g[:, 0], g[:, 1], g[:, 2:5], g[:, 5:9]


def fm_launch_fn_args_3d(packed: MeshPackedSubmaps3D, arrays: dict, config: FastSearch3DConfig,
                         use_rotational: bool = True):
    """(fn, args) of one round's launch over the mesh: the round's rows of
    `arrays` (build_candidate_arrays_3d over the mesh) uploaded to each of
    this process's shards; fn(*args) searches them and gathers."""
    c_max, batches = _shard_batches(packed, arrays, _batch_3d)
    return _sharded_scores_3d, (packed, batches, c_max, config, use_rotational)


def launch_fast_matches_3d(packed, batch, config: FastSearch3DConfig, use_rotational: bool = True):
    """The round's search: each candidate's yaw scores, then
    match_fast_3d_batched over the pack (one K4 launch per level). On one
    device `batch` is a CandidateBatch3D; over a mesh (packed a
    MeshPackedSubmaps3D) it is the round's host arrays, every process of
    the mesh entering with the same ones, and each shard makes its own K4
    launches. Returns device (scores, low_scores, pose_t, pose_q), in
    routed-row order over a mesh (invalid rows score -inf)."""
    if isinstance(packed, MeshPackedSubmaps3D):
        fn, args = fm_launch_fn_args_3d(packed, batch, config, use_rotational)
        return fn(*args)
    return _launch_on_device_3d(packed, batch, config, use_rotational)


def _sync(devices) -> None:
    for device in set(devices):
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def sharded_fast_matches_3d_packed(packed, candidates, config: FastSearch3DConfig, use_rotational: bool = True,
                                   profile: Optional[dict] = None, broadcast=None):
    """One round's candidates in one batched search over the pack (one
    launch a shard over a mesh). Returns [(score, low_score, Rigid3 pose on
    the card)] in candidate order, after one readback of the scores; the
    caller applies the score and low-resolution gates. `broadcast`, if
    given, is called with the round's host arrays before a mesh's launch,
    so that the followers of a multi-process mesh enter the same launch
    (cloud/solver_plane.py). `profile`, if given, receives the seconds of
    cand_build, broadcast, fm_launch (ending in a device sync) and
    fm_readback."""
    if not candidates:
        return []
    mesh = packed.mesh if isinstance(packed, MeshPackedSubmaps3D) else None
    devices = mesh.devices if mesh is not None else (packed.pyramids[0].device,)
    t0 = time.perf_counter()
    if mesh is None:
        batch, rows = build_candidate_arrays_3d(candidates, devices[0]), range(len(candidates))
    else:
        batch, rows = build_candidate_arrays_3d(candidates, mesh, packed.s_per_dev)
    if profile is not None:
        profile["cand_build"] = time.perf_counter() - t0
        t0 = time.perf_counter()
    if broadcast is not None:
        broadcast(batch)
        if profile is not None:
            profile["broadcast"] = time.perf_counter() - t0
            t0 = time.perf_counter()
    scores, low_scores, pose_t, pose_q = launch_fast_matches_3d(packed, batch, config, use_rotational)
    if profile is not None:
        _sync(devices)
        profile["fm_launch"] = time.perf_counter() - t0
        t0 = time.perf_counter()
    host = torch.stack([scores, low_scores.to(scores.dtype)]).tolist()
    if profile is not None:
        profile["fm_readback"] = time.perf_counter() - t0
    return [(host[0][r], host[1][r], Rigid3(pose_t[r], pose_q[r])) for r in rows]


def sharded_fast_matches_3d(matchers, candidates, config: FastSearch3DConfig, device,
                            use_rotational: bool = True) -> List[tuple]:
    """Every candidate of a round (candidates index `matchers`, which share
    their grid shapes) in one batched search on `device` or over a Mesh,
    packing the submaps on the fly; a caller that searches often packs
    once (pack_submaps_3d) and calls sharded_fast_matches_3d_packed."""
    if not candidates:
        return []
    return sharded_fast_matches_3d_packed(pack_submaps_3d(matchers, device), candidates, config, use_rotational)


# ---------------------------------------------------------------------------
# 2D
# ---------------------------------------------------------------------------
#
# A PackedSubmaps2D holds the prepared fast matchers of many finished
# submaps (one search depth) on the card: their levels stacked into one
# flat table whose submap blocks of depth * (nx + 1) rows a candidate
# addresses by its row base, and their grid corners. One round's
# candidates are searched together: one K5 launch per pyramid level for the
# whole round (match_fast_2d_batched), one readback of the round's scores.


class PackedSubmaps2D(NamedTuple):
    """Search state of `count` finished submaps of one search depth,
    stacked on one device."""

    levels: torch.Tensor  # (count * depth * (nx + 1), ny) f32
    min_corners: torch.Tensor  # (count, 2)
    resolution: torch.Tensor  # scalar f32
    dims: Tuple[int, int]
    depth: int
    count: int

    @property
    def block_rows(self) -> int:
        """Table rows of one submap's block."""
        return self.depth * (self.dims[0] + 1)


def _pack_2d(arrays, resolution: float, dims: Tuple[int, int], device) -> PackedSubmaps2D:
    shape = tuple(arrays[0][0].shape)
    f32 = dict(dtype=torch.float32, device=device)
    levels = torch.empty((len(arrays),) + shape, **f32)
    mcs = torch.empty((len(arrays), 2), **f32)
    for i, (lv, mc) in enumerate(arrays):
        levels[i].copy_(torch.as_tensor(lv), non_blocking=True)
        mcs[i].copy_(torch.as_tensor(mc), non_blocking=True)
    return PackedSubmaps2D(levels=levels.reshape(-1, shape[2]), min_corners=mcs,
                           resolution=torch.tensor(float(resolution), **f32), dims=tuple(int(d) for d in dims),
                           depth=int(shape[0]), count=len(arrays))


class MeshPackedSubmaps2D(NamedTuple):
    """Search state of `count` finished submaps of one search depth
    partitioned over a mesh: submap i is owned by shard i // s_per_dev.
    shards: for each of this process's shards, a PackedSubmaps2D of the
    submaps it owns, on its device, or None when it owns none."""

    shards: Tuple[Optional[PackedSubmaps2D], ...]
    s_per_dev: int
    count: int
    depth: int
    mesh: Mesh


def pack_submaps_2d_from_arrays(arrays: Sequence[Tuple[torch.Tensor, torch.Tensor]], resolution: float,
                                dims: Tuple[int, int], device):
    """Pack (flat_levels (depth, nx + 1, ny), min_corner (2,)) of each
    submap, tensors on any device or numpy, in their order: on `device`,
    or, when `device` is a Mesh, over its shards (a MeshPackedSubmaps2D, of
    which this process packs only its own shards' submaps). Raises
    ValueError on mixed level shapes."""
    shape = tuple(arrays[0][0].shape)
    if any(tuple(lv.shape) != shape for lv, _ in arrays):
        raise ValueError("pack_submaps_2d: mixed pyramid shapes")
    if not isinstance(device, Mesh):
        return _pack_2d(arrays, resolution, dims, torch.device(device))
    mesh, count = device, len(arrays)
    s_per_dev = _pow2_pad(-(-count // mesh.size))
    shards = tuple(_pack_2d([arrays[i] for i in slots], resolution, dims, dev) if len(slots) else None
                   for _, dev, slots in _owned(count, s_per_dev, mesh))
    return MeshPackedSubmaps2D(shards=shards, s_per_dev=s_per_dev, count=count, depth=int(shape[0]), mesh=mesh)


def pack_submaps_2d(prepared_submaps: Sequence[PreparedFastMatcher2D], device):
    """Stack prepared matchers (of one depth and grid shape) on `device`,
    or over a Mesh's shards."""
    p0 = prepared_submaps[0]
    return pack_submaps_2d_from_arrays([(p.flat_levels, p.meta.min_corner) for p in prepared_submaps],
                                       float(p0.meta.resolution), p0.dims, device)


class CandidateBatch2D(NamedTuple):
    """One round's candidates, stacked on the card."""

    cloud_positions: torch.Tensor  # (B, N, 3)
    cloud_mask: torch.Tensor  # (B, N)
    init_translation: torch.Tensor  # (B, 2)
    init_angle: torch.Tensor  # (B,)
    submap_slot: torch.Tensor  # (B,) int64 pack slot


def build_candidate_arrays_2d(candidates, device, s_per_dev: int = 0):
    """candidates: [(pack slot, cloud, initial Rigid2 in the grid frame)].

    On a device: one CandidateBatch2D. The clouds, already on the card,
    are stacked there (one expand when every candidate shares one cloud,
    the round of one node against many submaps); the initial poses and
    slots go up in one f64 copy, exact for each.

    Over a Mesh (with the pack's s_per_dev): the round's host arrays
    routed to the shards that own the candidates' submaps, in the JAX
    package's layout (see build_candidate_arrays_3d), and the row of each
    candidate: (arrays, row_of_candidate)."""
    if isinstance(device, Mesh):
        return _routed_arrays_2d(candidates, device.size, s_per_dev)
    host = np.stack([np.concatenate([_as_numpy(c[2].translation).reshape(2), _as_numpy(c[2].angle).reshape(1),
                                     [c[0]]])
                     for c in candidates]).astype(np.float64)
    rows = torch.from_numpy(host).to(device)
    clouds = [c[1] for c in candidates]
    if all(cl is clouds[0] for cl in clouds):
        positions = clouds[0].positions.expand(len(clouds), -1, -1)
        mask = clouds[0].mask.expand(len(clouds), -1)
    else:
        positions, mask = torch.stack([cl.positions for cl in clouds]), torch.stack([cl.mask for cl in clouds])
    return CandidateBatch2D(cloud_positions=positions, cloud_mask=mask, init_translation=rows[:, 0:2].float(),
                            init_angle=rows[:, 2].float(), submap_slot=rows[:, 3].to(torch.int64))


def _routed_arrays_2d(candidates, n_shards: int, s_per_dev: int):
    to_np = _HostCache()
    c_max, row_of = _route([c[0] for c in candidates], s_per_dev, n_shards)
    c_pad = n_shards * c_max
    n = to_np(candidates[0][1].positions).shape[0]
    arrays = {
        "cloud_positions": np.zeros((c_pad, n, 3), np.float32), "cloud_mask": np.zeros((c_pad, n), bool),
        "init_translation": np.zeros((c_pad, 2), np.float32), "init_angle": np.zeros(c_pad, np.float32),
        "submap_slot": np.zeros(c_pad, np.int64), "valid": np.zeros(c_pad, bool),
    }
    for (si, cloud, init), row in zip(candidates, row_of):
        arrays["cloud_positions"][row] = to_np(cloud.positions)
        arrays["cloud_mask"][row] = to_np(cloud.mask)
        arrays["init_translation"][row] = to_np(init.translation).reshape(2)
        arrays["init_angle"][row] = to_np(init.angle).reshape(())
        arrays["submap_slot"][row] = si - (row // c_max) * s_per_dev
        arrays["valid"][row] = True
    return arrays, row_of


def _launch_on_device_2d(packed: PackedSubmaps2D, batch: CandidateBatch2D, config: FastSearchConfig):
    slots = batch.submap_slot
    if config.depth != packed.depth:
        raise ValueError(f"a depth-{config.depth} search over a depth-{packed.depth} pack")
    scores, pose = match_fast_2d_batched(
        packed.levels, slots * packed.block_rows, packed.resolution, packed.min_corners[slots], packed.dims,
        PointCloud(batch.cloud_positions, batch.cloud_mask), Rigid2(batch.init_translation, batch.init_angle),
        config)
    return scores, pose.translation, pose.angle


def _batch_2d(arrays: dict, rows: slice, device) -> CandidateBatch2D:
    return CandidateBatch2D(**_rows_on(arrays, rows, device, CandidateBatch2D._fields))


def _sharded_scores_2d(packed: MeshPackedSubmaps2D, batches, c_max: int, config: FastSearchConfig):
    def launch(pack, batch):
        score, t, a = _launch_on_device_2d(pack, batch, config)
        return torch.cat([score[:, None], t, a[:, None]], dim=1)

    g = _gather_rows(packed, batches, c_max, 4, launch)
    return g[:, 0], g[:, 1:3], g[:, 3]


def fm_launch_fn_args_2d(packed: MeshPackedSubmaps2D, arrays: dict, config: FastSearchConfig):
    """(fn, args) of one round's launch over the mesh (see
    fm_launch_fn_args_3d)."""
    c_max, batches = _shard_batches(packed, arrays, _batch_2d)
    return _sharded_scores_2d, (packed, batches, c_max, config)


def launch_fast_matches_2d(packed, batch, config: FastSearchConfig):
    """The round's search: match_fast_2d_batched over the pack (one K5
    launch per level). On one device `batch` is a CandidateBatch2D; over
    a mesh (packed a MeshPackedSubmaps2D) it is the round's host arrays,
    every process of the mesh entering with the same ones, and each shard
    makes its own K5 launches. Returns device (scores, pose_t, pose_a), in
    routed-row order over a mesh (invalid rows score -inf)."""
    if isinstance(packed, MeshPackedSubmaps2D):
        fn, args = fm_launch_fn_args_2d(packed, batch, config)
        return fn(*args)
    return _launch_on_device_2d(packed, batch, config)


def sharded_fast_matches_2d_packed(packed, candidates, config: FastSearchConfig, profile: Optional[dict] = None,
                                   broadcast=None) -> List[tuple]:
    """One round's candidates in one batched search over the pack (the
    reference's one thread-pool task a candidate,
    constraint_builder_2d.cc:112-160; one launch a shard over a mesh).
    Returns [(score, Rigid2 pose on the card)] in candidate order, after
    one readback of the scores; the caller applies the score gate.
    `broadcast` and `profile` as in sharded_fast_matches_3d_packed."""
    if not candidates:
        return []
    mesh = packed.mesh if isinstance(packed, MeshPackedSubmaps2D) else None
    devices = mesh.devices if mesh is not None else (packed.levels.device,)
    t0 = time.perf_counter()
    if mesh is None:
        batch, rows = build_candidate_arrays_2d(candidates, devices[0]), range(len(candidates))
    else:
        batch, rows = build_candidate_arrays_2d(candidates, mesh, packed.s_per_dev)
    if profile is not None:
        profile["cand_build"] = time.perf_counter() - t0
        t0 = time.perf_counter()
    if broadcast is not None:
        broadcast(batch)
        if profile is not None:
            profile["broadcast"] = time.perf_counter() - t0
            t0 = time.perf_counter()
    scores, pose_t, pose_a = launch_fast_matches_2d(packed, batch, config)
    if profile is not None:
        _sync(devices)
        profile["fm_launch"] = time.perf_counter() - t0
        t0 = time.perf_counter()
    host = scores.tolist()
    if profile is not None:
        profile["fm_readback"] = time.perf_counter() - t0
    return [(host[r], Rigid2(pose_t[r], pose_a[r])) for r in rows]


def sharded_fast_matches_2d(prepared_submaps: Sequence[PreparedFastMatcher2D], candidates,
                            config: FastSearchConfig, device) -> List[tuple]:
    """Every candidate of a round (candidates index `prepared_submaps`) in
    one batched search on `device` or over a Mesh, packing the submaps on
    the fly; a caller that searches often packs once (pack_submaps_2d) and
    calls sharded_fast_matches_2d_packed."""
    if not candidates:
        return []
    return sharded_fast_matches_2d_packed(pack_submaps_2d(prepared_submaps, device), candidates, config)
