"""Checkpoint serialization: save and load the pose graph's state
(counterpart of hectorgrapher_tpu/io/serialization.py).

The file is the JAX package's, byte layout and `__index__` JSON alike, so
a state written by either package loads in the other. The logical schema
follows the reference's pbstream ordering (ref:
cartographer/io/internal/mapping_state_serialization.cc: header
(version), pose graph, submap payloads, node payloads; proto_stream.cc's
gzip container becomes a compressed .npz).

Grids and node clouds leave the card as numpy on save (float planes as
float16, uint16 codes as they are) and load onto the pose graph's device
as float32 planes or uint16 codes, through convert.py's grid builders.

Resume modes (ref: map_builder.cc LoadState:227-404):
  * full: constraints re-added, optimization continues;
  * frozen (load_frozen_state): the trajectory is FROZEN, its poses held
    constant in the SPA; pure localization against a prior map.
"""

from __future__ import annotations

import json
from types import SimpleNamespace
from typing import Dict, Optional

import numpy as np
import torch

from hectorgrapher_tpu_torch import convert
from hectorgrapher_tpu_torch.mapping.grids import TSDFGrid, plane_to_numpy
from hectorgrapher_tpu_torch.mapping.pose_graph.pose_graph import Constraint, PgNode, PgSubmap, TrajectoryState
from hectorgrapher_tpu_torch.mapping.submap_2d import Submap2D
from hectorgrapher_tpu_torch.mapping.submap_3d import Submap3D
from hectorgrapher_tpu_torch.sensor.types import PointCloud
from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3

SERIALIZATION_VERSION = 2  # the reference's current format version
MAGIC = "hectorgrapher_tpu_state"


def migrate_state_v1_to_v2(in_path: str, out_path: str) -> int:
    """Migrate a version-1 state file to version 2 (serialization.py
    :41-63). Version 1 predates per-submap rotational histograms; each 3D
    submap's is recomputed as the sum of the histograms of the nodes
    constrained INTRA to it, as the reference does (ref:
    io/serialization_format_migration.cc
    MigrateSubmapFormatVersion1ToVersion2). Returns the number of submaps
    migrated."""
    with np.load(in_path, allow_pickle=False) as data:
        arrays = {k: data[k] for k in data.files if k != "__index__"}
        index = json.loads(bytes(data["__index__"]).decode())
    if index["magic"] != MAGIC:
        raise ValueError("not a hectorgrapher_tpu state file")
    if index["version"] >= SERIALIZATION_VERSION:
        raise ValueError(f"state already at version {index['version']}")
    migrated = _recompute_missing_submap_histograms(index, arrays)
    index["version"] = SERIALIZATION_VERSION
    arrays["__index__"] = np.frombuffer(json.dumps(index).encode(), dtype=np.uint8)
    np.savez_compressed(out_path, **arrays)
    return migrated


def _intra_histogram(index: Dict, i: int, arrays) -> Optional[np.ndarray]:
    """The sum of the histograms of the nodes constrained INTRA to submap
    i, or None without one."""
    hist = None
    for c in index["constraints"]:
        key = f"node{c['node_index']}_histogram"
        if c["tag"] == "INTRA" and c["submap_index"] == i and key in arrays:
            hist = arrays[key] if hist is None else hist + arrays[key]
    return hist


def _recompute_missing_submap_histograms(index: Dict, arrays: Dict) -> int:
    migrated = 0
    for i, entry in enumerate(index["submaps"]):
        if entry.get("kind") != "3d" or f"submap{i}_histogram" in arrays:
            continue
        hist = _intra_histogram(index, i, arrays)
        if hist is None:
            # No node data to recompute from: an empty histogram, as the
            # reference's migration gives submaps without nodes.
            size = next((arrays[k].shape[0] for k in arrays if k.endswith("_histogram")), 128)
            hist = np.zeros(size, np.float32)
        arrays[f"submap{i}_histogram"] = np.asarray(hist, np.float32)
        migrated += 1
    return migrated


def _rigid_to_arr(p: NpRigid3) -> np.ndarray:
    return np.concatenate([np.asarray(p.t, np.float64), np.asarray(p.q, np.float64)])


def _rigid_from_arr(a) -> NpRigid3:
    return NpRigid3(np.asarray(a[:3]), np.asarray(a[3:7]))


def _grid_payload(prefix: str, grid, out: Dict[str, np.ndarray]) -> Dict:
    """A grid's planes into `out` as numpy, its metadata returned
    (serialization.py _grid_payload :100-128)."""
    meta = {"resolution": float(grid.meta.resolution)}
    out[f"{prefix}_min_corner"] = grid.meta.min_corner.cpu().numpy()
    if isinstance(grid, TSDFGrid):
        out[f"{prefix}_tsd"] = plane_to_numpy(grid.tsd)
        out[f"{prefix}_weight"] = plane_to_numpy(grid.weight)
        if out[f"{prefix}_tsd"].dtype == np.uint16:
            # uint16-quantized submap: the codes verbatim (the reference's
            # pbstream stores uint16 cells, hybrid_grid_tsdf.h).
            meta["quantized"] = True
        meta["type"] = "tsdf"
        meta["truncation_distance"] = float(grid.truncation_distance)
        meta["max_weight"] = float(grid.max_weight)
    else:
        out[f"{prefix}_log_odds"] = plane_to_numpy(grid.log_odds)
        if out[f"{prefix}_log_odds"].dtype == np.uint16:
            meta["quantized"] = True
        out[f"{prefix}_known"] = grid.known.cpu().numpy()
        meta["type"] = "probability"
    return meta


def _grid_from_payload(prefix: str, meta: Dict, data, device):
    """(serialization.py _grid_from_payload :131-150) float32 planes, or
    uint16 codes for a quantized grid, on `device`."""
    dt = np.uint16 if meta.get("quantized", False) else np.float32
    gmeta = SimpleNamespace(resolution=np.float32(meta["resolution"]),
                            min_corner=np.asarray(data[f"{prefix}_min_corner"], np.float32))
    if meta["type"] == "tsdf":
        return convert.tsdf_grid(SimpleNamespace(
            tsd=np.asarray(data[f"{prefix}_tsd"], dt),
            weight=np.asarray(data[f"{prefix}_weight"], dt),
            truncation_distance=np.float32(meta["truncation_distance"]),
            max_weight=np.float32(meta["max_weight"]),
            meta=gmeta,
        ), device)
    return convert.probability_grid(SimpleNamespace(
        log_odds=np.asarray(data[f"{prefix}_log_odds"], dt),
        known=np.asarray(data[f"{prefix}_known"]),
        meta=gmeta,
    ), device)


def _cloud_payload(prefix: str, cloud: Optional[PointCloud], out: Dict) -> bool:
    if cloud is None:
        return False
    out[f"{prefix}_positions"] = cloud.positions.to(torch.float32).cpu().numpy()
    out[f"{prefix}_mask"] = cloud.mask.cpu().numpy()
    return True


def _cloud_from_payload(prefix: str, data, device) -> Optional[PointCloud]:
    key = f"{prefix}_positions"
    if key not in data:
        return None
    return convert.point_cloud(SimpleNamespace(positions=data[key], mask=data[f"{prefix}_mask"]), device)


def save_state(pose_graph, path: str) -> None:
    """Serialize the pose graph (nodes, submaps, constraints) to .npz.

    Holds the pose graph's host lock for the whole snapshot, as JAX does
    (:167-179): with the async work queue, a constraint appended between
    the index pass and the zbar pass would desynchronize
    index['constraints'] from constraint_zbars."""
    with pose_graph._lock:
        _save_state_locked(pose_graph, path)


def _save_state_locked(pose_graph, path: str) -> None:
    arrays: Dict[str, np.ndarray] = {}
    index: Dict = {
        "magic": MAGIC,
        "version": SERIALIZATION_VERSION,
        "dim": 3 if hasattr(pose_graph, "_histogram_size") else 2,
        "nodes": [],
        "submaps": [],
        "constraints": [],
        "trajectory_states": {str(k): v.name for k, v in pose_graph._trajectory_states.items()},
    }

    for i, node in enumerate(pose_graph.nodes):
        entry = {
            "time": float(node.time),
            "trajectory_id": int(node.trajectory_id),
            "has_histogram": node.histogram is not None,
        }
        arrays[f"node{i}_local"] = _rigid_to_arr(node.local_pose)
        arrays[f"node{i}_global"] = _rigid_to_arr(node.global_pose)
        if node.histogram is not None:
            arrays[f"node{i}_histogram"] = np.asarray(node.histogram)
        if node.gravity_alignment is not None:
            arrays[f"node{i}_gravity"] = np.asarray(node.gravity_alignment)
        entry["has_cloud"] = _cloud_payload(f"node{i}_cloud", node.cloud, arrays)
        entry["has_high"] = _cloud_payload(f"node{i}_high", node.high_cloud, arrays)
        entry["has_low"] = _cloud_payload(f"node{i}_low", node.low_cloud, arrays)
        index["nodes"].append(entry)

    for i, pg_submap in enumerate(pose_graph.submaps):
        submap = pg_submap.submap
        entry = {
            "trajectory_id": int(pg_submap.trajectory_id),
            "finished": bool(pg_submap.finished),
            "num_range_data": int(submap.num_range_data),
        }
        arrays[f"submap{i}_local"] = _rigid_to_arr(submap.local_pose)
        arrays[f"submap{i}_global"] = _rigid_to_arr(pg_submap.global_pose)
        if isinstance(submap, Submap3D):
            entry["kind"] = "3d"
            entry["high_meta"] = _grid_payload(f"submap{i}_high", submap.high_resolution_grid, arrays)
            entry["low_meta"] = _grid_payload(f"submap{i}_low", submap.low_resolution_grid, arrays)
            arrays[f"submap{i}_histogram"] = np.asarray(submap.rotational_histogram)
        else:
            entry["kind"] = "2d"
            entry["grid_meta"] = _grid_payload(f"submap{i}_grid", submap.grid, arrays)
        index["submaps"].append(entry)

    for c in pose_graph.constraints:
        index["constraints"].append({
            "submap_index": int(c.submap_index),
            "node_index": int(c.node_index),
            "translation_weight": float(c.translation_weight),
            "rotation_weight": float(c.rotation_weight),
            "tag": c.tag,
        })
    arrays["constraint_zbars"] = (np.stack([_rigid_to_arr(c.zbar) for c in pose_graph.constraints])
                                  if pose_graph.constraints else np.zeros((0, 7)))

    arrays["__index__"] = np.frombuffer(json.dumps(index).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_state(pose_graph, path: str, load_frozen_state: bool = True) -> Dict[int, int]:
    """Load a serialized state into `pose_graph`, its grids and clouds on
    the pose graph's device. Returns the trajectory-id remapping
    {serialized_id: new_id} (ref: map_builder.cc LoadState:237-252, and
    FreezeTrajectory with load_frozen_state).

    Holds the pose graph's host lock, as save_state does and as JAX does
    (:262): loading into a live graph must not interleave with the async
    work queue adding nodes and constraints, or the offset-based
    constraint indices land on the wrong entries."""
    device = pose_graph._device
    with pose_graph._lock, np.load(path, allow_pickle=False) as data:
        index = json.loads(bytes(data["__index__"]).decode())
        if index["magic"] != MAGIC:
            raise ValueError("not a hectorgrapher_tpu state file")
        version = index["version"]
        if version > SERIALIZATION_VERSION:
            raise ValueError(f"unknown state version {version}")

        old_ids = sorted({e["trajectory_id"] for e in index["nodes"]} | {e["trajectory_id"] for e in index["submaps"]})
        base = max(pose_graph._trajectory_states.keys(), default=-1) + 1
        remap = {old: base + i for i, old in enumerate(old_ids)}

        node_offset = len(pose_graph.nodes)
        submap_offset = len(pose_graph.submaps)

        for i, entry in enumerate(index["nodes"]):
            node = PgNode(
                time=entry["time"],
                local_pose=_rigid_from_arr(data[f"node{i}_local"]),
                global_pose=_rigid_from_arr(data[f"node{i}_global"]),
                trajectory_id=remap[entry["trajectory_id"]],
                cloud=_cloud_from_payload(f"node{i}_cloud", data, device),
                high_cloud=_cloud_from_payload(f"node{i}_high", data, device),
                low_cloud=_cloud_from_payload(f"node{i}_low", data, device),
                histogram=np.asarray(data[f"node{i}_histogram"]) if entry.get("has_histogram") else None,
                gravity_alignment=np.asarray(data[f"node{i}_gravity"]) if f"node{i}_gravity" in data else None,
            )
            node.node_id = pose_graph._next_node_id
            pose_graph._next_node_id += 1
            pose_graph._node_index_by_id[node.node_id] = len(pose_graph.nodes)
            pose_graph.nodes.append(node)

        for i, entry in enumerate(index["submaps"]):
            local_pose = _rigid_from_arr(data[f"submap{i}_local"])
            if entry["kind"] == "3d":
                if f"submap{i}_histogram" in data:
                    histogram = np.asarray(data[f"submap{i}_histogram"])
                else:
                    # A version-1 file: recomputed from the INTRA-constrained
                    # nodes' histograms, the reference's on-load migration
                    # (ref: map_builder.cc:366-373).
                    if version != 1:
                        raise ValueError(f"version {version} 3D submap {i} has no histogram")
                    histogram = _intra_histogram(index, i, data)
                    if histogram is None:
                        histogram = np.zeros(128, np.float32)
                submap = Submap3D(
                    local_pose=local_pose,
                    high_resolution_grid=_grid_from_payload(f"submap{i}_high", entry["high_meta"], data, device),
                    low_resolution_grid=_grid_from_payload(f"submap{i}_low", entry["low_meta"], data, device),
                    rotational_histogram=histogram,
                    num_range_data=entry["num_range_data"],
                    insertion_finished=entry["finished"],
                )
            else:
                submap = Submap2D(
                    local_pose=local_pose,
                    grid=_grid_from_payload(f"submap{i}_grid", entry["grid_meta"], data, device),
                    num_range_data=entry["num_range_data"],
                    insertion_finished=entry["finished"],
                )
            pg_submap = PgSubmap(
                submap=submap,
                global_pose=_rigid_from_arr(data[f"submap{i}_global"]),
                trajectory_id=remap[entry["trajectory_id"]],
                finished=entry["finished"],
            )
            pg_submap.submap_id = pose_graph._next_submap_id
            pose_graph._next_submap_id += 1
            pose_graph._submap_index_by_id[pg_submap.submap_id] = len(pose_graph.submaps)
            pose_graph.submaps.append(pg_submap)
            pose_graph._submap_ids[id(submap)] = submap_offset + i

        zbars = data["constraint_zbars"]
        for ci, entry in enumerate(index["constraints"]):
            pose_graph.constraints.append(Constraint(
                submap_index=entry["submap_index"] + submap_offset,
                node_index=entry["node_index"] + node_offset,
                zbar=_rigid_from_arr(zbars[ci]),
                translation_weight=entry["translation_weight"],
                rotation_weight=entry["rotation_weight"],
                tag=entry["tag"],
            ))

        for old, new in remap.items():
            if load_frozen_state:
                pose_graph._trajectory_states[new] = TrajectoryState.FROZEN
            else:
                pose_graph._trajectory_states[new] = TrajectoryState[index["trajectory_states"].get(str(old),
                                                                                               "FINISHED")]
    return remap
