"""Distributed mapping server (counterpart of hectorgrapher_tpu/cloud/server.py).

(ref: cartographer/cloud/internal/map_builder_server.{h,cc}: a gRPC server
owning a MapBuilder; sensor data arrives through RPC handlers that enqueue
into a queue drained by one SLAM thread, StartSlamThread /
ProcessSensorDataQueue :157-176, pop timeout 100 ms :54;
cloud/proto/map_builder_service.proto, the RPC surface.)

Two layers in this module:

- MapBuilderServerCore: the transport-free server: the sensor queue, the
  SLAM thread (with batch_ct_windows, per-trajectory workers and the
  CtWindowBatcher's batched window solves), the uploader hook and every
  handler, each taking and returning a plain dict. It imports no grpc.
- MapBuilderServer: the core bound to gRPC/HTTP2 with generic method
  handlers, requests and responses pickled through wire.py's restricted
  unpickler. `import grpc` happens in its constructor, not at import.

The RPC names and the request / response dicts are the JAX package's.
Trust model: the data plane is for a private cluster, as in the
reference deployment.

What it records (common/profiling.py): the section server.queue_wait,
an item's time in the sensor queue from its put to its get on the SLAM
thread, and with batch_ct_windows server.drain, one pass of the batched
SLAM loop from the drain to the last worker's join.
"""

from __future__ import annotations

import queue
import threading
import time
import traceback
from typing import Dict, Optional

from hectorgrapher_tpu_torch.cloud import wire
from hectorgrapher_tpu_torch.common import profiling

SERVICE = "hectorgrapher.MapBuilderService"

# The two server-streaming RPCs (ref: map_builder_service.proto
# ReceiveLocalSlamResults / ReceiveGlobalSlamOptimizations).
STREAM_METHODS = ("ReceiveLocalSlamResults", "ReceiveGlobalSlamOptimizations")

# gRPC's default 4 MB receive limit is below one full-size 3D submap's
# payload (GetSubmap of a 256^3 / 128^3 TSDF submap: 72 MB as float16);
# the server, the client stubs and the uploader allow what the wire
# accepts (ROADMAP C24).
CHANNEL_OPTIONS = [("grpc.max_send_message_length", wire.MAX_WIRE_BYTES),
                   ("grpc.max_receive_message_length", wire.MAX_WIRE_BYTES)]

# gRPC's synchronous server runs a server-streaming handler on one of its
# pool's threads for the stream's whole life, so every open subscription
# (one ReceiveLocalSlamResults a robot) holds a thread: the pool keeps
# this many threads for streams beside the num_workers for unary calls,
# else a fleet of more robots than num_workers starves every call.
STREAM_THREADS = 64


class _SensorQueue(queue.Queue):
    """The sensor queue, each item stamped at its put: a get records the
    item's wait into the section server.queue_wait. Items go in and come
    out as they are."""

    def _put(self, item):
        self.queue.append((time.perf_counter_ns(), item))

    def _get(self):
        put_ns, item = self.queue.popleft()
        profiling.section_since("server.queue_wait", put_ns)
        return item


class MapBuilderServerCore:
    """(ref: map_builder_server.h MapBuilderServer, less its transport)"""

    SENSOR_QUEUE_POP_TIMEOUT = 0.1  # seconds (ref :54 kPopTimeout)

    def __init__(self, map_builder, uplink_address: str = None, batch_ct_windows: bool = False, ct_mesh=None):
        self.map_builder = map_builder
        # Cross-trajectory batched CT window serving (cloud/ct_batcher.py):
        # the SLAM loop advances each trajectory on its own thread and
        # solves all ready CT windows in one batched solve; ct_mesh (a Mesh
        # of this process's shards) shards that solve over its shards.
        self.ct_batcher = None
        if batch_ct_windows:
            from hectorgrapher_tpu_torch.cloud.ct_batcher import CtWindowBatcher

            self.ct_batcher = CtWindowBatcher(mesh=ct_mesh)
        self.uploader = None
        if uplink_address:
            from hectorgrapher_tpu_torch.cloud.uploader import LocalTrajectoryUploader

            self.uploader = LocalTrajectoryUploader(uplink_address)
        self._sensor_queue: "queue.Queue" = _SensorQueue()
        # Per-trajectory index of the front insertion submap, advanced when
        # it finishes (ref: map_builder_server.h starting_submap_index_).
        self._starting_submap_index: Dict[int, int] = {}
        self._shutdown = threading.Event()
        self._slam_thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._local_slam_results: Dict[int, list] = {}
        # Streaming subscriptions: trajectory_id -> per-subscriber queues
        # (ref: map_builder_server.cc SubscribeLocalSlamResults).
        self._subscribers: Dict[int, list] = {}
        self._global_opt_subscribers: list = []
        self.handlers = {
            "AddTrajectory": self._handle_add_trajectory,
            "FinishTrajectory": self._handle_finish_trajectory,
            "AddSensorData": self._handle_add_sensor_data,
            "AddSensorDataBatch": self._handle_add_sensor_data_batch,
            "GetLocalToGlobalTransform": self._handle_get_local_to_global,
            "GetTrajectoryNodePoses": self._handle_get_node_poses,
            "GetConstraints": self._handle_get_constraints,
            "RunFinalOptimization": self._handle_run_final_optimization,
            "GetLocalSlamResults": self._handle_get_local_slam_results,
            "WriteState": self._handle_write_state,
            "LoadState": self._handle_load_state,
            "DeleteTrajectory": self._handle_delete_trajectory,
            "GetSubmap": self._handle_get_submap,
            "GetAllSubmapPoses": self._handle_get_all_submap_poses,
            "GetTrajectoryStates": self._handle_get_trajectory_states,
            "GetLandmarkPoses": self._handle_get_landmark_poses,
            "SetLandmarkPose": self._handle_set_landmark_pose,
            "IsTrajectoryFinished": self._handle_is_trajectory_finished,
            "IsTrajectoryFrozen": self._handle_is_trajectory_frozen,
        }
        self.stream_handlers = {
            "ReceiveLocalSlamResults": self._handle_receive_local_slam_results,
            "ReceiveGlobalSlamOptimizations": self._handle_receive_global_slam_optimizations,
        }
        # The full RPC surface (the wire fuzz test calls every method).
        self.method_names = list(self.handlers) + list(STREAM_METHODS)
        # Fan optimization rounds out to subscribers (ref:
        # map_builder_server.cc OnGlobalSlamOptimizations).
        self.map_builder.pose_graph.add_global_slam_optimization_callback(self._on_global_slam_optimization)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        """(ref: MapBuilderServer::Start, StartSlamThread)"""
        self._slam_thread = threading.Thread(target=self._process_sensor_data_queue, daemon=True)
        self._slam_thread.start()
        if self.uploader:
            self.uploader.start()

    def shutdown(self) -> None:
        if self.uploader:
            self.uploader.shutdown()
        self._shutdown.set()
        if self._slam_thread:
            self._slam_thread.join(timeout=10.0)

    def wait_until_idle(self) -> None:
        self._sensor_queue.join()

    def _process_sensor_data_queue(self) -> None:
        """(ref: ProcessSensorDataQueue :157-176: one SLAM thread; with
        batch_ct_windows it coordinates per-trajectory workers and batched
        window solves instead)"""
        while not self._shutdown.is_set():
            try:
                item = self._sensor_queue.get(timeout=self.SENSOR_QUEUE_POP_TIMEOUT)
            except queue.Empty:
                continue
            if self.ct_batcher is None:
                try:
                    self._process_one_item(item)
                finally:
                    self._sensor_queue.task_done()
                continue
            with profiling.section("server.drain"):
                self._drain_batched(item)

    def _drain_batched(self, item) -> None:
        """Batched: drain what is there, group by trajectory (order kept
        within one), advance each group on its own thread, one group's
        host code at a time (CtWindowBatcher.host_turn), and solve the
        ready windows together whenever every live worker waits on one."""
        items = [item]
        while True:
            try:
                items.append(self._sensor_queue.get_nowait())
            except queue.Empty:
                break
        by_traj: Dict[int, list] = {}
        for it in items:
            by_traj.setdefault(it[0], []).append(it)

        def run(traj_items):
            try:
                with self.ct_batcher.host_turn():
                    for it in traj_items:
                        try:
                            self._process_one_item(it)
                        finally:
                            self._sensor_queue.task_done()
            finally:
                self.ct_batcher.finish()

        self.ct_batcher.begin(len(by_traj))
        threads = [threading.Thread(target=run, args=(its,), daemon=True) for its in by_traj.values()]
        for t in threads:
            t.start()
        try:
            self.ct_batcher.serve()
        except Exception:
            # The SLAM thread must survive (a dead one deadlocks every RPC
            # waiting on _sensor_queue.join()); fail the blocked solves so
            # that the workers finish their items.
            traceback.print_exc()
            self.ct_batcher.fail_pending(RuntimeError("ct batcher aborted"))
        for t in threads:
            t.join()

    def _process_one_item(self, item) -> None:
        try:
            trajectory_id, kind, payload = item
            builder = self.map_builder.get_trajectory_builder(trajectory_id)
            if kind == "range":
                result = builder.add_range_data(payload)
                if result is not None:
                    with self._lock:
                        self._local_slam_results.setdefault(trajectory_id, []).append(
                            (result.time, result.local_pose))
                        for q in self._subscribers.get(trajectory_id, ()):
                            q.put((result.time, result.local_pose))
                    if self.uploader is not None and result.insertion_result is not None:
                        self._upload_local_slam_result(trajectory_id, result)
            elif kind == "local_slam_result":
                # Uplink ingestion, past local SLAM (ref:
                # global_trajectory_builder.cc:118-123).
                builder.add_local_slam_result(payload)
            elif kind == "imu":
                builder.add_imu_data(*payload)
            elif kind == "odometry":
                builder.add_odometry_data(*payload)
            elif kind == "fixed_frame":
                builder.add_fixed_frame_pose_data(*payload)
            elif kind == "landmark":
                builder.add_landmark_data(*payload)
        except Exception:
            # One bad item (unknown trajectory, malformed payload, a failed
            # batched solve) must not kill the SLAM thread or its worker.
            traceback.print_exc()

    def _upload_local_slam_result(self, trajectory_id: int, result) -> None:
        """Package and enqueue a local SLAM result for the uplink (ref:
        map_builder_server.cc OnLocalSlamResult:178-205: results, not raw
        data; starting_submap_index_ advances when the front insertion
        submap finished)."""
        from hectorgrapher_tpu_torch.cloud.local_slam_result import make_local_slam_result_payload

        use_3d = self.map_builder._options.use_trajectory_builder_3d
        start = self._starting_submap_index.setdefault(trajectory_id, 0)
        payload = make_local_slam_result_payload(result, use_3d, start)
        if result.insertion_result.insertion_submaps[0].insertion_finished:
            self._starting_submap_index[trajectory_id] = start + 1
        self.uploader.enqueue_sensor_data(trajectory_id, "local_slam_result", payload)

    # -- handlers (ref: cloud/internal/handlers/*) ----------------------------

    def _handle_add_trajectory(self, request):
        trajectory_id = self.map_builder.add_trajectory_builder(
            local_slam_results=bool(request.get("local_slam_results", False)))
        if self.ct_batcher is not None:
            local = getattr(self.map_builder.get_trajectory_builder(trajectory_id), "_local", None)
            if local is not None and hasattr(local, "window_solve_fn"):
                self.ct_batcher.install(local)
        if self.uploader:
            self.uploader.add_trajectory(trajectory_id)
        return {"trajectory_id": trajectory_id}

    def _handle_finish_trajectory(self, request):
        self._sensor_queue.join()
        self.map_builder.finish_trajectory(request["trajectory_id"])
        # End-of-stream sentinel for subscribers (ref: map_builder_server.cc
        # OnLocalSlamResult's final message of a finished trajectory).
        with self._lock:
            for q in self._subscribers.get(request["trajectory_id"], ()):
                q.put(None)
        return {}

    def _handle_add_sensor_data(self, request):
        """(ref: add_rangefinder_data_handler.cc:30-41: enqueue.) IMU,
        odometry, fixed-frame and landmark data go on raw to the uplink;
        range data does not: the uplink receives local SLAM results from
        the SLAM thread (ref: local_trajectory_uploader.h:32-66)."""
        self._sensor_queue.put((request["trajectory_id"], request["kind"], request["payload"]))
        if self.uploader and request["kind"] != "range":
            self.uploader.enqueue_sensor_data(request["trajectory_id"], request["kind"], request["payload"])
        return {}

    def _handle_add_sensor_data_batch(self, request):
        """(ref: add_sensor_data_batch_handler.cc: the uplink's ingestion)"""
        for item in request["items"]:
            self._sensor_queue.put((item["trajectory_id"], item["kind"], item["payload"]))
        return {}

    def _handle_get_local_to_global(self, request):
        pose = self.map_builder.pose_graph.local_to_global(request["trajectory_id"])
        return {"translation": pose.t, "rotation": pose.q}

    def _handle_get_node_poses(self, request):
        self._sensor_queue.join()
        return {"poses": [
            {"time": n.time, "translation": n.global_pose.t, "rotation": n.global_pose.q,
             "trajectory_id": n.trajectory_id}
            for n in self.map_builder.pose_graph.nodes
        ]}

    def _handle_get_constraints(self, request):
        return {"constraints": [
            {"submap_index": c.submap_index, "node_index": c.node_index, "tag": c.tag}
            for c in self.map_builder.pose_graph.constraints
        ]}

    def _handle_run_final_optimization(self, request):
        self._sensor_queue.join()
        self.map_builder.pose_graph.run_final_optimization()
        return {}

    def _handle_get_local_slam_results(self, request):
        """Polling form of the ReceiveLocalSlamResults subscription."""
        with self._lock:
            results = list(self._local_slam_results.get(request["trajectory_id"], []))
        return {"results": results}

    def _handle_receive_local_slam_results(self, request, is_active):
        """Server-streaming subscription (ref: map_builder_server.cc
        SubscribeLocalSlamResults / UnsubscribeLocalSlamResults): replays
        the results that arrived before it, then streams new ones until
        FinishTrajectory (the None sentinel) or until is_active() turns
        false (the client cancelled)."""
        trajectory_id = request["trajectory_id"]
        sub: "queue.Queue" = queue.Queue()
        with self._lock:
            backlog = list(self._local_slam_results.get(trajectory_id, []))
            self._subscribers.setdefault(trajectory_id, []).append(sub)
        try:
            for item in backlog:
                yield {"time": item[0], "local_pose": item[1]}
            while is_active():
                try:
                    item = sub.get(timeout=self.SENSOR_QUEUE_POP_TIMEOUT)
                except queue.Empty:
                    continue
                if item is None:
                    return
                yield {"time": item[0], "local_pose": item[1]}
        finally:
            with self._lock:
                subs = self._subscribers.get(trajectory_id, [])
                if sub in subs:
                    subs.remove(sub)

    def _handle_delete_trajectory(self, request):
        """(ref: delete_trajectory_handler.cc)"""
        self._sensor_queue.join()
        self.map_builder.delete_trajectory(request["trajectory_id"])
        return {}

    def _handle_get_submap(self, request):
        """(ref: get_submap_handler.cc / SubmapQuery: the submap's global
        pose and grid payload; a 3D submap returns both resolutions.)

        The grid references are taken under the pose graph's lock, the
        copy off the card and the packing outside it: a full-grid copy
        under the lock would stall the SLAM threads for the whole RPC.
        The inserters return new planes and never write old ones, so the
        references stay a consistent snapshot."""
        from hectorgrapher_tpu_torch.cloud.local_slam_result import _pack_grid

        pg = self.map_builder.pose_graph
        with pg._lock:
            idx = request["submap_index"]
            if idx < 0 or idx >= len(pg.submaps):
                return {"error": f"submap {idx} out of range"}
            s = pg.submaps[idx]
            out = {
                "submap_index": idx,
                "trajectory_id": s.trajectory_id,
                "finished": s.finished,
                "num_range_data": s.submap.num_range_data,
                "global_translation": s.global_pose.t,
                "global_rotation": s.global_pose.q,
            }
            if hasattr(s.submap, "grid"):
                grids = {"grid": s.submap.grid}
            else:
                grids = {"high_resolution_grid": s.submap.high_resolution_grid,
                         "low_resolution_grid": s.submap.low_resolution_grid}
        for key, grid in grids.items():
            out[key] = _pack_grid(grid, include_arrays=True)
        return out

    def _handle_get_all_submap_poses(self, request):
        """(ref: get_all_submap_poses.cc)"""
        pg = self.map_builder.pose_graph
        with pg._lock:
            return {"submap_poses": [
                {"submap_index": i, "trajectory_id": s.trajectory_id, "finished": s.finished,
                 "translation": s.global_pose.t, "rotation": s.global_pose.q}
                for i, s in enumerate(pg.submaps)
            ]}

    def _handle_get_trajectory_states(self, request):
        """(ref: get_trajectory_states_handler.cc)"""
        states = self.map_builder.pose_graph.trajectory_states()
        return {"trajectory_states": {int(k): v.name for k, v in states.items()}}

    def _handle_get_landmark_poses(self, request):
        """(ref: get_landmark_poses_handler.cc)"""
        poses = self.map_builder.pose_graph.landmark_poses()
        return {"landmark_poses": {name: {"translation": p.t, "rotation": p.q} for name, p in poses.items()}}

    def _handle_set_landmark_pose(self, request):
        """(ref: set_landmark_pose_handler.cc)"""
        from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3

        self.map_builder.pose_graph.set_landmark_pose(
            request["landmark_id"], NpRigid3(request["translation"], request["rotation"]))
        return {}

    def _handle_is_trajectory_finished(self, request):
        """(ref: is_trajectory_finished_handler.cc)"""
        return {"is_finished": self.map_builder.pose_graph.is_finished(request["trajectory_id"])}

    def _handle_is_trajectory_frozen(self, request):
        """(ref: is_trajectory_frozen_handler.cc)"""
        return {"is_frozen": self.map_builder.pose_graph.is_frozen(request["trajectory_id"])}

    def _on_global_slam_optimization(self, num_optimizations: int) -> None:
        with self._lock:
            for q in self._global_opt_subscribers:
                q.put(num_optimizations)

    def _handle_receive_global_slam_optimizations(self, request, is_active):
        """One message per completed optimization, until is_active() turns
        false (ref: receive_global_slam_optimizations_handler.cc)."""
        sub: "queue.Queue" = queue.Queue()
        with self._lock:
            self._global_opt_subscribers.append(sub)
        try:
            while is_active():
                try:
                    n = sub.get(timeout=self.SENSOR_QUEUE_POP_TIMEOUT)
                except queue.Empty:
                    continue
                yield {"num_optimizations": n}
        finally:
            with self._lock:
                if sub in self._global_opt_subscribers:
                    self._global_opt_subscribers.remove(sub)

    def _handle_write_state(self, request):
        from hectorgrapher_tpu_torch.io.serialization import save_state

        self._sensor_queue.join()
        save_state(self.map_builder.pose_graph, request["filename"])
        return {}

    def _handle_load_state(self, request):
        from hectorgrapher_tpu_torch.io.serialization import load_state

        # Drain the sensor queue first: loading while the SLAM thread adds
        # nodes would misalign the offset-based constraint indices.
        self._sensor_queue.join()
        remap = load_state(self.map_builder.pose_graph, request["filename"],
                           load_frozen_state=request.get("load_frozen_state", True))
        return {"trajectory_remapping": remap}


class MapBuilderServer(MapBuilderServerCore):
    """The core bound to gRPC (ref: map_builder_server.h MapBuilderServer).
    Transport: real gRPC/HTTP2 with generic method handlers and pickled
    numpy payloads in place of protoc-generated stubs, decoded through
    wire.py's restricted unpickler."""

    def __init__(self, map_builder, address: str = "127.0.0.1:0", num_workers: int = 4, uplink_address: str = None,
                 batch_ct_windows: bool = False, ct_mesh=None):
        import grpc
        from concurrent import futures

        super().__init__(map_builder, uplink_address=uplink_address, batch_ct_windows=batch_ct_windows,
                         ct_mesh=ct_mesh)
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=num_workers + STREAM_THREADS),
                                   options=CHANNEL_OPTIONS)
        method_handlers = {
            name: grpc.unary_unary_rpc_method_handler(
                lambda request, context, fn=fn: fn(request),
                request_deserializer=wire.loads, response_serializer=wire.dumps)
            for name, fn in self.handlers.items()
        }
        for name, fn in self.stream_handlers.items():
            method_handlers[name] = grpc.unary_stream_rpc_method_handler(
                lambda request, context, fn=fn: fn(request, context.is_active),
                request_deserializer=wire.loads, response_serializer=wire.dumps)
        self._server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(SERVICE, method_handlers),))
        self.port = self._server.add_insecure_port(address)

    def start(self) -> None:
        """(ref: MapBuilderServer::Start: serve, then StartSlamThread)"""
        self._server.start()
        super().start()

    def shutdown(self) -> None:
        super().shutdown()
        self._server.stop(grace=1.0)
