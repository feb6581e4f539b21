"""Wire (de)serialization for the RPC layer: pickle with a restricted
unpickler (counterpart of hectorgrapher_tpu/cloud/wire.py).

The reference speaks protobuf (cloud/proto/map_builder_service.proto);
this keeps pickle for the private-cluster data plane but removes its
arbitrary-code-execution property: `loads` refuses to resolve any class
outside an explicit whitelist of data-only containers (numpy array
reconstruction and this package's value types). A hostile peer reaching
the port can send malformed data, but cannot make the server import or
call anything else (the classic `__reduce__` -> `os.system` pickle fails
with WirePayloadError).

Every payload that crosses is numpy: the whitelist names no torch type,
so a pickled tensor (rebuilt through torch._utils and storage classes)
is refused. Grids and node clouds become numpy in local_slam_result.py
before they reach the wire, the solver plane's SPA problems and pack
arrays in the pose graph.
"""

from __future__ import annotations

import io
import pickle

import numpy as np

dumps = pickle.dumps


class WirePayloadError(Exception):
    """A wire payload referenced a type outside the whitelist."""


_ALLOWED = {
    # numpy array/scalar reconstruction (module path moved in numpy 2.x).
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    # This package's value types that cross the RPC boundary: the sensor
    # data the handlers receive (IMU, odometry, fixed-frame and landmark
    # data arrive as tuples of numbers, numpy arrays and NpRigid3) and the
    # uplink's payloads.
    ("hectorgrapher_tpu_torch.transform.np_quat", "NpRigid3"),
    ("hectorgrapher_tpu_torch.sensor.types", "PointCloud"),
    ("hectorgrapher_tpu_torch.sensor.types", "TimedPointCloud"),
    ("hectorgrapher_tpu_torch.sensor.types", "TimedPointCloudData"),
    ("hectorgrapher_tpu_torch.cloud.local_slam_result", "LocalSlamResultPayload"),
    ("hectorgrapher_tpu_torch.cloud.local_slam_result", "SubmapPayload"),
    # The solver plane's SPA problems (cloud/solver_plane.py), with numpy
    # leaves.
    ("hectorgrapher_tpu_torch.mapping.pose_graph.optimization", "SpaProblem2D"),
    ("hectorgrapher_tpu_torch.mapping.pose_graph.optimization", "SpaProblem3D"),
    # Builtin value containers that pickle via find_class.
    ("builtins", "complex"),
    ("builtins", "set"),
    ("builtins", "frozenset"),
    ("builtins", "bytearray"),
    ("builtins", "slice"),
    ("builtins", "range"),
}

# numpy 2 dtype classes (numpy.dtypes.Float64DType, ...) appear in pickles
# of structured dtypes; they are data-only descriptors.
_ALLOWED_MODULES = ("numpy.dtypes",)


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _ALLOWED or module in _ALLOWED_MODULES:
            return super().find_class(module, name)
        raise WirePayloadError(f"wire payload references forbidden type {module}.{name}")


# Sanity caps on decoded payloads. numpy's __setstate__ rejects
# shape/buffer mismatches, so a pickle cannot allocate more array memory
# than it ships; what is left is pointer fan-out (a small stream building
# huge containers of repeated references) and unbounded nesting. Both are
# capped after decode, the raw payload size before it.
MAX_WIRE_BYTES = 256 * 1024 * 1024
MAX_TOTAL_ARRAY_BYTES = 1024 * 1024 * 1024
MAX_ARRAY_NDIM = 8
MAX_CONTAINER_LEN = 1 << 24
MAX_DEPTH = 64


def _validate(obj) -> None:
    total_array_bytes = 0
    stack = [(obj, 0)]
    while stack:
        value, depth = stack.pop()
        if depth > MAX_DEPTH:
            raise WirePayloadError("wire payload nesting exceeds MAX_DEPTH")
        if isinstance(value, np.ndarray):
            if value.ndim > MAX_ARRAY_NDIM:
                raise WirePayloadError(f"array ndim {value.ndim} > {MAX_ARRAY_NDIM}")
            total_array_bytes += value.nbytes
            if total_array_bytes > MAX_TOTAL_ARRAY_BYTES:
                raise WirePayloadError("wire payload array bytes exceed cap")
        elif isinstance(value, dict):
            if len(value) > MAX_CONTAINER_LEN:
                raise WirePayloadError("wire payload container too large")
            stack.extend((v, depth + 1) for v in value.values())
            stack.extend((k, depth + 1) for k in value.keys())
        elif isinstance(value, (list, tuple, set, frozenset)):  # NamedTuples too
            if len(value) > MAX_CONTAINER_LEN:
                raise WirePayloadError("wire payload container too large")
            stack.extend((v, depth + 1) for v in value)
        elif hasattr(value, "__dict__") and type(value).__module__.startswith("hectorgrapher_tpu_torch"):
            stack.extend((v, depth + 1) for v in vars(value).values())


def loads(data: bytes):
    """Deserialize an RPC payload, refusing non-whitelisted types,
    oversized messages, and decoded structures past the sanity caps."""
    if len(data) > MAX_WIRE_BYTES:
        raise WirePayloadError(f"wire payload {len(data)} bytes exceeds MAX_WIRE_BYTES")
    obj = _RestrictedUnpickler(io.BytesIO(data)).load()
    _validate(obj)
    return obj
