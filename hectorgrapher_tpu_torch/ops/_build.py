"""Builds the package's CUDA kernels from csrc/*.cu on first use.

nvcc compiles every source to an object file, all at once in parallel,
and links them into one shared library with a plain C interface, which is
loaded with ctypes. The library lands in
hectorgrapher_tpu_torch/_build/ under a name that carries the hash of the
sources, their headers (csrc/*.cuh) and flags, so an edited source is
rebuilt and a stale library is never loaded. A failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"

# --fmad=false: no multiply-add contraction anywhere, so every f32 multiply
# and add rounds on its own, as the JAX source writes the arithmetic (the
# prep kernel also spells this out with __fmul_rn/__fadd_rn intrinsics).
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_lib = None
_lock = threading.Lock()  # the pose graph's worker thread may be first to launch a kernel
build_log = ""  # nvcc's output of the last build (register and smem use)
build_seconds = 0.0  # 0.0 when the library was already built


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built if needed. Raises on a machine
    without a CUDA card: nothing falls back to the CPU."""
    global _lib
    with _lock:
        if _lib is None:
            if not torch.cuda.is_available():
                raise RuntimeError("hectorgrapher_tpu_torch's kernels need a CUDA card and "
                                   "torch.cuda.is_available() is false; pass device='cpu' to run on the CPU")
            _lib = _load()
        return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Launch the library's entry `name` on `device`'s current stream (its
    last argument) and raise if the launch failed. Switches the current
    device only when `device` is not already current."""
    fn = getattr(_lib or load_library(), name)
    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index == torch.cuda.current_device():
        status = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            status = fn(*args, stream)
    check_launch(status, name)


def _load() -> ctypes.CDLL:
    global build_log, build_seconds
    sources = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(_CSRC.glob("*.cuh")):  # the headers the sources include
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    target = _BUILD / f"libhg_kernels_{digest.hexdigest()[:16]}.so"
    if not target.exists():
        t0 = time.perf_counter()
        build_log = build(sources, target)
        build_seconds = time.perf_counter() - t0
    return bind(target)


def build(sources, target: Path) -> str:
    """Compile `sources` with nvcc (one process per source, all at once)
    and link them into the shared library `target`, replacing it whole.
    Returns nvcc's output; raises with it when a step fails."""
    target.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{target.stem}.{os.getpid()}"
    nvcc = _nvcc()
    objects = [target.parent / f"{src.stem}.{tag}.o" for src in sources]
    compiles = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)] for src, obj in zip(sources, objects))
    ]
    logs = []
    for cmd, proc in compiles:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            for _, other in compiles:
                other.wait()
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp), *map(str, objects)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = "".join(logs) + proc.stdout + proc.stderr
    for obj in objects:
        obj.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    os.replace(tmp, target)
    return log


def bind(path: Path) -> ctypes.CDLL:
    """Load the kernels' library at `path` and declare its entry points."""
    lib = ctypes.CDLL(str(path))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.hg_error_string.argtypes = [i32]
    lib.hg_error_string.restype = ctypes.c_char_p
    # Pointers and the stream as c_void_p: ctypes would cut a bare Python
    # int to 32 bits.
    lib.hg_correlative_prep_2d.argtypes = [ptr] * 7 + [i32] * 7 + [ptr]
    lib.hg_correlative_prep_2d.restype = i32
    lib.hg_correlative_scores_2d.argtypes = [ptr] * 5 + [i32] * 7 + [ptr]
    lib.hg_correlative_scores_2d.restype = i32
    lib.hg_ct_scan_block.argtypes = [ptr] * 16 + [i32] * 10 + [ptr]
    lib.hg_ct_scan_block.restype = i32
    lib.hg_ct_scan_block_slots.argtypes = [ptr] * 14 + [i32] * 10 + [ptr]
    lib.hg_ct_scan_block_slots.restype = i32
    lib.hg_ct_scan_block_points.argtypes = [ptr] * 16 + [i32] * 11 + [ptr]
    lib.hg_ct_scan_block_points.restype = i32
    lib.hg_ct_scan_block_points_slots.argtypes = [ptr] * 14 + [i32] * 11 + [ptr]
    lib.hg_ct_scan_block_points_slots.restype = i32
    lib.hg_ct_pair_residuals.argtypes = [ptr] * 16 + [i32] * 2 + [ptr]
    lib.hg_ct_pair_residuals.restype = i32
    lib.hg_ct_cloud_poses.argtypes = [ptr] * 7 + [i32] * 4 + [ptr]
    lib.hg_ct_cloud_poses.restype = i32
    lib.hg_fast_scores_3d.argtypes = [ptr] * 11 + [i32] * 13 + [ptr]
    lib.hg_fast_scores_3d.restype = i32
    lib.hg_fast_scores_2d.argtypes = [ptr] * 9 + [i32] * 9 + [ptr]
    lib.hg_fast_scores_2d.restype = i32
    lib.hg_gn_2d_lm.argtypes = [ptr] * 13 + [i32] * 4 + [f32] * 6 + [ptr]
    lib.hg_gn_2d_lm.restype = i32
    return lib


def check_launch(status: int, name: str) -> None:
    """Raise if a kernel's launch returned a CUDA error code."""
    if status != 0:
        lib = load_library()
        msg = lib.hg_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status} at launch: {msg}")
