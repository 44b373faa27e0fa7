"""The native C++ prefetching loader of registration training batches
(counterpart of ``houv_tpu/data/native_loader.py``).

``native/houv_loader.cpp`` depends on no framework: a thread pool draws the
train-time poses, jitters and voxelizes, and hands whole batches through a
ring buffer, so no Python runs between the steps' batches. The port builds
it with g++ (the JAX package's flags) into ``build/native/`` at the root of
the checkout, at first use: the library goes to a temporary name and is
renamed into place, so processes that build at once never read a partial
file, and the JAX package's own ``native/libhouv_loader.so`` is left alone.
Batches come out as numpy arrays; the trainer's ``fit_steps`` moves them to
its device.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
_SRC = _ROOT / "native" / "houv_loader.cpp"
_LIB = _ROOT / "build" / "native" / "libhouv_loader.so"

_lock = threading.Lock()
_lib = None


def build_native(force: bool = False) -> Path:
    """The loader's shared library, compiled first if missing or older than
    its source."""
    if not _SRC.exists():
        raise RuntimeError(f"the native loader's source {_SRC} is missing")
    if (_LIB.exists() and not force
            and _LIB.stat().st_mtime >= _SRC.stat().st_mtime):
        return _LIB
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native loader cannot be built")
    _LIB.parent.mkdir(parents=True, exist_ok=True)
    tmp = _LIB.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [gxx, "-O3", "-march=native", "-shared", "-fPIC", "-pthread",
           "-std=c++17", "-o", str(tmp), str(_SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native loader build failed:\n{proc.stderr}")
    os.replace(tmp, _LIB)
    return _LIB


def native_available() -> bool:
    """Whether the loader is built or can be (its source and g++)."""
    return _SRC.exists() and (_LIB.exists() or shutil.which("g++") is not None)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_native()))
            lib.loader_create.restype = ctypes.c_void_p
            lib.loader_create.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_float, ctypes.c_float,
                ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
            ]
            lib.loader_next.restype = ctypes.c_int
            lib.loader_next.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 4
            lib.loader_queue_size.restype = ctypes.c_int64
            lib.loader_queue_size.argtypes = [ctypes.c_void_p]
            lib.loader_destroy.argtypes = [ctypes.c_void_p]
            _lib = lib
        return _lib


class NativeRegistrationLoader:
    """Threaded prefetching loader of registration training batches:
    samples drawn with replacement (step-based training), each batch
    {src, tgt, transform[, coords]} with the reference's train-time poses
    applied natively; ``coords`` are the src points' voxel indices on a
    ``grid_size`` grid over [-0.5, 0.5]."""

    def __init__(self, src: np.ndarray, tgt: np.ndarray, batch_size: int,
                 *, max_angle_deg: float = 45.0, max_trans: float = 0.5,
                 jitter_sigma: float = 0.0, seed: int = 2021,
                 n_threads: int = 4, capacity: int = 8,
                 with_voxels: bool = False, grid_size: int = 50):
        self._lib = _load()
        # the C++ side keeps pointers into these arrays
        self._src = np.ascontiguousarray(src, np.float32)
        self._tgt = np.ascontiguousarray(tgt, np.float32)
        n, n_points, _ = self._src.shape
        self.batch_size = batch_size
        self.n_points = n_points
        self.with_voxels = with_voxels
        self._handle = self._lib.loader_create(
            self._src.ctypes.data, self._tgt.ctypes.data, ctypes.c_int64(n),
            n_points, batch_size, n_threads, capacity,
            ctypes.c_float(np.radians(max_angle_deg)),
            ctypes.c_float(max_trans), ctypes.c_float(jitter_sigma),
            ctypes.c_uint64(seed), int(with_voxels), grid_size)
        if not self._handle:
            raise RuntimeError("loader_create failed")

    def next_batch(self) -> dict:
        b, npts = self.batch_size, self.n_points
        out = {"src": np.empty((b, npts, 3), np.float32),
               "tgt": np.empty((b, npts, 3), np.float32),
               "transform": np.empty((b, 4, 4), np.float32)}
        if self.with_voxels:
            out["coords"] = np.empty((b, npts, 3), np.int32)
        rc = self._lib.loader_next(
            self._handle, out["src"].ctypes.data, out["tgt"].ctypes.data,
            out["transform"].ctypes.data,
            out["coords"].ctypes.data if self.with_voxels else None)
        if rc != 0:
            raise StopIteration("loader stopped")
        return out

    def queue_size(self) -> int:
        """Batches waiting in the ring buffer."""
        return int(self._lib.loader_queue_size(self._handle))

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.loader_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
