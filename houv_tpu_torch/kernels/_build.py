"""Build the CUDA kernels of ``houv_tpu_torch/csrc`` and load them with ctypes.

The sources have a plain C interface, so ``nvcc`` builds them in seconds into
``build/kernels/libhouv_kernels.so`` at the root of the checkout, at first use
(never at import): one ``nvcc`` per source, all started together, then one
link. A library newer than every source is reused.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_LIB_PATH = _BUILD_DIR / "libhouv_kernels.so"
_ARCH = "arch=compute_90a,code=sm_90a"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # a, b, bq, bk, n, m, i1, key2, stream
    "houv_nn_both": [_P, _P, _I, _I, _I, _I, _P, _P, _P],
    # pts, b, n, k, out, stream
    "houv_fps": [_P, _I, _I, _I, _P, _P],
    "houv_fps_max_points": [],
    # query, ref, b, m, n, k, out, stream
    "houv_knn": [_P, _P, _I, _I, _I, _I, _P, _P],
    "houv_knn_max_k": [],
    # x1, x2, b, n, m, eps, iters, dist, assign, stats, stream
    "houv_emd": [_P, _P, _I, _I, _I, ctypes.c_float, _I, _P, _P, _P, _P],
    "houv_emd_smem_bytes": [_I, _I],
    "houv_emd_max_smem_bytes": [],
    # idx, vals, b, n, m, c, out, stream
    "houv_scatter_add": [_P, _P, _I, _I, _I, _I, _P, _P],
    "houv_scatter_max_channels": [],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def _run(procs: list[tuple[list[str], subprocess.Popen]]) -> str:
    """Wait for every process; raise on the first that failed."""
    logs = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            for _, other in procs:
                other.kill()
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{out}")
        logs.append(out)
    return "".join(logs)


def build(verbose: bool = False) -> Path:
    """Compile every ``csrc/*.cu`` into one shared library; returns its path."""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    flags = ["-gencode", _ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
    if verbose:
        flags.insert(0, "-Xptxas=-v")
    objs, procs = [], []
    for src in sources():
        obj = _BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [_nvcc(), *flags, "-c", "-o", str(obj), str(src)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    tmp = _LIB_PATH.with_suffix(f".{tag}")
    try:
        log = _run(procs)
        link = [_nvcc(), "-gencode", _ARCH, "-shared", "-o", str(tmp),
                *map(str, objs)]
        log += _run([(link, subprocess.Popen(
            link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))])
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    if verbose:
        print(log, flush=True)
    os.replace(tmp, _LIB_PATH)
    return _LIB_PATH


def _stale() -> bool:
    if not _LIB_PATH.exists():
        return True
    built = _LIB_PATH.stat().st_mtime
    return any(src.stat().st_mtime > built for src in sources())


def load() -> ctypes.CDLL:
    """The kernel library, built first if missing or older than a source."""
    global _lib
    with _lock:
        if _lib is None:
            if _stale():
                build()
            lib = ctypes.CDLL(str(_LIB_PATH))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.houv_error_string.argtypes = [ctypes.c_int]
            lib.houv_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, err: int, name: str) -> None:
    """Raise if a kernel entry returned a CUDA error."""
    if err != 0:
        msg = lib.houv_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")
