"""Build the CUDA kernels of ``houv_tpu_torch/csrc`` and load them with ctypes.

The sources have a plain C interface, so ``nvcc`` builds them in seconds into
``build/kernels/libhouv_kernels.so`` at the root of the checkout, at first use
(never at import): one ``nvcc`` per source, all started together, then one
link. A library newer than every file of ``csrc/``, the headers the sources
include among them, is reused.
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
    # a, b, bq, bk, n, m, qlen, rlen, i1, i2, stream
    "houv_nn_both": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    # pts, b, n, k, warps, per, out, stream
    "houv_fps": [_P, _I, _I, _I, _I, _I, _P, _P],
    "houv_fps_max_points": [],
    # pts, b, n, k, c, warps, per, out, stream
    "houv_fps_large": [_P, _I, _I, _I, _I, _I, _I, _P, _P],
    "houv_fps_large_max_points": [],
    # c, warps, per
    "houv_fps_large_max_clusters": [_I, _I, _I],
    # pts, b, n, k, work, out, stream
    "houv_fps_global": [_P, _I, _I, _I, _P, _P, _P],
    # query, ref, b, m, n, k, per, len, scratch, out, stream
    "houv_knn": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    "houv_knn_max_k": [],
    # x1, x2, b, n, m, eps, iters, clusters, dist, assign, stats, stream
    "houv_emd": [_P, _P, _I, _I, _I, ctypes.c_float, _I, _I, _P, _P, _P, _P],
    "houv_emd_smem_bytes": [_I, _I],
    "houv_emd_max_clusters": [_I, _I, _I],
    "houv_emd_max_smem_bytes": [],
    # x1, x2, b, n, m, eps, iters, clusters, dist, assign, stats, stream
    "houv_emd_large": [_P, _P, _I, _I, _I, ctypes.c_float, _I, _I, _P, _P, _P,
                       _P],
    # n, m, c
    "houv_emd_large_smem_bytes": [_I, _I, _I],
    "houv_emd_large_max_clusters": [_I, _I, _I],
    # x1, x2, b, n, m, eps, iters, clusters, items, key, owner, list, item,
    # cnt, dist, assign, stats, stream
    "houv_emd_global": [_P, _P, _I, _I, _I, ctypes.c_float, _I, _I, _P, _P,
                        _P, _P, _P, _P, _P, _P, _P, _P],
    "houv_emd_global_max_clusters": [_I],
    # idx, vals, b, n, m, c, rows, out, stream
    "houv_scatter_add": [_P, _P, _I, _I, _I, _I, _I, _P, _P],
    "houv_scatter_max_channels": [],
    # query, ref, b, m, n, c, k, len, scratch, out, stream
    "houv_knn_wide": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    "houv_knn_wide_max_k": [],
    # a, b, bq, bk, n, m, qlen, rlen, c1, c2, key1, key2, stream
    "houv_nn_select": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    # src, idx, b, m, n, c, out, stream
    "houv_gather_rows": [_P, _P, _I, _I, _I, _I, _P, _P],
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
    """True if the library is missing or older than a file of ``csrc/``: a
    source, or a header that sources include (``nn_search.cuh``)."""
    if not _LIB_PATH.exists():
        return True
    built = _LIB_PATH.stat().st_mtime
    return any(f.stat().st_mtime > built for f in _CSRC.iterdir()
               if f.is_file())


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
