#!/usr/bin/env python3
"""Variants of the feature-space kNN kernel (``csrc/knn_wide.cu``), built
side by side and timed in one process on one card:

    python3 scripts/time_knn_wide_variants.py '{"base": {}, "tile32": {"kTile": 32}}'

Each variant is the source with some ``constexpr int`` constants given other
values (``{"name": value}``) and, under ``"_raw"``, exact text replacements
(``[[old, new], ...]``). Every variant is built by its own ``nvcc`` into
``build/knn_wide_variants/<variant>.so`` (all started together), checked
index for index against ``_knn_plain`` at six widths and k, and timed twice
at ``chip_smoke.KNN_WIDE_SHAPES`` with ``chip_smoke.cuda_ms``. Prints one
line per variant with its registers, and one per variant and round with
``ok`` and the milliseconds, shape by shape. Needs CUDA and nvcc.
"""

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
from houv_tpu_torch.kernels._build import _ARCH, _nvcc  # noqa: E402
from houv_tpu_torch.ops import grouping  # noqa: E402

OUT = ROOT / "build" / "knn_wide_variants"


def build(name, subs):
    """Start nvcc on the variant's source; returns (library path, process)."""
    src = (ROOT / "houv_tpu_torch/csrc/knn_wide.cu").read_text()
    subs = dict(subs)
    for old, new in subs.pop("_raw", []):
        if old not in src:
            raise ValueError(f"{name}: no {old!r} in the source")
        src = src.replace(old, new)
    for const, value in subs.items():
        pat = rf"constexpr int {const} = [^;]+;"
        if not re.search(pat, src):
            raise ValueError(f"{name}: no constant {const}")
        src = re.sub(pat, f"constexpr int {const} = {value};", src)
    cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
    cu.write_text(src)
    cmd = [_nvcc(), "-Xptxas=-v", "-gencode", _ARCH, "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-o", str(so), str(cu)]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)


def call(lib, q, r, k):
    """The wrapper's launch (``grouping._knn_cuda``) on a variant library."""
    b, m, c = q.shape
    n = r.shape[1]
    length, parts = grouping._wide_plan(b, m, n, k)
    out = torch.empty((b, m, k), dtype=torch.int64, device=q.device)
    scratch = None if parts == 1 else torch.empty(
        2 * parts * b * m * k, dtype=torch.int32, device=q.device)
    err = lib.houv_knn_wide(
        q.data_ptr(), r.data_ptr(), b, m, n, c, k, length,
        None if scratch is None else scratch.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"houv_knn_wide returned {err}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("time_knn_wide_variants: no CUDA device", file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    started = {name: build(name, subs)
               for name, subs in json.loads(sys.argv[1]).items()}
    libs = {}
    for name, (so, proc) in started.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"{name}: nvcc failed\n{log[-3000:]}", flush=True)
            continue
        regs = re.findall(r"Function properties for \S*?(knn_wide\w*?kernel"
                          r"I\w+?)EEv.*?Used (\d+) registers", log, re.S)
        print(json.dumps({"variant": name, "registers": dict(regs)}),
              flush=True)
        lib = ctypes.CDLL(str(so))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.houv_knn_wide.argtypes = [p, p, i, i, i, i, i, i, p, p, p]
        libs[name] = lib

    gen = torch.Generator().manual_seed(0)
    shapes = {}
    for b, n, c, k in chip_smoke.KNN_WIDE_SHAPES:
        x = torch.randn((b, n, c), generator=gen).cuda()
        shapes[(b, n, c, k)] = torch.relu(x) if k == 16 else x
    checks = [(torch.relu(torch.randn((4, 700, c), generator=gen)).cuda(), k)
              for c, k in ((24, 16), (48, 16), (64, 4), (256, 4), (37, 16),
                           (48, 33))]
    for rnd in range(2):
        for name, lib in libs.items():
            ok = all(bool((call(lib, x, x, k)
                           == grouping._knn_plain(x, x, k)).all())
                     for x, k in checks)
            ms = [chip_smoke.cuda_ms(lambda: call(lib, x, x, s[3]), reps=5)
                  for s, x in shapes.items()]
            print(json.dumps({"variant": name, "round": rnd, "ok": ok,
                              "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
