#!/usr/bin/env python3
"""Variants of the nearest-neighbour search kernel (``csrc/nn_both.cu``),
built side by side and timed in one process on one card:

    python3 scripts/time_nn_both_variants.py '{"base": {}, "two_blocks":
        {"_raw": [["__launch_bounds__(kThreads, 3)",
                   "__launch_bounds__(kThreads, 2)"]]}}'

Each variant is the source with some ``constexpr int`` constants given other
values (``{"name": value}``) and, under ``"_raw"``, exact text replacements
(``[[old, new], ...]``); ``"_blocks_per_sm"`` replaces the launch plan's
``_NN_MIN_BLOCKS_PER_SM`` (``ops/chamfer.py:_nn_plan``) for that variant.
Every variant is built by its own ``nvcc`` into
``build/nn_both_variants/<variant>.so`` (all started together), checked
index for index against ``_nn_both_plain`` on random clouds, planted copies
and an integer grid, and timed twice at ``chip_smoke.NN_SHAPES`` with
``chip_smoke.cuda_ms``. Prints a line with the card's name and power
limit, one per variant with its registers and spills, and one per variant
and round with ``ok`` and the milliseconds, shape by shape. A variant that
switches a part of the search off is timed all the same, and its ``ok``
says so. Needs CUDA and nvcc.
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
from houv_tpu_torch.ops import chamfer  # noqa: E402

OUT = ROOT / "build" / "nn_both_variants"


def build(name, subs):
    """Start nvcc on the variant's source; returns (library path, process)."""
    src = (ROOT / "houv_tpu_torch/csrc/nn_both.cu").read_text()
    subs = dict(subs)
    subs.pop("_blocks_per_sm", None)
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


def call(lib, a, b, blocks_per_sm):
    """The wrapper's launch (``chamfer._nn_both_cuda``) on a variant
    library, with its plan's blocks per SM."""
    bq, n, _ = a.shape
    bk, m, _ = b.shape
    saved = chamfer._NN_MIN_BLOCKS_PER_SM
    chamfer._NN_MIN_BLOCKS_PER_SM = blocks_per_sm
    try:
        qlen, rlen = chamfer._nn_plan(bk, n, m, chamfer._sm_count(b.device))
    finally:
        chamfer._NN_MIN_BLOCKS_PER_SM = saved
    i1 = torch.empty((bk, n), dtype=torch.int64, device=b.device)
    i2 = torch.empty((bk, m), dtype=torch.int64, device=b.device)
    err = lib.houv_nn_both(a.data_ptr(), b.data_ptr(), bq, bk, n, m, qlen,
                           rlen, i1.data_ptr(), i2.data_ptr(),
                           torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"houv_nn_both returned {err}")
    return i1, i2


def main() -> int:
    if not torch.cuda.is_available():
        print("time_nn_both_variants: no CUDA device", file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    print(json.dumps({"card": chip_smoke.card_line()}), flush=True)
    variants = json.loads(sys.argv[1])
    started = {name: build(name, subs) for name, subs in variants.items()}
    libs = {}
    for name, (so, proc) in started.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"{name}: nvcc failed\n{log[-3000:]}", flush=True)
            continue
        props = re.search(r"nn_both_kernel\w*' for 'sm_90a'.*?(\d+) bytes "
                          r"spill stores, (\d+) bytes spill loads.*?Used "
                          r"(\d+) registers", log, re.S)
        print(json.dumps({"variant": name, "spill_stores": int(props[1]),
                          "spill_loads": int(props[2]),
                          "registers": int(props[3])}), flush=True)
        lib = ctypes.CDLL(str(so))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.houv_nn_both.argtypes = [p, p, i, i, i, i, i, i, p, p, p]
        libs[name] = lib

    gen = torch.Generator().manual_seed(0)
    checks = []
    for bq, share, n, m in ((2, 8, 300, 257), (8, 66, 700, 1100),
                            (4, 1, 2048, 3072), (1, 1, 300, 3073)):
        a = torch.randn((bq, n, 3), generator=gen)
        b = torch.randn((bq * share, m, 3), generator=gen)
        checks.append((a, b))
        checks.append((
            chip_smoke.planted_copies(a, chip_smoke.NN_QUERY_COPIES, gen),
            chip_smoke.planted_copies(b, chip_smoke.NN_REF_COPIES, gen)))
    checks.append((torch.randint(0, 4, (8, 700, 3), generator=gen).float(),
                   torch.randint(0, 4, (528, 500, 3), generator=gen).float()))
    checks = [(a.cuda(), b.cuda(), chamfer._nn_both_plain(a.cuda(), b.cuda()))
              for a, b in checks]
    shapes = []
    for bq, share, n, m in chip_smoke.NN_SHAPES:
        a = torch.rand((bq, n, 3), generator=gen).cuda() - 0.5
        b = (a.repeat_interleave(share, 0)[:, :m]
             + 0.05 * torch.randn((bq * share, m, 3), generator=gen).cuda()
             if share > 1 else
             torch.rand((bq * share, m, 3), generator=gen).cuda() - 0.5)
        shapes.append((a, b))
    for rnd in range(2):
        for name, lib in libs.items():
            per_sm = variants[name].get("_blocks_per_sm",
                                        chamfer._NN_MIN_BLOCKS_PER_SM)
            ok = True
            for a, b, (p1, p2) in checks:
                k1, k2 = call(lib, a, b, per_sm)
                ok = ok and bool((k1 == p1).all()) and bool((k2 == p2).all())
            ms = [chip_smoke.cuda_ms(lambda: call(lib, a, b, per_sm), reps=5)
                  for a, b in shapes]
            print(json.dumps({"variant": name, "round": rnd, "ok": ok,
                              "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
