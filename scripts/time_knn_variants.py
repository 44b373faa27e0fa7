#!/usr/bin/env python3
"""Variants of the coordinate kNN kernel (``csrc/knn.cu``), built side by
side and timed in one process on one card:

    python3 scripts/time_knn_variants.py '{"base": {}, "one_query":
        {"_max_per": 1}}'

Each variant is the source with some ``constexpr int`` constants given other
values (``{"name": value}``) and, under ``"_raw"``, exact text replacements
(``[[old, new], ...]``); ``"_blocks_per_sm"``, ``"_min_part"`` and
``"_max_per"`` override the launch plan's target of blocks an SM, its least
part and its most queries a thread (``ops/grouping.py:_knn_plan``) for that
variant. Every variant is built by its own ``nvcc`` into
``build/knn_variants/<variant>.so`` (all started together), checked index
for index against ``_knn_plain`` (random clouds with planted copies, an
integer grid, repeated rows, refs in parts, packed clouds), and timed twice
at ``chip_smoke.KNN_SHAPES`` with ``chip_smoke.cuda_ms``. Prints a line
with the card's name and power limit, one per variant with the registers
and spills of ``knn_kernel`` at each bucket and queries a thread, and one per variant and round
with ``ok``, the milliseconds shape by shape and their sum over VRCNet's 14
shapes. A variant that switches a part of the selection off is timed all
the same, and its ``ok`` says so. Needs CUDA and nvcc.
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

OUT = ROOT / "build" / "knn_variants"
SOURCE = ROOT / "houv_tpu_torch/csrc/knn.cu"
# a variant's overrides of the launch plan (``_knn_plan``'s keywords)
PLAN = ("_blocks_per_sm", "_min_part", "_max_per")


def build(name, subs):
    """Start nvcc on the variant's source; returns (library path,
    process)."""
    src = SOURCE.read_text()
    subs = dict(subs)
    for key in PLAN:
        subs.pop(key, None)
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


def call(lib, q, r, k, plan):
    """The wrapper's launch (``grouping._knn_cuda``) on a variant library
    with its plan (``plan``: the variant's overrides of ``_knn_plan``)."""
    b, m, _ = q.shape
    n = r.shape[1]
    length, parts, per = grouping._knn_plan(b, m, n, k, **plan)
    out = torch.empty((b, m, k), dtype=torch.int64, device=q.device)
    scratch = None if parts == 1 else torch.empty(
        2 * parts * b * m * k, dtype=torch.int32, device=q.device)
    err = lib.houv_knn(
        q.data_ptr(), r.data_ptr(), b, m, n, k, per, length,
        None if scratch is None else scratch.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"houv_knn returned {err}")
    return out


def checks(gen):
    """(query, ref, k, plain picks) on the card."""
    cases = []
    for b, m, n, k in ((2, 300, 700, 20), (3, 129, 1000, 10),
                       (32, 384, 384, 20), (4, 700, 700, 64),
                       (700, 63, 256, 8), (3264, 24, 24, 2)):
        x = chip_smoke.planted_copies(
            torch.rand((b, max(m, n), 3), generator=gen) - 0.5,
            chip_smoke.KNN_COPIES, gen)
        cases.append((x[:, :m], x[:, :n], k))
    g = torch.randint(0, 4, (4, 700, 3), generator=gen).float()
    cases += [(g, g, 3), (g, g, 16), (g, g, 33)]
    cases = [(q.cuda(), r.cuda(), k) for q, r, k in cases]
    return [(q, r, k, grouping._knn_plain(q, r, k)) for q, r, k in cases]


def main() -> int:
    if not torch.cuda.is_available():
        print("time_knn_variants: no CUDA device", file=sys.stderr)
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
        props = re.findall(r"knn_kernelILi(\d+)ELi(\d+)ELb(\d)\w*' for "
                           r"'sm_90a'.*?(\d+) bytes spill stores.*?Used "
                           r"(\d+) registers", log, re.S)
        print(json.dumps({"variant": name, "knn_kernel": {
            f"K{K}_P{P}" + ("_direct" if direct == "1" else ""):
            {"spill_stores": int(sp), "registers": int(rg)}
            for K, P, direct, sp, rg in props}}), flush=True)
        lib = ctypes.CDLL(str(so))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.houv_knn.argtypes = [p, p, i, i, i, i, i, i, p, p, p]
        libs[name] = lib

    gen = torch.Generator().manual_seed(0)
    cases = checks(gen)
    shapes = []
    for b, m, n, k, path in chip_smoke.KNN_SHAPES:
        x = torch.rand((b, max(m, n), 3), generator=gen).cuda() - 0.5
        r = x[:, :n].contiguous()
        shapes.append((r if m == n else x[:, :m].contiguous(), r, k, path))
    for rnd in range(2):
        for name, lib in libs.items():
            plan = {key[1:]: value for key, value in variants[name].items()
                    if key in PLAN}
            ok = all(bool((call(lib, q, r, k, plan) == want).all())
                     for q, r, k, want in cases)
            ms = [chip_smoke.cuda_ms(
                lambda: call(lib, q, r, k, plan), reps=20)
                for q, r, k, _ in shapes]
            vrc = sum(t for t, s in zip(ms, shapes) if s[3] == "vrcnet")
            print(json.dumps({"variant": name, "round": rnd, "ok": ok,
                              "vrcnet_sum_ms": vrc, "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
