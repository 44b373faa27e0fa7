#!/usr/bin/env python3
"""Variants of the nearest-neighbour search (``csrc/nn_search.cuh``, which
``csrc/nn_both.cu`` and ``csrc/nn_select.cu`` share), built side by side and
timed in one process on one card:

    python3 scripts/time_nn_both_variants.py '{"base": {}, "two_blocks":
        {"_raw": [["__launch_bounds__(kThreads, 3)",
                   "__launch_bounds__(kThreads, 2)"]]}}'

Each variant is the three sources with some ``constexpr int`` constants of
the search given other values (``{"name": value}``) and, under ``"_raw"``,
exact text replacements (``[[old, new], ...]``, made in every one of the
three files that holds ``old``); ``"_blocks_per_sm"`` replaces the launch
plan's ``_NN_MIN_BLOCKS_PER_SM`` (``ops/chamfer.py:_nn_plan``) for that
variant. Every variant is built by its own ``nvcc`` into
``build/nn_both_variants/<variant>.so`` (all started together), its K1
checked index for index against ``_nn_both_plain`` and its K3 bit for bit
against ``_nn_select_plain`` on random clouds, planted copies and an
integer grid, and K1 timed twice at ``chip_smoke.NN_SHAPES`` with
``chip_smoke.cuda_ms``. Prints a line with the card's name and power
limit, one per variant with the registers and spills of both kernels, and
one per variant and round with ``ok`` and the milliseconds, shape by
shape. A variant that switches a part of the search off is timed all the
same, and its ``ok`` says so. Needs CUDA and nvcc.
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
FILES = ("nn_search.cuh", "nn_both.cu", "nn_select.cu")


def variant_sources(name, subs):
    """The variant's three files, {file name: text}: the constants set in
    the header, the raw replacements made in every file that holds them."""
    csrc = ROOT / "houv_tpu_torch" / "csrc"
    text = {f: (csrc / f).read_text() for f in FILES}
    subs = dict(subs)
    subs.pop("_blocks_per_sm", None)
    for old, new in subs.pop("_raw", []):
        hits = [f for f in FILES if old in text[f]]
        if not hits:
            raise ValueError(f"{name}: no {old!r} in the sources")
        for f in hits:
            text[f] = text[f].replace(old, new)
    for const, value in subs.items():
        pat = rf"constexpr int {const} = [^;]+;"
        if not re.search(pat, text["nn_search.cuh"]):
            raise ValueError(f"{name}: no constant {const}")
        text["nn_search.cuh"] = re.sub(
            pat, f"constexpr int {const} = {value};", text["nn_search.cuh"])
    return text


def build(name, subs):
    """Start nvcc on the variant's sources; returns (library path,
    process)."""
    src_dir = OUT / name
    src_dir.mkdir(parents=True, exist_ok=True)
    for f, text in variant_sources(name, subs).items():
        (src_dir / f).write_text(text)
    so = OUT / f"{name}.so"
    cmd = [_nvcc(), "-Xptxas=-v", "-gencode", _ARCH, "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-o", str(so),
           str(src_dir / "nn_both.cu"), str(src_dir / "nn_select.cu")]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)


def ptxas_props(log, kernel):
    """(spill stores, spill loads, registers) of a kernel in nvcc's
    ``-Xptxas=-v`` log."""
    props = re.search(kernel + r"\w*' for 'sm_90a'.*?(\d+) bytes spill "
                      r"stores, (\d+) bytes spill loads.*?Used (\d+) "
                      r"registers", log, re.S)
    return {"spill_stores": int(props[1]), "spill_loads": int(props[2]),
            "registers": int(props[3])}


def plan(a, b, blocks_per_sm):
    """``_nn_plan`` at these clouds with the variant's blocks per SM."""
    saved = chamfer._NN_MIN_BLOCKS_PER_SM
    chamfer._NN_MIN_BLOCKS_PER_SM = blocks_per_sm
    try:
        return chamfer._nn_plan(b.shape[0], a.shape[1], b.shape[1],
                                chamfer._sm_count(b.device))
    finally:
        chamfer._NN_MIN_BLOCKS_PER_SM = saved


def call(lib, a, b, blocks_per_sm):
    """The wrapper's launch (``chamfer._nn_both_cuda``) on a variant
    library, with its plan's blocks per SM."""
    bq, n, _ = a.shape
    bk, m, _ = b.shape
    qlen, rlen = plan(a, b, blocks_per_sm)
    i1 = torch.empty((bk, n), dtype=torch.int64, device=b.device)
    i2 = torch.empty((bk, m), dtype=torch.int64, device=b.device)
    err = lib.houv_nn_both(a.data_ptr(), b.data_ptr(), bq, bk, n, m, qlen,
                           rlen, i1.data_ptr(), i2.data_ptr(),
                           torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"houv_nn_both returned {err}")
    return i1, i2


def call_select(lib, a, b, blocks_per_sm):
    """The wrapper's launch of K3 (``chamfer._nn_select_cuda``) on a
    variant library, with its plan's blocks per SM."""
    bq, n, _ = a.shape
    bk, m, _ = b.shape
    qlen, rlen = plan(a, b, blocks_per_sm)
    c1 = torch.empty((bk, n, 3), device=b.device)
    c2 = torch.empty((bk, m, 3), device=b.device)
    key1 = torch.empty((bk, n), dtype=torch.int64, device=b.device)
    key2 = torch.empty((bk, m), dtype=torch.int64, device=b.device)
    err = lib.houv_nn_select(a.data_ptr(), b.data_ptr(), bq, bk, n, m, qlen,
                             rlen, c1.data_ptr(), c2.data_ptr(),
                             key1.data_ptr(), key2.data_ptr(),
                             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"houv_nn_select returned {err}")
    return c1, c2


def same_bits(x, y):
    return bool((x.view(torch.int32) == y.view(torch.int32)).all())


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
        print(json.dumps({"variant": name, **{
            kernel: ptxas_props(log, kernel)
            for kernel in ("nn_both_kernel", "nn_select_kernel")}}),
            flush=True)
        lib = ctypes.CDLL(str(so))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.houv_nn_both.argtypes = [p, p, i, i, i, i, i, i, p, p, p]
        lib.houv_nn_select.argtypes = [p, p, i, i, i, i, i, i, p, p, p, p, p]
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
    checks = [(a.cuda(), b.cuda(), chamfer._nn_both_plain(a.cuda(), b.cuda()),
               chamfer._nn_select_plain(a.cuda(), b.cuda()))
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
            for a, b, (p1, p2), (s1, s2) in checks:
                k1, k2 = call(lib, a, b, per_sm)
                ok = ok and bool((k1 == p1).all()) and bool((k2 == p2).all())
                c1, c2 = call_select(lib, a, b, per_sm)
                ok = ok and same_bits(c1, s1) and same_bits(c2, s2)
            ms = [chip_smoke.cuda_ms(lambda: call(lib, a, b, per_sm), reps=5)
                  for a, b in shapes]
            print(json.dumps({"variant": name, "round": rnd, "ok": ok,
                              "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
