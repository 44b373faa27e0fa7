#!/usr/bin/env python3
"""Variants of the furthest-point sampling kernel (``csrc/fps.cu``), built
side by side and timed in one process on one card:

    python3 scripts/time_fps_variants.py '{"base": {}, "t512":
        {"_threads": 512}, "chain": {"kPass": 0}}'
    python3 scripts/time_fps_variants.py scripts/fps_variants.json

The variants are a JSON object, given inline or as a ``.json`` file
(``scripts/fps_variants.json``: the ones PERF.md reports). Each variant is
the source with some ``constexpr int`` constants given other
values (``{"name": value}``) and, under ``"_raw"``, exact text replacements
(``[[old, new], ...]``); ``"_threads"`` overrides the launch plan's target
block size (``ops/sampling.py:_fps_plan``) for that variant,
``"_cluster"`` plans for the points of one of that many blocks a cloud
(a source that launches a cluster of them), and ``"_source"`` names
another source with the same C entry (an earlier design or such a
cluster, kept outside the package) to start from. Variants of the
same text share one build. Every build is its own ``nvcc`` into
``build/fps_variants/<variant>.so`` (all started together); every variant is
checked index for index against ``_fps_plain`` (random clouds, integer
grids, every point twice, K == N, sizes off the plan's blocks) and timed
twice at ``chip_smoke.FPS_SHAPES`` with ``chip_smoke.cuda_ms``. Prints a
line with the card's name and power limit, one per build with the
registers and spills of ``fps_kernel`` at each number of points a thread
(``_scan``: the instantiation for blocks that scan their slots),
and one per variant and round with ``ok``, the plan and the milliseconds
shape by shape. ``{"kPass": 0}`` is the chain alone: the same barrier, slot
and redux reductions and the winner's coordinates, with no distance pass
(its picks are wrong, and its ``ok`` says so); its times are the latency
floor of PERF.md. Needs CUDA and nvcc.
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
from houv_tpu_torch.ops import sampling  # noqa: E402

OUT = ROOT / "build" / "fps_variants"
SOURCE = ROOT / "houv_tpu_torch/csrc/fps.cu"


def variant_source(name, subs):
    """The variant's source text."""
    src = Path(subs.get("_source", SOURCE)).read_text()
    subs = {k: v for k, v in subs.items()
            if k not in ("_threads", "_source", "_cluster")}
    for old, new in subs.pop("_raw", []):
        if old not in src:
            raise ValueError(f"{name}: no {old!r} in the source")
        src = src.replace(old, new)
    for const, value in subs.items():
        pat = rf"constexpr int {const} = [^;]+;"
        if not re.search(pat, src):
            raise ValueError(f"{name}: no constant {const}")
        src = re.sub(pat, f"constexpr int {const} = {value};", src)
    return src


def build(name, src):
    """Start nvcc on a source; returns (library path, process)."""
    cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
    cu.write_text(src)
    cmd = [_nvcc(), "-Xptxas=-v", "-gencode", _ARCH, "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-o", str(so), str(cu)]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)


def plan(n, variant):
    """The variant's (warps, points a thread): ``_fps_plan`` with its
    ``"_threads"`` for the points of one of its ``"_cluster"`` blocks."""
    parts = variant.get("_cluster", 1)
    return sampling._fps_plan(-(-n // parts), variant.get("_threads"))


def call(lib, pts, k, variant):
    """The wrapper's launch (``sampling._fps_cuda``) on a variant library
    with the variant's plan."""
    b, n, _ = pts.shape
    warps, per = plan(n, variant)
    out = torch.empty((b, k), dtype=torch.int64, device=pts.device)
    err = lib.houv_fps(pts.data_ptr(), b, n, k, warps, per, out.data_ptr(),
                       torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"houv_fps returned {err}")
    return out


def checks(gen):
    """(points, k, plain picks) on the card."""
    cases = [torch.randn((b, n, 3), generator=gen)
             for b, n in ((3, 1000), (2, 2049), (2, 4097), (1, 8192),
                          (4, 31), (2, 257))]
    cases = [(x, min(x.shape[1], 300)) for x in cases]
    g = torch.randint(0, 4, (3, 700, 3), generator=gen).float()
    twice = torch.randn((2, 1024, 3), generator=gen)
    twice[:, 512:] = twice[:, :512]
    cases += [(g, 700), (twice, 1024), (cases[0][0], 1000)]
    cases = [(x.cuda(), k) for x, k in cases]
    return [(x, k, sampling._fps_plain(x, k)) for x, k in cases]


def main() -> int:
    if not torch.cuda.is_available():
        print("time_fps_variants: no CUDA device", file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    print(json.dumps({"card": chip_smoke.card_line()}), flush=True)
    arg = sys.argv[1]
    variants = json.loads(Path(arg).read_text() if arg.endswith(".json")
                          else arg)
    texts = {name: variant_source(name, subs)
             for name, subs in variants.items()}
    builds = {}                         # source text -> first variant's name
    for name, src in texts.items():
        builds.setdefault(src, name)
    started = {name: build(name, src) for src, name in builds.items()}
    libs = {}
    for name, (so, proc) in started.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"{name}: nvcc failed\n{log[-3000:]}", flush=True)
            continue
        props = re.findall(r"fps_kernelILi(\d+)E(?:Lb(\d)E)?E\w*' for "
                           r"'sm_90a'.*?(\d+) bytes spill stores.*?Used "
                           r"(\d+) registers", log, re.S)
        print(json.dumps({"build": name, "fps_kernel": {
            f"PER{per}" + ("_scan" if scan == "1" else ""):
            {"spill_stores": int(sp), "registers": int(rg)}
            for per, scan, sp, rg in props}}), flush=True)
        lib = ctypes.CDLL(str(so))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.houv_fps.argtypes = [p, i, i, i, i, i, p, p]
        libs[name] = lib
    libs = {name: libs[builds[src]] for name, src in texts.items()
            if builds[src] in libs}

    gen = torch.Generator().manual_seed(0)
    cases = checks(gen)
    shapes = [(torch.randn((b, n, 3), generator=gen).cuda(), k)
              for b, n, k, _ in chip_smoke.FPS_SHAPES]
    for rnd in range(2):
        for name, lib in libs.items():
            var = variants[name]
            ok = all(bool((call(lib, x, k, var) == want).all())
                     for x, k, want in cases)
            ms = [chip_smoke.cuda_ms(lambda: call(lib, x, k, var), reps=5)
                  for x, k in shapes]
            plans = [plan(x.shape[1], var) for x, _ in shapes]
            print(json.dumps({"variant": name, "round": rnd, "ok": ok,
                              "plans": plans, "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
