#!/usr/bin/env python3
"""The auction EMD kernel (``csrc/emd.cu``, K7) on its paths' own clouds:
the bidders a round, and variants built side by side and timed in one
process on one card:

    python3 scripts/time_emd_variants.py histogram
    python3 scripts/time_emd_variants.py '{"base": {}, "c1":
        {"_clusters": 1}, "floor": {"_floor": 1}}'
    python3 scripts/time_emd_variants.py scripts/emd_variants.json

The inputs are ``chip_smoke.emd_path_inputs``: validate's first batch with
``eval_emd`` (32 pairs of 2048, eps 0.004, 3000 rounds at most) and the
auctions of one ``loss: emd`` train step of VRCNet (64 pairs; 1024, 3072,
2048 and 2048 bidders for 2048 items) and ECG (32 pairs; 1024 and 2048),
eps 0.005, 50 rounds (``chip_smoke.EMD_SHAPES``).

``histogram`` runs the plain version (``ops/emd.py:_auction_plain``) on
each and prints, by ranges of unassigned bidders a round (1-8, 9-32,
33-256, > 256), the rounds (summed over the pairs) and the share of the
bids made in them, and the bids of the pair that made the most.

Otherwise the argument is a JSON object of variants, inline or a ``.json``
file (``scripts/emd_variants.json``: the ones PERF.md reports): each the
source with some ``constexpr int`` constants given other values
(``{"kSolo": 0}``) and, under ``"_raw"``, exact text replacements
(``[[old, new], ...]``). ``"_clusters"`` forces the blocks a pair (else
the plan, ``ops/emd.py:_emd_plan``); sizes above the kernel's 3 are
compiled into the variant. ``"_floor"`` compiles the item scan out
(``FLOOR``: bidder i bids eps on item i mod M, and the rounds run to the
real run's count with whatever bidders are left): the latency floor, a
round's fixed cost; its assignments are wrong and its ``ok`` says so.
Variants of the same text share one build, each its own ``nvcc`` into
``build/emd_variants/<variant>.so`` (all started together). Every variant
is checked against the plain version on every input (assignment index for
index, rounds and bids; its ``ok`` says so) and timed twice on each with
``chip_smoke.cuda_ms``. Prints a line with the card's name and power
limit, one per build with ``emd_kernel``'s registers and spills at each
cluster size, and one per variant and round with ``ok``, the plans, the
most clusters of the plan's size the card holds at once
(``houv_emd_max_clusters``) and the milliseconds input by input. Needs CUDA and nvcc.
"""

import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
from houv_tpu_torch.kernels._build import _ARCH, _nvcc  # noqa: E402
from houv_tpu_torch.ops import emd  # noqa: E402

OUT = ROOT / "build" / "emd_variants"
SOURCE = ROOT / "houv_tpu_torch" / "csrc" / "emd.cu"
# the latency floor: no item scan, the rounds run to the cap
FLOOR = [
    ["Triple tr = scan<kPrice>(items, m, active ? sub : m, s, ax, ay, az);",
     "Triple tr{-INFINITY, -INFINITY, kNone};\n"
     "    if (active && sub == 0) tr = Triple{0.f, 0.f, "
     "static_cast<int>(i % m)};"],
    ["while (rounds < iters && u > stop) {",
     "while (rounds < iters && (u > stop || stop == 0)) {"],
    ["if (rounds < iters && u > 0) {", "if (rounds < iters) {"]]
LAST_CASES = ("    case 3:\n      return launch<3>(x1, x2, b, n, m, eps, "
              "iters, dist, assign, stats, s);\n",
              "    case 3: return max_clusters<3>(smem);\n")


def variant_source(name, subs):
    """The variant's source text."""
    src = SOURCE.read_text()
    raw = list(subs.get("_raw", [])) + (FLOOR if subs.get("_floor") else [])
    clusters = subs.get("_clusters") or 0
    if clusters > 3:
        raw += [[case, case + "".join(case.replace("3", str(c))
                                      for c in range(4, clusters + 1))]
                for case in LAST_CASES]
    for old, new in raw:
        if old not in src:
            raise ValueError(f"{name}: no {old!r} in the source")
        src = src.replace(old, new)
    for const, value in subs.items():
        if const.startswith("_"):
            continue
        pat = rf"constexpr int {const} = [^;]+;"
        if not re.search(pat, src):
            raise ValueError(f"{name}: no constant {const}")
        src = re.sub(pat, f"constexpr int {const} = {value};", src)
    return src


def build(name, src):
    """Start nvcc on a source; returns (library path, process)."""
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
    cu.write_text(src)
    cmd = [_nvcc(), "-Xptxas=-v", "-gencode", _ARCH, "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-o", str(so), str(cu)]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)


def load(name, so, proc):
    """Wait for a variant's nvcc and load it: (ctypes library, nvcc log)."""
    log, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"emd variant {name}: nvcc failed\n{log[-3000:]}")
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.houv_emd.argtypes = [p, p, i, i, i, ctypes.c_float, i, i, p, p, p, p]
    lib.houv_emd_max_clusters.argtypes = [i, i, i]
    return lib, log


def call(lib, x1, x2, eps, iters, clusters):
    """A variant library's launch with ``clusters`` blocks a pair: dist,
    assignment, rounds and bids as ``ops/emd.py:_emd_cuda`` returns
    them."""
    b, n, _ = x1.shape
    dist = torch.empty((b, n), dtype=torch.float32, device=x1.device)
    assign = torch.empty((b, n), dtype=torch.int64, device=x1.device)
    stats = torch.empty((b, 2), dtype=torch.int64, device=x1.device)
    err = lib.houv_emd(x1.data_ptr(), x2.data_ptr(), b, n, x2.shape[1], eps,
                       iters, clusters, dist.data_ptr(), assign.data_ptr(),
                       stats.data_ptr(),
                       torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"emd variant launch failed: CUDA error {err}")
    return dist, assign, stats[:, 0], stats[:, 1]


RANGES = ((1, 8), (9, 32), (33, 256), (257, None))


def histogram(inputs):
    for (x1, x2, eps, iters), shape in zip(inputs, chip_smoke.EMD_SHAPES):
        counts = []
        _, _, rounds, bids = emd._auction_plain(x1, x2, eps, iters, counts)
        u = torch.stack(counts).flatten() if counts else torch.zeros(1)
        u = u[u > 0]
        total = int(u.sum())
        rows = {}
        for lo, hi in RANGES:
            sel = (u >= lo) & (u <= hi if hi else True)
            rows[f"{lo}-{hi}" if hi else f">{lo - 1}"] = {
                "rounds": int(sel.sum()),
                "bid_share": int(u[sel].sum()) / max(total, 1)}
        print(json.dumps({
            "histogram": shape[5], "shape": [*x1.shape[:2], x2.shape[1]],
            "eps": eps, "iters": iters,
            "plan": chip_smoke.emd_plan(*x1.shape[:2], x2.shape[1]),
            "rounds_max": int(rounds.max()),
            "rounds_mean": float(rounds.float().mean()), "bids": total,
            "bids_per_pair": total / x1.shape[0],
            "bids_most_in_a_pair": int(bids.max()), "by_bidders": rows}),
            flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("time_emd_variants: no CUDA device", file=sys.stderr)
        return 2
    print(json.dumps({"card": chip_smoke.card_line()}), flush=True)
    arg = sys.argv[1]
    if arg != "histogram":
        variants = json.loads(Path(arg).read_text() if arg.endswith(".json")
                              else arg)
        texts = {name: variant_source(name, subs)
                 for name, subs in variants.items()}
        builds = {}                     # source text -> first variant's name
        for name, src in texts.items():
            builds.setdefault(src, name)
        started = {name: build(name, src) for src, name in builds.items()}
    with tempfile.TemporaryDirectory() as tmp:
        inputs = chip_smoke.emd_path_inputs(tmp)
    if arg == "histogram":
        histogram(inputs)
        return 0
    libs = {}
    for name, (so, proc) in started.items():
        libs[name], log = load(name, so, proc)
        props = re.findall(r"emd_kernelILi(\d+)E\w*' for 'sm_90a'.*?(\d+) "
                           r"bytes spill stores.*?Used (\d+) registers", log,
                           re.S)
        print(json.dumps({"build": name, "emd_kernel": {
            f"C{c}": {"spill_stores": int(sp), "registers": int(rg)}
            for c, sp, rg in props}}), flush=True)
    libs = {name: libs[builds[src]] for name, src in texts.items()}
    plain = [emd._auction_plain(*args) for args in inputs]
    for rnd in range(2):
        for name, lib in libs.items():
            var = variants[name]
            plans = [var.get("_clusters") or chip_smoke.emd_plan(
                *x1.shape[:2], x2.shape[1]) for x1, x2, _, _ in inputs]
            ok, ms = True, []
            for (x1, x2, eps, iters), c, (pd, pa, pr, pb) in zip(
                    inputs, plans, plain):
                if var.get("_floor"):
                    iters = int(pr.max())
                d, a, r, b = call(lib, x1, x2, eps, iters, c)
                ok = ok and bool((a == pa).all() and (r == pr).all()
                                 and (b == pb).all())
                ms.append(chip_smoke.cuda_ms(
                    lambda: call(lib, x1, x2, eps, iters, c), reps=3))
            # the most clusters of the variant's size the card holds
            held = [lib.houv_emd_max_clusters(x1.shape[1], x2.shape[1], c)
                    if c > 1 else None for (x1, x2, _, _), c in zip(inputs,
                                                                    plans)]
            print(json.dumps({"variant": name, "round": rnd, "ok": ok,
                              "plans": plans, "clusters_held": held,
                              "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
