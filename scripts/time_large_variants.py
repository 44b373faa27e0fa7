#!/usr/bin/env python3
"""Variants of K2's and K7's kernels for clouds past their limits
(``csrc/fps_large.cu``, ``csrc/fps_global.cu``, ``csrc/emd_large.cu``,
``csrc/emd_global.cu``), built side by side and timed in one process on
one card:

    python3 scripts/time_large_variants.py '{"new": {"_kernel":
        "fps_large"}, "mbar": {"_kernel": "fps_large", "kMbar": 1},
        "chain": {"_kernel": "fps_global", "kPass": 0}}'
    python3 scripts/time_large_variants.py scripts/large_variants.json \
        [validate] [yaml]

The variants are a JSON object, given inline or as a ``.json`` file
(``scripts/large_variants.json``: the ones PERF.md reports). Each names its
design under ``"_kernel"`` (its source ``csrc/<kernel>.cu``, or the file
under ``"_source"``, a path in the repository: the exchanges measured and
not kept are ``scripts/fps_large_exchange_variants.cu`` and
``scripts/emd_large_sync_variants.cu``) and gives some ``constexpr int``
constants other values (``{"kPass": 0}``) and, under ``"_raw"``, exact text
replacements (``[[old, new], ...]``); ``"_clusters"`` forces the blocks a cloud or a
pair (else the wrapper's plan: ``ops/sampling.py:_fps_cluster_plan``,
``ops/emd.py:_emd_large_plan`` or ``_emd_global_plan``), and ``"_threads"``
the block size of ``_fps_cluster_plan``'s blocks. Every variant is its own
``nvcc`` of its one source into ``build/large_variants/<variant>.so`` (all
started together), called through its C entry.

- An FPS variant is checked index for index against ``_fps_plain`` (a
  cloud just past 8192 points, sizes off the plan's blocks, an integer
  grid, every point twice, K == N) and timed with ``chip_smoke.cuda_ms`` at
  ``FPS_SHAPES``: ``chip_smoke.LARGE_FPS`` and VRCNet's two at 16384
  points, (8, 16384) and (16, 18432) -> 2048. ``{"kPass": 0}`` is the chain
  alone, its picks wrong: the latency floor.
- An EMD variant is checked against ``_auction_plain`` (assignment, rounds
  and bids at ``chip_smoke.LARGE_EMD``'s few rounds, and N != M) and timed
  at ``EMD_SHAPES``, validate's eps 0.004 and 3000 rounds; with the
  argument ``validate`` also on VRCNet's untrained outputs at 8192 points,
  validate's (8, 8192)². ``{"kScan": 0}`` drops the item scan and runs
  the real run's rounds (from the plain design): the latency floor.
- With the argument ``yaml`` the shapes are those of cfgs/vrcnet.yaml's
  batch of 32 in place of the smoke's 8 (``YAML_FPS_SHAPES``: the ground
  truth's and the decoder's FPS at 16384 points, and one cloud at the
  cluster design's capacity; ``YAML_EMD_SHAPES`` and, with ``validate``,
  validate's (32, 8192)² on VRCNet's outputs), where a plan may take
  fewer blocks a cloud or a second wave.

Prints a line with the card's name and power limit, one per build with the
registers and spills of its kernels, and one per variant and round with
``ok``, the plans and the milliseconds shape by shape. Needs CUDA and nvcc.
"""

import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
from houv_tpu_torch import kernels  # noqa: E402
from houv_tpu_torch.kernels._build import (  # noqa: E402
    _ARCH, _SIGNATURES, _nvcc)
from houv_tpu_torch.ops import emd, sampling  # noqa: E402

OUT = ROOT / "build" / "large_variants"
CSRC = ROOT / "houv_tpu_torch" / "csrc"
FPS_SHAPES = (*chip_smoke.LARGE_FPS, (8, 16384, 2048), (16, 18432, 2048))
EMD_SHAPES = ((2, 8192, 8192), (2, 16384, 16384))
YAML_FPS_SHAPES = ((32, 16384, 2048), (64, 18432, 2048), (1, 65536, 2048))
YAML_EMD_SHAPES = ((32, 8192, 8192),)


def variant_source(name, subs):
    """The variant's source text."""
    src = (ROOT / subs["_source"] if "_source" in subs
           else CSRC / f"{subs['_kernel']}.cu").read_text()
    for old, new in subs.get("_raw", []):
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
    cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
    cu.write_text(src)
    cmd = [_nvcc(), "-Xptxas=-v", "-gencode", _ARCH, "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-o", str(so), str(cu)]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)


def load(so):
    """The variant's library, its entries typed as ``_SIGNATURES`` says."""
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def stream():
    return torch.cuda.current_stream().cuda_stream


def fps_plan(lib, var, b, n):
    """(C, warps, per) of an fps_large variant for b clouds of n points."""
    if var.get("_clusters"):
        c = var["_clusters"]
        if -(-n // c) > sampling._FPS_BLOCK_POINTS:
            return None
        return (c, *sampling._fps_plan(-(-n // c), var.get("_threads")))
    return sampling._fps_cluster_plan(
        n, b, lambda c, w, p: lib.houv_fps_large_max_clusters(c, w, p),
        var.get("_threads"))


def fps_call(lib, var, pts, k):
    b, n, _ = pts.shape
    out = torch.empty((b, k), dtype=torch.int64, device=pts.device)
    if var["_kernel"] == "fps_global":
        work = torch.empty((b, n, 4), dtype=torch.float32, device=pts.device)
        err = lib.houv_fps_global(pts.data_ptr(), b, n, k, work.data_ptr(),
                                  out.data_ptr(), stream())
    else:
        c, warps, per = fps_plan(lib, var, b, n)
        err = lib.houv_fps_large(pts.data_ptr(), b, n, k, c, warps, per,
                                 out.data_ptr(), stream())
    if err:
        raise RuntimeError(f"fps variant launch failed: CUDA error {err}")
    return out


def fps_cases(gen):
    """(points, k, plain picks) on the card."""
    cases = [(torch.randn((b, n, 3), generator=gen), k)
             for b, n, k in ((2, 8193, 300), (3, 9001, 300),
                             (1, 16384, 500), (2, 18432, 200),
                             (1, 20000, 100))]
    grid = torch.randint(0, 6, (2, 12000, 3), generator=gen).float()
    twice = torch.randn((1, 16384, 3), generator=gen)
    twice[:, 8192:] = twice[:, :8192]
    cases += [(grid, 400), (twice, 600),
              (torch.randn((1, 8200, 3), generator=gen), 8200)]
    cases = [(x.cuda(), k) for x, k in cases]
    return [(x, k, sampling._fps_plain(x, k)) for x, k in cases]


def emd_plan(lib, var, b, n, m):
    """Blocks a pair of an EMD variant; None where its forced size cannot
    hold the pair."""
    if var.get("_clusters"):
        c = var["_clusters"]
        if var["_kernel"] == "emd_large" and lib.houv_emd_large_smem_bytes(
                n, m, c) > kernels.load().houv_emd_max_smem_bytes():
            return None
        return c
    if var["_kernel"] == "emd_global":
        return emd._emd_global_plan(
            b, {c: lib.houv_emd_global_max_clusters(c)
                for c in emd._EMD_LARGE_CLUSTERS})
    return emd._emd_large_plan(
        b, lambda c: lib.houv_emd_large_smem_bytes(n, m, c),
        kernels.load().houv_emd_max_smem_bytes(),
        lambda c: lib.houv_emd_large_max_clusters(n, m, c))


def emd_call(lib, var, x1, x2, eps, iters):
    b, n, _ = x1.shape
    m = x2.shape[1]
    c = emd_plan(lib, var, b, n, m)
    dist, assign, stats = emd._emd_outputs(x1)
    if var["_kernel"] == "emd_global":
        new = lambda shape, dt: torch.empty(shape, dtype=dt,  # noqa: E731
                                            device=x1.device)
        scratch = (new((b, m, 4), torch.float32), new((b, m), torch.int64),
                   new((b, m), torch.int32), new((b, 2 * n), torch.int32),
                   new((b, n), torch.int32), new((b, 2), torch.int32))
        err = lib.houv_emd_global(
            x1.data_ptr(), x2.data_ptr(), b, n, m, eps, iters, c,
            *(t.data_ptr() for t in scratch), dist.data_ptr(),
            assign.data_ptr(), stats.data_ptr(), stream())
    else:
        err = lib.houv_emd_large(x1.data_ptr(), x2.data_ptr(), b, n, m, eps,
                                 iters, c, dist.data_ptr(), assign.data_ptr(),
                                 stats.data_ptr(), stream())
    if err:
        raise RuntimeError(f"emd variant launch failed: CUDA error {err}")
    return dist, assign, stats[:, 0], stats[:, 1], c


def emd_cases(gen):
    """(x1, x2, eps, iters, plain outputs) on the card."""
    def cloud(b, n):
        return torch.rand((b, n, 3), generator=gen).cuda() - 0.5

    cases = [(cloud(b, n), cloud(b, n), 0.004, iters)
             for b, n, iters in chip_smoke.LARGE_EMD]
    cases += [(cloud(2, 7000), cloud(2, 9000), 0.005, 20),
              (cloud(2, 9000), cloud(2, 7000), 0.005, 20)]
    return [(x1, x2, eps, iters, emd._auction_plain(x1, x2, eps, iters))
            for x1, x2, eps, iters in cases]


def validate_outputs(tmp, b):
    """VRCNet's untrained outputs at 8192 points against their ground truth,
    a batch of b (8: ``chip_smoke.phase_large_clouds``'s validate; 32:
    cfgs/vrcnet.yaml's)."""
    from houv_tpu_torch.train.cli import build_dataset
    from houv_tpu_torch.train.config import load_config
    from houv_tpu_torch.train.harness import CompletionTrainer

    cfg = load_config(chip_smoke._large_vrcnet_cfg(tmp, b, 8192,
                                                   eval_emd=True))
    trainer = CompletionTrainer(cfg)
    trainer.init_state()
    batch = build_dataset(cfg, "val").get_batch(np.arange(b))
    with torch.no_grad():
        fine = trainer.predict_batch(batch, step=0)
    gt = torch.as_tensor(batch["gt"], device="cuda")
    del trainer
    torch.cuda.empty_cache()
    return fine.contiguous(), gt


def main() -> int:
    if not torch.cuda.is_available():
        print("time_large_variants: no CUDA device", file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    print(json.dumps({"card": chip_smoke.card_line()}), flush=True)
    arg = sys.argv[1]
    yaml = "yaml" in sys.argv[2:]
    fps_shapes = YAML_FPS_SHAPES if yaml else FPS_SHAPES
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
            print(f"{name}: nvcc failed\n{log[-4000:]}", flush=True)
            continue
        props = re.findall(r"Function properties for (\w+)\n.*?(\d+) bytes "
                           r"spill stores.*?Used (\d+) registers", log, re.S)
        print(json.dumps({"build": name, "kernels": {
            fn: {"spill_stores": int(sp), "registers": int(rg)}
            for fn, sp, rg in props if "kernel" in fn}}), flush=True)
        libs[name] = load(so)
    libs = {name: libs[builds[src]] for name, src in texts.items()
            if builds[src] in libs}

    gen = torch.Generator().manual_seed(0)
    fps_vars = {k: v for k, v in variants.items() if k in libs
                and v["_kernel"].startswith("fps")}
    emd_vars = {k: v for k, v in variants.items() if k in libs
                and v["_kernel"].startswith("emd")}
    if fps_vars:
        cases = fps_cases(gen)
        shapes = [(torch.randn((b, n, 3), generator=gen).cuda(), k)
                  for b, n, k in fps_shapes]
        for rnd in range(2):
            for name, var in fps_vars.items():
                lib = libs[name]
                held = var["_kernel"] == "fps_global" or (
                    lambda x: fps_plan(lib, var, *x.shape[:2]) is not None)
                ok = all(bool((fps_call(lib, var, x, k) == want).all())
                         for x, k, want in cases if held is True or held(x))
                ms = [chip_smoke.cuda_ms(lambda: fps_call(lib, var, x, k),
                                         reps=5)
                      if held is True or held(x) else None
                      for x, k in shapes]
                plans = ([fps_plan(lib, var, x.shape[0], x.shape[1])
                          for x, _ in shapes]
                         if var["_kernel"] == "fps_large" else None)
                print(json.dumps({"variant": name, "round": rnd, "ok": ok,
                                  "shapes": [list(s) for s in fps_shapes],
                                  "plans": plans, "ms": ms}), flush=True)
        del cases, shapes
        torch.cuda.empty_cache()
    if emd_vars:
        cases = emd_cases(gen)
        pairs = [(torch.rand((b, n, 3), generator=gen).cuda() - 0.5,
                  torch.rand((b, m, 3), generator=gen).cuda() - 0.5)
                 for b, n, m in (YAML_EMD_SHAPES if yaml else EMD_SHAPES)]
        if "validate" in sys.argv[2:]:
            with tempfile.TemporaryDirectory() as tmp:
                pairs.append(validate_outputs(tmp, 32 if yaml else 8))
        # the rounds each pair runs, for the floors (the plain design)
        real = {}
        for name, var in emd_vars.items():
            if var.get("kScan", 1):
                for i, (x1, x2) in enumerate(pairs):
                    _, _, r, bids, _ = emd_call(libs[name], var, x1, x2,
                                                0.004, 3000)
                    real[i] = (int(r.max()), int(bids.sum()))
                break
        for rnd in range(2):
            for name, var in emd_vars.items():
                lib = libs[name]
                ok = True
                for x1, x2, eps, iters, want in cases:
                    if emd_plan(lib, var, x1.shape[0], x1.shape[1],
                                x2.shape[1]) is None:
                        continue
                    got = emd_call(lib, var, x1, x2, eps, iters)
                    ok &= all(bool((g == w).all())
                              for g, w in zip(got[1:4], want[1:4]))
                    ok &= bool((got[0].view(torch.int32)
                                == want[0].view(torch.int32)).all())
                rows = []
                for i, (x1, x2) in enumerate(pairs):
                    if emd_plan(lib, var, x1.shape[0], x1.shape[1],
                                x2.shape[1]) is None:
                        rows.append(None)
                        continue
                    iters = real.get(i, (3000,))[0] if not var.get(
                        "kScan", 1) else 3000
                    _, _, r, bids, c = emd_call(lib, var, x1, x2, 0.004,
                                                iters)
                    rows.append({
                        "shape": [*x1.shape[:2], x2.shape[1]],
                        "clusters": c, "rounds_max": int(r.max()),
                        "bids": int(bids.sum()),
                        "ms": chip_smoke.cuda_ms(lambda: emd_call(
                            lib, var, x1, x2, 0.004, iters), reps=3)})
                print(json.dumps({"variant": name, "round": rnd, "ok": ok,
                                  "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
