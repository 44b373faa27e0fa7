#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``houv_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failed check exits non-zero:

1. the card (nvidia-smi name and power limit) and the kernel build
   (nvcc, sm_90a, from ``houv_tpu_torch/csrc``, one nvcc per source);
2. the nearest-neighbour kernel against its plain PyTorch version at the
   solver's shared-query layout and on a ragged case;
3. the FPS kernel against its plain version (exact index equality);
4. the kNN kernel against its plain version at VRCNet's shapes and on a
   ragged case (exact index equality, distances to 1e-6 relative);
5. the auction EMD kernel against its plain version at (4, 2048): the
   train and eval settings and a permuted copy (EMD 0);
6. the registration path: the port's ``test_main`` on
   ``cfgs/houv_fast.yaml`` at full width over a 16-pair synthetic split,
   then on ``cfgs/houv.yaml`` over 4 pairs, with each kernel's launch count
   on that run; then both configs over 100 pairs, their own batch size, for
   throughput, and houv_fast on a 16-pair split rotated up to 90°, which
   runs the retries;
7. VRCNet on the card against the port's CPU path at the parity tests'
   size (same seeded weights and clouds); then the completion path:
   ``test_main`` on ``cfgs/vrcnet.yaml`` at full
   width over a 64-cloud synthetic test split, then ``validate`` with
   ``eval_emd`` over a 64-cloud val split, each with its launch counts;
   then both over 1024 and 256 clouds for throughput;
8. torch.profiler breakdowns of one houv_fast angle window (16 pairs) and
   of one VRCNet test batch (32 clouds);
9. a ``kernels`` line: each kernel's time at its main-path shape beside its
   plain version, its bound on the card and a PyTorch library yardstick.

The last line is {"ok": true, "device": {...}}. Needs CUDA and a checkout of
the repository around this file; imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import yaml

REPO = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): f32 on the CUDA cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of fn() on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_build():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    from houv_tpu_torch import kernels

    t0 = time.perf_counter()
    kernels.build(verbose=True)
    kernels.load()
    emit({"phase": "build", "card": card,
          "sources": [str(p.relative_to(REPO)) for p in kernels.sources()],
          "seconds": round(time.perf_counter() - t0, 3)})


def _nn_dists(a_rows, b, i1, i2):
    """f64 squared distances of the selected pairs, per row of b."""
    a64, b64 = a_rows.double(), b.double()
    rows = torch.arange(b.shape[0], device=b.device)[:, None]
    d1 = ((a64 - b64[rows, i1]) ** 2).sum(-1)
    d2 = ((b64 - a64[rows, i2]) ** 2).sum(-1)
    return d1, d2


def check_nn(a, b, name):
    """Kernel vs plain: recomputed distances to 1e-6 relative; indices equal
    except where the two picks are candidates within that tolerance."""
    from houv_tpu_torch.ops import chamfer

    ki1, ki2 = chamfer.chamfer_indices(a, b)
    pi1, pi2 = chamfer._nn_both_plain(a, b)
    torch.cuda.synchronize()
    a_rows = a.repeat_interleave(b.shape[0] // a.shape[0], dim=0)
    kd1, kd2 = _nn_dists(a_rows, b, ki1, ki2)
    pd1, pd2 = _nn_dists(a_rows, b, pi1, pi2)
    rel = max(
        float(((kd1 - pd1).abs() / pd1.clamp_min(1e-12)).max()),
        float(((kd2 - pd2).abs() / pd2.clamp_min(1e-12)).max()))
    mism = int((ki1 != pi1).sum()) + int((ki2 != pi2).sum())
    err = max(float((kd1 - pd1).abs().max()), float((kd2 - pd2).abs().max()))
    emit({"phase": "nn_both_check", "case": name,
          "a": list(a.shape), "b": list(b.shape), "index_mismatches": mism,
          "max_rel_dist_err": rel, "max_abs_dist_err": err,
          "tolerance_rel": 1e-6})
    if rel > 1e-6:
        fail(f"nn_both {name}: distances differ by {rel:.3g} relative")
    return err


def phase_nn(gen):
    dev = "cuda"
    a = torch.rand((2, 2048, 3), generator=gen).to(dev) - 0.5
    b = (a.repeat_interleave(64, 0)
         + 0.05 * torch.randn((128, 2048, 3), generator=gen).to(dev))
    err = check_nn(a, b, "shared_B2_K64_N2048_M2048")
    a = torch.randn((1, 2047, 3), generator=gen).to(dev)
    b = torch.randn((1, 1500, 3), generator=gen).to(dev)
    return max(err, check_nn(a, b, "ragged_N2047_M1500"))


def phase_fps(gen):
    from houv_tpu_torch.ops import sampling

    for b, n, k in ((8, 2048, 512), (8, 2048, 1024), (8, 4096, 2048)):
        pts = torch.randn((b, n, 3), generator=gen).cuda()
        ki = sampling.furthest_point_sample(pts, k)
        pi = sampling._fps_plain(pts, k)
        mism = int((ki != pi).sum())
        emit({"phase": "fps_check", "points": [b, n], "k": k,
              "index_mismatches": mism})
        if mism:
            fail(f"fps ({b}, {n}) -> {k}: {mism} indices differ")


def check_knn(q, r, k, name):
    """Kernel vs plain: exact index equality; the recomputed (negated)
    distances to 1e-6 relative of the plain version's."""
    from houv_tpu_torch.ops import grouping

    saved = grouping.knn_indices.launches
    kv, ki = grouping.knn_points(q, r, k)
    grouping.knn_indices.launches = saved
    pi = grouping._knn_plain(q, r, k)
    pv = -((q[:, :, None, :] - grouping.index_points(r, pi)) ** 2).sum(-1)
    torch.cuda.synchronize()
    mism = int((ki != pi).sum())
    err = float((kv - pv).abs().max())
    rel = float(((kv - pv).abs() / pv.abs().clamp_min(1e-12)).max())
    emit({"phase": "knn_check", "case": name, "query": list(q.shape),
          "ref": list(r.shape), "k": k, "index_mismatches": mism,
          "max_rel_dist_err": rel, "max_abs_dist_err": err,
          "descending": bool((kv[..., :-1] >= kv[..., 1:]).all()),
          "tolerance_rel": 1e-6})
    if mism or rel > 1e-6:
        fail(f"knn {name}: {mism} indices differ, distances {rel:.3g} rel")
    return err


def phase_knn(gen):
    """At VRCNet's level-0 shapes (batch 32): the self-kNN at k 20, the pk
    query 1536 x 3072 at k 10, three_nn 3072 x 1536; and a ragged case."""
    b, n = 32, 3072
    pts = torch.rand((b, n, 3), generator=gen).cuda() - 0.5
    half = pts[:, ::2].contiguous()
    err = check_knn(pts, pts, 20, "self_B32_N3072_k20")
    err = max(err, check_knn(half, pts, 10, "pk_B32_M1536_N3072_k10"))
    err = max(err, check_knn(pts, half, 3, "three_nn_B32_M3072_N1536_k3"))
    q = torch.randn((2, 3071, 3), generator=gen).cuda()
    r = torch.randn((2, 1499, 3), generator=gen).cuda()
    return max(err, check_knn(q, r, 17, "ragged_M3071_N1499_k17"))


def phase_emd(gen):
    """Kernel vs plain at (4, 2048): the train setting, the eval setting and
    a permuted copy. The assignments must be equal, the mean matched
    distances within 1e-6 relative, and the kernel's a permutation wherever
    the plain version's is."""
    from houv_tpu_torch.ops import emd

    x1 = torch.rand((4, 2048, 3), generator=gen).cuda() - 0.5
    x2 = torch.rand((4, 2048, 3), generator=gen).cuda() - 0.5
    perm = x1[:, torch.randperm(2048, generator=gen).cuda()]
    err = 0.0
    for name, a, b, eps, iters in (("train", x1, x2, 0.005, 50),
                                   ("eval", x1, x2, 0.004, 3000),
                                   ("permuted_copy", x1, perm, 0.004, 3000)):
        saved = emd.emd_auction_with_stats.launches
        kd, ka, kr, kb = emd.emd_auction_with_stats(a, b, eps, iters)
        emd.emd_auction_with_stats.launches = saved
        pd, pa, pr, pb = emd._auction_plain(a, b, eps, iters)
        torch.cuda.synchronize()
        kperm = [len(torch.unique(row)) == row.numel() for row in ka]
        pperm = [len(torch.unique(row)) == row.numel() for row in pa]
        rel = float(((kd.mean(-1) - pd.mean(-1)).abs()
                     / pd.mean(-1).clamp_min(1e-12)).max())
        err = max(err, float((kd - pd).abs().max()))
        emit({"phase": "emd_check", "case": name, "shape": list(a.shape),
              "eps": eps, "iters": iters,
              "assignment_mismatches": int((ka != pa).sum()),
              "rounds": kr.tolist(), "plain_rounds": pr.tolist(),
              "bids": kb.tolist(), "permutation": kperm,
              "plain_permutation": pperm,
              "mean_dist": kd.mean(-1).tolist(),
              "rel_diff_mean_dist": rel, "tolerance_rel": 1e-6})
        if rel > 1e-6 or any(p and not k for k, p in zip(kperm, pperm)):
            fail(f"emd {name}: mean distance {rel:.3g} relative, "
                 f"permutations {kperm} vs plain {pperm}")
        if name == "permuted_copy" and float(kd.max()) != 0.0:
            fail(f"emd of a permuted copy is {float(kd.max())}, not 0")
    return err


def run_sweep(cfg_name, n_pairs, workdir, max_angle=None):
    """The port's test_main on a temp copy of cfgs/<cfg_name> over a
    synthetic structured split of n_pairs (seed 7), batch = n_pairs;
    ``max_angle`` widens the split's rotations."""
    from houv_tpu_torch.data import synthesize_registration_pairs
    from houv_tpu_torch.geometry.rotations import rotation_error
    from houv_tpu_torch.ops.chamfer import chamfer_indices
    from houv_tpu_torch.ops.sampling import furthest_point_sample
    from houv_tpu_torch.train.cli import test_main
    from houv_tpu_torch.train.submission import read_results_h5

    with open(REPO / "cfgs" / cfg_name) as f:
        raw = yaml.safe_load(f)
    raw.update(synthetic_size=n_pairs, synthetic_shape="structured",
               batch_size=n_pairs,
               work_dir=str(workdir / Path(cfg_name).stem))
    if max_angle is not None:
        raw["max_angle"] = max_angle
    cfg_path = workdir / cfg_name
    cfg_path.write_text(yaml.safe_dump(raw))
    chamfer_indices.launches = 0
    furthest_point_sample.launches = 0
    t0 = time.perf_counter()
    out = test_main(["-c", str(cfg_path)])
    wall = time.perf_counter() - t0
    launches = {"nn_both": chamfer_indices.launches,
                "fps": furthest_point_sample.launches}
    results = read_results_h5(out["results_h5"])
    gt = synthesize_registration_pairs(
        n_pairs, n_points=raw["num_points"], max_angle_deg=raw["max_angle"],
        max_trans=raw["max_trans"], seed=7, shape_mode="structured",
        rot_mix=True)["transforms"]
    if results.shape != (n_pairs, 4, 4) or not np.isfinite(results).all():
        fail(f"{cfg_name}: results {results.shape} not finite (N, 4, 4)")
    if not os.path.getsize(out["submission"]):
        fail(f"{cfg_name}: empty submission zip")
    rot = rotation_error(torch.as_tensor(results[:, :3, :3]),
                         torch.as_tensor(gt[:, :3, :3])).numpy()
    rec = {"phase": "main_path", "config": f"cfgs/{cfg_name}",
           "pairs": n_pairs, "max_angle": raw["max_angle"],
           "points": raw["num_points"],
           "restarts": raw["kernel"], "steps": raw["num_epochs"],
           "angle_passes": raw["angle_passes"],
           "schedule": raw.get("nn_refresh_schedule"),
           "wall_s": round(wall, 3), "solve_s": round(out["seconds"], 3),
           "pairs_per_s": n_pairs / out["seconds"],
           "n_retry": out["n_retry"],
           "rot_err_median_deg": float(np.median(rot)),
           "rot_err_max_deg": float(rot.max()),
           "launches": launches}
    emit(rec)
    return rec


def phase_main():
    with tempfile.TemporaryDirectory() as tmp:
        workdir = Path(tmp)
        fast = run_sweep("houv_fast.yaml", 16, workdir)
        if fast["rot_err_median_deg"] >= 10.0:
            fail(f"houv_fast median rotation error "
                 f"{fast['rot_err_median_deg']:.2f} >= 10 deg")
        if min(fast["launches"].values()) < 1:
            fail(f"houv_fast main path skipped a kernel: {fast['launches']}")
        ref = run_sweep("houv.yaml", 4, workdir)
        if ref["launches"]["nn_both"] < 1:
            fail("houv.yaml main path never launched nn_both")
        # half the pairs rotated 45-90 deg (the quality-gate statistics):
        # their loss passes the threshold and the retry windows run
        wide = run_sweep("houv_fast.yaml", 16, workdir, max_angle=90.0)
        if wide["n_retry"] < 1 or wide["rot_err_median_deg"] >= 10.0:
            fail(f"houv_fast at 90 deg: {wide['n_retry']} retries, median "
                 f"{wide['rot_err_median_deg']:.2f} deg")
        # throughput at the configs' own batch of 100 pairs
        for name in ("houv_fast.yaml", "houv.yaml"):
            full = run_sweep(name, 100, workdir)
            if full["rot_err_median_deg"] >= 10.0:
                fail(f"{name} at 100 pairs: median rotation error "
                     f"{full['rot_err_median_deg']:.2f} >= 10 deg")
    return fast


def _completion_counters():
    from houv_tpu_torch.ops.chamfer import chamfer_indices
    from houv_tpu_torch.ops.emd import emd_auction_with_stats
    from houv_tpu_torch.ops.grouping import knn_indices
    from houv_tpu_torch.ops.sampling import furthest_point_sample

    return {"knn": knn_indices, "fps": furthest_point_sample,
            "nn_both": chamfer_indices, "emd": emd_auction_with_stats}


def _vrcnet_cfg(tmp, n_clouds):
    """A temp copy of cfgs/vrcnet.yaml over an n-cloud synthetic split,
    with eval_emd on."""
    with open(REPO / "cfgs" / "vrcnet.yaml") as f:
        raw = yaml.safe_load(f)
    raw.update(synthetic_size=n_clouds, work_dir=str(tmp), eval_emd=True)
    path = Path(tmp) / f"vrcnet_{n_clouds}.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def run_completion(tmp, n_test, n_val, counters):
    """``test_main`` over an n_test-cloud test split, then ``validate``
    over an n_val-cloud val split, each with the counts set to 0 just
    before it and read just after."""
    from houv_tpu_torch.train.cli import build_dataset, test_main
    from houv_tpu_torch.train.config import load_config
    from houv_tpu_torch.train.harness import CompletionTrainer
    from houv_tpu_torch.train.submission import read_results_h5

    for c in counters.values():
        c.launches = 0
    res = test_main(["-c", _vrcnet_cfg(tmp, n_test)])
    test_launches = {k: c.launches for k, c in counters.items()}
    results = read_results_h5(res["results_h5"])
    if results.shape != (n_test, 2048, 3) or not np.isfinite(results).all():
        fail(f"vrcnet results {results.shape} not finite ({n_test}, 2048, 3)")
    if not os.path.getsize(res["submission"]):
        fail("vrcnet: empty submission zip")
    test = {"phase": "completion", "config": "cfgs/vrcnet.yaml",
            "run": "test_main", "clouds": res["n_clouds"], "batch": 32,
            "seconds": res["seconds"],
            "clouds_per_s": res["n_clouds"] / res["seconds"],
            "result_abs_max": float(np.abs(results).max()),
            "launches": test_launches}
    emit(test)

    cfg = load_config(_vrcnet_cfg(tmp, n_val))
    trainer = CompletionTrainer(cfg)
    trainer.init_state()
    val_ds = build_dataset(cfg, "val")
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    metrics = trainer.validate(val_ds)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    val_launches = {k: c.launches for k, c in counters.items()}
    val = {"phase": "completion", "config": "cfgs/vrcnet.yaml",
           "run": "validate", "clouds": len(val_ds), "seconds": seconds,
           "clouds_per_s": len(val_ds) / seconds, "metrics": metrics,
           "launches": val_launches}
    emit(val)
    if not all(np.isfinite(v) for v in metrics.values()) \
            or set(metrics) != {"cd_p", "cd_t", "emd", "f1"}:
        fail(f"validate metrics {metrics}")
    return test, val, trainer, val_ds


def phase_completion_reference():
    """At the parity tests' size (256 points, coarse_raw 128, layers
    1,1,1,1, knn_list 4,8, pk 8), the card's VRCNet against the port's CPU
    path, whose plain versions tests/test_torch_vrcnet.py holds against the
    JAX model: the same seeded weights and clouds. The test outputs are
    compared as point sets, by the largest distance from a point of either
    cloud to the other (1e-4): the GEMMs round differently on the two
    devices, and at a near-tie FPS then takes the same points in another
    order. cd_p and cd_t to 1e-4 relative; f1 counts points under a
    threshold, so one point crossing it moves the mean by up to
    2 / (points x clouds); the emd within 2 eps (the two auctions see
    clouds 1e-6 apart, in another order)."""
    from houv_tpu_torch.train.cli import build_dataset
    from houv_tpu_torch.train.config import Config
    from houv_tpu_torch.train.harness import CompletionTrainer

    with open(REPO / "cfgs" / "vrcnet.yaml") as f:
        raw = yaml.safe_load(f)
    raw.update(num_points=256, num_coarse_raw=128, num_fps=256,
               num_coarse=256, layers="1, 1, 1, 1", knn_list="4, 8", pk=8,
               batch_size=8, synthetic_size=16, eval_emd=True)
    cfg = Config.from_dict(raw)
    runs = {}
    for dev in ("cpu", "cuda"):
        trainer = CompletionTrainer(cfg, dev)
        trainer.init_state()
        ds = build_dataset(cfg, "val")
        out = trainer.predict_batch(ds.get_batch(np.arange(8))).cpu()
        runs[dev] = (out, trainer.validate(ds))
    (cpu_out, cpu_m), (gpu_out, gpu_m) = runs["cpu"], runs["cuda"]
    d = torch.cdist(cpu_out.double(), gpu_out.double())
    err = float(torch.maximum(d.amin(-1).amax(-1), d.amin(-2).amax(-1)).max())
    moved = int(((cpu_out - gpu_out).norm(dim=-1) > 1e-4).sum())
    diffs = {m: abs(cpu_m[m] - gpu_m[m]) for m in cpu_m}
    tol = {"cd_p": 1e-4 * cpu_m["cd_p"], "cd_t": 1e-4 * cpu_m["cd_t"],
           "f1": 2 / (256 * 16), "emd": 2 * 0.004}
    emit({"phase": "completion_reference", "clouds": 16, "points": 256,
          "max_set_dist": err, "positions_holding_another_point": moved,
          "metrics_cuda": gpu_m, "metrics_cpu": cpu_m,
          "tolerance": 1e-4, "metric_tolerance": tol})
    if not err <= 1e-4 or any(diffs[m] > tol[m] for m in tol):
        fail(f"vrcnet on the card differs from the CPU path: clouds "
             f"{err:.3g} apart, metrics {diffs}")


def phase_completion():
    """VRCNet at the full width of cfgs/vrcnet.yaml: ``test_main`` over a
    64-cloud synthetic test split (2 batches of 32), then ``validate`` with
    eval_emd over a 64-cloud val split, each with its launch counts; then
    both again over 1024 and 256 clouds for steady-state throughput (the
    first batch of a run pays the allocator's warm-up)."""
    counters = _completion_counters()
    with tempfile.TemporaryDirectory() as tmp:
        test, val, trainer, val_ds = run_completion(tmp, 64, 64, counters)
        for run, launches in (("test_main", test["launches"]),
                              ("validate", val["launches"])):
            if launches["knn"] < 1 or launches["fps"] < 1:
                fail(f"vrcnet {run} skipped a kernel: {launches}")
        if val["launches"]["nn_both"] < 1 or val["launches"]["emd"] < 1:
            fail(f"vrcnet validate skipped a kernel: {val['launches']}")
        # validate's first batch, on which the kernels line times emd
        batch = val_ds.get_batch(np.arange(32))
        emd_inputs = (trainer.predict_batch(batch, step=0),
                      torch.as_tensor(batch["gt"], device="cuda"))
        run_completion(tmp, 1024, 256, counters)
    return {"test": test, "validate": val, "emd_inputs": emd_inputs}


def _profile_top(prof, wall_ms):
    kernels = []
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0))
        if str(getattr(ev, "device_type", "")).endswith("CUDA") and t > 0:
            kernels.append((t / 1e3, ev.count, ev.key))
    kernels.sort(reverse=True)
    device_ms = sum(k[0] for k in kernels)
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms,
            "device_ops": sum(k[1] for k in kernels),
            "top": [{"name": k[2][:60], "ms": k[0], "count": k[1],
                     "share_of_device": k[0] / max(device_ms, 1e-9)}
                    for k in kernels[:10]]}


def phase_profile_vrcnet():
    """Where one VRCNet test batch's time goes: torch.profiler over one
    forward of 32 clouds at full width, after one warm-up forward."""
    from torch.profiler import ProfilerActivity, profile

    from houv_tpu_torch.train.cli import build_dataset
    from houv_tpu_torch.train.config import load_config
    from houv_tpu_torch.train.harness import CompletionTrainer

    cfg = load_config(str(REPO / "cfgs" / "vrcnet.yaml"))
    cfg.synthetic_size = 32
    trainer = CompletionTrainer(cfg)
    trainer.init_state()
    batch = build_dataset(cfg, "test").get_batch(np.arange(32))
    trainer.predict_batch(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.predict_batch(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    emit({"phase": "profile", "config": "cfgs/vrcnet.yaml", "clouds": 32,
          "run": "predict_batch", **_profile_top(prof, wall_ms)})


def phase_profile():
    """Where one houv_fast window's time goes: torch.profiler over one
    angle pass of the 16-pair split, device time by kernel name."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from houv_tpu_torch.data import synthesize_registration_pairs
    from houv_tpu_torch.solvers.houv import houv_solve, init_params
    from houv_tpu_torch.train.cli import solver_config
    from houv_tpu_torch.train.config import load_config

    cfg = load_config(str(REPO / "cfgs" / "houv_fast.yaml"))
    scfg = dataclasses.replace(solver_config(cfg), angle_passes=1)
    d = synthesize_registration_pairs(
        16, n_points=cfg.num_points, max_angle_deg=cfg.max_angle,
        max_trans=cfg.max_trans, seed=7, shape_mode="structured",
        rot_mix=True)
    src = torch.as_tensor(d["rotated_src"], device="cuda")
    tgt = torch.as_tensor(d["rotated_tgt"], device="cuda")
    params0 = init_params(torch.Generator().manual_seed(0), 16, scfg.kernel,
                          device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        houv_solve(src, tgt, scfg, params0=params0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    emit({"phase": "profile", "config": "cfgs/houv_fast.yaml",
          "pairs": 16, "angle_passes": 1, **_profile_top(prof, wall_ms)})


def phase_kernels(launches, nn_err, knn_err, emd_err, completion, gen):
    """``launches``: the houv_fast counts; ``completion``: the VRCNet runs
    (their counts summed for knn and emd, and the first val batch's fine
    and gt clouds, on which emd is timed)."""
    from houv_tpu_torch.ops import chamfer, emd, grouping, sampling

    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    # nn_both at the final phase of houv_fast: 16 pairs x 64 restarts, 2048
    # points each side, the target cloud shared by its pair's restarts
    bq, share, n = 16, 64, 2048
    a = torch.rand((bq, n, 3), generator=gen).cuda() - 0.5
    b = (a.repeat_interleave(share, 0)
         + 0.05 * torch.randn((bq * share, n, 3), generator=gen).cuda())
    a_rep = a.repeat_interleave(share, 0)
    saved = chamfer.chamfer_indices.launches
    ms = cuda_ms(lambda: chamfer.chamfer_indices(a, b), reps=5)
    chamfer.chamfer_indices.launches = saved
    plain_ms = cuda_ms(lambda: chamfer._nn_both_plain(a, b), reps=1)

    def library():
        d = torch.cdist(a_rep, b)
        return d.argmin(-1), d.argmin(-2)

    library_ms = cuda_ms(library, reps=2)
    bk = bq * share
    n_bytes = 12 * bq * n + 12 * bk * n + 8 * bk * n + 8 * bk * n
    bound_ms, bound_by = bound(n_bytes, 8.0 * bk * n * n)
    out.append({"name": "nn_both", "route": "cuda",
                "source": "houv_tpu_torch/csrc/nn_both.cu",
                "replaces": "houv_tpu/ops/chamfer.py:84",
                "shape": {"a": [bq, n, 3], "b": [bk, n, 3]},
                "launches": launches["nn_both"], "max_abs_err": nn_err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms})
    del a, b, a_rep
    torch.cuda.empty_cache()

    # fps at the N/2 phase of houv_fast: 16 clouds of 2048 -> 1024
    bsz, n, k = 16, 2048, 1024
    pts = torch.randn((bsz, n, 3), generator=gen).cuda()
    saved = sampling.furthest_point_sample.launches
    ki = sampling.furthest_point_sample(pts, k)
    ms = cuda_ms(lambda: sampling.furthest_point_sample(pts, k), reps=10)
    sampling.furthest_point_sample.launches = saved
    pi = sampling._fps_plain(pts, k)
    plain_ms = cuda_ms(lambda: sampling._fps_plain(pts, k), reps=1)
    # per step and point: 3 sub, 3 mul, 2 add, 1 min, 1 compare
    bound_ms, bound_by = bound(12 * bsz * n + 8 * bsz * k,
                               10.0 * bsz * n * (k - 1))
    out.append({"name": "fps", "route": "cuda",
                "source": "houv_tpu_torch/csrc/fps.cu",
                "replaces": "houv_tpu/ops/sampling.py:43",
                "shape": {"points": [bsz, n, 3], "k": k},
                "launches": launches["fps"],
                "max_abs_err": float((ki - pi).abs().max()),
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None})

    vrc = {k: completion["test"]["launches"][k]
           + completion["validate"]["launches"][k] for k in ("knn", "emd")}
    # knn at VRCNet's level-0 self-kNN: 32 clouds of 3072 points, k 20
    b, n, k = 32, 3072, 20
    pts = torch.rand((b, n, 3), generator=gen).cuda() - 0.5
    saved = grouping.knn_indices.launches
    ms = cuda_ms(lambda: grouping.knn_indices(pts, pts, k), reps=10)
    grouping.knn_indices.launches = saved
    plain_ms = cuda_ms(lambda: grouping._knn_plain(pts, pts, k), reps=1)
    library_ms = cuda_ms(lambda: torch.topk(torch.cdist(pts, pts), k,
                                            largest=False), reps=3)
    # per pair: 3 sub, 3 mul, 2 add, 1 compare against the k-th
    bound_ms, bound_by = bound(12 * b * n * 2 + 8 * b * n * k,
                               9.0 * b * n * n)
    out.append({"name": "knn", "route": "cuda",
                "source": "houv_tpu_torch/csrc/knn.cu",
                "replaces": "houv_tpu/ops/grouping.py:90",
                "shape": {"query": [b, n, 3], "ref": [b, n, 3], "k": k},
                "launches": vrc["knn"], "max_abs_err": knn_err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms})
    del pts
    torch.cuda.empty_cache()

    # emd at validate's setting on its first batch: 32 fine clouds against
    # their gt, 2048 points, eps 0.004, 3000 rounds at most
    fine, gt = completion["emd_inputs"]
    eps, iters = 0.004, 3000
    saved = emd.emd_auction_with_stats.launches
    _, _, rounds, bids = emd.emd_auction_with_stats(fine, gt, eps, iters)
    ms = cuda_ms(lambda: emd.emd_auction_with_stats(fine, gt, eps, iters),
                 reps=3)
    emd.emd_auction_with_stats.launches = saved
    plain_ms = cuda_ms(lambda: emd._auction_plain(fine, gt, eps, iters),
                       reps=1, warmup=0)
    b, n = fine.shape[:2]
    # per bid and item: 3 sub, 3 mul, 2 add, 1 sub (price), 2 compares;
    # the bids are what this run's data needed
    n_bids = int(bids.sum())
    bound_ms, bound_by = bound(24 * b * n + 12 * b * n, 11.0 * n_bids * n)
    out.append({"name": "emd", "route": "cuda",
                "source": "houv_tpu_torch/csrc/emd.cu",
                "replaces": "houv_tpu/ops/emd_kernel.py:48",
                "shape": {"x1": list(fine.shape), "x2": list(gt.shape),
                          "eps": eps, "iters": iters},
                "rounds_max": int(rounds.max()), "bids": n_bids,
                "launches": vrc["emd"], "max_abs_err": emd_err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (REPO / "houv_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)

    phase_build()
    nn_err = phase_nn(gen)
    phase_fps(gen)
    knn_err = phase_knn(gen)
    emd_err = phase_emd(gen)
    fast = phase_main()
    phase_completion_reference()
    completion = phase_completion()
    phase_profile()
    phase_profile_vrcnet()
    emit({"kernels": phase_kernels(fast["launches"], nn_err, knn_err,
                                   emd_err, completion, gen)})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
