#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``houv_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failed check exits non-zero:

1. the card (nvidia-smi name and power limit) and the kernel build
   (nvcc, sm_90a, from ``houv_tpu_torch/csrc``, one nvcc per source);
2. the nearest-neighbour kernel against its plain PyTorch version at the
   solver's shared-query layout, at the train step's shapes (64 rows of
   2048 gt points against 1024, 3072 and 2048) and on a ragged case;
3. the FPS kernel against its plain version (exact index equality) at the
   solver's and the train step's shapes (the gt's full permutation 2048 ->
   2048, 3072 -> 2048 and the decoder's pyramid 3072 -> 1536 -> 768 -> 384);
4. the kNN kernel against its plain version at VRCNet's shapes and on a
   ragged case (exact index equality, distances to 1e-6 relative);
5. the auction EMD kernel against its plain version at (4, 2048): the
   train and eval settings and a permuted copy (EMD 0); the scatter-add
   kernel against its plain version (bit for bit) at the train step's and
   the solver's shapes, ragged, all-equal and out-of-range cases, and
   against the dense one-hot product; the chamfer gradient against
   autograd through the gathered form with the same matches, which must be
   the dense golden's;
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
8. VRCNet training: one train step at the parity tests' size on the card
   against the port's CPU path in f64 on the same picks; then ``train_main`` on ``cfgs/vrcnet.yaml``
   at full width (batch 32, two epochs of four steps on the synthetic
   split, ``validate`` and a checkpoint after each), with the launch counts
   of the run held against the counts derived from the code, peak memory
   with and without ``use_remat``, ``test_main`` with ``load_model`` on the
   checkpoint, 20 steps on one repeated batch (the loss must fall), and
   four steps with ``loss: emd`` (four auctions a step, the coarse stages'
   between clouds of different sizes);
   then a short ``houv_solve`` with ``grad_mode='scatter'`` beside the
   gather mode;
9. torch.profiler breakdowns of one houv_fast angle window (16 pairs), of
   one VRCNet test batch (32 clouds) and of one VRCNet train step;
10. a ``kernels`` line: each kernel's time at its main-path shape beside its
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
    # the train step's four calc_cd terms: 64 rows of 2048 gt points against
    # coarse_raw (1024), coarse_high (3072) and coarse and fine (2048)
    gt = torch.rand((64, 2048, 3), generator=gen).to(dev) - 0.5
    for m in (1024, 3072, 2048):
        out = torch.rand((64, m, 3), generator=gen).to(dev) - 0.5
        err = max(err, check_nn(gt, out, f"train_B64_N2048_M{m}"))
    del gt, out
    a = torch.randn((1, 2047, 3), generator=gen).to(dev)
    b = torch.randn((1, 1500, 3), generator=gen).to(dev)
    return max(err, check_nn(a, b, "ragged_N2047_M1500"))


def phase_fps(gen):
    from houv_tpu_torch.ops import sampling

    # the solver's phases; then the train step's: the gt's full permutation
    # (K == N), coarse_high 3072 -> 2048 and the decoder's pyramid
    for b, n, k in ((8, 2048, 512), (8, 2048, 1024), (8, 4096, 2048),
                    (8, 2048, 2048), (8, 3072, 2048), (8, 3072, 1536),
                    (8, 1536, 768), (8, 768, 384)):
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
    a permuted copy; and at the coarse stages of EMD training, 1024 and 3072
    bidders for 2048 items. The assignments must be equal, the mean matched
    distances within 1e-6 relative, and the kernel's a permutation wherever
    the plain version's is."""
    from houv_tpu_torch.ops import emd

    x1 = torch.rand((4, 2048, 3), generator=gen).cuda() - 0.5
    x2 = torch.rand((4, 2048, 3), generator=gen).cuda() - 0.5
    perm = x1[:, torch.randperm(2048, generator=gen).cuda()]
    few = torch.rand((4, 1024, 3), generator=gen).cuda() - 0.5
    many = torch.rand((4, 3072, 3), generator=gen).cuda() - 0.5
    err = 0.0
    for name, a, b, eps, iters in (("train", x1, x2, 0.005, 50),
                                   ("eval", x1, x2, 0.004, 3000),
                                   ("permuted_copy", x1, perm, 0.004, 3000),
                                   ("train_1024_bidders", few, x2, 0.005, 50),
                                   ("train_3072_bidders", many, x2, 0.005,
                                    50)):
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
              "items": b.shape[1], "eps": eps, "iters": iters,
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


def check_scatter(idx, vals, m, name):
    """Kernel vs plain: every element bit for bit (both add in ascending
    i); returns the largest absolute difference (0 when equal)."""
    from houv_tpu_torch.ops import scatter

    saved = scatter.scatter_add.launches
    out = scatter.scatter_add(idx, vals, m)
    again = scatter.scatter_add(idx, vals, m)
    scatter.scatter_add.launches = saved
    plain = scatter._scatter_add_plain(idx, vals, m)
    torch.cuda.synchronize()
    mism = int((out != plain).sum())
    err = float((out - plain).abs().max()) if out.numel() else 0.0
    emit({"phase": "scatter_check", "case": name, "idx": list(idx.shape),
          "rows": m, "channels": vals.shape[-1],
          "dropped": int(((idx < 0) | (idx >= m)).sum()),
          "fullest_row": int(torch.bincount(torch.cat([
              (idx + m * torch.arange(idx.shape[0], device=idx.device)
               [:, None])[(idx >= 0) & (idx < m)],
              idx.new_zeros(1)])).max()),
          "mismatches": mism, "max_abs_err": err,
          "run_to_run_mismatches": int((out != again).sum())})
    if mism or not torch.equal(out, again):
        fail(f"scatter_add {name}: {mism} elements differ from the plain "
             f"version (max {err:.3g})")
    return err


def phase_scatter(gen):
    """At the train step's shapes ((64, 2048) -> 1024, 3072, 2048 rows) and
    the solver's scatter mode ((1024, 2048) -> 2048), a ragged case, eight
    channels, every index equal, indices out of range; and against the
    dense one-hot product at a small size (another order of summation:
    1e-5)."""
    def case(b, n, m, c, lo=0, hi=None):
        idx = torch.randint(lo, m if hi is None else hi, (b, n),
                            generator=gen).cuda()
        return idx, torch.randn((b, n, c), generator=gen).cuda()

    err = 0.0
    for m in (1024, 3072, 2048):
        err = max(err, check_scatter(*case(64, 2048, m, 3), m,
                                     f"train_B64_N2048_M{m}"))
    err = max(err, check_scatter(*case(1024, 2048, 2048, 3), 2048,
                                 "solver_B1024_N2048_M2048"))
    err = max(err, check_scatter(*case(3, 1999, 777, 3), 777,
                                 "ragged_N1999_M777"))
    err = max(err, check_scatter(*case(5, 300, 130, 8), 130, "channels_8"))
    idx, vals = case(2, 2048, 16, 3)
    err = max(err, check_scatter(torch.full_like(idx, 5), vals, 16,
                                 "all_indices_equal"))
    err = max(err, check_scatter(*case(4, 2048, 500, 3, lo=-100, hi=600),
                                 500, "negative_and_past_the_end"))
    from houv_tpu_torch.ops import scatter

    idx, vals = case(4, 256, 128, 3)
    saved = scatter.scatter_add.launches
    out = scatter.scatter_add(idx, vals, 128)
    scatter.scatter_add.launches = saved
    onehot = (idx[..., None] == torch.arange(128, device="cuda")).float()
    dense = torch.einsum("bnm,bnc->bmc", onehot, vals)
    d = float((out - dense).abs().max())
    emit({"phase": "scatter_check", "case": "dense_one_hot_B4_N256_M128",
          "max_abs_err": d, "tolerance": 1e-5})
    if not d <= 1e-5:
        fail(f"scatter_add differs from the one-hot product by {d:.3g}")
    return err


def phase_chamfer_grad(gen):
    """The chamfer Function's gradients for both inputs against autograd
    through the gathered form with the kernel's own matches, at (8, 2048) x
    (8, 3072). autograd's gather backward adds with atomics, in another
    order: 1e-5 of the largest entry. The matches themselves must be those
    of the dense golden ``chamfer_reference``, or as near (1e-6 relative,
    in f64)."""
    from houv_tpu_torch.ops import chamfer, scatter
    from houv_tpu_torch.ops.gather import gather_rows

    a = (torch.rand((8, 2048, 3), generator=gen) - 0.5).cuda()
    b = (torch.rand((8, 3072, 3), generator=gen) - 0.5).cuda()
    w1 = torch.randn((8, 2048), generator=gen).cuda()
    w2 = torch.randn((8, 3072), generator=gen).cuda()
    saved = (scatter.scatter_add.launches, chamfer.chamfer_indices.launches)
    ka, kb = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    d1, d2, i1, i2 = chamfer.chamfer(ka, kb)
    ((d1 * w1).sum() + (d2 * w2).sum()).backward()
    used = scatter.scatter_add.launches - saved[0]
    scatter.scatter_add.launches, chamfer.chamfer_indices.launches = saved
    ra, rb = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    r1 = ((ra - gather_rows(rb, i1)) ** 2).sum(-1)
    r2 = ((rb - gather_rows(ra, i2)) ** 2).sum(-1)
    ((r1 * w1).sum() + (r2 * w2).sum()).backward()
    _, _, g1, g2 = chamfer.chamfer_reference(a, b)
    torch.cuda.synchronize()
    rel = max(float((ka.grad - ra.grad).abs().max() / ra.grad.abs().max()),
              float((kb.grad - rb.grad).abs().max() / rb.grad.abs().max()))
    # a match may differ from the golden's only at a tie: the golden takes
    # its distances in the expansion form, which rounds otherwise
    kd1, kd2 = _nn_dists(a, b, i1, i2)
    gd1, gd2 = _nn_dists(a, b, g1, g2)
    differing = int((i1 != g1).sum() + (i2 != g2).sum())
    off_golden = int((kd1 > gd1 * (1 + 1e-6)).sum()
                     + (kd2 > gd2 * (1 + 1e-6)).sum())
    emit({"phase": "chamfer_grad_check", "a": list(a.shape),
          "b": list(b.shape), "scatter_launches": used,
          "max_err_over_max_grad": rel, "tolerance": 1e-5,
          "value_err": float(max((d1 - r1).detach().abs().max(),
                                 (d2 - r2).detach().abs().max())),
          "matches_differing_from_dense_golden": differing,
          "matches_farther_than_the_golden's": off_golden,
          "match_tolerance_rel": 1e-6})
    if not rel <= 1e-5 or used != 2 or off_golden:
        fail(f"chamfer gradient differs by {rel:.3g} of its largest entry "
             f"({used} scatter launches, {off_golden} matches farther than "
             "the dense golden's)")


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
    from houv_tpu_torch.ops.scatter import scatter_add

    return {"knn": knn_indices, "fps": furthest_point_sample,
            "nn_both": chamfer_indices, "emd": emd_auction_with_stats,
            "scatter_add": scatter_add}


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


def _small_train_cfg(**extra):
    from houv_tpu_torch.train.config import Config

    with open(REPO / "cfgs" / "vrcnet.yaml") as f:
        raw = yaml.safe_load(f)
    raw.update(num_points=256, num_coarse_raw=128, num_fps=256,
               num_coarse=256, layers="1, 1, 1, 1", knn_list="4, 8", pk=8,
               batch_size=8, synthetic_size=16, **extra)
    return Config.from_dict(raw)


def _share_picks(own, ref):
    """``own`` geometry with its index tensors replaced by ``ref``'s."""
    if isinstance(own, torch.Tensor):
        return own if own.is_floating_point() else ref.to(own.device)
    if isinstance(own, dict):
        return {k: _share_picks(v, ref[k]) for k, v in own.items()}
    return type(own)(_share_picks(o, r) for o, r in zip(own, ref))


def _index_tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [] if tree.is_floating_point() else [tree]
    return [t for v in (tree.values() if isinstance(tree, dict) else tree)
            for t in _index_tensors(v)]


def _flips(own, ref):
    return sum(int((o.cpu() != r.cpu()).sum())
               for o, r in zip(_index_tensors(own), _index_tensors(ref)))


class _Picks:
    """Stands in for a function that returns index tensors (``fps``,
    ``chamfer_indices``) wherever the port's modules hold it. It calls the
    function every time; without ``replay`` it keeps the results in call
    order, with ``replay`` it counts the entries that differ from the
    kept ones and returns those instead."""

    def __init__(self, fn, replay=None):
        self.fn, self.replay = fn, replay
        self.kept, self.flips, self.launches = [], 0, 0
        self.holders = [m for name, m in list(sys.modules.items())
                        if name.startswith("houv_tpu_torch")
                        and getattr(m, fn.__name__, None) is fn]

    def __call__(self, *args, **kwargs):
        out = self.fn(*args, **kwargs)
        if self.replay is None:
            self.kept.append(out)
            return out
        ref = self.replay[len(self.kept)]
        self.kept.append(out)
        self.flips += _flips(out, ref)
        return _share_picks(out, ref)

    def __enter__(self):
        for m in self.holders:
            setattr(m, self.fn.__name__, self)
        return self

    def __exit__(self, *exc):
        for m in self.holders:
            setattr(m, self.fn.__name__, self.fn)


def _small_train_step(cfg, batch, noise, dev, dtype, picks=None):
    """One forward and backward of the seeded small model on ``dev`` in
    ``dtype``: total_loss, the gradients by name (f64, on the CPU) and the
    picks it made: the FPS picks, the chamfer matches and the U-Net's
    geometry. With ``picks`` (another run's), every one of them is still
    computed here, by the kernels on the card, and counted where it
    differs, and the run goes on with the given ones."""
    from houv_tpu_torch.ops.chamfer import chamfer_indices
    from houv_tpu_torch.ops.sampling import furthest_point_sample
    from houv_tpu_torch.train.harness import CompletionTrainer

    model = CompletionTrainer(cfg, dev).init_state()
    masks = model.decoder.encoder.dropout_masks(
        16, torch.Generator().manual_seed(12))
    model = model.to(dtype)
    given = picks or {"fps": None, "matches": None, "geometry": None}
    seen = {}

    def hook(_, args):
        seen["geometry"] = args[1]
        if picks is None:
            return None
        seen["flips"] = _flips(args[1], given["geometry"])
        return (args[0], _share_picks(args[1], given["geometry"]), *args[2:])

    handle = model.decoder.encoder.register_forward_pre_hook(hook)
    with _Picks(furthest_point_sample, given["fps"]) as fps, \
            _Picks(chamfer_indices, given["matches"]) as matches:
        out = model(torch.as_tensor(batch["partial"], device=dev).to(dtype),
                    torch.as_tensor(batch["gt"], device=dev).to(dtype),
                    "train", alpha=0.5, noise=[n.to(dtype) for n in noise],
                    dropout_masks=[m.to(dtype) for m in masks])
    handle.remove()
    out["total_loss"].backward()
    return (out["total_loss"].item(),
            {n: p.grad.double().cpu() for n, p in model.named_parameters()},
            {"fps": fps.kept, "matches": matches.kept,
             "geometry": seen["geometry"]},
            {"fps": fps.flips, "matches": matches.flips,
             "geometry": seen.get("flips", 0)})


def phase_train_reference():
    """One train step at the parity tests' size (256 points, layers
    1,1,1,1, batch 8) on the card against the port's CPU path in f64: the
    same seeded weights, batch, latent noise and dropout masks. The f32 run
    computes its own FPS picks, chamfer matches and kNN graphs (on the card
    with the kernels), counts where these differ from the f64 run's, and
    goes on with the f64 run's: a near-tie that flips between precisions
    selects another point, which is another function. On equal picks what
    is left is rounding: total_loss to 1e-4 relative, every parameter's
    gradient to 1e-3 of that tensor's largest f64 entry. Printed beside
    it, not held: a second run on the card (autograd's gather backward adds
    with atomics), and the CPU path in f32, whose distance from f64 on the
    small gradients deep in the U-Net (sums of cancelling terms) changes by
    orders of magnitude with the order its threads add in."""
    from houv_tpu_torch.train.cli import build_dataset

    cfg = _small_train_cfg()
    batch = build_dataset(cfg, "train").get_batch(
        np.arange(8), rng=np.random.default_rng(0))
    g = torch.Generator().manual_seed(11)
    noise = [torch.randn((8, 128), generator=g) for _ in range(2)]
    ref_loss, ref_g, picks, _ = _small_train_step(cfg, batch, noise, "cpu",
                                                  torch.float64)
    runs = {"cuda": _small_train_step(cfg, batch, noise, "cuda",
                                      torch.float32, picks),
            "cuda_again": _small_train_step(cfg, batch, noise, "cuda",
                                            torch.float32, picks),
            "cpu_f32": _small_train_step(cfg, batch, noise, "cpu",
                                         torch.float32, picks)}
    rec = {"phase": "train_reference", "clouds": 8, "points": 256,
           "total_loss_cpu_f64": ref_loss, "loss_tolerance_rel": 1e-4,
           "grad_tolerance_over_tensor_max": 1e-3, "held": ["cuda"],
           "cpu_threads": torch.get_num_threads(),
           "largest_grad_entry": max(float(r.abs().max())
                                     for r in ref_g.values()),
           "smallest_tensor_max": min(float(r.abs().max())
                                      for r in ref_g.values()),
           "parameters": len(ref_g)}
    for dev, (loss, grads, _, flips) in runs.items():
        rows = sorted(((float((grads[n] - r).abs().max() / r.abs().max()), n,
                        float(r.abs().max())) for n, r in ref_g.items()),
                      reverse=True)
        rec[dev] = {"total_loss": loss,
                    "loss_rel_diff": abs(loss - ref_loss) / abs(ref_loss),
                    "picks_differing_from_f64": flips,
                    "worst_grads": [{"name": n, "err_over_tensor_max": e,
                                     "tensor_max": m}
                                    for e, n, m in rows[:4]]}
    rec["cuda_run_to_run_over_tensor_max"] = max(
        float((runs["cuda"][1][n] - runs["cuda_again"][1][n]).abs().max()
              / r.abs().max()) for n, r in ref_g.items())
    emit(rec)
    worst = rec["cuda"]["worst_grads"][0]
    if not (rec["cuda"]["loss_rel_diff"] <= 1e-4
            and worst["err_over_tensor_max"] <= 1e-3):
        fail(f"train step on the card differs from the f64 CPU path: loss "
             f"{rec['cuda']['loss_rel_diff']:.3g} relative, gradient of "
             f"{worst['name']} {worst['err_over_tensor_max']:.3g} of its "
             "largest entry")


def _full_train_cfg(tmp, **extra):
    with open(REPO / "cfgs" / "vrcnet.yaml") as f:
        raw = yaml.safe_load(f)
    raw.update(work_dir=str(tmp), **extra)
    path = Path(tmp) / ("vrcnet_train_" + "_".join(
        f"{k}{v}" for k, v in sorted(extra.items()) if k != "load_model")
        + ("_loaded" if "load_model" in extra else "") + ".yaml")
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def _repeated_batch(tmp, n_steps, use_remat, **extra):
    """``n_steps`` train steps on one repeated batch of 32 clouds at full
    width from the seeded initialisation: losses, steps/s, peak memory
    (after a first step outside the clock) and the kernels' launches.
    ``extra`` overrides keys of the config."""
    from houv_tpu_torch.train.cli import build_dataset
    from houv_tpu_torch.train.config import load_config
    from houv_tpu_torch.train.harness import CompletionTrainer

    cfg = load_config(_full_train_cfg(tmp, use_remat=use_remat, **extra))
    trainer = CompletionTrainer(cfg)
    trainer.init_state()
    batch = build_dataset(cfg, "train").get_batch(
        np.arange(32), rng=np.random.default_rng(0))
    counters = _completion_counters()
    for c in counters.values():
        c.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses = [float(trainer.train_step(batch, 0, 0))]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for step in range(1, n_steps):
        losses.append(float(trainer.train_step(batch, 0, step)))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    rec = {"phase": "train_repeated_batch", "config": "cfgs/vrcnet.yaml",
           "batch": 32, "use_remat": use_remat, "loss": cfg.loss,
           "steps": n_steps, "losses": losses,
           "launches": {k: c.launches for k, c in counters.items()},
           "steps_per_s": (n_steps - 1) / seconds,
           "clouds_per_s": 32 * (n_steps - 1) / seconds,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}
    emit(rec)
    del trainer
    torch.cuda.empty_cache()
    return rec


def phase_train():
    """``train_main`` on cfgs/vrcnet.yaml at full width on the synthetic
    split (128 train clouds: 4 steps an epoch at batch 32; 64 val clouds: 2
    val batches an epoch), two epochs, without ``use_remat``; then
    ``test_main`` with ``load_model`` on the checkpoint, and the
    repeated-batch runs."""
    from houv_tpu_torch.train.cli import build_dataset, test_main, train_main
    from houv_tpu_torch.train.config import load_config
    from houv_tpu_torch.train.harness import CompletionTrainer
    from houv_tpu_torch.train.submission import read_results_h5

    counters = _completion_counters()
    with tempfile.TemporaryDirectory() as tmp:
        for c in counters.values():
            c.launches = 0
        torch.cuda.reset_peak_memory_stats()
        out = train_main(["-c", _full_train_cfg(tmp, nepoch=2)])
        torch.cuda.synchronize()
        launches = {k: c.launches for k, c in counters.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        trainer = out["trainer"]
        steps, val_batches = len(out["losses"]), 2 * 2
        # per train step: 4 calc_cd (one nn_both forward and, gt needing no
        # gradient, one scatter backward each); fps of the gt, the decoder's
        # 3-level pyramid and coarse_high 3072 -> 2048; 14 knn (8 graphs, 3
        # pooling, 3 three-NN). per val batch: 1 nn_both, 4 fps, 14 knn.
        expected = {"scatter_add": 4 * steps,
                    "nn_both": 4 * steps + val_batches,
                    "fps": 5 * steps + 4 * val_batches,
                    "knn": 14 * steps + 14 * val_batches, "emd": 0}
        model = trainer.model
        fresh = CompletionTrainer(trainer.cfg)
        fresh.init_state()
        moved = sum(int(not torch.equal(p, q)) for p, q in zip(
            model.parameters(), fresh.model.parameters()))
        n_params = sum(1 for _ in model.parameters())
        finite_grads = sum(int(p.grad is not None
                               and bool(torch.isfinite(p.grad).all()))
                           for p in model.parameters())
        del fresh

        # the checkpoint reloads to bit-equal predictions, in a trainer and
        # through test_main with load_model
        cfg_loaded = _full_train_cfg(tmp, synthetic_size=64,
                                     load_model=out["checkpoint"])
        reloaded = CompletionTrainer(load_config(cfg_loaded))
        reloaded.init_state()
        test_ds = build_dataset(load_config(cfg_loaded), "test")
        first = test_ds.get_batch(np.arange(32))
        pred = trainer.predict_batch(first, step=0)
        same_trainer = torch.equal(reloaded.predict_batch(first, step=0),
                                   pred)
        res = test_main(["-c", cfg_loaded])
        results = read_results_h5(res["results_h5"])
        same_sweep = np.array_equal(results[:32], pred.cpu().numpy())
        del reloaded
        rec = {"phase": "train", "config": "cfgs/vrcnet.yaml",
               "run": "train_main", "batch": 32, "use_remat": False,
               "epochs": 2, "steps": steps, "losses": out["losses"],
               "seconds": out["seconds"],
               "steps_per_s_with_validate_and_save": steps / out["seconds"],
               "peak_memory_gib": peak, "best": trainer.best,
               "launches": launches, "expected_launches": expected,
               "launches_per_step": {"scatter_add": 4, "nn_both": 4,
                                     "fps": 5, "knn": 14},
               "parameters": n_params, "parameters_moved": moved,
               "parameters_with_finite_grad": finite_grads,
               "checkpoint": os.path.basename(out["checkpoint"]),
               "checkpoint_files": sorted(os.listdir(out["log_dir"])),
               "reload_bit_equal": same_trainer,
               "test_main_load_model_bit_equal": same_sweep,
               "test_main_clouds": res["n_clouds"]}
        emit(rec)
        if steps < 8 or not np.isfinite(out["losses"]).all():
            fail(f"train_main: {steps} steps, losses {out['losses']}")
        if launches != expected:
            fail(f"train_main launches {launches}, expected {expected}")
        if moved != n_params or finite_grads != n_params:
            fail(f"train_main: {moved} of {n_params} parameters moved, "
                 f"{finite_grads} have a finite gradient")
        if not (same_trainer and same_sweep):
            fail("the checkpoint does not reload to bit-equal predictions "
                 f"(trainer {same_trainer}, test_main {same_sweep})")
        if results.shape != (64, 2048, 3) or not np.isfinite(results).all():
            fail(f"test_main with load_model: results {results.shape}")
        del trainer, model, pred
        torch.cuda.empty_cache()

        rep = _repeated_batch(tmp, 20, False)
        if not (np.isfinite(rep["losses"]).all()
                and rep["losses"][-1] < rep["losses"][0]):
            fail(f"20 steps on one batch did not lower the loss: "
                 f"{rep['losses']}")
        remat = _repeated_batch(tmp, 3, True)
        # loss: emd. Per step four auctions (1024, 3072, 2048 and 2048
        # bidders for the gt's 2048 items), whose gradient needs no kernel;
        # the logged cd_t takes one nn_both and stays out of the backward.
        emd = _repeated_batch(tmp, 4, False, loss="emd")
        want = {"emd": 16, "nn_both": 4, "scatter_add": 0, "fps": 20,
                "knn": 56}
        if emd["launches"] != want or not (
                np.isfinite(emd["losses"]).all()
                and emd["losses"][-1] < emd["losses"][0]):
            fail(f"loss: emd training: launches {emd['launches']}, expected "
                 f"{want}; losses {emd['losses']}")
    return {"train": rec, "repeated": rep, "remat": remat, "emd": emd}


def phase_scatter_solve():
    """``houv_solve`` with ``grad_mode='scatter'`` beside the gather mode:
    4 pairs of the structured split, cfgs/houv.yaml with the budget cut to
    100 steps. One scatter launch per Adam step (the target needs no
    gradient), in every angle window that runs."""
    import dataclasses

    from houv_tpu_torch.data import synthesize_registration_pairs
    from houv_tpu_torch.ops.scatter import scatter_add
    from houv_tpu_torch.solvers.houv import (evaluate_solution, houv_solve,
                                             init_params)
    from houv_tpu_torch.train.cli import solver_config
    from houv_tpu_torch.train.config import load_config

    cfg = load_config(str(REPO / "cfgs" / "houv.yaml"))
    base = dataclasses.replace(solver_config(cfg), steps=100)
    d = synthesize_registration_pairs(
        4, n_points=cfg.num_points, max_angle_deg=cfg.max_angle,
        max_trans=cfg.max_trans, seed=7, shape_mode="structured",
        rot_mix=True)
    src = torch.as_tensor(d["rotated_src"], device="cuda")
    tgt = torch.as_tensor(d["rotated_tgt"], device="cuda")
    gt = torch.as_tensor(d["transforms"], device="cuda")
    rec = {"phase": "scatter_solve", "config": "cfgs/houv.yaml", "pairs": 4,
           "restarts": base.kernel, "steps": 100}
    for mode in ("gather", "scatter"):
        scfg = dataclasses.replace(base, grad_mode=mode)
        params0 = init_params(torch.Generator().manual_seed(0), 4,
                              scfg.kernel, device="cuda")
        scatter_add.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = houv_solve(src, tgt, scfg, params0=params0)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        r_err, _ = evaluate_solution(out["transform"], gt)
        windows = 1 + (scfg.angle_passes - 1) * int(out["n_retry"] > 0)
        rec[mode] = {"seconds": seconds, "n_retry": out["n_retry"],
                     "windows": windows,
                     "rot_err_deg": r_err.tolist(),
                     "rmse": out["rmse"].tolist(),
                     "scatter_launches": scatter_add.launches}
        want = 100 * windows if mode == "scatter" else 0
        if scatter_add.launches != want:
            emit(rec)
            fail(f"houv_solve grad_mode={mode}: {scatter_add.launches} "
                 f"scatter launches, expected {want}")
        if not torch.isfinite(out["transform"]).all():
            emit(rec)
            fail(f"houv_solve grad_mode={mode}: transform not finite")
    emit(rec)
    return rec


def phase_profile_train():
    """Where one VRCNet train step's time goes: torch.profiler over one
    step of 32 clouds at full width, after two warm-up steps."""
    from torch.profiler import ProfilerActivity, profile

    from houv_tpu_torch.train.cli import build_dataset
    from houv_tpu_torch.train.config import load_config
    from houv_tpu_torch.train.harness import CompletionTrainer

    with tempfile.TemporaryDirectory() as tmp:
        cfg = load_config(_full_train_cfg(tmp))
        trainer = CompletionTrainer(cfg)
        trainer.init_state()
        batch = build_dataset(cfg, "train").get_batch(
            np.arange(32), rng=np.random.default_rng(0))
        for step in range(2):
            trainer.train_step(batch, 0, step)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer.train_step(batch, 0, 2)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    emit({"phase": "profile", "config": "cfgs/vrcnet.yaml", "clouds": 32,
          "run": "train_step", **_profile_top(prof, wall_ms)})
    del trainer
    torch.cuda.empty_cache()


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


def _time_scatter(b, n, m, gen):
    """scatter_add at idx (b, n) -> m rows, 3 channels: kernel, plain and
    ``Tensor.scatter_add_`` milliseconds, and the function's bound: idx,
    vals and out moved once, and b*n*3 additions, whichever takes longer.
    The kernel's owner scan compares every index with every row; those
    b*n*m compares are its algorithm's work, not the function's, and stand
    beside the bound as ``scan_compares`` and ``scan_ms_at_peak`` (at the
    CUDA cores' f32 rate; the table has no separate integer rate)."""
    from houv_tpu_torch.ops import scatter

    idx = torch.randint(0, m, (b, n), generator=gen).cuda()
    vals = torch.randn((b, n, 3), generator=gen).cuda()
    saved = scatter.scatter_add.launches
    ms = cuda_ms(lambda: scatter.scatter_add(idx, vals, m), reps=20)
    scatter.scatter_add.launches = saved
    plain_ms = cuda_ms(lambda: scatter._scatter_add_plain(idx, vals, m),
                       reps=10, warmup=2)
    wide = idx[..., None].expand(-1, -1, 3)
    library_ms = cuda_ms(lambda: torch.zeros(
        (b, m, 3), device="cuda").scatter_add_(1, wide, vals), reps=20,
        warmup=2)
    bound_ms, bound_by = bound(8 * b * n + 12 * b * n + 12 * b * m,
                               3.0 * b * n)
    return {"shape": {"idx": [b, n], "vals": [b, n, 3], "rows": m},
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "scan_compares": b * n * m,
            "scan_ms_at_peak": b * n * m / PEAK_F32_FLOPS * 1e3}


def phase_kernels(launches, nn_err, knn_err, emd_err, scatter_err,
                  completion, train, solve, gen):
    """``launches``: the houv_fast counts; ``completion``: the VRCNet runs
    (their counts summed for knn and emd, and the first val batch's fine
    and gt clouds, on which emd is timed); ``train``: the train_main run
    (scatter_add's count); ``solve``: the scatter-mode solve."""
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
    del fine, gt
    torch.cuda.empty_cache()

    # scatter_add at the train step's largest backward, coarse_high: 64 rows
    # of 2048 gt matches onto 3072 points; and at the solver's scatter mode
    at_train = _time_scatter(64, 2048, 3072, gen)
    at_solver = _time_scatter(1024, 2048, 2048, gen)
    out.append({"name": "scatter_add", "route": "cuda",
                "source": "houv_tpu_torch/csrc/scatter.cu",
                "replaces": "houv_tpu/ops/scatter.py:35",
                "launches": train["train"]["launches"]["scatter_add"],
                "launches_scatter_solve":
                    solve["scatter"]["scatter_launches"],
                "max_abs_err": scatter_err, **at_train,
                "at_solver_shape": at_solver})
    for row in out:
        row["train_main_launches"] = train["train"]["launches"].get(
            row["name"], 0)
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
    scatter_err = phase_scatter(gen)
    phase_chamfer_grad(gen)
    fast = phase_main()
    phase_completion_reference()
    completion = phase_completion()
    phase_train_reference()
    train = phase_train()
    solve = phase_scatter_solve()
    phase_profile()
    phase_profile_vrcnet()
    phase_profile_train()
    emit({"kernels": phase_kernels(fast["launches"], nn_err, knn_err,
                                   emd_err, scatter_err, completion, train,
                                   solve, gen)})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
