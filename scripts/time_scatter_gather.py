#!/usr/bin/env python3
"""Times of the ordered scatter-add (K4), the row gather (K5), the
feature-space kNN (K6-wide), the nearest-neighbour search (K1), the
coordinate kNN (K6), the furthest-point sampling (K2), the auction EMD
(K7), the coordinate search (K3) and K2's and K7's kernels for clouds past
their limits of the ``houv_tpu_torch`` in the working directory,
and the end-to-end rates around them, all taken by this
repository's ``chip_smoke.py``, so that an older checkout can be timed
beside this one on one card, in turns:

    (cd <old checkout> && python3 <this repo>/scripts/time_scatter_gather.py)
    python3 scripts/time_scatter_gather.py [scatter gather_rows knn_wide
                                            steps nn_both houv knn
                                            vrcnet_test profiles fps emd
                                            nn_select fps_large emd_large]

(the named parts only; all fourteen without arguments)

- scatter, gather_rows: K4 and K5 at the shapes of PERF.md's kernel table
  (``_time_scatter``, ``_time_gather_rows``: device time, plain version,
  library yardstick);
- knn_wide: K6-wide's device time at its seven path shapes
  (``KNN_WIDE_SHAPES``, ``_time_knn_wide``);
- steps: train steps/s of 10 steps on one repeated batch of
  cfgs/vrcnet.yaml, cfgs/pcn.yaml and cfgs/ecg.yaml (``_repeated_batch``;
  4, 2 and 2 K4 launches a step), and pairs/s of ``test_main`` on
  cfgs/houv_fast.yaml over 100 pairs (``run_sweep``; no K4 or K5: the
  host's speed on this machine);
- nn_both: K1's device time at its twelve path shapes (``NN_SHAPES``,
  ``_time_nn_both``: houv_fast's final phase, houv.yaml's 6400-row step,
  the train steps' calc_cd, the ICP and grid Go-ICP batches, vrcnet_knn's
  calc_cd and its fused_cd stack);
- houv: pairs/s, wall seconds, retries and median rotation error of
  ``test_main`` on cfgs/houv.yaml over 100 pairs, one batch (``run_sweep``;
  501 K1 launches a pass);
- knn: K6's device time at its 42 path shapes (``KNN_SHAPES``,
  ``_time_knn``: VRCNet's 14 per forward, ECG's 6, get_uniform_loss's 10
  per ECG step, FGR's k 16 and 17, vrcnet_knn's 10) and their sum over
  VRCNet's 14;
- vrcnet_test: clouds/s of ``test_main`` on cfgs/vrcnet.yaml over 512
  synthetic clouds (14 K6 launches a batch of 32);
- profiles: device milliseconds of one VRCNet and one ECG train step under
  torch.profiler (``phase_profile_train``), with the port's kernels' share;
- fps: K2's device time at its 21 path shapes (``FPS_SHAPES``,
  ``_time_fps``: houv_fast's phases, combine, VRCNet's 5 and ECG's 14 a
  train step, goicp_bnb's, vrcnet_knn's 4 a forward);
- emd: K7's device time, rounds and bids on its paths' own clouds
  (``emd_path_inputs``, ``EMD_SHAPES``: validate's first batch with
  eval_emd and the auctions of one ``loss: emd`` step of VRCNet and ECG),
  clouds/s of VRCNet's ``validate`` with eval_emd over 128 synthetic
  clouds (after one warm-up pass; one auction a batch of 32), and K7's
  device time in one profiled ``loss: emd`` train step of VRCNet (4
  auctions) and of ECG (2);
- nn_select: K3's device time at the solver's two shapes
  (``NN_SELECT_SHAPES``, ``_time_nn_select``: 16 and 100 pairs of 64
  restarts, 2048 points a side) beside K1 and the two gathers of the
  default branch on the same inputs (``k1_gather_ms``), and ``houv_solve``
  on cfgs/houv.yaml's solver config over 100 pairs of the structured split
  (seed 7, one batch) with ``nn_select=True`` and with the default, called
  directly as ``phase_select_solve`` calls it (the yaml has no key for
  it), each after a 10-step warm-up solve: pairs/s, median rotation
  error, ``n_retry`` and launches;
- fps_large: the device time of furthest-point sampling past K2's 8192
  points at ``chip_smoke.LARGE_FPS``, VRCNet's two at 16384 points,
  (8, 16384) and (16, 18432) -> 2048, the same two at cfgs/vrcnet.yaml's
  batch of 32, (32, 16384) and (64, 18432) -> 2048, and one cloud of
  65536 points -> 2048 (``YAML_FPS``; whichever kernel the checkout routes
  them to), and the seconds of 3 train steps of cfgs/vrcnet.yaml at
  num_points 16384, batch 8 (``chip_smoke._large_vrcnet_cfg``; after one
  warm-up step);
- emd_large: the device time, rounds and bids of the auction past K7's
  shared memory at ``chip_smoke.LARGE_EMD``'s pairs at validate's eps
  0.004 and 3000 rounds, and on VRCNet's untrained outputs at 8192 points
  (validate's (8, 8192)², and at cfgs/vrcnet.yaml's batch of 32,
  (32, 8192)²), and the seconds of ``validate`` with eval_emd
  at 8192 points (after one warm-up pass).

Only the package comes from the working directory. Prints one JSON line
after chip_smoke's own; needs CUDA and builds the checkout's kernels at
first use.
"""

import json
import os
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (imports no package of the port itself)

sys.path.insert(0, os.getcwd())         # the checkout's houv_tpu_torch


# the FPS past K2's limit at cfgs/vrcnet.yaml's batch of 32 (the smoke's
# path runs 8), and one cloud at csrc/fps_large.cu's capacity
YAML_FPS = ((32, 16384, 2048), (64, 18432, 2048), (1, 65536, 2048))
PARTS = ("scatter", "gather_rows", "knn_wide", "steps", "nn_both", "houv",
         "knn", "vrcnet_test", "profiles", "fps", "emd", "nn_select",
         "fps_large", "emd_large")


def time_emd():
    """K7 at its path inputs, VRCNet's validate with eval_emd, and K7 in
    the profiled loss: emd train steps (the ``emd`` part)."""
    from houv_tpu_torch.ops import emd
    from houv_tpu_torch.train.cli import build_dataset
    from houv_tpu_torch.train.config import load_config
    from houv_tpu_torch.train.harness import CompletionTrainer

    out = {"emd": []}
    with tempfile.TemporaryDirectory() as tmp:
        inputs = chip_smoke.emd_path_inputs(tmp)
        for (x1, x2, eps, iters), shape in zip(inputs, chip_smoke.EMD_SHAPES):
            _, _, rounds, bids = emd.emd_auction_with_stats(x1, x2, eps, iters)
            out["emd"].append({
                "path": shape[5], "shape": [*x1.shape[:2], x2.shape[1]],
                "rounds_max": int(rounds.max()), "bids": int(bids.sum()),
                "ms": chip_smoke.cuda_ms(lambda: emd.emd_auction_with_stats(
                    x1, x2, eps, iters), reps=3)})
        del inputs
        cfg = load_config(chip_smoke._model_cfg(tmp, "vrcnet", 128,
                                                eval_emd=True))
        trainer = CompletionTrainer(cfg)
        trainer.init_state()
        val_ds = build_dataset(cfg, "val")
        trainer.validate(val_ds)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.validate(val_ds)
        torch.cuda.synchronize()
        out["vrcnet_validate_eval_emd_clouds_per_s"] = (
            len(val_ds) / (time.perf_counter() - t0))
        del trainer
        torch.cuda.empty_cache()
    out["loss_emd_step_profiles"] = {}
    for model in ("vrcnet", "ecg"):
        rec = chip_smoke.phase_profile_train(model, loss="emd")
        out["loss_emd_step_profiles"][model] = {
            "device_ms": rec["device_ms"], "wall_ms": rec["wall_ms"],
            "emd_kernel": rec["port_kernels"].get("emd_kernel")}
    return out


def time_nn_select(gen):
    """K3 and K1 + gathers at the solver's shapes, and the select branch of
    houv_solve beside the default on houv.yaml over 100 pairs (the
    ``nn_select`` part)."""
    import dataclasses

    from houv_tpu_torch.data import synthesize_registration_pairs
    from houv_tpu_torch.ops.chamfer import chamfer_indices, nn_select
    from houv_tpu_torch.solvers.houv import evaluate_solution, houv_solve
    from houv_tpu_torch.train.cli import solver_config
    from houv_tpu_torch.train.config import load_config

    out = {"nn_select": [
        chip_smoke._time_nn_select(bq, 64, 2048, 2048, gen, yardsticks=False)
        for bq in chip_smoke.NN_SELECT_SHAPES]}
    torch.cuda.empty_cache()
    cfg = load_config(str(chip_smoke.REPO / "cfgs" / "houv.yaml"))
    d = synthesize_registration_pairs(
        100, n_points=cfg.num_points, max_angle_deg=cfg.max_angle,
        max_trans=cfg.max_trans, seed=7, shape_mode="structured",
        rot_mix=True)
    src, tgt, gt = (torch.as_tensor(d[k], device="cuda")
                    for k in ("rotated_src", "rotated_tgt", "transforms"))
    for select in (False, True):
        scfg = dataclasses.replace(solver_config(cfg), nn_select=select)
        # a short solve first: the allocator's warm-up is not the branch's
        houv_solve(src, tgt, dataclasses.replace(scfg, steps=10,
                                                 angle_passes=1))
        nn_select.launches, chamfer_indices.launches = 0, 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = houv_solve(src, tgt, scfg)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        r_err, _ = evaluate_solution(res["transform"], gt)
        out["houv_solve_nn_select" if select else "houv_solve_default"] = {
            "pairs": 100, "seconds": seconds, "pairs_per_s": 100 / seconds,
            "rot_err_median_deg": float(r_err.median()),
            "n_retry": int(res["n_retry"]),
            "nn_select_launches": nn_select.launches,
            "nn_both_launches": chamfer_indices.launches}
    return out


def time_fps_large(gen):
    """FPS past K2's limit at its shapes, and VRCNet's train steps at 16384
    points (the ``fps_large`` part)."""
    import numpy as np

    from houv_tpu_torch.ops.sampling import furthest_point_sample
    from houv_tpu_torch.train.cli import build_dataset
    from houv_tpu_torch.train.config import load_config
    from houv_tpu_torch.train.harness import CompletionTrainer

    rows = []
    for b, n, k in chip_smoke.LARGE_FPS + chip_smoke.LARGE_FPS_PATH \
            + YAML_FPS:
        pts = torch.randn((b, n, 3), generator=gen).cuda()
        rows.append({"shape": [b, n, k], "ms": chip_smoke.cuda_ms(
            lambda: furthest_point_sample(pts, k), reps=10)})
    with tempfile.TemporaryDirectory() as tmp:
        cfg = load_config(chip_smoke._large_vrcnet_cfg(tmp, 32, 16384))
        trainer = CompletionTrainer(cfg)
        trainer.init_state()
        ds = build_dataset(cfg, "train")
        batches = [ds.get_batch(np.arange(8 * i, 8 * i + 8),
                                rng=np.random.default_rng(i))
                   for i in range(4)]
        trainer.train_step(batches[0], 0, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, bt in enumerate(batches[1:]):
            trainer.train_step(bt, 0, i + 1)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        del trainer, batches
        torch.cuda.empty_cache()
    return {"fps_large": rows, "vrcnet_16384_three_steps_s": seconds}


def time_emd_large(gen):
    """The auction past K7's shared memory at its shapes and on validate's
    outputs at 8192 points, and that validate (the ``emd_large`` part)."""
    import numpy as np

    from houv_tpu_torch.ops.emd import emd_auction_with_stats
    from houv_tpu_torch.train.cli import build_dataset
    from houv_tpu_torch.train.config import load_config
    from houv_tpu_torch.train.harness import CompletionTrainer

    def row(x1, x2):
        _, _, rounds, bids = emd_auction_with_stats(x1, x2, 0.004, 3000)
        return {"shape": [*x1.shape[:2], x2.shape[1]],
                "rounds_max": int(rounds.max()), "bids": int(bids.sum()),
                "ms": chip_smoke.cuda_ms(lambda: emd_auction_with_stats(
                    x1, x2, 0.004, 3000), reps=3)}

    rows = []
    for b, n, _ in chip_smoke.LARGE_EMD:
        x1 = torch.rand((b, n, 3), generator=gen).cuda() - 0.5
        x2 = torch.rand((b, n, 3), generator=gen).cuda() - 0.5
        rows.append(row(x1, x2))
    del x1, x2
    with tempfile.TemporaryDirectory() as tmp:
        cfg = load_config(chip_smoke._large_vrcnet_cfg(tmp, 8, 8192,
                                                       eval_emd=True))
        trainer = CompletionTrainer(cfg)
        trainer.init_state()
        val_ds = build_dataset(cfg, "val")
        trainer.validate(val_ds)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.validate(val_ds)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        batch = val_ds.get_batch(np.arange(8))
        with torch.no_grad():
            fine = trainer.predict_batch(batch, step=0)
        rows.append({"path": "validate 8192", **row(
            fine.contiguous(), torch.as_tensor(batch["gt"], device="cuda"))})
        del trainer, fine
        torch.cuda.empty_cache()
        # the yaml's batch of 32
        cfg = load_config(chip_smoke._large_vrcnet_cfg(tmp, 32, 8192,
                                                       eval_emd=True))
        trainer = CompletionTrainer(cfg)
        trainer.init_state()
        batch = build_dataset(cfg, "val").get_batch(np.arange(32))
        with torch.no_grad():
            fine = trainer.predict_batch(batch, step=0)
        rows.append({"path": "validate 8192, batch 32", **row(
            fine.contiguous(), torch.as_tensor(batch["gt"], device="cuda"))})
        del trainer, fine
        torch.cuda.empty_cache()
    return {"emd_large": rows, "vrcnet_validate_8192_eval_emd_s": seconds,
            "validate_clouds": len(val_ds)}


def main() -> int:
    if not torch.cuda.is_available():
        print("time_scatter_gather: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    parts = sys.argv[1:] or list(PARTS)
    unknown = set(parts) - set(PARTS)
    if unknown:
        print(f"time_scatter_gather: no part {sorted(unknown)}; the parts "
              f"are {list(PARTS)}", file=sys.stderr)
        return 2
    gen = torch.Generator().manual_seed(0)
    out = {"checkout": os.getcwd(), "card": chip_smoke.card_line()}
    if "scatter" in parts:
        out["scatter_add"] = [chip_smoke._time_scatter(b, 2048, m, gen)
                              for b, m in ((64, 3072), (1024, 2048))]
    if "gather_rows" in parts:
        out["gather_rows"] = chip_smoke._time_gather_rows(gen)
    if "knn_wide" in parts:
        out["knn_wide"] = [
            chip_smoke._time_knn_wide(b, n, c, k, gen, yardsticks=False)
            for b, n, c, k in chip_smoke.KNN_WIDE_SHAPES]
    if "steps" in parts:
        with tempfile.TemporaryDirectory() as tmp:
            out["train_steps_per_s"] = {
                model: chip_smoke._repeated_batch(tmp, 10, False,
                                                  model)["steps_per_s"]
                for model in ("vrcnet", "pcn", "ecg")}
            out["houv_fast_pairs_per_s"] = chip_smoke.run_sweep(
                "houv_fast.yaml", 100, Path(tmp))["pairs_per_s"]
    if "nn_both" in parts:
        out["nn_both"] = [
            chip_smoke._time_nn_both(*shape, gen, yardsticks=False)
            for shape in chip_smoke.NN_SHAPES]
    if "houv" in parts:
        with tempfile.TemporaryDirectory() as tmp:
            rec = chip_smoke.run_sweep("houv.yaml", 100, Path(tmp))
        out["houv"] = {k: rec[k] for k in (
            "pairs_per_s", "wall_s", "solve_s", "n_retry",
            "rot_err_median_deg", "launches")}
    if "knn" in parts:
        out["knn"] = [chip_smoke._time_knn(*shape, gen, yardsticks=False)
                      for shape in chip_smoke.KNN_SHAPES]
        out["knn_vrcnet_sum_ms"] = sum(row["ms"] for row in out["knn"]
                                       if row["path"] == "vrcnet")
    if "vrcnet_test" in parts:
        from houv_tpu_torch.train.cli import test_main
        with tempfile.TemporaryDirectory() as tmp:
            res = test_main(["-c", chip_smoke._model_cfg(tmp, "vrcnet",
                                                         512)])
        out["vrcnet_test_clouds_per_s"] = res["n_clouds"] / res["seconds"]
    if "profiles" in parts:
        out["train_step_profiles"] = {}
        for model in ("vrcnet", "ecg"):
            rec = chip_smoke.phase_profile_train(model)
            out["train_step_profiles"][model] = {
                k: rec[k] for k in ("device_ms", "wall_ms", "port_kernels")}
    if "fps" in parts:
        out["fps"] = [chip_smoke._time_fps(*shape, gen)
                      for shape in chip_smoke.FPS_SHAPES]
    if "emd" in parts:
        out.update(time_emd())
    if "nn_select" in parts:
        out.update(time_nn_select(gen))
    if "fps_large" in parts:
        out.update(time_fps_large(gen))
    if "emd_large" in parts:
        out.update(time_emd_large(gen))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
