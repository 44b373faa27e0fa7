#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``houv_tpu_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --quality-pairs 100

With ``--quality-pairs P`` it runs phases 1 and 3's quality modes alone,
their sweeps over P pairs at a batch of P (the yamls' own batch is 100),
and prints no last line. With no argument it runs every phase:

Phases, each printing JSON lines (and ``phase_done`` with its seconds); any
failed check exits non-zero:

1. the card (nvidia-smi name and power limit) and the kernel build
   (nvcc, sm_90a, from ``houv_tpu_torch/csrc``, one nvcc per source);
2. each of the eight kernels against its plain PyTorch version on the card:
   the nearest-neighbour search ``nn_both``, index for index (shared-query
   layout, houv.yaml's 6400 rows, the train steps' shapes (vrcnet_knn's
   and its fused_cd stack with the sentinels too), ragged, tiny M,
   the classical solvers' ICP and grid Go-ICP batches, unshared,
   the tile and block edges of its launch plan with exact copies planted
   across threads, tiles and blocks, integer grids, NaN points and all-NaN
   clouds) and its coordinate form
   ``nn_select``, which runs the same search (the solver's shapes, 16 and
   houv.yaml's 100 pairs of 64 restarts, unshared, ragged, duplicates, each
   split of the launch plan, planted copies, grids, all-NaN clouds and one
   NaN point in a finite cloud: bit for bit against the plain version and
   against the gather of K1's indices);
   ``fps``
   (exact indices at its 22 path shapes, ``FPS_SHAPES``: the solver's,
   VRCNet's, ECG's, goicp_bnb's, vrcnet_knn's and the transformer's, the
   uniform losses' seeds included; at
   the edges of its plan, one point, K == 1 and K >= N, the limit of 8192
   points, and 8193 on its cluster design ``fps_large``; integer grids,
   every point twice, planted copies);
   ``knn`` at VRCNet's shapes, FGR's (k 16 and 17), vrcnet_knn's ten, the
   learned registration models' three ((32, 2048)², k 12, 20, 21), DCP's
   on cfgs/modelnet.yaml ((32, 1024)², k 20) and ECG's (the
   poolings, the three-NN, the uniform losses' thousands of tiny clouds
   with repeated points) and at the edges of its design (fewer queries
   than a warp, sizes off its blocks, tiles and batches, N == k, every
   bucket edge of k on integer grids, refs in parts, packed clouds at and
   beside the threshold, planted copies, all points equal: exact indices)
   and ``knn_wide`` at the four self-kNN shapes of
   ECG's DenseConv, EFExpansion's two shapes, FGR's mutual search (33
   bins, k 1, both ways), ragged cases in every k
   bucket, the edges of its design (compiled widths and their neighbours,
   bucket and queue edges of k, split refs, unaligned rows) and duplicated
   rows across lanes, warps, blocks and parts (exact indices); the auction
   ``emd`` (the assignment index for index, distances bit for bit, rounds
   and bids equal: train and eval settings, a permuted copy, the eval
   batch and the train shapes, repeated points, a grid, B 1 and 160,
   every cluster size, one item, the size limit, one point past it on the
   cluster design ``emd_large``, which is also forced at K7's sizes with
   every cluster size; ``phase_emd``, and on the paths' own clouds in
   ``phase_kernels``); ``scatter`` (bit
   for bit, at the kernel's edges too: order-sensitive sums, -0.0, one row
   of 65536, 200,000 rows, 70,000 batch entries; and against the dense
   one-hot product; and spconv.yaml's voxel targets, (8, 2048) rows of
   4 channels onto 125,000 voxels) and ``gather_rows`` (bit for bit,
   out-of-range indices
   and 70,000 batch entries included); the chamfer gradient against
   autograd through the gathered form;
3. the registration path: the port's ``test_main`` on
   ``cfgs/houv_fast.yaml`` at full width over a 16-pair synthetic split,
   then on ``cfgs/houv.yaml`` over 4 pairs, with each kernel's launch count
   on that run; then both configs over 100 pairs, their own batch size, for
   throughput, and houv_fast on a 16-pair split rotated up to 90°, which
   runs the retries; then registration's quality modes at full width over
   8 pairs (``phase_quality``): ``cfgs/houv_quality.yaml`` (the view loss,
   its K1 launches held to 4 a step), ``cfgs/houv_rescore.yaml`` and
   ``cfgs/houv_extratest_rescore.yaml`` (the trained classifier of
   ``log/``, no sparse-conv site dropped), the rescoring's card logits
   against the port's CPU path on the same overlays (5e-2, equal picks at
   margin 3), and ``houv_eval_main`` through ``train -c`` with its meters
   by bucket; then the classical baselines through ``train -c``
   (``phase_classical``: cfgs/fgr.yaml, cfgs/goicp_bnb.yaml, and icp and
   goicp on fgr.yaml's settings, over 32 structured pairs at full width,
   each run's launches held to ``classical_launches``, the card beside the
   port's CPU path, K6 and K6-wide index for index on FGR's own clouds and
   features, goicp_bnb's field and cube bounds and its planted 60° case on
   the card) and the shard combine (``phase_combine``: houv_fast at batch
   16 on 48 pairs, shards [0, 16) and [32, 48), ``--combine`` solving
   [16, 32), held bit for bit to the unsharded sweep);
4. VRCNet on the card against the port's CPU path at the parity tests'
   size; then the completion path of ``cfgs/vrcnet.yaml``, ``cfgs/pcn.yaml``
   and ``cfgs/ecg.yaml`` at full width: ``test_main`` over a 64-cloud
   synthetic test split and ``validate`` with ``eval_emd`` over a 64-cloud
   val split, each with its launch counts held against the counts derived
   from the code (``LAUNCHES``), then over 512 and 128 clouds for
   throughput; and ``test_main`` on ``cfgs/vrcnet.yaml`` with ``num_points:
   4096, num_input: 2048`` and no local folding, which runs both of
   VRCNet's ``EFExpansion``s;
5. training: one VRCNet and one ECG train step at the parity tests' size on
   the card against the port's CPU path in f64 on the same picks; then for
   each of the three configs at full width ``train_main`` (batch 32, two
   epochs of four steps on the synthetic split, ``validate`` and a
   checkpoint after each) with the launch counts of the run held against
   ``LAUNCHES``, the checkpoint read back to bit-equal predictions by a
   trainer and by ``test_main`` with ``load_model``, and 10 steps on one
   repeated batch (the loss must fall); for VRCNet also ``use_remat`` and
   ``loss: emd``, for ECG ``loss: emd``; then vrcnet_knn
   (``phase_vrcnet_knn``, cfgs/vrcnet_knn.yaml: batch 16, bf16, the hybrid
   sparse/dense voxel branch with BatchNorm in train mode): the card
   against the port's CPU path at the parity tests' size in f32 and bf16
   (test cloud, val metrics, a train step's loss and running statistics),
   ``train_main`` at full width (two epochs of four steps, launches held,
   checkpoint reloads bit-equal), 10 steps on one batch with the sites
   kept and dropped at each strided sparse conv and the 13³ occupancy, a
   ``fused_cd`` loss equal to the separate chamfers', the sweep of
   cfgs/vrcnet_knn_extratest.yaml over 512 clouds, and one profiled train
   step; then the learned models (``phase_learned``): the card against the
   port's CPU path at the parity tests' size for DCP, DeepGMR and IDAM
   (transforms, a train forward's loss and running statistics) and the
   trained transformer of ``log/transformer_cd_debug/`` on 4 clouds at full
   width; cfgs/dcp.yaml, deepgmr.yaml and idam.yaml at full width (batch
   32, 2048 points) through ``train_main`` (8 steps, the five ``best_*``
   checkpoints) and ``test_main`` with ``load_model`` over 64 pairs, then
   10 steps on one batch (the loss must fall; steps/s, pairs/s, peak
   memory); cfgs/transformer.yaml on the trained checkpoint through the
   sweep over 512 clouds and ``validate`` with eval_emd (the auction's
   rounds), ``train_main`` and 10 steps; one profiled train step of each
   registration model, its forward's parts timed; then the aux models and
   ModelNet (``phase_aux``, each run's work_dir a temporary directory):
   cfgs/embedding.yaml (batch 32, 2048 points), cfgs/alignment.yaml (f32,
   16 rows a step), cfgs/rescore_alignment.yaml (bf16, its split cut from
   512 pairs to 64) and cfgs/spconv.yaml (VoxAsym, batch 8, grid 50)
   through ``train_main`` (``nepoch`` 100 -> 2), the embedding's and
   VoxAsym's 10 steps on one batch (the loss must fall), the trained
   checkpoints of ``log/`` through ``test_main`` (their val meters; the
   classifier's dropped sites, 0) and on the card against the CPU path
   (VoxAsym's voxel targets, on K4, bit for bit); cfgs/modelnet.yaml
   (DCP, 1024 points, batch 32) through ``train_main`` and the sweep over
   64 pairs, variants clean and noisy, K6 held to 2 a forward; the SHA-256
   of every checkpoint under ``log/`` unchanged by the phase; then
   ``compute_dtype: bfloat16`` (``phase_bf16``) for pcn, ecg, vrcnet, the
   transformer (from its trained checkpoint), dcp, deepgmr, idam, the
   instance embedding and VoxAsym at their yamls' full width:
   ``train_main`` (64 train and 64 val items, two epochs), ``test_main``
   with its checkpoint, 10 bf16 steps on one batch (the loss must fall,
   launches as in f32) beside 10 f32 steps on the same batch (steps/s,
   peak memory), ECG's bf16 kNN picks held to the plain version index for
   index, and each model at the parity tests' size on the card against
   the CPU path within 5e-3 (the CPU run's picks handed to the card's);
   then the cascade-GAN trainer (``phase_gan``): cfgs/vrcnet.yaml with
   ``use_gan`` at full width through ``train_main`` (8 GAN steps, the
   critic in the checkpoint, the reloads bit-equal), 10 GAN steps on one
   batch (the recon loss must fall, the critic's stay finite; launches a
   step those of a plain step) and one GAN step at the parity size on the
   card against the CPU path in f64 (the generator's and the critic's
   gradients to 1e-3 of each tensor's largest entry);
   then torch.distributed (``phase_parallel``): NCCL over every visible card
   (at most 4; world size 1 on a one-card machine, where the mesh still
   holds the world group, so the collectives run through NCCL) with its
   all_reduce, broadcast and exact row gather (``dist.all_gather``) and
   the 100-pair houv_fast batch through ``sharded_houv_solve``; two ranks
   sharing card 0 over gloo: houv_fast
   at 100 pairs and houv_rescore at 8 through ``test_main``, the (data 1 x
   restart 2) split of houv.yaml's 4 pairs, each bit for bit against the
   one-process rows of phases 3's ``main_path`` and ``quality`` (picks,
   ``n_override`` and ``n_retry`` equal), and DDP steps of vrcnet.yaml
   (as the yaml has it, KLD, and again with distribution_loss MMD) and
   deepgmr.yaml (batch 32, 16 a rank, 2 steps) against one process (the
   replicas bit-equal; the first gradient against one process on the whole
   batch under ``DDP_GRAD_BOUND``, which a planted fault, one process on
   rank 0's rows alone, must exceed; VRCNet's KLD gradient to 1e-5 of the
   ranks' work redone in one process; VRCNet's MMD run, its latent path's
   gradient under ``DDP_MMD_LATENT_BOUND``, which the planted fault, each
   rank's MMD over its own rows, must exceed; DeepGMR's running
   statistics after a step: the global batch's BatchNorm); the CLI on the
   visible cards, and on
   one more, which takes the cards there are (rows bit-equal); pairs/s, steps/s and each rank's peak memory beside one
   process's (every other phase runs in this one process: the script sets
   torchrun's ``WORLD_SIZE=1`` for them);
6. short ``houv_solve`` runs of ``cfgs/houv.yaml`` (4 pairs, 100 steps):
   ``grad_mode='scatter'`` beside the gather mode, and ``nn_select=True``
   beside the default (with a profiled window of 5 steps of each at 16
   pairs: K3 one kernel a step, no memset, no unpack pass), then the
   exported row gather on that solve's matches; then the solver's
   ablations (``phase_ablations``, ``ABLATIONS``: each reparam,
   ``two_bracket``, ``euler``, ``multi_percent``, ``select_percent=1.0``,
   ``consensus``, ``voxel_downsample: 50`` and scripts/quality_gate.py's
   ``v3`` bundle), one solve each, K1 and K4 launches held to the code's,
   ``voxel_downsample``'s K4 sums bit for bit against the plain version;
   then clouds above the kernels' limits (``phase_large_clouds``: K2's
   cluster design ``csrc/fps_large.cu`` at (4, 16384) and (4, 8193) ->
   2048, sizes off its blocks, K == N, an integer grid, every point twice,
   its capacity of 65536 points and every cluster size its plan picks,
   forced; one point past the capacity on ``csrc/fps_global.cu``; K7's
   cluster design ``csrc/emd_large.cu`` at (2, 8192)², (2, 16384)² and
   N != M, a pair one item past its capacity on ``csrc/emd_global.cu``;
   each against its plain version, then timed, the global designs past
   the capacities after one call through the public entry point there; 3
   train steps of cfgs/vrcnet.yaml at num_points 16384, batch 8, and
   ``validate`` with eval_emd at 8192, with launches by route);
   the MVPN preprocessing (``phase_preprocess``: ``combine_dataset`` on
   1024 synthetic scans of 2048 points in modes f1 and embedding, the F1
   sweep's pairs/s, the card's F1 against the plain arithmetic and the
   CPU path); the native loader (``phase_native``: ``train_main`` on
   cfgs/deepgmr.yaml with ``use_native_loader``, steps/s beside the
   in-memory feed, and ``profile_dir``'s trace);
7. torch.profiler breakdowns of one houv_fast angle window (16 pairs), of
   one houv_rescore window (8 pairs: the pool solve, then the scoring by
   the trained classifier; both windows the device's activity only, cut
   to a quarter of their depth, ``PROFILE_WINDOW``), of
   one VRCNet test batch (32 clouds) and of
   one VRCNet, one ECG and one vrcnet_knn train step; K2's census,
   (B, N, K) at its every launch in that window and those steps, each of
   them one of ``FPS_SHAPES``;
8. a ``kernels`` line: each of the eight kernels' time (and K2's and K7's
   designs past their limits, ``fps_large``, ``fps_global``, ``emd_large``
   and ``emd_global``, at theirs) at its main-path
   shape beside its plain version, its bound on the card and a PyTorch
   library yardstick, with its launches on the paths above (and on the
   classical and combine runs, ``classical_launches``, on the
   vrcnet_knn runs, ``vrcnet_knn_launches``, on the learned models'
   runs, ``learned_launches``, and on the aux runs, ``aux_launches``;
   ``scatter_add`` also at the voxel targets' shape, ``at_voxel_targets``);
   ``nn_both`` at its twelve
   path shapes, ``nn_select`` at the solver's two (with K1 and its two
   gathers on the same inputs beside it), ``fps`` at its 22 (the
   transformer's (32, 2048) -> 256 among them), ``knn`` at its 46 (the
   learned registration models' (32, 2048)² at k 12, 20 and 21 and
   ModelNet's (32, 1024)² at k 20 among them) and ``knn_wide`` at its seven, each but ``fps`` with
   the floor of its
   contract (K2's latency floor: ``scripts/time_fps_variants.py``), and
   ``emd`` on its paths' own clouds (``EMD_SHAPES``: validate's first
   batch, the ``loss: emd`` steps' auctions) with its plan and the floor
   of its instructions at the plan's SMs (its latency floor:
   ``scripts/time_emd_variants.py``).

The last line is {"ok": true, "device": {...}}. Needs CUDA and a checkout of
the repository around this file; imports nothing of JAX.
"""

from __future__ import annotations

import itertools
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
    """Mean milliseconds of fn() on the current stream (CUDA events). The
    card first spins for ~10 ms, so that the host has queued the launches
    before the start event: a call shorter than its host overhead is timed
    on the device, not at the host's enqueue rate. (A fn that synchronises
    inside is timed with its host gaps.)"""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
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


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def phase_build():
    card = card_line()
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
    """Kernel vs plain: indices equal, index for index (both round each
    distance op by op); the recomputed distances to 1e-6 relative."""
    from houv_tpu_torch.ops import chamfer

    ki1, ki2 = chamfer.chamfer_indices(a, b)
    pi1, pi2 = chamfer._nn_both_plain(a, b)
    torch.cuda.synchronize()
    a_rows = a.repeat_interleave(b.shape[0] // a.shape[0], dim=0)
    kd1, kd2 = _nn_dists(a_rows, b, ki1, ki2)
    pd1, pd2 = _nn_dists(a_rows, b, pi1, pi2)
    # a NaN point's own distances are NaN on both sides: not compared
    rel = max(
        float(((kd1 - pd1).abs() / pd1.clamp_min(1e-12)).nan_to_num(0.0)
              .max()),
        float(((kd2 - pd2).abs() / pd2.clamp_min(1e-12)).nan_to_num(0.0)
              .max()))
    mism = int((ki1 != pi1).sum()) + int((ki2 != pi2).sum())
    err = max(float((kd1 - pd1).abs().nan_to_num(0.0).max()),
              float((kd2 - pd2).abs().nan_to_num(0.0).max()))
    emit({"phase": "nn_both_check", "case": name,
          "a": list(a.shape), "b": list(b.shape), "index_mismatches": mism,
          "max_rel_dist_err": rel, "max_abs_dist_err": err,
          "tolerance_rel": 1e-6})
    if mism or rel > 1e-6:
        fail(f"nn_both {name}: {mism} indices differ, distances "
             f"{rel:.3g} relative")
    return err


def planted_copies(x, offsets, gen):
    """x (B, P, 3) with exact copies planted: for each offset o, a few rows
    i get x[:, i + o] = x[:, i], so that a point and its copy lie in
    different threads, warps, tiles or blocks of the kernel."""
    x = x.clone()
    p = x.shape[1]
    for k, o in enumerate(offsets):
        if o >= p:
            continue
        src = torch.randperm(p - o, generator=gen)[:4 + k]
        x[:, src + o] = x[:, src]
    return x


# K1's edges, (Bq, share, N, M): tiles of 128 and their float4 halves of 64;
# blocks of 128 split queries (few rows) against whole rows (528 rows fill
# 132 SMs 4 times over); 3072 references a block
NN_EDGES = ((2, 1, 127, 129), (2, 1, 129, 127), (2, 1, 63, 65),
            (2, 1, 65, 64), (2, 1, 255, 300), (2, 1, 257, 385),
            (8, 66, 2047, 2049), (8, 66, 2049, 2047), (8, 66, 129, 3073),
            (1, 1, 300, 3071), (1, 1, 300, 3073), (1, 1, 129, 6145),
            (3, 1, 1, 700))
# offsets of the planted copies: the next query, thread row (8), tile (128),
# block of split queries (128 too) or of a whole row (2048); the next ref,
# lane (4), float4 half (64), tile (128), block of refs (3072)
NN_QUERY_COPIES = (1, 8, 64, 128, 256, 2048)
NN_REF_COPIES = (1, 4, 64, 128, 2048, 3072)


def phase_nn(gen):
    dev = "cuda"
    a = torch.rand((2, 2048, 3), generator=gen).to(dev) - 0.5
    b = (a.repeat_interleave(64, 0)
         + 0.05 * torch.randn((128, 2048, 3), generator=gen).to(dev))
    err = check_nn(a, b, "shared_B2_K64_N2048_M2048")
    # houv.yaml's step: 100 pairs x 64 restarts in one call
    a = torch.rand((100, 2048, 3), generator=gen).to(dev) - 0.5
    b = (a.repeat_interleave(64, 0)
         + 0.05 * torch.randn((6400, 2048, 3), generator=gen).to(dev))
    err = max(err, check_nn(a, b, "houv_B100_K64_N2048_M2048"))
    del a, b
    # the train step's four calc_cd terms: 64 rows of 2048 gt points against
    # coarse_raw (1024), coarse_high (3072) and coarse and fine (2048)
    gt = torch.rand((64, 2048, 3), generator=gen).to(dev) - 0.5
    for m in (1024, 3072, 2048):
        out = torch.rand((64, m, 3), generator=gen).to(dev) - 0.5
        err = max(err, check_nn(gt, out, f"train_B64_N2048_M{m}"))
    # PCN's and ECG's two: 32 rows of gt against coarse (1024) and fine
    gt = gt[:32].contiguous()
    for m in (1024, 2048):
        out = torch.rand((32, m, 3), generator=gen).to(dev) - 0.5
        err = max(err, check_nn(gt, out, f"train_B32_N2048_M{m}"))
    for m in (1, 3, 257):
        out = torch.rand((4, m, 3), generator=gen).to(dev) - 0.5
        err = max(err, check_nn(gt[:4].contiguous(), out,
                                f"share1_B4_N2048_M{m}"))
    del gt, out
    # the classical solvers' searches: ICP at fgr.yaml's batch of 16 and the
    # grid Go-ICP's chunks of 5 rotations of it, (80, 2048)², unshared
    for rows, path in ((16, "icp"), (80, "goicp")):
        a = torch.rand((rows, 2048, 3), generator=gen).to(dev) - 0.5
        b = torch.rand((rows, 2048, 3), generator=gen).to(dev) - 0.5
        err = max(err, check_nn(a, b, f"{path}_B{rows}_N2048_M2048"))
    # vrcnet_knn's train step: 16 rows of 2048 gt points against coarse
    # (1024), fine (3072) and native (2048); with fused_cd one search of the
    # three stacked, coarse and native padded to 3072 with 1e3 sentinels
    gt = torch.rand((16, 2048, 3), generator=gen).to(dev) - 0.5
    outs = [torch.rand((16, m, 3), generator=gen).to(dev) - 0.5
            for m in (1024, 3072, 2048)]
    for out in outs:
        err = max(err, check_nn(gt, out,
                                f"vrcnet_knn_B16_N2048_M{out.shape[1]}"))
    stacked = torch.cat([torch.cat([o, o.new_full(
        (16, 3072 - o.shape[1], 3), 1e3)], 1) for o in outs], 0)
    err = max(err, check_nn(gt.repeat(3, 1, 1), stacked,
                            "vrcnet_knn_fused_B48_N2048_M3072"))
    del gt, outs, stacked
    a = torch.randn((1, 2047, 3), generator=gen).to(dev)
    b = torch.randn((1, 1500, 3), generator=gen).to(dev)
    err = max(err, check_nn(a, b, "ragged_N2047_M1500"))
    for bq, share, n, m in NN_EDGES:
        a = torch.randn((bq, n, 3), generator=gen)
        b = torch.randn((bq * share, m, 3), generator=gen)
        name = f"edge_B{bq}_K{share}_N{n}_M{m}"
        err = max(err, check_nn(a.to(dev), b.to(dev), name))
        a = planted_copies(a, NN_QUERY_COPIES, gen)
        b = planted_copies(b, NN_REF_COPIES, gen)
        err = max(err, check_nn(a.to(dev), b.to(dev), f"{name}_copies"))
    # integer coordinates: most distances tie with many others
    a = torch.randint(0, 4, (2, 700, 3), generator=gen).float()
    b = torch.randint(0, 4, (6, 900, 3), generator=gen).float()
    err = max(err, check_nn(a.to(dev), b.to(dev), "grid_B2_K3_N700_M900"))
    a = torch.randint(0, 6, (8, 1100, 3), generator=gen).float()
    b = torch.randint(0, 6, (528, 1300, 3), generator=gen).float()
    err = max(err, check_nn(a.to(dev), b.to(dev), "grid_B8_K66_N1100_M1300"))
    # one NaN point in a finite query and in a finite reference cloud (no
    # distance picks it), and an all-NaN cloud (index 0), at a whole plan,
    # with the columns split and with the rows split
    for bq, share, n, m in ((8, 66, 300, 400), (4, 8, 600, 700),
                            (33, 8, 300, 3100)):
        a = torch.randn((bq, n, 3), generator=gen)
        b = torch.randn((bq * share, m, 3), generator=gen)
        a[1, n // 3, 1] = float("nan")
        b[0, m // 2, 0] = float("nan")
        b[2] = float("nan")
        err = max(err, check_nn(a.to(dev), b.to(dev),
                                f"nan_point_B{bq}_K{share}_N{n}_M{m}"))
    return err


# K2 on its paths, (B, N, K, path): a houv_fast window's N/4 and N/2
# phases of both clouds (16 pairs; 100 at the yaml's batch), combine's
# merge of two clouds, VRCNet's train step (the gt's full permutation; the
# decoder's pyramid and its trim of coarse_high, on the concatenated batch
# of 64) and ECG's (the encoder's hierarchy, the trim of fine, and the
# seeds of get_uniform_loss, 5% of the fine and of the coarse cloud, five
# times each); goicp_bnb's subsample of the source, 256 of 2048 at its
# yaml's batch of 8; vrcnet_knn's forward at its batch of 16 (the U-Net's
# pyramid over coarse + input, and fine 3072 -> native 2048).
# ``fps_census`` records them from the paths themselves.
FPS_SHAPES = ((16, 2048, 512, "houv_fast"), (16, 2048, 1024, "houv_fast"),
              (100, 2048, 512, "houv_fast"), (100, 2048, 1024, "houv_fast"),
              (16, 4096, 2048, "combine"),
              (32, 2048, 2048, "vrcnet"), (64, 3072, 1536, "vrcnet"),
              (64, 1536, 768, "vrcnet"), (64, 768, 384, "vrcnet"),
              (64, 3072, 2048, "vrcnet"),
              (32, 3072, 1024, "ecg"), (32, 1024, 256, "ecg"),
              (32, 256, 64, "ecg"), (32, 3072, 2048, "ecg"),
              (32, 2048, 102, "ecg"), (32, 1024, 51, "ecg"),
              (8, 2048, 256, "goicp_bnb"),
              (16, 3072, 1536, "vrcnet_knn"), (16, 1536, 768, "vrcnet_knn"),
              (16, 768, 384, "vrcnet_knn"), (16, 3072, 2048, "vrcnet_knn"),
              (32, 2048, 256, "transformer"))
# the edges of K2's plan (N at and beside the sizes where its block or its
# points a thread change, one point, a warp, the limit; K == 1 and K >= N)
# on random clouds: (B, N, K)
FPS_EDGES = tuple(
    [(2, 1, 1), (2, 1, 3), (3, 31, 31), (3, 32, 40), (3, 33, 33),
     (4, 2048, 1), (1, 2048, 1024), (2, 8192, 8192), (1, 8192, 300)]
    + [(2, n, min(n, 300)) for base in (64, 128, 256, 512, 768, 1024, 1536,
                                        2048, 3072, 4096)
       for n in (base - 1, base, base + 1)]
    + [(2, n, n) for n in (127, 255, 257, 513, 769, 1025)])


def check_fps(pts, k, name):
    """The kernel's picks against the plain version's, index for index."""
    from houv_tpu_torch.ops import sampling

    ki = sampling.furthest_point_sample(pts, k)
    pi = sampling._fps_plain(pts, k)
    mism = int((ki != pi).sum())
    emit({"phase": "fps_check", "case": name, "points": list(pts.shape[:2]),
          "k": k, "index_mismatches": mism})
    if mism:
        fail(f"fps {name} ({pts.shape[0]}, {pts.shape[1]}) -> {k}: {mism} "
             "indices differ")
    return float((ki - pi).abs().max())


def phase_fps(gen):
    """K2 against its plain version at every path shape, the plan's edges,
    integer grids (ties everywhere), every point twice and planted copies;
    and the limit: 8193 points go to the cluster design
    (``csrc/fps_large.cu``), not to K2."""
    from houv_tpu_torch.ops import sampling

    err = 0.0
    for b, n, k, path in FPS_SHAPES:
        err = max(err, check_fps(torch.randn((b, n, 3), generator=gen)
                                 .cuda(), k, path))
    for b, n, k in FPS_EDGES:
        err = max(err, check_fps(torch.randn((b, n, 3), generator=gen)
                                 .cuda(), k, "edge"))
    for b, n, k, c in ((4, 700, 700, 4), (3, 2048, 1024, 6),
                       (1, 8192, 2048, 8), (64, 256, 256, 3)):
        grid = torch.randint(0, c, (b, n, 3), generator=gen).float()
        err = max(err, check_fps(grid.cuda(), k, "integer_grid"))
    for b, n in ((2, 2048), (1, 8192)):
        twice = torch.randn((b, n, 3), generator=gen)
        twice[:, n // 2:] = twice[:, :n // 2]
        err = max(err, check_fps(twice.cuda(), n, "every_point_twice"))
    copies = planted_copies(torch.randn((8, 3072, 3), generator=gen),
                            (1, 32, 256, 512, 1024, 2048), gen)
    err = max(err, check_fps(copies.cuda(), 2048, "planted_copies"))
    # one point above the limit goes to csrc/fps_large.cu, not to K2
    fps = sampling.furthest_point_sample
    before = (fps.launches, fps.large_launches)
    err = max(err, check_fps(torch.randn((1, 8193, 3), generator=gen)
                             .cuda(), 4, "above_the_limit"))
    routed = (fps.launches - before[0], fps.large_launches - before[1])
    emit({"phase": "fps_check", "case": "limit", "points": [1, 8193],
          "launches_fps_and_fps_large": list(routed)})
    if routed != (0, 1):
        fail(f"fps at 8193 points launched (fps, fps_large) {routed}, "
             "expected (0, 1)")
    return err


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
    query 1536 x 3072 at k 10, three_nn 3072 x 1536; a ragged case; FGR's
    self-kNN at k 16 and 17; vrcnet_knn's ten (batch 16), the learned
    models' three and DCP's on cfgs/modelnet.yaml ((32, 1024)², k 20);
    then ECG's shapes."""
    b, n = 32, 3072
    pts = torch.rand((b, n, 3), generator=gen).cuda() - 0.5
    half = pts[:, ::2].contiguous()
    err = check_knn(pts, pts, 20, "self_B32_N3072_k20")
    err = max(err, check_knn(half, pts, 10, "pk_B32_M1536_N3072_k10"))
    err = max(err, check_knn(pts, half, 3, "three_nn_B32_M3072_N1536_k3"))
    q = torch.randn((2, 3071, 3), generator=gen).cuda()
    r = torch.randn((2, 1499, 3), generator=gen).cuda()
    err = max(err, check_knn(q, r, 17, "ragged_M3071_N1499_k17"))
    # FGR's self-kNN at fgr.yaml's batch of 16: k 16 for the normals and
    # k 17 for FPFH, one past the two-queries-a-thread bucket
    x = pts[:16, :2048].contiguous()
    for k in (16, 17):
        err = max(err, check_knn(x, x, k, f"fgr_B16_N2048_k{k}"))
    # vrcnet_knn's 10 searches a forward, at its batch of 16, and the
    # learned registration models' self-kNN at batch 32
    for b_, m, n_, k, _ in KNN_SHAPES:
        if _ in ("vrcnet_knn", "dcp", "deepgmr", "idam", "modelnet"):
            err = max(err, check_knn(pts[:b_, :m].contiguous(),
                                     pts[:b_, :n_].contiguous(), k,
                                     f"{_}_B{b_}_M{m}_N{n_}_k{k}"))
    del half, q, r
    err = max(err, _phase_knn_edges(gen))
    return max(err, _phase_knn_ecg(pts, gen))


# csrc/knn.cu's edges, (B, M, N, k): fewer queries than a warp, queries and
# refs off the blocks (128 and 256 queries), tiles (256 refs) and batches
# (8 refs), N == k, every bucket edge of k, refs in parts with a short last
# one, and packed clouds at and beside the packing threshold (M < 64,
# N <= 256)
KNN_EDGES = ((3, 5, 700, 5), (2, 31, 3000, 20), (2, 33, 257, 10),
             (2, 129, 255, 3), (2, 257, 513, 16), (1, 1025, 3, 3),
             (4, 300, 20, 20), (2, 100, 64, 64), (1, 700, 1, 1),
             (3, 384, 385, 20), (5, 200, 1000, 33), (1, 130, 3001, 64),
             (700, 63, 256, 8), (700, 64, 256, 8), (600, 63, 257, 4),
             (4000, 7, 7, 7), (3264, 24, 24, 2), (1632, 4, 4, 2))
KNN_BUCKETS = (1, 4, 5, 8, 9, 16, 17, 24, 25, 32, 33, 64)
# offsets of the planted copies: the next lane, warp, block, tile, part
KNN_COPIES = (1, 32, 128, 256, 300, 1024)


def _phase_knn_edges(gen):
    """The kernel's edges (``KNN_EDGES``) on random clouds and with planted
    copies; every bucket edge of k on an integer grid (ties everywhere),
    with one part and with refs in parts; every point equal; clouds of
    repeated rows, as get_uniform_loss's balls, packed and not."""
    err = 0.0
    for b, m, n, k in KNN_EDGES:
        x = torch.rand((b, max(m, n), 3), generator=gen) - 0.5
        for tag, y in (("rand", x),
                       ("copies", planted_copies(x, KNN_COPIES, gen))):
            q, r = y[:, :m].cuda(), y[:, :n].cuda()
            err = max(err, check_knn(q, r, k,
                                     f"edge_{tag}_B{b}_M{m}_N{n}_k{k}"))
    for k in KNN_BUCKETS:
        for b, m in ((32, 700), (2, 700)):    # refs whole, refs in parts
            g = torch.randint(0, 4, (b, m, 3), generator=gen).float().cuda()
            err = max(err, check_knn(g, g, k, f"grid_B{b}_N{m}_k{k}"))
    same = torch.full((4, 300, 3), 0.25).cuda()
    for k in (1, 20, 64):
        err = max(err, check_knn(same, same, k, f"all_equal_N300_k{k}"))
    for clouds, n in ((3264, 24), (1632, 12), (40, 300)):
        g = torch.rand((clouds, n, 3), generator=gen) - 0.5
        hits = torch.randint(1, n + 1, (clouds,), generator=gen)
        g = torch.where(torch.arange(n)[None, :, None] < hits[:, None, None],
                        g, g[:, :1]).cuda()
        err = max(err, check_knn(g, g, 2, f"repeated_B{clouds}_N{n}_k2"))
    return err


def _uniform_loss_groups(pcd, p):
    """The ball neighbourhoods ``get_uniform_loss`` hands to the kNN for the
    percentage ``p``: (B, N, 3) -> (B x 5% of N, max(N p, 2), 3). A ball
    with fewer points than slots repeats its first hit, so rows are
    duplicated."""
    import math

    from houv_tpu_torch.ops import grouping, sampling
    from houv_tpu_torch.ops.gather import gather_rows

    b, n, _ = pcd.shape
    npoint, nsample = max(int(n * 0.05), 1), max(int(n * p), 2)
    saved = sampling.furthest_point_sample.launches
    seeds = gather_rows(pcd, sampling.furthest_point_sample(pcd, npoint))
    sampling.furthest_point_sample.launches = saved
    idx = grouping.ball_query(0.0, math.sqrt(p), nsample, pcd, seeds)
    return gather_rows(pcd, idx.reshape(b, -1)).reshape(b * npoint, nsample, 3)


def _phase_knn_ecg(pts, gen):
    """ECG's shapes on cfgs/ecg.yaml (batch 32): the three poolings of
    ``edge_preserve_sampling`` (each level's picks against the level, k 16),
    the three ``three_nn`` on the way up (k 3), and the uniform losses'
    thousands of tiny clouds with repeated points (k 2) for the fine (2048)
    and the coarse (1024) cloud at all five percentages."""
    err = 0.0
    levels = [pts]
    for n in (1024, 256, 64):
        pick = torch.randperm(levels[-1].shape[1], generator=gen)[:n].cuda()
        levels.append(levels[-1][:, pick].contiguous())
    for fine, coarse in zip(levels, levels[1:]):
        m, n = coarse.shape[1], fine.shape[1]
        err = max(err, check_knn(coarse, fine, 16, f"pool_B32_M{m}_N{n}_k16"))
        err = max(err, check_knn(fine, coarse, 3,
                                 f"three_nn_B32_M{n}_N{m}_k3"))
    for n in (2048, 1024):
        pcd = pts[:, :n].contiguous()
        for p in (0.004, 0.006, 0.008, 0.010, 0.012):
            g = _uniform_loss_groups(pcd, p)
            dup = int((g[:, 1:] == g[:, :1]).all(-1).sum())
            emit({"phase": "knn_check", "case": "uniform_loss_groups",
                  "cloud": n, "percentage": p, "groups": list(g.shape),
                  "rows_repeating_the_first": dup})
            err = max(err, check_knn(
                g, g, 2, f"uniform_B{g.shape[0]}_N{g.shape[1]}_k2"))
    return err


# K7 on its paths, (B, N, M, eps, iters, path): validate's first batch with
# eval_emd, and the auctions of a ``loss: emd`` train step: VRCNet's four
# (coarse_raw, coarse_high, coarse and fine against the gt, its two
# branches concatenated: 64 clouds) and ECG's (and PCN's) two (coarse and
# fine, 32 clouds)
EMD_SHAPES = ((32, 2048, 2048, 0.004, 3000, "validate"),
              (64, 1024, 2048, 0.005, 50, "vrcnet coarse_raw"),
              (64, 3072, 2048, 0.005, 50, "vrcnet coarse_high"),
              (64, 2048, 2048, 0.005, 50, "vrcnet coarse"),
              (64, 2048, 2048, 0.005, 50, "vrcnet fine"),
              (32, 1024, 2048, 0.005, 50, "ecg coarse"),
              (32, 2048, 2048, 0.005, 50, "ecg fine"))


def emd_route(n, m):
    """Which kernel takes pairs of n bidders and m items: "emd" (K7), past
    one block's shared memory "emd_large" (a cluster's), past that
    "emd_global"."""
    from houv_tpu_torch.kernels import load
    from houv_tpu_torch.ops import emd

    lib = load()
    return emd._emd_route(lib.houv_emd_smem_bytes(n, m),
                          lib.houv_emd_large_smem_bytes(n, m, 8),
                          lib.houv_emd_max_smem_bytes())


def emd_plan(b, n, m, design=None):
    """Blocks a pair on this card for ``design`` (by default the route of
    n and m): K7's (``ops/emd.py:_emd_plan``), the large design's
    (``_emd_large_plan``) or the global design's (``_emd_global_plan``)."""
    from houv_tpu_torch.ops import emd

    design = design or emd_route(n, m)
    if design == "emd_large":
        return emd._large_card_plan(b, n, m, torch.device("cuda"))
    if design == "emd_global":
        return emd._emd_global_plan(b, emd._max_global_clusters(0))
    return emd._card_plan(b, n, m, torch.device("cuda"))


def _emd_counts():
    from houv_tpu_torch.ops import emd

    run = emd.emd_auction_with_stats
    return [run.launches, run.large_launches, run.global_launches]


def _set_emd_counts(counts):
    from houv_tpu_torch.ops import emd

    run = emd.emd_auction_with_stats
    run.launches, run.large_launches, run.global_launches = counts


def check_emd(a, b, eps, iters, name, clusters=(None,), design=None):
    """K7 (or, past its shared memory, the design its route names, or
    ``design`` forced: "emd_large", "emd_global") against its plain
    version on the same inputs: at its plan (``None``) and at each forced
    number of blocks a pair in ``clusters``, the assignment index for
    index, dist bit for bit and each pair's rounds and bids equal, or the
    run fails. Returns the largest distance error (0)."""
    from houv_tpu_torch.ops import emd

    pd, pa, pr, pb = emd._auction_plain(a, b, eps, iters)
    err = 0.0
    launch = {"emd_large": emd._emd_large_cuda,
              "emd_global": emd._emd_global_cuda}.get(design, emd._emd_cuda)
    route = design or emd_route(a.shape[1], b.shape[1])
    for c in clusters:
        saved = _emd_counts()
        kd, ka, kr, kb = launch(a, b, eps, iters, c)
        _set_emd_counts(saved)
        torch.cuda.synchronize()
        rec = {"phase": "emd_check", "case": name, "shape": list(a.shape),
               "items": b.shape[1], "eps": eps, "iters": iters,
               "route": route,
               "plan": emd_plan(a.shape[0], a.shape[1], b.shape[1], route),
               "clusters": c,
               "assignment_mismatches": int((ka != pa).sum()),
               "dist_bit_mismatches": int(
                   (kd.view(torch.int32) != pd.view(torch.int32)).sum()),
               "rounds_equal": bool((kr == pr).all()),
               "bids_equal": bool((kb == pb).all()),
               "rounds_max": int(pr.max()), "bids": int(pb.sum()),
               "mean_dist": float(kd.mean())}
        emit(rec)
        err = max(err, float((kd - pd).abs().max()))
        if rec["assignment_mismatches"] or rec["dist_bit_mismatches"] \
                or not (rec["rounds_equal"] and rec["bids_equal"]):
            fail(f"emd {name} (blocks a pair {c or rec['plan']}): "
                 f"{rec['assignment_mismatches']} assignments and "
                 f"{rec['dist_bit_mismatches']} distances differ, rounds "
                 f"equal {rec['rounds_equal']}, bids equal "
                 f"{rec['bids_equal']}")
        if name == "permuted_copy" and float(kd.max()) != 0.0:
            fail(f"emd of a permuted copy is {float(kd.max())}, not 0")
    return err


def phase_emd(gen):
    """K7 against its plain version (``check_emd``: every assignment, every
    distance's bits, rounds and bids): (4, 2048) at the train and eval
    settings and a permuted copy; the eval batch (32, 2048) and the train
    shapes (1024, 2048 and 3072 bidders for 2048 items) at B 32 and 64 on
    uniform clouds; repeated points and an integer grid; B 1 and 160; every
    cluster size forced on one case; one item (its price goes to inf and
    later bids are NaN: never seated), iters 0; and the size limit: 6428
    against 6428, 28924 against 1 and 1 against 8264 on K7, one more point
    on its cluster design (``csrc/emd_large.cu``), which is also forced at
    K7's sizes with every cluster size."""
    from houv_tpu_torch.ops import emd

    def cloud(b, n):
        return torch.rand((b, n, 3), generator=gen).cuda() - 0.5

    x1, x2 = cloud(4, 2048), cloud(4, 2048)
    perm = x1[:, torch.randperm(2048, generator=gen).cuda()]
    rep1, rep2 = x1.clone(), x2.clone()
    rep1[:, 1024:] = rep1[:, :1024]
    rep2[:, 1536:] = rep2[:, :512]
    grid = torch.randint(0, 8, (2, 4, 2048, 3), generator=gen).cuda() / 8.0
    cases = [("train", x1, x2, 0.005, 50), ("eval", x1, x2, 0.004, 3000),
             ("permuted_copy", x1, perm, 0.004, 3000),
             ("eval_B32", cloud(32, 2048), cloud(32, 2048), 0.004, 3000),
             ("repeated_points", rep1, rep2, 0.004, 3000),
             ("integer_grid", grid[0], grid[1], 0.004, 3000),
             ("B1", x1[:1], x2[:1], 0.004, 3000),
             ("B160", cloud(160, 2048), cloud(160, 2048), 0.005, 50),
             ("one_item", cloud(2, 3), cloud(2, 1), 0.005, 5),
             ("iters_0", cloud(4, 33), cloud(4, 33), 0.005, 0),
             ("limit_6428", cloud(1, 6428), cloud(1, 6428), 0.005, 50),
             ("limit_28924_bidders", cloud(1, 28924), cloud(1, 1), 0.005, 5),
             ("limit_8264_items", cloud(1, 1), cloud(1, 8264), 0.005, 50)]
    items = cloud(64, 2048)
    for b in (32, 64):
        cases += [(f"train_B{b}_{n}_bidders", cloud(b, n), items[:b],
                   0.005, 50) for n in (1024, 2048, 3072)]
    err = 0.0
    for name, a, b, eps, iters in cases:
        err = max(err, check_emd(a, b, eps, iters, name))
    err = max(err, check_emd(x1, x2, 0.004, 3000, "eval_every_cluster_size",
                             range(1, 4)))
    # one point past each limit leaves K7 (for csrc/emd_large.cu, or for
    # csrc/emd_global.cu where a cluster's copies of the lists pass its
    # blocks' shared memory: 28925 bidders), held to the plain version
    # likewise; and the cluster design forced at K7's sizes, every
    # cluster size, on the eval pairs and on n != m both ways
    for n, m, route in ((6429, 6429, "emd_large"), (28925, 1, "emd_global"),
                        (1, 8265, "emd_large")):
        if emd_route(n, m) != route:
            fail(f"emd at {n} bidders and {m} items is routed to "
                 f"{emd_route(n, m)}, not {route}")
        err = max(err, check_emd(cloud(1, n), cloud(1, m), 0.005, 5,
                                 f"above_limit_{n}_{m}"))
    for name, a, b, eps, iters in (
            ("large_forced_eval", x1[:2], x2[:2], 0.004, 3000),
            ("large_forced_more_items", cloud(3, 1000), cloud(3, 1500),
             0.005, 50),
            ("large_forced_more_bidders", cloud(3, 1500), cloud(3, 1000),
             0.005, 50),
            ("large_forced_one_item", cloud(2, 3), cloud(2, 1), 0.005, 5)):
        err = max(err, check_emd(a, b, eps, iters, name, (None, 1, 2, 4, 8),
                                 design="emd_large"))
    return err


def check_scatter(idx, vals, m, name, ref=None):
    """Kernel vs plain (or ``ref``, a sum in the same order): every element
    bit for bit, so that -0.0 and +0.0 differ (both add in ascending i from
    +0.0); returns the largest absolute difference (0 when equal)."""
    from houv_tpu_torch.ops import scatter

    saved = scatter.scatter_add.launches
    out = scatter.scatter_add(idx, vals, m)
    again = scatter.scatter_add(idx, vals, m)
    scatter.scatter_add.launches = saved
    plain = scatter._scatter_add_plain(idx, vals, m) if ref is None else ref
    torch.cuda.synchronize()
    mism = int((out.view(torch.int32) != plain.view(torch.int32)).sum())
    err = float((out - plain).abs().max()) if out.numel() else 0.0
    emit({"phase": "scatter_check", "case": name, "idx": list(idx.shape),
          "reference": "plain" if ref is None else "sequential",
          "rows": m, "channels": vals.shape[-1],
          "dropped": int(((idx < 0) | (idx >= m)).sum()),
          "fullest_row": int(torch.bincount(torch.cat([
              (idx + m * torch.arange(idx.shape[0], device=idx.device)
               [:, None])[(idx >= 0) & (idx < m)],
              idx.new_zeros(1)])).max()),
          "mismatches": mism, "max_abs_err": err,
          "run_to_run_mismatches": int((out.view(torch.int32)
                                        != again.view(torch.int32)).sum())})
    if mism or not torch.equal(out.view(torch.int32), again.view(torch.int32)):
        fail(f"scatter_add {name}: {mism} elements differ from the plain "
             f"version (max {err:.3g})")
    return err


def voxel_target_inputs(gen, b=8, n=2048, g=50):
    """K4's inputs in ``_voxel_targets``: the flat voxel ids of b clouds of
    n uniform points in [-0.5, 0.5]³ on the g³ grid, and [1, x, y, z]."""
    pts = torch.rand((b, n, 3), generator=gen) - 0.5
    cell = torch.clamp(torch.floor((pts + 0.5) * (g - 1)), 0, g - 1).long()
    flat = (cell[..., 0] * g + cell[..., 1]) * g + cell[..., 2]
    vals = torch.cat([torch.ones_like(pts[..., :1]), pts], -1)
    return flat.cuda(), vals.cuda()


def phase_scatter(gen):
    """At the train steps' shapes (VRCNet's (64, 2048) -> 1024, 3072, 2048
    rows, PCN's and ECG's (32, 2048) -> 1024, 2048) and
    the solver's scatter mode ((1024, 2048) -> 2048), a ragged case, eight
    channels, every index equal, indices out of range; at the kernel's
    edges: sums that change with their order, -0.0 alone in its row, one
    row receiving all of 65536 indices (16 chunks; held against the
    sequential sum in ascending i, which the plain version's 65536 rank
    passes would take seconds to reach), 200,000 rows (49 row blocks) and
    70,000 batch entries (two launches); spconv.yaml's voxel targets,
    (8, 2048) rows of 4 channels onto 125,000 voxels; and against the
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
    for m in (1024, 2048):                  # PCN's and ECG's two calc_cd
        err = max(err, check_scatter(*case(32, 2048, m, 3), m,
                                     f"train_B32_N2048_M{m}"))
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

    # every row receives +-1e8 and +-1 (16 values on average): the sum
    # changes with its order, and the reversed order must show it
    idx, vals = case(4, 2048, 128, 3)
    big = torch.rand(vals.shape, generator=gen).cuda() < 0.5
    vals = torch.where(big, 1e8, 1.0) * vals.sign()
    rev = scatter._scatter_add_plain(idx.flip(1), vals.flip(1), 128)
    fwd = scatter._scatter_add_plain(idx, vals, 128)
    if torch.equal(rev.view(torch.int32), fwd.view(torch.int32)):
        fail("scatter order case: the reversed sum is the same")
    err = max(err, check_scatter(idx, vals, 128, "order_sensitive_1e8_1"))
    # -0.0 alone in its row gives +0.0 (the sum starts from +0.0)
    idx = torch.stack([torch.randperm(1024, generator=gen)[:512]
                       for _ in range(4)]).cuda()
    vals = torch.randn((4, 512, 3), generator=gen).cuda()
    vals[:, ::2] = -0.0
    check_scatter(idx, vals, 1024, "negative_zero_single_match")
    out = scatter._scatter_add_plain(idx, vals, 1024)
    if torch.signbit(out[torch.arange(4, device="cuda")[:, None],
                             idx[:, ::2]]).any():
        fail("scatter: a row holding only -0.0 is not +0.0")
    # one row receives every index: 16 chunks of one row
    vals = (torch.randn((2, 65536, 3), generator=gen)
            * 10 ** (6 * torch.rand((2, 65536, 1), generator=gen) - 3))
    seq = np.add.accumulate(np.concatenate(
        [np.zeros((2, 1, 3), np.float32), vals.numpy()], 1), axis=1)[:, -1]
    ref = torch.zeros((2, 16, 3))
    ref[:, 7] = torch.from_numpy(seq)
    err = max(err, check_scatter(torch.full((2, 65536), 7).cuda(),
                                 vals.cuda(), 16, "one_row_N65536",
                                 ref=ref.cuda()))
    # beyond one row block: 49 blocks of 4096 rows
    err = max(err, check_scatter(*case(2, 4096, 200000, 3, lo=-5,
                                       hi=200005), 200000, "rows_M200000"))
    # past the grid's 65535 batch entries
    err = max(err, check_scatter(*case(70000, 4, 4, 3, lo=-1, hi=5), 4,
                                 "batch_B70000_N4_M4"))
    # cfgs/spconv.yaml's voxel targets (train/aux.py:_voxel_targets): 8
    # clouds of 2048 points onto the 50³ grid's 125,000 voxels, channels
    # [1, x, y, z]
    err = max(err, check_scatter(*voxel_target_inputs(gen), 125000,
                                 "voxel_targets_B8_N2048_M125000_C4"))

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


def check_knn_wide(q, r, k, name):
    """Wide kernel vs plain: exact index equality; returns the largest
    difference between the two picks' distances (f64; 0 when equal)."""
    from houv_tpu_torch.ops import grouping

    saved = (grouping.knn_indices.launches, grouping.knn_indices.wide_launches)
    ki = grouping.knn_indices(q, r, k)
    used = grouping.knn_indices.wide_launches - saved[1]
    grouping.knn_indices.launches, grouping.knn_indices.wide_launches = saved
    pi = grouping._knn_plain(q, r, k)
    torch.cuda.synchronize()
    mism = int((ki != pi).sum())
    err = 0.0
    ascending = True
    for b in range(q.shape[0]):       # per cloud: the f64 maps are large
        q64, r64 = q[b].double(), r[b].double()
        kd = ((q64[:, None] - r64[ki[b]]) ** 2).sum(-1)
        pd = ((q64[:, None] - r64[pi[b]]) ** 2).sum(-1)
        err = max(err, float((kd - pd).abs().max()))
        ascending &= bool((kd[:, :-1] <= kd[:, 1:] * (1 + 1e-4) + 1e-12).all())
    emit({"phase": "knn_wide_check", "case": name, "query": list(q.shape),
          "ref": list(r.shape), "k": k, "index_mismatches": mism,
          "max_abs_dist_err": err, "ascending": ascending,
          "wide_launches": used})
    if mism or used != 1 or not ascending:
        fail(f"knn_wide {name}: {mism} indices differ from the plain "
             f"version ({used} wide launches, ascending {ascending})")
    return err


def phase_knn_wide(gen):
    """At the four self-kNN shapes of ECG's DenseConv on cfgs/ecg.yaml
    (batch 32: 3072 points of 24 channels, then 1024, 256 and 64 points of
    48, k 16; features after a ReLU, so many are exactly 0), at
    EFExpansion's shapes in VRCNet (3072 points of 256 channels and 2048 of
    64, k 4), on ragged cases that reach every k bucket, and at the edges of
    the kernel's design: C on and beside each compiled width, k at each
    bucket's and the queue's edges, refs split into parts that do not
    divide N or exceed it, fewer queries than a block, rows that are not
    16-byte aligned, and exact duplicates in other lanes, warps, blocks and
    parts."""
    def feats(b, n, c, relu=True):
        x = torch.randn((b, n, c), generator=gen).cuda()
        return torch.relu(x) if relu else x

    err = 0.0
    for n, c in ((3072, 24), (1024, 48), (256, 48), (64, 48)):
        x = feats(32, n, c)
        err = max(err, check_knn_wide(x, x, 16, f"denseconv_B32_N{n}_C{c}"))
    for n, c in ((3072, 256), (2048, 64)):
        x = feats(32, n, c, relu=False)
        err = max(err, check_knn_wide(x, x, 4, f"efexpansion_B32_N{n}_C{c}"))
    del x
    for (m, n, c, k) in ((1999, 777, 37, 17), (300, 500, 9, 40),
                         (130, 70, 513, 8), (5, 3, 12, 3)):
        q, r = feats(2, m, c, False), feats(2, n, c, False)
        err = max(err, check_knn_wide(q, r, k, f"ragged_M{m}_N{n}_C{c}_k{k}"))
    # the compiled widths (24, 48, 64, 256) and their neighbours
    for c in (23, 24, 25, 47, 48, 49, 63, 64, 65, 255, 256, 257):
        q, r = feats(2, 300, c), feats(2, 1000, c)
        err = max(err, check_knn_wide(q, r, 16, f"width_C{c}_k16"))
    # k at each bucket's edge (4, 8, 16, 32, 64) and the queue's (32 slots)
    for k in (1, 4, 5, 8, 9, 16, 17, 31, 32, 33, 63, 64):
        q, r = feats(2, 200, 48), feats(2, 500, 48)
        err = max(err, check_knn_wide(q, r, k, f"bucket_C48_k{k}"))
    # parts of the refs: N not a multiple of a part, N below one part; M
    # below a block's 128 queries
    for (b, m, n, c, k) in ((3, 50, 70, 24, 16), (2, 7, 5, 24, 3),
                            (8, 100, 333, 48, 16), (1, 1, 3000, 256, 4)):
        q, r = feats(b, m, c), feats(b, n, c)
        err = max(err, check_knn_wide(q, r, k,
                                      f"parts_B{b}_M{m}_N{n}_C{c}_k{k}"))
    # FGR's mutual search at fgr.yaml's batch: 2048 FPFH features of 33
    # bins against another cloud's, k 1, both ways (33 is no compiled
    # width: the run-time-C path)
    q = torch.rand((16, 2048, 33), generator=gen).cuda()
    r = torch.rand((16, 2048, 33), generator=gen).cuda()
    err = max(err, check_knn_wide(q, r, 1, "fgr_mutual_B16_N2048_C33_k1"))
    err = max(err, check_knn_wide(r, q, 1, "fgr_mutual_back_B16_N2048_C33"))
    # rows off 16-byte alignment: the run-time-C path at a compiled width
    flat = torch.randn(2 * 400 * 24 + 1, generator=gen).cuda()
    x = flat[1:].view(2, 400, 24)
    err = max(err, check_knn_wide(x, x, 16, "misaligned_B2_N400_C24"))
    # duplicated rows: exact ties, which go to the smaller index
    x = feats(4, 512, 24)
    x = torch.cat([x, x[:, :256]], 1)
    err = max(err, check_knn_wide(x, x, 16, "duplicates_B4_N768_C24"))
    # copies 1, 33 and 130 rows on (another lane, warp and block of
    # queries), and 192 rows on: across the 4 parts of 64 refs at ECG's
    # 256-point level; at 256 channels (the chunk path, one part) likewise
    for n, c in ((256, 48), (600, 256)):
        x = feats(32, n, c)
        x[:, 192:256] = x[:, :64]
        for i in (0, 5, 40):
            for shift in (1, 33, 130):
                x[:, i + shift] = x[:, i]
        err = max(err, check_knn_wide(x, x, 16, f"duplicates_B32_N{n}_C{c}"))
    return err


def _bits_differ(x, y) -> int:
    """Elements whose f32 bits differ (so a NaN equals its exact copy)."""
    return int((x.view(torch.int32) != y.view(torch.int32)).sum())


def check_nn_select(a, b, name, split=None):
    """Kernel vs plain, and vs the rows K1's own indices name
    (``gather_rows`` of ``chamfer_indices``, as the solver's default branch
    gathers them): both coordinate outputs bit for bit, compared as int32
    so that NaN compares too. ``split``: the (rows, columns) split the
    launch plan must take at this shape."""
    from houv_tpu_torch.ops import chamfer
    from houv_tpu_torch.ops.gather import gather_rows

    bq, n, _ = a.shape
    bk, m, _ = b.shape
    qlen, rlen = chamfer._nn_plan(bk, n, m, chamfer._sm_count(b.device))
    plan_split = [m > rlen, n > qlen]
    saved = (chamfer.nn_select.launches, chamfer.chamfer_indices.launches)
    k1, k2 = chamfer.nn_select(a, b)
    i1, i2 = chamfer.chamfer_indices(a, b)
    chamfer.nn_select.launches, chamfer.chamfer_indices.launches = saved
    p1, p2 = chamfer._nn_select_plain(a, b)
    g1 = gather_rows(b, i1)
    g2 = gather_rows(a, i2.reshape(bq, -1)).reshape(bk, m, 3)
    torch.cuda.synchronize()
    mism = _bits_differ(k1, p1) + _bits_differ(k2, p2)
    mism_k1 = _bits_differ(k1, g1) + _bits_differ(k2, g2)
    err = max(float((k1 - p1).abs().nan_to_num(0.0).max()),
              float((k2 - p2).abs().nan_to_num(0.0).max()))
    rec = {"phase": "nn_select_check", "case": name, "a": list(a.shape),
           "b": list(b.shape), "plan": [qlen, rlen],
           "split_rows_cols": plan_split, "mismatches": mism,
           "mismatches_vs_k1_gather": mism_k1, "max_abs_err": err,
           "nan_outputs": int(k1.isnan().sum()) + int(k2.isnan().sum())}
    emit(rec)
    if mism or mism_k1:
        fail(f"nn_select {name}: {mism} coordinates differ from the plain "
             f"version, {mism_k1} from the gather of K1's indices")
    if split is not None and plan_split != list(split):
        fail(f"nn_select {name}: the plan splits (rows, columns) "
             f"{plan_split}, the case was meant for {list(split)}")
    return err


# K3's edges, (Bq, share, N, M, name, split (rows, columns)): refs over
# 3072 split with the queries whole (264 rows x 2 parts fill 132 SMs 4
# times) and with both split; queries split at the train steps' 32 and 64
# rows, and at phase_select_solve's 4 pairs of 64 restarts (256 rows: 512
# queries a block, share 64). The solver's shapes, both directions whole,
# are phase_nn_select's first cases; planted copies at whole, split and
# edge plans follow
NN_SELECT_EDGES = (
    (33, 8, 300, 3100, "rows_split", (True, False)),
    (8, 1, 1500, 4100, "rows_and_cols_split", (True, True)),
    (32, 1, 2048, 2048, "cols_split", (False, True)),
    (64, 1, 2048, 3072, "cols_split", (False, True)),
    (4, 64, 2048, 2048, "select_solve", (False, True)),
)
NN_SELECT_COPIES = (
    (16, 64, 2048, 2048, (False, False)), (8, 66, 2049, 2047, (False, False)),
    (2, 1, 257, 385, (False, True)), (1, 1, 300, 3073, (True, True)),
    (33, 8, 129, 6145, (True, False)), (32, 1, 2048, 1024, (False, True)),
)


def phase_nn_select(gen):
    """At the solver's shapes (the smoke's houv_fast window of 16 pairs and
    cfgs/houv.yaml's batch of 100, the target shared by each pair's 64
    restarts, 2048 points a side), without sharing, with a share that is
    no multiple of 8, ragged, duplicated; at each split of the launch plan,
    the select solve's 4 pairs among them; with exact copies planted across
    threads, tiles and blocks; on integer grids; with all-NaN clouds, where
    no distance compares and row 0 is copied; and with one NaN point in a
    finite cloud, which no distance picks."""
    a = torch.rand((16, 2048, 3), generator=gen).cuda() - 0.5
    b = (a.repeat_interleave(64, 0)
         + 0.05 * torch.randn((1024, 2048, 3), generator=gen).cuda())
    err = check_nn_select(a, b, "solver_B16_K64_N2048_M2048", (False, False))
    del b
    b = torch.rand((16, 1024, 3), generator=gen).cuda() - 0.5
    err = max(err, check_nn_select(a, b, "unshared_B16_N2048_M1024"))
    a = torch.rand((100, 2048, 3), generator=gen).cuda() - 0.5
    b = (a.repeat_interleave(64, 0)
         + 0.05 * torch.randn((6400, 2048, 3), generator=gen).cuda())
    err = max(err, check_nn_select(a, b, "houv_B100_K64_N2048_M2048",
                                   (False, False)))
    del a, b
    torch.cuda.empty_cache()
    a = torch.randn((3, 1500, 3), generator=gen).cuda()
    b = torch.randn((9, 777, 3), generator=gen).cuda()
    err = max(err, check_nn_select(a, b, "ragged_B3_K3_N1500_M777"))
    b = torch.cat([a, a[:, :100]], 1)      # exact ties, and distance 0
    err = max(err, check_nn_select(a, b, "duplicates_B3_N1500_M1600"))
    for bq, share, n, m, name, split in NN_SELECT_EDGES:
        a = torch.randn((bq, n, 3), generator=gen).cuda()
        b = torch.randn((bq * share, m, 3), generator=gen).cuda()
        err = max(err, check_nn_select(a, b, f"{name}_B{bq}_K{share}_N{n}"
                                       f"_M{m}", split))
    for bq, share, n, m, split in NN_SELECT_COPIES:
        a = planted_copies(torch.randn((bq, n, 3), generator=gen),
                           NN_QUERY_COPIES, gen)
        b = planted_copies(torch.randn((bq * share, m, 3), generator=gen),
                           NN_REF_COPIES, gen)
        err = max(err, check_nn_select(a.cuda(), b.cuda(),
                                       f"copies_B{bq}_K{share}_N{n}_M{m}",
                                       split))
    # integer coordinates: most distances tie with many others
    a = torch.randint(0, 4, (2, 700, 3), generator=gen).float()
    b = torch.randint(0, 4, (6, 900, 3), generator=gen).float()
    err = max(err, check_nn_select(a.cuda(), b.cuda(), "grid_B2_K3_N700_M900"))
    a = torch.randint(0, 6, (8, 1100, 3), generator=gen).float()
    b = torch.randint(0, 6, (528, 1300, 3), generator=gen).float()
    err = max(err, check_nn_select(a.cuda(), b.cuda(),
                                   "grid_B8_K66_N1100_M1300"))
    # one query cloud and one reference cloud all NaN, at a whole plan,
    # with the columns split and with the rows split
    for bq, share, n, m, split in ((8, 66, 300, 400, (False, False)),
                                   (4, 8, 600, 700, (False, True)),
                                   (33, 8, 300, 3100, (True, False))):
        a = torch.randn((bq, n, 3), generator=gen)
        b = torch.randn((bq * share, m, 3), generator=gen)
        a[1] = float("nan")
        b[0] = float("nan")
        err = max(err, check_nn_select(a.cuda(), b.cuda(),
                                       f"nan_B{bq}_K{share}_N{n}_M{m}",
                                       split))
        # one NaN point in a finite query cloud and in a finite reference
        # cloud: never picked, by the kernels as by the plain version
        a[1] = torch.randn((n, 3), generator=gen)
        b[0] = torch.randn((m, 3), generator=gen)
        a[1, n // 3, 1] = float("nan")
        b[0, m // 2, 0] = float("nan")
        err = max(err, check_nn_select(a.cuda(), b.cuda(),
                                       f"nan_point_B{bq}_K{share}_N{n}_M{m}",
                                       split))
    return err


def check_gather_rows(src, idx, name):
    """Kernel vs plain, and vs ``torch.gather`` where every index is in
    range: bit for bit."""
    from houv_tpu_torch.ops import scatter

    saved = scatter.gather_rows_kernel.launches
    out = scatter.gather_rows_kernel(src, idx)
    scatter.gather_rows_kernel.launches = saved
    plain = scatter._gather_rows_plain(src, idx)
    torch.cuda.synchronize()
    mism = int((out != plain).sum())
    outside = int(((idx < 0) | (idx >= src.shape[1])).sum())
    if not outside:
        mism += int((out != torch.gather(
            src, 1, idx[..., None].expand(-1, -1, src.shape[-1]))).sum())
    err = float((out - plain).abs().max())
    emit({"phase": "gather_rows_check", "case": name, "src": list(src.shape),
          "idx": list(idx.shape), "out_of_range": outside,
          "mismatches": mism, "max_abs_err": err})
    if mism:
        fail(f"gather_rows {name}: {mism} elements differ")
    return err


def phase_gather_rows(gen):
    """At the solver's shape (16 clouds of 2048 rows, 64 x 2048 indices
    each), eight channels, a ragged case, 67 channels, 70,000 batch entries
    of one channel (two launches) and indices out of range."""
    def case(b, m, n, c, lo=0, hi=None):
        idx = torch.randint(lo, m if hi is None else hi, (b, n),
                            generator=gen).cuda()
        return torch.randn((b, m, c), generator=gen).cuda(), idx

    err = check_gather_rows(*case(16, 2048, 64 * 2048, 3),
                            "solver_B16_M2048_N131072")
    err = max(err, check_gather_rows(*case(5, 130, 300, 8), "channels_8"))
    err = max(err, check_gather_rows(*case(3, 777, 1999, 1), "ragged_C1"))
    err = max(err, check_gather_rows(*case(2, 40, 64, 67), "wide_C67"))
    err = max(err, check_gather_rows(*case(70000, 8, 16, 1, lo=-2, hi=10),
                                     "batch_B70000_C1"))
    return max(err, check_gather_rows(
        *case(4, 500, 2048, 3, lo=-100, hi=600), "negative_and_past_the_end"))


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


def sweep_cfg(cfg_name, n_pairs, workdir, max_angle=None, name=None,
              **extra):
    """A temp copy of cfgs/<cfg_name> over a synthetic structured split of
    n_pairs (seed 7), batch = n_pairs, the classifier's path absolute;
    ``max_angle`` widens the split's rotations, ``extra`` overrides keys.
    Returns (path, keys)."""
    with open(REPO / "cfgs" / cfg_name) as f:
        raw = yaml.safe_load(f)
    raw.update(synthetic_size=n_pairs, synthetic_shape="structured",
               batch_size=n_pairs,
               work_dir=str(workdir / Path(name or cfg_name).stem), **extra)
    if max_angle is not None:
        raw["max_angle"] = max_angle
    if raw.get("rescore_ckpt"):
        raw["rescore_ckpt"] = str(REPO / raw["rescore_ckpt"])
    cfg_path = workdir / (name or cfg_name)
    cfg_path.write_text(yaml.safe_dump(raw))
    return cfg_path, raw


def run_sweep(cfg_name, n_pairs, workdir, max_angle=None, **extra):
    """The port's test_main on ``sweep_cfg``'s copy of cfgs/<cfg_name>.
    The record carries the sweep's counts (rescored: the classifier's
    overrides, the pools' and the scoring's seconds, the sites dropped),
    the launches of K1 and K2 and the peak device memory; the test_main
    result is under ``out`` and the transforms under ``results`` (neither
    printed)."""
    from houv_tpu_torch.data import synthesize_registration_pairs
    from houv_tpu_torch.geometry.rotations import rotation_error
    from houv_tpu_torch.ops.chamfer import chamfer_indices
    from houv_tpu_torch.ops.sampling import furthest_point_sample
    from houv_tpu_torch.train.cli import test_main
    from houv_tpu_torch.train.submission import read_results_h5

    cfg_path, raw = sweep_cfg(cfg_name, n_pairs, workdir, max_angle,
                              **extra)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
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
           "use_view_loss": bool(raw.get("use_view_loss", False)),
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": launches}
    if "rescore" in out:
        rec.update({k: out[k] for k in ("n_override", "pool_seconds",
                                        "score_seconds", "classifier_calls",
                                        "sites_dropped")},
                   rescore_cands=raw["rescore_cands"],
                   rescore_margin=raw["rescore_margin"])
    emit(rec)
    rec["out"] = out
    rec["results"] = results
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
        refs = {"houv.yaml:4": ref}
        for name in ("houv_fast.yaml", "houv.yaml"):
            full = run_sweep(name, 100, workdir)
            if full["rot_err_median_deg"] >= 10.0:
                fail(f"{name} at 100 pairs: median rotation error "
                     f"{full['rot_err_median_deg']:.2f} >= 10 deg")
            refs[f"{name}:100"] = full
    # the one-process rows the parallel phase's sharded runs are held to
    fast["refs"] = {k: {"results": r["results"], "n_retry": r["n_retry"],
                        "pairs_per_s": r["pairs_per_s"]}
                    for k, r in refs.items()}
    return fast


# pairs of each quality-mode run: the yamls' widths (2048 points, 64
# restarts, 500 steps, 4 windows; rescored: 16 candidates, the trained
# classifier at grid 50), the split and the batch cut to 8 pairs (the
# yamls' batch of 100: ``--quality-pairs 100``)
QUALITY_PAIRS = 8
# houv_eval_main's labelled split (cut from 8 pairs); the smoke's
# houv_quality.yaml sweep cut in depth from the yaml's 500 Adam steps a
# window (``--quality-pairs`` runs the yaml's)
EVAL_PAIRS = 4
QUALITY_STEPS = 250
RESCORE_CKPT = "log/alignment_spconv_cd_rescorer_pool/best_acc_network.ckpt"


def _rescorer_model(device):
    """The trained classifier as ``train/cli.py:make_rescorer`` builds it:
    bf16 mode, grid 50, on ``device``."""
    from houv_tpu_torch.models import get_model
    from houv_tpu_torch.state import state_from_flax
    from houv_tpu_torch.train.checkpoint import read_flax_msgpack

    state = read_flax_msgpack(str(REPO / RESCORE_CKPT))
    model = get_model("alignment_spconv", grid_size=50,
                      compute_dtype="bfloat16")
    model.load_state_dict(state_from_flax(state, model), strict=True)
    return model.to(device).eval()


def _check_rescore(run, workdir):
    """The run's card logits against the port's CPU path on the same
    overlays (each pair's candidates moved onto its target), both in bf16
    mode; the picks at the run's margin must agree. Then the classifier's
    ms per call of 32 overlays."""
    from houv_tpu_torch.solvers.rescore import apply_candidates, rescore_pick
    from houv_tpu_torch.train.cli import build_dataset
    from houv_tpu_torch.train.config import load_config

    diag = run["out"]["rescore"]
    n = min(QUALITY_PAIRS, len(diag["pick"]))
    cfg = load_config(str(workdir / Path(run["config"]).name))
    batch = build_dataset(cfg, "test").get_batch(np.arange(n))
    moved = apply_candidates(torch.as_tensor(batch["src"]),
                             torch.as_tensor(diag["cand_r"][:n]),
                             torch.as_tensor(diag["cand_t"][:n]))
    tgt = torch.as_tensor(batch["tgt"])
    c = moved.shape[1]
    cpu = _rescorer_model("cpu")
    logits = []
    with torch.no_grad():
        for i in range(n):
            logits.append(cpu(moved[i], tgt[i:i + 1].expand(c, -1, -1)))
    cpu_logits = torch.stack(logits)
    card_logits = torch.as_tensor(diag["cand_logits"][:n])
    err = float((card_logits - cpu_logits).abs().max())
    loss = torch.as_tensor(diag["cand_loss"][:n])
    margin = run["rescore_margin"]
    card_pick = rescore_pick(loss, card_logits, margin)
    cpu_pick = rescore_pick(loss, cpu_logits, margin)
    model = _rescorer_model("cuda")
    s32 = moved.reshape(-1, *moved.shape[2:])[:32].cuda()
    t32 = tgt.repeat_interleave(c, 0)[:32].cuda()
    with torch.no_grad():
        ms = cuda_ms(lambda: model(s32, t32), reps=5)
    rec = {"phase": "rescore_check", "config": run["config"],
           "overlays": n * c, "max_abs_logit_err": err, "tolerance": 5e-2,
           "picks_differ": int((card_pick != cpu_pick).sum()),
           "picks": card_pick.tolist(), "margin": margin,
           "classifier_ms_per_32": ms,
           "sites_dropped_32": int(model.sites_dropped)}
    emit(rec)
    if err > 5e-2 or rec["picks_differ"]:
        fail(f"rescore: card logits {err:.3g} from the CPU path's, "
             f"{rec['picks_differ']} picks differ")
    return rec


def phase_quality(n_pairs=QUALITY_PAIRS, quality_steps=QUALITY_STEPS):
    """Registration's quality modes at full width on ``n_pairs`` pairs (a
    batch of as many) through ``test_main``: cfgs/houv_quality.yaml (at
    ``quality_steps`` Adam steps a window, the yaml's where None; the view
    loss: 4
    K1 searches an Adam step and 4 for the final objective, every window),
    cfgs/houv_rescore.yaml and cfgs/houv_extratest_rescore.yaml (the
    cadence's pools, 16 candidates, the trained classifier at margin 3);
    then ``houv_eval_main`` (``train -c``) on houv_rescore.yaml over a
    labelled split of ``EVAL_PAIRS``, globally and by bucket, and the rescoring's card
    logits against the CPU path on the first 8 pairs."""
    from houv_tpu_torch.train.cli import main as cli_main

    with tempfile.TemporaryDirectory() as tmp:
        workdir = Path(tmp)
        quality = run_sweep("houv_quality.yaml", n_pairs, workdir,
                            **({"num_epochs": quality_steps}
                               if quality_steps else {}))
        windows = 4          # retry_mode always
        expected = 4 * (quality["steps"] + 1) * windows
        if quality["launches"]["nn_both"] != expected:
            fail(f"houv_quality: {quality['launches']['nn_both']} K1 "
                 f"launches, expected {expected}")
        runs = [quality]
        for name in ("houv_rescore.yaml", "houv_extratest_rescore.yaml"):
            run = run_sweep(name, n_pairs, workdir)
            if run["sites_dropped"] or min(run["launches"].values()) < 1:
                fail(f"{name}: {run['sites_dropped']} sites dropped, "
                     f"launches {run['launches']}")
            runs.append(run)
        for run in runs:
            if run["rot_err_median_deg"] >= 10.0:
                fail(f"{run['config']}: median rotation error "
                     f"{run['rot_err_median_deg']:.2f} >= 10 deg")
        check = _check_rescore(runs[1], workdir)
        cfg_path = workdir / "houv_rescore.yaml"
        raw = yaml.safe_load(cfg_path.read_text())
        raw.update(synthetic_size=EVAL_PAIRS, batch_size=EVAL_PAIRS,
                   work_dir=str(workdir / "eval"))
        cfg_path.write_text(yaml.safe_dump(raw))
        t0 = time.perf_counter()
        meters = cli_main(["train", "-c", str(cfg_path)])
        rec = {"phase": "houv_eval_main", "config": "cfgs/houv_rescore.yaml",
               "pairs": meters["n_pairs"],
               "wall_s": time.perf_counter() - t0, **meters}
        emit(rec)
        names = ("RotE", "transE", "MSE", "RMSE", "recall", "GeoE")
        if not all(np.isfinite(meters[m]) for m in names):
            fail(f"houv_eval_main: meters {meters}")
        if sum(b["n"] for b in meters["buckets"].values()) != rec["pairs"]:
            fail("houv_eval_main: the buckets do not cover the pairs")
    rescore = runs[1]
    return {"runs": [{k: v for k, v in r.items()
                      if k not in ("out", "results")} for r in runs],
            "check": check, "eval": rec,
            "rescore_ref": {"results": rescore["results"],
                            "n_retry": rescore["n_retry"],
                            "n_override": rescore["n_override"],
                            "rescore": rescore["out"]["rescore"]}}


# the classical solvers' runs: the model, the yaml it copies (icp and goicp
# copy fgr.yaml with their model name, as the reference's train_ICP.py
# serves them), a 32-pair structured val split at the yaml's width and
# batch; the CPU path redoes the first batch's first pairs
CLASSICAL_RUNS = (("fgr", "fgr.yaml"), ("goicp_bnb", "goicp_bnb.yaml"),
                  ("icp", "fgr.yaml"), ("goicp", "fgr.yaml"))
CLASSICAL_PAIRS = 32
CLASSICAL_CPU_PAIRS = {"fgr": 4, "goicp_bnb": 2, "icp": 2}


def classical_launches(model, cfg, batches):
    """The kernel launches of ``icp_eval_main`` over ``batches`` batches,
    derived from the code: FGR 4 K6 (k 16 and 17 on each cloud) and 2
    K6-wide (the mutual search) a batch; goicp_bnb 1 K2 (the subsample); ICP
    max(num_iters, 50) + 1 K1; the grid Go-ICP (21 grid chunks + 6 a
    refinement level, 2 levels) x (num_iters + 1) K1."""
    if model == "fgr":
        return {"knn": 4 * batches, "knn_wide": 2 * batches}
    if model == "goicp_bnb":
        return {"fps": batches}
    if model == "icp":
        return {"nn_both": (max(cfg.num_iters, 50) + 1) * batches}
    return {"nn_both": (21 + 6 * 2) * (cfg.num_iters + 1) * batches}


def _agree_deg(a, b):
    """Rotation angles (degrees) between two stacks of (4, 4) transforms."""
    from houv_tpu_torch.geometry.rotations import rotation_error

    return rotation_error(torch.as_tensor(a[:, :3, :3]),
                          torch.as_tensor(b[:, :3, :3])).numpy()


def _bnb_on_card(rng_seed=7):
    """``tests/test_torch_goicp_bnb.py`` on the card, with its bounds: the
    field's floor and ceiling around the true distance, each cube's LB under
    the objective inside it (20 cubes), and the planted 60° case (e <=
    1e-5, gap <= 5e-4, rotation error < 2°). A TF32 product in the field
    would break the first two."""
    from houv_tpu_torch.geometry.rotations import rodrigues
    from houv_tpu_torch.solvers import goicp_bnb as bnb

    rng = np.random.default_rng(rng_seed)

    def cloud(n):
        pts = rng.normal(size=(n, 3)).astype(np.float32)
        return pts / (2.0 * np.abs(pts).max())

    tgt = cloud(64)
    field, cell = bnb.build_distance_field(torch.tensor(tgt[None]).cuda(),
                                           24, -1.2, 1.2)
    qry = rng.uniform(-3.0, 3.0, (1, 500, 3)).astype(np.float32)
    true_d = np.sqrt(((qry[0][:, None].astype(np.float64) - tgt[None])
                      ** 2).sum(-1).min(-1))
    f, d = (x.cpu().numpy()[0] for x in
            bnb._field_lookup(field, torch.tensor(qry).cuda(), -1.2, cell))
    field_err = max(float((f - d - true_d).max()),
                    float((true_d - f - d).max()))
    src = cloud(48)
    tgt = cloud(64)
    field, cell = bnb.build_distance_field(torch.tensor(tgt[None]).cuda(),
                                           24, -1.5, 1.5)
    p = torch.tensor(src[None]).cuda()
    p_norm = p.norm(dim=-1)
    lb_excess = -np.inf
    for _ in range(20):
        rc = rng.uniform(-2.0, 2.0, 3).astype(np.float32)
        sr, tc = float(rng.uniform(0.05, 0.6)), rng.uniform(-0.3, 0.3, 3)
        st = float(rng.uniform(0.02, 0.2))
        lb, _, _ = bnb.cube_bounds(
            field, cell, -1.5, p, p_norm,
            torch.tensor(rc[None, None]).cuda(),
            torch.tensor([[sr]]).cuda(),
            torch.tensor(tc[None, None], dtype=torch.float32).cuda(),
            torch.tensor([[st]]).cuda(),
            torch.tensor([[True]]).cuda())
        rr = rc + rng.uniform(-sr, sr, 3).astype(np.float32)
        tt = tc + rng.uniform(-st, st, 3)
        ang = np.linalg.norm(rr)
        r_in = rodrigues(torch.tensor([ang], dtype=torch.float32),
                         torch.tensor((rr / max(ang, 1e-9))[None]))[0]
        moved = src.astype(np.float64) @ r_in.double().numpy().T + tt
        e_true = ((moved[:, None] - tgt[None]) ** 2).sum(-1).min(-1).mean()
        lb_excess = max(lb_excess, float(lb[0, 0]) - e_true)
    src = cloud(96)
    axis = torch.tensor([[0.3, 1.0, -0.2]])
    r_gt = rodrigues(torch.tensor([np.radians(60.0)], dtype=torch.float32),
                     axis)[0].numpy()
    tgt = src @ r_gt.T + np.array([0.1, -0.05, 0.08], np.float32)
    out = bnb.goicp_bnb_solve(
        torch.tensor(src[None]).cuda(), torch.tensor(tgt[None]).cuda(),
        trans_half=0.2, n_src=48, grid=32, frontier=1024, levels=12,
        icp_iters=8)
    r_est = out["transform"][0, :3, :3].cpu().numpy()
    rec = {"field_bound_excess": field_err, "cube_lb_excess": lb_excess,
           "planted_e": float(out["e"][0]), "planted_gap": float(out["gap"][0]),
           "planted_rot_err_deg": float(np.degrees(np.arccos(np.clip(
               (np.trace(r_est.T @ r_gt) - 1) / 2, -1, 1)))),
           "tolerance": 1e-5}
    emit({"phase": "goicp_bnb_card_check", **rec})
    if (field_err > 1e-5 or lb_excess > 1e-5 or rec["planted_e"] > 1e-5
            or not -1e-6 <= rec["planted_gap"] <= 5e-4
            or rec["planted_rot_err_deg"] >= 2.0):
        fail(f"goicp_bnb on the card: {rec}")
    return rec


def phase_classical():
    """The classical baselines at full width through ``train -c`` (the
    port's ``icp_eval_main``): cfgs/fgr.yaml, cfgs/goicp_bnb.yaml, and icp
    and goicp (copies of fgr.yaml with the model name changed) over a
    32-pair structured val split, 2048 points, the yamls' batches (16; 8
    for goicp_bnb). Each run's launches are held to the counts derived from
    the code (``classical_launches``, the counts set to 0 just before the
    run); the meters must be finite and goicp_bnb's gap >= 0 on every
    pair. The card's transforms on the first batch's first pairs go beside
    the port's CPU path's on the same pairs (the grid Go-ICP, 33 ICPs of
    (num_iters + 1) searches a batch, on one pair at 4 iterations and its
    first 512 points on both devices); K6 and K6-wide are checked index for
    index on FGR's own clouds and features; then goicp_bnb's bounds and
    its planted case on the card."""
    from houv_tpu_torch.solvers import fgr
    from houv_tpu_torch.train.cli import (build_dataset, classical_solve,
                                          main as cli_main)
    from houv_tpu_torch.train.config import load_config

    counters = _completion_counters()
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for model, base in CLASSICAL_RUNS:
            with open(REPO / "cfgs" / base) as f:
                raw = yaml.safe_load(f)
            raw.update(model_name=model, synthetic_size=CLASSICAL_PAIRS,
                       synthetic_shape="structured", work_dir=str(tmp))
            path = Path(tmp) / f"{model}.yaml"
            path.write_text(yaml.safe_dump(raw))
            cfg = load_config(str(path))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _zero(counters)
            t0 = time.perf_counter()
            out = cli_main(["train", "-c", str(path)])
            wall = time.perf_counter() - t0
            launches = _read(counters)
            batches = CLASSICAL_PAIRS // raw["batch_size"]
            expected = classical_launches(model, cfg, batches)
            rec = {"phase": "classical", "config": f"cfgs/{base}",
                   "model": model, "pairs": out["n_pairs"],
                   "points": raw["num_points"],
                   "batch_size": raw["batch_size"],
                   "num_iters": raw["num_iters"], "wall_s": wall,
                   "solve_s": out["seconds"],
                   "pairs_per_s": out["n_pairs"] / out["seconds"],
                   "RotE": out["RotE"], "transE": out["transE"],
                   "recall": out["recall"],
                   "rot_err_median_deg": float(np.median(_agree_deg(
                       out["transforms"], build_dataset(cfg, "val")
                       .transforms[:out["n_pairs"]]))),
                   "peak_memory_gib": torch.cuda.max_memory_allocated()
                   / 2**30, "launches": launches,
                   "launches_expected": expected}
            if model == "goicp_bnb":
                gap = out["bnb"]["gap"]
                rec.update(certified=int(out["bnb"]["certified"].sum()),
                           gap_max=float(gap.max()), gap_min=float(gap.min()),
                           e_mean=float(out["bnb"]["e"].mean()))
                if gap.min() < 0:
                    fail(f"goicp_bnb: a negative gap {gap.min()}")
            # the card beside the CPU path on the first batch's first pairs
            ds = build_dataset(cfg, "val")
            if model == "goicp":
                cfg.num_iters = 4
                batch = ds.get_batch(np.arange(1))
                src, tgt = (torch.as_tensor(batch[k][:, :512])
                            for k in ("src", "tgt"))
                card = classical_solve(cfg, src.cuda(), tgt.cuda(),
                                       torch.device("cuda"))["transform"]
                card = card.cpu().numpy()
                rec["cpu_compare"] = "pair 0, 512 points, num_iters 4"
            else:
                n = CLASSICAL_CPU_PAIRS[model]
                batch = ds.get_batch(np.arange(n))
                src, tgt = (torch.as_tensor(batch[k]) for k in ("src", "tgt"))
                card = out["transforms"][:n]
                rec["cpu_compare"] = f"the first batch's first {n} pairs"
            cpu = classical_solve(cfg, src, tgt,
                                  torch.device("cpu"))["transform"].numpy()
            diff = _agree_deg(card, cpu)
            rec.update(cpu_rot_diff_deg=diff.tolist(),
                       cpu_share_within_1deg=float((diff < 1.0).mean()),
                       cpu_trans_diff_max=float(np.abs(
                           card[:, :3, 3] - cpu[:, :3, 3]).max()))
            emit(rec)
            for m in ("RotE", "transE", "recall"):
                if not np.isfinite(rec[m]):
                    fail(f"{model}: {m} = {rec[m]}")
            if launches != expected:
                fail(f"{model}: launches {launches}, derived {expected}")
            runs[model] = rec
            if model == "fgr":
                # K6 and K6-wide index for index on FGR's own first batch
                batch = ds.get_batch(np.arange(raw["batch_size"]))
                x = torch.as_tensor(batch["src"]).cuda()
                y = torch.as_tensor(batch["tgt"]).cuda()
                for k in (16, 17):
                    check_knn(x, x, k, f"fgr_path_B16_N2048_k{k}")
                fx, fy = fgr.fpfh(x), fgr.fpfh(y)
                check_knn_wide(fx, fy, 1, "fgr_path_fpfh_k1")
                check_knn_wide(fy, fx, 1, "fgr_path_fpfh_back_k1")
    runs["card_check"] = _bnb_on_card()
    return runs


def phase_combine():
    """The shard combine at full width: cfgs/houv_fast.yaml at batch 16 on a
    48-pair structured test split, unsharded; then shards [0, 16) and
    [32, 48) and ``--combine``, which solves [16, 32). The merged
    results.h5 is held to the unsharded one bit for bit; where they differ,
    the largest rotation difference is printed (the solver's gather path
    has no atomics: a difference would come from a library reduction or
    product picking another algorithm)."""
    from houv_tpu_torch.train.cli import test_main
    from houv_tpu_torch.train.submission import read_results_h5

    counters = _completion_counters()
    with tempfile.TemporaryDirectory() as tmp:
        with open(REPO / "cfgs" / "houv_fast.yaml") as f:
            raw = yaml.safe_load(f)
        paths = {}
        for name in ("whole", "sharded"):
            raw.update(synthetic_size=48, synthetic_shape="structured",
                       batch_size=16, work_dir=str(Path(tmp) / name))
            paths[name] = Path(tmp) / f"houv_fast_{name}.yaml"
            paths[name].write_text(yaml.safe_dump(raw))
        t0 = time.perf_counter()
        whole = test_main(["-c", str(paths["whole"])])
        whole_s = time.perf_counter() - t0
        for l, r in ((0, 16), (32, 48)):
            test_main(["-c", str(paths["sharded"]), "-l", str(l), "-r",
                       str(r)])
        _zero(counters)
        t0 = time.perf_counter()
        out = test_main(["-c", str(paths["sharded"]), "--combine"])
        combine_s = time.perf_counter() - t0
        launches = _read(counters)
        merged = read_results_h5(out["results_h5"])
        expected = read_results_h5(whole["results_h5"])
        with open(out["manifest"]) as f:
            manifest = json.load(f)
    bits = merged.shape == expected.shape and \
        merged.tobytes() == expected.tobytes()
    rec = {"phase": "combine", "config": "cfgs/houv_fast.yaml",
           "pairs": 48, "batch_size": 16, "shards": manifest["shards"],
           "resolved": [list(x) for x in out["resolved"]],
           "unsharded_s": whole_s, "combine_s": combine_s,
           "launches": launches, "bit_equal": bits}
    if not bits:
        diff = _agree_deg(merged, expected)
        rec.update(max_rot_diff_deg=float(diff.max()),
                   rows_differing=int((merged != expected).any((1, 2)).sum()))
    emit(rec)
    if merged.shape != (48, 4, 4) or not np.isfinite(merged).all():
        fail(f"combine: results {merged.shape} not finite (48, 4, 4)")
    if manifest != {"total": 48, "shards": [[0, 16], [16, 32], [32, 48]]}:
        fail(f"combine: manifest {manifest}")
    if out["resolved"] != [(16, 32)] or min(
            launches.get(k, 0) for k in ("nn_both", "fps")) < 1:
        fail(f"combine solved {out['resolved']} with launches {launches}")
    if not bits:
        fail(f"combine differs from the unsharded sweep: {rec}")
    return rec


# ---------------------------------------------------------------------------
# the parallel phase: torch.distributed over the card(s)
# ---------------------------------------------------------------------------

# DDP runs: (run, yaml, global batch (two ranks of 16), steps, keys over
# the yaml's): VRCNet as its yaml has it (KLD) and under distribution_loss
# MMD, whose latent samples are gathered over the ranks
DDP_RUNS = (("vrcnet", "vrcnet", 32, 2, {}),
            ("vrcnet_mmd", "vrcnet", 32, 2, {"distribution_loss": "MMD"}),
            ("deepgmr", "deepgmr", 32, 2, {}))
PARALLEL_PAIRS = {"houv_fast.yaml": 100, "houv.yaml": 4,
                  "houv_rescore.yaml": QUALITY_PAIRS}


def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.tobytes() == b.tobytes()


def _peaks(mesh):
    """Each rank's peak device memory (GiB) since the last reset, in rank
    order."""
    from houv_tpu_torch.parallel.mesh import all_gather_rows

    peak = torch.tensor([torch.cuda.max_memory_allocated() / 2**30],
                        dtype=torch.float64, device=mesh.device)
    return all_gather_rows(peak, mesh).tolist()


def _rank_launches(counters, mesh):
    """The kernels' launches since ``_zero``, summed over the ranks."""
    from houv_tpu_torch.parallel.mesh import sum_int

    return {k: n for k in counters
            if (n := sum_int(counters[k].launches, mesh))}


def _nccl_rank(path, n_pairs):
    """A rank of the NCCL job (a card each): all_reduce, broadcast and the
    exact row gather on CUDA tensors (-0.0 and NaN rows among them), then
    the houv_fast batch through ``sharded_houv_solve`` over every rank.
    The mesh holds the world group even of one rank, so the gather runs
    ``dist.all_gather`` and the solve's gathers and counts run through
    NCCL at world size 1 too (there its one shard is the whole batch)."""
    import torch.distributed as dist

    from houv_tpu_torch.parallel.mesh import (_has_all_gather,
                                              all_gather_rows, make_mesh,
                                              sharded_houv_solve)
    from houv_tpu_torch.solvers.houv import init_params
    from houv_tpu_torch.train import cli
    from houv_tpu_torch.train.config import load_config

    mesh = make_mesh()
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = mesh.device
    if mesh.group() is None:
        raise RuntimeError("the NCCL job's mesh holds no process group")
    t = torch.full((4,), float(rank + 1), device=dev)
    dist.all_reduce(t)
    summed = bool((t == world * (world + 1) / 2).all())
    b = torch.arange(5, dtype=torch.float32, device=dev) * (rank == 0)
    dist.broadcast(b, src=0)
    broadcast = bool((b == torch.arange(5, device=dev)).all())
    row = torch.tensor([[-0.0, float("nan"), rank, 1e-38]], device=dev)
    gather_path = ("all_gather" if _has_all_gather(mesh.group(), row)
                   else "broadcasts")
    gathered = all_gather_rows(row, mesh).cpu()
    expect = torch.tensor([[-0.0, float("nan"), r, 1e-38]
                           for r in range(world)])
    gather = _bits_equal(gathered.numpy(), expect.numpy())
    cfg = load_config(path)
    batch = cli.build_dataset(cfg, "test").get_batch(np.arange(n_pairs))
    scfg = cli.solver_config(cfg)
    params0 = init_params(cli._pair_generator(cfg, 0), n_pairs, scfg.kernel,
                          scfg.lattice_init, device="cpu")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sharded_houv_solve(torch.as_tensor(batch["src"]),
                             torch.as_tensor(batch["tgt"]), mesh, scfg,
                             params0=params0)
    transform = out["transform"].cpu().numpy()
    return {"world": world, "backend": dist.get_backend(mesh.group()),
            "all_reduce": summed, "broadcast": broadcast,
            "gather_bits": gather, "gather_path": gather_path,
            "results": transform,
            "n_retry": out["n_retry"],
            "seconds": time.perf_counter() - t0}


def _grads(model) -> dict:
    return {k: p.grad.detach().cpu().numpy().copy()
            for k, p in model.named_parameters() if p.grad is not None}


def _running(model) -> dict:
    return {k: v.detach().cpu().numpy().copy()
            for k, v in model.state_dict().items() if "running" in k}


def _ddp_steps(raw, batch, n_steps, mesh):
    """``n_steps`` train steps of config ``raw`` on the global ``batch``
    (over ``mesh``'s ranks, or in one process for None): the losses, the
    first step's gradients and running statistics, the final state,
    steps/s (steps 2..n), and over ranks whether the replicas are
    bit-equal."""
    from houv_tpu_torch.train.cli import make_trainer
    from houv_tpu_torch.train.config import Config

    trainer = make_trainer(Config.from_dict(raw), "cuda", mesh)
    trainer.init_state()
    losses = [float(trainer.train_step(batch, 0, 0))]
    grads, running = _grads(trainer.model), _running(trainer.model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(1, n_steps):
        losses.append(float(trainer.train_step(batch, 0, s)))
    torch.cuda.synchronize()
    rate = (n_steps - 1) / (time.perf_counter() - t0)
    state = {k: v.detach().cpu().numpy().copy()
             for k, v in trainer.model.state_dict().items()}
    out = {"losses": losses, "grads": grads, "running_1": running,
           "state": state, "steps_per_s": rate}
    if mesh is not None:
        from houv_tpu_torch.parallel.mesh import all_gather_rows

        flat = torch.cat([v.reshape(-1).float() for v in
                          trainer.model.state_dict().values()])
        rows = all_gather_rows(flat[None], mesh).view(torch.int32)
        out["replicas_equal"] = bool((rows == rows[:1]).all())
    del trainer
    torch.cuda.empty_cache()
    return out


def _gloo_rank(paths, ddp):
    """A rank of the two-rank job sharing one card over gloo: the sweeps
    of ``paths`` (``_gloo_sweeps``; none when empty), then the DDP steps
    of ``ddp``; each run's launches summed over the ranks, each rank's
    peak memory."""
    from houv_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh()
    counters = _completion_counters()
    out = _gloo_sweeps(paths, mesh, counters) if paths else {}
    for run, (raw, global_batch, n_steps) in ddp.items():
        _zero(counters)
        torch.cuda.reset_peak_memory_stats()
        rec = _ddp_steps(raw, global_batch, n_steps, mesh)
        rec["launches"] = _rank_launches(counters, mesh)
        rec["peak_gib"] = _peaks(mesh)
        if _f64_loss_run(raw):
            rec["loss_f64"] = _first_loss_f64(raw, global_batch, mesh)
        out[run] = rec
    return out


def _f64_loss_run(raw) -> bool:
    """Whether the DDP run of config ``raw`` also takes its first step in
    f64: a BatchNorm model without MMD, whose f32 loss carries more
    rounding than the DDP comparison's bound (``DDP_LOSS_REL_F64``)."""
    return (raw["model_name"] not in DDP_NO_BATCHNORM
            and raw.get("distribution_loss") != "MMD")


def _first_loss_f64(raw, batch, mesh):
    """The first train step's loss of config ``raw`` on the global
    ``batch`` with the model and the batch in f64 (over ``mesh``'s ranks,
    or in one process for None), from the same seeded weights; the kNN
    kernels still pick in f32, on the f64 points rounded."""
    from houv_tpu_torch.train.cli import make_trainer
    from houv_tpu_torch.train.config import Config

    trainer = make_trainer(Config.from_dict(raw), "cuda", mesh)
    trainer.init_state()
    trainer.model.to(torch.float64)
    batch = {k: v.astype(np.float64) if getattr(v, "dtype", None)
             == np.float32 else v for k, v in batch.items()}
    loss = float(trainer.train_step(batch, 0, 0))
    del trainer
    torch.cuda.empty_cache()
    return loss


def _gloo_sweeps(paths, mesh, counters):
    """The two-rank sweeps: houv_fast at 100 pairs and houv_rescore at 8
    through ``test_main``, the (1 x 2) split of houv.yaml's 4 pairs."""
    from houv_tpu_torch.parallel.mesh import (make_mesh_2d,
                                              sharded_houv_solve_2d)
    from houv_tpu_torch.solvers.houv import init_params
    from houv_tpu_torch.train import cli
    from houv_tpu_torch.train.config import load_config
    from houv_tpu_torch.train.submission import read_results_h5

    out = {}
    for name in ("houv_fast.yaml", "houv_rescore.yaml"):
        _zero(counters)
        torch.cuda.reset_peak_memory_stats()
        rec = cli.test_main(["-c", str(paths[name])])
        out[name] = {"results": read_results_h5(rec["results_h5"]),
                     "seconds": rec["seconds"], "n_retry": rec["n_retry"],
                     "launches": _rank_launches(counters, mesh),
                     "peak_gib": _peaks(mesh)}
        if "rescore" in rec:
            out[name].update(rescore=rec["rescore"],
                             n_override=rec["n_override"])
    cfg = load_config(str(paths["houv.yaml"]))
    n = PARALLEL_PAIRS["houv.yaml"]
    batch = cli.build_dataset(cfg, "test").get_batch(np.arange(n))
    scfg = cli.solver_config(cfg)
    params0 = init_params(cli._pair_generator(cfg, 0), n, scfg.kernel,
                          scfg.lattice_init, device="cpu")
    mesh_2d = make_mesh_2d(1, 2)
    _zero(counters)
    t0 = time.perf_counter()
    split = sharded_houv_solve_2d(torch.as_tensor(batch["src"]),
                                  torch.as_tensor(batch["tgt"]), mesh_2d,
                                  scfg, params0=params0)
    out["houv.yaml"] = {"results": split["transform"].cpu().numpy(),
                        "n_retry": split["n_retry"],
                        "seconds": time.perf_counter() - t0,
                        "launches": _rank_launches(counters, mesh)}
    return out


def _half_batch_grads(raw, batch, ranks=2):
    """One process's first-step gradient computed as the DDP ranks compute
    it: each rank's rows of the global batch with its slice of the step's
    draws, one after the other from the same weights, then their mean. For
    a model without BatchNorm (whose ranks need nothing of each other in
    the forward) the DDP step's averaged gradient is this, up to the order
    of the card's atomic adds."""
    from houv_tpu_torch.parallel.mesh import Mesh
    from houv_tpu_torch.train.cli import make_trainer
    from houv_tpu_torch.train.config import Config

    trainer = make_trainer(Config.from_dict(raw), "cuda")
    trainer.init_state()
    parts = []
    for r in range(ranks):
        # a mesh without a process group: this rank's rows and draws
        trainer.mesh = Mesh(("data",), (ranks,), (r,), (None,),
                            trainer.device)
        trainer.optimizer.zero_grad(set_to_none=True)
        trainer._train_loss(trainer._local(batch), 0, 0).backward()
        parts.append({k: p.grad.detach().clone()
                      for k, p in trainer.model.named_parameters()
                      if p.grad is not None})
    mean = {k: (sum(p[k] for p in parts) / ranks).cpu().numpy()
            for k in parts[0]}
    del trainer, parts
    torch.cuda.empty_cache()
    return mean


def _ddp_inputs(workdir):
    """The DDP runs' inputs and their one-process side: for each run of
    ``DDP_RUNS`` its yaml at the global batch, the batch and the steps
    (``ddp``); one process's run on the whole batch with its peak memory,
    for a model without BatchNorm the ranks' work redone in one process
    (``halves``), and the planted fault (``fault``) (``one``). Under MMD
    the ranks' work redone one rank after the other is the planted fault
    itself: each rank's MMD over its own rows only."""
    from houv_tpu_torch.train.cli import build_dataset
    from houv_tpu_torch.train.config import Config

    ddp, one = {}, {}
    for run, model, batch_size, n_steps, extra in DDP_RUNS:
        with open(REPO / "cfgs" / f"{model}.yaml") as f:
            raw = yaml.safe_load(f)
        raw.update(batch_size=batch_size, synthetic_size=batch_size,
                   work_dir=str(workdir / run), **extra)
        cfg = Config.from_dict(raw)
        batch = build_dataset(cfg, "train").get_batch(
            np.arange(batch_size), rng=np.random.default_rng(DDP_SEED))
        ddp[run] = (raw, batch, n_steps)
        torch.cuda.reset_peak_memory_stats()
        one[run] = _ddp_steps(raw, batch, n_steps, None)
        one[run].update(model=model, peak_gib=torch.cuda.max_memory_allocated()
                        / 2**30)
        if _f64_loss_run(raw):
            one[run]["loss_f64"] = _first_loss_f64(raw, batch, None)
        if raw.get("distribution_loss") == "MMD":
            one[run]["fault"] = _half_batch_grads(raw, batch)
            one[run]["fault_kind"] = "MMD over each rank's rows alone"
            continue
        if model in DDP_NO_BATCHNORM:
            one[run]["halves"] = _half_batch_grads(raw, batch)
        one[run]["fault"] = _fault_grads(raw, batch)
        one[run]["fault_kind"] = "one process on rank 0's rows"
    torch.cuda.empty_cache()
    return ddp, one


def _fault_grads(raw, batch, ranks=2):
    """The planted fault the DDP gradient bound must catch: one process's
    first-step gradient on rank 0's rows alone (the first 1/``ranks`` of
    the global batch, drawn and normalised on its own), what a rank steps
    on when the gradients are not averaged and BatchNorm sees only its
    rows. Built without the sharding code."""
    half = raw["batch_size"] // ranks
    rows = {k: v[:half] if getattr(v, "ndim", 0) else v
            for k, v in batch.items()}
    return _ddp_steps(dict(raw, batch_size=half), rows, 1, None)["grads"]


def _ddp_compare(run, raw, one, two, n_steps, halves=None):
    """The DDP run against one process on the global batch: the first
    loss, the first step's gradient (over the model's largest gradient
    entry) and the planted fault's (``_fault_grads``) read the same way,
    its running statistics, each final state tensor's largest difference
    over its largest entry, the most any entry moved apart (Adam's
    normalised step moves an entry by about lr); with ``halves``
    (``_half_batch_grads``) the first step's gradient against the ranks'
    own computation in one process."""
    gmax = max(float(np.abs(g).max()) for g in one["grads"].values())

    def grad_err(ref, got=two["grads"], keys=None):
        """Over the model's largest entry, or over ``keys``' largest."""
        top = gmax if keys is None else max(
            float(np.abs(ref[k]).max()) for k in keys)
        return max(float(np.abs(ref[k] - got[k]).max())
                   for k in (ref if keys is None else keys)) / top

    running_1 = max((float(np.abs(v - two["running_1"][k]).max())
                     / max(float(np.abs(v).max()), 1e-30)
                     for k, v in one["running_1"].items()), default=0.0)
    rel, worst, move = {}, ("", 0.0), 0.0
    for k, a in one["state"].items():
        d = float(np.abs(a.astype(np.float64) - two["state"][k]).max())
        r = d / max(float(np.abs(a).max()), 1e-30)
        rel[k] = r
        if r > worst[1]:
            worst = (k, r)
        if k in one["grads"]:
            move = max(move, d)
    running = [r for k, r in rel.items() if "running" in k]
    return {"phase": "parallel_ddp", "run": run,
            "config": f"cfgs/{one['model']}.yaml", "ranks": 2, "global_batch": raw["batch_size"],
            "steps": n_steps, "losses_one": one["losses"],
            "losses_ddp": two["losses"],
            "first_loss_rel": abs(two["losses"][0] - one["losses"][0])
            / abs(one["losses"][0]),
            "first_grad_err_over_max_grad": grad_err(one["grads"]),
            "fault_grad_err_over_max_grad": grad_err(one["grads"],
                                                     one["fault"]),
            "fault": one["fault_kind"],
            "grad_bound": DDP_GRAD_BOUND,
            "running_stats_after_step_1_worst_rel": running_1,
            "halves_grad_err_over_max_grad":
                None if halves is None else grad_err(halves),
            "halves_bit_equal": None if halves is None else all(
                halves[k].tobytes() == two["grads"][k].tobytes()
                for k in halves),
            "state_worst_rel": {"tensor": worst[0], "rel": worst[1]},
            "running_stats_final_worst_rel": max(running, default=0.0),
            "param_move_apart_max": move, "lr": raw["lr"],
            "replicas_equal": two["replicas_equal"],
            "steps_per_s_one": one["steps_per_s"],
            "steps_per_s_ddp": two["steps_per_s"],
            "launches": two["launches"], "peak_gib_ranks": two["peak_gib"],
            **_f64_loss_reads(one, two),
            **_latent_reads(raw, one, two, grad_err)}


def _f64_loss_reads(one, two):
    """With the f64 first step (``_first_loss_f64``): its DDP loss against
    one process's, and each f32 first loss against one process's f64 loss
    (the f32 model's own rounding)."""
    if "loss_f64" not in one:
        return {}
    ref = one["loss_f64"]
    return {"losses_f64": [ref, two["loss_f64"]],
            "first_loss_rel_f64": abs(two["loss_f64"] - ref) / abs(ref),
            "loss_bound_f64": DDP_LOSS_REL_F64,
            "one_f32_vs_f64_rel": abs(one["losses"][0] - ref) / abs(ref),
            "ddp_f32_vs_f64_rel": abs(two["losses"][0] - ref) / abs(ref)}


def _latent_reads(raw, one, two, grad_err):
    """Under MMD, the first gradient of VRCNet's latent path (posterior,
    prior), where the distribution loss acts, over that path's largest
    entry: the DDP run's and the planted fault's (MMD over each rank's
    rows alone)."""
    if raw.get("distribution_loss") != "MMD":
        return {}
    keys = [k for k in one["grads"]
            if k.split(".")[0] in ("post1", "post2", "prior")]
    return {"distribution_loss": "MMD",
            "latent_grad_err_over_its_max": grad_err(one["grads"],
                                                     keys=keys),
            "fault_latent_grad_err_over_its_max": grad_err(
                one["grads"], one["fault"], keys),
            "latent_grad_bound": DDP_MMD_LATENT_BOUND}


# the DDP runs whose ranks need nothing of each other in the forward
DDP_NO_BATCHNORM = ("vrcnet",)
# the seed of the DDP runs' batches (DeepGMR's poses are drawn per batch)
DDP_SEED = 0
# the first loss of a BatchNorm run, DDP against one process, held in f64
# (the CPU tests' choice for these models): at its seeded initialisation
# DeepGMR's f32 loss in one process sits up to 5.4e-5 from its f64 value
# (the mixture means, all near the centroid, cancel), and DDP against one
# process in f32 read up to 1.6e-5 on an H100; in f64 they read at most
# 1.4e-14 there (scripts/ddp_loss_rounding.py, six seeds)
DDP_LOSS_REL_F64 = 1e-10
# the first DDP gradient against one process on the whole batch, over the
# model's largest gradient entry: above f32 rounding through the card's
# atomics, kNN near-ties and the SVD heads (DeepGMR read 2.2e-3 and 5.2e-3
# on an H100), below the planted fault (``_fault_grads``: 0.29 and 1.2),
# which the phase checks exceeds it
DDP_GRAD_BOUND = 5e-2
# under distribution_loss MMD the planted fault (each rank's MMD over its
# own rows) moves the latent path's gradient alone: at the CPU tests' size
# 7.8e-3 of the model's largest entry, 4.3e-2 of the latent path's; the
# path's own bound sits between that and f32 summation order
DDP_MMD_LATENT_BOUND = 1e-2


def _check_ddp(ddp, one, two):
    """Each DDP run of ``ddp`` (``_ddp_inputs``) read against its
    one-process side ``one`` (``_ddp_compare``) and emitted; the run fails
    where one is outside its bounds. Returns the records by run."""
    out = {}
    for run, (raw, _, n_steps) in ddp.items():
        rec = _ddp_compare(run, raw, one[run], two[run], n_steps,
                           one[run].get("halves"))
        rec["peak_gib_one"] = one[run]["peak_gib"]
        emit(rec)
        out[run] = rec
        # the first gradient against one process on the whole batch,
        # under the bound that the planted fault exceeds; exact where
        # the ranks' work can be redone in one process (no BatchNorm:
        # up to the atomics' order), the global batch's BatchNorm
        # statistics to f32 sums' rounding; the states after 2 steps
        # are read, not bounded: Adam's normalised step moves a
        # near-zero gradient's entry by ~lr
        # under MMD the ranks' forwards meet in the gather, and the
        # planted fault moves the latent path: its bound there
        # a BatchNorm run's first loss is held in f64
        # (``DDP_LOSS_REL_F64``), the others' in f32
        loss_held = (rec["first_loss_rel_f64"] <= DDP_LOSS_REL_F64
                     if "first_loss_rel_f64" in rec
                     else rec["first_loss_rel"] <= 1e-5)
        if "distribution_loss" in rec:
            held = (rec["latent_grad_err_over_its_max"]
                    <= DDP_MMD_LATENT_BOUND
                    < rec["fault_latent_grad_err_over_its_max"])
            caught = True
        else:
            held = (rec["halves_grad_err_over_max_grad"] <= 1e-5
                    if one[run]["model"] in DDP_NO_BATCHNORM
                    else rec["running_stats_after_step_1_worst_rel"]
                    <= 1e-4)
            caught = (DDP_GRAD_BOUND
                      < rec["fault_grad_err_over_max_grad"])
        if not (held and caught and rec["replicas_equal"]
                and rec["first_grad_err_over_max_grad"] <= DDP_GRAD_BOUND
                and loss_held and np.isfinite(rec["losses_ddp"]).all()):
            fail(f"parallel: DDP {run} outside its bounds: {rec}")
    return out


def phase_parallel(refs, rescore_ref):
    """torch.distributed on the card(s). ``refs``: phase ``main_path``'s
    one-process rows (houv_fast at 100 pairs, houv.yaml at 4);
    ``rescore_ref``: phase ``quality``'s houv_rescore run at 8 pairs.
    1. NCCL over every visible card (at most 4; one on a one-card
       machine): all_reduce, broadcast and the exact row gather, and the
       100-pair houv_fast batch through ``sharded_houv_solve``, bit-equal
       to the one-process rows;
    2. two ranks sharing card 0 over gloo (CUDA tensors): houv_fast at 100
       pairs through ``test_main`` (pairs/s beside one process's), the
       (data 1 x restart 2) split of houv.yaml's 4 pairs, houv_rescore at
       8 pairs with log/'s classifier (picks, ``n_override``, logits), all
       bit-equal to one process; DDP steps of vrcnet.yaml and deepgmr.yaml
       (batch 32, 16 a rank, 2 steps; VRCNet as its yaml has it and under
       MMD) against one process on the global batch, DeepGMR's first loss
       in f64 beside its f32 run;
    3. the CLI: ``n_devices`` the visible cards runs; one more takes the
       cards there are, its rows bit-equal.
    Returns the launches of each run, for the ``kernels`` line."""
    t_phase = time.perf_counter()
    one_process = os.environ.pop("WORLD_SIZE", None)
    try:
        return _phase_parallel(refs, rescore_ref, t_phase)
    finally:
        if one_process is not None:
            os.environ["WORLD_SIZE"] = one_process


def _phase_parallel(refs, rescore_ref, t_phase):
    from houv_tpu_torch.parallel.distributed import launch
    from houv_tpu_torch.train.cli import test_main

    cards = torch.cuda.device_count()
    world = min(cards, 4)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        workdir = Path(tmp)
        paths = {name: sweep_cfg(name, n, workdir)[0]
                 for name, n in PARALLEL_PAIRS.items()}
        # 1. NCCL
        t0 = time.perf_counter()
        nccl = launch(_nccl_rank, world, "cuda",
                      args=(str(paths["houv_fast.yaml"]),
                            PARALLEL_PAIRS["houv_fast.yaml"]))
        ref = refs["houv_fast.yaml:100"]
        rec = {"phase": "parallel_nccl", "world": nccl["world"],
               "cards": cards, "backend": nccl["backend"],
               "all_reduce": nccl["all_reduce"],
               "broadcast": nccl["broadcast"],
               "gather_bits": nccl["gather_bits"],
               "gather_path": nccl["gather_path"],
               "sweep_bit_equal": _bits_equal(nccl["results"],
                                              ref["results"]),
               "n_retry": [nccl["n_retry"], ref["n_retry"]],
               "solve_s": nccl["seconds"],
               "job_s": time.perf_counter() - t0}
        emit(rec)
        if not (rec["backend"] == "nccl" and rec["all_reduce"]
                and rec["broadcast"] and rec["gather_bits"]
                and rec["gather_path"] == "all_gather"
                and rec["sweep_bit_equal"]
                and nccl["n_retry"] == ref["n_retry"]):
            fail(f"parallel: NCCL checks failed: {rec}")
        checks = [rec]

        # 2. two ranks on card 0 over gloo, and one process for the DDP
        ddp, one = _ddp_inputs(workdir)
        t0 = time.perf_counter()
        two = launch(_gloo_rank, 2, "cuda", backend="gloo",
                     args=(paths, ddp))
        job_s = time.perf_counter() - t0
        launches = {}
        for name, key in (("houv_fast.yaml", "houv_fast.yaml:100"),
                          ("houv.yaml", "houv.yaml:4")):
            got, ref = two[name], refs[key]
            rec = {"phase": "parallel_gloo", "config": f"cfgs/{name}",
                   "ranks": 2, "layout": ("data 2" if name == "houv_fast.yaml"
                                          else "data 1 x restart 2"),
                   "pairs": PARALLEL_PAIRS[name],
                   "bit_equal": _bits_equal(got["results"], ref["results"]),
                   "n_retry": [got["n_retry"], ref["n_retry"]],
                   "seconds": got["seconds"], "launches": got["launches"]}
            if name == "houv_fast.yaml":
                rec.update(pairs_per_s_two_ranks=100 / got["seconds"],
                           pairs_per_s_one=ref["pairs_per_s"],
                           peak_gib_ranks=got["peak_gib"])
            if not rec["bit_equal"]:
                diff = _agree_deg(got["results"], ref["results"])
                rec.update(max_rot_diff_deg=float(diff.max()),
                           rows_differing=int((got["results"]
                                               != ref["results"]).any(
                                                   (1, 2)).sum()))
            emit(rec)
            checks.append(rec)
            launches[name] = got["launches"]
            if not rec["bit_equal"] or got["n_retry"] != ref["n_retry"]:
                fail(f"parallel: {name} over two ranks differs: {rec}")
        got = two["houv_rescore.yaml"]
        diag, ref_diag = got["rescore"], rescore_ref["rescore"]
        logit_err = float(np.abs(diag["cand_logits"].astype(np.float64)
                                 - ref_diag["cand_logits"]).max())
        rec = {"phase": "parallel_gloo", "config": "cfgs/houv_rescore.yaml",
               "ranks": 2, "layout": "data 2",
               "pairs": PARALLEL_PAIRS["houv_rescore.yaml"],
               "bit_equal": _bits_equal(got["results"],
                                        rescore_ref["results"]),
               "picks_equal": _bits_equal(diag["pick"], ref_diag["pick"]),
               "n_override": [got["n_override"], rescore_ref["n_override"]],
               "n_retry": [got["n_retry"], rescore_ref["n_retry"]],
               "max_logit_diff": logit_err,
               "logit_bound_card_vs_cpu_pr15": 9.7e-4,
               "seconds": got["seconds"], "launches": got["launches"]}
        emit(rec)
        checks.append(rec)
        launches["houv_rescore.yaml"] = got["launches"]
        if not (rec["picks_equal"]
                and got["n_override"] == rescore_ref["n_override"]
                and got["n_retry"] == rescore_ref["n_retry"]
                and logit_err <= 9.7e-4):
            fail(f"parallel: the sharded rescored solve differs: {rec}")
        for run, rec in _check_ddp(ddp, one, two).items():
            checks.append(rec)
            launches[f"ddp:{run}"] = two[run]["launches"]

        # 3. the CLI over the visible cards; one more takes the cards there
        # are (as the JAX package takes the first n devices), its rows
        # bit-equal
        from houv_tpu_torch.train.submission import read_results_h5

        raw = yaml.safe_load(paths["houv_fast.yaml"].read_text())
        raw.update(synthetic_size=16, batch_size=16 // world * world,
                   n_devices=world)
        cli_path = workdir / "houv_fast_cli.yaml"
        cli_path.write_text(yaml.safe_dump(raw))
        out = test_main(["-c", str(cli_path)])
        rows = read_results_h5(out["results_h5"])
        raw["n_devices"] = cards + 1
        cli_path.write_text(yaml.safe_dump(raw))
        more = test_main(["-c", str(cli_path)])
        rec = {"phase": "parallel_cli", "n_devices": world,
               "pairs": out["n_pairs"], "n_retry": out["n_retry"],
               "n_devices_above_the_cards": cards + 1,
               "pairs_above": more["n_pairs"],
               "n_retry_above": more["n_retry"],
               "rows_bit_equal": _bits_equal(
                   rows, read_results_h5(more["results_h5"]))}
        emit(rec)
        checks.append(rec)
        if not (rec["rows_bit_equal"] and more["n_pairs"] == out["n_pairs"]
                and more["n_retry"] == out["n_retry"]):
            fail(f"parallel: n_devices {cards + 1} on {cards} cards: {rec}")
    rec = {"phase": "parallel_summary", "card": card_line(),
           "checks": len(checks), "gloo_job_s": job_s,
           "phase_s": time.perf_counter() - t_phase}
    emit(rec)
    return launches


class _Count:
    """One kernel's launch count, an attribute of its wrapper."""

    def __init__(self, fn, attr="launches"):
        self.fn, self.attr = fn, attr

    @property
    def launches(self):
        return getattr(self.fn, self.attr)

    @launches.setter
    def launches(self, value):
        setattr(self.fn, self.attr, value)


def _completion_counters():
    from houv_tpu_torch.ops.chamfer import chamfer_indices, nn_select
    from houv_tpu_torch.ops.emd import emd_auction_with_stats
    from houv_tpu_torch.ops.grouping import knn_indices
    from houv_tpu_torch.ops.sampling import furthest_point_sample
    from houv_tpu_torch.ops.scatter import gather_rows_kernel, scatter_add

    return {"knn": _Count(knn_indices),
            "knn_wide": _Count(knn_indices, "wide_launches"),
            "fps": _Count(furthest_point_sample),
            "nn_both": _Count(chamfer_indices),
            "emd": _Count(emd_auction_with_stats),
            "scatter_add": _Count(scatter_add),
            "nn_select": _Count(nn_select),
            "gather_rows": _Count(gather_rows_kernel),
            "fps_large": _Count(furthest_point_sample, "large_launches"),
            "emd_large": _Count(emd_auction_with_stats, "large_launches"),
            "fps_global": _Count(furthest_point_sample, "global_launches"),
            "emd_global": _Count(emd_auction_with_stats, "global_launches")}


def _zero(counters):
    for c in counters.values():
        c.launches = 0


def _read(counters):
    """The counts that are not 0."""
    return {k: c.launches for k, c in counters.items() if c.launches}


def _times(per_unit, units):
    return {k: v * units for k, v in per_unit.items()}


def _sum(*counts):
    keys = sorted({k for c in counts for k in c})
    total = {k: sum(c.get(k, 0) for c in counts) for k in keys}
    return {k: v for k, v in total.items() if v}


# Launches per batch of each model at its config's width, derived from the
# code. ``test``: one forward. ``val`` adds the chamfer metric (and one
# auction with eval_emd). ``train``: one step with ``loss: cd``.
# vrcnet: 14 knn (8 graphs, 3 pooling, 3 three-NN); fps: the decoder's
# 3-level pyramid and coarse_high 3072 -> 2048, in training also the gt's;
# 4 calc_cd (one nn_both forward and, the gt needing no gradient, one
# scatter backward each).
# ecg: 4 DenseConv graphs on knn_wide; knn for 3 poolings and 3 three-NN;
# fps for 3 poolings and the trim 3072 -> 2048; a train step adds the two
# uniform losses (5 fps and 5 knn each) and 2 calc_cd.
# pcn: no kernel in its forward; 2 calc_cd a train step.
# vrcnet_knn: 10 knn (4 graphs at k 16, 3 pooling, 3 three-NN) and 4 fps
# (the U-Net's 3-level pyramid over coarse + input, fine 3072 -> native
# 2048) a forward; 3 calc_cd a train step (coarse, fine, native; fine's
# counted twice in the loss), the val metric on fine.
# transformer: 1 fps a forward (2048 -> 256 latent points), 1 calc_cd a
# train step, the val metric.
# dcp, deepgmr, idam: 1 knn a cloud a forward (DCP's DGCNN graph at k 20,
# DeepGMR's RRI at k 21, IDAM's GNN graph at k 12), whatever the prefix;
# IDAM's train-time nearest neighbour is a dense argmin, no kernel.
LAUNCHES = {
    "vrcnet": {"test": {"knn": 14, "fps": 4},
               "val": {"knn": 14, "fps": 4, "nn_both": 1},
               "train": {"knn": 14, "fps": 5, "nn_both": 4,
                         "scatter_add": 4}},
    "ecg": {"test": {"knn_wide": 4, "knn": 6, "fps": 4},
            "val": {"knn_wide": 4, "knn": 6, "fps": 4, "nn_both": 1},
            "train": {"knn_wide": 4, "knn": 16, "fps": 14, "nn_both": 2,
                      "scatter_add": 2}},
    "pcn": {"test": {}, "val": {"nn_both": 1},
            "train": {"nn_both": 2, "scatter_add": 2}},
    "vrcnet_knn": {"test": {"knn": 10, "fps": 4},
                   "val": {"knn": 10, "fps": 4, "nn_both": 1},
                   "train": {"knn": 10, "fps": 4, "nn_both": 3,
                             "scatter_add": 3}},
    "transformer": {"test": {"fps": 1}, "val": {"fps": 1, "nn_both": 1},
                    "train": {"fps": 1, "nn_both": 1, "scatter_add": 1}},
    **{m: {run: {"knn": 2} for run in ("test", "val", "train")}
       for m in ("dcp", "deepgmr", "idam")},
}


def _model_cfg(tmp, model, n_clouds, **extra):
    """A temp copy of cfgs/<model>.yaml over an n-cloud synthetic split,
    ``extra`` overriding its keys."""
    with open(REPO / "cfgs" / f"{model}.yaml") as f:
        raw = yaml.safe_load(f)
    raw.update(synthetic_size=n_clouds, work_dir=str(tmp), **extra)
    path = Path(tmp) / (f"{model}_{n_clouds}_" + "_".join(
        f"{k}{v}" for k, v in sorted(extra.items()) if k != "load_model")
        + ("_loaded" if "load_model" in extra else "") + ".yaml")
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def run_completion(tmp, n_test, n_val, counters, model="vrcnet",
                   eval_emd=True):
    """``test_main`` on cfgs/<model>.yaml over an n_test-cloud test split,
    then ``validate`` over an n_val-cloud val split, each with the counts
    set to 0 just before it and read just after, and held against the
    counts derived from the code."""
    from houv_tpu_torch.train.cli import build_dataset, test_main
    from houv_tpu_torch.train.config import load_config
    from houv_tpu_torch.train.harness import CompletionTrainer
    from houv_tpu_torch.train.submission import read_results_h5

    config = f"cfgs/{model}.yaml"
    _zero(counters)
    res = test_main(["-c", _model_cfg(tmp, model, n_test)])
    test_launches = _read(counters)
    results = read_results_h5(res["results_h5"])
    if results.shape != (n_test, 2048, 3) or not np.isfinite(results).all():
        fail(f"{model} results {results.shape} not finite ({n_test}, 2048, "
             "3)")
    if not os.path.getsize(res["submission"]):
        fail(f"{model}: empty submission zip")
    test = {"phase": "completion", "config": config,
            "run": "test_main", "clouds": res["n_clouds"], "batch": 32,
            "seconds": res["seconds"],
            "clouds_per_s": res["n_clouds"] / res["seconds"],
            "result_abs_max": float(np.abs(results).max()),
            "launches": test_launches,
            "expected_launches": _times(LAUNCHES[model]["test"],
                                        n_test // 32)}
    emit(test)

    cfg = load_config(_model_cfg(tmp, model, n_val, eval_emd=eval_emd))
    trainer = CompletionTrainer(cfg)
    trainer.init_state()
    val_ds = build_dataset(cfg, "val")
    torch.cuda.synchronize()
    _zero(counters)
    t0 = time.perf_counter()
    metrics = trainer.validate(val_ds)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    per_val = dict(LAUNCHES[model]["val"], **({"emd": 1} if eval_emd else {}))
    val = {"phase": "completion", "config": config, "eval_emd": eval_emd,
           "run": "validate", "clouds": len(val_ds), "seconds": seconds,
           "clouds_per_s": len(val_ds) / seconds, "metrics": metrics,
           "launches": _read(counters),
           "expected_launches": _times(per_val, n_val // 32)}
    emit(val)
    want = {"cd_p", "cd_t", "f1"} | ({"emd"} if eval_emd else set())
    if not all(np.isfinite(v) for v in metrics.values()) \
            or set(metrics) != want:
        fail(f"{model} validate metrics {metrics}")
    for run in (test, val):
        if run["launches"] != run["expected_launches"]:
            fail(f"{model} {run['run']} launches {run['launches']}, "
                 f"expected {run['expected_launches']}")
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
        # validate's first batch, on which the kernels line times emd
        batch = val_ds.get_batch(np.arange(32))
        emd_inputs = (trainer.predict_batch(batch, step=0),
                      torch.as_tensor(batch["gt"], device="cuda"))
        del trainer
        run_completion(tmp, 512, 128, counters)
    return {"test": test, "validate": val, "emd_inputs": emd_inputs}


def phase_completion_models():
    """PCN and ECG at the full width of cfgs/pcn.yaml and cfgs/ecg.yaml
    (batch 32, 2048 points, 1024 coarse, ECG's encoder on 3072 points,
    f32): ``test_main`` over 64 test clouds and ``validate`` with
    ``eval_emd`` over 64 val clouds, each with its launch counts held
    against the counts derived from the code; then the sweep over 512
    clouds and ``validate`` without ``eval_emd`` over 128 for throughput.
    Then ``test_main`` on cfgs/vrcnet.yaml with a 4096-point ground truth
    from 2048-point scans (``num_points: 4096, num_input: 2048``) and no
    local folding, 32 clouds, so that both of VRCNet's ``EFExpansion``s run:
    the decoder's 3072 points of 256 channels are doubled, and after the FPS
    to 2048 the 64-channel coarse features are doubled too."""
    from houv_tpu_torch.train.cli import test_main
    from houv_tpu_torch.train.submission import read_results_h5

    counters = _completion_counters()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for model in ("pcn", "ecg"):
            test, val, _, _ = run_completion(tmp, 64, 64, counters, model)
            run_completion(tmp, 512, 128, counters, model, eval_emd=False)
            out[model] = {"test": test, "validate": val}
            torch.cuda.empty_cache()

        # MVP's 4096-point ground truth with its 2048-point partial scans
        _zero(counters)
        res = test_main(["-c", _model_cfg(
            tmp, "vrcnet", 32, num_points=4096, num_input=2048,
            local_folding=False)])
        launches = _read(counters)
        fine = read_results_h5(res["results_h5"])
        expected = dict(LAUNCHES["vrcnet"]["test"], knn_wide=2)
        emit({"phase": "completion", "config": "cfgs/vrcnet.yaml",
              "run": "test_main", "num_points": 4096, "num_input": 2048,
              "local_folding": False, "clouds": res["n_clouds"],
              "seconds": res["seconds"], "result": list(fine.shape),
              "launches": launches, "expected_launches": expected,
              "efexpansion_shapes": [[32, 3072, 256], [32, 2048, 64]]})
        if fine.shape != (32, 4096, 3) or not np.isfinite(fine).all() \
                or launches != expected:
            fail(f"vrcnet with EFExpansion: result {fine.shape}, "
                 f"launches {launches}, expected {expected}")
        out["vrcnet_efexpansion"] = launches
        torch.cuda.empty_cache()
    return out


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
        self.kept, self.flips = [], 0
        # the wrappers count launches on whatever holds their name
        self.launches = self.wide_launches = 0
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


class _EmdInputs(_Picks):
    """A ``_Picks`` for K7's launch (``ops/emd.py:_emd_cuda``) that keeps
    the inputs of its first ``limit`` calls, (x1, x2, eps, iters)."""

    def __init__(self, limit):
        from houv_tpu_torch.ops import emd

        super().__init__(emd._emd_cuda)
        self.limit = limit

    def __call__(self, x1, x2, eps, iters, *args, **kwargs):
        if len(self.kept) < self.limit:
            self.kept.append((x1.clone(), x2.clone(), eps, iters))
        return self.fn(x1, x2, eps, iters, *args, **kwargs)


class _FpsLargeInputs(_Picks):
    """A ``_Picks`` for K2's launch (``ops/sampling.py:_fps_cuda``) that
    keeps the (B, N, K) of each launch past K2's limit (``csrc/fps_large.cu``
    or ``csrc/fps_global.cu``) in ``shapes``, and in ``kept`` the first
    cloud and k at each shape."""

    def __init__(self):
        from houv_tpu_torch.kernels import load
        from houv_tpu_torch.ops import sampling

        super().__init__(sampling._fps_cuda)
        self.max_points = load().houv_fps_max_points()
        self.shapes = []

    def __call__(self, points, k):
        from houv_tpu_torch.ops import sampling

        if points.shape[1] > self.max_points:
            shape = [*points.shape[:2], k]
            if shape not in self.shapes:
                self.kept.append((points.clone(), k))
            self.shapes.append(shape)
        return self.fn(points, k)


class _Census(_Picks):
    """A ``_Picks`` for ``furthest_point_sample`` that keeps the (B, N, K)
    of every call in ``kept``, for the census of K2's shapes."""

    def __call__(self, points, k, *args, **kwargs):
        self.kept.append([*points.shape[:2], k])
        return self.fn(points, k, *args, **kwargs)


def _replay_geometry(model, picks):
    """A hook on VRCNet's U-Net encoder that keeps the geometry (kNN
    graphs, pooling and unpooling picks) it is given in ``seen``; with
    ``picks`` (another run's) it counts the entries that differ and hands
    the encoder ``picks['geometry']`` instead. Returns (seen, handle)."""
    seen = {}

    def hook(_, args):
        seen["geometry"] = args[1]
        if picks is None:
            return None
        seen["flips"] = _flips(args[1], picks["geometry"])
        return (args[0], _share_picks(args[1], picks["geometry"]), *args[2:])

    return seen, model.decoder.encoder.register_forward_pre_hook(hook)


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
    seen, handle = _replay_geometry(model, picks)
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


def _full_train_cfg(tmp, model="vrcnet", **extra):
    with open(REPO / "cfgs" / f"{model}.yaml") as f:
        raw = yaml.safe_load(f)
    raw.update(work_dir=str(tmp), **extra)
    path = Path(tmp) / (f"{model}_train_" + "_".join(
        f"{k}{v}" for k, v in sorted(extra.items()) if k != "load_model")
        + ("_loaded" if "load_model" in extra else "") + ".yaml")
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def _repeated_batch(tmp, n_steps, use_remat, model="vrcnet", **extra):
    """``n_steps`` train steps of cfgs/<model>.yaml on one repeated batch
    (the config's batch size: 32, vrcnet_knn's 16) at full width from the
    seeded initialisation: losses, steps/s, peak memory (after a first step
    outside the clock) and the kernels' launches. ``extra`` overrides keys
    of the config."""
    from houv_tpu_torch.train.cli import build_dataset
    from houv_tpu_torch.train.config import load_config
    from houv_tpu_torch.train.harness import CompletionTrainer

    cfg = load_config(_full_train_cfg(tmp, model, use_remat=use_remat,
                                      **extra))
    trainer = CompletionTrainer(cfg)
    trainer.init_state()
    bs = cfg.batch_size
    batch = build_dataset(cfg, "train").get_batch(
        np.arange(bs), rng=np.random.default_rng(0))
    counters = _completion_counters()
    _zero(counters)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    critic = []

    def step(i):
        loss = float(trainer.train_step(batch, 0, i))
        if trainer.critic is not None:
            critic.append(float(trainer.critic_loss))
        return loss

    losses = [step(0)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(1, n_steps):
        losses.append(step(i))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    rec = {"phase": "train_repeated_batch", "config": f"cfgs/{model}.yaml",
           "batch": bs, "use_remat": use_remat, "loss": cfg.loss,
           "steps": n_steps, "losses": losses,
           **({"critic_losses": critic} if critic else {}),
           "launches": _read(counters),
           "steps_per_s": (n_steps - 1) / seconds,
           "clouds_per_s": bs * (n_steps - 1) / seconds,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}
    emit(rec)
    del trainer
    torch.cuda.empty_cache()
    return rec


def run_train_main(tmp, model, **extra):
    """``train_main`` on cfgs/<model>.yaml at full width on the synthetic
    split (128 train clouds: 4 steps an epoch at batch 32; 64 val clouds: 2
    val batches an epoch; ``extra`` overrides keys of the config), two
    epochs, without ``use_remat``, the launch counts held against the
    counts derived from the code; then the checkpoint read back by a second
    trainer and by ``test_main`` with ``load_model`` over 64 clouds, both to
    bit-equal predictions."""
    from houv_tpu_torch.train.cli import build_dataset, test_main, train_main
    from houv_tpu_torch.train.config import load_config
    from houv_tpu_torch.train.harness import CompletionTrainer
    from houv_tpu_torch.train.submission import read_results_h5

    counters = _completion_counters()
    _zero(counters)
    torch.cuda.reset_peak_memory_stats()
    out = train_main(["-c", _full_train_cfg(tmp, model, nepoch=2, **extra)])
    torch.cuda.synchronize()
    launches = _read(counters)
    peak = torch.cuda.max_memory_allocated() / 2**30
    trainer = out["trainer"]
    bs = trainer.cfg.batch_size
    steps = len(out["losses"])
    val_batches = 2 * (len(build_dataset(trainer.cfg, "val")) // bs)
    expected = _sum(_times(LAUNCHES[model]["train"], steps),
                    _times(LAUNCHES[model]["val"], val_batches))
    net = trainer.model
    fresh = CompletionTrainer(trainer.cfg)
    fresh.init_state()
    still = sorted(n for (n, p), q in zip(net.named_parameters(),
                                          fresh.model.parameters())
                   if torch.equal(p, q))
    n_params = sum(1 for _ in net.parameters())
    moved = n_params - len(still)
    finite_grads = sum(int(p.grad is not None
                           and bool(torch.isfinite(p.grad).all()))
                       for p in net.parameters())
    # a selective-kernel fusion over one k (vrcnet_knn's knn_list of 16)
    # softmaxes a single branch: 1 whatever its squeeze and excite layers
    # say, so they get no gradient (in the JAX model too) and stay put
    constant = sorted(n for n, p in net.named_parameters()
                      if len(trainer.cfg.knn_list) == 1 and ".sk." in n
                      and (".squeeze." in n or ".excite." in n)
                      and not p.grad.any())
    del fresh

    cfg_loaded = _full_train_cfg(tmp, model, **dict(
        extra, synthetic_size=64, load_model=out["checkpoint"]))
    reloaded = CompletionTrainer(load_config(cfg_loaded))
    reloaded.init_state()
    test_ds = build_dataset(load_config(cfg_loaded), "test")
    first = test_ds.get_batch(np.arange(bs))
    pred = trainer.predict_batch(first, step=0)
    same_trainer = torch.equal(reloaded.predict_batch(first, step=0), pred)
    res = test_main(["-c", cfg_loaded])
    results = read_results_h5(res["results_h5"])
    same_sweep = np.array_equal(results[:bs], pred.cpu().numpy())
    del reloaded
    rec = {"phase": "train", "config": f"cfgs/{model}.yaml",
           "run": "train_main", "batch": bs, "use_remat": False,
           "epochs": 2, "steps": steps, "losses": out["losses"],
           "seconds": out["seconds"],
           "steps_per_s_with_validate_and_save": steps / out["seconds"],
           "peak_memory_gib": peak, "best": trainer.best,
           "launches": launches, "expected_launches": expected,
           "launches_per_step": LAUNCHES[model]["train"],
           "parameters": n_params, "parameters_moved": moved,
           "parameters_constant_by_construction": constant,
           "parameters_with_finite_grad": finite_grads,
           "checkpoint": os.path.basename(out["checkpoint"]),
           "checkpoint_entries": sorted(torch.load(
               out["checkpoint"], map_location="cpu", weights_only=True)),
           "checkpoint_files": sorted(os.listdir(out["log_dir"])),
           "reload_bit_equal": same_trainer,
           "test_main_load_model_bit_equal": same_sweep,
           "test_main_clouds": res["n_clouds"]}
    emit(rec)
    if steps < 8 or not np.isfinite(out["losses"]).all():
        fail(f"{model} train_main: {steps} steps, losses {out['losses']}")
    if launches != expected:
        fail(f"{model} train_main launches {launches}, expected {expected}")
    if still != constant or finite_grads != n_params:
        fail(f"{model} train_main: {moved} of {n_params} parameters moved "
             f"({still} did not), {finite_grads} have a finite gradient")
    if not (same_trainer and same_sweep):
        fail(f"{model}: the checkpoint does not reload to bit-equal "
             f"predictions (trainer {same_trainer}, test_main {same_sweep})")
    if results.shape != (64, *pred.shape[1:]) \
            or not np.isfinite(results).all():
        fail(f"{model} test_main with load_model: results {results.shape}")
    del trainer, net, pred
    torch.cuda.empty_cache()
    return rec


def _falling(rep, model):
    if not (np.isfinite(rep["losses"]).all()
            and rep["losses"][-1] < rep["losses"][0]):
        fail(f"{model}: {rep['steps']} steps on one batch did not lower the "
             f"loss: {rep['losses']}")
    want = _times(LAUNCHES[model]["train"], rep["steps"])
    if rep["loss"] == "cd" and rep["launches"] != want:
        fail(f"{model} repeated batch launches {rep['launches']}, expected "
             f"{want}")


def phase_train():
    """``train_main`` on cfgs/vrcnet.yaml (``run_train_main``), then the
    repeated-batch runs: 10 steps (the loss must fall), 3 with
    ``use_remat``, 4 with ``loss: emd``."""
    with tempfile.TemporaryDirectory() as tmp:
        rec = run_train_main(tmp, "vrcnet")
        rep = _repeated_batch(tmp, 10, False)
        _falling(rep, "vrcnet")
        remat = _repeated_batch(tmp, 3, True)
        # loss: emd. Per step four auctions (1024, 3072, 2048 and 2048
        # bidders for the gt's 2048 items), whose gradient needs no kernel;
        # the logged cd_t takes one nn_both and stays out of the backward.
        with _EmdInputs(4) as emd_inputs:
            emd = _repeated_batch(tmp, 4, False, loss="emd")
        want = {"emd": 16, "nn_both": 4, "fps": 20, "knn": 56}
        if emd["launches"] != want or not (
                np.isfinite(emd["losses"]).all()
                and emd["losses"][-1] < emd["losses"][0]):
            fail(f"loss: emd training: launches {emd['launches']}, expected "
                 f"{want}; losses {emd['losses']}")
    return {"train": rec, "repeated": rep, "remat": remat, "emd": emd,
            "emd_inputs": emd_inputs.kept}


def phase_train_models():
    """PCN and ECG training at the full width of their configs:
    ``train_main`` (``run_train_main``), then 10 steps on one repeated
    batch (the loss must fall; launches per step as derived from the code);
    for ECG also 3 steps with ``loss: emd`` (two auctions a step)."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for model in ("pcn", "ecg"):
            rec = run_train_main(tmp, model)
            rep = _repeated_batch(tmp, 10, False, model)
            _falling(rep, model)
            out[model] = {"train": rec, "repeated": rep}
        with _EmdInputs(2) as emd_inputs:
            emd = _repeated_batch(tmp, 3, False, "ecg", loss="emd")
        want = {"knn_wide": 12, "knn": 48, "fps": 42, "emd": 6}
        if emd["launches"] != want or not np.isfinite(emd["losses"]).all():
            fail(f"ecg loss: emd training: launches {emd['launches']}, "
                 f"expected {want}; losses {emd['losses']}")
        out["ecg"]["emd"] = emd
        out["ecg"]["emd_inputs"] = emd_inputs.kept
    return out


# vrcnet_knn at the parity tests' size (tests/test_torch_vrcnet_knn.py):
# both voxel levels run (grid 20 -> 10 sparse, dense from 5), the card
# against the port's CPU path, f32 and bf16
VRCNET_KNN_SMALL = dict(num_points=256, num_coarse=128, num_fine=384,
                        num_native=256, knn_list="8", pk=8, grid_size=20,
                        voxel_init_size=16, batch_size=2, synthetic_size=16)


def _vrcnet_knn_small_run(cfg, dev, picks=None):
    """The seeded small vrcnet_knn on ``dev``: one test batch's cloud, the
    val metrics, one train step's loss and the running statistics it
    moved, and the picks it made in that order (FPS, the chamfer matches,
    the U-Net's geometry). With ``picks`` (another run's) every pick is
    still computed here, by the kernels on the card, and counted where it
    differs, and the run goes on with the given ones."""
    from houv_tpu_torch.ops.chamfer import chamfer_indices
    from houv_tpu_torch.ops.sampling import furthest_point_sample
    from houv_tpu_torch.train.cli import build_dataset
    from houv_tpu_torch.train.harness import CompletionTrainer

    trainer = CompletionTrainer(cfg, dev)
    trainer.init_state()
    given = picks or {"fps": None, "matches": None, "geometry": None}
    seen = {"geometry": [], "flips": 0}

    def hook(_, args):
        seen["geometry"].append(args[1])
        if picks is None:
            return None
        ref = given["geometry"][len(seen["geometry"]) - 1]
        seen["flips"] += _flips(args[1], ref)
        return (args[0], _share_picks(args[1], ref), *args[2:])

    handle = trainer.model.decoder.encoder.register_forward_pre_hook(hook)
    with _Picks(furthest_point_sample, given["fps"]) as fps, \
            _Picks(chamfer_indices, given["matches"]) as matches:
        out = trainer.predict_batch(
            build_dataset(cfg, "test").get_batch(np.arange(2))).cpu()
        metrics = trainer.validate(build_dataset(cfg, "val"))
        batch = build_dataset(cfg, "train").get_batch(
            np.arange(2), rng=np.random.default_rng(0))
        loss = float(trainer.train_step(batch, 0, 0))
    handle.remove()
    stats = {n: b.cpu() for n, b in trainer.model.named_buffers()}
    return (out, metrics, loss, stats,
            {"fps": fps.kept, "matches": matches.kept,
             "geometry": seen["geometry"]},
            {"fps": fps.flips, "matches": matches.flips,
             "geometry": seen["flips"]})


def _vrcnet_knn_cpu_vs_card(compute_dtype, tol):
    """The seeded small vrcnet_knn on the CPU and on the card, the card on
    the CPU run's picks (its own counted where they differ: a near-tie
    that flips selects another point, which is another function): the
    test cloud (as point sets: the largest distance from a point of either
    cloud to the other), val's cd_p and cd_t (relative) and f1 (one point
    crossing the threshold moves it by 2 / points), one train step's loss
    (relative) and the running statistics it moved (relative to each
    tensor's largest entry)."""
    from houv_tpu_torch.train.config import Config

    with open(REPO / "cfgs" / "vrcnet_knn.yaml") as f:
        raw = yaml.safe_load(f)
    with tempfile.TemporaryDirectory() as tmp:
        raw.update(VRCNET_KNN_SMALL, compute_dtype=compute_dtype,
                   work_dir=tmp)
        cfg = Config.from_dict(raw)
        c_out, c_m, c_loss, c_st, picks, _ = _vrcnet_knn_small_run(cfg,
                                                                   "cpu")
        g_out, g_m, g_loss, g_st, _, flips = _vrcnet_knn_small_run(
            cfg, "cuda", picks)
    d = torch.cdist(c_out.double(), g_out.double())
    set_dist = float(torch.maximum(d.amin(-1).amax(-1),
                                   d.amin(-2).amax(-1)).max())
    diffs = {"cloud_set_dist": set_dist,
             "cd_p_rel": abs(c_m["cd_p"] - g_m["cd_p"]) / c_m["cd_p"],
             "cd_t_rel": abs(c_m["cd_t"] - g_m["cd_t"]) / c_m["cd_t"],
             "f1": abs(c_m["f1"] - g_m["f1"]),
             "loss_rel": abs(c_loss - g_loss) / abs(c_loss),
             "stats_rel": max(float((g_st[n] - c_st[n]).abs().max()
                                    / c_st[n].abs().max()) for n in c_st)}
    bounds = dict(tol, f1=2 / 256)
    rec = {"phase": "vrcnet_knn_reference", "compute_dtype": compute_dtype,
           "clouds": 2, "points": 256, "grid": 20,
           "outputs": list(g_out.shape), "loss_cpu": c_loss,
           "loss_cuda": g_loss, "metrics_cpu": c_m, "metrics_cuda": g_m,
           "card_picks_differing_from_cpu": flips, "diffs": diffs,
           "bounds": bounds}
    emit(rec)
    bad = {k: v for k, v in diffs.items() if not v <= bounds[k]}
    if bad or g_out.shape != (2, 384, 3):
        fail(f"vrcnet_knn ({compute_dtype}) on the card differs from the "
             f"CPU path: {bad}, output {list(g_out.shape)}")
    return rec


def _voxel_sites(model):
    """Sites kept and dropped at each strided sparse conv (mean over the
    batch's clouds), and the dense level's occupied share."""
    vox = model.voxel
    return {"strided_convs": [
        {"grid": s["grid"], "kept_mean": float(s["kept"].float().mean()),
         "dropped_mean": float(s["dropped"].float().mean()),
         "dropped_max": int(s["dropped"].max())} for s in vox.sites],
        "dense_13_occupancy": None if vox.dense_occupancy is None
        else float(vox.dense_occupancy.mean())}


def phase_vrcnet_knn():
    """vrcnet_knn (cfgs/vrcnet_knn.yaml: batch 16, bf16, grid 50, init
    128, the third voxel level dense at 13³):
    (a) the card against the port's CPU path at the parity tests' size, in
        f32 and in bf16 (``_vrcnet_knn_cpu_vs_card``);
    (b) at full width ``train_main`` (two epochs of four steps over a
        64-cloud synthetic split, validation and checkpoints, launches held
        to ``LAUNCHES``) and ``test_main`` with ``load_model``
        (``run_train_main``); 10 steps on one repeated batch (the loss
        must fall), with the sites kept and dropped at each strided sparse
        conv and the 13³ level's occupancy; one ``fused_cd`` forward, whose
        loss must equal the separate chamfers';
    (c) the sweep of cfgs/vrcnet_knn_extratest.yaml cut to 512 clouds,
        clouds/s with the first batch's warm-up apart;
    (d) one profiled train step (``phase_profile_train``), with K2's
        census."""
    from houv_tpu_torch.train.cli import build_dataset, test_main
    from houv_tpu_torch.train.config import load_config
    from houv_tpu_torch.train.harness import CompletionTrainer

    out = {"reference": [_vrcnet_knn_cpu_vs_card(
        None, {"cloud_set_dist": 1e-4, "cd_p_rel": 1e-4, "cd_t_rel": 1e-4,
               "loss_rel": 1e-4, "stats_rel": 1e-4}),
        _vrcnet_knn_cpu_vs_card(
        "bfloat16", {"cloud_set_dist": 2e-2, "cd_p_rel": 1e-2,
                     "cd_t_rel": 2e-2, "loss_rel": 1e-2, "stats_rel": 1e-2})]}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        out["train"] = run_train_main(tmp, "vrcnet_knn", synthetic_size=64)
        rep = _repeated_batch(tmp, 10, False, "vrcnet_knn")
        _falling(rep, "vrcnet_knn")
        out["repeated"] = rep

        cfg = load_config(_full_train_cfg(tmp, "vrcnet_knn"))
        trainer = CompletionTrainer(cfg)
        trainer.init_state()
        batch = build_dataset(cfg, "train").get_batch(
            np.arange(cfg.batch_size), rng=np.random.default_rng(0))
        model = trainer.model
        kw = dict(label=trainer._tensor(batch, "label").long(),
                  coords=trainer._tensor(batch, "coords"))
        x, gt = trainer._tensor(batch, "partial"), trainer._tensor(batch,
                                                                  "gt")
        losses = {}
        with torch.no_grad():
            for fused in (False, True):
                model.fused_cd = fused
                losses[fused] = float(model(
                    x, gt, "train", generator=torch.Generator().manual_seed(
                        3), **kw)["total_loss"])
            sites = _voxel_sites(model)
        model.fused_cd = False
        fused_rel = abs(losses[True] - losses[False]) / abs(losses[False])
        rec = {"phase": "vrcnet_knn", "run": "fused_cd",
               "loss_separate": losses[False], "loss_fused": losses[True],
               "rel_diff": fused_rel, "tolerance_rel": 1e-6, **sites}
        emit(rec)
        if not fused_rel <= 1e-6:
            fail(f"vrcnet_knn fused_cd loss {losses[True]} is not the "
                 f"separate chamfers' {losses[False]}")
        out["fused"] = rec
        del trainer, model
        torch.cuda.empty_cache()

        counters = _completion_counters()
        _zero(counters)
        res = test_main(["-c", _model_cfg(tmp, "vrcnet_knn_extratest", 512)])
        launches = _read(counters)
        from houv_tpu_torch.train.submission import read_results_h5
        results = read_results_h5(res["results_h5"])
        steady = res["seconds"] - res["first_batch_seconds"]
        expected = _times(LAUNCHES["vrcnet_knn"]["test"], 512 // 16)
        sweep = {"phase": "vrcnet_knn", "run": "test_main",
                 "config": "cfgs/vrcnet_knn_extratest.yaml",
                 "clouds": res["n_clouds"], "batch": 16,
                 "seconds": res["seconds"],
                 "first_batch_seconds": res["first_batch_seconds"],
                 "clouds_per_s": res["n_clouds"] / res["seconds"],
                 "clouds_per_s_after_first":
                     (res["n_clouds"] - 16) / steady,
                 "result": list(results.shape), "launches": launches,
                 "expected_launches": expected}
        emit(sweep)
        if results.shape != (512, 3072, 3) or not np.isfinite(results).all() \
                or launches != expected:
            fail(f"vrcnet_knn_extratest sweep: results {results.shape}, "
                 f"launches {launches}, expected {expected}")
        out["sweep"] = sweep
    torch.cuda.empty_cache()
    out["profile"] = phase_profile_train("vrcnet_knn")
    return out


LEARNED = ("dcp", "deepgmr", "idam")
TRANSFORMER_CKPT = str(REPO / "log" / "transformer_cd_debug"
                       / "best_cd_p_network.ckpt")
REG_METRICS = ("RotE", "transE", "MSE", "RMSE", "recall")
# the parity tests' sizes (tests/test_torch_{dcp,deepgmr,idam}.py): the
# model's keywords and the points a cloud
LEARNED_SMALL = {"dcp": (dict(emb_dims=32), 64),
                 "deepgmr": (dict(rri_size=20), 64),
                 "idam": (dict(descriptor_size=16), 96)}


def _learned_trainer(cfg):
    from houv_tpu_torch.train.cli import make_trainer

    trainer = make_trainer(cfg, "cuda")
    trainer.init_state()
    return trainer


def _registration_pair(seed, b, n):
    """(src, tgt, t_gt): n uniform points and their copy under a random
    rotation of 9 to 45 degrees and a shift, with noise 0.005 and a third
    of the target replaced by outliers (IDAM's sampling then has positives
    and negatives); t_gt (B, 4, 4) aligns src to tgt."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-0.5, 0.5, (b, n, 3))
    t_gt = np.tile(np.eye(4), (b, 1, 1))
    for i in range(b):
        axis = rng.standard_normal(3)
        axis /= np.linalg.norm(axis)
        ang = np.radians(rng.uniform(9.0, 45.0))
        k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]])
        t_gt[i, :3, :3] = np.eye(3) + np.sin(ang) * k \
            + (1 - np.cos(ang)) * (k @ k)
        t_gt[i, :3, 3] = rng.uniform(-0.25, 0.25, 3)
    tgt = src @ t_gt[:, :3, :3].transpose(0, 2, 1) + t_gt[:, None, :3, 3]
    tgt = tgt + 0.005 * rng.standard_normal(tgt.shape)
    tgt[:, 2 * n // 3:] = rng.uniform(-0.8, 0.8, (b, n - 2 * n // 3, 3))
    return [torch.tensor(a, dtype=torch.float32) for a in (src, tgt, t_gt)]


def _closeness_scores(model, gen):
    """IDAM's similarity blocks set to score a pair by 5·relu(3 −
    distance) through one channel, small draws elsewhere (as
    tests/test_torch_idam.py sets them): drawn blocks send every kept
    point to one target point, whose rank-1 Procrustes problem any
    rounding turns."""
    e = model.emb
    with torch.no_grad():
        for i in range(model.num_iters):
            for kind in ("sim1_", "sim2_"):
                blk = getattr(model, f"{kind}{i}")
                for p in blk.parameters():
                    p.copy_(1e-3 * torch.randn(p.shape, generator=gen))
                blk.bn0.weight.fill_(1.0)
                blk.bn0.running_var.fill_(1.0)
                blk.bn0.running_mean.zero_()
                if kind == "sim1_":
                    blk.fc0.weight[0, 2 * e] = -1.0
                    blk.bn0.running_mean[0] = -3.0
                    blk.out.weight[0, 0] = 1.0
                else:
                    blk.fc0.weight[0, 0] = 1.0
                    blk.out.weight[0, 0] = 5.0


def _learned_small_run(model_name, dev):
    """The seeded small model on ``dev``: the val outputs, the test
    transform, and one train forward's loss and the running statistics
    it moved (IDAM on Gumbel noise drawn on the host)."""
    from houv_tpu_torch.models import get_model
    from houv_tpu_torch.models.common import init_like_flax

    kw, n = LEARNED_SMALL[model_name]
    model = get_model(model_name, **kw)
    gen = torch.Generator().manual_seed(11)
    init_like_flax(model, gen)
    if model_name == "idam":
        _closeness_scores(model, gen)
    model.to(dev)
    src, tgt, t_gt = (a.to(dev) for a in _registration_pair(5, 2, n))
    extra = {}
    if model_name == "idam":
        g = torch.Generator().manual_seed(12)
        extra["gumbel"] = tuple(-torch.log(-torch.log(torch.rand(
            (2, n), generator=g).clamp_min(1e-30))).to(dev)
            for _ in range(2))
    with torch.no_grad():
        val = model(src, tgt, t_gt, prefix="val", train=False)
        test = model(src, tgt, None, prefix="test")
        train = model(src, tgt, t_gt, prefix="train", train=True, **extra)
    stats = {k: v.cpu() for k, v in model.named_buffers()}
    return ({k: v.cpu() for k, v in val.items()}, test.cpu(),
            float(train["loss"]), stats)


def _learned_cpu_vs_card(model_name):
    """The card against the port's CPU path at the parity tests' size:
    the val transform and errors (1e-4; the rotation error 1e-2 degrees,
    its arccos near 1), the test transform, a train forward's loss (1e-4
    relative) and the running statistics it moved (1e-4 of each tensor's
    largest entry)."""
    c_val, c_test, c_loss, c_st = _learned_small_run(model_name, "cpu")
    g_val, g_test, g_loss, g_st = _learned_small_run(model_name, "cuda")
    diffs = {"transform": float((c_val["transform"]
                                 - g_val["transform"]).abs().max()),
             "test_transform": float((c_test - g_test).abs().max()),
             "r_err_deg": float((c_val["r_err"] - g_val["r_err"]).abs()
                                .max()),
             "rmse": float((c_val["rmse"] - g_val["rmse"]).abs().max()),
             "loss_rel": abs(c_loss - g_loss) / max(abs(c_loss), 1e-12),
             "stats_rel": max((float((g_st[k] - c_st[k]).abs().max()
                                     / c_st[k].abs().max().clamp_min(1e-12))
                               for k in c_st), default=0.0)}
    bounds = {"transform": 1e-4, "test_transform": 1e-4, "r_err_deg": 1e-2,
              "rmse": 1e-4, "loss_rel": 1e-4, "stats_rel": 1e-4}
    rec = {"phase": "learned_reference", "model": model_name,
           "small": LEARNED_SMALL[model_name][0],
           "points": LEARNED_SMALL[model_name][1], "pairs": 2,
           "loss_cpu": c_loss, "loss_cuda": g_loss,
           "rmse_cuda": g_val["rmse"].tolist(), "diffs": diffs,
           "bounds": bounds}
    emit(rec)
    bad = {k: v for k, v in diffs.items() if not v <= bounds[k]}
    if bad:
        fail(f"{model_name} on the card differs from the CPU path: {bad}")
    return rec


def _transformer_cpu_vs_card():
    """The trained transformer (``TRANSFORMER_CKPT``) on 4 val clouds of
    the synthetic split at full width, on the card and on the CPU: the
    completions as point sets (the largest distance from a point of either
    cloud to the other, 1e-4) and point for point."""
    from houv_tpu_torch.train.cli import build_dataset
    from houv_tpu_torch.train.config import load_config
    from houv_tpu_torch.train.harness import CompletionTrainer

    with tempfile.TemporaryDirectory() as tmp:
        cfg = load_config(_model_cfg(tmp, "transformer", 16,
                                     load_model=TRANSFORMER_CKPT))
        batch = build_dataset(cfg, "val").get_batch(np.arange(4))
        outs = {}
        for dev in ("cpu", "cuda"):
            trainer = CompletionTrainer(cfg, dev)
            trainer.init_state()
            outs[dev] = trainer.predict_batch(batch).cpu()
    c, g = outs["cpu"], outs["cuda"]
    d = torch.cdist(c.double(), g.double())
    set_dist = float(torch.maximum(d.amin(-1).amax(-1),
                                   d.amin(-2).amax(-1)).max())
    rec = {"phase": "learned_reference", "model": "transformer",
           "checkpoint": TRANSFORMER_CKPT, "clouds": 4, "points": 2048,
           "max_set_dist": set_dist,
           "max_abs_diff": float((c - g).abs().max()), "tolerance": 1e-4}
    emit(rec)
    if not set_dist <= 1e-4 or g.shape != (4, 2048, 3):
        fail(f"the trained transformer on the card differs from the CPU "
             f"path: clouds {set_dist:.3g} apart, {list(g.shape)}")
    return rec


def run_learned_train(tmp, model):
    """``train_main`` on cfgs/<model>.yaml at full width over the
    synthetic split cut to 128 train and 64 val pairs (``nepoch`` 100 ->
    2: 8 steps, two validations of 2 batches), launches held to
    ``LAUNCHES``, the five ``best_<metric>_network.ckpt`` written; a last
    ``validate`` for the five meters; then ``test_main`` with
    ``load_model`` over 64 test pairs, its (64, 4, 4) transforms and
    launches held."""
    from houv_tpu_torch.train.cli import build_dataset, test_main, train_main
    from houv_tpu_torch.train.submission import read_results_h5

    counters = _completion_counters()
    _zero(counters)
    torch.cuda.reset_peak_memory_stats()
    out = train_main(["-c", _full_train_cfg(tmp, model, nepoch=2)])
    torch.cuda.synchronize()
    launches = _read(counters)
    peak = torch.cuda.max_memory_allocated() / 2**30
    trainer = out.pop("trainer")
    cfg = trainer.cfg
    steps = len(out["losses"])
    expected = _sum(_times(LAUNCHES[model]["train"], steps),
                    _times(LAUNCHES[model]["val"], 4))
    files = sorted(os.listdir(out["log_dir"]))
    want = {f"best_{m}_network.ckpt" for m in REG_METRICS} | {"network.ckpt"}
    best = dict(trainer.best)
    meters = trainer.validate(build_dataset(cfg, "val"), epoch=2)
    del trainer
    torch.cuda.empty_cache()
    _zero(counters)
    res = test_main(["-c", _full_train_cfg(tmp, model, synthetic_size=64,
                                           load_model=out["checkpoint"])])
    sweep_launches = _read(counters)
    results = read_results_h5(res["results_h5"])
    rot = results[:, :3, :3]
    ortho = float(np.abs(rot @ rot.transpose(0, 2, 1) - np.eye(3)).max())
    rec = {"phase": "learned", "config": f"cfgs/{model}.yaml",
           "run": "train_main", "batch": cfg.batch_size,
           "points": cfg.num_points, "epochs": 2,
           "steps": steps, "losses": out["losses"],
           "seconds": out["seconds"],
           "steps_per_s_with_validate_and_save": steps / out["seconds"],
           "peak_memory_gib": peak, "launches": launches,
           "expected_launches": expected, "best": best,
           "val_meters": meters,
           "checkpoint_files": files, "test_main_pairs": res["n_pairs"],
           "test_main_seconds": res["seconds"],
           "test_main_pairs_per_s": res["n_pairs"] / res["seconds"],
           "test_main_first_batch_seconds": res["first_batch_seconds"],
           "results": list(results.shape), "rotation_orthonormal_err": ortho,
           "test_main_launches": sweep_launches,
           "expected_test_main_launches": _times(LAUNCHES[model]["test"], 2)}
    emit(rec)
    if steps != 8 or not np.isfinite(out["losses"]).all():
        fail(f"{model} train_main: {steps} steps, losses {out['losses']}")
    if launches != expected or sweep_launches != rec[
            "expected_test_main_launches"]:
        fail(f"{model} launches: train_main {launches}, expected "
             f"{expected}; test_main {sweep_launches}")
    if not want <= set(files):
        fail(f"{model} train_main wrote {files}, not {sorted(want)}")
    if results.shape != (64, 4, 4) or not np.isfinite(results).all() \
            or ortho > 1e-4 or not all(np.isfinite(v)
                                       for v in meters.values()):
        fail(f"{model}: results {results.shape} (rotations {ortho:.3g} "
             f"from orthonormal), meters {meters}")
    return rec


def _learned_repeated(tmp, model, n_steps=10):
    """``n_steps`` train steps of cfgs/<model>.yaml at full width on one
    repeated batch of 32 pairs (IDAM's sampling repeated too: the step's
    generator stays that of step 0), from the seeded initialisation: the
    losses (they must fall), steps/s and pairs/s after a first step outside
    the clock, peak memory, launches held."""
    from houv_tpu_torch.train.cli import build_dataset
    from houv_tpu_torch.train.config import load_config

    cfg = load_config(_full_train_cfg(tmp, model))
    trainer = _learned_trainer(cfg)
    batch = build_dataset(cfg, "train").get_batch(
        np.arange(cfg.batch_size), rng=np.random.default_rng(0))
    counters = _completion_counters()
    _zero(counters)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses = [float(trainer.train_step(batch, 0, 0))]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(1, n_steps):
        losses.append(float(trainer.train_step(batch, 0, 0)))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    rec = {"phase": "learned", "config": f"cfgs/{model}.yaml",
           "run": "repeated_batch", "batch": cfg.batch_size,
           "points": cfg.num_points, "steps": n_steps, "losses": losses,
           "steps_per_s": (n_steps - 1) / seconds,
           "pairs_per_s": cfg.batch_size * (n_steps - 1) / seconds,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": _read(counters),
           "expected_launches": _times(LAUNCHES[model]["train"], n_steps)}
    emit(rec)
    del trainer
    torch.cuda.empty_cache()
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"{model}: {n_steps} steps on one batch did not lower the loss:"
             f" {losses}")
    if rec["launches"] != rec["expected_launches"]:
        fail(f"{model} repeated batch launches {rec['launches']}, expected "
             f"{rec['expected_launches']}")
    return rec


def _forward_ranges(model):
    """The forward parts whose device time the profile reads, by name:
    DCP's DGCNN and transformer (``attention``), DeepGMR's RRI features
    and PointNet, IDAM's GNN and its similarity convolutions; and the
    whole forward."""
    name = type(model).__name__
    if name == "DCP":
        parts = {"dgcnn": [model.emb_nn], "attention": [model.pointer]}
    elif name == "DeepGMR":
        parts = {"rri": [model, "_features"], "backbone": [model.backbone]}
    else:
        parts = {"gnn": [model.emb_nn],
                 "similarity": [getattr(model, f"{k}{i}")
                                for i in range(model.num_iters)
                                for k in ("sim1_", "sim2_", "weight_fc")]}
    return dict(parts, forward=[model])


def _wrap_ranges(model):
    """Wrap each part of ``_forward_ranges`` in a profiler range
    ``learned::<name>`` (the instance's own attribute, on this model
    only)."""
    from torch.profiler import record_function

    def wrap(fn, label):
        def run(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)
        return run

    for label, parts in _forward_ranges(model).items():
        if len(parts) == 2 and isinstance(parts[1], str):
            obj, attr = parts
            setattr(obj, attr, wrap(getattr(obj, attr), RANGE_PREFIX + label))
            continue
        for mod in parts:
            mod.forward = wrap(mod.forward, RANGE_PREFIX + label)


def phase_profile_learned(model):
    """torch.profiler over one train step of cfgs/<model>.yaml at full
    width (batch 32, 2048 points), after two warm-up steps: the kernels by
    device time, and the device time of the forward and of its parts
    (``_forward_ranges``; the backward's kernels run outside the
    ranges)."""
    from torch.profiler import ProfilerActivity, profile

    from houv_tpu_torch.train.cli import build_dataset
    from houv_tpu_torch.train.config import load_config

    with tempfile.TemporaryDirectory() as tmp:
        cfg = load_config(_full_train_cfg(tmp, model))
        trainer = _learned_trainer(cfg)
        _wrap_ranges(trainer.model)
        batch = build_dataset(cfg, "train").get_batch(
            np.arange(cfg.batch_size), rng=np.random.default_rng(0))
        for step in range(2):
            trainer.train_step(batch, 0, step)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer.train_step(batch, 0, 2)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    top = _profile_top(prof, wall_ms)
    # each range's device time, the kernels launched inside it (nested
    # ranges included), summed over its calls, from the host-side range
    # (the device-side one spans only the kernels outside nested ranges):
    # the forward's parts and the whole forward
    ranges = {}
    for ev in prof.events():
        if ev.name.startswith(RANGE_PREFIX) \
                and not str(ev.device_type).endswith("CUDA"):
            rec = ranges.setdefault(ev.name[len(RANGE_PREFIX):],
                                    {"device_ms": 0.0, "calls": 0})
            rec["device_ms"] += getattr(ev, "device_time_total", getattr(
                ev, "cuda_time_total", 0)) / 1e3
            rec["calls"] += 1
    fwd = ranges.get("forward", {}).get("device_ms", 0.0)
    for rec in ranges.values():
        rec["share_of_forward"] = rec["device_ms"] / max(fwd, 1e-9)
        rec["share_of_step"] = rec["device_ms"] / max(top["device_ms"],
                                                      1e-9)
    rec = {"phase": "profile", "config": f"cfgs/{model}.yaml",
           "pairs": cfg.batch_size, "run": "train_step", **top,
           "forward_ranges": ranges}
    emit(rec)
    del trainer
    torch.cuda.empty_cache()
    return rec


def phase_learned():
    """The learned models (no new kernel: K6 carries the registration
    models, K2, K1, K4 and K7 the transformer):
    (a) for each of cfgs/dcp.yaml, deepgmr.yaml and idam.yaml at full
        width (batch 32, 2048 points): ``train_main`` and ``test_main``
        with ``load_model`` (``run_learned_train``), then 10 steps on one
        batch (``_learned_repeated``: the loss must fall; steps/s, pairs/s,
        peak memory);
    (b) cfgs/transformer.yaml with the trained JAX checkpoint
        ``TRANSFORMER_CKPT``: ``test_main`` over 512 clouds, ``validate``
        with eval_emd over 64 (cd_p, cd_t, f1, emd and the auction's
        rounds on trained weights), ``train_main`` (8 steps, checkpoint
        reloads bit-equal) and 10 steps on one batch;
    (c) the card against the port's CPU path at the parity tests' size for
        the three registration models, and the trained transformer on 4
        val clouds at full width;
    (d) one profiled train step of each registration model
        (``phase_profile_learned``: DCP's attention, DeepGMR's RRI, IDAM's
        similarity convolutions)."""
    from houv_tpu_torch.ops.emd import emd_auction_with_stats
    from houv_tpu_torch.train.cli import build_dataset, test_main
    from houv_tpu_torch.train.config import load_config
    from houv_tpu_torch.train.harness import CompletionTrainer
    from houv_tpu_torch.train.submission import read_results_h5

    out = {"reference": {m: _learned_cpu_vs_card(m) for m in LEARNED}}
    out["reference"]["transformer"] = _transformer_cpu_vs_card()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        for model in LEARNED:
            out[model] = {"train": run_learned_train(tmp, model),
                          "repeated": _learned_repeated(tmp, model)}
        counters = _completion_counters()
        _zero(counters)
        res = test_main(["-c", _model_cfg(tmp, "transformer", 512,
                                          load_model=TRANSFORMER_CKPT)])
        launches = _read(counters)
        results = read_results_h5(res["results_h5"])
        steady = res["seconds"] - res["first_batch_seconds"]
        sweep = {"phase": "learned", "config": "cfgs/transformer.yaml",
                 "run": "test_main", "checkpoint": TRANSFORMER_CKPT,
                 "clouds": res["n_clouds"], "batch": 32,
                 "seconds": res["seconds"],
                 "first_batch_seconds": res["first_batch_seconds"],
                 "clouds_per_s": res["n_clouds"] / res["seconds"],
                 "clouds_per_s_after_first": (res["n_clouds"] - 32) / steady,
                 "result": list(results.shape), "launches": launches,
                 "expected_launches": _times(LAUNCHES["transformer"]["test"],
                                             512 // 32)}
        emit(sweep)
        if results.shape != (512, 2048, 3) or not np.isfinite(results).all() \
                or launches != sweep["expected_launches"]:
            fail(f"transformer sweep: results {results.shape}, launches "
                 f"{launches}")
        cfg = load_config(_model_cfg(tmp, "transformer", 64, eval_emd=True,
                                     load_model=TRANSFORMER_CKPT))
        trainer = CompletionTrainer(cfg)
        trainer.init_state()
        val_ds = build_dataset(cfg, "val")
        torch.cuda.synchronize()
        _zero(counters)
        t0 = time.perf_counter()
        with _EmdInputs(2) as emd_inputs:
            metrics = trainer.validate(val_ds)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _read(counters)
        rounds = [emd_auction_with_stats(*args)[2].float()
                  for args in emd_inputs.kept]
        rounds = torch.cat(rounds)
        val = {"phase": "learned", "config": "cfgs/transformer.yaml",
               "run": "validate", "checkpoint": TRANSFORMER_CKPT,
               "eval_emd": True, "clouds": len(val_ds), "seconds": seconds,
               "clouds_per_s": len(val_ds) / seconds, "metrics": metrics,
               "emd_rounds_mean": float(rounds.mean()),
               "emd_rounds_max": float(rounds.max()),
               "emd_pairs_at_3000_rounds": int((rounds >= 3000).sum()),
               "launches": launches,
               "expected_launches": _times(dict(
                   LAUNCHES["transformer"]["val"], emd=1), 2)}
        emit(val)
        del trainer
        torch.cuda.empty_cache()
        if set(metrics) != {"cd_p", "cd_t", "emd", "f1"} or not all(
                np.isfinite(v) for v in metrics.values()) \
                or launches != val["expected_launches"]:
            fail(f"transformer validate: metrics {metrics}, launches "
                 f"{launches}")
        train = run_train_main(tmp, "transformer")
        rep = _repeated_batch(tmp, 10, False, "transformer")
        _falling(rep, "transformer")
        out["transformer"] = {"sweep": sweep, "validate": val,
                              "train": train, "repeated": rep}
    out["profiles"] = {m: phase_profile_learned(m) for m in LEARNED}
    return out


AUX_CKPTS = {"embedding": "log/model_embedding_cd_embed/best_acc_network.ckpt",
             "alignment": "log/alignment_spconv_cd_aligned/best_acc_network.ckpt",
             "spconv": "log/voxel_asym_cd_vox/best_iou_network.ckpt"}
# the aux yamls' kernel launches a train step and a val batch, derived from
# the code: VoxAsym's voxel targets one K4 scatter of (8, 2048, 4) onto
# 125,000 voxels; DCP (cfgs/modelnet.yaml) K6 once a cloud a forward; the
# embedding and the classifier none (plain gathers and GEMMs)
AUX_LAUNCHES = {"embedding": {}, "alignment": {}, "rescore_alignment": {},
                "spconv": {"scatter_add": 1}, "modelnet": {"knn": 2}}


def _ckpt_hashes():
    """SHA-256 of every checkpoint under ``log/``."""
    import hashlib

    return {str(p.relative_to(REPO)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted((REPO / "log").rglob("*.ckpt"))}


class _SitesDropped:
    """The most sites any alignment classifier's strided convs dropped in
    the calls made inside the block (a global forward hook)."""

    def __enter__(self):
        from houv_tpu_torch.models.alignment import AlignmentClassifier

        self.most, self.calls = 0, 0

        def hook(module, args, out):
            if isinstance(module, AlignmentClassifier):
                self.most = max(self.most, int(module.sites_dropped))
                self.calls += 1

        self.handle = torch.nn.modules.module.register_module_forward_hook(
            hook)
        return self

    def __exit__(self, *exc):
        self.handle.remove()


def _aux_batch(cfg, split, trainer, n=None, seed=0):
    """``n`` items (default a batch) of the yaml's split through the
    trainer's view."""
    from houv_tpu_torch.train.cli import build_dataset

    ds = trainer.wrap_dataset(build_dataset(cfg, split))
    return ds.get_batch(np.arange(n or cfg.batch_size),
                        rng=np.random.default_rng(seed))


def run_aux_train(tmp, name, **extra):
    """``train_main`` on cfgs/<name>.yaml at full width, ``nepoch`` cut to
    2 (``extra`` overriding keys), its launches held to ``AUX_LAUNCHES``
    a step and a val batch: steps/s with validation and checkpoints, peak
    memory, losses, the tracked meter's best and the files written."""
    from houv_tpu_torch.train.cli import build_dataset, train_main

    counters = _completion_counters()
    _zero(counters)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = train_main(["-c", _full_train_cfg(tmp, name, nepoch=2, **extra)])
    torch.cuda.synchronize()
    launches = _read(counters)
    peak = torch.cuda.max_memory_allocated() / 2**30
    trainer = out.pop("trainer")
    cfg = trainer.cfg
    steps = len(out["losses"])
    val = trainer.wrap_dataset(build_dataset(cfg, "val"))
    val_batches = (len(val) // cfg.batch_size) * sum(
        1 for e in range(2) if e % cfg.epoch_interval_to_val == 0)
    expected = _sum(_times(AUX_LAUNCHES[name], steps + val_batches))
    rows = cfg.batch_size * (2 if cfg.model_name == "alignment_spconv"
                             else 1)
    rec = {"phase": "aux", "config": f"cfgs/{name}.yaml", "run": "train_main",
           "model": cfg.model_name, "batch": cfg.batch_size,
           "rows_a_step": rows, "points": cfg.num_points,
           "compute_dtype": cfg.compute_dtype,
           "train_items": len(build_dataset(cfg, "train")),
           "val_items": len(val), "epochs": 2, "steps": steps,
           "losses": out["losses"], "seconds": out["seconds"],
           "steps_per_s_with_validate_and_save": steps / out["seconds"],
           "items_per_s_with_validate_and_save":
               steps * cfg.batch_size / out["seconds"],
           "peak_memory_gib": peak, "best": dict(trainer.best),
           "launches": launches, "expected_launches": expected,
           "checkpoint_files": sorted(os.listdir(out["log_dir"]))}
    emit(rec)
    tracked = f"best_{next(iter(trainer.best))}_network.ckpt"
    del trainer
    torch.cuda.empty_cache()
    if not steps or not np.isfinite(out["losses"]).all():
        fail(f"{name} train_main: {steps} steps, losses {out['losses']}")
    if launches != expected:
        fail(f"{name} train_main launches {launches}, expected {expected}")
    if not {"network.ckpt", tracked} <= set(rec["checkpoint_files"]):
        fail(f"{name} train_main wrote {rec['checkpoint_files']}")
    return dict(rec, checkpoint=out["checkpoint"])


def _aux_repeated(tmp, name, n_steps=10):
    """``n_steps`` train steps of cfgs/<name>.yaml at full width on one
    repeated batch from the seeded initialisation: the losses (they must
    fall), steps/s and clouds/s after a first step outside the clock, peak
    memory, launches held."""
    from houv_tpu_torch.train.cli import make_trainer
    from houv_tpu_torch.train.config import load_config

    cfg = load_config(_full_train_cfg(tmp, name))
    trainer = make_trainer(cfg, "cuda")
    trainer.init_state()
    batch = _aux_batch(cfg, "train", trainer)
    counters = _completion_counters()
    _zero(counters)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses = [float(trainer.train_step(batch, 0, 0))]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for step in range(1, n_steps):
        losses.append(float(trainer.train_step(batch, 0, step)))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    rec = {"phase": "aux", "config": f"cfgs/{name}.yaml",
           "run": "repeated_batch", "batch": cfg.batch_size,
           "points": cfg.num_points, "steps": n_steps, "losses": losses,
           "steps_per_s": (n_steps - 1) / seconds,
           "clouds_per_s": cfg.batch_size * (n_steps - 1) / seconds,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": _read(counters),
           "expected_launches": _times(AUX_LAUNCHES[name], n_steps)}
    emit(rec)
    del trainer
    torch.cuda.empty_cache()
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"{name}: {n_steps} steps on one batch did not lower the loss: "
             f"{losses}")
    if rec["launches"] != rec["expected_launches"]:
        fail(f"{name} repeated batch launches {rec['launches']}, expected "
             f"{rec['expected_launches']}")
    return rec


def _aux_trained(tmp, name, ckpt, **extra):
    """``test_main`` on cfgs/<name>.yaml with ``load_model`` the trained
    JAX checkpoint ``ckpt`` (``work_dir`` in ``tmp``, ``extra`` overriding
    keys): the val meters (their draws seeded), seconds, items/s, launches
    held, and the sites the classifier dropped."""
    from houv_tpu_torch.train.cli import build_dataset, test_main
    from houv_tpu_torch.train.config import load_config

    path = _full_train_cfg(tmp, name, load_model=str(REPO / ckpt), **extra)
    cfg = load_config(path)
    counters = _completion_counters()
    _zero(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _SitesDropped() as sites:
        meters = test_main(["-c", path])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _read(counters)
    n_val = len(build_dataset(cfg, "val"))
    batches = n_val // cfg.batch_size
    rec = {"phase": "aux", "config": f"cfgs/{name}.yaml", "run": "test_main",
           "checkpoint": ckpt, "compute_dtype": cfg.compute_dtype,
           "meters": meters, "val_items": n_val,
           "items_evaluated": batches * cfg.batch_size, "seconds": seconds,
           "items_per_s": batches * cfg.batch_size / seconds,
           "launches": launches,
           "expected_launches": _sum(_times(AUX_LAUNCHES[name], batches))}
    if cfg.model_name == "alignment_spconv":
        rec.update(sites_dropped=sites.most, classifier_calls=sites.calls)
    emit(rec)
    if not meters or not all(np.isfinite(v) for v in meters.values()) \
            or launches != rec["expected_launches"]:
        fail(f"{name} test_main on {ckpt}: meters {meters}, launches "
             f"{launches}")
    if rec.get("sites_dropped"):
        fail(f"{name}: the classifier dropped {sites.most} sites")
    return rec


def _aux_cpu_vs_card(tmp, name, ckpt, tol, **extra):
    """The trained checkpoint on one val batch at full width, on the card
    and on the CPU: the embeddings and logits (embedding.yaml), the logits
    (the classifier's yamls), or the occupancy probabilities and positions
    over the valid voxels (spconv.yaml), each within ``tol``; for
    spconv.yaml also ``_voxel_targets`` on the card against the CPU:
    occupancy equal and the means bit for bit."""
    from houv_tpu_torch.train.aux import _voxel_targets
    from houv_tpu_torch.train.cli import make_trainer
    from houv_tpu_torch.train.config import load_config

    cfg = load_config(_full_train_cfg(tmp, name, load_model=str(REPO / ckpt),
                                      **extra))
    outs, batch = {}, None
    for dev in ("cpu", "cuda"):
        trainer = make_trainer(cfg, dev)
        trainer.init_state()
        batch = batch or _aux_batch(cfg, "val", trainer, seed=5)
        with torch.inference_mode():
            if name == "embedding":
                out = trainer._embed(batch)[0]
            elif name == "spconv":
                probs, pos, _, mask = trainer.model(
                    trainer._tensor(batch, "partial"),
                    trainer._tensor(batch, "coords").long())
                out = (probs[mask], pos[mask])
            else:
                out = (trainer._logits(batch, False),)
        outs[dev] = [t.float().cpu() for t in out]
        if name == "spconv":
            outs[dev + "_targets"] = [t.cpu() for t in _voxel_targets(
                trainer._tensor(batch, "gt"),
                trainer._tensor(batch, "gt_coords"), cfg.grid_size)]
        if name != "embedding":
            outs[dev + "_sites"] = int(getattr(trainer.model,
                                               "sites_dropped", 0) or 0)
        del trainer
    diffs = [float((c - g).abs().max()) for c, g in zip(outs["cpu"],
                                                        outs["cuda"])]
    rec = {"phase": "aux_reference", "config": f"cfgs/{name}.yaml",
           "checkpoint": ckpt, "items": cfg.batch_size,
           "points": cfg.num_points, "compute_dtype": cfg.compute_dtype,
           "outputs": ["embedding", "logits"] if name == "embedding"
           else ["probs", "positions"] if name == "spconv" else ["logits"],
           "max_abs_diff": diffs, "tolerance": tol,
           "largest_output": [float(t.abs().max()) for t in outs["cpu"]]}
    if name == "spconv":
        (occ_c, mean_c), (occ_g, mean_g) = (outs["cpu_targets"],
                                            outs["cuda_targets"])
        rec["targets_occupied"] = int(occ_c.sum())
        rec["targets_occupancy_mismatches"] = int((occ_c != occ_g).sum())
        rec["targets_mean_bit_mismatches"] = int(
            (mean_c.view(torch.int32) != mean_g.view(torch.int32)).sum())
    else:
        rec["sites_dropped"] = outs.get("cuda_sites", 0)
    emit(rec)
    if not all(d <= tol for d in diffs):
        fail(f"{name} on the card differs from the CPU path: {diffs}")
    if rec.get("targets_occupancy_mismatches") or rec.get(
            "targets_mean_bit_mismatches") or rec.get("sites_dropped"):
        fail(f"{name}: {rec}")
    return rec


def run_modelnet(tmp):
    """cfgs/modelnet.yaml (DCP at 1024 points, batch 32) at full width:
    ``train_main`` over the synthetic 128 train and 64 val clouds, 2
    epochs; then the test sweep with the trained weights over the 64-pair
    split, variant clean and noisy, K6 held to 2 a forward."""
    from houv_tpu_torch.train.cli import test_main
    from houv_tpu_torch.train.submission import read_results_h5

    train = run_aux_train(tmp, "modelnet")
    sweeps = {}
    counters = _completion_counters()
    for variant in ("clean", "noisy"):
        _zero(counters)
        res = test_main(["-c", _full_train_cfg(
            tmp, "modelnet", variant=variant,
            load_model=train["checkpoint"])])
        launches = _read(counters)
        results = read_results_h5(res["results_h5"])
        rot = results[:, :3, :3]
        ortho = float(np.abs(rot @ rot.transpose(0, 2, 1) - np.eye(3)).max())
        batches = -(-res["n_pairs"] // 32)
        sweeps[variant] = {
            "phase": "aux", "config": "cfgs/modelnet.yaml",
            "run": "test_main", "variant": variant,
            "pairs": res["n_pairs"], "seconds": res["seconds"],
            "pairs_per_s": res["n_pairs"] / res["seconds"],
            "first_batch_seconds": res["first_batch_seconds"],
            "results": list(results.shape),
            "rotation_orthonormal_err": ortho, "launches": launches,
            "expected_launches": _times(AUX_LAUNCHES["modelnet"], batches)}
        emit(sweeps[variant])
        if results.shape != (64, 4, 4) or not np.isfinite(results).all() \
                or ortho > 1e-4 \
                or launches != sweeps[variant]["expected_launches"]:
            fail(f"modelnet {variant} sweep: {sweeps[variant]}")
    return {"train": train, **sweeps}


def phase_aux():
    """The aux models and ModelNet at the yamls' full width (no new
    kernel: K4 carries VoxAsym's voxel targets, K6 DCP on ModelNet), each
    run's work_dir a temporary directory:
    (a) cfgs/embedding.yaml (batch 32, 2048 points): ``train_main`` (128
        train and 64 val clouds, ``nepoch`` 100 -> 2), 10 steps on one
        triplet batch, the trained checkpoint of ``log/`` through
        ``test_main`` (acc, cls_acc) and on the card against the CPU path;
    (b) cfgs/alignment.yaml (f32, batch 8 -> 16 rows) and
        cfgs/rescore_alignment.yaml (bf16, its structured split cut from
        512 pairs to 64): ``train_main`` (64 train and 64 val pairs,
        ``nepoch`` -> 2), the trained classifier of ``log/`` through
        ``test_main`` (acc, sites dropped) and its logits on the card
        against the CPU path;
    (c) cfgs/spconv.yaml (VoxAsym, batch 8, grid 50): ``train_main``, 10
        steps on one batch, the trained checkpoint through ``test_main``
        (ce, pos_mse, iou), its outputs and ``_voxel_targets`` on the card
        against the CPU path;
    (d) cfgs/modelnet.yaml (``run_modelnet``).
    The SHA-256 of every checkpoint under ``log/`` is the same after the
    phase as before it."""
    before = _ckpt_hashes()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        out["embedding"] = {
            "train": run_aux_train(tmp, "embedding"),
            "repeated": _aux_repeated(tmp, "embedding"),
            "trained": _aux_trained(tmp, "embedding", AUX_CKPTS["embedding"]),
            "reference": _aux_cpu_vs_card(tmp, "embedding",
                                          AUX_CKPTS["embedding"], 1e-4)}
        for name, tol in (("alignment", 1e-3), ("rescore_alignment", 5e-2)):
            out[name] = {
                "train": run_aux_train(tmp, name, synthetic_size=64),
                "trained": _aux_trained(tmp, name, AUX_CKPTS["alignment"],
                                        synthetic_size=64),
                "reference": _aux_cpu_vs_card(tmp, name,
                                              AUX_CKPTS["alignment"], tol,
                                              synthetic_size=64)}
        out["spconv"] = {
            "train": run_aux_train(tmp, "spconv"),
            "repeated": _aux_repeated(tmp, "spconv"),
            "trained": _aux_trained(tmp, "spconv", AUX_CKPTS["spconv"]),
            "reference": _aux_cpu_vs_card(tmp, "spconv", AUX_CKPTS["spconv"],
                                          1e-4)}
        out["modelnet"] = run_modelnet(tmp)
    after = _ckpt_hashes()
    emit({"phase": "aux_checkpoints", "sha256": before,
          "unchanged": after == before})
    if after != before or not before:
        fail(f"log/'s checkpoints changed: {before} -> {after}")
    return out


# The nine models whose bf16 mode the port gained with [11a]: (yaml, model)
BF16_RUNS = (("pcn.yaml", "pcn"), ("ecg.yaml", "ecg"),
             ("vrcnet.yaml", "vrcnet"), ("transformer.yaml", "transformer"),
             ("dcp.yaml", "dcp"), ("deepgmr.yaml", "deepgmr"),
             ("idam.yaml", "idam"), ("embedding.yaml", "model_embedding"),
             ("spconv.yaml", "voxel_asym"))
# launches a bf16 train step: the f32 path's (``LAUNCHES``); the embedding
# runs no kernel, VoxAsym one K4 (its voxel targets)
BF16_STEP_LAUNCHES = {**{m: LAUNCHES[m]["train"] for m in (
    "pcn", "ecg", "vrcnet", "transformer", "dcp", "deepgmr", "idam")},
    "model_embedding": {}, "voxel_asym": {"scatter_add": 1}}
# the parity tests' sizes (tests/test_torch_bf16_*.py) and what each test
# holds: the output, or the intermediate its docstring names
BF16_SMALL = {
    "pcn": dict(num_points=128, num_coarse=64),
    "ecg": dict(num_points=128, num_coarse=64, num_input=128),
    "vrcnet": dict(num_points=512, num_coarse_raw=128, num_fps=256,
                   num_coarse=256, layers=(1, 1, 1, 1), knn_list=(4, 8),
                   pk=8, n_input=256),
    "transformer": dict(num_points=128, num_latent=64),
    "dcp": dict(emb_dims=32), "deepgmr": dict(rri_size=8),
    "idam": dict(descriptor_size=16),
    "model_embedding": dict(use_attention=True),
    "voxel_asym": dict(grid_size=12, embedding_dim=16, init_size=8)}
BF16_BOUND = 5e-3


def _bf16_cfg(tmp, yaml_name, compute_dtype="bfloat16", **extra):
    """A temp copy of cfgs/<yaml_name> in ``compute_dtype``, ``extra``
    overriding its keys."""
    with open(REPO / "cfgs" / yaml_name) as f:
        raw = yaml.safe_load(f)
    raw.update(work_dir=str(Path(tmp) / "work"), compute_dtype=compute_dtype,
               **extra)
    path = Path(tmp) / f"{yaml_name[:-5]}_{len(os.listdir(tmp))}.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def _timed_steps(trainer, batch, n_steps):
    """``n_steps`` train steps on one batch (step 0's draws each time), the
    first outside the clock: losses, steps/s, peak memory (GiB)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses = [float(trainer.train_step(batch, 0, 0))]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(1, n_steps):
        losses.append(float(trainer.train_step(batch, 0, 0)))
    torch.cuda.synchronize()
    return (losses, (n_steps - 1) / (time.perf_counter() - t0),
            torch.cuda.max_memory_allocated() / 2**30)


def _profiled_step(trainer, batch):
    """torch.profiler over one more train step: its wall and device
    milliseconds, device busy share, device ops and five largest
    kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(batch, 0, 0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    top = _profile_top(prof, wall_ms)
    return {k: top[k] for k in ("wall_ms", "device_ms", "device_busy_share",
                                "device_ops")} | {"top": top["top"][:5]}


class _KnnHeldToPlain(_Picks):
    """A ``_Picks`` for ``knn_indices`` that, at each call on the card,
    also runs the plain version on the same (f32) inputs and counts the
    slots where the kernel's picks differ from it."""

    def __init__(self):
        from houv_tpu_torch.ops.grouping import knn_indices

        super().__init__(knn_indices)
        self.calls, self.differ, self.widths, self.dtypes = 0, 0, [], set()

    def __call__(self, query, ref, k, device="cuda"):
        from houv_tpu_torch.ops.grouping import _knn_plain

        out = self.fn(query, ref, k, device=device)
        plain = _knn_plain(query.detach().float().contiguous(),
                           ref.detach().float().contiguous(), k)
        self.calls += 1
        self.differ += int((out != plain).sum())
        self.widths.append(int(query.shape[-1]))
        self.dtypes.add(str(query.dtype))
        return out


def _bf16_full_width(tmp, yaml_name, model):
    """cfgs/<yaml_name> at full width in bf16: ``train_main`` (64 train and
    64 val items, two epochs; the transformer from its trained checkpoint),
    ``test_main`` with the checkpoint it wrote (the aux models: their val
    meters) and 10 steps on one batch (the loss must fall, launches as
    ``BF16_STEP_LAUNCHES``), then 10 f32 steps on the same batch in the
    same process: steps/s and peak memory of each, and one profiled step
    of each (device time, busy share, the largest kernels). For ECG the
    bf16 step's K6-wide picks (its graphs on bf16 features cast to f32)
    are held to the plain version index for index."""
    from houv_tpu_torch.train.cli import (build_dataset, make_trainer,
                                          test_main, train_main)
    from houv_tpu_torch.train.config import load_config
    from houv_tpu_torch.train.submission import read_results_h5

    counters = _completion_counters()
    load = dict(load_model=TRANSFORMER_CKPT) if model == "transformer" \
        else {}
    _zero(counters)
    torch.cuda.reset_peak_memory_stats()
    out = train_main(["-c", _bf16_cfg(tmp, yaml_name, nepoch=2,
                                      synthetic_size=64, **load)])
    torch.cuda.synchronize()
    train_launches = _read(counters)
    train_peak = torch.cuda.max_memory_allocated() / 2**30
    trainer = out.pop("trainer")
    bs = trainer.cfg.batch_size
    del trainer
    torch.cuda.empty_cache()
    _zero(counters)
    res = test_main(["-c", _bf16_cfg(tmp, yaml_name, synthetic_size=64,
                                     load_model=out["checkpoint"])])
    test_launches = _read(counters)
    if "results_h5" in res:
        results = read_results_h5(res["results_h5"])
        tested = {"results": list(results.shape),
                  "finite": bool(np.isfinite(results).all()),
                  "items_per_s": len(results) / res["seconds"]}
    else:
        tested = {"meters": {k: v for k, v in res.items()
                             if isinstance(v, float)}}
        tested["finite"] = all(np.isfinite(v)
                               for v in tested["meters"].values())
    runs = {}
    for dt in ("bfloat16", None):
        cfg = load_config(_bf16_cfg(tmp, yaml_name, compute_dtype=dt,
                                    synthetic_size=64))
        trainer = make_trainer(cfg, "cuda")
        trainer.init_state()
        batch = trainer.wrap_dataset(build_dataset(cfg, "train")).get_batch(
            np.arange(cfg.batch_size), rng=np.random.default_rng(0))
        _zero(counters)
        losses, rate, peak = _timed_steps(trainer, batch, 10)
        runs[dt or "float32"] = {"losses": losses, "steps_per_s": rate,
                                 "items_per_s": rate * cfg.batch_size,
                                 "peak_memory_gib": peak,
                                 "launches": _read(counters),
                                 "profile": _profiled_step(trainer, batch)}
        if dt and model == "ecg":
            with _KnnHeldToPlain() as held:
                trainer.train_step(batch, 0, 0)
            runs["bfloat16"]["knn_held_to_plain"] = {
                "calls": held.calls, "differ": held.differ,
                "widths": held.widths, "dtypes": sorted(held.dtypes)}
        del trainer, batch
        torch.cuda.empty_cache()
    bf, f32 = runs["bfloat16"], runs["float32"]
    rec = {"phase": "bf16", "config": f"cfgs/{yaml_name}", "model": model,
           "batch": bs, "train_main": {
               "steps": len(out["losses"]), "losses": out["losses"],
               "seconds": out["seconds"], "peak_memory_gib": train_peak,
               "launches": train_launches,
               "checkpoint_files": sorted(os.listdir(out["log_dir"]))},
           "test_main": dict(tested, launches=test_launches),
           "repeated_bf16": bf, "repeated_f32": f32,
           "bf16_over_f32_steps_per_s": bf["steps_per_s"]
           / f32["steps_per_s"],
           "expected_step_launches": _times(BF16_STEP_LAUNCHES[model], 10)}
    emit(rec)
    if not (np.isfinite(out["losses"]).all() and len(out["losses"]) >= 2
            and tested["finite"] and "network.ckpt"
            in rec["train_main"]["checkpoint_files"]):
        fail(f"bf16 {model}: train_main {out['losses']}, test_main "
             f"{tested}")
    if not (np.isfinite(bf["losses"]).all()
            and bf["losses"][-1] < bf["losses"][0]
            and np.isfinite(f32["losses"]).all()):
        fail(f"bf16 {model}: 10 steps on one batch did not lower the loss: "
             f"{bf['losses']} (f32 {f32['losses']})")
    if bf["launches"] != rec["expected_step_launches"]:
        fail(f"bf16 {model}: launches {bf['launches']}, expected "
             f"{rec['expected_step_launches']}")
    if model == "ecg":
        held = bf["knn_held_to_plain"]
        if held["differ"] or held["calls"] != 20 \
                or held["dtypes"] != ["torch.float32"]:
            fail(f"bf16 ecg: kNN picks against the plain version {held}")
    return rec


def _bf16_small_outputs(model_name, dev):
    """The seeded bf16 model at the parity tests' size on ``dev``: what
    the tests hold (the completion's cloud, DCP's transform, DeepGMR's
    backbone logits, IDAM's GNN embedding, the embedding's logits,
    VoxAsym's occupancy probabilities), on the CPU."""
    from houv_tpu_torch.models import get_model
    from houv_tpu_torch.models.common import init_like_flax

    kw = BF16_SMALL[model_name]
    model = get_model(model_name, compute_dtype="bfloat16", **kw)
    gen = torch.Generator().manual_seed(21)
    init_like_flax(model, gen)
    if model_name == "transformer":        # a completion's scale, as the test
        with torch.no_grad():
            model.regressor.head_out.weight.mul_(0.25)
    if model_name == "idam":
        _closeness_scores(model, gen)
    model.to(dev).eval()
    seen = []
    sub = {"deepgmr": "backbone", "idam": "emb_nn"}.get(model_name)
    hook = sub and getattr(model, sub).register_forward_hook(
        lambda m, i, o: seen.append(o))
    with torch.no_grad():
        if model_name in LEARNED:
            src, tgt, t_gt = (a.to(dev) for a in _registration_pair(
                5, 2, 96 if model_name == "idam" else 64))
            out = model(src, tgt, t_gt, prefix="val", train=False)
            out = seen[0] if sub else out["transform"]
        elif model_name == "voxel_asym":
            pts = torch.rand(2, 128, 3, generator=gen) - 0.5
            coords = ((pts + 0.5) * 11).floor().long().clamp(0, 11)
            out = model(pts.to(dev), coords.to(dev))[0]
        else:
            x = torch.rand(2, 256 if model_name == "vrcnet" else 128, 3,
                           generator=gen) - 0.5
            if model_name == "model_embedding":
                out = model(x.to(dev))[1]
            else:
                extra = dict(noise=torch.randn(2, 128, generator=gen).to(
                    dev)) if model_name == "vrcnet" else {}
                out = model(x.to(dev), None, "test", **extra)["result"]
    if hook:
        hook.remove()
    return out.float().cpu()


def _bf16_cpu_vs_card(model_name):
    """The card's bf16 model against the port's CPU path at the parity
    size, within the tests' bound; the CPU run's picks (kNN, FPS, ball
    query) handed to the card's, whose own kernels still pick and are
    counted where they differ."""
    from houv_tpu_torch.ops.grouping import ball_query, knn_indices
    from houv_tpu_torch.ops.sampling import furthest_point_sample

    fns = (knn_indices, furthest_point_sample, ball_query)
    kept = []
    with _Picks(fns[0]) as a, _Picks(fns[1]) as b, _Picks(fns[2]) as c:
        cpu = _bf16_small_outputs(model_name, "cpu")
    kept = [a.kept, b.kept, c.kept]
    with _Picks(fns[0], kept[0]) as a, _Picks(fns[1], kept[1]) as b, \
            _Picks(fns[2], kept[2]) as c:
        card = _bf16_small_outputs(model_name, "cuda")
    diff = float((card - cpu).abs().max())
    rec = {"phase": "bf16_reference", "model": model_name,
           "small": {k: list(v) if isinstance(v, tuple) else v
                     for k, v in BF16_SMALL[model_name].items()},
           "shape": list(card.shape), "max_abs_diff": diff,
           "mean_abs_diff": float((card - cpu).abs().mean()),
           "picks_flipped": {"knn": a.flips, "fps": b.flips,
                             "ball": c.flips},
           "bound": BF16_BOUND}
    emit(rec)
    if not diff <= BF16_BOUND or card.shape != cpu.shape:
        fail(f"bf16 {model_name} on the card differs from the CPU path: "
             f"{diff:.3g} (bound {BF16_BOUND})")
    return rec


def phase_bf16():
    """``compute_dtype: bfloat16`` for the nine models that gained it with
    [11a] (``BF16_RUNS``): each at its yaml's full width
    (``_bf16_full_width``: ``train_main``, ``test_main`` with its
    checkpoint, 10 bf16 steps on one batch beside 10 f32 steps on the same
    batch), then each at the parity size on the card against the CPU path
    (``_bf16_cpu_vs_card``)."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for yaml_name, model in BF16_RUNS:
            out[model] = {"full": _bf16_full_width(tmp, yaml_name, model)}
    for _, model in BF16_RUNS:
        out[model]["reference"] = _bf16_cpu_vs_card(model)
    emit({"phase": "bf16_summary", "card": card_line(), "steps_per_s": {
        m: {"bf16": r["full"]["repeated_bf16"]["steps_per_s"],
            "f32": r["full"]["repeated_f32"]["steps_per_s"]}
        for m, r in out.items()}, "device_ms_a_step": {
        m: {"bf16": r["full"]["repeated_bf16"]["profile"]["device_ms"],
            "f32": r["full"]["repeated_f32"]["profile"]["device_ms"]}
        for m, r in out.items()}, "peak_memory_gib": {
        m: {"bf16": r["full"]["repeated_bf16"]["peak_memory_gib"],
            "f32": r["full"]["repeated_f32"]["peak_memory_gib"]}
        for m, r in out.items()}})
    return out


def _small_gan_step(cfg, batch, noise, dev, dtype, picks=None):
    """One GAN step of ``CompletionTrainer`` (``use_gan``) on the seeded
    small VRCNet and critic on ``dev`` in ``dtype``, its latent noise and
    dropout masks given: (recon loss, critic loss, the generator's and the
    critic's gradients by name (f64, on the CPU), the picks, their flips),
    picks as ``_small_train_step`` keeps and replays them."""
    from houv_tpu_torch.ops.chamfer import chamfer_indices
    from houv_tpu_torch.ops.sampling import furthest_point_sample
    from houv_tpu_torch.train.harness import CompletionTrainer

    trainer = CompletionTrainer(cfg, dev)
    model = trainer.init_state()
    masks = model.decoder.encoder.dropout_masks(
        16, torch.Generator().manual_seed(12))
    model.to(dtype)
    trainer.critic.to(dtype)
    forward = model.forward
    model.forward = lambda *a, generator=None, **kw: forward(
        *a, noise=[n.to(dev, dtype) for n in noise],
        dropout_masks=[m.to(dtype) for m in masks], **kw)
    given = picks or {"fps": None, "matches": None, "geometry": None}
    seen, handle = _replay_geometry(model, picks)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    batch = {k: v.astype(np_dtype) if v.dtype.kind == "f" else v
             for k, v in batch.items()}
    with _Picks(furthest_point_sample, given["fps"]) as fps, \
            _Picks(chamfer_indices, given["matches"]) as matches:
        loss = float(trainer.train_step(batch, 0, 0))
    handle.remove()
    return (loss, float(trainer.critic_loss),
            {n: p.grad.double().cpu() for n, p in model.named_parameters()},
            {n: p.grad.double().cpu()
             for n, p in trainer.critic.named_parameters()},
            {"fps": fps.kept, "matches": matches.kept,
             "geometry": seen["geometry"]},
            {"fps": fps.flips, "matches": matches.flips,
             "geometry": seen.get("flips", 0)})


def _worst_grads(grads, ref):
    """(error over the tensor's largest f64 entry, name, that entry), the
    worst first."""
    return sorted(((float((grads[n] - r).abs().max() / r.abs().max()), n,
                    float(r.abs().max())) for n, r in ref.items()),
                  reverse=True)


def _gan_reference():
    """One GAN step at the parity tests' size (``phase_train_reference``'s
    VRCNet, batch 8, ``use_gan``) on the card against the port's CPU path
    in f64: the same seeded weights and critic, batch, latent noise,
    dropout masks and picks. Held at that phase's tolerances: the recon
    and critic losses to 1e-4 relative, every gradient of the generator
    and of the critic to 1e-3 of that tensor's largest f64 entry."""
    from houv_tpu_torch.train.cli import build_dataset

    cfg = _small_train_cfg(use_gan=True)
    batch = build_dataset(cfg, "train").get_batch(
        np.arange(8), rng=np.random.default_rng(0))
    g = torch.Generator().manual_seed(11)
    noise = [torch.randn((8, 128), generator=g) for _ in range(2)]
    ref = _small_gan_step(cfg, batch, noise, "cpu", torch.float64)
    card = _small_gan_step(cfg, batch, noise, "cuda", torch.float32, ref[4])
    rec = {"phase": "gan_reference", "clouds": 8, "points": 256,
           "loss_tolerance_rel": 1e-4,
           "grad_tolerance_over_tensor_max": 1e-3,
           "recon_loss_cpu_f64": ref[0], "critic_loss_cpu_f64": ref[1],
           "recon_loss_rel_diff": abs(card[0] - ref[0]) / abs(ref[0]),
           "critic_loss_rel_diff": abs(card[1] - ref[1]) / abs(ref[1]),
           "picks_differing_from_f64": card[5]}
    for part, i in (("generator", 2), ("critic", 3)):
        rows = _worst_grads(card[i], ref[i])
        rec[part] = {"parameters": len(rows), "worst_grads": [
            {"name": n, "err_over_tensor_max": e, "tensor_max": m}
            for e, n, m in rows[:3]]}
    emit(rec)
    worst = max(rec[p]["worst_grads"][0]["err_over_tensor_max"]
                for p in ("generator", "critic"))
    if not (rec["recon_loss_rel_diff"] <= 1e-4
            and rec["critic_loss_rel_diff"] <= 1e-4 and worst <= 1e-3):
        fail(f"GAN step on the card differs from the f64 CPU path: losses "
             f"{rec['recon_loss_rel_diff']:.3g}, "
             f"{rec['critic_loss_rel_diff']:.3g} relative, a gradient "
             f"{worst:.3g} of its tensor's largest entry")
    return rec


def phase_gan():
    """The cascade-GAN trainer (``use_gan``) on cfgs/vrcnet.yaml at full
    width (batch 32, 2048 points, KLD, the critic on the first 2048 points
    of the fine cloud): ``train_main`` (``run_train_main``: two epochs of
    four GAN steps, launches held, the checkpoint holding the critic and
    reloading to bit-equal predictions through a trainer and through
    ``test_main``), 10 GAN steps on one repeated batch (the recon loss
    must fall, the critic's loss stay finite), and one GAN step at the
    parity size against the CPU path in f64 (``_gan_reference``). The
    critic runs no kernel: a GAN step launches what a plain step launches,
    ``LAUNCHES['vrcnet']['train']``."""
    with tempfile.TemporaryDirectory() as tmp:
        rec = run_train_main(tmp, "vrcnet", use_gan=True)
        if not {"critic", "critic_optimizer"} <= set(
                rec["checkpoint_entries"]):
            fail(f"GAN checkpoint holds {rec['checkpoint_entries']}")
        rep = _repeated_batch(tmp, 10, False, use_gan=True)
        _falling(rep, "vrcnet")
        if not np.isfinite(rep["critic_losses"]).all():
            fail(f"GAN critic losses {rep['critic_losses']}")
    ref = _gan_reference()
    emit({"phase": "gan", "card": card_line(),
          "train_main_steps_per_s": rec["steps_per_s_with_validate_and_save"],
          "steps_per_s": rep["steps_per_s"],
          "peak_memory_gib": rep["peak_memory_gib"],
          "launches_per_step": LAUNCHES["vrcnet"]["train"]})
    return {"train": rec, "repeated": rep, "reference": ref}


# The solver ablations run by ``phase_ablations``, each over the canonical
# cfgs/houv.yaml solve; 'v3' is scripts/quality_gate.py's bundle.
ABLATIONS = {
    "sigmoid": dict(reparam="sigmoid"),
    "v3_reparam": dict(reparam="v3"),
    "unconstrained": dict(reparam="unconstrained"),
    "two_bracket": dict(two_bracket=True),
    "euler": dict(rotation_mode="euler"),
    "multi_percent": dict(objective="multi_percent"),
    "select_percent": dict(select_percent=1.0),
    "consensus": dict(window_select="consensus"),
    "voxel_downsample": dict(voxel_downsample=50),
    "v3": dict(reparam="v3", objective="multi_percent", two_bracket=True,
               lr=0.01, angle_passes=2),
}


def _voxel_inputs(cloud, g):
    """K4's inputs in ``ops/voxel.py:voxelize_mean`` on [-1, 1]³: the flat
    voxel ids and [1, x, y, z]."""
    from houv_tpu_torch.ops.voxel import voxel_grid_indices

    ind = voxel_grid_indices(cloud, g, -1.0, 1.0)
    flat = (ind[..., 0] * g + ind[..., 1]) * g + ind[..., 2]
    return flat, torch.cat([torch.ones_like(cloud[..., :1]), cloud], -1)


def phase_ablations():
    """The HOUV solver's ablations (``ABLATIONS``) at cfgs/houv.yaml's
    width (2048 points, 64 restarts), 4 pairs of the structured split,
    the budget cut to 100 steps (``_short_solve_inputs``): one
    ``houv_solve`` each, its transform finite, its K1 and K4 launches held
    to the code's: K1 one search an Adam step and one at each window's
    end (four with 'multi_percent': the three view searches), over the
    windows that ran; K4 two (the two clouds' voxel means) with
    ``voxel_downsample``; every other kernel of ``_completion_counters``
    none. Seconds and rotation errors printed.
    ``voxel_downsample``'s K4 sums on the card bit for bit against the
    plain version, and its voxel means against the CPU path's."""
    import dataclasses

    from houv_tpu_torch.ops.voxel import voxelize_mean
    from houv_tpu_torch.solvers.houv import (evaluate_solution, houv_solve,
                                             init_params)

    counters = _completion_counters()
    base, src, tgt, gt = _short_solve_inputs()
    rec = {"phase": "ablations", "config": "cfgs/houv.yaml", "pairs": 4,
           "restarts": base.kernel, "steps": 100, "card": card_line()}
    for name, extra in ABLATIONS.items():
        scfg = dataclasses.replace(base, **extra)
        params0 = init_params(torch.Generator().manual_seed(0), 4,
                              scfg.kernel, two_bracket=scfg.two_bracket,
                              device="cuda")
        _zero(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = houv_solve(src, tgt, scfg, params0=params0)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = {k: c.launches for k, c in counters.items()}
        r_err, t_err = evaluate_solution(out["transform"], gt)
        windows = 1 + (scfg.angle_passes - 1) * int(out["n_retry"] > 0)
        searches = 4 if scfg.objective == "multi_percent" else 1
        want = dict.fromkeys(counters, 0)
        want["nn_both"] = windows * (scfg.steps + 1) * searches
        want["scatter_add"] = 2 if scfg.voxel_downsample else 0
        rec[name] = {"options": extra, "seconds": seconds,
                     "n_retry": out["n_retry"], "windows": windows,
                     "rot_err_deg": r_err.tolist(),
                     "trans_err": t_err.tolist(),
                     "rmse": out["rmse"].tolist(), "launches": got,
                     "expected_launches": want}
        if got != want or not torch.isfinite(out["transform"]).all():
            emit(rec)
            fail(f"ablation {name}: launches {got}, expected {want}; "
                 f"transform finite: "
                 f"{bool(torch.isfinite(out['transform']).all())}")
    g = ABLATIONS["voxel_downsample"]["voxel_downsample"]
    for cloud_name, cloud in (("src", src), ("tgt", tgt)):
        check_scatter(*_voxel_inputs(cloud, g), g ** 3,
                      f"voxel_downsample {cloud_name}")
        vp, cnt = voxelize_mean(cloud, g, -1.0, 1.0)
        cvp, ccnt = voxelize_mean(cloud.cpu(), g, -1.0, 1.0)
        rec[f"voxels_{cloud_name}"] = cnt.tolist()
        if not (torch.equal(vp.cpu().view(torch.int32),
                            cvp.view(torch.int32))
                and torch.equal(cnt.cpu(), ccnt)):
            emit(rec)
            fail(f"voxelize_mean on the card differs from the CPU path "
                 f"({cloud_name})")
    emit(rec)
    return rec


# clouds above the card kernels' limits: K2's cluster design at (B, N) ->
# K, just past K2's 8192 points and at MVP's largest ground truth, and the
# two FPS of VRCNet's train step at 16384 points (the gt's, the decoder's);
# K7's at (B, N) x (B, N), its checks at few enough rounds for the plain
# version
LARGE_FPS = ((4, 16384, 2048), (4, 8193, 2048))
LARGE_FPS_PATH = ((8, 16384, 2048), (16, 18432, 2048))
LARGE_EMD = ((2, 8192, 40), (2, 16384, 12))
# the same FPS, and validate's auction at 8192 points, at cfgs/vrcnet.yaml's
# batch of 32 (the paths here run 8), where the plans weigh a second wave
# of clusters against fewer blocks a cloud
LARGE_FPS_YAML = ((32, 16384, 2048), (64, 18432, 2048))
LARGE_EMD_YAML = (32, 8192, 12)


def _large_vrcnet_cfg(tmp, n_clouds, num_points, **extra):
    """cfgs/vrcnet.yaml at MVP's num_points-point ground truth from
    2048-point scans, batch 8: ``num_input`` 2048 and no local folding (as
    the 4096-point run of ``phase_completion_models``), its widths as the
    yaml's."""
    return _model_cfg(tmp, "vrcnet", n_clouds, num_points=num_points,
                      num_input=2048, local_folding=False, batch_size=8,
                      **extra)


def _fps_counts():
    from houv_tpu_torch.ops import sampling

    fps = sampling.furthest_point_sample
    return [fps.launches, fps.large_launches, fps.global_launches]


def _check_fps_routed(pts, k, name, route):
    """``check_fps`` through the wrapper, which must launch ``route``
    ("fps_large" or "fps_global") alone."""
    before = _fps_counts()
    err = check_fps(pts, k, name)
    routed = [a - b for a, b in zip(_fps_counts(), before)]
    want = [0, 1, 0] if route == "fps_large" else [0, 0, 1]
    emit({"phase": "fps_check", "case": name, "route": route,
          "launches_fps_large_global": routed})
    if routed != want:
        fail(f"fps {name} at {pts.shape[1]} points launched (fps, "
             f"fps_large, fps_global) {routed}, expected {want}")
    return err


def _check_fps_forced(pts, k, c):
    """``csrc/fps_large.cu`` at c blocks a cloud against the plain version,
    index for index."""
    from houv_tpu_torch.ops import sampling

    saved = _fps_counts()
    ki = sampling._fps_large_cuda(pts, k, c)
    fps = sampling.furthest_point_sample
    fps.launches, fps.large_launches, fps.global_launches = saved
    pi = sampling._fps_plain(pts, k)
    mism = int((ki != pi).sum())
    emit({"phase": "fps_check", "case": f"fps_large_forced_{c}",
          "points": list(pts.shape[:2]), "k": k, "index_mismatches": mism})
    if mism:
        fail(f"fps_large at {c} blocks a cloud ({pts.shape[0]}, "
             f"{pts.shape[1]}) -> {k}: {mism} indices differ")
    return float((ki - pi).abs().max())


def _fps_large_floor(b, n, k):
    """The instruction floor of ``csrc/fps_large.cu``: 10 f32 instructions a
    point and step (``_time_fps``'s count) at 128 lanes a clock on the
    plan's SMs, at the card's maximum SM clock."""
    from houv_tpu_torch.ops import sampling

    c, _, _ = sampling._fps_cluster_plan(
        n, b, lambda c, w, p: sampling._held(c, w, p, 0))
    sms = min(torch.cuda.get_device_properties(0).multi_processor_count,
              b * c)
    return {"plan_blocks_a_cloud": c,
            "floor_ms": 10.0 * b * n * (k - 1)
            / (sms * 128 * _sm_max_clock_mhz() * 1e3)}


def _emd_past_capacity(n):
    """The fewest items past which ``csrc/emd_large.cu`` cannot hold a pair
    of n bidders: the pair one item past its capacity."""
    from houv_tpu_torch.kernels import load

    lib = load()
    top = lib.houv_emd_max_smem_bytes()
    m = n
    while lib.houv_emd_large_smem_bytes(n, m, 8) <= top:
        m += 1
    return m


def phase_large_clouds(gen):
    """Clouds above K2's and K7's limits. K2's cluster design
    (``csrc/fps_large.cu``) index for index against the plain version at
    ``LARGE_FPS``, sizes off its blocks, K == N, an integer grid, every
    point twice, its capacity and ``LARGE_FPS_YAML``, each through the
    wrapper's route; at every cluster size its plan can pick, forced; one
    point past its capacity on the global-memory design
    (``csrc/fps_global.cu``). K7's cluster design (``csrc/emd_large.cu``)
    at ``LARGE_EMD``, ``LARGE_EMD_YAML`` and N != M (assignments,
    distances' bits, rounds and bids against the plain version at few
    rounds), and a pair one item past its capacity on
    ``csrc/emd_global.cu``. Each design timed at its shapes (the global
    ones at one shape past the capacities, after one call through the
    public entry point there). Then the paths: 3 train steps of
    cfgs/vrcnet.yaml at num_points 16384, batch 8 (K2's cluster design
    twice a step: the ground truth's FPS to the 2048 input points and the
    decoder's of its coarse cloud to ``num_fps``), and ``validate`` with
    eval_emd at num_points 8192, batch 8 (K7's cluster design, once a
    batch), each with its launches by route and the (B, N, K) of each FPS
    launch past K2's limit (``_FpsLargeInputs``), the design held to the
    plain version on the path's first cloud at each of them. Returns the
    ``kernels`` line's four rows."""
    from houv_tpu_torch.kernels import load
    from houv_tpu_torch.ops import emd, sampling
    from houv_tpu_torch.train.cli import build_dataset
    from houv_tpu_torch.train.config import load_config
    from houv_tpu_torch.train.harness import CompletionTrainer

    lib = load()
    cap = lib.houv_fps_large_max_points()
    fps_err = 0.0
    cases = [(*shape, "large") for shape in LARGE_FPS]
    cases += [(2, 12345, 1000, "off_the_blocks"), (1, 9000, 9000, "k_equals_n"),
              (1, cap, 256, "capacity")]
    for b, n, k, name in cases:
        fps_err = max(fps_err, _check_fps_routed(
            torch.randn((b, n, 3), generator=gen).cuda(), k, name,
            "fps_large"))
    grid = torch.randint(0, 8, (2, 12000, 3), generator=gen).float()
    fps_err = max(fps_err, _check_fps_routed(grid.cuda(), 2000,
                                             "integer_grid", "fps_large"))
    twice = torch.randn((1, 16384, 3), generator=gen)
    twice[:, 8192:] = twice[:, :8192]
    fps_err = max(fps_err, _check_fps_routed(twice.cuda(), 4096,
                                             "every_point_twice", "fps_large"))
    for b, n, k in LARGE_FPS_YAML:
        fps_err = max(fps_err, _check_fps_routed(
            torch.randn((b, n, 3), generator=gen).cuda(), k,
            f"yaml_batch_{b}", "fps_large"))
    admitted = [c for c in sampling._FPS_CLUSTERS
                if sampling._held(c, *sampling._fps_plan(-(-16384 // c)),
                                  0) > 0]
    for b, n, k in ((2, 16384, 1024), (2, 8193, 512)):
        pts = torch.randn((b, n, 3), generator=gen).cuda()
        for c in admitted:
            if -(-n // c) <= sampling._FPS_BLOCK_POINTS:
                fps_err = max(fps_err, _check_fps_forced(pts, k, c))
    past = torch.randn((1, cap + 1, 3), generator=gen).cuda()
    fps_global_err = _check_fps_routed(past, 256, "capacity_plus_one",
                                       "fps_global")
    fps_rows = []
    for i, (b, n, k) in enumerate(LARGE_FPS + LARGE_FPS_PATH
                                  + LARGE_FPS_YAML):
        fps_rows.append({**_time_fps(b, n, k, "large_clouds", gen,
                                     plain=i == 0),
                         **_fps_large_floor(b, n, k)})
    # the global design at one shape past the capacity, through the
    # public entry point first, then timed
    counters = _completion_counters()
    _zero(counters)
    sampling.furthest_point_sample(past, 2048)
    torch.cuda.synchronize()
    fps_global_launches = _read(counters)
    emit({"phase": "large_clouds", "run": "fps_past_capacity",
          "points": [1, cap + 1], "k": 2048,
          "launches": fps_global_launches})
    if fps_global_launches != {"fps_global": 1}:
        fail(f"fps past the capacity launched {fps_global_launches}")
    fps_global_row = _time_fps(1, cap + 1, 2048, "past_capacity", gen,
                               plain=True)
    del past, grid, twice
    torch.cuda.empty_cache()

    emd_err, emd_rows = 0.0, []
    for b, n, iters in LARGE_EMD:
        x1 = torch.rand((b, n, 3), generator=gen).cuda() - 0.5
        x2 = torch.rand((b, n, 3), generator=gen).cuda() - 0.5
        emd_err = max(emd_err, check_emd(x1, x2, 0.004, iters,
                                         f"large_{n}"))
        row = {"path": "large_clouds", **_time_emd(x1, x2, 0.004, iters)}
        if not emd_rows:
            row["plain_ms"] = cuda_ms(
                lambda: emd._auction_plain(x1, x2, 0.004, iters), reps=1,
                warmup=0)
        emd_rows.append(row)
        emd_rows.append({"path": "large_clouds, validate's setting",
                         **_time_emd(x1, x2, 0.004, 3000)})
        del x1, x2
        torch.cuda.empty_cache()
    b, n, iters = LARGE_EMD_YAML
    x1 = torch.rand((b, n, 3), generator=gen).cuda() - 0.5
    x2 = torch.rand((b, n, 3), generator=gen).cuda() - 0.5
    emd_err = max(emd_err, check_emd(x1, x2, 0.004, iters,
                                     f"large_{n}_batch_{b}"))
    emd_rows.append({"path": "large_clouds, the yaml's batch, validate's "
                             "setting", **_time_emd(x1, x2, 0.004, 3000)})
    del x1, x2
    torch.cuda.empty_cache()
    for n, m in ((7000, 9000), (9000, 7000)):
        x1 = torch.rand((2, n, 3), generator=gen).cuda() - 0.5
        x2 = torch.rand((2, m, 3), generator=gen).cuda() - 0.5
        if emd_route(n, m) != "emd_large":
            fail(f"emd at {n} bidders and {m} items is not routed to "
                 "emd_large")
        emd_err = max(emd_err, check_emd(x1, x2, 0.005, 20,
                                         f"large_{n}_{m}"))
    n_cap = 17272
    m_past = _emd_past_capacity(n_cap)
    x1 = torch.rand((1, n_cap, 3), generator=gen).cuda() - 0.5
    x2 = torch.rand((1, m_past, 3), generator=gen).cuda() - 0.5
    if emd_route(n_cap, m_past - 1) != "emd_large" \
            or emd_route(n_cap, m_past) != "emd_global":
        fail(f"emd's capacity edge at {n_cap} bidders is not {m_past} items")
    emd_global_err = check_emd(x1, x2, 0.005, 5,
                               f"one_item_past_capacity_{m_past}")
    _zero(counters)
    emd.emd_auction(x1, x2, 0.004, 3000)
    torch.cuda.synchronize()
    emd_global_launches = _read(counters)
    emit({"phase": "large_clouds", "run": "emd_past_capacity",
          "x1": [1, n_cap], "x2": [1, m_past],
          "launches": emd_global_launches})
    if emd_global_launches != {"emd_global": 1}:
        fail(f"emd past the capacity launched {emd_global_launches}")
    emd_global_row = {"path": "past_capacity",
                      **_time_emd(x1, x2, 0.004, 3000)}
    emd_global_row["plain_ms"] = cuda_ms(
        lambda: emd._auction_plain(x1, x2, 0.004, 5), reps=1, warmup=0)
    emd_global_row["plain_iters"] = 5
    del x1, x2
    torch.cuda.empty_cache()

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        cfg = load_config(_large_vrcnet_cfg(tmp, 24, 16384))
        trainer = CompletionTrainer(cfg)
        trainer.init_state()
        ds = build_dataset(cfg, "train")
        batches = [ds.get_batch(np.arange(8 * i, 8 * i + 8),
                                rng=np.random.default_rng(i))
                   for i in range(3)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero(counters)
        t0 = time.perf_counter()
        with _FpsLargeInputs() as path_fps:
            losses = [float(trainer.train_step(bt, 0, i))
                      for i, bt in enumerate(batches)]
            torch.cuda.synchronize()
        launches["train_16384"] = _read(counters)
        rec = {"phase": "large_clouds", "run": "train_steps",
               "config": "cfgs/vrcnet.yaml", "num_points": 16384,
               "num_input": 2048, "local_folding": False, "batch": 8,
               "steps": 3, "losses": losses,
               "seconds": time.perf_counter() - t0,
               "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
               "launches": launches["train_16384"],
               "fps_large_shapes": path_fps.shapes}
        emit(rec)
        # two of a step's FPS pass K2's limit: the ground truth's to the
        # 2048 input points and the decoder's of its coarse cloud to
        # num_fps (models/vrcnet.py's, (16, 18432) -> 2048 on an H100),
        # both on the cluster design
        if not np.isfinite(losses).all() \
                or launches["train_16384"].get("fps_large") != 2 * 3 \
                or launches["train_16384"].get("fps_global") \
                or len(path_fps.shapes) != 2 * 3:
            fail(f"vrcnet at 16384 points: {rec}")
        # the design at each of the path's shapes, on the path's own
        # first cloud there, index for index against the plain version
        for pts, k in path_fps.kept:
            fps_err = max(fps_err, check_fps(pts, k, "train_16384"))
        del trainer, batches, path_fps
        torch.cuda.empty_cache()

        cfg = load_config(_large_vrcnet_cfg(tmp, 8, 8192, eval_emd=True))
        trainer = CompletionTrainer(cfg)
        trainer.init_state()
        val_ds = build_dataset(cfg, "val")
        torch.cuda.synchronize()
        _zero(counters)
        t0 = time.perf_counter()
        with _FpsLargeInputs() as path_fps:
            metrics = trainer.validate(val_ds)
            torch.cuda.synchronize()
        launches["validate_8192"] = _read(counters)
        rec = {"phase": "large_clouds", "run": "validate",
               "config": "cfgs/vrcnet.yaml", "num_points": 8192,
               "num_input": 2048, "eval_emd": True, "clouds": len(val_ds),
               "seconds": time.perf_counter() - t0, "metrics": metrics,
               "launches": launches["validate_8192"],
               "fps_large_shapes": path_fps.shapes}
        emit(rec)
        want = len(val_ds) // 8
        if set(metrics) != {"cd_p", "cd_t", "f1", "emd"} \
                or not all(np.isfinite(v) for v in metrics.values()) \
                or launches["validate_8192"].get("emd_large") != want \
                or launches["validate_8192"].get("emd") \
                or launches["validate_8192"].get("emd_global") \
                or launches["validate_8192"].get("fps_large", 0) \
                != len(path_fps.shapes):
            fail(f"vrcnet validate at 8192 points: {rec}")
        for pts, k in path_fps.kept:
            fps_err = max(fps_err, check_fps(pts, k, "validate_8192"))
        del path_fps
        batch = val_ds.get_batch(np.arange(8))
        fine = trainer.predict_batch(batch, step=0)
        gt = torch.as_tensor(batch["gt"], device="cuda")
        emd_rows.append({"path": "validate 8192",
                         **_time_emd(fine, gt, 0.004, 3000)})
        del trainer, fine, gt
        torch.cuda.empty_cache()
    fps_row = {"name": "fps_large", "route": "cuda",
               "source": "houv_tpu_torch/csrc/fps_large.cu",
               "replaces": "houv_tpu/ops/sampling.py:43",
               "launches": launches["train_16384"].get("fps_large", 0),
               "max_abs_err": fps_err, **fps_rows[0], "library_ms": None,
               "at_shapes": fps_rows}
    fps_global = {"name": "fps_global", "route": "cuda",
                  "source": "houv_tpu_torch/csrc/fps_global.cu",
                  "replaces": "houv_tpu/ops/sampling.py:43",
                  "launches": fps_global_launches.get("fps_global", 0),
                  "launches_on": f"furthest_point_sample at (1, {cap + 1}) "
                                 "-> 2048, past fps_large's capacity",
                  "max_abs_err": fps_global_err, **fps_global_row,
                  "library_ms": None}
    emd_row = {"name": "emd_large", "route": "cuda",
               "source": "houv_tpu_torch/csrc/emd_large.cu",
               "replaces": "houv_tpu/ops/emd_kernel.py:48",
               "launches": launches["validate_8192"].get("emd_large", 0),
               "max_abs_err": emd_err, **emd_rows[0], "library_ms": None,
               "at_shapes": emd_rows}
    emd_global = {"name": "emd_global", "route": "cuda",
                  "source": "houv_tpu_torch/csrc/emd_global.cu",
                  "replaces": "houv_tpu/ops/emd_kernel.py:48",
                  "launches": emd_global_launches.get("emd_global", 0),
                  "launches_on": f"emd_auction at (1, {n_cap}) x (1, "
                                 f"{m_past}), past emd_large's capacity",
                  "max_abs_err": emd_global_err, **emd_global_row,
                  "library_ms": None}
    return {"rows": [fps_row, fps_global, emd_row, emd_global],
            "launches": launches}


# MVPN preprocessing at full width: one synthetic class of 1024 partial
# scans of 2048 points (64 models x 16 views), k 6, 10 Adam epochs; the
# card's F1 matrix held to the plain arithmetic on the card over the first
# PRE_CHECK clouds and to the CPU path over the first PRE_CPU
PRE_MODELS, PRE_VIEWS, PRE_POINTS = 64, 16, 2048
PRE_CHECK, PRE_CPU = 64, 8


def _plain_f1(partials):
    """The F1 of every pair of ``partials`` ((N, P, 3) on the card) as
    ``data/preprocess.py:pairwise_f1`` computes it, its nearest neighbours
    from the plain version (``ops/chamfer.py:_nn_both_plain``)."""
    from houv_tpu_torch.metrics.cd import fscore
    from houv_tpu_torch.ops import chamfer
    from houv_tpu_torch.ops.gather import gather_rows

    n = partials.shape[0]
    out = torch.empty((n, n), device=partials.device)
    for i in range(n):
        out_c = partials[i:i + 1].expand_as(partials).contiguous()
        i1, i2 = chamfer._nn_both_plain(partials, out_c)
        d1 = ((partials - gather_rows(out_c, i1)) ** 2).sum(-1)
        d2 = ((out_c - gather_rows(partials, i2)) ** 2).sum(-1)
        out[i] = fscore(d1, d2)[0]
    return out.cpu().numpy()


def _f1_agree(f1, ref, knn, k):
    """F1 entries equal, and each row's kNN equal to the reference's away
    from ties at its k-th score (the scores at the picks equal)."""
    from houv_tpu_torch.data.preprocess import _top_k

    n = len(ref)
    ref_knn = _top_k(ref, k)
    s = np.array(ref, copy=True)
    np.fill_diagonal(s, -np.inf)
    srt = -np.sort(-s, axis=1)
    untied = srt[:, k - 1] != srt[:, k]
    same = [np.array_equal(np.sort(knn[i]), np.sort(ref_knn[i]))
            for i in range(n)]
    scores_equal = all(np.array_equal(s[i, knn[i]], s[i, ref_knn[i]])
                       for i in range(n))
    return {"f1_max_abs_diff": float(np.abs(f1 - ref).max()),
            "rows_untied": int(untied.sum()),
            "knn_equal_untied": bool(all(same[i] for i in range(n)
                                         if untied[i])),
            "scores_at_picks_equal": scores_equal}


def phase_preprocess():
    """``data/preprocess.py:combine_dataset`` on the card at full width:
    one synthetic class of 1024 scans of 2048 points, k 6, 10 epochs, in
    mode f1 (the all-pairs chamfer F1: 1,048,576 pairs through K1, 16 x
    1024 a call; BFS; a fused cloud a cluster: K4's voxel means, 10 Adam
    steps of K1 and K4) and in mode embedding (the trained instance
    embedding of log/); pairs/s of the F1 sweep, K1 and K4 launches,
    clusters and the largest, seconds a stage. The card's F1 and kNN over
    the first 64 clouds against the plain arithmetic on the card, and over
    the first 8 against the CPU path, away from F1 ties."""
    from houv_tpu_torch.data import preprocess, synthesize_completion_set
    from houv_tpu_torch.models import get_model
    from houv_tpu_torch.state import state_from_flax
    from houv_tpu_torch.train.checkpoint import read_flax_msgpack

    t0 = time.perf_counter()
    data = synthesize_completion_set(PRE_MODELS, PRE_VIEWS, PRE_POINTS,
                                     PRE_POINTS, seed=11)
    partials = data["incomplete_pcds"]
    labels = np.zeros(len(partials), np.int64)            # one class
    synth_s = time.perf_counter() - t0
    n, k = len(partials), 6
    counters = _completion_counters()
    out = {}

    _zero(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f1 = preprocess.pairwise_f1(partials)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    sweep = {"phase": "preprocess", "run": "f1_sweep", "clouds": n,
             "points": PRE_POINTS, "pairs": n * n, "seconds": sweep_s,
             "pairs_per_s": n * n / sweep_s, "launches": _read(counters)}
    knn = preprocess._top_k(f1, k)
    sub = torch.as_tensor(partials[:PRE_CHECK], device="cuda")
    sweep["plain_on_card"] = _f1_agree(f1[:PRE_CHECK, :PRE_CHECK],
                                       _plain_f1(sub),
                                       preprocess._top_k(
                                           f1[:PRE_CHECK, :PRE_CHECK], k), k)
    cpu = preprocess.pairwise_f1(partials[:PRE_CPU], device="cpu")
    sweep["cpu_path"] = _f1_agree(f1[:PRE_CPU, :PRE_CPU], cpu,
                                  preprocess._top_k(f1[:PRE_CPU, :PRE_CPU],
                                                    k), k)
    emit(sweep)
    for side in ("plain_on_card", "cpu_path"):
        agree = sweep[side]
        if agree["f1_max_abs_diff"] > 1e-6 or not (
                agree["knn_equal_untied"] and agree["scores_at_picks_equal"]):
            fail(f"preprocess: the card's F1 differs from the {side}: "
                 f"{agree}")
    del sub
    out["f1_sweep"] = sweep

    for mode in ("f1", "embedding"):
        kw = {}
        if mode == "embedding":
            state = read_flax_msgpack(str(REPO / AUX_CKPTS["embedding"]))
            model = get_model("model_embedding")
            model.load_state_dict(state_from_flax(state, model), strict=True)
            model = model.cuda().eval()
            kw["embed_fn"] = lambda x: model(x)[0]
        stages = {}
        _zero(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        knn_all, fused, cid = preprocess.combine_dataset(
            partials, labels, k=k, epochs=10, mode=mode, stages=stages,
            **kw)
        torch.cuda.synchronize()
        rec = {"phase": "preprocess", "run": "combine_dataset", "mode": mode,
               "clouds": n, "points": PRE_POINTS, "k": k, "epochs": 10,
               "seconds": time.perf_counter() - t0,
               "stage_seconds": stages,
               "clusters": int(cid.max()) + 1,
               "largest_cluster": int(np.bincount(cid).max()),
               "launches": _read(counters),
               "fused_moved_max": float(np.abs(fused - partials).max())}
        if mode == "f1":
            rec["knn_equal_sweep"] = bool(np.array_equal(knn_all, knn))
        emit(rec)
        if not (np.isfinite(fused).all() and (cid >= 0).all()
                and knn_all.shape == (n, k)
                and (knn_all != np.arange(n)[:, None]).all()
                and rec.get("knn_equal_sweep", True)
                and rec["launches"].get("scatter_add", 0) > 0
                and (mode == "embedding"
                     or rec["launches"].get("nn_both", 0) > 0)):
            fail(f"preprocess: combine_dataset in mode {mode}: {rec}")
        out[mode] = rec
    out["synthesis_s"] = synth_s
    torch.cuda.empty_cache()
    return out


NATIVE_STEPS = 8


def phase_native():
    """The native C++ loader (``data/native_loader.py``, built into
    build/native/) on cfgs/deepgmr.yaml at full width (batch 32, 2048
    points): ``train_main`` with ``use_native_loader`` and ``native_steps``
    8 (its launches, K6 2 a step and 2 a val batch); the steps/s of 8
    steps fed by the loader beside 8 fed by the in-memory split (one
    trainer each, steps 2..8, ending in a sync) and the loader's queue;
    then ``train_main`` with ``profile_dir`` and ``profile_steps`` 3: the
    Chrome trace exists and names the steps' K6 launches."""
    from houv_tpu_torch.data.native_loader import NativeRegistrationLoader
    from houv_tpu_torch.data.pipeline import batch_iterator
    from houv_tpu_torch.train.cli import build_dataset, make_trainer, train_main
    from houv_tpu_torch.train.config import load_config

    counters = _completion_counters()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = _model_cfg(tmp, "deepgmr", 64, use_native_loader=True,
                          native_steps=NATIVE_STEPS)
        _zero(counters)
        res = train_main(["-c", path])
        launches = _read(counters)
        cfg = res["trainer"].cfg
        val_batches = len(build_dataset(cfg, "val")) // cfg.batch_size
        expected = {"knn": 2 * (NATIVE_STEPS + val_batches)}
        rec = {"phase": "native", "run": "train_main",
               "config": "cfgs/deepgmr.yaml", "batch": cfg.batch_size,
               "steps": res["steps"], "losses": res["losses"],
               "queue_size": res["queue_size"], "seconds": res["seconds"],
               "launches": launches, "expected_launches": expected}
        emit(rec)
        if res["steps"] != NATIVE_STEPS or launches != expected \
                or not np.isfinite(res["losses"]).all():
            fail(f"native loader: {rec}")
        out["train_main"] = rec
        del res

        # steps/s, one trainer fed by each loader
        rates = {}
        train_ds = build_dataset(cfg, "train")
        for feed in ("native", "in_memory"):
            trainer = make_trainer(cfg, "cuda")
            trainer.init_state()
            if feed == "native":
                loader = NativeRegistrationLoader(
                    train_ds.src, train_ds.tgt, cfg.batch_size,
                    max_angle_deg=cfg.max_angle, max_trans=cfg.max_trans,
                    seed=2021)
                nxt = loader.next_batch
            else:
                it = itertools.cycle(list(batch_iterator(
                    trainer.wrap_dataset(train_ds), cfg.batch_size,
                    shuffle=True, drop_last=True, seed=0)))
                nxt = lambda: next(it)  # noqa: E731
            batches = (lambda: {k: torch.as_tensor(v, device="cuda")
                                for k, v in nxt().items()})
            trainer.train_step(batches(), 0, 0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for step in range(1, NATIVE_STEPS):
                trainer.train_step(batches(), 0, step)
            torch.cuda.synchronize()
            rates[feed] = (NATIVE_STEPS - 1) / (time.perf_counter() - t0)
            if feed == "native":
                rates["queue_size"] = loader.queue_size()
                loader.close()
            del trainer
        rec = {"phase": "native", "run": "steps_per_s",
               "config": "cfgs/deepgmr.yaml", "batch": cfg.batch_size,
               "steps_per_s_native": rates["native"],
               "steps_per_s_in_memory": rates["in_memory"],
               "queue_size_after": rates["queue_size"]}
        emit(rec)
        out["rates"] = rec

        prof_dir = Path(tmp) / "profile"
        profile_steps = 3
        path = Path(_model_cfg(tmp, "deepgmr", 128, nepoch=1,
                               profile_steps=profile_steps))
        raw = yaml.safe_load(path.read_text())
        raw["profile_dir"] = str(prof_dir)
        path.write_text(yaml.safe_dump(raw))
        res = train_main(["-c", str(path)])
        trace = prof_dir / "trace_rank0.json"
        events = json.loads(trace.read_text())["traceEvents"] \
            if trace.exists() else []
        kernels = [e for e in events if e.get("cat") == "kernel"]
        knn_kernels = sum("knn" in e.get("name", "") for e in kernels)
        # the host's step annotations (the device's timeline mirrors each
        # as a gpu_user_annotation)
        steps = sum(1 for e in events if e.get("ph") == "X"
                    and e.get("cat") != "gpu_user_annotation"
                    and e.get("name", "").startswith("Optimizer.step"))
        rec = {"phase": "native", "run": "profile_dir",
               "trace": trace.exists(), "trace_bytes":
                   trace.stat().st_size if trace.exists() else 0,
               "kernel_events": len(kernels), "knn_kernel_events":
                   knn_kernels, "optimizer_steps_traced": steps,
               "steps_run": len(res["losses"])}
        emit(rec)
        # the steps' K6 launches (two a DeepGMR step) named in the trace;
        # CUPTI may drop a kernel at the very start of a trace (one of six
        # in one run on an H100)
        if not (trace.exists() and steps == profile_steps
                and knn_kernels >= 2 * profile_steps - 1):
            fail(f"profile_dir: {rec}")
        out["profile"] = rec
    torch.cuda.empty_cache()
    return out


def _short_solve_inputs(pairs=4):
    """cfgs/houv.yaml's solver config with the budget cut to 100 steps, and
    ``pairs`` pairs of the structured split on the card: (config, src, tgt,
    gt)."""
    import dataclasses

    from houv_tpu_torch.data import synthesize_registration_pairs
    from houv_tpu_torch.train.cli import solver_config
    from houv_tpu_torch.train.config import load_config

    cfg = load_config(str(REPO / "cfgs" / "houv.yaml"))
    base = dataclasses.replace(solver_config(cfg), steps=100)
    d = synthesize_registration_pairs(
        pairs, n_points=cfg.num_points, max_angle_deg=cfg.max_angle,
        max_trans=cfg.max_trans, seed=7, shape_mode="structured",
        rot_mix=True)
    return base, *(torch.as_tensor(d[k], device="cuda")
                   for k in ("rotated_src", "rotated_tgt", "transforms"))


def phase_scatter_solve():
    """``houv_solve`` with ``grad_mode='scatter'`` beside the gather mode:
    4 pairs of the structured split, cfgs/houv.yaml with the budget cut to
    100 steps. One scatter launch per Adam step (the target needs no
    gradient), in every angle window that runs."""
    import dataclasses

    from houv_tpu_torch.ops.scatter import scatter_add
    from houv_tpu_torch.solvers.houv import (evaluate_solution, houv_solve,
                                             init_params)

    base, src, tgt, gt = _short_solve_inputs()
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


def _profiled_steps(scfg, src, tgt, params0, steps):
    """torch.profiler over ``steps`` Adam steps of ``scfg`` from params0:
    the port's kernels by name (``_profile_top``), the device memsets
    listed, and K3's counted launches."""
    from torch.profiler import ProfilerActivity, profile

    from houv_tpu_torch.ops.chamfer import chamfer_indices, nn_select
    from houv_tpu_torch.solvers.houv import _adam_init, _adam_loop

    saved = (nn_select.launches, chamfer_indices.launches)
    nn_select.launches = 0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _adam_loop(src, tgt, 0.0, scfg, params0, _adam_init(params0), steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = nn_select.launches
    nn_select.launches, chamfer_indices.launches = saved
    top = _profile_top(prof, wall_ms)
    memsets = sum(ev.count for ev in prof.key_averages()
                  if "memset" in ev.key.lower()
                  and str(getattr(ev, "device_type", "")).endswith("CUDA"))
    return {"steps": steps, "wall_ms": wall_ms,
            "device_ms": top["device_ms"], "launches": launches,
            "port_kernels": top["port_kernels"], "memsets": memsets}


def phase_select_solve():
    """``houv_solve`` with ``nn_select=True`` beside the default: 4 pairs
    of the structured split, cfgs/houv.yaml with the budget cut to 100
    steps. One nn_select launch per Adam step in every angle window that
    runs, one more for each window's final objective, and no nn_both; in a
    profiled window of 5 steps at the solver's 16 pairs (1024 rows, the
    launch plan direct) the select branch runs nn_select_kernel alone of
    the port's kernels, once a step, and lists no memset. The
    first five steps' losses from the same restarts are held against the
    default's at 1e-5 relative: the matched raw source rows come back as
    R^T (c1 - t) and differ from the gathered rows by that product's
    rounding."""
    import dataclasses

    from houv_tpu_torch.ops.chamfer import chamfer_indices, nn_select
    from houv_tpu_torch.solvers.houv import (_adam_init, _adam_loop,
                                             evaluate_solution, houv_solve,
                                             init_params)

    base, src, tgt, gt = _short_solve_inputs()
    rec = {"phase": "select_solve", "config": "cfgs/houv.yaml", "pairs": 4,
           "restarts": base.kernel, "steps": 100,
           "loss_tolerance_rel": 1e-5}
    first = {}
    for select in (False, True):
        name = "nn_select" if select else "default"
        scfg = dataclasses.replace(base, nn_select=select)
        params0 = init_params(torch.Generator().manual_seed(0), 4,
                              scfg.kernel, device="cuda")
        saved = (nn_select.launches, chamfer_indices.launches)
        first[name] = _adam_loop(src, tgt, 0.0, scfg, params0,
                                 _adam_init(params0), 5)[2].tolist()
        nn_select.launches, chamfer_indices.launches = 0, 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = houv_solve(src, tgt, scfg, params0=params0)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        r_err, _ = evaluate_solution(out["transform"], gt)
        windows = 1 + (scfg.angle_passes - 1) * int(out["n_retry"] > 0)
        rec[name] = {"seconds": seconds, "n_retry": out["n_retry"],
                     "windows": windows, "first_losses": first[name],
                     "rot_err_deg": r_err.tolist(),
                     "rmse": out["rmse"].tolist(),
                     "nn_select_launches": nn_select.launches,
                     "nn_both_launches": chamfer_indices.launches}
        want = (101 * windows, 0) if select else (0, 101 * windows)
        got = (nn_select.launches, chamfer_indices.launches)
        nn_select.launches, chamfer_indices.launches = saved
        if got != want or not torch.isfinite(out["transform"]).all():
            emit(rec)
            fail(f"houv_solve nn_select={select}: (nn_select, nn_both) "
                 f"launches {got}, expected {want}")
    rec["first_losses_rel_diff"] = max(
        abs(a - b) / abs(b) for a, b in zip(first["nn_select"],
                                            first["default"]))
    # A profiled window of 5 Adam steps of each branch at the solver's
    # shape, 16 pairs of 64 restarts (1024 rows; the 4 pairs above give 256
    # rows, where the plan splits the queries): both directions whole, so
    # K3 is one kernel a step, with no memset of key scratch and no unpack
    # pass (K1 likewise).
    _, src16, tgt16, _ = _short_solve_inputs(16)
    params16 = init_params(torch.Generator().manual_seed(0), 16,
                           base.kernel, device="cuda")
    for select in (False, True):
        name = "nn_select" if select else "default"
        rec[name]["profiled_window"] = _profiled_steps(
            dataclasses.replace(base, nn_select=select), src16, tgt16,
            params16, 5)
    window = rec["nn_select"]["profiled_window"]
    if (window["memsets"] or window["launches"] != 5
            or window["port_kernels"].get("nn_select_kernel", {}).get(
                "count") != 5
            or set(window["port_kernels"]) != {"nn_select_kernel"}):
        emit(rec)
        fail(f"houv_solve nn_select=True: the profiled window at 16 pairs "
             f"ran {window['port_kernels']} and {window['memsets']} memsets "
             f"for {window['launches']} launches, expected "
             f"nn_select_kernel alone, once a step, and no memset")
    del src16, tgt16, params16
    # The exported row gather (it has no caller in either package) on this
    # solve's matches, as ``_pair_matches`` gathers them: both ways, bit for
    # bit what ``gather_rows`` returns.
    from houv_tpu_torch.ops import gather_rows, gather_rows_kernel
    from houv_tpu_torch.solvers.houv import _apply, reparametrize

    saved = chamfer_indices.launches
    r, t = reparametrize(params0, 0.0, base.tran_mode)
    n = src.shape[1]
    i1, i2 = chamfer_indices(tgt, _apply(src, r, t).reshape(-1, n, 3))
    chamfer_indices.launches = saved
    gather_rows_kernel.launches = 0
    rows = [(tgt, i2.reshape(4, -1)), (src, i1.reshape(4, -1))]
    same = all(torch.equal(gather_rows_kernel(table, idx),
                           gather_rows(table, idx)) for table, idx in rows)
    rec["gather_rows"] = {"launches": gather_rows_kernel.launches,
                          "src": list(src.shape),
                          "idx": list(rows[0][1].shape),
                          "bit_equal_to_gather_rows": same}
    emit(rec)
    if not same or gather_rows_kernel.launches != 2:
        fail(f"the exported row gather on the solve's matches: "
             f"{rec['gather_rows']}")
    if not rec["first_losses_rel_diff"] <= 1e-5:
        fail("houv_solve with nn_select: the first steps' losses differ "
             f"from the default's by {rec['first_losses_rel_diff']:.3g}")
    return rec


def _small_ecg_step(cfg, batch, dev, dtype, picks=None):
    """One forward and backward of the seeded small ECG on ``dev`` in
    ``dtype``: total_loss, the gradients by name (f64, on the CPU), the
    picks it made (FPS, both kNN forms, ball queries, chamfer matches, in
    call order) and, with another run's ``picks``, how many of its own
    differ from them; it then goes on with the given ones."""
    from houv_tpu_torch.ops.chamfer import chamfer_indices
    from houv_tpu_torch.ops.grouping import ball_query, knn_indices
    from houv_tpu_torch.ops.sampling import furthest_point_sample
    from houv_tpu_torch.train.harness import CompletionTrainer

    model = CompletionTrainer(cfg, dev).init_state().to(dtype)
    fns = {"fps": furthest_point_sample, "knn": knn_indices,
           "ball": ball_query, "matches": chamfer_indices}
    given = picks or dict.fromkeys(fns)
    stand_ins = {k: _Picks(fn, given[k]) for k, fn in fns.items()}
    for p in stand_ins.values():
        p.__enter__()
    try:
        out = model(torch.as_tensor(batch["partial"], device=dev).to(dtype),
                    torch.as_tensor(batch["gt"], device=dev).to(dtype),
                    "train", alpha=0.5)
    finally:
        for p in stand_ins.values():
            p.__exit__()
    out["total_loss"].backward()
    return (out["total_loss"].item(),
            {n: p.grad.double().cpu() for n, p in model.named_parameters()},
            {k: p.kept for k, p in stand_ins.items()},
            {k: p.flips for k, p in stand_ins.items()})


def phase_train_reference_ecg():
    """One ECG train step at the parity tests' size (256 points, 128
    coarse, batch 8; the encoder's default hierarchy asks FPS for 1024 of
    384 points) on the card against the port's CPU path in f64, as
    ``phase_train_reference`` does for VRCNet: same seeded weights and
    batch; the card computes its own picks (FPS, the coordinate and the
    feature-space kNN, the ball queries, the chamfer matches) with the
    kernels, counts where they differ from the f64 run's and goes on with
    the f64 run's. total_loss to 1e-4 relative, every parameter's gradient
    to 1e-3 of that tensor's largest f64 entry."""
    from houv_tpu_torch.train.cli import build_dataset
    from houv_tpu_torch.train.config import Config

    with open(REPO / "cfgs" / "ecg.yaml") as f:
        raw = yaml.safe_load(f)
    raw.update(num_points=256, num_coarse=128, batch_size=8,
               synthetic_size=16)
    cfg = Config.from_dict(raw)
    batch = build_dataset(cfg, "train").get_batch(
        np.arange(8), rng=np.random.default_rng(0))
    ref_loss, ref_g, picks, _ = _small_ecg_step(cfg, batch, "cpu",
                                                torch.float64)
    loss, grads, _, flips = _small_ecg_step(cfg, batch, "cuda",
                                            torch.float32, picks)
    rows = sorted(((float((grads[n] - r).abs().max() / r.abs().max()), n,
                    float(r.abs().max())) for n, r in ref_g.items()),
                  reverse=True)
    rec = {"phase": "train_reference", "model": "ecg", "clouds": 8,
           "points": 256, "total_loss_cpu_f64": ref_loss,
           "total_loss": loss,
           "loss_rel_diff": abs(loss - ref_loss) / abs(ref_loss),
           "loss_tolerance_rel": 1e-4,
           "grad_tolerance_over_tensor_max": 1e-3,
           "picks": {k: sum(t.numel() for v in kept
                            for t in _index_tensors(v))
                     for k, kept in picks.items()},
           "picks_differing_from_f64": flips, "parameters": len(ref_g),
           "worst_grads": [{"name": n, "err_over_tensor_max": e,
                            "tensor_max": m} for e, n, m in rows[:4]]}
    emit(rec)
    if not (rec["loss_rel_diff"] <= 1e-4 and rows[0][0] <= 1e-3):
        fail(f"ECG train step on the card differs from the f64 CPU path: "
             f"loss {rec['loss_rel_diff']:.3g} relative, gradient of "
             f"{rows[0][1]} {rows[0][0]:.3g} of its largest entry")


def phase_profile_train(model="vrcnet", **extra):
    """Where one train step's time goes on cfgs/<model>.yaml (``extra``
    overriding its keys, as ``loss="emd"``): torch.profiler over one step
    of the config's batch (32 clouds; vrcnet_knn's 16) at full width, after
    two warm-up steps, the second of them with K2's census
    (``fps_census``: (B, N, K) of each launch)."""
    from torch.profiler import ProfilerActivity, profile

    from houv_tpu_torch.ops.sampling import furthest_point_sample
    from houv_tpu_torch.train.cli import build_dataset
    from houv_tpu_torch.train.config import load_config
    from houv_tpu_torch.train.harness import CompletionTrainer

    with tempfile.TemporaryDirectory() as tmp:
        cfg = load_config(_full_train_cfg(tmp, model, **extra))
        trainer = CompletionTrainer(cfg)
        trainer.init_state()
        bs = cfg.batch_size
        batch = build_dataset(cfg, "train").get_batch(
            np.arange(bs), rng=np.random.default_rng(0))
        trainer.train_step(batch, 0, 0)
        with _Census(furthest_point_sample) as census:
            trainer.train_step(batch, 0, 1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer.train_step(batch, 0, 2)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    rec = {"phase": "profile", "config": f"cfgs/{model}.yaml", "clouds": bs,
           "run": "train_step", **extra, **_profile_top(prof, wall_ms),
           "fps_census": census.kept}
    emit(rec)
    del trainer
    torch.cuda.empty_cache()
    return rec


# the port's own kernels, by their __global__ names in csrc/*.cu
PORT_KERNELS = ("nn_both_kernel", "nn_both_unpack_kernel", "nn_select_kernel",
                "nn_select_unpack_kernel", "fps_kernel", "knn_kernel",
                "knn_packed_kernel", "knn_merge_kernel", "knn_wide_kernel", "knn_wide_chunk_kernel",
                "knn_wide_merge_kernel", "emd_kernel", "scatter_kernel",
                "gather_rows_kernel")


# the prefix of the profiler ranges ``_wrap_ranges`` opens: their spans on
# the device are not kernels, and the device's sums leave them out
RANGE_PREFIX = "learned::"


def _profile_top(prof, wall_ms):
    """Device time by kernel: the ten largest, and every one of the port's
    own kernels (its instantiations summed), wherever it ranks."""
    kernels = []
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0))
        if str(getattr(ev, "device_type", "")).endswith("CUDA") and t > 0 \
                and not ev.key.startswith(RANGE_PREFIX):
            kernels.append((t / 1e3, ev.count, ev.key))
    kernels.sort(reverse=True)
    device_ms = sum(k[0] for k in kernels)
    port = {}
    for ms, count, key in kernels:
        for name in PORT_KERNELS:
            if f"::{name}<" in key or f"::{name}(" in key:
                ms0, count0 = port.get(name, (0.0, 0))
                port[name] = (ms0 + ms, count0 + count)
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms,
            "device_ops": sum(k[1] for k in kernels),
            "top": [{"name": k[2][:60], "ms": k[0], "count": k[1],
                     "share_of_device": k[0] / max(device_ms, 1e-9)}
                    for k in kernels[:10]],
            "port_kernels": {name: {"ms": ms, "count": count}
                             for name, (ms, count) in port.items()}}


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


# The solver windows' profiles record the device's activity only: a window
# launches ≈250,000 kernels, and parsing the host's operators beside them
# took minutes a window (PERF.md §6), more than the script's time limit
# holds. Their wall time is then the window's without the host-side
# profiler's overhead.
# the profiled registration windows, cut in depth to a quarter of the
# yamls' cadence "300:5:4,150:5:2,50:2" (each phase's refresh and
# subsample kept): parsing the device's activity is the phases' time, about
# 254,000 kernels a full window
PROFILE_WINDOW = dict(steps=125,
                      nn_refresh_schedule=((75, 5, 4), (40, 5, 2), (10, 2, 1)))


def phase_profile():
    """Where one houv_fast window's time goes: torch.profiler (the device's
    activity only) over one angle pass of the 16-pair split, its depth cut
    to ``PROFILE_WINDOW``, device time by kernel name, and K2's census in
    that window (``fps_census``: (B, N, K) of each launch)."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from houv_tpu_torch.ops.sampling import furthest_point_sample
    from houv_tpu_torch.data import synthesize_registration_pairs
    from houv_tpu_torch.solvers.houv import houv_solve, init_params
    from houv_tpu_torch.train.cli import solver_config
    from houv_tpu_torch.train.config import load_config

    cfg = load_config(str(REPO / "cfgs" / "houv_fast.yaml"))
    scfg = dataclasses.replace(solver_config(cfg), angle_passes=1,
                               **PROFILE_WINDOW)
    d = synthesize_registration_pairs(
        16, n_points=cfg.num_points, max_angle_deg=cfg.max_angle,
        max_trans=cfg.max_trans, seed=7, shape_mode="structured",
        rot_mix=True)
    src = torch.as_tensor(d["rotated_src"], device="cuda")
    tgt = torch.as_tensor(d["rotated_tgt"], device="cuda")
    params0 = init_params(torch.Generator().manual_seed(0), 16, scfg.kernel,
                          device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof, \
            _Census(furthest_point_sample) as census:
        t0 = time.perf_counter()
        houv_solve(src, tgt, scfg, params0=params0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rec = {"phase": "profile", "config": "cfgs/houv_fast.yaml", "pairs": 16,
           "angle_passes": 1, "window_cut_to": PROFILE_WINDOW,
           **_profile_top(prof, wall_ms),
           "fps_census": census.kept}
    emit(rec)
    return rec


def phase_profile_rescore():
    """Where one rescored window's time goes (cfgs/houv_rescore.yaml, 8
    pairs, one angle window cut to ``PROFILE_WINDOW``): torch.profiler (the device's activity only)
    over the pool solve, then over the candidates' scoring by the trained
    classifier, each with its wall time and device time by kernel."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from houv_tpu_torch.data import synthesize_registration_pairs
    from houv_tpu_torch.solvers.houv import init_params
    from houv_tpu_torch.solvers.rescore import (houv_candidate_pools,
                                                houv_solve_rescored,
                                                make_classifier_scorer)
    from houv_tpu_torch.train.cli import solver_config
    from houv_tpu_torch.train.config import load_config

    cfg = load_config(str(REPO / "cfgs" / "houv_rescore.yaml"))
    scfg = dataclasses.replace(solver_config(cfg), angle_passes=1,
                               **PROFILE_WINDOW)
    n = QUALITY_PAIRS
    d = synthesize_registration_pairs(
        n, n_points=cfg.num_points, max_angle_deg=cfg.max_angle,
        max_trans=cfg.max_trans, seed=7, shape_mode="structured",
        rot_mix=True)
    src = torch.as_tensor(d["rotated_src"], device="cuda")
    tgt = torch.as_tensor(d["rotated_tgt"], device="cuda")
    params0 = init_params(torch.Generator().manual_seed(0), n, scfg.kernel,
                          device="cuda")
    scorer = make_classifier_scorer(_rescorer_model("cuda"), micro_batch=16)
    rec = {"phase": "profile_rescore", "config": "cfgs/houv_rescore.yaml",
           "pairs": n, "angle_passes": 1, "window_cut_to": PROFILE_WINDOW,
           "rescore_cands": cfg.rescore_cands}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pools = houv_candidate_pools(src, tgt, scfg, params0=params0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rec["pool"] = _profile_top(prof, wall_ms)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = houv_solve_rescored(src, tgt, scfg, scorer,
                                  n_cand=cfg.rescore_cands,
                                  angle_deg=cfg.rescore_angle,
                                  margin=cfg.rescore_margin, pools=pools)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rec["scoring"] = _profile_top(prof, wall_ms)
    rec.update(classifier_calls=scorer.calls, n_override=out["n_override"],
               sites_dropped=scorer.sites_dropped)
    emit(rec)
    return rec


def phase_fps_census(profiles):
    """K2's (B, N, K) at every launch in one houv_fast window and one
    VRCNet and one ECG train step (from their profile phases), each held
    against ``FPS_SHAPES``, where K2 is checked and timed."""
    census = {name: rec["fps_census"] for name, rec in profiles.items()}
    emit({"phase": "fps_census", "launches": census})
    known = {(b, n, k) for b, n, k, _ in FPS_SHAPES}
    missing = {tuple(shape) for shapes in census.values()
               for shape in shapes} - known
    if missing:
        fail(f"K2 ran at {sorted(missing)}, not in FPS_SHAPES")


def _time_fps(b, n, k, path, gen, plain=False):
    """K2 on b clouds of n normal points, k picks (``FPS_SHAPES``): kernel
    milliseconds, the bound (the points read and the indices written once;
    per step and point 3 sub, 3 mul, 2 add, a min and a compare at the f32
    rate: a chain of K - 1 argmaxes, so the latency floor of
    ``scripts/time_fps_variants.py`` says more) and with ``plain`` the
    plain version's."""
    from houv_tpu_torch.kernels import load
    from houv_tpu_torch.ops import sampling

    pts = torch.randn((b, n, 3), generator=gen).cuda()
    fps = sampling.furthest_point_sample
    saved = (fps.launches, fps.large_launches, fps.global_launches)
    ms = cuda_ms(lambda: fps(pts, k), reps=10)
    fps.launches, fps.large_launches, fps.global_launches = saved
    lib = load()
    row = {"shape": {"points": [b, n, 3], "k": k}, "path": path,
           "variant": sampling._fps_route(n, lib.houv_fps_max_points(),
                                          lib.houv_fps_large_max_points()),
           "ms": ms}
    row["bound_ms"], row["bound_by"] = bound(12 * b * n + 8 * b * k,
                                             10.0 * b * n * (k - 1))
    if plain:
        row["plain_ms"] = cuda_ms(lambda: sampling._fps_plain(pts, k),
                                  reps=1)
    return row


def _time_scatter(b, n, m, gen, c=3, inputs=None):
    """scatter_add at idx (b, n) -> m rows of c channels (uniform indices,
    or ``inputs``' (idx, vals)): kernel, plain and ``Tensor.scatter_add_``
    milliseconds, and the function's bound: idx, vals and out moved once,
    and b*n*c additions, whichever takes longer."""
    from houv_tpu_torch.ops import scatter

    if inputs is None:
        idx = torch.randint(0, m, (b, n), generator=gen).cuda()
        vals = torch.randn((b, n, c), generator=gen).cuda()
    else:
        idx, vals = inputs
    saved = scatter.scatter_add.launches
    ms = cuda_ms(lambda: scatter.scatter_add(idx, vals, m), reps=20)
    scatter.scatter_add.launches = saved
    plain_ms = cuda_ms(lambda: scatter._scatter_add_plain(idx, vals, m),
                       reps=10, warmup=2)
    wide = idx[..., None].expand(-1, -1, c)
    library_ms = cuda_ms(lambda: torch.zeros(
        (b, m, c), device="cuda").scatter_add_(1, wide, vals), reps=20,
        warmup=2)
    bound_ms, bound_by = bound(8 * b * n + 4 * c * b * n + 4 * c * b * m,
                               float(c * b * n))
    return {"shape": {"idx": [b, n], "vals": [b, n, c], "rows": m},
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


# knn_wide on its paths: ECG's four DenseConv levels (self-kNN after a
# ReLU, k 16), VRCNet's two EFExpansions (k 4) and FGR's mutual search in
# the 33-bin FPFH space (k 1, one cloud's features against the other's,
# at fgr.yaml's batch of 16); (B, N, C, k)
KNN_WIDE_SHAPES = ((32, 3072, 24, 16), (32, 1024, 48, 16), (32, 256, 48, 16),
                   (32, 64, 48, 16), (32, 3072, 256, 4), (32, 2048, 64, 4),
                   (16, 2048, 33, 1))


def _sm_max_clock_mhz() -> float:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    return float(smi.stdout.split()[0])


def _time_knn_wide(b, n, c, k, gen, yardsticks=True):
    """knn_wide's self-kNN on b clouds of n points with c channels (at k 1
    FGR's search between two clouds of uniform features): kernel
    milliseconds, and with ``yardsticks`` the plain version's and ``cdist``
    + ``topk``'s, the bound (clouds and indices moved once; per pair and
    channel a sub, a mul and an add, and per pair a compare, at the f32
    rate) and the floor of this contract: 3 f32 instructions per pair and
    channel (no FMA) at 132 SMs x 128 lanes a clock of the card's maximum
    SM clock."""
    from houv_tpu_torch.ops import grouping

    x = torch.randn((b, n, c), generator=gen).cuda()
    if k == 16:
        x = torch.relu(x)      # DenseConv's features; EFExpansion's are not
    r = x
    if k == 1:                 # FGR's: histograms, one cloud's to another's
        x = torch.rand((b, n, c), generator=gen).cuda()
        r = torch.rand((b, n, c), generator=gen).cuda()
    saved = grouping.knn_indices.wide_launches
    ms = cuda_ms(lambda: grouping.knn_indices(x, r, k), reps=5)
    grouping.knn_indices.wide_launches = saved
    row = {"shape": {"query": [b, n, c], "ref": [b, n, c], "k": k}, "ms": ms}
    if not yardsticks:
        return row
    row["plain_ms"] = cuda_ms(lambda: grouping._knn_plain(x, r, k), reps=1)
    row["library_ms"] = cuda_ms(
        lambda: torch.topk(torch.cdist(x, r), k, largest=False), reps=3)
    row["bound_ms"], row["bound_by"] = bound(
        4 * b * n * c * 2 + 8 * b * n * k, (3.0 * c + 1.0) * b * n * n)
    clock_mhz = _sm_max_clock_mhz()
    row["floor_ms"] = 3.0 * b * n * n * c / (132 * 128 * clock_mhz * 1e3)
    row["floor_clock_mhz"] = clock_mhz
    return row


# K6 on its paths, (B, M, N, k, path): VRCNet's 14 per forward (the
# self-kNN graphs of the pyramid 3072/1536/768/384 at k 10 and 20, the pk
# poolings at k 10, three_nn on the way up), ECG's 6 (the poolings at k 16,
# three_nn), get_uniform_loss's 10 per ECG step (FPS-seeded balls of 5%
# of the cloud, fine 2048 and coarse 1024 points, at five percentages, k 2)
# FGR's 4 a batch (the normals at k 16 and FPFH at k 17, each cloud),
# vrcnet_knn's 10 per forward at its batch of 16 (the k 16 graphs of the
# pyramid 3072/1536/768/384, the pk 10 poolings, three_nn on the way up)
# and the learned registration models' 2 a forward (one a cloud: DCP's
# graph at k 20, DeepGMR's RRI at k 21 with the point itself, IDAM's
# graph at k 12; DCP on cfgs/modelnet.yaml's 1024 points)
KNN_SHAPES = tuple(
    [(32, n, n, k, "vrcnet") for n in (3072, 1536, 768, 384)
     for k in (20, 10)]
    + [(32, n // 2, n, 10, "vrcnet") for n in (3072, 1536, 768)]
    + [(32, n, n // 2, 3, "vrcnet") for n in (3072, 1536, 768)]
    + [(32, m, n, 16, "ecg") for m, n in ((1024, 3072), (256, 1024),
                                         (64, 256))]
    + [(32, n, m, 3, "ecg") for m, n in ((1024, 3072), (256, 1024),
                                        (64, 256))]
    + [(32 * (cloud // 20), s, s, 2, "ecg_uniform")
       for cloud in (2048, 1024)
       for s in (max(int(cloud * p), 2)
                 for p in (0.004, 0.006, 0.008, 0.010, 0.012))]
    + [(16, 2048, 2048, k, "fgr") for k in (16, 17)]
    + [(16, n, n, 16, "vrcnet_knn") for n in (3072, 1536, 768, 384)]
    + [(16, n // 2, n, 10, "vrcnet_knn") for n in (3072, 1536, 768)]
    + [(16, n, n // 2, 3, "vrcnet_knn") for n in (3072, 1536, 768)]
    + [(32, 2048, 2048, k, m) for m, k in (("dcp", 20), ("deepgmr", 21),
                                           ("idam", 12))]
    + [(32, 1024, 1024, 20, "modelnet")])


def _time_knn(b, m, n, k, path, gen, yardsticks=True, plain=False):
    """knn on b clouds of m queries and n refs at k (``KNN_SHAPES``; the
    queries and refs are the first m and n of one cloud of uniform points,
    so a self-kNN is one tensor): kernel milliseconds, and with
    ``yardsticks`` ``cdist`` + ``topk``'s, the bound (clouds and indices
    moved once; 8 flops and a compare a pair at the f32 rate) and the floor
    of the contract (9 non-FMA f32 instructions a pair at 132 SMs x 128
    lanes a clock of the card's maximum SM clock), and with ``plain`` the
    plain version's."""
    from houv_tpu_torch.ops import grouping

    x = torch.rand((b, max(m, n), 3), generator=gen).cuda() - 0.5
    q, r = x[:, :m].contiguous(), x[:, :n].contiguous()
    if m == n:
        q = r
    saved = grouping.knn_indices.launches
    ms = cuda_ms(lambda: grouping.knn_indices(q, r, k), reps=20)
    grouping.knn_indices.launches = saved
    row = {"shape": {"query": [b, m, 3], "ref": [b, n, 3], "k": k},
           "path": path, "ms": ms}
    if not yardsticks:
        return row
    if plain:
        row["plain_ms"] = cuda_ms(lambda: grouping._knn_plain(q, r, k),
                                  reps=1)
    row["library_ms"] = cuda_ms(
        lambda: torch.topk(torch.cdist(q, r), k, largest=False), reps=5)
    # per pair: 3 sub, 3 mul, 2 add, 1 compare against the k-th
    row["bound_ms"], row["bound_by"] = bound(
        12 * b * m + 12 * b * n + 8 * b * m * k, 9.0 * b * m * n)
    clock_mhz = _sm_max_clock_mhz()
    row["floor_ms"] = 9.0 * b * m * n / (132 * 128 * clock_mhz * 1e3)
    row["floor_clock_mhz"] = clock_mhz
    return row


# K1's path shapes, (Bq, share, N, M): houv_fast's final phase (16 pairs x
# 64 restarts), houv.yaml's step (100 pairs x 64), the train steps' calc_cd
# (64 rows against coarse_raw, coarse_high, coarse and fine), PCN's and
# ECG's (32 rows against coarse and fine), the classical solvers': ICP
# at fgr.yaml's batch of 16 (also vrcnet_knn's native) and the grid
# Go-ICP's chunks of 5 x 16, and vrcnet_knn's: 16 rows against coarse and
# fine (fine also its val metric), and fused_cd's 48 stacked rows
NN_SHAPES = ((16, 64, 2048, 2048), (100, 64, 2048, 2048),
             (64, 1, 2048, 1024), (64, 1, 2048, 3072), (64, 1, 2048, 2048),
             (32, 1, 2048, 1024), (32, 1, 2048, 2048),
             (16, 1, 2048, 2048), (80, 1, 2048, 2048),
             (16, 1, 2048, 1024), (16, 1, 2048, 3072), (48, 1, 2048, 3072))


def _time_nn_both(bq, share, n, m, gen, yardsticks=True, plain=True):
    """nn_both on bq query clouds of n points, each serving ``share`` rows
    of m references: kernel milliseconds, and with ``yardsticks`` the bound
    (clouds read and indices written once; 8 flops a pair at the f32 rate),
    the floor of the contract (8 non-FMA f32 instructions a pair at 132 SMs
    x 128 lanes a clock of the card's maximum SM clock), ``cdist`` + 2
    ``argmin`` (one call up to 1024 rows of 2048², beyond that in chunks of
    whole pairs whose distance matrix stays within 16 GiB: the full one at
    houv.yaml's 6400 rows would be 107 GB), and with ``plain`` too the plain
    version's."""
    from houv_tpu_torch.ops import chamfer

    bk = bq * share
    a = torch.rand((bq, n, 3), generator=gen).cuda() - 0.5
    if share > 1:    # restarts of a pair: the target near each source
        b = (a.repeat_interleave(share, 0)[:, :m]
             + 0.05 * torch.randn((bk, m, 3), generator=gen).cuda())
    else:
        b = torch.rand((bk, m, 3), generator=gen).cuda() - 0.5
    saved = chamfer.chamfer_indices.launches
    ms = cuda_ms(lambda: chamfer.chamfer_indices(a, b), reps=5)
    chamfer.chamfer_indices.launches = saved
    row = {"shape": {"a": [bq, n, 3], "b": [bk, m, 3]}, "ms": ms}
    if not yardsticks:
        return row
    if plain:
        row["plain_ms"] = cuda_ms(lambda: chamfer._nn_both_plain(a, b),
                                  reps=1)
    step = max(1, (1 << 32) // (n * m * share)) * share

    def library():
        for r0 in range(0, bk, step):
            rows = b[r0:r0 + step]
            d = torch.cdist(a[r0 // share:(r0 + step) // share]
                            .repeat_interleave(share, 0), rows)
            d.argmin(-1), d.argmin(-2)

    row["library_ms"] = cuda_ms(library, reps=2)
    row["bound_ms"], row["bound_by"] = bound(
        12 * bq * n + 12 * bk * m + 8 * bk * n + 8 * bk * m,
        8.0 * bk * n * m)
    clock_mhz = _sm_max_clock_mhz()
    row["floor_ms"] = 8.0 * bk * n * m / (132 * 128 * clock_mhz * 1e3)
    row["floor_clock_mhz"] = clock_mhz
    return row


# K3's timed shapes: the query clouds of the solver's two batches (64
# restarts each, 2048 points a side)
NN_SELECT_SHAPES = (16, 100)


def _time_nn_select(bq, share, n, m, gen, yardsticks=True):
    """nn_select on bq query clouds of n points, each serving ``share``
    rows of m references (the restarts: the target near each source):
    kernel milliseconds; ``k1_gather_ms``, the solver's default branch on
    the same inputs (``chamfer_indices`` and the two ``gather_rows`` of
    ``solvers/houv.py:_pair_matches``); the bound (clouds read and both
    coordinate outputs written once; 8 flops a pair at the f32 rate) and
    the floor of the contract (K1's: 8 non-FMA f32 instructions a pair at
    132 SMs x 128 lanes a clock of the card's maximum SM clock); with
    ``yardsticks`` the plain version's and ``cdist`` + 2 ``argmin`` + 2
    ``gather``'s."""
    from houv_tpu_torch.ops import chamfer
    from houv_tpu_torch.ops.gather import gather_rows

    bk = bq * share
    a = torch.rand((bq, n, 3), generator=gen).cuda() - 0.5
    b = (a.repeat_interleave(share, 0)[:, :m]
         + 0.05 * torch.randn((bk, m, 3), generator=gen).cuda())
    saved = (chamfer.nn_select.launches, chamfer.chamfer_indices.launches)
    ms = cuda_ms(lambda: chamfer.nn_select(a, b), reps=5)

    def k1_gather():
        i1, i2 = chamfer.chamfer_indices(a, b)
        return gather_rows(b, i1), gather_rows(a, i2.reshape(bq, -1))

    k1_gather_ms = cuda_ms(k1_gather, reps=5)
    chamfer.nn_select.launches, chamfer.chamfer_indices.launches = saved
    bound_ms, bound_by = bound(12 * bq * n + 12 * bk * m + 12 * bk * n
                               + 12 * bk * m, 8.0 * bk * n * m)
    clock_mhz = _sm_max_clock_mhz()
    floor = 8.0 * bk * n * m / (132 * 128 * clock_mhz * 1e3)
    row = {"shape": {"a": [bq, n, 3], "b": [bk, m, 3]}, "ms": ms,
           "k1_gather_ms": k1_gather_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "floor_ms": floor, "x_floor": ms / floor,
           "floor_clock_mhz": clock_mhz}
    if not yardsticks:
        return row
    row["plain_ms"] = cuda_ms(lambda: chamfer._nn_select_plain(a, b), reps=1)
    a_rep = a.repeat_interleave(share, 0)

    def library():
        d = torch.cdist(a_rep, b)
        i1 = d.argmin(-1)[..., None].expand(-1, -1, 3)
        i2 = d.argmin(-2)[..., None].expand(-1, -1, 3)
        return torch.gather(b, 1, i1), torch.gather(a_rep, 1, i2)

    row["library_ms"] = cuda_ms(library, reps=2)
    return row


def emd_path_inputs(tmp):
    """K7's inputs on its paths, in the order of ``EMD_SHAPES``, from the
    seeded models at full width: validate's first batch (VRCNet's fine
    output against the gt, as in ``phase_completion``) and the auctions of
    one ``loss: emd`` train step of VRCNet and of ECG; [(x1, x2, eps,
    iters)]."""
    from houv_tpu_torch.train.cli import build_dataset
    from houv_tpu_torch.train.config import load_config
    from houv_tpu_torch.train.harness import CompletionTrainer

    cfg = load_config(_model_cfg(tmp, "vrcnet", 64, eval_emd=True))
    trainer = CompletionTrainer(cfg)
    trainer.init_state()
    batch = build_dataset(cfg, "val").get_batch(np.arange(32))
    inputs = [(trainer.predict_batch(batch, step=0),
               torch.as_tensor(batch["gt"], device="cuda"), 0.004, 3000)]
    del trainer
    for model, calls in (("vrcnet", 4), ("ecg", 2)):
        with _EmdInputs(calls) as kept:
            _repeated_batch(tmp, 1, False, model, loss="emd")
        inputs += kept.kept
    torch.cuda.empty_cache()
    return inputs


def _time_emd(x1, x2, eps, iters):
    """K7 on one batch of pairs at its plan: milliseconds, rounds and bids;
    the bound (clouds read and outputs written once; per bid and item 3
    sub, 3 mul, 2 add, the price's sub and 2 compares at the f32 rate, for
    the bids these inputs needed); and the instruction floor (11 f32
    instructions per bid and item at the plan's SMs, 128 lanes a clock at
    the card's maximum SM clock)."""
    from houv_tpu_torch.ops import emd

    b, n, _ = x1.shape
    m = x2.shape[1]
    run = emd.emd_auction_with_stats
    saved = _emd_counts()
    _, _, rounds, bids = run(x1, x2, eps, iters)
    ms = cuda_ms(lambda: run(x1, x2, eps, iters), reps=3)
    _set_emd_counts(saved)
    plan = emd_plan(b, n, m)
    n_bids, n_rounds = int(bids.sum()), int(rounds.max())
    bound_ms, bound_by = bound(12 * b * (n + m) + 12 * b * n + 16 * b,
                               11.0 * n_bids * m)
    clock_mhz = _sm_max_clock_mhz()
    sms = min(torch.cuda.get_device_properties(0).multi_processor_count,
              b * plan)
    floor = 11.0 * n_bids * m / (sms * 128 * clock_mhz * 1e3)
    return {"shape": {"x1": [b, n, 3], "x2": [b, m, 3], "eps": eps,
                      "iters": iters},
            "variant": emd_route(n, m), "plan": plan, "rounds_max": n_rounds,
            "bids": n_bids, "ms": ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "floor_ms": floor,
            "x_floor": ms / floor,
            "floor_clock_mhz": clock_mhz}


def new_kernel_rows(gen, errs, launches):
    """The ``kernels`` rows of knn_wide, nn_select and gather_rows at their
    main-path shapes. ``errs``: each one's largest error against its plain
    version; ``launches``: each one's count on its path."""
    out = []
    shapes = [_time_knn_wide(b, n, c, k, gen) for b, n, c, k in
              KNN_WIDE_SHAPES]
    out.append({"name": "knn_wide", "route": "cuda",
                "source": "houv_tpu_torch/csrc/knn_wide.cu",
                "replaces": "houv_tpu/ops/grouping.py:107",
                "launches": launches["knn_wide"],
                "max_abs_err": errs["knn_wide"], **shapes[0],
                "at_shapes": shapes})
    torch.cuda.empty_cache()

    # nn_select at the solver's two shapes, 64 restarts a pair and 2048
    # points a side, the target shared by its pair's restarts: the 16 pairs
    # of the smoke's houv_fast window and cfgs/houv.yaml's batch of 100
    # (the yaml's own); the plain version and the library call at the first
    shapes = [_time_nn_select(bq, 64, 2048, 2048, gen, yardsticks=i == 0)
              for i, bq in enumerate(NN_SELECT_SHAPES)]
    out.append({"name": "nn_select", "route": "cuda",
                "source": "houv_tpu_torch/csrc/nn_select.cu",
                "replaces": "houv_tpu/ops/chamfer.py:273",
                "launches": launches["nn_select"],
                "max_abs_err": errs["nn_select"], **shapes[0],
                "at_shapes": shapes})
    torch.cuda.empty_cache()

    out.append({"name": "gather_rows", "route": "cuda",
                "source": "houv_tpu_torch/csrc/gather_rows.cu",
                "replaces": "houv_tpu/ops/scatter.py:55",
                "launches": launches["gather_rows"],
                "max_abs_err": errs["gather_rows"], **_time_gather_rows(gen)})
    return out


def _time_gather_rows(gen):
    """gather_rows at the solver's row gather, 16 clouds of 2048 rows and
    the matches of 64 restarts x 2048 points each: kernel, plain and
    ``torch.gather`` milliseconds, and the bytes bound (src, idx and out
    moved once)."""
    from houv_tpu_torch.ops import scatter

    bsz, m, n = 16, 2048, 64 * 2048
    src = torch.randn((bsz, m, 3), generator=gen).cuda()
    idx = torch.randint(0, m, (bsz, n), generator=gen).cuda()
    saved = scatter.gather_rows_kernel.launches
    ms = cuda_ms(lambda: scatter.gather_rows_kernel(src, idx), reps=20)
    scatter.gather_rows_kernel.launches = saved
    plain_ms = cuda_ms(lambda: scatter._gather_rows_plain(src, idx), reps=10)
    wide = idx[..., None].expand(-1, -1, 3)
    library_ms = cuda_ms(lambda: torch.gather(src, 1, wide), reps=20)
    bound_ms, bound_by = bound(12 * bsz * m + 8 * bsz * n + 12 * bsz * n, 0.0)
    return {"shape": {"src": [bsz, m, 3], "idx": [bsz, n]}, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def phase_kernels(launches, errs, completion, train, solve, models,
                  models_train, select, classical, combine, vrcnet_knn,
                  learned, aux, bf16, parallel, gan, ablations, large, pre,
                  native, gen):
    """``launches``: the houv_fast counts; ``errs``: each kernel's largest
    error against its plain version; ``completion``: the VRCNet runs (their
    counts summed for knn and emd, and the first val batch's fine and gt
    clouds, on which emd is timed); ``train``: the VRCNet train_main run
    (scatter_add's count); ``solve``: the scatter-mode solve; ``models``
    and ``models_train``: the PCN and ECG runs; ``select``: the nn_select
    solve with the exported row gather; ``classical`` and ``combine``: the
    classical solvers' runs and the combine's re-solve, whose launches
    each row carries under ``classical_launches``; ``vrcnet_knn``: its
    phase, whose runs' launches each row carries under
    ``vrcnet_knn_launches``; ``learned``: the learned models' phase,
    whose runs' launches each row carries under ``learned_launches``;
    ``aux``: the aux phase, likewise under ``aux_launches``; ``bf16``:
    the bf16 phase's full-width runs, under ``bf16_launches`` (the bf16
    mode sends the kernels the same shapes as f32, in f32);
    ``parallel``: the parallel phase's runs, summed over their ranks,
    under ``parallel_launches``; ``gan``: the GAN phase's ``train_main``
    and repeated-batch runs, under ``gan_launches``; ``ablations``: the
    ablation solves, under ``ablation_launches``; ``large``: the
    large-cloud phase, whose rows of K2's and K7's designs past their
    limits join the line and whose runs' launches each row carries under
    ``large_clouds_launches``; ``pre`` and ``native``: the preprocessing
    and native-loader phases, under ``preprocess_launches`` and
    ``native_launches``."""
    nn_err, knn_err, emd_err, scatter_err = (
        errs["nn_both"], errs["knn"], errs["emd"], errs["scatter_add"])
    from houv_tpu_torch.ops import emd

    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    # nn_both at its path shapes; the plain version timed at the first two
    shapes = [_time_nn_both(*shape, gen, plain=i < 2)
              for i, shape in enumerate(NN_SHAPES)]
    out.append({"name": "nn_both", "route": "cuda",
                "source": "houv_tpu_torch/csrc/nn_both.cu",
                "replaces": "houv_tpu/ops/chamfer.py:84",
                "launches": launches["nn_both"], "max_abs_err": nn_err,
                **shapes[0], "at_shapes": shapes})
    torch.cuda.empty_cache()

    # fps at its path shapes, the first row's (houv_fast's N/2 phase, 16
    # clouds of 2048 -> 1024) with the plain version timed there
    shapes = [_time_fps(*shape, gen, plain=shape[:3] == (16, 2048, 1024))
              for shape in FPS_SHAPES]
    main_row = next(row for row in shapes if "plain_ms" in row)
    out.append({"name": "fps", "route": "cuda",
                "source": "houv_tpu_torch/csrc/fps.cu",
                "replaces": "houv_tpu/ops/sampling.py:43",
                "launches": launches["fps"], "max_abs_err": errs["fps"],
                **main_row, "library_ms": None, "at_shapes": shapes})

    vrc = {k: completion["test"]["launches"].get(k, 0)
           + completion["validate"]["launches"].get(k, 0)
           for k in ("knn", "emd")}
    # knn at its 46 path shapes, the first VRCNet's level-0 self-kNN (32
    # clouds of 3072 points, k 20), the plain version timed there
    shapes = [_time_knn(*shape, gen, plain=i == 0)
              for i, shape in enumerate(KNN_SHAPES)]
    vrc_shapes = [row for row in shapes if row["path"] == "vrcnet"]
    out.append({"name": "knn", "route": "cuda",
                "source": "houv_tpu_torch/csrc/knn.cu",
                "replaces": "houv_tpu/ops/grouping.py:90",
                "launches": vrc["knn"], "max_abs_err": knn_err,
                **shapes[0], "at_shapes": shapes,
                "vrcnet_sum_ms": sum(row["ms"] for row in vrc_shapes),
                "vrcnet_sum_floor_ms": sum(row["floor_ms"]
                                           for row in vrc_shapes)})
    torch.cuda.empty_cache()

    # emd on its paths' own clouds: validate's first batch (32 fine clouds
    # against their gt, 2048 points, eps 0.004, 3000 rounds at most), the
    # main row, with the plain version timed there; and the first loss: emd
    # step's auctions of VRCNet and ECG, each checked first
    inputs = [(*completion["emd_inputs"], 0.004, 3000)]
    inputs += train["emd_inputs"] + models_train["ecg"]["emd_inputs"]
    shapes = []
    for (x1, x2, eps, iters), shape in zip(inputs, EMD_SHAPES):
        if (*x1.shape[:2], x2.shape[1], eps, iters) != shape[:5]:
            fail(f"emd ran at {[*x1.shape[:2], x2.shape[1], eps, iters]} "
                 f"where EMD_SHAPES has {shape}")
        emd_err = max(emd_err, check_emd(x1, x2, eps, iters,
                                         f"path {shape[5]}"))
        shapes.append({"path": shape[5],
                       **_time_emd(x1, x2, eps, iters)})
    fine, gt = completion["emd_inputs"]
    plain_ms = cuda_ms(lambda: emd._auction_plain(fine, gt, 0.004, 3000),
                       reps=1, warmup=0)
    out.append({"name": "emd", "route": "cuda",
                "source": "houv_tpu_torch/csrc/emd.cu",
                "replaces": "houv_tpu/ops/emd_kernel.py:48",
                "launches": vrc["emd"], "max_abs_err": emd_err,
                **shapes[0], "plain_ms": plain_ms, "library_ms": None,
                "at_shapes": shapes})
    del fine, gt, inputs
    torch.cuda.empty_cache()

    # scatter_add at the train step's largest backward, coarse_high: 64 rows
    # of 2048 gt matches onto 3072 points; and at the solver's scatter mode
    at_train = _time_scatter(64, 2048, 3072, gen)
    at_solver = _time_scatter(1024, 2048, 2048, gen)
    # and at spconv.yaml's voxel targets: (8, 2048) rows of [1, x, y, z]
    # onto the 125,000 voxels of the 50³ grid
    at_voxels = _time_scatter(8, 2048, 125000, gen, c=4,
                              inputs=voxel_target_inputs(gen))
    out.append({"name": "scatter_add", "route": "cuda",
                "source": "houv_tpu_torch/csrc/scatter.cu",
                "replaces": "houv_tpu/ops/scatter.py:35",
                "launches": train["train"]["launches"]["scatter_add"],
                "launches_scatter_solve":
                    solve["scatter"]["scatter_launches"],
                "max_abs_err": scatter_err, **at_train,
                "at_solver_shape": at_solver,
                "at_voxel_targets": at_voxels})
    ecg = models["ecg"]
    out += new_kernel_rows(gen, errs, {
        "knn_wide": ecg["test"]["launches"]["knn_wide"]
        + ecg["validate"]["launches"]["knn_wide"]
        + models["vrcnet_efexpansion"]["knn_wide"],
        "nn_select": select["nn_select"]["nn_select_launches"],
        "gather_rows": select["gather_rows"]["launches"]})
    out += large["rows"]
    paths = {m: rec["launches"] for m, rec in classical.items()
             if "launches" in rec}
    paths["combine"] = combine["launches"]
    for row in out:
        row["classical_launches"] = {
            m: n[row["name"]] for m, n in paths.items() if row["name"] in n}
        row["train_main_launches"] = {
            "vrcnet": train["train"]["launches"].get(row["name"], 0),
            **{m: models_train[m]["train"]["launches"].get(row["name"], 0)
               for m in ("pcn", "ecg")},
            "vrcnet_knn": vrcnet_knn["train"]["launches"].get(row["name"],
                                                              0)}
        row["vrcnet_knn_launches"] = {
            run: vrcnet_knn[run]["launches"].get(row["name"], 0)
            for run in ("train", "repeated", "sweep")}
        row["learned_launches"] = {
            m: {run: rec[key].get(row["name"], 0)
                for run, rec, key in _learned_runs(learned, m)}
            for m in LEARNED + ("transformer",)}
        row["aux_launches"] = {
            f"{name}:{run}": rec["launches"].get(row["name"], 0)
            for name, runs in aux.items() for run, rec in runs.items()
            if "launches" in rec}
        row["parallel_launches"] = {
            run: counts.get(row["name"], 0)
            for run, counts in parallel.items()}
        row["bf16_launches"] = {
            model: {run: rec["full"][key]["launches"].get(row["name"], 0)
                    for run, key in (("train_main", "train_main"),
                                     ("test_main", "test_main"),
                                     ("repeated", "repeated_bf16"))}
            for model, rec in bf16.items()}
        row["gan_launches"] = {
            run: gan[run]["launches"].get(row["name"], 0)
            for run in ("train", "repeated")}
        row["ablation_launches"] = {
            name: ablations[name]["launches"].get(row["name"], 0)
            for name in ABLATIONS}
        row["large_clouds_launches"] = {
            run: counts.get(row["name"], 0)
            for run, counts in large["launches"].items()}
        row["preprocess_launches"] = {
            run: pre[run]["launches"].get(row["name"], 0)
            for run in ("f1_sweep", "f1", "embedding")}
        row["native_launches"] = {
            "train_main": native["train_main"]["launches"].get(row["name"],
                                                               0)}
    return out


def _learned_runs(learned, model):
    """(run, record, launches key) of each run of ``model`` in the learned
    phase."""
    rec = learned[model]
    if model == "transformer":
        return [(run, rec[run], "launches")
                for run in ("sweep", "validate", "train", "repeated")]
    return [("train_main", rec["train"], "launches"),
            ("test_main", rec["train"], "test_main_launches"),
            ("repeated", rec["repeated"], "launches")]


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="chip_smoke.py")
    p.add_argument("--quality-pairs", type=int, default=None,
                   help="run the build and the quality modes alone, over "
                        "this many pairs a sweep")
    args = p.parse_args(argv)
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
    # every phase but ``parallel`` runs in this one process: as torchrun
    # declares a one-process job, so that the CLI does not start a rank a
    # card on a machine with several
    os.environ["WORLD_SIZE"] = "1"

    t0 = time.perf_counter()

    def timed(phase, *args):
        t = time.perf_counter()
        out = phase(*args)
        emit({"phase_done": phase.__name__,
              "seconds": round(time.perf_counter() - t, 1),
              "total_seconds": round(time.perf_counter() - t0, 1)})
        return out

    timed(phase_build)
    if args.quality_pairs:
        timed(phase_quality, args.quality_pairs, None)
        return 0
    errs = {"nn_both": timed(phase_nn, gen)}
    errs["fps"] = timed(phase_fps, gen)
    errs["knn"] = timed(phase_knn, gen)
    errs["knn_wide"] = timed(phase_knn_wide, gen)
    errs["emd"] = timed(phase_emd, gen)
    errs["scatter_add"] = timed(phase_scatter, gen)
    errs["nn_select"] = timed(phase_nn_select, gen)
    errs["gather_rows"] = timed(phase_gather_rows, gen)
    timed(phase_chamfer_grad, gen)
    fast = timed(phase_main)
    quality = timed(phase_quality)
    classical = timed(phase_classical)
    combine = timed(phase_combine)
    timed(phase_completion_reference)
    completion = timed(phase_completion)
    models = timed(phase_completion_models)
    timed(phase_train_reference)
    timed(phase_train_reference_ecg)
    train = timed(phase_train)
    models_train = timed(phase_train_models)
    vrcnet_knn = timed(phase_vrcnet_knn)
    learned = timed(phase_learned)
    aux = timed(phase_aux)
    bf16 = timed(phase_bf16)
    gan = timed(phase_gan)
    parallel = timed(phase_parallel, fast["refs"], quality["rescore_ref"])
    solve = timed(phase_scatter_solve)
    select = timed(phase_select_solve)
    ablations = timed(phase_ablations)
    large = timed(phase_large_clouds, gen)
    pre = timed(phase_preprocess)
    native = timed(phase_native)
    profiles = {"houv_fast": timed(phase_profile)}
    timed(phase_profile_rescore)
    timed(phase_profile_vrcnet)
    profiles["vrcnet"] = timed(phase_profile_train)
    profiles["ecg"] = timed(phase_profile_train, "ecg")
    profiles["vrcnet_knn"] = vrcnet_knn["profile"]
    timed(phase_fps_census, profiles)
    emit({"kernels": timed(phase_kernels, fast["launches"], errs, completion,
                           train, solve, models, models_train, select,
                           classical, combine, vrcnet_knn, learned, aux,
                           bf16, parallel, gan, ablations, large, pre,
                           native, gen)})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
