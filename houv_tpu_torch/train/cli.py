"""Command-line entries (counterpart of ``houv_tpu/train/cli.py``): the
test sweep (HOUV or learned registration; PCN, ECG, VRCNet,
vrcnet_knn or transformer completion), the merge of a sharded sweep, the
training of a completion, learned registration or aux model, the aux
models' evaluation and the evaluation of the registration solvers.

    python -m houv_tpu_torch.train.cli -c cfgs/houv_fast.yaml [-l L -r R]
        [--data-path FILE] [--device cuda|cpu]
    (likewise houv.yaml, houv_quality.yaml, houv_rescore.yaml, ...)
    python -m houv_tpu_torch.train.cli -c cfgs/houv_fast.yaml --combine
    python -m houv_tpu_torch.train.cli -c cfgs/vrcnet.yaml [--device cpu]
    python -m houv_tpu_torch.train.cli train -c cfgs/vrcnet.yaml
        [--data-path FILE] [--device cuda|cpu]
    (likewise cfgs/pcn.yaml, cfgs/ecg.yaml, cfgs/vrcnet_knn.yaml,
    cfgs/transformer.yaml, cfgs/dcp.yaml, cfgs/deepgmr.yaml, cfgs/idam.yaml,
    cfgs/modelnet.yaml, the aux models' cfgs/embedding.yaml,
    cfgs/alignment.yaml, cfgs/rescore_alignment.yaml and cfgs/spconv.yaml
    and, for the sweep, cfgs/vrcnet_knn_extratest.yaml)
    python -m houv_tpu_torch.train.cli train -c cfgs/houv_rescore.yaml
    python -m houv_tpu_torch.train.cli train -c cfgs/fgr.yaml
    (likewise cfgs/goicp_bnb.yaml, and model_name icp or goicp)

The sweep runs the test split batch by batch and writes ``results.h5`` (the
(N, 4, 4) transforms, or the (N, num_points, 3) completions) and
``submission.zip`` under ``<work_dir>/<model_name>/``; with ``-l L -r R``
it solves pairs [L, R) into ``results_L_R.h5``, and ``--combine`` merges
those shards, solves the ranges none covers and writes ``results.h5``,
``submission.zip`` and ``manifest.json``. With ``load_model`` set (a
checkpoint of the port or of the JAX package), the completion and learned
registration sweeps run that checkpoint's weights; with ``rescore_ckpt`` set,
the HOUV sweep picks each pair's transform among rotation-diverse
candidates with that trained classifier (``solvers/rescore.py``).
``train`` fits the config's completion, learned registration or aux model
and writes ``network.ckpt`` and ``best_<metric>_network.ckpt`` under
``<work_dir>/<model>_<loss>_<flag>/``; for ``model_name: houv`` it runs
``houv_eval_main`` on the labelled val split instead, and for the
classical solvers (``icp``, ``goicp``, ``goicp_bnb``, ``fgr``)
``icp_eval_main``. The aux models (``model_embedding``,
``alignment_spconv``, ``voxel_asym``) write no submission: their "test" is
their validation meters on the val split. When the MVP or ModelNet .h5
file is absent, a synthetic split stands in.

Several ranks: ``n_devices`` in the yaml (every visible card when unset;
one process on the CPU) starts that many ranks (``parallel.distributed.
launch``: NCCL on CUDA, gloo with ``--device cpu``), or ``torchrun
--nproc_per_node N -m houv_tpu_torch.train.cli ...`` starts them. The HOUV
sweep, ``houv_eval_main`` and the rescored solve then split each batch's
pairs over the ranks (``parallel/mesh.py``), the model sweeps and the
aux models' meters each batch's rows, and training is data-parallel
(``train/harness.py``); rank 0 writes results.h5, the zip and the
checkpoints. As in the JAX CLI, ``n_devices`` above the visible cards
takes the cards there are; the HOUV sweeps round their batch down to a
multiple of the ranks (at least one pair a rank), and training, the model
sweeps and the aux meters run in one process where the ranks do not divide
``batch_size`` (``job_mesh``). The classical solvers' evaluation runs in
one process, as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from houv_tpu_torch._device import resolve_device
from houv_tpu_torch.data.mvp import (
    ModelNetDataset,
    MVPCompletionDataset,
    MVPRegistrationDataset,
    synthesize_completion_set,
    synthesize_modelnet_set,
    synthesize_registration_pairs,
)
from houv_tpu_torch.data.pipeline import batch_iterator
from houv_tpu_torch.geometry.rotations import (
    rmse_loss,
    rotation_geodesic_error,
    translation_error,
)
from houv_tpu_torch.models import get_model
from houv_tpu_torch.ops.chamfer import chamfer_indices
from houv_tpu_torch.ops.grouping import knn_indices
from houv_tpu_torch.ops.sampling import furthest_point_sample
from houv_tpu_torch.parallel.distributed import init_distributed, launch
from houv_tpu_torch.parallel.mesh import (all_reduce, barrier, local_mesh,
                                          make_mesh, sharded_houv_pools,
                                          sharded_houv_solve, sum_int)
from houv_tpu_torch.solvers.fgr import fgr_solve
from houv_tpu_torch.solvers.goicp_bnb import goicp_bnb_solve
from houv_tpu_torch.solvers.houv import (
    HOUVConfig,
    evaluate_solution,
    init_params,
)
from houv_tpu_torch.solvers.icp import goicp_solve, icp_solve
from houv_tpu_torch.solvers.rescore import (
    make_sharded_classifier_scorer,
    sharded_houv_solve_rescored,
)
from houv_tpu_torch.state import state_from_flax
from houv_tpu_torch.train.aux import AUX_TRAINERS
from houv_tpu_torch.train.checkpoint import read_flax_msgpack
from houv_tpu_torch.train.config import (Config, load_config,
                                         parse_refresh_schedule)
from houv_tpu_torch.train.harness import (AUX_MODELS, LEARNED_REGISTRATION,
                                          CompletionTrainer,
                                          RegistrationTrainer)
from houv_tpu_torch.train.submission import (read_results_h5,
                                             write_results_h5,
                                             write_submission)
from houv_tpu_torch.utils.logging_utils import setup_logging
from houv_tpu_torch.utils.meters import AverageValueMeter, SplitMeterGrid

REGISTRATION_MODELS = {"dcp", "deepgmr", "idam", "houv", "icp", "goicp",
                       "goicp_bnb", "fgr"}
# the registration baselines without learned weights (icp_eval_main)
CLASSICAL_MODELS = ("icp", "goicp", "goicp_bnb", "fgr")


def is_registration(cfg: Config) -> bool:
    return cfg.model_name in REGISTRATION_MODELS or cfg.dataset.endswith("rg")


def make_trainer(cfg: Config, device, mesh=None):
    """The trainer of the config's model: an aux model's of
    ``train/aux.py``, ``RegistrationTrainer`` for a learned registration
    model, else ``CompletionTrainer``; over ``mesh`` (the job's, from
    ``job_mesh``; ``local_mesh`` when None), data-parallel where it has
    several ranks."""
    if cfg.model_name in AUX_TRAINERS:
        return AUX_TRAINERS[cfg.model_name](cfg, device, mesh)
    if cfg.model_name in LEARNED_REGISTRATION:
        return RegistrationTrainer(cfg, device, mesh)
    return CompletionTrainer(cfg, device, mesh)


def job_mesh(cfg: Config, device):
    """How an entry runs: ``(mesh, 0)`` to run here, on the job's mesh (a
    process group set up, as ``launch`` does, or torchrun's ``WORLD_SIZE``
    in the environment) or on ``local_mesh`` for one process; ``(None, n)``
    where ``n`` > 1 ranks are still to start: ``n_devices``, or every
    visible card when unset (one process on the CPU), at most the visible
    cards (as the JAX package's ``make_mesh`` takes the first n devices).
    Training, the model sweeps and the aux meters split each batch's rows
    over the ranks, so a ``batch_size`` the ranks do not divide runs in one
    process, as the JAX CLI's ``make_trainer`` trains on one device; the
    HOUV sweeps (``model_name: houv``) round their batch to a multiple of
    the ranks instead. ValueError inside a job whose size differs from
    ``n_devices`` (capped at the cards), or whose ranks do not divide a
    trainer's batch."""
    rows = cfg.model_name != "houv"
    cards = torch.cuda.device_count() if device.type == "cuda" else None
    want = cfg.n_devices
    if want and cards is not None:
        want = min(want, cards)
    if dist.is_initialized() or "WORLD_SIZE" in os.environ:
        mesh = make_mesh(device=init_distributed(device=device))
        n = mesh.size
        if want and want != n:
            raise ValueError(f"n_devices {cfg.n_devices} in a job of {n} "
                             "ranks")
        if rows and cfg.batch_size % n:
            raise ValueError(
                f"batch_size {cfg.batch_size} is not divisible by the job's "
                f"{n} ranks: training and the model sweeps split a batch "
                "into equal rows a rank (started by the CLI, such a batch "
                "runs in one process, as the JAX CLI runs it on one device)")
        return mesh, 0
    n = want or cards or 1
    if rows and cfg.batch_size % n:
        n = 1
    return (local_mesh(device), 0) if n == 1 else (None, n)


def _rank_entry(entry, argv: list):
    """A launched rank's run of ``test_main`` or ``train_main``: its result
    without the trainer (rank 0's goes back to the launching process)."""
    return {k: v for k, v in entry(argv).items() if k != "trainer"}


def _rank_logging(log_dir, mesh):
    """``setup_logging``: rank 0 logs (to ``log_dir`` too), the other ranks
    their warnings only."""
    if mesh.rank == 0:
        return setup_logging(log_dir)
    log = setup_logging(None)
    log.setLevel(logging.WARNING)
    return log


def build_dataset(cfg: Config, split: str, index_range=None):
    """The split of the config's task: the MVP or ModelNet .h5 file when
    present, else a synthetic split (seed 2021 for train, 7 otherwise; of
    ``synthetic_size`` items, by default 128 train and 64 other; ModelNet's
    always 128 and 64, as in the JAX CLI)."""
    have_file = cfg.data_path and os.path.exists(cfg.data_path)
    n = cfg.synthetic_size or (64 if split != "train" else 128)
    seed = 2021 if split == "train" else 7
    if cfg.dataset == "modelnet":
        # reference registration/dataset.py:154-187's variants
        kw = dict(variant=cfg.variant, max_angle_deg=cfg.max_angle,
                  max_trans=cfg.max_trans, index_range=index_range)
        if have_file:
            return ModelNetDataset(split, path=cfg.data_path, **kw)
        return ModelNetDataset(split, data=synthesize_modelnet_set(
            64 if split != "train" else 128, n_points=cfg.num_points,
            seed=seed), **kw)
    if not is_registration(cfg):
        with_voxels = cfg.model_name == "vrcnet_knn"
        if have_file:
            return MVPCompletionDataset(
                split, path=cfg.data_path, scale_aug=cfg.scale_aug,
                index_range=index_range, category=cfg.category,
                with_voxels=with_voxels, grid_size=cfg.grid_size)
        data = synthesize_completion_set(
            max(n // 8, 2), views_per_model=8,
            n_partial=cfg.num_input or cfg.num_points,
            n_complete=cfg.num_points, seed=seed)
        return MVPCompletionDataset(
            split, data=data, views_per_model=8, scale_aug=cfg.scale_aug,
            index_range=index_range, with_voxels=with_voxels,
            grid_size=cfg.grid_size)
    if have_file:
        return MVPRegistrationDataset(
            split, path=cfg.data_path, max_angle_deg=cfg.max_angle,
            max_trans=cfg.max_trans, index_range=index_range,
            category=cfg.category,
        )
    data = synthesize_registration_pairs(
        n, n_points=cfg.num_points, max_angle_deg=cfg.max_angle,
        max_trans=cfg.max_trans, seed=seed,
        shape_mode=cfg.synthetic_shape,
        rot_mix=(cfg.synthetic_shape == "structured"),
    )
    return MVPRegistrationDataset(
        split, data=data, max_angle_deg=cfg.max_angle,
        max_trans=cfg.max_trans, index_range=index_range,
    )


def solver_config(cfg: Config) -> HOUVConfig:
    return HOUVConfig(
        kernel=cfg.kernel, steps=cfg.num_epochs, lr=cfg.houv_lr,
        retry_threshold=cfg.retry_threshold, angle_passes=cfg.angle_passes,
        retry_mode=cfg.retry_mode, use_view_loss=cfg.use_view_loss,
        reparam=cfg.houv_reparam, objective=cfg.houv_objective,
        two_bracket=cfg.two_bracket, nn_refresh=cfg.nn_refresh,
        nn_refresh_schedule=parse_refresh_schedule(cfg.nn_refresh_schedule),
        window_select=cfg.window_select,
    )


def make_rescorer(cfg: Config, log, device, mesh=None):
    """The classifier scorer of ``cfg.rescore_ckpt``, or None. A missing
    file logs a warning and the solve goes without rescoring, as in the JAX
    CLI; a file that is there but does not load raises. The classifier is
    built in bf16 mode, as the JAX CLI builds it; a checkpoint holding a
    third ``Dense`` has the loss-gap head, which is then fed. The scorer
    is the sharded one over ``mesh`` (``local_mesh`` when None)."""
    if not cfg.rescore_ckpt:
        return None
    if not os.path.exists(cfg.rescore_ckpt):
        log.warning("rescore_ckpt %s not found: solving WITHOUT rescoring",
                    cfg.rescore_ckpt)
        return None
    state = read_flax_msgpack(cfg.rescore_ckpt)
    has_gap = "Dense_2" in state["params"]
    model = get_model("alignment_spconv", grid_size=cfg.grid_size,
                      compute_dtype="bfloat16", n_extra=1 if has_gap else 0)
    model.load_state_dict(state_from_flax(state, model), strict=True)
    model.to(device).eval()
    log.info("rescoring: ckpt=%s n_cand=%d angle=%.1f margin=%.2f "
             "gap_head=%s tta=%d", cfg.rescore_ckpt, cfg.rescore_cands,
             cfg.rescore_angle, cfg.rescore_margin, has_gap, cfg.rescore_tta)
    return make_sharded_classifier_scorer(
        model, mesh or local_mesh(device), micro_batch=16,
        n_aug=cfg.rescore_tta, use_gap=has_gap)


def _pair_generator(cfg: Config, start: int) -> torch.Generator:
    """The restarts' generator of the batch starting at pair ``start`` of
    the whole split (not of a shard): a sharded sweep whose shards start on
    multiples of the batch size solves each pair as the unsharded one
    does."""
    seed = cfg.manual_seed or 2021
    return torch.Generator().manual_seed(
        int(np.random.SeedSequence([seed, start]).generate_state(1)[0]))


def _solve_batch(cfg: Config, scfg: HOUVConfig, src, tgt, start, scorer,
                 mesh, timing: dict) -> dict:
    """One batch of pairs, split over ``mesh``'s ranks, through
    ``sharded_houv_solve``, or with a scorer through the candidate pools
    and ``sharded_houv_solve_rescored`` (their seconds added to
    ``timing``, each ending in a device sync): each pair solved as
    ``houv_solve`` or ``houv_solve_rescored`` solves it in one process."""
    params0 = init_params(_pair_generator(cfg, start), src.shape[0],
                          scfg.kernel, scfg.lattice_init, scfg.two_bracket,
                          device="cpu")
    if scorer is None:
        return sharded_houv_solve(src, tgt, mesh, scfg, params0=params0)
    t0 = time.perf_counter()
    pools = sharded_houv_pools(src, tgt, mesh, scfg, params0)[1]
    pools[0].cpu()
    t1 = time.perf_counter()
    out = sharded_houv_solve_rescored(
        src, tgt, mesh, scfg, scorer, n_cand=cfg.rescore_cands,
        angle_deg=cfg.rescore_angle, margin=cfg.rescore_margin, pools=pools)
    out["pick"].cpu()
    timing["pool_seconds"] = timing.get("pool_seconds", 0.0) + t1 - t0
    timing["score_seconds"] = (timing.get("score_seconds", 0.0)
                               + time.perf_counter() - t1)
    return out


_DIAGNOSTICS = ("cand_loss", "cand_logits", "cand_r", "cand_t", "pick")


def _houv_sweep(cfg: Config, ds, log, mesh, offset: int = 0):
    """Solve the registration split batch by batch: (N, 4, 4) transforms
    and, for the log, the pairs that entered the retry passes; rescored,
    also the pairs whose pick the classifier overrode, the seconds of the
    pools and of the scoring, and the rescoring's per-pair diagnostics
    (``rescore``: candidates, their losses and logits, the picks).
    ``offset``: the index of ``ds``'s first pair in the whole split. Each
    batch's pairs split over ``mesh``'s ranks, and every rank gets the
    whole batch's results."""
    if cfg.model_name in CLASSICAL_MODELS:
        raise NotImplementedError(
            f"{cfg.model_name!r} has no test sweep, as in the JAX package: "
            "evaluate it with `train -c`")
    if cfg.model_name != "houv":
        raise ValueError(
            f"the registration sweep runs houv, dcp, deepgmr and idam, got "
            f"{cfg.model_name!r}")
    scfg = solver_config(cfg)
    device = mesh.device
    scorer = make_rescorer(cfg, log, device, mesh)
    # Pairs go in batches of batch_size (the restart expansion makes a
    # pair kernel·N points), rounded down to a multiple of the ranks (at
    # least one pair a rank); the tail batch is padded by repetition so
    # every batch shares one Adam scale, as in the JAX CLI.
    bs = max(cfg.batch_size // mesh.size * mesh.size, mesh.size)
    n = len(ds)
    chunks = []
    diagnostics = {k: [] for k in _DIAGNOSTICS}
    n_retry = n_override = 0
    timing: dict = {}
    t0 = time.perf_counter()
    for start in range(0, n, bs):
        idx = np.arange(start, min(start + bs, n))
        batch = ds.get_batch(np.resize(idx, bs))
        src = torch.as_tensor(batch["src"], device=device)
        tgt = torch.as_tensor(batch["tgt"], device=device)
        out = _solve_batch(cfg, scfg, src, tgt, offset + start, scorer,
                           mesh, timing)
        chunks.append(out["transform"][: len(idx)].cpu().numpy())
        n_retry += out["n_retry"]
        if scorer is not None:
            for k in _DIAGNOSTICS:
                diagnostics[k].append(out[k][: len(idx)].cpu().numpy())
            n_override += int((diagnostics["pick"][-1] != 0).sum())
        log.info("solved pairs [%d, %d)/%d", start, start + len(idx), n)
    seconds = time.perf_counter() - t0
    log.info("solved %d pairs, %d retries, %.2f s", n, n_retry, seconds)
    counts = {"n_pairs": n, "n_retry": n_retry, "seconds": seconds}
    if scorer is not None:
        log.info("rescoring overrode %d of %d picks", n_override, n)
        calls = sum_int(scorer.local.calls, mesh)
        dropped = int(all_reduce(
            torch.tensor([scorer.local.sites_dropped], device=device), mesh,
            op=dist.ReduceOp.MAX))
        counts.update(timing, n_override=n_override,
                      classifier_calls=calls, sites_dropped=dropped,
                      rescore={k: np.concatenate(v, 0)
                               for k, v in diagnostics.items()})
    return np.concatenate(chunks, axis=0), counts


def houv_eval_main(cfg: Config, log, mesh) -> dict:
    """The solver's evaluation on the labelled val split (reference
    registration/train_HOUV.py:40-131): RotE, transE, MSE (the reference's
    alias of RMSE), RMSE, recall (RMSE < 0.1) and GeoE (geodesic rotation
    error plus translation error), averaged over the pairs, and under
    ``buckets`` the same per (rot_level, match_level) with each bucket's
    pair count. Whole batches only, at most ``batch_size`` pairs each;
    with ``rescore_ckpt`` the solves are rescored. Each batch's pairs
    split over ``mesh``'s ranks (a batch cut to the split rounded down to
    a multiple of the ranks, as in the JAX CLI)."""
    device = mesh.device
    ds = build_dataset(cfg, "val")
    scfg = solver_config(cfg)
    metric_names = ("RotE", "transE", "MSE", "RMSE", "recall", "GeoE")
    meters = {m: AverageValueMeter() for m in metric_names}
    grid = SplitMeterGrid(metrics=metric_names)
    width = mesh.size
    if len(ds) < width:
        raise ValueError(f"val split of {len(ds)} pairs < {width} ranks")
    bs = max(min(cfg.batch_size, len(ds)) // width * width, width)
    scorer = make_rescorer(cfg, log, device, mesh)
    timing: dict = {}
    n_done = n_retry = 0
    t0 = time.perf_counter()
    for start in range(0, (len(ds) // bs) * bs, bs):
        batch = ds.get_batch(np.arange(start, start + bs))
        src = torch.as_tensor(batch["src"], device=device)
        tgt = torch.as_tensor(batch["tgt"], device=device)
        out = _solve_batch(cfg, scfg, src, tgt, start, scorer, mesh, timing)
        tf = out["transform"]
        t_gt = torch.as_tensor(batch["transform"], device=device).float()
        r_err, t_err = evaluate_solution(tf, t_gt)
        rmse = rmse_loss(src, tf, t_gt)
        # the reference's MSE meter tracks rmse_loss; GeoE is the extra
        # geodesic + translation meter
        geo = (rotation_geodesic_error(tf[:, :3, :3], t_gt[:, :3, :3])
               + translation_error(tf[:, :3, 3], t_gt[:, :3, 3]))
        rmse = rmse.cpu().numpy()
        vals = {"RotE": r_err.cpu().numpy(), "transE": t_err.cpu().numpy(),
                "MSE": rmse, "RMSE": rmse,
                "recall": (rmse < 0.1).astype(np.float32),
                "GeoE": geo.cpu().numpy()}
        for m, arr in vals.items():
            meters[m].update(float(arr.mean()), bs)
        if "rot_level" in batch and "match_level" in batch:
            grid.update(batch["rot_level"], batch["match_level"], vals)
        n_done += bs
        n_retry += out["n_retry"]
        log.info("[%d/%d] %sretries %d", n_done, len(ds),
                 "".join(f"{m}: {v.avg:.4f}; " for m, v in meters.items()),
                 out["n_retry"])
    for line in grid.logs():
        log.info(line)
    seconds = time.perf_counter() - t0
    log.info("HOUV eval done: %d pairs in %.1f s (%.3f pairs/s)", n_done,
             seconds, n_done / max(seconds, 1e-9))
    buckets = {f"rot{i}_match{j}": dict(
        {m: grid.grid[i][j][m].avg for m in metric_names},
        n=grid.grid[i][j]["RotE"].count)
        for i in range(2) for j in range(2)}
    return dict({m: v.avg for m, v in meters.items()}, buckets=buckets,
                n_pairs=n_done, n_retry=n_retry, seconds=seconds, **timing)


def _launch_counts() -> dict:
    """The launch counters of the kernels the registration paths run."""
    return {"nn_both": chamfer_indices.launches,
            "fps": furthest_point_sample.launches,
            "knn": knn_indices.launches,
            "knn_wide": knn_indices.wide_launches}


def classical_solve(cfg: Config, src, tgt, device) -> dict:
    """One batch through the config's classical solver at the JAX CLI's
    settings: ``fgr`` at max(num_iters, 48) GNC iterations, ``goicp_bnb``
    at max(num_iters, 10) levels and translation half-width ``max_trans``,
    ``goicp`` at num_iters ICP iterations a start (threshold 0.1), ``icp``
    at max(num_iters, 50) (threshold 0.02)."""
    if cfg.model_name == "fgr":
        return fgr_solve(src, tgt, iters=max(cfg.num_iters, 48),
                         device=device)
    if cfg.model_name == "goicp_bnb":
        return goicp_bnb_solve(src, tgt, trans_half=cfg.max_trans,
                               levels=max(cfg.num_iters, 10), device=device)
    if cfg.model_name == "goicp":
        return goicp_solve(src, tgt, threshold=0.1, max_iters=cfg.num_iters,
                           device=device)
    return icp_solve(src, tgt, threshold=0.02,
                     max_iters=max(cfg.num_iters, 50), device=device)


def icp_eval_main(cfg: Config, log, device) -> dict:
    """The classical baselines on the labelled val split (reference
    registration/train_ICP.py:104-210, test_goicp.py's Go-ICP sweep):
    ``classical_solve`` batch by batch, whole batches only, at most
    ``batch_size`` pairs each. Returns RotE, transE and recall (the share
    of pairs under 5° of rotation error), averaged over the pairs, with
    ``n_pairs``, ``seconds`` (the batches' wall time, each ending in a
    device sync), the kernels' ``launches`` in the run and the solved
    ``transforms`` (n_pairs, 4, 4); for goicp_bnb also its per-pair
    certificate under ``bnb`` (e, gap, certified)."""
    ds = build_dataset(cfg, "val")
    meters = {m: AverageValueMeter() for m in ("RotE", "transE", "recall")}
    bs = max(min(cfg.batch_size, len(ds)), 1)
    before = _launch_counts()
    transforms, bnb = [], {"e": [], "gap": [], "certified": []}
    t0 = time.perf_counter()
    for start in range(0, (len(ds) // bs) * bs, bs):
        batch = ds.get_batch(np.arange(start, start + bs))
        src = torch.as_tensor(batch["src"], device=device)
        tgt = torch.as_tensor(batch["tgt"], device=device)
        out = classical_solve(cfg, src, tgt, device)
        if cfg.model_name == "goicp_bnb":
            for k in bnb:
                bnb[k].append(out[k].cpu().numpy())
            log.info("goicp_bnb: e %.5f gap %.5f certified %d/%d",
                     float(bnb["e"][-1].mean()), float(bnb["gap"][-1].mean()),
                     int(bnb["certified"][-1].sum()), bs)
        t_gt = torch.as_tensor(batch["transform"], device=device).float()
        r_err, t_err = evaluate_solution(out["transform"], t_gt)
        r_err = r_err.cpu().numpy()
        meters["RotE"].update(float(r_err.mean()), bs)
        meters["transE"].update(float(t_err.mean()), bs)
        meters["recall"].update(float((r_err < 5.0).mean()), bs)
        transforms.append(out["transform"].cpu().numpy())
        log.info("".join(f"{m}: {v.avg:.4f}; " for m, v in meters.items()))
    seconds = time.perf_counter() - t0
    n_done = len(transforms) * bs
    log.info("%s eval done: %d pairs in %.1f s (%.3f pairs/s)",
             cfg.model_name, n_done, seconds, n_done / max(seconds, 1e-9))
    after = _launch_counts()
    rec = dict({m: v.avg for m, v in meters.items()}, n_pairs=n_done,
               seconds=seconds,
               launches={k: after[k] - before[k] for k in after},
               transforms=np.concatenate(transforms, 0) if transforms
               else np.zeros((0, 4, 4), np.float32))
    if cfg.model_name == "goicp_bnb" and transforms:
        rec["bnb"] = {k: np.concatenate(v, 0) for k, v in bnb.items()}
    return rec


def _model_sweep(cfg: Config, ds, mesh):
    """The test split batch by batch through the config's trained model
    (``load_model``'s weights, else the seeded initialisation): its
    predictions, the seconds of all batches and of the first alone (its
    allocations and kernel set-up). The tail batch is padded by repetition
    (``pad_last``), so every batch has one shape; each batch's rows split
    over ``mesh``'s ranks."""
    trainer = make_trainer(cfg, mesh.device, mesh)
    trainer.init_state()
    outs = []
    t0 = time.perf_counter()
    first = None
    for i, batch in enumerate(batch_iterator(ds, cfg.batch_size,
                                             pad_last=True)):
        valid = int(batch.pop("valid"))
        outs.append(trainer.predict_batch(batch, step=i)[:valid].cpu()
                    .numpy())
        if first is None:
            first = time.perf_counter() - t0
    seconds = time.perf_counter() - t0
    return np.concatenate(outs, axis=0), seconds, first


def _completion_sweep(cfg: Config, ds, log, mesh):
    """Complete the test split with the config's model: (N, points, 3),
    the model's output cloud (num_points; vrcnet_knn's num_coarse +
    num_points), and the seconds of all batches and of the first alone."""
    results, seconds, first = _model_sweep(cfg, ds, mesh)
    log.info("completed %d clouds, %.2f s", len(ds), seconds)
    return results, {"n_clouds": len(ds), "seconds": seconds,
                     "first_batch_seconds": first}


def _learned_registration_sweep(cfg: Config, ds, log, mesh):
    """Register the test split's pairs with the config's learned model
    (dcp, deepgmr or idam): the (N, 4, 4) transforms, and the seconds of
    all batches and of the first alone."""
    results, seconds, first = _model_sweep(cfg, ds, mesh)
    log.info("registered %d pairs with %s, %.2f s", len(ds), cfg.model_name,
             seconds)
    return results, {"n_pairs": len(ds), "seconds": seconds,
                     "first_batch_seconds": first}


def _shard_range(path: str) -> tuple[int, int] | None:
    """(l, r) of a ``results_<l>_<r>.h5`` file name, else None."""
    parts = os.path.basename(path)[len("results_"):-len(".h5")].split("_")
    if len(parts) != 2 or not all(p.isdigit() for p in parts):
        return None
    return int(parts[0]), int(parts[1])


def _missing_ranges(total: int, shards) -> list[tuple[int, int]]:
    """The maximal ranges of [0, total) that no (l, r) in ``shards``
    covers, ascending."""
    missing, pos = [], 0
    for l, r in sorted(shards):
        if l > pos:
            missing.append((pos, l))
        pos = max(pos, r)
    if pos < total:
        missing.append((pos, total))
    return missing


def combine_main(cfg: Config, config_path: str, device, log,
                 data_path: str | None = None) -> dict:
    """Merge a sharded sweep (the reference's run_test.sh combine, a blind
    concatenation after a sleep; restartable here): read the
    ``results_<l>_<r>.h5`` shards under ``<work_dir>/<model_name>/``, solve
    each range of the test split that none covers through ``test_main -l
    -r`` (with this config path, ``data_path`` and device), then write
    ``results.h5``, ``submission.zip`` and ``manifest.json`` (the split's
    size and the shards merged). Serves registration (N, 4, 4) and
    completion (N, num_points, 3) shards alike. Raises ValueError, naming
    the files, when shards overlap, reach past the split or hold other than
    r - l rows."""
    out_dir = os.path.join(cfg.work_dir, cfg.model_name)
    total = len(build_dataset(cfg, "test"))
    shards = {}
    for path in sorted(glob.glob(os.path.join(out_dir, "results_*_*.h5"))):
        rng = _shard_range(path)
        if rng is not None:
            shards[rng] = path
    prev = None
    for l, r in sorted(shards):
        if not 0 <= l < r <= total:
            raise ValueError(f"shard {shards[(l, r)]} is not a range of the "
                             f"{total}-pair test split")
        if prev is not None and l < prev[1]:
            raise ValueError(f"shards {shards[prev]} and {shards[(l, r)]} "
                             "overlap")
        prev = (l, r)
    resolved = _missing_ranges(total, shards)
    for l, r in resolved:
        log.info("solving missing shard [%d, %d)", l, r)
        argv = ["-c", config_path, "-l", str(l), "-r", str(r),
                "--device", str(device)]
        if data_path:
            argv += ["--data-path", data_path]
        shards[(l, r)] = test_main(argv)["results_h5"]
    parts = []
    for (l, r), path in sorted(shards.items()):
        part = read_results_h5(path)
        if part.shape[0] != r - l:
            raise ValueError(f"shard {path} holds {part.shape[0]} rows, not "
                             f"{r - l}")
        parts.append(part)
    h5_path = write_results_h5(os.path.join(out_dir, "results.h5"),
                               np.concatenate(parts, axis=0))
    zip_path = write_submission(os.path.join(out_dir, "submission.zip"),
                                h5_path)
    manifest = os.path.join(out_dir, "manifest.json")
    with open(manifest, "w") as f:
        json.dump({"total": total,
                   "shards": [list(k) for k in sorted(shards)]}, f)
    log.info("combined %d shards (%d solved now) -> %s", len(shards),
             len(resolved), h5_path)
    return {"results_h5": h5_path, "submission": zip_path,
            "manifest": manifest, "shards": sorted(shards),
            "resolved": resolved}


def _flag(value) -> bool:
    """``--combine``'s value: given alone it is on; 0, false, no and off
    turn it off."""
    return str(value).strip().lower() not in ("", "0", "false", "no", "off")


def aux_eval_main(cfg: Config, log, mesh) -> dict:
    """An aux model's "test": its trainer's validation meters on the val
    split (the reference evaluates these models in their training loops;
    they have no submission), from ``load_model``'s weights or the seeded
    initialisation."""
    trainer = make_trainer(cfg, mesh.device, mesh)
    trainer.init_state()
    metrics = trainer.validate(build_dataset(cfg, "val"))
    log.info("aux test metrics: %s", metrics)
    return metrics


def test_main(argv=None) -> dict:
    """Run the sweep; returns the paths written, the wall seconds of the
    sweep's batches (set-up excluded) and its counts: ``n_pairs`` and
    ``n_retry`` (the pairs that entered the retry passes) for HOUV,
    ``n_pairs`` and ``first_batch_seconds`` for a learned registration
    model, ``n_clouds`` and ``first_batch_seconds`` for completion. For an
    aux model, ``aux_eval_main``'s meters. With ``--combine``,
    ``combine_main``'s record. Over several ranks (``job_mesh``) each rank
    returns the record and rank 0 writes the files; where this call starts
    the ranks, it returns rank 0's record."""
    argv = sys.argv[1:] if argv is None else list(argv)
    p = argparse.ArgumentParser()
    p.add_argument("-c", "--config", required=True)
    p.add_argument("-l", type=int, default=None)
    p.add_argument("-r", type=int, default=None)
    p.add_argument("--combine", nargs="?", const=True, default=False,
                   type=_flag,
                   help="merge the results_<l>_<r>.h5 shards, solving the "
                        "ranges none covers")
    p.add_argument("--data-path", default=None,
                   help="MVP .h5 file; overrides the config's data_path "
                        "(absent file -> synthetic fallback)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain versions of the "
                        "kernels")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_config(args.config)
    if args.data_path:
        cfg.data_path = args.data_path

    if args.combine:
        return combine_main(cfg, args.config, device, setup_logging(None),
                            args.data_path)
    mesh, n_ranks = job_mesh(cfg, device)
    if n_ranks:
        return launch(_rank_entry, n_ranks, device, args=(test_main, argv))
    log = _rank_logging(None, mesh)

    if cfg.model_name in AUX_TRAINERS:
        return aux_eval_main(cfg, log, mesh)

    index_range = (args.l, args.r) if args.l is not None else None
    ds = build_dataset(cfg, "test", index_range=index_range)
    if cfg.model_name in LEARNED_REGISTRATION:
        results, counts = _learned_registration_sweep(cfg, ds, log, mesh)
    elif is_registration(cfg):
        results, counts = _houv_sweep(cfg, ds, log, mesh,
                                      offset=args.l or 0)
    else:
        results, counts = _completion_sweep(cfg, ds, log, mesh)

    suffix = f"_{args.l}_{args.r}" if index_range else ""
    out_dir = os.path.join(cfg.work_dir, cfg.model_name)
    h5_path = os.path.join(out_dir, f"results{suffix}.h5")
    zip_path = os.path.join(out_dir, f"submission{suffix}.zip")
    if mesh.rank == 0:
        write_results_h5(h5_path, results)
        write_submission(zip_path, h5_path)
        log.info("wrote %s and %s", h5_path, zip_path)
    barrier(mesh)
    return {"results_h5": h5_path, "submission": zip_path, **counts}


def train_main(argv=None) -> dict:
    """Train the config's completion, learned registration or aux model
    (the trainer's ``fit`` on the train split, validating on the val
    split).
    Returns the trainer, its log directory, the checkpoint ``fit`` wrote
    last, the per-step losses and the wall seconds of ``fit`` (set-up
    excluded). For ``model_name: houv`` returns ``houv_eval_main``'s
    meters, for the classical solvers ``icp_eval_main``'s (in one process,
    whatever ``n_devices`` says). Over several ranks (``job_mesh``) training
    is data-parallel and rank 0 writes the checkpoints; where this call
    starts the ranks, it returns rank 0's record without the trainer."""
    argv = sys.argv[1:] if argv is None else list(argv)
    p = argparse.ArgumentParser(prog="houv_tpu_torch.train.cli train")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("--data-path", default=None,
                   help="MVP .h5 file; overrides the config's data_path "
                        "(absent file -> synthetic fallback)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain versions of the "
                        "kernels")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_config(args.config)
    if args.data_path:
        cfg.data_path = args.data_path
    if cfg.model_name in CLASSICAL_MODELS:
        log = setup_logging(os.path.join(cfg.work_dir, cfg.model_name))
        return icp_eval_main(cfg, log, device)
    mesh, n_ranks = job_mesh(cfg, device)
    if n_ranks:
        return launch(_rank_entry, n_ranks, device, args=(train_main, argv))
    if cfg.model_name == "houv":
        # the reference's train_HOUV.py: nothing to train, the solver's
        # evaluation on the labelled split
        log = _rank_logging(os.path.join(cfg.work_dir, "houv"), mesh)
        return houv_eval_main(cfg, log, mesh)
    if is_registration(cfg) and cfg.model_name not in (
            LEARNED_REGISTRATION | AUX_MODELS):
        raise ValueError(f"{cfg.model_name!r} does not train on the "
                         f"registration split {cfg.dataset!r}")
    trainer = make_trainer(cfg, mesh.device, mesh)
    log = _rank_logging(trainer.log_dir, mesh)
    log.info("config: %s", cfg)
    train_ds = build_dataset(cfg, "train")
    val_ds = build_dataset(cfg, "val")
    trainer.init_state()
    out = {"trainer": trainer, "log_dir": trainer.log_dir,
           "checkpoint": os.path.join(trainer.log_dir, "network.ckpt")}
    t0 = time.perf_counter()
    if cfg.use_native_loader and is_registration(cfg):
        # the C++ prefetching loader (poses drawn in a native thread pool),
        # step-based as the JAX CLI: native_steps, else nepoch epochs of
        # the split's batches; over several ranks one worker thread, so that
        # every rank draws the same global batches
        from houv_tpu_torch.data.native_loader import NativeRegistrationLoader

        epoch_len = max(len(train_ds) // cfg.batch_size, 1)
        n_steps = cfg.native_steps or cfg.nepoch * epoch_len
        with NativeRegistrationLoader(
                train_ds.src, train_ds.tgt, cfg.batch_size,
                max_angle_deg=cfg.max_angle, max_trans=cfg.max_trans,
                seed=cfg.manual_seed or 2021,
                n_threads=4 if mesh.size == 1 else 1) as loader:
            trainer.fit_steps(loader, n_steps, epoch_len=epoch_len,
                              val_ds=val_ds)
            out["queue_size"] = loader.queue_size()
        out["steps"] = n_steps
    else:
        trainer.fit(train_ds, val_ds)
    return {**out, "losses": trainer.losses,
            "seconds": time.perf_counter() - t0}


def main(argv=None):
    """``train ...`` trains; anything else is the test sweep."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "train":
        return train_main(argv[1:])
    return test_main(argv)


if __name__ == "__main__":
    main()
