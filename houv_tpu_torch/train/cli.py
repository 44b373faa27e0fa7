"""Command-line entries (counterpart of ``houv_tpu/train/cli.py`` on one
device): the test sweep (HOUV registration; PCN, ECG or VRCNet completion),
the training of a completion model and the HOUV solver's evaluation.

    python -m houv_tpu_torch.train.cli -c cfgs/houv_fast.yaml [-l L -r R]
        [--data-path FILE] [--device cuda|cpu]
    (likewise houv.yaml, houv_quality.yaml, houv_rescore.yaml, ...)
    python -m houv_tpu_torch.train.cli -c cfgs/vrcnet.yaml [--device cpu]
    python -m houv_tpu_torch.train.cli train -c cfgs/vrcnet.yaml
        [--data-path FILE] [--device cuda|cpu]
    (likewise cfgs/pcn.yaml and cfgs/ecg.yaml)
    python -m houv_tpu_torch.train.cli train -c cfgs/houv_rescore.yaml

The sweep runs the test split batch by batch and writes ``results.h5`` (the
(N, 4, 4) transforms, or the (N, num_points, 3) completions) and
``submission.zip`` under ``<work_dir>/<model_name>/``; with ``load_model``
set, the completion sweep runs that checkpoint's weights; with
``rescore_ckpt`` set, the HOUV sweep picks each pair's transform among
rotation-diverse candidates with that trained classifier
(``solvers/rescore.py``). ``train`` fits the config's completion model and
writes ``network.ckpt`` and ``best_<metric>_network.ckpt`` under
``<work_dir>/<model>_<loss>_<flag>/``; for ``model_name: houv`` it runs
``houv_eval_main`` on the labelled val split instead. When the MVP .h5 file
is absent, a synthetic split stands in.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from houv_tpu_torch._device import resolve_device
from houv_tpu_torch.data.mvp import (
    MVPCompletionDataset,
    MVPRegistrationDataset,
    synthesize_completion_set,
    synthesize_registration_pairs,
)
from houv_tpu_torch.data.pipeline import batch_iterator
from houv_tpu_torch.geometry.rotations import (
    rmse_loss,
    rotation_geodesic_error,
    translation_error,
)
from houv_tpu_torch.models import get_model
from houv_tpu_torch.solvers.houv import (
    HOUVConfig,
    evaluate_solution,
    houv_solve,
    init_params,
)
from houv_tpu_torch.solvers.rescore import (
    houv_candidate_pools,
    houv_solve_rescored,
    make_classifier_scorer,
)
from houv_tpu_torch.state import state_from_flax
from houv_tpu_torch.train.checkpoint import read_flax_msgpack
from houv_tpu_torch.train.config import (Config, load_config,
                                         parse_refresh_schedule)
from houv_tpu_torch.train.harness import CompletionTrainer
from houv_tpu_torch.train.submission import write_results_h5, write_submission
from houv_tpu_torch.utils.logging_utils import setup_logging
from houv_tpu_torch.utils.meters import AverageValueMeter, SplitMeterGrid

REGISTRATION_MODELS = {"dcp", "deepgmr", "idam", "houv", "icp", "goicp",
                       "goicp_bnb", "fgr"}


def is_registration(cfg: Config) -> bool:
    return cfg.model_name in REGISTRATION_MODELS or cfg.dataset.endswith("rg")


def build_dataset(cfg: Config, split: str, index_range=None):
    """The split of the config's task: the MVP .h5 file when present, else
    a synthetic split (seed 2021 for train, 7 otherwise)."""
    if cfg.dataset == "modelnet":
        raise NotImplementedError(
            "ModelNet datasets are not ported yet (ROADMAP.md Queue 1, "
            "item 12)")
    have_file = cfg.data_path and os.path.exists(cfg.data_path)
    n = cfg.synthetic_size or (64 if split != "train" else 128)
    seed = 2021 if split == "train" else 7
    if not is_registration(cfg):
        with_voxels = cfg.model_name == "vrcnet_knn"
        if have_file:
            return MVPCompletionDataset(
                split, path=cfg.data_path, scale_aug=cfg.scale_aug,
                index_range=index_range, category=cfg.category,
                with_voxels=with_voxels)
        data = synthesize_completion_set(
            max(n // 8, 2), views_per_model=8,
            n_partial=cfg.num_input or cfg.num_points,
            n_complete=cfg.num_points, seed=seed)
        return MVPCompletionDataset(
            split, data=data, views_per_model=8, scale_aug=cfg.scale_aug,
            index_range=index_range, with_voxels=with_voxels)
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


def make_rescorer(cfg: Config, log, device):
    """The classifier scorer of ``cfg.rescore_ckpt``, or None. A missing
    file logs a warning and the solve goes without rescoring, as in the JAX
    CLI; a file that is there but does not load raises. The classifier is
    built in bf16 mode, as the JAX CLI builds it; a checkpoint holding a
    third ``Dense`` has the loss-gap head, which is then fed."""
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
    return make_classifier_scorer(model, micro_batch=16,
                                  n_aug=cfg.rescore_tta, use_gap=has_gap)


def _pair_generator(cfg: Config, start: int) -> torch.Generator:
    """The restarts' generator of the batch starting at pair ``start``."""
    seed = cfg.manual_seed or 2021
    return torch.Generator().manual_seed(
        int(np.random.SeedSequence([seed, start]).generate_state(1)[0]))


def _solve_batch(cfg: Config, scfg: HOUVConfig, src, tgt, start, scorer,
                 device, timing: dict) -> dict:
    """One batch of pairs through ``houv_solve``, or with a scorer through
    the candidate pools and ``houv_solve_rescored`` (their seconds added to
    ``timing``, each ending in a device sync)."""
    params0 = init_params(_pair_generator(cfg, start), src.shape[0],
                          scfg.kernel, scfg.lattice_init, device=device)
    if scorer is None:
        return houv_solve(src, tgt, scfg, params0=params0, device=device)
    t0 = time.perf_counter()
    pools = houv_candidate_pools(src, tgt, scfg, params0=params0,
                                 device=device)
    pools[0].cpu()
    t1 = time.perf_counter()
    out = houv_solve_rescored(src, tgt, scfg, scorer,
                              n_cand=cfg.rescore_cands,
                              angle_deg=cfg.rescore_angle,
                              margin=cfg.rescore_margin, device=device,
                              pools=pools)
    out["pick"].cpu()
    timing["pool_seconds"] = timing.get("pool_seconds", 0.0) + t1 - t0
    timing["score_seconds"] = (timing.get("score_seconds", 0.0)
                               + time.perf_counter() - t1)
    return out


_DIAGNOSTICS = ("cand_loss", "cand_logits", "cand_r", "cand_t", "pick")


def _houv_sweep(cfg: Config, ds, device, log):
    """Solve the registration split batch by batch: (N, 4, 4) transforms
    and, for the log, the pairs that entered the retry passes; rescored,
    also the pairs whose pick the classifier overrode, the seconds of the
    pools and of the scoring, and the rescoring's per-pair diagnostics
    (``rescore``: candidates, their losses and logits, the picks)."""
    if cfg.model_name != "houv":
        raise NotImplementedError(
            f"the registration sweep runs model_name 'houv' only, got "
            f"{cfg.model_name!r} (ROADMAP.md Queue 1, items 9 and 12)")
    scfg = solver_config(cfg)
    scorer = make_rescorer(cfg, log, device)
    # Pairs go in batches of batch_size (the restart expansion makes a
    # pair kernel·N points); the tail batch is padded by repetition so
    # every batch shares one Adam scale, as in the JAX CLI.
    bs = max(cfg.batch_size, 1)
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
        out = _solve_batch(cfg, scfg, src, tgt, start, scorer, device, timing)
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
        counts.update(timing, n_override=n_override,
                      classifier_calls=scorer.calls,
                      sites_dropped=scorer.sites_dropped,
                      rescore={k: np.concatenate(v, 0)
                               for k, v in diagnostics.items()})
    return np.concatenate(chunks, axis=0), counts


def houv_eval_main(cfg: Config, log, device) -> dict:
    """The solver's evaluation on the labelled val split (reference
    registration/train_HOUV.py:40-131): RotE, transE, MSE (the reference's
    alias of RMSE), RMSE, recall (RMSE < 0.1) and GeoE (geodesic rotation
    error plus translation error), averaged over the pairs, and under
    ``buckets`` the same per (rot_level, match_level) with each bucket's
    pair count. Whole batches only, at most ``batch_size`` pairs each;
    with ``rescore_ckpt`` the solves are rescored."""
    ds = build_dataset(cfg, "val")
    scfg = solver_config(cfg)
    metric_names = ("RotE", "transE", "MSE", "RMSE", "recall", "GeoE")
    meters = {m: AverageValueMeter() for m in metric_names}
    grid = SplitMeterGrid(metrics=metric_names)
    bs = max(min(cfg.batch_size, len(ds)), 1)
    scorer = make_rescorer(cfg, log, device)
    timing: dict = {}
    n_done = n_retry = 0
    t0 = time.perf_counter()
    for start in range(0, (len(ds) // bs) * bs, bs):
        batch = ds.get_batch(np.arange(start, start + bs))
        src = torch.as_tensor(batch["src"], device=device)
        tgt = torch.as_tensor(batch["tgt"], device=device)
        out = _solve_batch(cfg, scfg, src, tgt, start, scorer, device, timing)
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


def _completion_sweep(cfg: Config, ds, device, log):
    """Complete the test split batch by batch with the config's model
    (``load_model``'s weights, else the seeded initialisation):
    (N, num_points, 3)."""
    trainer = CompletionTrainer(cfg, device)
    trainer.init_state()
    outs = []
    t0 = time.perf_counter()
    # pad_last keeps one batch shape for the whole sweep
    for i, batch in enumerate(batch_iterator(ds, cfg.batch_size,
                                             pad_last=True)):
        valid = int(batch.pop("valid"))
        outs.append(trainer.predict_batch(batch, step=i)[:valid].cpu()
                    .numpy())
    seconds = time.perf_counter() - t0
    log.info("completed %d clouds, %.2f s", len(ds), seconds)
    return np.concatenate(outs, axis=0), {"n_clouds": len(ds),
                                          "seconds": seconds}


def test_main(argv=None) -> dict:
    """Run the sweep; returns the paths written, the wall seconds of the
    sweep's batches (set-up excluded) and its counts: ``n_pairs`` and
    ``n_retry`` (the pairs that entered the retry passes) for registration,
    ``n_clouds`` for completion."""
    p = argparse.ArgumentParser()
    p.add_argument("-c", "--config", required=True)
    p.add_argument("-l", type=int, default=None)
    p.add_argument("-r", type=int, default=None)
    p.add_argument("--combine", default=False)
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
    log = setup_logging(None)

    if args.combine:
        raise NotImplementedError(
            "--combine is not ported yet (ROADMAP.md Queue 1, item 7)")
    if cfg.n_devices and cfg.n_devices > 1:
        raise NotImplementedError(
            "multi-device sweeps are not ported yet (ROADMAP.md Queue 1, "
            "item 13)")

    index_range = (args.l, args.r) if args.l is not None else None
    sweep = _houv_sweep if is_registration(cfg) else _completion_sweep
    ds = build_dataset(cfg, "test", index_range=index_range)
    results, counts = sweep(cfg, ds, device, log)

    suffix = f"_{args.l}_{args.r}" if index_range else ""
    out_dir = os.path.join(cfg.work_dir, cfg.model_name)
    h5_path = write_results_h5(
        os.path.join(out_dir, f"results{suffix}.h5"), results)
    zip_path = write_submission(
        os.path.join(out_dir, f"submission{suffix}.zip"), h5_path)
    log.info("wrote %s and %s", h5_path, zip_path)
    return {"results_h5": h5_path, "submission": zip_path, **counts}


def train_main(argv=None) -> dict:
    """Train the config's completion model (``CompletionTrainer.fit`` on the
    train split, validating on the val split). Returns the trainer, its log
    directory, the checkpoint ``fit`` wrote last, the per-step losses and
    the wall seconds of ``fit`` (set-up excluded). For ``model_name: houv``
    returns ``houv_eval_main``'s meters."""
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
    if cfg.model_name == "houv":
        # the reference's train_HOUV.py: nothing to train, the solver's
        # evaluation on the labelled split
        log = setup_logging(os.path.join(cfg.work_dir, "houv"))
        return houv_eval_main(cfg, log, device)
    if is_registration(cfg):
        raise NotImplementedError(
            f"training or evaluating registration model {cfg.model_name!r} "
            "is not ported yet (ROADMAP.md Queue 1, items 9 and 12)")
    if cfg.n_devices and cfg.n_devices > 1:
        raise NotImplementedError(
            "multi-device training is not ported yet (ROADMAP.md Queue 1, "
            "item 13)")
    trainer = CompletionTrainer(cfg, device)
    log = setup_logging(trainer.log_dir)
    log.info("config: %s", cfg)
    train_ds = build_dataset(cfg, "train")
    val_ds = build_dataset(cfg, "val")
    trainer.init_state()
    t0 = time.perf_counter()
    trainer.fit(train_ds, val_ds)
    seconds = time.perf_counter() - t0
    return {"trainer": trainer, "log_dir": trainer.log_dir,
            "checkpoint": os.path.join(trainer.log_dir, "network.ckpt"),
            "losses": trainer.losses, "seconds": seconds}


def main(argv=None):
    """``train ...`` trains; anything else is the test sweep."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "train":
        return train_main(argv[1:])
    return test_main(argv)


if __name__ == "__main__":
    main()
