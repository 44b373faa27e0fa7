"""Classifier-rescored restart selection for the HOUV solver (counterpart
of ``houv_tpu/solvers/rescore.py`` on one device).

1. ``houv_candidate_pools`` (``solvers/houv.py``, which ``houv_solve``
   runs too): the angle-window passes, retries included, keeping EVERY
   restart's (loss, R, T); a window a pair never entered carries +inf
   losses;
2. ``extract_candidates``: per pair, greedily the ``n_cand`` lowest-loss
   restarts that lie pairwise at least ``angle_deg`` apart (rotation NMS);
3. a scorer gives each candidate a logit: ``make_classifier_scorer`` runs
   the trained alignment classifier on the overlay of the moved source and
   the target, ``make_oracle_scorer`` the negative error against ground
   truth (a diagnostic);
4. ``rescore_pick``: candidate 0 is the loss choice (the reference's);
   another wins only when its logit beats candidate 0's by more than
   ``margin``. margin = +inf is ``houv_solve``'s selection.

Over several ranks (``parallel/mesh.py``), ``sharded_houv_solve_rescored``
runs the four steps on each rank's pairs and gathers the results, and
``make_sharded_classifier_scorer`` scores a whole batch's candidates with
each rank taking its pairs' rows.
"""

from __future__ import annotations

import numpy as np
import torch

from houv_tpu_torch.data.pipeline import shard_rows
from houv_tpu_torch.geometry.rotations import rodrigues, rt_to_transformation
from houv_tpu_torch.parallel.mesh import (all_gather_rows, rank_rows,
                                          sharded_houv_pools, sum_int)
from houv_tpu_torch.solvers.houv import (HOUVConfig, houv_candidate_pools,
                                         voxel_downsample_clouds)


def extract_candidates(pool_loss: torch.Tensor, pool_r: torch.Tensor,
                       pool_t: torch.Tensor, n_cand: int = 8,
                       angle_deg: float = 10.0):
    """Greedy rotation-diverse top-k restarts per pair.

    pool_loss (B, P), +inf on masked slots; pool_r (B, P, 3, 3); pool_t
    (B, P, 3). Returns (cand_loss (B, C), cand_r (B, C, 3, 3), cand_t
    (B, C, 3)) in ascending loss order of the picks; candidate 0 is the
    pool's loss argmin. When fewer than ``n_cand`` restarts lie
    ``angle_deg`` apart, the tail repeats the first pool slot in loss
    order (duplicates score alike, and the first of equal logits wins)."""
    cos_thresh = torch.cos(torch.deg2rad(torch.tensor(
        angle_deg, dtype=torch.float32, device=pool_loss.device)))
    bsz = pool_loss.shape[0]
    rows = torch.arange(bsz, device=pool_loss.device)[:, None]
    order = torch.argsort(pool_loss, dim=1, stable=True)
    loss_s = pool_loss.gather(1, order)
    r_s = pool_r[rows, order]
    t_s = pool_t[rows, order]
    excluded = ~torch.isfinite(loss_s)
    picks = []
    for _ in range(n_cand):
        i = (~excluded).to(torch.uint8).argmax(1)   # first one available
        picks.append(i)
        tr = torch.einsum("bkij,bij->bk", r_s, r_s[rows[:, 0], i])
        cos = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
        # the pick's rotation neighbourhood, the pick itself included
        excluded = excluded | (cos > cos_thresh)
    idx = torch.stack(picks, 1)
    return loss_s.gather(1, idx), r_s[rows, idx], t_s[rows, idx]


def apply_candidates(src: torch.Tensor, cand_r: torch.Tensor,
                     cand_t: torch.Tensor) -> torch.Tensor:
    """src (B, N, 3) × (B, C, 3, 3) / (B, C, 3) -> (B, C, N, 3)."""
    return (torch.einsum("bnc,bkdc->bknd", src, cand_r)
            + cand_t[:, :, None, :])


def _tta_rotations(n: int, device=None) -> torch.Tensor:
    """Deterministic test-time rotations (n, 3, 3): the identity, then
    quarter and half turns about 7 fixed axes."""
    axes = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0], [0, 1, 1],
                     [1, 0, 1], [1, 1, 1]], np.float32)
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    angles = [np.pi / 2, np.pi, -np.pi / 2] * 3
    rots = [torch.eye(3)]
    for i in range(n - 1):
        rots.append(rodrigues(
            torch.tensor([angles[i % len(angles)]], dtype=torch.float32),
            torch.tensor(axes[i % len(axes)][None]))[0])
    return torch.stack(rots[:n]).to(device)


def make_classifier_scorer(model, micro_batch: int = 32, n_aug: int = 1,
                           use_gap: bool = False):
    """Scorer over a trained ``AlignmentClassifier`` (in eval mode, on the
    device of the clouds it will score): (moved (B, C, N, 3), tgt (B, M, 3),
    cand_r, cand_t[, cand_loss]) -> logits (B, C).

    (pair, candidate) rows go through the classifier ``micro_batch`` at a
    time; BatchNorm runs on its running statistics, so a row's logit does
    not depend on its chunk and the tail chunk needs no padding. ``n_aug``
    > 1 averages the logits over that many rotations of the overlay.
    ``use_gap`` feeds the relative CD-loss gap against the loss pick as the
    model's side input (a checkpoint with the gap head). The scorer's
    ``sites_dropped`` is the most sparse-conv sites any call dropped
    beyond capacity, its ``calls`` the classifier calls made."""

    def scorer(moved, tgt, cand_r=None, cand_t=None, cand_loss=None):
        # the convs' bf16 operands are multiplied in full f32
        torch.backends.cuda.matmul.allow_tf32 = False
        bsz, c = moved.shape[:2]
        src_moved = moved.reshape(bsz * c, *moved.shape[2:])
        tgt_rep = tgt.repeat_interleave(c, 0)
        extra = None
        if use_gap:
            if cand_loss is None:
                raise ValueError("a use_gap scorer needs cand_loss")
            base = cand_loss[:, :1].clamp_min(1e-6)
            gap = torch.clamp((cand_loss - cand_loss[:, :1]) / base, 0.0, 4.0)
            extra = gap.reshape(bsz * c, 1).float()
        rots = _tta_rotations(n_aug, moved.device) if n_aug > 1 else None
        outs = []
        with torch.no_grad():
            for s in range(0, bsz * c, micro_batch):
                cs = src_moved[s:s + micro_batch]
                ct = tgt_rep[s:s + micro_batch]
                ce = None if extra is None else extra[s:s + micro_batch]
                if rots is None:
                    logits = model(cs, ct, ce)
                else:
                    logits = torch.stack([
                        model(cs @ rot.T, ct @ rot.T, ce) for rot in rots
                    ]).mean(0)
                scorer.calls += 1
                scorer.sites_dropped = max(scorer.sites_dropped,
                                           int(model.sites_dropped))
                outs.append(logits)
        return torch.cat(outs).reshape(bsz, c)

    scorer.calls = 0
    scorer.sites_dropped = 0
    return scorer


def oracle_logits(cand_r: torch.Tensor,
                  gt_transforms: torch.Tensor) -> torch.Tensor:
    """-rotation error (degrees) of each candidate against ground truth:
    cand_r (B, C, 3, 3), gt (B, 4, 4) -> (B, C)."""
    gt_r = gt_transforms[:, :3, :3]
    tr = torch.einsum("bcij,bij->bc", cand_r, gt_r)
    cos = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    return -torch.rad2deg(torch.arccos(cos))


def make_oracle_scorer(gt_transforms: torch.Tensor):
    """Diagnostic scorer: ``oracle_logits`` against ground truth, the upper
    bound of what any rescoring signal can recover."""

    def scorer(moved, tgt, cand_r, cand_t, cand_loss=None):
        return oracle_logits(cand_r, gt_transforms.to(cand_r))

    return scorer


def rescore_pick(cand_loss: torch.Tensor, logits: torch.Tensor,
                 margin: float = 0.0) -> torch.Tensor:
    """Per pair: candidate 0 unless the best logit (its first index)
    exceeds candidate 0's by MORE than ``margin``. (B,) int64."""
    challenger = logits.argmax(1)
    chal = logits.gather(1, challenger[:, None])[:, 0]
    override = chal > logits[:, 0] + margin
    return torch.where(override, challenger, 0)


def make_sharded_classifier_scorer(model, mesh, micro_batch: int = 32,
                                   n_aug: int = 1, use_gap: bool = False,
                                   axis: str = "data"):
    """``make_classifier_scorer`` over the ranks of ``mesh``: given the
    whole batch's candidates (the same on every rank), each rank scores its
    pairs' (pair · candidate) rows ``micro_batch`` at a time and the logits
    are gathered, (B, C) on every rank. Its ``local`` is the host scorer
    of one rank's rows (what ``sharded_houv_solve_rescored`` calls), with
    ``calls`` and ``sites_dropped``. Build it once for a sweep."""
    local = make_classifier_scorer(model, micro_batch, n_aug, use_gap)
    width, index = mesh.shape[axis], mesh.index(axis)

    def scorer(moved, tgt, cand_r=None, cand_t=None, cand_loss=None):
        def mine(x):
            return None if x is None else shard_rows(x, index, width)

        logits = local(mine(moved), mine(tgt), mine(cand_r), mine(cand_t),
                       cand_loss=mine(cand_loss))
        return all_gather_rows(logits, mesh, axis)

    scorer.local = local
    return scorer


def sharded_houv_solve_rescored(src: torch.Tensor, tgt: torch.Tensor, mesh,
                                cfg: HOUVConfig, scorer, n_cand: int = 8,
                                angle_deg: float = 10.0,
                                margin: float = 0.0,
                                params0: dict | None = None,
                                generator: torch.Generator | None = None,
                                axis: str = "data", pools=None) -> dict:
    """``houv_solve_rescored`` with the batch's pairs split over the mesh:
    each rank's pools (``parallel.mesh.sharded_houv_pools``: the whole
    batch's restarts, the mean over its B·K replicas; or ``pools``, this
    rank's, given), its candidates, their logits from ``scorer`` (a
    sharded scorer's ``local``) and its picks; then every result gathered,
    ``n_retry`` and ``n_override`` summed. Returns
    ``houv_solve_rescored``'s dict for the whole batch."""
    _check_rescored(cfg)
    if pools is None:
        rows, pools = sharded_houv_pools(src, tgt, mesh, cfg, params0,
                                         generator, axis)
    else:
        rows = rank_rows(src.shape[0], mesh, axis)
    dev = mesh.device
    out = houv_solve_rescored(src[rows].to(dev), tgt[rows].to(dev), cfg,
                              getattr(scorer, "local", scorer), n_cand,
                              angle_deg, margin, device=dev, pools=pools)
    for key, value in out.items():
        out[key] = (all_gather_rows(value, mesh, axis)
                    if torch.is_tensor(value) else sum_int(value, mesh, axis))
    return out


def _check_rescored(cfg: HOUVConfig) -> None:
    """The rescored pick replaces the window merge: the JAX package's
    refusals of two_bracket and window_select='consensus'."""
    if cfg.two_bracket:
        raise NotImplementedError(
            "rescored selection assumes the plain restart axis "
            "(two_bracket folds its own preference rule)")
    if cfg.window_select != "loss":
        raise ValueError(
            "rescoring replaces the window merge itself — "
            "use window_select='loss'")


def houv_solve_rescored(src: torch.Tensor, tgt: torch.Tensor,
                        cfg: HOUVConfig, scorer, n_cand: int = 8,
                        angle_deg: float = 10.0, margin: float = 0.0,
                        params0: dict | None = None,
                        generator: torch.Generator | None = None,
                        device: str | torch.device = "cuda", pools=None):
    """``houv_solve`` with classifier-rescored selection: the pool (from
    ``houv_candidate_pools``, or ``pools`` given) -> candidates -> the
    scorer's logits -> the pick. ``scorer``: (moved (B, C, N, 3), tgt,
    cand_r, cand_t, cand_loss=...) -> logits (B, C), higher = better
    aligned. Returns ``houv_solve``'s dict plus ``n_override`` (pairs
    whose pick is not the loss choice) and the ``cand_loss``,
    ``cand_logits``, ``cand_r``, ``cand_t`` and ``pick`` diagnostics. The
    candidates move the clouds the passes solved, voxel-reduced with
    ``voxel_downsample``."""
    _check_rescored(cfg)
    if pools is None:
        pools = houv_candidate_pools(src, tgt, cfg, params0, generator,
                                     device)
    pool_loss, pool_r, pool_t, n_retry = pools
    src, tgt = voxel_downsample_clouds(src.float(), tgt.float(), cfg)
    cand_loss, cand_r, cand_t = extract_candidates(
        pool_loss, pool_r, pool_t, n_cand, angle_deg)
    moved = apply_candidates(src, cand_r, cand_t)
    logits = scorer(moved, tgt, cand_r, cand_t, cand_loss=cand_loss)
    pick = rescore_pick(cand_loss, logits, margin)
    rows = torch.arange(src.shape[0], device=src.device)
    return {
        "transform": rt_to_transformation(cand_r[rows, pick],
                                          cand_t[rows, pick]),
        "rmse": cand_loss[rows, pick],
        "n_retry": n_retry,
        "n_override": int((pick != 0).sum()),
        "cand_loss": cand_loss,
        "cand_logits": logits,
        "cand_r": cand_r,
        "cand_t": cand_t,
        "pick": pick,
    }
