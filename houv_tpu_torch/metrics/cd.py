"""Chamfer metrics and losses (counterpart of ``houv_tpu/metrics/cd.py``):
``calc_cd`` and ``fscore``, the truncated ``calc_cd_percent`` family and
``loss_view``, and the solver's truncated means. All are differentiable
through ``ops/chamfer.py:chamfer``.

The reference calls ``cd(gt, output)``, so d1 is per ground-truth point and
d2 per output point; that direction is kept so cd_p and cd_t match."""

from __future__ import annotations

import torch

from houv_tpu_torch.ops.chamfer import chamfer


def _smallest_k(d: torch.Tensor, k: int) -> torch.Tensor:
    """k smallest values along the last axis (order irrelevant for means)."""
    return torch.topk(d, k, dim=-1, largest=False, sorted=False).values


def _safe_sqrt(d: torch.Tensor) -> torch.Tensor:
    """sqrt floored at 1e-12: d == 0 happens (coincident points) and sqrt's
    gradient there is inf."""
    return torch.sqrt(torch.clamp_min(d, 1e-12))


def smallest_k_sqrt_mean_fast(d: torch.Tensor, k: int,
                              iters: int = 16) -> torch.Tensor:
    """Mean of √(smallest k of d) along the last axis via a bisected count
    threshold instead of a sort: ``iters`` counting passes find t with
    |{d <= t}| ≈ k, then a masked mean over d <= t. The mask carries no
    gradient, so gradients flow through the kept elements as with top-k."""
    lo = d.amin(-1)
    hi = d.amax(-1)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        below = (d <= mid[..., None]).sum(-1) < k
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid)
    mask = (d <= hi[..., None]).to(d.dtype).detach()
    count = torch.clamp_min(mask.sum(-1), 1.0)
    return (_safe_sqrt(d) * mask).sum(-1) / count


def calc_cd(output: torch.Tensor, gt: torch.Tensor, calc_f1: bool = False):
    """cd_p = (mean √d1 + mean √d2) / 2, cd_t = mean d1 + mean d2, per cloud;
    d1 per gt point, d2 per output point. Returns (cd_p, cd_t[, f1])."""
    d1, d2, _, _ = chamfer(gt, output)
    cd_p = (_safe_sqrt(d1).mean(-1) + _safe_sqrt(d2).mean(-1)) / 2.0
    cd_t = d1.mean(-1) + d2.mean(-1)
    if calc_f1:
        return cd_p, cd_t, fscore(d1, d2)[0]
    return cd_p, cd_t


def calc_cd_percent(output: torch.Tensor, gt: torch.Tensor,
                    percent: float = 1.0, fast: bool = False):
    """Truncated one-sided CDs: only the smallest ``percent`` fraction of
    the per-point distances counts on each side. Returns (cd_p, cd_t) with
    cd_p = mean √(smallest k of d1), cd_t = mean √(smallest k of d2);
    k = int(N_out · percent) on both sides. ``fast`` takes the bisected
    threshold mean instead of the exact top-k."""
    k = int(output.shape[-2] * percent)
    d1, d2, _, _ = chamfer(gt, output)

    def mean_sqrt(d):
        if k >= d.shape[-1]:
            return _safe_sqrt(d).mean(-1)
        if fast:
            return smallest_k_sqrt_mean_fast(d, k)
        return _safe_sqrt(_smallest_k(d, k)).mean(-1)

    return mean_sqrt(d1), mean_sqrt(d2)


def calc_cd_percent_aligned(output: torch.Tensor, gt: torch.Tensor,
                            percent: float = 1.0):
    """Truncated CD that also returns the matches and which points were
    kept: (cd_p, cd_t, i1, i2, kept1, kept2), kept in ascending distance,
    ties to the smaller index."""
    k = int(output.shape[-2] * percent)
    d1, d2, i1, i2 = chamfer(gt, output)
    d1k, kept1 = (t[..., :k] for t in torch.sort(d1, dim=-1, stable=True))
    d2k, kept2 = (t[..., :k] for t in torch.sort(d2, dim=-1, stable=True))
    return (_safe_sqrt(d1k).mean(-1), _safe_sqrt(d2k).mean(-1), i1, i2,
            kept1, kept2)


def calc_cd_percent_len(output: torch.Tensor, gt: torch.Tensor,
                        mask_output: torch.Tensor | None = None,
                        mask_gt: torch.Tensor | None = None,
                        calc_f1: bool = False):
    """``calc_cd`` with per-cloud validity masks, mask_output (B, N) and
    mask_gt (B, M), 1 = valid: invalid points add nothing and the means
    count the valid ones."""
    d1, d2, _, _ = chamfer(gt, output)

    def means(d, mask):
        if mask is None:
            return _safe_sqrt(d).mean(-1), d.mean(-1)
        w = mask.to(d.dtype)
        count = torch.clamp_min(w.sum(-1), 1.0)
        return (_safe_sqrt(d) * w).sum(-1) / count, (d * w).sum(-1) / count

    s1, t1 = means(d1, mask_gt)
    s2, t2 = means(d2, mask_output)
    cd_p = (s1 + s2) / 2.0
    cd_t = t1 + t2
    if calc_f1:
        return cd_p, cd_t, fscore(d1, d2)[0]
    return cd_p, cd_t


def loss_view(src: torch.Tensor, tgt: torch.Tensor, dim: int = 0,
              percent: float = 1.0):
    """``calc_cd_percent`` of both clouds projected onto the plane
    orthogonal to axis ``dim`` (that coordinate zeroed)."""
    mask = torch.ones(3, dtype=src.dtype, device=src.device)
    mask[dim] = 0.0
    return calc_cd_percent(src * mask, tgt * mask, percent)


def fscore(d1: torch.Tensor, d2: torch.Tensor, threshold: float = 1e-4):
    """F1, precision and recall from squared distances at ``threshold``
    (0 where both are 0)."""
    p1 = (d1 < threshold).to(d1.dtype).mean(-1)
    p2 = (d2 < threshold).to(d2.dtype).mean(-1)
    denom = p1 + p2
    f1 = torch.where(denom > 0,
                     2.0 * p1 * p2 / torch.clamp_min(denom, 1e-30),
                     torch.zeros_like(denom))
    return f1, p1, p2
