"""Chamfer metrics (counterpart of ``houv_tpu/metrics/cd.py``): the
completion metrics ``calc_cd`` and ``fscore``, and the solver's truncated
means.

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
