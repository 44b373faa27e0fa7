"""Batched Kabsch / weighted-Procrustes rigid alignment via SVD.

Counterpart of ``houv_tpu/geometry/kabsch.py``: one batched
``torch.linalg.svd`` of the 3x3 covariances on the tensors' own device and
the det < 0 reflection fix as a batched column scale, no per-sample branch.
The products run in full f32 as long as
``torch.backends.cuda.matmul.allow_tf32`` stays False, which the solvers
set.
"""

from __future__ import annotations

import torch


def det3(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (...,) determinants by cofactor expansion."""
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2]
                            - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2]
                              - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1]
                              - m[..., 1, 1] * m[..., 2, 0]))


def fix_reflection(u: torch.Tensor, vt: torch.Tensor) -> torch.Tensor:
    """Compose R = V·diag(1, 1, det(V·Uᵀ))·Uᵀ so det(R) = +1, batched."""
    v = vt.transpose(-1, -2)
    ut = u.transpose(-1, -2)
    det = det3(v @ ut)
    ones = torch.ones_like(det)
    d = torch.stack([ones, ones, det], dim=-1)
    return (v * d[..., None, :]) @ ut


def kabsch(src: torch.Tensor, tgt: torch.Tensor):
    """Least-squares rigid transform aligning src -> tgt (equal weights).

    src, tgt: (..., N, 3) corresponding point sets -> (R (..., 3, 3),
    t (..., 3)) with tgt ≈ src @ Rᵀ + t."""
    n = src.shape[-2]
    w = torch.full(src.shape[:-2] + (n,), 1.0 / n, dtype=src.dtype,
                   device=src.device)
    return weighted_kabsch(src, tgt, w)


def weighted_kabsch(src: torch.Tensor, tgt: torch.Tensor,
                    weights: torch.Tensor):
    """Weighted Procrustes: minimise Σ w_i |R·src_i + t - tgt_i|².

    src, tgt: (..., N, 3); weights (..., N), not necessarily normalised
    (their sum is floored at the dtype's ``tiny``) -> (R, t) with
    tgt ≈ src @ Rᵀ + t. The covariance and its SVD run in f32 (in f64 for
    f64 clouds, which the gradient checks use)."""
    w = weights / torch.clamp_min(weights.sum(-1, keepdim=True),
                                  torch.finfo(src.dtype).tiny)
    src_c = (src * w[..., None]).sum(-2, keepdim=True)
    tgt_c = (tgt * w[..., None]).sum(-2, keepdim=True)
    src0 = src - src_c
    tgt0 = tgt - tgt_c
    h = (src0 * w[..., None]).transpose(-1, -2) @ tgt0
    h = h.to(torch.promote_types(h.dtype, torch.float32))
    u, _, vt = torch.linalg.svd(h, full_matrices=False)
    r = fix_reflection(u, vt).to(src.dtype)
    t = tgt_c[..., 0, :] - (r @ src_c[..., 0, :, None])[..., 0]
    return r, t
