"""Rigid-transform math on batched f32 tensors.

Counterpart of ``houv_tpu/geometry/rotations.py`` (the parts the HOUV sweep
uses). The JAX package runs these matmuls at ``Precision.HIGHEST``; here
they run in full f32 as long as ``torch.backends.cuda.matmul.allow_tf32``
stays False, which the solver sets.
"""

from __future__ import annotations

import math

import torch


def _skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) vectors -> (..., 3, 3) cross-product matrices."""
    zeros = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([zeros, -v[..., 2], v[..., 1]], dim=-1),
            torch.stack([v[..., 2], zeros, -v[..., 0]], dim=-1),
            torch.stack([-v[..., 1], v[..., 0], zeros], dim=-1),
        ],
        dim=-2,
    )


def rodrigues(angle: torch.Tensor, axis: torch.Tensor,
              eps: float = 1e-12) -> torch.Tensor:
    """R = I + sin(a)·A + (1-cos(a))·A², A = skew(axis/|axis|).

    angle (...,) or (..., 1) radians; axis (..., 3), any norm > 0."""
    if angle.dim() == axis.dim():
        angle = angle[..., 0]
    norm = torch.sqrt((axis * axis).sum(-1, keepdim=True) + eps)
    a = _skew(axis / norm)
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device)
    sin = torch.sin(angle)[..., None, None]
    cos1 = (1.0 - torch.cos(angle))[..., None, None]
    return eye + sin * a + cos1 * (a @ a)


def rotation_xyz(angles_xyz: torch.Tensor) -> torch.Tensor:
    """R = Rx(ax) @ Ry(ay) @ Rz(az) from (..., 3) Euler-style angles, each
    factor a ``rodrigues`` about its unit axis."""
    eye = torch.eye(3, dtype=angles_xyz.dtype, device=angles_xyz.device)
    rx, ry, rz = (rodrigues(angles_xyz[..., i],
                            eye[i].expand(angles_xyz.shape))
                  for i in range(3))
    return (rx @ ry) @ rz


def rt_to_transformation(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) + (..., 3) or (..., 3, 1) -> (..., 4, 4)."""
    if t.shape[-1] != 1:
        t = t[..., None]
    top = torch.cat([r, t], dim=-1)
    bot = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=r.dtype, device=r.device)
    bot = bot.expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bot], dim=-2)


def rotation_error(r: torch.Tensor, r_gt: torch.Tensor) -> torch.Tensor:
    """Angle in degrees between batched rotations, from trace(R·R_gtᵀ)."""
    cos_theta = ((r * r_gt).sum((-2, -1)) - 1.0) / 2.0
    return torch.arccos(cos_theta.clamp(-1.0, 1.0)) * (180.0 / math.pi)


def translation_error(t: torch.Tensor, t_gt: torch.Tensor) -> torch.Tensor:
    """L2 norm of the translation difference."""
    return torch.linalg.norm(t - t_gt, dim=-1)


def rmse_loss(pts: torch.Tensor, t: torch.Tensor,
              t_gt: torch.Tensor) -> torch.Tensor:
    """Mean per-point distance between clouds moved by T and by T_gt."""
    pred = pts @ t[..., :3, :3].transpose(-1, -2) + t[..., None, :3, 3]
    gt = pts @ t_gt[..., :3, :3].transpose(-1, -2) + t_gt[..., None, :3, 3]
    return torch.linalg.norm(pred - gt, dim=-1).mean(-1)


def rotation_geodesic_error(m1: torch.Tensor, m2: torch.Tensor) -> torch.Tensor:
    """Geodesic angle in radians between rotations."""
    m = m1 @ m2.transpose(-1, -2)
    cos = (m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2] - 1.0) / 2.0
    return torch.arccos(cos.clamp(-1.0, 1.0))


def normalize_translation(tran: torch.Tensor, scale: torch.Tensor,
                          eps: float = 1e-12) -> torch.Tensor:
    """Unit-normalize a direction and scale it (scale may be negative)."""
    norm = torch.sqrt((tran * tran).sum(-1, keepdim=True) + eps)
    return tran / norm * scale
