"""DeepGMR, registration by Gaussian-mixture alignment (counterpart of
``houv_tpu/models/deepgmr.py``).

Each point gets rotation-invariant features from its ``rri_size`` nearest
neighbours (``get_rri``: K6, ``csrc/knn.cu``, at k rri_size + 1, the point
itself dropped) or, without ``use_rri``, its centred coordinates; a
PointNet with BatchNorm turns them into soft assignments to ``num_groups``
mixture components; the closed-form mixture parameters of both clouds
(``gmm_params``) are aligned by a weighted Procrustes SVD
(``gmm_register``). The loss is the forward and backward transforms'
mean((T · T_gt^∓1 − I)²). The RRI features, the mixtures and the SVD run
in the input's dtype (f32), whatever the backbone runs in: with
``compute_dtype`` bf16 only the backbone's PointNets (their BatchNorms
included) run in bf16, and they return f32, as in the JAX model.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from houv_tpu_torch.geometry.kabsch import fix_reflection
from houv_tpu_torch.geometry.rotations import rt_to_transformation
from houv_tpu_torch.models.common import (FlaxNamed, PointMLP,
                                          max_pool_points,
                                          registration_outputs,
                                          transform_mse)
from houv_tpu_torch.ops.gather import gather_edge_features
from houv_tpu_torch.ops.grouping import knn_indices


def get_rri(pts: torch.Tensor, k: int) -> torch.Tensor:
    """Rotation-invariant features per point: for each point p and each of
    its k nearest neighbours q_i (itself excluded), [|p|, |q_i|, the angle
    between them, φ_i], φ_i the smallest positive angle, about p, from q_i's
    projection on p's tangent plane to another neighbour's (the angle to
    itself forced to 0 before the sort). (B, N, 3) -> (B, N, 4k)."""
    b, n, _ = pts.shape
    idx = knn_indices(pts, pts, k + 1, device=pts.device)[..., 1:]
    q = gather_edge_features(pts, idx)                      # (B, N, k, 3)
    p = pts[:, :, None, :].expand_as(q)
    rp = torch.linalg.norm(p, dim=-1, keepdim=True)
    rq = torch.linalg.norm(q, dim=-1, keepdim=True)
    pn = p / torch.clamp_min(rp, 1e-9)
    qn = q / torch.clamp_min(rq, 1e-9)
    dot = (pn * qn).sum(-1, keepdim=True)
    theta = torch.arccos(torch.clamp(dot, -1.0, 1.0))
    t_q = q - dot * p
    a, c = t_q[:, :, None, :, :], t_q[:, :, :, None, :]     # [i, j]: j, i
    cross = torch.linalg.cross(*torch.broadcast_tensors(a, c), dim=-1)
    sin_psi = (cross * pn[:, :, None, :, :]).sum(-1)        # (B, N, k, k)
    cos_psi = (a * c).sum(-1)
    psi = torch.remainder(torch.atan2(sin_psi, cos_psi), 2 * math.pi)
    eye = torch.eye(k, dtype=torch.bool, device=pts.device)
    psi = torch.where(eye, torch.zeros((), dtype=psi.dtype,
                                       device=psi.device), psi)
    phi = torch.sort(psi, -1).values[..., 1:2]
    return torch.cat([rp, rq, theta, phi], -1).reshape(b, n, 4 * k)


def gmm_params(gamma: torch.Tensor, pts: torch.Tensor):
    """Soft assignments gamma (B, N, J) and points (B, N, 3) -> the mixture
    (pi (B, J), mu (B, J, 3), sigma (B, J, 3, 3)), isotropic covariances."""
    pi = gamma.mean(1)
    npi = pi * gamma.shape[1]
    mu = torch.einsum("bnj,bnc->bjc", gamma, pts) / torch.clamp_min(
        npi[..., None], 1e-9)
    diff = pts[:, :, None, :] - mu[:, None, :, :]            # (B, N, J, 3)
    var = torch.einsum("bnjc,bnjc,bnj->bj", diff, diff, gamma) \
        / torch.clamp_min(npi, 1e-9)
    eye = torch.eye(3, dtype=pts.dtype, device=pts.device)
    return pi, mu, var[..., None, None] * eye


def gmm_register(pi_s: torch.Tensor, mu_s: torch.Tensor, mu_t: torch.Tensor,
                 sigma_t: torch.Tensor) -> torch.Tensor:
    """Weighted Procrustes between mixtures: the (B, 4, 4) transform moving
    the source mixture's means onto the target's, each component weighted
    by its share pi_s and the target's inverse covariance. The SVD runs in
    f32 (in f64 for f64 mixtures)."""
    c_s = torch.einsum("bj,bjc->bc", pi_s, mu_s)[:, None]
    c_t = torch.einsum("bj,bjc->bc", pi_s, mu_t)[:, None]
    sigma_inv = torch.linalg.inv(sigma_t)
    ms = torch.einsum("bj,bjc,bjd,bjde->bce", pi_s, mu_s - c_s, mu_t - c_t,
                      sigma_inv)
    u, _, vt = torch.linalg.svd(ms.to(torch.promote_types(ms.dtype,
                                                          torch.float32)))
    r = fix_reflection(u, vt).to(mu_s.dtype)
    t = c_t[:, 0] - (r @ c_s[:, 0, :, None])[..., 0]
    return rt_to_transformation(r, t)


class GMRBackbone(FlaxNamed):
    """PointNet encoder (64, 128, 256, 1024) and decoder (512, 256, 128)
    with BatchNorm, the encoder's global maximum beside every point, then
    per-point logits over ``num_groups`` components."""

    def __init__(self, in_features: int, num_groups: int = 16,
                 use_bn: bool = True, compute_dtype=None):
        super().__init__()
        self.child("enc", PointMLP((64, 128, 256, 1024), in_features,
                                   relu_last=True, use_bn=use_bn,
                                   compute_dtype=compute_dtype))
        self.child("dec", PointMLP((512, 256, 128), 2048, relu_last=True,
                                   use_bn=use_bn,
                                   compute_dtype=compute_dtype))
        self.child("head", nn.Linear(128, num_groups))

    def forward(self, feats: torch.Tensor, train: bool = False):
        f_loc = self.enc(feats, train)
        f_glob = max_pool_points(f_loc)
        h = torch.cat([f_loc, f_glob[:, None].expand_as(f_loc)], -1)
        return self.head(self.dec(h, train))


class DeepGMR(FlaxNamed):
    """src, tgt (B, N, 3) -> the (B, 4, 4) transform aligning src to tgt
    ('test' without ``t_gt``); with ``t_gt`` the outputs of
    ``registration_outputs``. ``train`` runs the BatchNorms on the batch
    (the backbone is shared: their running statistics move once for each
    cloud). The model draws no random numbers."""

    def __init__(self, num_groups: int = 16, use_rri: bool = True,
                 rri_size: int = 20, compute_dtype=None):
        super().__init__()
        self.use_rri, self.rri_size = use_rri, rri_size
        in_features = 4 * rri_size if use_rri else 3
        self.child("backbone", GMRBackbone(in_features, num_groups,
                                           compute_dtype=compute_dtype))

    def _features(self, pts: torch.Tensor) -> torch.Tensor:
        if self.use_rri:
            return get_rri(pts, self.rri_size)
        return pts - pts.mean(1, keepdim=True)

    def forward(self, src: torch.Tensor, tgt: torch.Tensor,
                t_gt: torch.Tensor | None = None, prefix: str = "train",
                train: bool = False):
        gamma1 = torch.softmax(self.backbone(self._features(src), train), -1)
        gamma2 = torch.softmax(self.backbone(self._features(tgt), train), -1)
        pi1, mu1, sigma1 = gmm_params(gamma1, src)
        pi2, mu2, sigma2 = gmm_params(gamma2, tgt)
        t_12 = gmm_register(pi1, mu1, mu2, sigma2)
        if t_gt is None:
            return t_12
        t_21 = gmm_register(pi2, mu2, mu1, sigma1)
        eye = torch.eye(4, dtype=t_12.dtype, device=t_12.device)
        loss = transform_mse(t_12, t_gt) + ((t_21 @ t_gt - eye) ** 2).mean()
        return registration_outputs(loss, src, t_12, t_12[:, :3, :3],
                                    t_12[:, :3, 3], t_gt)
