"""Instance embeddings and the transformer point regressors (counterpart
of ``houv_tpu/models/embedding.py``): ``InstanceEmbedding`` and
``triplet_loss`` (the ``model_embedding`` model), ``TransformerRegressor``
and ``TransformerCompletion`` (the ``transformer`` completion model) and
``PCNTransformer``.

``InstanceEmbedding`` lifts each point with a per-point MLP (optionally
adding multi-head self-attention), max-pools a global feature and returns
its L2-normalised embedding (the norm floored at 1e-9) and class logits;
trained on triplets of partial scans (``train/aux.py``), its distances
drive the MVPN clustering.

In the transformer regressor a per-point MLP lifts the partial cloud to ``d_model`` features; FPS (K2,
``ops/sampling.py``) picks ``num_latent`` of them as latent points, which
pass ``n_layers`` pre-norm blocks of self-attention, cross-attention to
every point's features and a feed-forward layer. Each latent point is then
repeated ``ratio`` times, tagged with a 1-D offset in [-0.05, 0.05], and an
MLP regresses the output coordinates. The train loss is cd_p + 0.02 · cd_t
on K1 (its backward on K4); validation gives cd_p, cd_t, f1 (and EMD with
``eval_emd``, on K7).

``compute_dtype`` bf16 is the JAX models': in ``InstanceEmbedding`` the
point MLP, the attention and the hidden Dense layers run in bf16 while the
embedding and logits heads stay f32; in the transformer the point MLP, the
LayerNorms, the attention, the feed-forward and the head run in bf16, each
block's residual is added in f32 and the coordinates come back in f32.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from houv_tpu_torch.metrics.cd import calc_cd
from houv_tpu_torch.metrics.emd import calc_emd
from houv_tpu_torch.models.common import (FlaxNamed, LayerNorm,
                                          MultiHeadAttention, PointMLP,
                                          compute_dtype_of, dense,
                                          max_pool_points, to_f32)
from houv_tpu_torch.ops.gather import gather_rows
from houv_tpu_torch.ops.sampling import furthest_point_sample


class InstanceEmbedding(FlaxNamed):
    """(B, N, 3) cloud -> (unit embedding (B, embedding_size), class
    logits (B, nclasses)), both f32."""

    def __init__(self, embedding_size: int = 32, nclasses: int = 16,
                 use_attention: bool = False, compute_dtype=None):
        super().__init__()
        self.use_attention = use_attention
        self.dt = dt = compute_dtype_of(compute_dtype)
        self.child("mlp", PointMLP((64, 128, 256), 3, relu_last=True,
                                   compute_dtype=dt))
        if use_attention:
            self.child("attn", MultiHeadAttention(8, 256, dt))
        self.child("fc", nn.Linear(256, 256))
        self.child("embed", nn.Linear(256, embedding_size))
        # flax constructs the logits' Dense before the hidden one it is
        # applied to, so the logits layer is Dense_2 and the hidden Dense_3
        self.child("logits", nn.Linear(512, nclasses))
        self.child("hidden", nn.Linear(256, 512))

    def forward(self, x: torch.Tensor):
        dt = self.dt
        h = self.mlp(x)
        if self.use_attention:
            h = h + self.attn(h, h, h).to(h.dtype)
        g = torch.relu(dense(self.fc, max_pool_points(h), dt))
        # the embedding head in f32, as the JAX model's
        emb = self.embed(to_f32(g, dt))
        emb = emb / torch.linalg.vector_norm(emb, dim=-1,
                                             keepdim=True).clamp_min(1e-9)
        return emb, self.logits(to_f32(torch.relu(dense(self.hidden, g, dt)),
                                       dt))


def triplet_loss(anchor: torch.Tensor, positive: torch.Tensor,
                 negative: torch.Tensor, margin: float = 0.2) -> torch.Tensor:
    """Mean margin triplet loss on squared embedding distances."""
    d_pos = ((anchor - positive) ** 2).sum(-1)
    d_neg = ((anchor - negative) ** 2).sum(-1)
    return torch.clamp_min(d_pos - d_neg + margin, 0.0).mean()


class TransformerRegressor(FlaxNamed):
    """(B, N, 3) partial cloud -> (B, num_out, 3)."""

    def __init__(self, num_latent: int = 256, num_out: int = 2048,
                 d_model: int = 256, n_heads: int = 4, n_layers: int = 2,
                 compute_dtype=None):
        super().__init__()
        self.num_latent, self.num_out, self.n_layers = (num_latent, num_out,
                                                        n_layers)
        self.dt = dt = compute_dtype_of(compute_dtype)
        self.child("mlp", PointMLP((64, d_model), 3, relu_last=True,
                                   compute_dtype=dt))
        for i in range(n_layers):
            self.child(f"self_norm{i}", LayerNorm(d_model, compute_dtype=dt))
            self.child(f"self_attn{i}", MultiHeadAttention(n_heads, d_model,
                                                           dt))
            self.child(f"cross_norm{i}", LayerNorm(d_model, compute_dtype=dt))
            self.child(f"cross_attn{i}", MultiHeadAttention(n_heads, d_model,
                                                            dt))
            self.child(f"ff_norm{i}", LayerNorm(d_model, compute_dtype=dt))
            # flax names the outer Dense first: it is built before the
            # inner one it is applied to
            self.child(f"ff_out{i}", nn.Linear(2 * d_model, d_model))
            self.child(f"ff_in{i}", nn.Linear(d_model, 2 * d_model))
        self.child("head_out", nn.Linear(128, 3))
        self.child("head_in", nn.Linear(d_model + 1, 128))
        self.ratio = -(-num_out // num_latent)
        grid = np.tile(np.linspace(-0.05, 0.05, self.ratio,
                                   dtype=np.float32), num_latent)[:num_out]
        self.register_buffer("grid", torch.from_numpy(grid[:, None]),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, dt = x.shape[0], self.dt
        feats = self.mlp(x)
        idx = furthest_point_sample(x, self.num_latent, device=x.device)
        latent = gather_rows(feats, idx)
        for i in range(self.n_layers):
            h = getattr(self, f"self_norm{i}")(latent)
            latent = latent + getattr(self, f"self_attn{i}")(
                h, h, h).to(latent.dtype)
            h = getattr(self, f"cross_norm{i}")(latent)
            latent = latent + getattr(self, f"cross_attn{i}")(
                h, feats, feats).to(latent.dtype)
            h = getattr(self, f"ff_norm{i}")(latent)
            latent = latent + dense(getattr(self, f"ff_out{i}"), torch.relu(
                dense(getattr(self, f"ff_in{i}"), h, dt)), dt).to(
                    latent.dtype)
        up = latent.repeat_interleave(self.ratio, 1)[:, :self.num_out]
        grid = self.grid.to(up.dtype).expand(b, -1, -1)
        h = torch.cat([up, grid], -1)
        return to_f32(dense(self.head_out, torch.relu(
            dense(self.head_in, h, dt)), dt), dt)


class TransformerCompletion(FlaxNamed):
    """``TransformerRegressor`` under the completion-model contract:
    x (B, N, 3) -> {'result'} ('test'); with gt, cd_p, cd_t, f1 (and emd)
    per cloud ('val'); or {'out2', 'loss2', 'total_loss'} ('train': mean
    cd_p + 0.02 · mean cd_t). The model draws no random numbers; ``alpha``
    is accepted and not used, as in the JAX model."""

    def __init__(self, num_points: int = 2048, num_latent: int = 256,
                 eval_emd: bool = False, compute_dtype=None):
        super().__init__()
        self.eval_emd = eval_emd
        self.child("regressor", TransformerRegressor(
            num_latent=num_latent, num_out=num_points,
            compute_dtype=compute_dtype))

    def forward(self, x: torch.Tensor, gt: torch.Tensor | None = None,
                prefix: str = "test", alpha: float | None = None) -> dict:
        out = self.regressor(x)
        if prefix == "train":
            cd_p, cd_t = calc_cd(out, gt)
            return {"out2": out, "loss2": cd_t,
                    "total_loss": cd_p.mean() + cd_t.mean() * 0.02}
        if prefix == "val":
            cd_p, cd_t, f1 = calc_cd(out, gt, calc_f1=True)
            res = {"out2": out, "cd_p": cd_p, "cd_t": cd_t, "f1": f1}
            if self.eval_emd:
                res["emd"] = calc_emd(out, gt, eps=0.004, iterations=3000)
            return res
        if prefix != "test":
            raise ValueError(
                f"prefix is 'train', 'val' or 'test', got {prefix!r}")
        return {"result": out}


class PCNTransformer(FlaxNamed):
    """PCN's encoder with an attention refinement head (reference
    registration/models/pcn.py PCN_Transformer :31-52): (B, N, 3) ->
    (B, output_size) global feature, f32 (its layers in ``compute_dtype``,
    as the JAX module's)."""

    def __init__(self, output_size: int = 1024, compute_dtype=None):
        super().__init__()
        self.dt = dt = compute_dtype_of(compute_dtype)
        self.child("fc1", nn.Linear(3, 128))
        self.child("fc2", nn.Linear(128, 256))
        self.child("fc3", nn.Linear(512, 512))
        self.child("attn", MultiHeadAttention(4, 512, dt))
        self.child("out", nn.Linear(512, output_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dt
        h = dense(self.fc2, torch.relu(dense(self.fc1, x, dt)), dt)
        g = max_pool_points(h)
        h = torch.cat([h, g[:, None].expand_as(h)], -1)
        h = torch.relu(dense(self.fc3, h, dt))
        h = h + self.attn(h, h, h).to(h.dtype)
        return to_f32(max_pool_points(dense(self.out, h, dt)), dt)
