"""DCP, Deep Closest Point (counterpart of ``houv_tpu/models/dcp.py``).

A DGCNN embeds each point from its k = 20 nearest neighbours on the
coordinates (K6, ``csrc/knn.cu``, one search per cloud); a pre-norm
transformer (one encoder and one decoder layer, 4 heads, d 512, ff 1024)
decodes each cloud's embedding against the other's; a softmax over the
embeddings' scaled products gives each source point a soft correspondence
in the target, and a Procrustes SVD the transform. The loss is
mean((T12 · T_gt⁻¹ − I)²), with ``cycle`` plus 0.1 of the reverse
direction's consistency; its gradient runs through the SVD. Features last,
as in the JAX package. ``compute_dtype`` bf16 runs the DGCNN (its
BatchNorms included) and the transformer's layers in bf16, as the JAX
model does; the transformer's two final LayerNorms return f32, so the
embeddings reach the soft correspondence and the SVD head in f32.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from houv_tpu_torch.geometry.rotations import rt_to_transformation
from houv_tpu_torch.models.common import (BatchNorm, FlaxNamed, LayerNorm,
                                          MultiHeadAttention,
                                          compute_dtype_of, dense,
                                          get_graph_feature,
                                          registration_outputs, svd_head,
                                          to_f32, transform_mse)


class DGCNN(FlaxNamed):
    """Four graph-conv stages over one kNN graph of the input coordinates
    (edge features [center, neighbour] -> Dense + BatchNorm without bias +
    ReLU, each stage's maximum over the k edges kept), the four maxima
    concatenated and projected to ``emb_dims``: (B, N, 3) -> (B, N,
    emb_dims)."""

    widths = (64, 64, 128, 256)

    def __init__(self, emb_dims: int = 512, k: int = 20, compute_dtype=None):
        super().__init__()
        self.k = k
        self.dt = dt = compute_dtype_of(compute_dtype)
        c = 6
        for i, f in enumerate(self.widths):
            self.child(f"conv{i}", nn.Linear(c, f, bias=False))
            self.child(f"bn{i}", BatchNorm(f, use_bias=False,
                                           compute_dtype=dt))
            c = f
        self.child("proj", nn.Linear(sum(self.widths), emb_dims, bias=False))
        self.child("proj_bn", BatchNorm(emb_dims, use_bias=False,
                                        compute_dtype=dt))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = get_graph_feature(x, self.k, minus_center=False)  # (B, N, k, 6)
        outs = []
        for i in range(len(self.widths)):
            h = torch.relu(getattr(self, f"bn{i}")(
                dense(getattr(self, f"conv{i}"), h, self.dt), train))
            outs.append(h.amax(2))
        return torch.relu(self.proj_bn(
            dense(self.proj, torch.cat(outs, -1), self.dt), train))


class _FFN(FlaxNamed):
    def __init__(self, d_model: int, d_ff: int, dt=None):
        super().__init__()
        self.dt = dt
        self.child("fc1", nn.Linear(d_model, d_ff))
        self.child("fc2", nn.Linear(d_ff, d_model))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(self.fc2, torch.relu(dense(self.fc1, x, self.dt)),
                     self.dt)


class _EncoderLayer(FlaxNamed):
    def __init__(self, d_model: int, d_ff: int, n_heads: int, dt=None):
        super().__init__()
        self.child("attn", MultiHeadAttention(n_heads, d_model, dt))
        self.child("norm1", LayerNorm(d_model, compute_dtype=dt))
        self.child("norm2", LayerNorm(d_model, compute_dtype=dt))
        self.child("ff", _FFN(d_model, d_ff, dt))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm1(x)
        x = x + self.attn(h, h, h)
        return x + self.ff(self.norm2(x))


class _DecoderLayer(FlaxNamed):
    def __init__(self, d_model: int, d_ff: int, n_heads: int, dt=None):
        super().__init__()
        self.child("self_attn", MultiHeadAttention(n_heads, d_model, dt))
        self.child("cross_attn", MultiHeadAttention(n_heads, d_model, dt))
        self.child("norm1", LayerNorm(d_model, compute_dtype=dt))
        self.child("norm2", LayerNorm(d_model, compute_dtype=dt))
        self.child("norm3", LayerNorm(d_model, compute_dtype=dt))
        self.child("ff", _FFN(d_model, d_ff, dt))

    def forward(self, x: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        h = self.norm1(x)
        x = x + self.self_attn(h, h, h)
        x = x + self.cross_attn(self.norm2(x), memory, memory)
        return x + self.ff(self.norm3(x))


class Pointer(FlaxNamed):
    """The DCP transformer: the target decoded against the encoded source
    and the source against the encoded target; returns the residual
    embeddings (src_p, tgt_p), f32 (the final LayerNorms have no compute
    dtype, as in the JAX module)."""

    def __init__(self, d_model: int = 512, d_ff: int = 1024,
                 n_heads: int = 4, n_layers: int = 1, compute_dtype=None):
        super().__init__()
        self.n_layers = n_layers
        dt = compute_dtype_of(compute_dtype)
        for i in range(n_layers):
            self.child(f"enc{i}", _EncoderLayer(d_model, d_ff, n_heads, dt))
        for i in range(n_layers):
            self.child(f"dec{i}", _DecoderLayer(d_model, d_ff, n_heads, dt))
        self.child("enc_norm", LayerNorm(d_model))
        self.child("dec_norm", LayerNorm(d_model))

    def _encode(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"enc{i}")(x)
        return self.enc_norm(x)

    def _decode(self, x: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"dec{i}")(x, memory)
        return self.dec_norm(x)

    def forward(self, src_emb: torch.Tensor, tgt_emb: torch.Tensor):
        tgt_p = self._decode(tgt_emb, self._encode(src_emb))
        src_p = self._decode(src_emb, self._encode(tgt_emb))
        return src_p, tgt_p


def dcp_svd_head(src_emb: torch.Tensor, tgt_emb: torch.Tensor,
                 src: torch.Tensor, tgt: torch.Tensor):
    """Soft correspondence and Procrustes: embeddings (B, N, D), clouds
    (B, N, 3) -> (R, t) aligning src to its soft matches in tgt."""
    scores = torch.matmul(src_emb, tgt_emb.transpose(-1, -2)) / math.sqrt(
        src_emb.shape[-1])
    src_corr = torch.matmul(torch.softmax(scores, -1), tgt)
    return svd_head(src, src_corr)


class DCP(FlaxNamed):
    """src, tgt (B, N, 3) -> the (B, 4, 4) transform aligning src to tgt;
    with ``t_gt`` the outputs of ``registration_outputs``. ``train`` runs
    the BatchNorms on the batch (moving their running statistics, once for
    each cloud). The model draws no random numbers."""

    def __init__(self, emb_dims: int = 512, cycle: bool = False,
                 compute_dtype=None):
        super().__init__()
        self.cycle = cycle
        self.dt = compute_dtype_of(compute_dtype)
        self.child("emb_nn", DGCNN(emb_dims, compute_dtype=self.dt))
        self.child("pointer", Pointer(emb_dims, compute_dtype=self.dt))

    def forward(self, src: torch.Tensor, tgt: torch.Tensor,
                t_gt: torch.Tensor | None = None, prefix: str = "train",
                train: bool = False):
        src_emb = self.emb_nn(src, train)
        tgt_emb = self.emb_nn(tgt, train)
        src_p, tgt_p = self.pointer(src_emb, tgt_emb)
        src_emb = to_f32(src_emb + src_p, self.dt)
        tgt_emb = to_f32(tgt_emb + tgt_p, self.dt)
        r_ab, t_ab = dcp_svd_head(src_emb, tgt_emb, src, tgt)
        t_12 = rt_to_transformation(r_ab, t_ab)
        if t_gt is None:
            return t_12
        mse = transform_mse(t_12, t_gt)
        if self.cycle:
            # R_ba·R_ab = I and R_ba·t_ab = -t_ba, as the JAX model adds
            r_ba, t_ba = dcp_svd_head(tgt_emb, src_emb, tgt, src)
            eye3 = torch.eye(3, dtype=r_ab.dtype, device=r_ab.device)
            rot_cycle = ((r_ba @ r_ab - eye3) ** 2).mean()
            tr_cycle = (((r_ba @ t_ab[..., None])[..., 0] + t_ba) ** 2).mean()
            mse = mse + 0.1 * (rot_cycle + tr_cycle)
        return registration_outputs(mse, src, t_12, t_12[:, :3, :3],
                                    t_12[:, :3, 3], t_gt)
