"""IDAM, Iterative Distance-Aware similarity Matrix registration
(counterpart of ``houv_tpu/models/idam.py``).

A GNN embeds each point over one kNN(12) graph of its cloud (K6,
``csrc/knn.cu``); a per-point significance score keeps N // 6 points of
each cloud: at train half of them drawn among the source points whose
ground-truth match lies within 0.05 and half among the others (Gumbel
top-k, without replacement, from an explicit ``torch.Generator``), each
paired with its nearest target point; otherwise the top-scored points of
each cloud. Three iterations then build the (B, m, m) similarity of every
kept pair from both embeddings, their distance and direction
(``_ConvBlock`` stacks over (B, m, m, 2·emb + 4)), take each source
point's best match, weight the matches by a learned score gated at its
median and solve a weighted Procrustes SVD with its gradient stopped,
moving the source. At train the loss sums the significance scores'
regression onto the similarity's negative entropy (first iteration), the
matching cross-entropy and the weights' logistic loss.

Top-k picks go through a stable sort (the lower index first on ties, as
``lax.top_k``), the train-time nearest neighbour is a dense diff-form
argmin (the first index on ties) and the median of an even count is the
mean of the two middle values, as ``jnp.median``'s.

``compute_dtype`` bf16 runs every ``_ConvBlock`` (the GNN's, the
significance score's and the similarity stacks', their BatchNorms
included) in bf16 and returns its result in f32, as the JAX model does:
the selection, the matching, the weights and the SVD stay f32.
"""

from __future__ import annotations

import torch
from torch import nn

from houv_tpu_torch.geometry.rotations import rt_to_transformation
from houv_tpu_torch.models.common import (BatchNorm, FlaxNamed, batch_sum,
                                          compute_dtype_of, dense, draw_rows,
                                          registration_outputs, svd_head,
                                          to_f32)
from houv_tpu_torch.ops.gather import gather_edge_features
from houv_tpu_torch.ops.grouping import _sqdist_diff, knn_indices


class _ConvBlock(FlaxNamed):
    """Dense (no bias) + BatchNorm + ReLU for each of ``channels`` but the
    last, then a plain Dense to the last; in ``dt`` (None: as the input
    is), the result in f32."""

    def __init__(self, channels, in_features: int, dt=None):
        super().__init__()
        self.n, self.dt = len(channels) - 1, dt
        for i, f in enumerate(channels[:-1]):
            self.child(f"fc{i}", nn.Linear(in_features, f, bias=False))
            self.child(f"bn{i}", BatchNorm(f, compute_dtype=dt))
            in_features = f
        self.child("out", nn.Linear(in_features, channels[-1]))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for i in range(self.n):
            x = torch.relu(getattr(self, f"bn{i}")(
                dense(getattr(self, f"fc{i}"), x, self.dt), train))
        return to_f32(dense(self.out, x, self.dt), self.dt)


class Propagate(FlaxNamed):
    """x (B, N, C) and the graph idx (B, N, k) -> (B, N, emb_dims): each
    edge's feature difference through a two-layer block, the maximum over
    the edges, then one Dense."""

    def __init__(self, in_features: int, emb_dims: int, dt=None):
        super().__init__()
        self.child("edge", _ConvBlock((emb_dims, emb_dims), in_features, dt))
        self.child("node", _ConvBlock((emb_dims,), emb_dims, dt))

    def forward(self, x: torch.Tensor, idx: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        h = gather_edge_features(x, idx) - x[:, :, None, :]
        return self.node(self.edge(h, train).amax(2), train)


class GNN(FlaxNamed):
    """Four Propagate layers of width 64 and one of ``emb_dims`` over the
    kNN(12) graph of the points."""

    def __init__(self, emb_dims: int = 64, dt=None):
        super().__init__()
        widths = (3, 64, 64, 64, 64)
        for i, c in enumerate(widths):
            self.child(f"prop{i}", Propagate(c, 64 if i < 4 else emb_dims,
                                             dt))

    def forward(self, pts: torch.Tensor, train: bool = False):
        idx = knn_indices(pts, pts, 12, device=pts.device)
        x = pts
        for i in range(5):
            x = getattr(self, f"prop{i}")(x, idx, train)
        return x


def _top_k(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest scores per row, descending, the lower
    index first on ties (``lax.top_k``)."""
    return torch.sort(score, dim=1, descending=True, stable=True).indices[
        :, :k]


def _gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise, −log(−log(U)), U uniform in [tiny, 1)."""
    u = draw_rows(torch.rand, shape, generator)
    u = torch.clamp_min(u, torch.finfo(u.dtype).tiny)
    return (-torch.log(-torch.log(u))).to(device)


def _gumbel_choice(logp: torch.Tensor, k: int,
                   noise: torch.Tensor) -> torch.Tensor:
    """k indices per row without replacement, drawn ∝ exp(logp) by the
    Gumbel-top-k trick on ``noise`` (standard Gumbel, logp's shape)."""
    return _top_k(logp + noise, k)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, ...) × (B, M) -> (B, M, ...)."""
    shape = idx.shape + (1,) * (x.dim() - 2)
    return torch.gather(x, 1, idx.reshape(shape).expand(
        idx.shape + x.shape[2:]))


def _median(w: torch.Tensor) -> torch.Tensor:
    """The median over the last axis, kept: the mean of the two middle
    values of an even count (``jnp.median``)."""
    s = torch.sort(w, -1).values
    m = w.shape[-1]
    return ((s[..., (m - 1) // 2] + s[..., m // 2]) * 0.5)[..., None]


class IDAM(FlaxNamed):
    """src, tgt (B, N, 3) -> the (B, 4, 4) transform aligning src to tgt;
    with ``t_gt`` the outputs of ``registration_outputs``. ``prefix``
    'train' samples the kept points from the ground truth and adds the
    losses: its Gumbel noise comes from ``gumbel`` (a pair of (B, N)
    tensors, for the positives and the negatives) or is drawn from
    ``generator``. ``train`` runs the BatchNorms on the batch: the GNN's
    and ``sig_fc``'s run on each cloud, so their running statistics move
    twice a call, the similarity blocks' once. The match loss's ratio of
    sums runs over the global batch where a ``batch_group`` is set
    (``common.set_batch_group``)."""

    batch_group = None

    def __init__(self, descriptor_size: int = 64, num_iters: int = 3,
                 compute_dtype=None):
        super().__init__()
        self.emb, self.num_iters = descriptor_size, num_iters
        e, dt = descriptor_size, compute_dtype_of(compute_dtype)
        self.child("emb_nn", GNN(e, dt))
        self.child("sig_fc", _ConvBlock((64, 32, 1), e, dt))
        for i in range(num_iters):
            self.child(f"sim1_{i}", _ConvBlock((32, 32), 2 * e + 4, dt))
        for i in range(num_iters):
            self.child(f"sim2_{i}", _ConvBlock((32, 1), 32, dt))
        for i in range(num_iters):
            self.child(f"weight_fc{i}", _ConvBlock((32, 1), 32, dt))

    def _sample(self, src, tgt, t_gt, num_keep, gumbel, generator):
        """The kept source points' indices, their ground-truth nearest
        target points' and their match labels (within 0.05)."""
        with torch.no_grad():
            r_gt, tr_gt = t_gt[:, :3, :3], t_gt[:, :3, 3]
            src_gt = src @ r_gt.transpose(-1, -2) + tr_gt[:, None]
            d2 = _sqdist_diff(src_gt, tgt)
            min_idx = torch.argmin(d2, -1)
            min_d2 = torch.gather(d2, -1, min_idx[..., None])[..., 0]
            labels = (torch.sqrt(min_d2) < 0.05).to(src.dtype)
            pos_logp = torch.log(labels + 1e-5)
            neg_logp = torch.log(1.0 + 1e-5 * 2 - labels)
            if gumbel is None:
                gumbel = tuple(_gumbel(labels.shape, generator, src.device)
                               .to(src.dtype) for _ in range(2))
            pos = _gumbel_choice(pos_logp, num_keep // 2, gumbel[0])
            neg = _gumbel_choice(neg_logp, num_keep - num_keep // 2,
                                 gumbel[1])
            src_idx = torch.cat([pos, neg], 1)
            return (src_idx, torch.gather(min_idx, 1, src_idx),
                    torch.gather(labels, 1, src_idx))

    def forward(self, src: torch.Tensor, tgt: torch.Tensor,
                t_gt: torch.Tensor | None = None, prefix: str = "train",
                train: bool = False, generator: torch.Generator | None = None,
                gumbel: tuple | None = None):
        b, n, _ = src.shape
        src_full = src
        src_emb = self.emb_nn(src, train)
        tgt_emb = self.emb_nn(tgt, train)
        src_sig = self.sig_fc(src_emb, train)[..., 0]
        tgt_sig = self.sig_fc(tgt_emb, train)[..., 0]
        num_keep = n // 6
        training = prefix == "train"
        if training:
            src_idx, tgt_idx, labels = self._sample(
                src, tgt, t_gt, num_keep, gumbel, generator)
        else:
            src_idx = _top_k(src_sig, num_keep)
            tgt_idx = _top_k(tgt_sig, num_keep)
        src, src_emb = _take(src, src_idx), _take(src_emb, src_idx)
        src_sig = torch.gather(src_sig, 1, src_idx)
        tgt, tgt_emb = _take(tgt, tgt_idx), _take(tgt_emb, tgt_idx)
        tgt_sig = torch.gather(tgt_sig, 1, tgt_idx)

        m, e = src.shape[1], self.emb
        r = torch.eye(3, dtype=src.dtype, device=src.device).expand(b, 3, 3)
        t = torch.zeros((b, 3), dtype=src.dtype, device=src.device)
        loss = torch.zeros((), dtype=src.dtype, device=src.device)
        arange = torch.arange(m, device=src.device)
        for i in range(self.num_iters):
            pair = torch.cat([src_emb[:, :, None, :].expand(b, m, m, e),
                              tgt_emb[:, None, :, :].expand(b, m, m, e)], -1)
            diff = src[:, :, None, :] - tgt[:, None, :, :]
            dist = torch.sqrt(torch.clamp_min(
                (diff * diff).sum(-1, keepdim=True), 1e-12))
            sim = torch.cat([pair, dist, diff / (dist + 1e-8)], -1)
            sim = getattr(self, f"sim1_{i}")(sim, train)     # (B, m, m, 32)
            weights = getattr(self, f"weight_fc{i}")(sim.amax(2),
                                                     train)[..., 0]
            sim = torch.clamp(getattr(self, f"sim2_{i}")(sim, train)[..., 0],
                              -20.0, 20.0)
            if training and i == 0:
                p_src = torch.softmax(sim, -1)
                src_ne = (p_src * torch.log(p_src + 1e-12)).sum(-1)
                p_tgt = torch.softmax(sim, -2)
                tgt_ne = (p_tgt * torch.log(p_tgt + 1e-12)).sum(-2)
                loss = loss + ((src_sig - src_ne.detach()) ** 2).mean() \
                    + ((tgt_sig - tgt_ne.detach()) ** 2).mean()
            if training:
                diag = torch.diagonal(torch.softmax(sim, -1), dim1=-2,
                                      dim2=-1)
                g = self.batch_group
                loss = loss + batch_sum(-torch.log(diag + 1e-12) * labels, g) \
                    / torch.clamp_min(batch_sum(labels, g), 1.0)
            corr_idx = torch.argmax(sim, -1)
            src_corr = _take(tgt, corr_idx)
            if training:
                w_labels = (corr_idx == arange).to(weights.dtype)
                loss = loss + (torch.relu(weights) - weights * w_labels
                               + torch.log1p(torch.exp(-weights.abs()))
                               ).mean()
            w = torch.sigmoid(weights)
            w = w * (w >= _median(w)).to(w.dtype)
            w = w / (w.sum(-1, keepdim=True) + 1e-8)
            r_ab, t_ab = svd_head(src, src_corr, w, stop_grad=True)
            r_ab, t_ab = r_ab.detach(), t_ab.detach()
            src = src @ r_ab.transpose(-1, -2) + t_ab[:, None]
            r = r_ab @ r
            t = (r_ab @ t[..., None])[..., 0] + t_ab
        transform = rt_to_transformation(r, t)
        if t_gt is None:
            return transform
        return registration_outputs(loss, src_full, transform, r, t, t_gt)
