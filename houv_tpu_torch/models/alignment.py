"""The alignment-quality classifier and the voxel-occupancy net
(counterpart of ``houv_tpu/models/alignment.py``): ``AlignmentClassifier``
(``alignment_spconv``) with its training pairs (``make_aligned_pairs``)
and loss (``alignment_bce_loss``), and ``VoxAsym`` (``voxel_asym``).

It scores whether a candidate transform aligns a pair: the source moved by
the candidate and the target are voxelized jointly on one grid over
[-1, 1]³, each point's feature its position and a one-hot tag of its cloud;
a sparse-conv trunk (a context block, two strided residual blocks) is
max-pooled over the valid voxels to a logit. ``n_extra`` scalar side inputs
(the rescorer's CD-loss gap) add a third ``Dense``. In bf16 mode the convs
round their operands to bf16 and multiply in f32, as the JAX rescorer's
bf16 build does. With ``train`` its context block's BatchNorms normalise
by the batch's statistics and move the running ones.

``VoxAsym`` (reference completion/models/vox_asym.py) lifts each point
with a per-point MLP, averages the features of each occupied voxel of the
given indices, runs one context block and a ``Dense`` to two class logits
(softmaxed: is the voxel occupied in the complete cloud) and a position
per voxel.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from houv_tpu_torch.data.mvp import random_pose_np
from houv_tpu_torch.models.common import FlaxNamed, PointMLP
from houv_tpu_torch.models.voxelnet import ResBlock, ResContextBlock
from houv_tpu_torch.ops.sparse_conv import (
    build_lookup,
    from_point_voxels,
    masked_max,
)
from houv_tpu_torch.ops.voxel import voxel_grid_indices


def make_aligned_pairs(rng: np.random.Generator, transform: np.ndarray):
    """(true, false) candidate transforms for a ground-truth ``transform``
    (reference getTransform): the true one perturbed by at most 5° and
    1e-3, the false one rotated by 5° to 180°; the true one drawn first."""
    pose_t = random_pose_np(rng, np.pi / 36, 0.001)
    pose_f = random_pose_np(rng, np.pi, 0.001, min_angle=np.pi / 36)
    return pose_t @ transform, pose_f @ transform


def alignment_bce_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy on logits, in its stable form."""
    return (torch.clamp_min(logits, 0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs()))).mean()


class AlignmentClassifier(FlaxNamed):
    """Binary alignment logit for (src moved by a candidate, tgt).

    ``sites_dropped`` holds, after a call, the most sites either strided
    conv found beyond its list's capacity in any overlay (a (,) tensor;
    0 when every site fit)."""

    def __init__(self, grid_size: int = 50, init_size: int = 32,
                 compute_dtype: str | None = None, n_extra: int = 0):
        super().__init__()
        self.grid_size = grid_size
        self.n_extra = n_extra
        c, dt = init_size, compute_dtype
        self.child("context", ResContextBlock(5, c, dt))
        self.child("down1", ResBlock(c, 2 * c, True, dt))
        self.child("down2", ResBlock(2 * c, 4 * c, True, dt))
        self.child("head", nn.Linear(4 * c, 128))
        self.child("logit", nn.Linear(128, 1))
        if n_extra:
            self.child("gap", nn.Linear(n_extra, 1))
            nn.init.zeros_(self.gap.weight)
            nn.init.zeros_(self.gap.bias)
        self.sites_dropped = None

    def forward(self, src_moved: torch.Tensor, tgt: torch.Tensor,
                extra: torch.Tensor | None = None, *,
                train: bool = False) -> torch.Tensor:
        b, n1 = src_moved.shape[:2]
        n2 = tgt.shape[1]
        merged = torch.cat([src_moved, tgt], 1).float()       # (B, N, 3)
        tags = torch.zeros((b, n1 + n2, 2), device=merged.device)
        tags[:, :n1, 0] = 1.0
        tags[:, n1:, 1] = 1.0
        feats = torch.cat([merged, tags], -1)                  # (B, N, 5)
        coords = voxel_grid_indices(merged, self.grid_size, -1.0, 1.0)
        sg = from_point_voxels(coords, feats, self.grid_size)
        lookup = build_lookup(sg)
        sg = self.context(sg, lookup, train)
        down1, _ = self.down1(sg, lookup)
        down2, _ = self.down2(down1, build_lookup(down1))
        self.sites_dropped = torch.maximum(down1.dropped.max(),
                                           down2.dropped.max())
        h = torch.relu(self.head(masked_max(down2)))
        logit = self.logit(h)[..., 0]
        if self.n_extra:
            if extra is None:
                extra = torch.zeros((b, self.n_extra), device=logit.device)
            logit = logit + self.gap(extra.float())[..., 0]
        return logit


class VoxAsym(FlaxNamed):
    """points (B, N, 3) and their voxel indices (B, N, 3) -> (occupancy
    probabilities (B, V, 2), positions (B, V, 3), voxel indices (B, V, 3),
    valid rows (B, V)), V = N rows of the voxel list. ``compute_dtype``
    bf16 runs the point MLP (which returns f32) and the context block's
    convs in bf16, as the JAX model; the head and the softmax stay f32."""

    def __init__(self, grid_size: int = 50, embedding_dim: int = 64,
                 init_size: int = 32, compute_dtype: str | None = None):
        super().__init__()
        self.grid_size = grid_size
        self.child("mlp", PointMLP((64, embedding_dim), 3, relu_last=True,
                                   compute_dtype=compute_dtype))
        self.child("context", ResContextBlock(embedding_dim, init_size,
                                              compute_dtype))
        self.child("head", nn.Linear(init_size, 5))

    def forward(self, points: torch.Tensor, coords: torch.Tensor,
                train: bool = False):
        sg = from_point_voxels(coords, self.mlp(points), self.grid_size)
        h = self.context(sg, build_lookup(sg), train)
        pred = self.head(h.features)
        return torch.softmax(pred[..., :2], -1), pred[..., 2:], h.coords, h.mask
