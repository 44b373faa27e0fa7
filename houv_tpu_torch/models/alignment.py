"""The alignment-quality classifier (counterpart of
``houv_tpu/models/alignment.py:AlignmentClassifier``), registered as
``alignment_spconv``.

It scores whether a candidate transform aligns a pair: the source moved by
the candidate and the target are voxelized jointly on one grid over
[-1, 1]³, each point's feature its position and a one-hot tag of its cloud;
a sparse-conv trunk (a context block, two strided residual blocks) is
max-pooled over the valid voxels to a logit. ``n_extra`` scalar side inputs
(the rescorer's CD-loss gap) add a third ``Dense``. In bf16 mode the convs
round their operands to bf16 and multiply in f32, as the JAX rescorer's
bf16 build does.
"""

from __future__ import annotations

import torch
from torch import nn

from houv_tpu_torch.models.common import FlaxNamed
from houv_tpu_torch.models.voxelnet import ResBlock, ResContextBlock
from houv_tpu_torch.ops.sparse_conv import (
    build_lookup,
    from_point_voxels,
    masked_max,
)
from houv_tpu_torch.ops.voxel import voxel_grid_indices


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
                extra: torch.Tensor | None = None) -> torch.Tensor:
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
        sg = self.context(sg, lookup)
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
