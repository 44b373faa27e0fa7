"""PCN, the Point Completion Network (counterpart of
``houv_tpu/models/pcn.py``): a two-stage PointNet encoder, an FC coarse
decoder and a folding-grid fine decoder, with its in-model losses (CD or
EMD, coarse + alpha·fine). Features last, (B, N, C). With
``compute_dtype`` bf16 the Dense layers run in bf16 (flax
``Dense(dtype=bf16)``, ``models/common.py:dense``) and the encoder's
feature and the decoder's clouds come back in f32 where the JAX modules
cast them."""

from __future__ import annotations

import math

import torch
from torch import nn

from houv_tpu_torch.metrics.cd import calc_cd
from houv_tpu_torch.metrics.emd import calc_emd
from houv_tpu_torch.models.common import (
    FlaxNamed,
    compute_dtype_of,
    dense,
    gen_grid_up,
    max_pool_points,
    to_f32,
)


class PCNEncoder(FlaxNamed):
    """(B, N, 3) -> (B, output_size) global feature (f32): a two-stage
    PointNet with the first stage's global feature concatenated to every
    point."""

    def __init__(self, output_size: int = 1024, compute_dtype=None):
        super().__init__()
        self.dt = compute_dtype_of(compute_dtype)
        self.child("fc1", nn.Linear(3, 128))
        self.child("fc2", nn.Linear(128, 256))
        self.child("fc3", nn.Linear(512, 512))
        self.child("fc4", nn.Linear(512, output_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dt
        h = dense(self.fc2, torch.relu(dense(self.fc1, x, dt)), dt)
        g = max_pool_points(h)
        h = torch.cat([h, g[:, None, :].expand_as(h)], -1)
        h = dense(self.fc4, torch.relu(dense(self.fc3, h, dt)), dt)
        return to_f32(max_pool_points(h), dt)


class PCNEncoderLabel(FlaxNamed):
    """Label-conditioned encoder: a 16-way class embedding joins the first
    stage's global feature. (x (B, N, 3), label (B,) int) ->
    (global feature (B, output_size), point feature (B, N, 1024)), both
    f32. With ``compute_dtype`` bf16 its Dense layers run in bf16 (flax
    ``Dense(dtype=bf16)``, ``models/common.py:dense``) and the embedding
    joins them rounded to bf16."""

    def __init__(self, output_size: int = 1024, compute_dtype=None):
        super().__init__()
        self.dt = compute_dtype_of(compute_dtype)
        self.child("fc1", nn.Linear(3, 512))
        self.child("embed", nn.Embedding(16, 256))
        self.child("fc2", nn.Linear(512 + 768, 512))
        self.child("fc3", nn.Linear(512, 1024))
        self.child("fc4", nn.Linear(1024, output_size))

    def forward(self, x: torch.Tensor, label: torch.Tensor):
        dt = self.dt
        h = torch.relu(dense(self.fc1, x, dt))
        g = torch.cat([self.embed(label.long()).to(h.dtype),
                       max_pool_points(h)], -1)
        h = torch.cat([h, g[:, None, :].expand(-1, h.shape[1], -1)], -1)
        h = torch.relu(dense(self.fc3, torch.relu(dense(self.fc2, h, dt)),
                             dt))
        out = max_pool_points(dense(self.fc4, h, dt))
        return to_f32(out, dt), to_f32(h, dt)


def fc_coarse(module: FlaxNamed, feat_size: int, num_coarse: int) -> None:
    """Registers the FC coarse decoder's three layers on ``module``."""
    module.child("fc1", nn.Linear(feat_size, 1024))
    module.child("fc2", nn.Linear(1024, 1024))
    module.child("fc3", nn.Linear(1024, num_coarse * 3))


def run_fc_coarse(module: nn.Module, feat: torch.Tensor, num_coarse: int,
                  dt: torch.dtype | None = None) -> torch.Tensor:
    """(B, feat_size) -> the coarse cloud (B, num_coarse, 3), f32; its
    layers in ``dt`` (None: as they are)."""
    h = torch.relu(dense(module.fc2, torch.relu(dense(module.fc1, feat, dt)),
                         dt))
    return to_f32(dense(module.fc3, h, dt), dt).reshape(feat.shape[0],
                                                        num_coarse, 3)


class PCNDecoder(FlaxNamed):
    """FC coarse cloud, then a folding fine cloud: every coarse point is
    repeated ``scale`` times beside a grid offset and the global feature,
    and a pointwise MLP moves it. feat (B, G) -> (coarse (B, num_coarse, 3),
    fine (B, num_fine, 3))."""

    def __init__(self, num_coarse: int, num_fine: int, scale: int,
                 feat_size: int = 1024, compute_dtype=None):
        super().__init__()
        self.num_coarse, self.num_fine, self.scale = num_coarse, num_fine, scale
        self.dt = compute_dtype_of(compute_dtype)
        fc_coarse(self, feat_size, num_coarse)
        self.child("fold1", nn.Linear(2 + 3 + feat_size, 512))
        self.child("fold2", nn.Linear(512, 512))
        self.child("fold3", nn.Linear(512, 3))

    def forward(self, feat: torch.Tensor):
        b, dt = feat.shape[0], self.dt
        coarse = run_fc_coarse(self, feat, self.num_coarse, dt)
        grid = gen_grid_up(2 ** int(math.log2(self.scale)), 0.05).to(
            feat.device)                                      # (scale, 2)
        grid_feat = grid[None, None].expand(
            b, self.num_coarse, self.scale, 2).reshape(b, self.num_fine, 2)
        point_feat = coarse.repeat_interleave(self.scale, dim=1)
        global_feat = feat[:, None, :].expand(-1, self.num_fine, -1)
        h = torch.cat([grid_feat, point_feat, global_feat], -1)
        h = torch.relu(dense(self.fold2, torch.relu(dense(self.fold1, h, dt)),
                             dt))
        return coarse, to_f32(dense(self.fold3, h, dt), dt) + point_feat


def completion_outputs(coarse, fine, gt, prefix, eval_emd):
    """The 'val' and 'test' outputs PCN and ECG share: the fine cloud alone,
    or both clouds with cd_p, cd_t, f1 per cloud (and emd)."""
    if prefix == "test":
        return {"result": fine}
    if prefix != "val":
        raise ValueError(
            f"prefix is 'train', 'val' or 'test', got {prefix!r}")
    cd_p, cd_t, f1 = calc_cd(fine, gt, calc_f1=True)
    out = {"out1": coarse, "out2": fine, "cd_p": cd_p, "cd_t": cd_t, "f1": f1}
    if eval_emd:
        out["emd"] = calc_emd(fine, gt, eps=0.004, iterations=3000)
    return out


def coarse_and_fine_losses(coarse, fine, gt, train_loss):
    """(loss of the coarse cloud, of the fine cloud), each (B,): cd_p, or
    the auction EMD."""
    if train_loss == "emd":
        return calc_emd(coarse, gt), calc_emd(fine, gt)
    return calc_cd(coarse, gt)[0], calc_cd(fine, gt)[0]


class PCN(FlaxNamed):
    """PCN with its in-model losses: x (B, N, 3) -> {'result': fine}
    ('test'); with gt the metrics per cloud ('val'); or {'out2', 'loss2',
    'total_loss'} ('train': mean coarse loss + alpha · mean fine loss). The
    model draws no random numbers. ``compute_dtype`` bf16 runs the encoder
    and the decoder in bf16; clouds and losses are f32."""

    def __init__(self, num_points: int = 2048, num_coarse: int = 1024,
                 train_loss: str = "cd", eval_emd: bool = False,
                 compute_dtype=None):
        super().__init__()
        if train_loss not in ("cd", "emd"):
            raise NotImplementedError("train loss is either cd or emd")
        self.train_loss, self.eval_emd = train_loss, eval_emd
        self.child("encoder", PCNEncoder(compute_dtype=compute_dtype))
        self.child("decoder", PCNDecoder(num_coarse, num_points,
                                         num_points // num_coarse,
                                         compute_dtype=compute_dtype))

    def forward(self, x: torch.Tensor, gt: torch.Tensor | None = None,
                prefix: str = "test", alpha: float | None = None) -> dict:
        coarse, fine = self.decoder(self.encoder(x))
        if prefix != "train":
            return completion_outputs(coarse, fine, gt, prefix, self.eval_emd)
        loss1, loss2 = coarse_and_fine_losses(coarse, fine, gt,
                                              self.train_loss)
        return {"out2": fine, "loss2": loss2,
                "total_loss": loss1.mean() + loss2.mean() * alpha}
