"""ECG, Edge-aware Completion with Graph convolutions (counterpart of
``houv_tpu/models/ecg.py``): a PCN encoder, an FC coarse cloud joined with
the input, the ``EFEncoder`` U-Net of densely growing graph convolutions
over four point resolutions (edge-preserve pooling down, three-NN
interpolation up), ``EFExpansion`` when the fine cloud is larger, and an FPS
trim; loss = CD or EMD + 0.1 · uniform loss on the coarse and the fine
cloud. Features last, (B, N, C).

``DenseConv`` builds its graph in the feature space (24 and 48 channels) on
the wide kNN kernel; the pooling, the interpolation and the uniform loss run
the coordinate kNN and the FPS kernels, the chamfer terms ``nn_both`` and
``scatter``.

With ``compute_dtype`` bf16 the Dense layers run in bf16
(``models/common.py:dense``) and their results come back in f32 where the
JAX modules cast them: a ``DenseConv`` picks its neighbours on its
bf16 input cast to f32 (so the wide kNN sees f32 inputs) and returns f32,
the U-Net's upward layers and its last layer return f32, and the
pooling, the interpolation and the losses run in f32.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from houv_tpu_torch.models.common import (
    EFExpansion,
    FlaxNamed,
    compute_dtype_of,
    dense,
    edge_preserve_sampling,
    get_graph_feature,
    get_uniform_loss,
    to_f32,
)
from houv_tpu_torch.models.pcn import (
    PCNEncoder,
    coarse_and_fine_losses,
    completion_outputs,
    fc_coarse,
    run_fc_coarse,
)
from houv_tpu_torch.ops.gather import gather_rows
from houv_tpu_torch.ops.interpolate import (
    three_interpolate,
    three_nn_upsampling,
)
from houv_tpu_torch.ops.sampling import furthest_point_sample


class DenseConv(FlaxNamed):
    """Densely growing graph convolution: edge features of the k nearest
    neighbours in the feature space, a first Dense with ReLU, then
    ``dense_n - 1`` Dense layers each concatenated onto its input (the last
    without a ReLU), and the maximum over the k edges.
    (B, N, C) -> (B, N, C + growth_rate · dense_n)."""

    def __init__(self, in_channels: int, growth_rate: int = 24,
                 dense_n: int = 3, k: int = 16, compute_dtype=None):
        super().__init__()
        self.k = k
        self.dt = compute_dtype_of(compute_dtype)
        self.layers = nn.ModuleList()
        width = 2 * in_channels
        for i in range(dense_n):
            self.layers.append(self.child(f"layers.{i}",
                                          nn.Linear(width, growth_rate)))
            width = growth_rate + in_channels if i == 0 \
                else width + growth_rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dt
        y = get_graph_feature(to_f32(x, dt), self.k, minus_center=True)
        if dt is not None:
            y, x = y.to(dt), x.to(dt)
        y = torch.relu(dense(self.layers[0], y, dt))
        y = torch.cat([y, x[:, :, None, :].expand(-1, -1, y.shape[2], -1)],
                      -1)
        for i, layer in enumerate(self.layers[1:], 1):
            h = dense(layer, y, dt)
            if i != len(self.layers) - 1:
                h = torch.relu(h)
            y = torch.cat([y, h], -1)
        return to_f32(y.amax(2), dt)


class EFEncoder(FlaxNamed):
    """The dense-conv U-Net over the point resolutions N and
    ``hierarchy``: (B, N, 3) -> (B, N, output_size)."""

    def __init__(self, growth_rate: int = 24, dense_n: int = 3, k: int = 16,
                 hierarchy: tuple = (1024, 256, 64), output_size: int = 256,
                 compute_dtype=None):
        super().__init__()
        self.k, self.hierarchy = k, tuple(hierarchy)
        self.dt = compute_dtype_of(compute_dtype)
        comp = growth_rate * 2
        grown = growth_rate * dense_n

        def conv(c_in):
            return DenseConv(c_in, growth_rate, dense_n, k, self.dt)

        # in the order the flax module builds them
        self.child("fc0", nn.Linear(3, 24))
        self.child("conv1", conv(24))
        c1 = 24 + grown + 24                 # x1 = [conv1(x0), x0]
        self.child("comp2", nn.Linear(2 * c1, comp))
        self.child("conv2", conv(comp))
        c2 = comp + grown + 2 * c1           # x2 = [conv2, x1d]
        self.child("comp3", nn.Linear(2 * c2, comp))
        self.child("conv3", conv(comp))
        c3 = comp + grown + 2 * c2
        self.child("comp4", nn.Linear(2 * c3, comp))
        self.child("conv4", conv(comp))
        c4 = comp + grown + 2 * c3
        self.child("g1", nn.Linear(c4, 1024))
        self.child("g2", nn.Linear(1024, 512))
        self.child("g3", nn.Linear(512, 1024))
        self.child("up4", nn.Linear(1024 + c4, 1024))
        self.child("up3", nn.Linear(c3 + 1024, 768))
        self.child("up2", nn.Linear(c2 + 768, 512))
        self.child("out", nn.Linear(c1 + 512, output_size))

    def forward(self, points: torch.Tensor) -> torch.Tensor:
        dt = self.dt
        pc1 = points
        # a bf16 layer's result joins an f32 one as f32, as jnp promotes
        x0 = torch.relu(dense(self.fc0, points, dt))
        x1 = torch.cat([torch.relu(self.conv1(x0)), x0], -1)
        x1d, _, pc2 = edge_preserve_sampling(x1, pc1, self.hierarchy[0],
                                             self.k)
        x2 = torch.relu(dense(self.comp2, x1d, dt))
        x2 = torch.cat([torch.relu(self.conv2(x2)), x1d], -1)
        x2d, _, pc3 = edge_preserve_sampling(x2, pc2, self.hierarchy[1],
                                             self.k)
        x3 = torch.relu(dense(self.comp3, x2d, dt))
        x3 = torch.cat([torch.relu(self.conv3(x3)), x2d], -1)
        x3d, _, pc4 = edge_preserve_sampling(x3, pc3, self.hierarchy[2],
                                             self.k)
        x4 = torch.relu(dense(self.comp4, x3d, dt))
        x4 = torch.cat([torch.relu(self.conv4(x4)), x3d], -1)

        gf = dense(self.g1, x4, dt).amax(1)
        gf = torch.relu(dense(self.g3, torch.relu(dense(self.g2, gf, dt)),
                              dt))
        gf = gf[:, None, :].expand(-1, x4.shape[1], -1)

        def unpool(feat, fine_pts, coarse_pts):
            idx, w = three_nn_upsampling(fine_pts, coarse_pts)
            return three_interpolate(feat.transpose(1, 2), idx,
                                     w).transpose(1, 2)

        def up(layer, a, b):
            return torch.relu(to_f32(dense(layer, torch.cat([a, b], -1), dt),
                                     dt))

        x4 = unpool(up(self.up4, gf, x4), pc3, pc4)
        x3 = unpool(up(self.up3, x3, x4), pc2, pc3)
        x2 = unpool(up(self.up2, x2, x3), pc1, pc2)
        return to_f32(dense(self.out, torch.cat([x1, x2], -1), dt), dt)


class ECGDecoder(FlaxNamed):
    """FC coarse cloud; the coarse cloud and the input together through
    ``EFEncoder``; ``EFExpansion`` when the fine cloud needs at least twice
    their points; a pointwise head; an FPS trim to ``num_fine``.
    (global feature (B, G), input (B, num_input, 3)) -> (coarse, fine)."""

    def __init__(self, num_coarse: int, num_fine: int, num_input: int,
                 feat_size: int = 1024, compute_dtype=None):
        super().__init__()
        self.num_coarse, self.num_fine = num_coarse, num_fine
        self.dt = compute_dtype_of(compute_dtype)
        scale = math.ceil(num_fine / (num_coarse + num_input))
        fc_coarse(self, feat_size, num_coarse)
        self.child("encoder", EFEncoder(output_size=256,
                                        compute_dtype=self.dt))
        self.expansion = None
        if scale >= 2:
            self.expansion = self.child(
                "expansion", EFExpansion(256, 64, step_ratio=scale, k=4,
                                         compute_dtype=self.dt))
        self.child("head1", nn.Linear(64 if scale >= 2 else 256, 64))
        self.child("head2", nn.Linear(64, 3))

    def forward(self, global_feat: torch.Tensor, point_input: torch.Tensor):
        dt = self.dt
        coarse = run_fc_coarse(self, global_feat, self.num_coarse, dt)
        dense_feat = self.encoder(torch.cat([coarse, point_input], 1))
        if self.expansion is not None:
            dense_feat = self.expansion(dense_feat)
        fine = to_f32(dense(self.head2, torch.relu(
            dense(self.head1, dense_feat, dt)), dt), dt)
        if fine.shape[1] > self.num_fine:
            fine = gather_rows(fine, furthest_point_sample(
                fine, self.num_fine, device=fine.device))
        return coarse, fine


class ECG(FlaxNamed):
    """ECG with its in-model losses; outputs as ``PCN``'s. 'train' adds 0.1
    · the uniform loss of the coarse and of the fine cloud to their CD or
    EMD terms. The model draws no random numbers. ``compute_dtype`` bf16
    runs the encoder and the decoder's layers in bf16; clouds and losses
    are f32."""

    def __init__(self, num_points: int = 2048, num_coarse: int = 1024,
                 num_input: int = 2048, train_loss: str = "cd",
                 eval_emd: bool = False, compute_dtype=None):
        super().__init__()
        if train_loss not in ("cd", "emd"):
            raise NotImplementedError("train loss is either cd or emd")
        self.train_loss, self.eval_emd = train_loss, eval_emd
        self.child("encoder", PCNEncoder(compute_dtype=compute_dtype))
        self.child("decoder", ECGDecoder(num_coarse, num_points, num_input,
                                         compute_dtype=compute_dtype))

    def forward(self, x: torch.Tensor, gt: torch.Tensor | None = None,
                prefix: str = "test", alpha: float | None = None) -> dict:
        coarse, fine = self.decoder(self.encoder(x), x)
        if prefix != "train":
            return completion_outputs(coarse, fine, gt, prefix, self.eval_emd)
        u1, u2 = get_uniform_loss(coarse), get_uniform_loss(fine)
        loss1, loss2 = coarse_and_fine_losses(coarse, fine, gt,
                                              self.train_loss)
        total = loss1.mean() + 0.1 * u1 + (loss2.mean() + 0.1 * u2) * alpha
        return {"out2": fine, "loss2": loss2, "total_loss": total}
