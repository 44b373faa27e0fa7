"""vrcnet_knn, the champion completion model (counterpart of
``houv_tpu/models/vrcnet_knn.py``).

A label-conditioned PCN encoder gives a global feature and per-point
features; the point features, scattered onto the voxel grid by the batch's
``coords``, run through the hybrid sparse/dense ``Asymm3DSpconv``, whose
max-pooled output joins the global feature. ``KNNDecoder`` then makes an FC
coarse cloud, runs the SA-SKN U-Net over the coarse cloud and the input
together, moves every one of those points to a fine cloud with a tanh
MLP, and takes ``num_native`` of them by FPS to a "native" cloud.

The loss is CD(coarse) + 2·CD(fine) + CD(native): the reference decoder
returns the fine cloud twice and counts its chamfer twice, which the JAX
package keeps. With ``fused_cd`` the three chamfers are one, over the
clouds stacked on the batch axis, coarse and native padded to the fine
cloud's size with far sentinels that are masked out of their own means.
'val' gives cd_p, cd_t and f1 of the fine cloud; 'test' the fine cloud.

The kernels of the path: FPS (``fps``) and kNN (``knn``) in the U-Net's
geometry and the trim to the native cloud, the chamfer (``nn_both``) and
its backward (``scatter``). With ``compute_dtype`` bf16 the encoder's and
the U-Net's Dense layers run in bf16; the voxel branch runs in
``voxel_compute_dtype``, bf16 by default whatever ``compute_dtype`` is, as
the JAX harness never sets it. On the card the model keeps TF32 and
cuBLAS's reduced-precision bf16 sums off (``_device.exact_cuda_math``), so
that f32 is f32 and bf16 products are summed in f32, as in the JAX package.
Dropout masks come from a ``torch.Generator`` handed in, or as tensors.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from houv_tpu_torch._device import exact_cuda_math
from houv_tpu_torch.metrics.cd import calc_cd, calc_cd_percent_len
from houv_tpu_torch.models.common import FlaxNamed
from houv_tpu_torch.models.pcn import PCNEncoderLabel
from houv_tpu_torch.models.voxelnet import Asymm3DSpconv
from houv_tpu_torch.models.vrcnet import SASKNResEncoder, saskn_geometry
from houv_tpu_torch.ops.gather import gather_rows
from houv_tpu_torch.ops.sampling import furthest_point_sample


class KNNDecoder(FlaxNamed):
    """(global feature (B, feat_size), input (B, n_input, 3)) -> (coarse
    (B, num_coarse, 3), fine (B, num_coarse + n_input, 3), native
    (B, num_native, 3)); ``num_fine`` is num_coarse + n_input, as the JAX
    model's points are. ``remat`` recomputes the whole SA-SKN encoder in
    the backward; its geometry stays outside and is kept."""

    def __init__(self, feat_size: int, num_native: int = 2048,
                 num_coarse: int = 1024, layers: tuple = (1, 1, 1, 1),
                 knn_list: tuple = (16,), pk: int = 10, remat: bool = False,
                 compute_dtype=None):
        super().__init__()
        self.num_native, self.num_coarse = num_native, num_coarse
        self.knn_list, self.pk = tuple(knn_list), pk
        self.remat = remat
        self.child("fc1", nn.Linear(feat_size, 1024))
        self.child("fc2", nn.Linear(1024, 1024))
        self.child("fc3", nn.Linear(1024, num_coarse * 3))
        encoder = SASKNResEncoder(3, knn_list, pk, 256, layers,
                                  compute_dtype=compute_dtype)
        if remat:     # the name flax gives the class nn.remat lifts
            encoder.flax_class = "CheckpointSASKNResEncoder"
        self.child("encoder", encoder)
        # flax builds each outer Dense(3) before its inner Dense(1024)
        self.child("fine_out", nn.Linear(1024, 3))
        self.child("fine_hidden", nn.Linear(256, 1024))
        self.child("native_out", nn.Linear(1024, 3))
        self.child("native_hidden", nn.Linear(256, 1024))

    def forward(self, global_feat: torch.Tensor, origin_points: torch.Tensor,
                dropout: tuple | None = None):
        b = global_feat.shape[0]
        h = torch.tanh(self.fc2(torch.relu(self.fc1(global_feat))))
        coarse = self.fc3(h).reshape(b, self.num_coarse, 3)
        points = torch.cat([coarse, origin_points], 1)
        t = points.shape[1]
        geo = saskn_geometry(points, (t, t // 2, t // 4, t // 8),
                             self.knn_list, self.pk)
        if self.remat and torch.is_grad_enabled():
            fine_feat = checkpoint(self.encoder, points, geo, dropout,
                                   use_reentrant=False)
        else:
            fine_feat = self.encoder(points, geo, dropout)
        fine = self.fine_out(torch.tanh(self.fine_hidden(fine_feat)))
        idx = furthest_point_sample(fine, self.num_native, device=fine.device)
        native_feat = gather_rows(fine_feat, idx)
        native = self.native_out(torch.tanh(self.native_hidden(native_feat)))
        return coarse, fine, native


class VRCNetKNN(FlaxNamed):
    """x (B, N, 3), gt (B, M, 3), label (B,) int (None: class 0), coords
    (B, N, 3) int grid indices of x (None: a zero voxel feature) ->
    {'out2': fine, 'loss2': cd_t of native, 'total_loss'} ('train'),
    {'out1': coarse, 'out2': native, 'cd_p', 'cd_t', 'f1'} of the fine
    cloud ('val'), or {'result': fine} ('test').

    'train' runs the voxel branch's BatchNorms on the batch (moving their
    running statistics) and the U-Net's two dropouts, whose keep masks are
    ``dropout_masks`` or drawn from ``generator``
    (``SASKNResEncoder.dropout_masks``). ``feature_size`` is accepted as
    the JAX model accepts it: the decoder's input width is
    global_feature_size + 8 · voxel_init_size."""

    def __init__(self, num_native: int = 2048, num_coarse: int = 1024,
                 num_fine: int = 3072, feature_size: int = 2048,
                 global_feature_size: int = 1024,
                 layers: tuple = (1, 1, 1, 1), knn_list: tuple = (16,),
                 pk: int = 10, voxel_grid_size: int = 50,
                 voxel_init_size: int = 128, remat: bool = False,
                 compute_dtype=None, voxel_compute_dtype="bfloat16",
                 voxel_conv_remat: bool = False, fused_cd: bool = False):
        super().__init__()
        self.num_native, self.num_coarse, self.num_fine = (
            num_native, num_coarse, num_fine)
        self.voxel_init_size = voxel_init_size
        self.fused_cd = fused_cd
        self.child("encoder", PCNEncoderLabel(global_feature_size,
                                              compute_dtype))
        self.child("voxel", Asymm3DSpconv(
            1024, voxel_init_size, voxel_grid_size,
            compute_dtype=voxel_compute_dtype, conv_remat=voxel_conv_remat))
        self.child("decoder", KNNDecoder(
            global_feature_size + 8 * voxel_init_size, num_native,
            num_coarse, layers, knn_list, pk, remat, compute_dtype))

    def _loss(self, coarse, fine, native, gt):
        if not self.fused_cd:
            loss1 = calc_cd(coarse, gt)[0]
            loss2 = calc_cd(fine, gt)[0]
            loss4, loss4_t = calc_cd(native, gt)
        else:
            b, npad = coarse.shape[0], self.num_fine

            def pad(c):
                return torch.cat([c, c.new_full((b, npad - c.shape[1], 3),
                                                1e3)], 1)

            pred = torch.cat([pad(coarse), fine, pad(native)], 0)
            ar = torch.arange(npad, device=fine.device)
            valid = torch.cat([
                (ar < self.num_coarse).expand(b, npad),
                torch.ones((b, npad), dtype=torch.bool, device=fine.device),
                (ar < self.num_native).expand(b, npad)], 0)
            cd_p, cd_t = calc_cd_percent_len(pred, torch.cat([gt] * 3, 0),
                                             mask_output=valid)
            loss1, loss2, loss4 = cd_p[:b], cd_p[b:2 * b], cd_p[2 * b:]
            loss4_t = cd_t[2 * b:]
        return loss1.mean() + 2.0 * loss2.mean() + loss4.mean(), loss4_t

    def forward(self, x: torch.Tensor, gt: torch.Tensor | None = None,
                prefix: str = "test", label: torch.Tensor | None = None,
                coords: torch.Tensor | None = None,
                generator: torch.Generator | None = None,
                dropout_masks: tuple | None = None) -> dict:
        if prefix not in ("train", "val", "test"):
            raise ValueError(
                f"prefix is 'train', 'val' or 'test', got {prefix!r}")
        if x.is_cuda:
            exact_cuda_math()
        train = prefix == "train"
        b = x.shape[0]
        if label is None:
            label = torch.zeros((b,), dtype=torch.long, device=x.device)
        feat, point_feat = self.encoder(x, label)
        if coords is not None:
            feat_voxel = self.voxel(coords, point_feat, train=train)
        else:
            feat_voxel = feat.new_zeros((b, 8 * self.voxel_init_size))
        feat = torch.cat([feat, feat_voxel], -1)
        dropout = None
        if train:
            dropout = dropout_masks or self.decoder.encoder.dropout_masks(
                b, generator)
        coarse, fine, native = self.decoder(feat, x, dropout)
        if train:
            total, loss4_t = self._loss(coarse, fine, native, gt)
            return {"out2": fine, "loss2": loss4_t, "total_loss": total}
        if prefix == "val":
            cd_p, cd_t, f1 = calc_cd(fine, gt, calc_f1=True)
            return {"out1": coarse, "out2": native, "cd_p": cd_p,
                    "cd_t": cd_t, "f1": f1}
        return {"result": fine}
