"""The asymmetric voxel encoder (counterpart of
``houv_tpu/models/voxelnet.py``): the sparse blocks ``SubMConv``,
``SparseDownConv``, ``MaskedBatchNorm``, ``ResContextBlock``, ``ResBlock``,
``ReconBlock`` and ``SparseBasicBlock``, the dense blocks of its coarse levels
(``DenseSubMConv``, ``DenseResBlock``, ``DenseReconBlock``) and the whole
hybrid encoder ``Asymm3DSpconv``, the voxel branch of ``vrcnet_knn`` and
the trunk of the alignment classifier (``models/alignment.py``).

Factorised submanifold kernels (1,3,3) and (3,1,3), 9 taps each, no bias;
the strided conv has 27 taps. Activations are leaky ReLU at slope 0.01
(flax's default). BatchNorm is flax's over the valid rows, ε = 1e-5: in a
train step it normalises by the batch's biased statistics and moves the
running ones by 1% towards them; otherwise it uses the running ones. Each
block is ``FlaxNamed``: its children carry the flax auto-names
(``SubMConv_2``, ``BatchNorm_1``), so ``state.state_from_flax`` carries a
JAX checkpoint across; the conv kernels keep flax's layouts, (K, Cin, Cout)
sparse and (kx, ky, kz, Cin, Cout) dense, and are permuted where they are
used.

The dense levels hold a (B, G, G, G, C) volume and an occupancy mask: from
``dense_from`` cells a side down (13³, where a 2048-point cloud fills most
cells) a masked dense conv gives what the submanifold conv gives, on
``torch.nn.functional.conv3d``. In bf16 mode a dense conv rounds its
operands and its result to bf16, as the JAX package's ``_dense_conv`` does;
a sparse conv rounds its operands only (``ops/sparse_conv.py``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from houv_tpu_torch.models.common import (BatchNorm, FlaxNamed,
                                          flax_normalize, lecun_normal_)
from houv_tpu_torch.ops.sparse_conv import (
    SparseGrid,
    build_lookup,
    downsample_sites,
    from_point_voxels,
    masked_max,
    sparse_conv_down_features,
    subm_conv,
    to_dense,
)


def _lecun_param(*shape: int) -> nn.Parameter:
    with torch.no_grad():
        return nn.Parameter(lecun_normal_(torch.empty(shape)))


def _remat(body, *args):
    """``body(*args)``, recomputed in the backward instead of kept, when
    autograd records."""
    if torch.is_grad_enabled():
        return checkpoint(body, *args, use_reentrant=False)
    return body(*args)


class SubMConv(nn.Module):
    """Submanifold conv with a factorised kernel, no bias. ``remat``
    recomputes the gathered neighbours in the backward."""

    flax_leaves = {"kernel": "kernel"}
    lecun_params = ("kernel",)

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size=(3, 3, 3), compute_dtype=None,
                 remat: bool = False):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.compute_dtype = compute_dtype
        self.remat = remat
        self.kernel = _lecun_param(int(np.prod(kernel_size)), in_channels,
                                   out_channels)

    def forward(self, sg: SparseGrid, lookup: torch.Tensor) -> SparseGrid:
        if not self.remat:
            return subm_conv(sg, lookup, self.kernel, self.kernel_size,
                             self.compute_dtype)

        def body(feats, w):
            return subm_conv(SparseGrid(feats, sg.coords, sg.mask,
                                        sg.grid_size), lookup, w,
                             self.kernel_size, self.compute_dtype).features

        return SparseGrid(_remat(body, sg.features, self.kernel), sg.coords,
                          sg.mask, sg.grid_size)


class SparseDownConv(nn.Module):
    """Strided sparse conv (kernel 3, padding 1), exact spconv sites; the
    output grid's ``dropped`` counts sites beyond its capacity. ``remat``
    recomputes the gathered taps in the backward (the sites are kept)."""

    flax_leaves = {"kernel": "kernel"}
    lecun_params = ("kernel",)

    def __init__(self, in_channels: int, out_channels: int,
                 stride=(2, 2, 2), compute_dtype=None, remat: bool = False):
        super().__init__()
        self.stride = tuple(stride)
        self.compute_dtype = compute_dtype
        self.remat = remat
        self.kernel = _lecun_param(27, in_channels, out_channels)

    def forward(self, sg: SparseGrid, lookup: torch.Tensor) -> SparseGrid:
        out_coords, out_mask, out_g, dropped = downsample_sites(sg,
                                                                self.stride)

        def body(feats, w):
            return sparse_conv_down_features(
                SparseGrid(feats, sg.coords, sg.mask, sg.grid_size), lookup,
                w, out_coords, out_mask, self.stride, self.compute_dtype)

        feats = (_remat(body, sg.features, self.kernel) if self.remat
                 else body(sg.features, self.kernel))
        return SparseGrid(feats, out_coords, out_mask, out_g, dropped)


class MaskedBatchNorm(BatchNorm):
    """flax ``nn.BatchNorm`` over the valid rows (the reference's
    BatchNorm1d over the ragged voxel list), rows outside the mask set to
    0: ``common.BatchNorm``'s arithmetic, its train-mode statistics over
    the valid rows of every cloud."""

    def forward(self, sg: SparseGrid, train: bool = False) -> SparseGrid:
        mask = sg.mask[..., None]
        mean, var = self.statistics(sg.features, train, mask)
        feats = flax_normalize(sg.features, mean, var, self.eps, self.weight,
                               self.bias)
        feats = torch.where(mask, feats, 0.0)
        return SparseGrid(feats, sg.coords, sg.mask, sg.grid_size)


def _act(sg: SparseGrid) -> SparseGrid:
    """Leaky ReLU at flax's slope, 0.01."""
    return SparseGrid(F.leaky_relu(sg.features, 0.01), sg.coords, sg.mask,
                      sg.grid_size)


class ResContextBlock(FlaxNamed):
    """(1x3x3 -> 3x1x3) beside (3x1x3 -> 1x3x3), each conv followed by
    leaky ReLU and masked BatchNorm, summed."""

    def __init__(self, in_channels: int, out_filters: int,
                 compute_dtype=None, remat: bool = False):
        super().__init__()
        c, dt = out_filters, compute_dtype
        self.child("short1", SubMConv(in_channels, c, (1, 3, 3), dt, remat))
        self.child("short1_bn", MaskedBatchNorm(c))
        self.child("short2", SubMConv(c, c, (3, 1, 3), dt, remat))
        self.child("short2_bn", MaskedBatchNorm(c))
        self.child("res1", SubMConv(in_channels, c, (3, 1, 3), dt, remat))
        self.child("res1_bn", MaskedBatchNorm(c))
        self.child("res2", SubMConv(c, c, (1, 3, 3), dt, remat))
        self.child("res2_bn", MaskedBatchNorm(c))

    def forward(self, sg: SparseGrid, lookup: torch.Tensor,
                train: bool = False) -> SparseGrid:
        short = self.short1_bn(_act(self.short1(sg, lookup)), train)
        short = self.short2_bn(_act(self.short2(short, lookup)), train)
        res = self.res1_bn(_act(self.res1(sg, lookup)), train)
        res = self.res2_bn(_act(self.res2(res, lookup)), train)
        return SparseGrid(res.features + short.features, sg.coords, sg.mask,
                          sg.grid_size)


class ResBlock(FlaxNamed):
    """(3x1x3 -> 1x3x3) beside (1x3x3 -> 3x1x3), leaky ReLU after each conv,
    summed, then the strided conv: stride (2,2,2) with ``height_pooling``,
    else (2,2,1). Returns (pooled, pre-pool)."""

    def __init__(self, in_channels: int, out_filters: int,
                 height_pooling: bool = True, compute_dtype=None,
                 remat: bool = False):
        super().__init__()
        c, dt = out_filters, compute_dtype
        self.child("short1", SubMConv(in_channels, c, (3, 1, 3), dt, remat))
        self.child("short2", SubMConv(c, c, (1, 3, 3), dt, remat))
        self.child("res1", SubMConv(in_channels, c, (1, 3, 3), dt, remat))
        self.child("res2", SubMConv(c, c, (3, 1, 3), dt, remat))
        stride = (2, 2, 2) if height_pooling else (2, 2, 1)
        self.child("pool", SparseDownConv(c, c, stride, dt, remat))

    def forward(self, sg: SparseGrid, lookup: torch.Tensor):
        short = _act(self.short2(_act(self.short1(sg, lookup)), lookup))
        res = _act(self.res2(_act(self.res1(sg, lookup)), lookup))
        res = SparseGrid(res.features + short.features, sg.coords, sg.mask,
                         sg.grid_size)
        return self.pool(res, lookup), res


class SparseBasicBlock(FlaxNamed):
    """The ResNet-style sparse residual block (the reference's
    ``sparse_block.SparseBasicBlock``): two 3x3x3 submanifold convs, ReLU
    and masked BatchNorm after the first, masked BatchNorm after the
    second, plus the input (through a bias-free Dense where the widths
    differ), then ReLU. Exported, no caller in either package."""

    def __init__(self, in_channels: int, out_filters: int,
                 compute_dtype=None):
        super().__init__()
        c, dt = out_filters, compute_dtype
        self.child("conv1", SubMConv(in_channels, c, (3, 3, 3), dt))
        self.child("bn1", MaskedBatchNorm(c))
        self.child("conv2", SubMConv(c, c, (3, 3, 3), dt))
        self.child("bn2", MaskedBatchNorm(c))
        self.shortcut = None
        if in_channels != c:
            self.child("shortcut", nn.Linear(in_channels, c, bias=False))

    def forward(self, sg: SparseGrid, lookup: torch.Tensor,
                train: bool = False) -> SparseGrid:
        h = self.conv1(sg, lookup)
        h = SparseGrid(torch.relu(h.features), h.coords, h.mask, h.grid_size)
        h = self.bn2(self.conv2(self.bn1(h, train), lookup), train)
        identity = sg.features
        if self.shortcut is not None:
            identity = self.shortcut(identity)
        return SparseGrid(torch.relu(h.features + identity), sg.coords,
                          sg.mask, sg.grid_size)


class ReconBlock(FlaxNamed):
    """Dimension-wise sigmoid attention: the sum of sigmoid((3,1,1)),
    sigmoid((1,3,1)) and sigmoid((1,1,3)) convs times the input."""

    def __init__(self, in_channels: int, out_filters: int,
                 compute_dtype=None, remat: bool = False):
        super().__init__()
        dt = compute_dtype
        for name, k in (("att_x", (3, 1, 1)), ("att_y", (1, 3, 1)),
                        ("att_z", (1, 1, 3))):
            self.child(name, SubMConv(in_channels, out_filters, k, dt, remat))

    def forward(self, sg: SparseGrid, lookup: torch.Tensor) -> SparseGrid:
        att = sum(torch.sigmoid(conv(sg, lookup).features)
                  for conv in (self.att_x, self.att_y, self.att_z))
        return SparseGrid(att * sg.features, sg.coords, sg.mask, sg.grid_size)


# --- the dense levels --------------------------------------------------------


def _dense_conv(x: torch.Tensor, w: torch.Tensor, stride=(1, 1, 1),
                compute_dtype=None) -> torch.Tensor:
    """x (B, X, Y, Z, C) × w (kx, ky, kz, C, D), padding (k − 1) / 2 a side
    -> (B, X', Y', Z', D) f32. With a ``compute_dtype`` both operands and
    the result are rounded to it: on the card one cuDNN conv in bf16 (f32
    sums, a bf16 result), on the CPU one f32 conv of the rounded operands,
    rounded after."""
    pad = tuple((k - 1) // 2 for k in w.shape[:3])
    xc = x.permute(0, 4, 1, 2, 3)                     # (B, C, X, Y, Z)
    wc = w.permute(4, 3, 0, 1, 2)                     # (D, C, kx, ky, kz)
    if compute_dtype is None:
        out = F.conv3d(xc.float(), wc, stride=tuple(stride), padding=pad)
    else:
        dt = getattr(torch, str(compute_dtype))
        if x.is_cuda:
            out = F.conv3d(xc.to(dt), wc.to(dt), stride=tuple(stride),
                           padding=pad)
        else:
            out = F.conv3d(xc.to(dt).float(), wc.to(dt).float(),
                           stride=tuple(stride), padding=pad).to(dt)
    return out.float().permute(0, 2, 3, 4, 1)


def sparse_to_dense(sg: SparseGrid) -> tuple[torch.Tensor, torch.Tensor]:
    """SparseGrid -> (features (B, G, G, G, C) f32, occupancy (B, G, G, G)
    bool)."""
    g = sg.grid_size
    b = sg.coords.shape[0]
    flat = torch.where(sg.mask, (sg.coords[..., 0] * g + sg.coords[..., 1])
                       * g + sg.coords[..., 2], g ** 3)
    occ = torch.zeros((b, g ** 3 + 1), dtype=torch.bool,
                      device=sg.coords.device)
    occ.scatter_(1, flat, True)
    return to_dense(sg), occ[:, :g ** 3].reshape(b, g, g, g)


def _occ_downsample(occ: torch.Tensor, stride) -> torch.Tensor:
    """The exact sites of a strided conv (kernel 3, padding 1) on a dense
    occupancy (B, X, Y, Z): coarse cell o is occupied iff an input cell in
    [o·s − 1, o·s + 1]³ is (the rule of ``ops/sparse_conv.py:
    downsample_sites``, so the dense levels mask the sites the sparse ones
    would emit). Padding (1, (og − 1)·s + 2 − g) per axis, og =
    ceil(g / s)."""
    pads = []
    for i in reversed(range(3)):                      # F.pad: last axis first
        g = occ.shape[1 + i]
        og = -(-g // stride[i])
        pads += [1, (og - 1) * stride[i] + 2 - g]
    x = F.pad(occ[:, None].to(torch.float32), pads)
    return F.max_pool3d(x, 3, stride=tuple(stride))[:, 0] > 0


class DenseSubMConv(nn.Module):
    """Dense-volume counterpart of ``SubMConv`` (same factorised kernels),
    its output kept at the occupied cells."""

    flax_leaves = {"kernel": "kernel"}
    lecun_params = ("kernel",)

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size=(3, 3, 3), compute_dtype=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.kernel = _lecun_param(*kernel_size, in_channels, out_channels)

    def forward(self, x: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
        return (_dense_conv(x, self.kernel, (1, 1, 1), self.compute_dtype)
                * occ[..., None].float())


class DenseResBlock(FlaxNamed):
    """``ResBlock`` on a dense volume: ((pooled, its occupancy), pre-pool).
    The strided conv's (3, 3, 3, C, C) kernel is the leaf ``down_kernel``,
    as in the JAX module."""

    flax_leaves = {"down_kernel": "down_kernel"}
    lecun_params = ("down_kernel",)

    def __init__(self, in_channels: int, out_filters: int,
                 height_pooling: bool = True, compute_dtype=None):
        super().__init__()
        c, dt = out_filters, compute_dtype
        self.compute_dtype = dt
        self.child("short1", DenseSubMConv(in_channels, c, (3, 1, 3), dt))
        self.child("short2", DenseSubMConv(c, c, (1, 3, 3), dt))
        self.child("res1", DenseSubMConv(in_channels, c, (1, 3, 3), dt))
        self.child("res2", DenseSubMConv(c, c, (3, 1, 3), dt))
        self.stride = (2, 2, 2) if height_pooling else (2, 2, 1)
        self.down_kernel = _lecun_param(3, 3, 3, c, c)

    def forward(self, x: torch.Tensor, occ: torch.Tensor):
        def act(t):
            return F.leaky_relu(t, 0.01)

        short = act(self.short2(act(self.short1(x, occ)), occ))
        res = act(self.res2(act(self.res1(x, occ)), occ))
        res = res + short
        occ_dn = _occ_downsample(occ, self.stride)
        pooled = (_dense_conv(res, self.down_kernel, self.stride,
                              self.compute_dtype)
                  * occ_dn[..., None].float())
        return (pooled, occ_dn), res


class DenseReconBlock(FlaxNamed):
    """``ReconBlock`` on a dense volume."""

    def __init__(self, in_channels: int, out_filters: int,
                 compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        for name, k in (("att_x", (3, 1, 1)), ("att_y", (1, 3, 1)),
                        ("att_z", (1, 1, 3))):
            self.child(name, DenseSubMConv(in_channels, out_filters, k, dt))

    def forward(self, x: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
        att = sum(torch.sigmoid(conv(x, occ))
                  for conv in (self.att_x, self.att_y, self.att_z))
        return att * x


def dense_masked_max(x: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
    """(B, C) max over the occupied cells; 0 for a volume with none."""
    neg = torch.where(occ[..., None], x,
                      torch.tensor(float("-inf"), device=x.device))
    out = neg.amax((1, 2, 3))
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


class Asymm3DSpconv(FlaxNamed):
    """The hybrid voxel encoder: point features scattered onto the grid
    (a voxel's feature the mean of its points'), the context block, two
    stride-2 ``ResBlock``s, then a third and a ``ReconBlock``, and the max
    over the sites of the last two concatenated: (B, 8 · init_size).

    The third level runs dense from ``dense_from`` cells a side down (13,
    where the grid of 50 arrives after two strides; 0 keeps it sparse):
    the volume is densified once and ``DenseResBlock`` and
    ``DenseReconBlock`` take the sparse blocks' places (and flax names).
    bf16 by default (``compute_dtype``), as in the JAX module, whose TPU
    design point it is; None is full f32. ``conv_remat`` recomputes the
    sparse convs' gathered neighbours in the backward.

    ``grid_ind`` (B, N, 3) int in [0, grid_size), ``point_features``
    (B, N, C_in). ``train`` runs the BatchNorms on the batch's statistics
    and moves their running ones. After each call ``sites`` holds, per
    strided sparse conv, its output grid and the sites kept and dropped
    per cloud, and ``dense_occupancy`` the dense level's occupied share
    per cloud (tensors on the device, None when the level is sparse)."""

    def __init__(self, in_channels: int = 1024, init_size: int = 128,
                 grid_size: int = 50, dense_from: int = 13,
                 compute_dtype="bfloat16", conv_remat: bool = False):
        super().__init__()
        c, dt, rm = 4 * init_size, compute_dtype, conv_remat
        self.grid_size = grid_size
        self.child("context", ResContextBlock(in_channels, c, dt, rm))
        self.child("down1", ResBlock(c, c, True, dt, rm))
        self.child("down2", ResBlock(c, c, True, dt, rm))
        g2 = -(-(-(-grid_size // 2)) // 2)
        self.dense = g2 <= dense_from
        if self.dense:
            self.child("down3", DenseResBlock(c, c, True, dt))
            self.child("recon", DenseReconBlock(c, c, dt))
        else:
            self.child("down3", ResBlock(c, c, True, dt, rm))
            self.child("recon", ReconBlock(c, c, dt, rm))
        self.sites: list[dict] = []
        self.dense_occupancy = None

    def forward(self, grid_ind: torch.Tensor, point_features: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        sg = from_point_voxels(grid_ind, point_features, self.grid_size)
        sg = self.context(sg, build_lookup(sg), train)
        down1, _ = self.down1(sg, build_lookup(sg))
        down2, _ = self.down2(down1, build_lookup(down1))
        self.sites = [{"grid": d.grid_size, "kept": d.mask.sum(1),
                       "dropped": d.dropped} for d in (down1, down2)]
        if self.dense:
            dn, occ = sparse_to_dense(down2)
            (down3, occ3), _ = self.down3(dn, occ)
            down4 = self.recon(down3, occ3)
            self.dense_occupancy = occ.flatten(1).float().mean(1)
            a = dense_masked_max(down3, occ3)
            b = dense_masked_max(down4, occ3)
        else:
            down3, _ = self.down3(down2, build_lookup(down2))
            down4 = self.recon(down3, build_lookup(down3))
            self.sites.append({"grid": down3.grid_size,
                               "kept": down3.mask.sum(1),
                               "dropped": down3.dropped})
            self.dense_occupancy = None
            a, b = masked_max(down3), masked_max(down4)
        return torch.cat([a, b], -1)
