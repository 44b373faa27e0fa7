"""Sparse-conv blocks of the asymmetric voxel encoder (counterpart of
``houv_tpu/models/voxelnet.py``: ``SubMConv``, ``SparseDownConv``,
``_masked_bn``, ``ResContextBlock``, ``ResBlock``), the trunk of the
alignment classifier (``models/alignment.py``).

Factorised submanifold kernels (1,3,3) and (3,1,3), 9 taps each, no bias;
the strided conv has 27 taps. Activations are leaky ReLU at slope 0.01
(flax's default), BatchNorm runs in eval mode over the valid rows with the
running statistics, ε = 1e-5. Each block is ``FlaxNamed``: its children
carry the flax auto-names (``SubMConv_2``, ``BatchNorm_1``), so
``state.state_from_flax`` carries a JAX checkpoint across; the conv kernels
keep flax's (K, Cin, Cout) layout.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from houv_tpu_torch.models.common import FlaxNamed
from houv_tpu_torch.ops.sparse_conv import SparseGrid, sparse_conv_down, subm_conv


def _lecun_kernel(k: int, cin: int, cout: int) -> nn.Parameter:
    """flax's lecun-normal for a (K, Cin, Cout) kernel: fan_in K·Cin, a
    normal truncated at ±2σ."""
    std = math.sqrt(1.0 / (k * cin)) / 0.87962566103423978
    w = torch.empty((k, cin, cout))
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std)
    return nn.Parameter(w)


class SubMConv(nn.Module):
    """Submanifold conv with a factorised kernel, no bias."""

    flax_leaves = {"kernel": "kernel"}

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size=(3, 3, 3), compute_dtype=None):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.compute_dtype = compute_dtype
        self.kernel = _lecun_kernel(int(np.prod(kernel_size)), in_channels,
                                    out_channels)

    def forward(self, sg: SparseGrid, lookup: torch.Tensor) -> SparseGrid:
        return subm_conv(sg, lookup, self.kernel, self.kernel_size,
                         self.compute_dtype)


class SparseDownConv(nn.Module):
    """Strided sparse conv (kernel 3, padding 1), exact spconv sites; the
    output grid's ``dropped`` counts sites beyond its capacity."""

    flax_leaves = {"kernel": "kernel"}

    def __init__(self, in_channels: int, out_channels: int,
                 stride=(2, 2, 2), compute_dtype=None):
        super().__init__()
        self.stride = tuple(stride)
        self.compute_dtype = compute_dtype
        self.kernel = _lecun_kernel(27, in_channels, out_channels)

    def forward(self, sg: SparseGrid, lookup: torch.Tensor) -> SparseGrid:
        return sparse_conv_down(sg, lookup, self.kernel, self.stride,
                                self.compute_dtype)


class MaskedBatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` in eval mode, (x − mean) · (rsqrt(var + ε) ·
    scale) + bias with the running statistics, rows outside the mask set
    to 0 (the reference's BatchNorm1d over the ragged voxel list)."""

    flax_class = "BatchNorm"
    flax_leaves = {"scale": "weight", "bias": "bias", "mean": "running_mean",
                   "var": "running_var"}

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, sg: SparseGrid) -> SparseGrid:
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        feats = (sg.features - self.running_mean) * mul + self.bias
        feats = torch.where(sg.mask[..., None], feats, 0.0)
        return SparseGrid(feats, sg.coords, sg.mask, sg.grid_size)


def _act(sg: SparseGrid) -> SparseGrid:
    """Leaky ReLU at flax's slope, 0.01."""
    return SparseGrid(nn.functional.leaky_relu(sg.features, 0.01),
                      sg.coords, sg.mask, sg.grid_size)


class ResContextBlock(FlaxNamed):
    """(1x3x3 -> 3x1x3) beside (3x1x3 -> 1x3x3), each conv followed by
    leaky ReLU and masked BatchNorm, summed."""

    def __init__(self, in_channels: int, out_filters: int,
                 compute_dtype=None):
        super().__init__()
        c, dt = out_filters, compute_dtype
        self.child("short1", SubMConv(in_channels, c, (1, 3, 3), dt))
        self.child("short1_bn", MaskedBatchNorm(c))
        self.child("short2", SubMConv(c, c, (3, 1, 3), dt))
        self.child("short2_bn", MaskedBatchNorm(c))
        self.child("res1", SubMConv(in_channels, c, (3, 1, 3), dt))
        self.child("res1_bn", MaskedBatchNorm(c))
        self.child("res2", SubMConv(c, c, (1, 3, 3), dt))
        self.child("res2_bn", MaskedBatchNorm(c))

    def forward(self, sg: SparseGrid, lookup: torch.Tensor) -> SparseGrid:
        short = self.short1_bn(_act(self.short1(sg, lookup)))
        short = self.short2_bn(_act(self.short2(short, lookup)))
        res = self.res1_bn(_act(self.res1(sg, lookup)))
        res = self.res2_bn(_act(self.res2(res, lookup)))
        return SparseGrid(res.features + short.features, sg.coords, sg.mask,
                          sg.grid_size)


class ResBlock(FlaxNamed):
    """(3x1x3 -> 1x3x3) beside (1x3x3 -> 3x1x3), leaky ReLU after each conv,
    summed, then the strided conv: stride (2,2,2) with ``height_pooling``,
    else (2,2,1). Returns (pooled, pre-pool)."""

    def __init__(self, in_channels: int, out_filters: int,
                 height_pooling: bool = True, compute_dtype=None):
        super().__init__()
        c, dt = out_filters, compute_dtype
        self.child("short1", SubMConv(in_channels, c, (3, 1, 3), dt))
        self.child("short2", SubMConv(c, c, (1, 3, 3), dt))
        self.child("res1", SubMConv(in_channels, c, (1, 3, 3), dt))
        self.child("res2", SubMConv(c, c, (3, 1, 3), dt))
        stride = (2, 2, 2) if height_pooling else (2, 2, 1)
        self.child("pool", SparseDownConv(c, c, stride, dt))

    def forward(self, sg: SparseGrid, lookup: torch.Tensor):
        short = _act(self.short2(_act(self.short1(sg, lookup)), lookup))
        res = _act(self.res2(_act(self.res1(sg, lookup)), lookup))
        res = SparseGrid(res.features + short.features, sg.coords, sg.mask,
                         sg.grid_size)
        return self.pool(res, lookup), res
