"""Shared model blocks (counterpart of ``houv_tpu/models/common.py``).

Layout: features last, (B, N, C), as in the JAX package; a flax ``Dense`` is
an ``nn.Linear`` over the last axis. ``FlaxNamed`` modules record, for each
child layer, the auto-name flax gives the same layer (``Dense_3``,
``SKNResUnit_2``), so ``houv_tpu_torch.state.vrcnet_state_from_flax`` can
carry JAX parameters across name by name. ``EFExpansion`` needs the wide
kNN and is not ported yet (ROADMAP.md Queue 2, item 4).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from houv_tpu_torch.ops.gather import gather_edge_features, gather_rows
from houv_tpu_torch.ops.grouping import knn_points
from houv_tpu_torch.ops.sampling import furthest_point_sample


class FlaxNamed(nn.Module):
    """A module whose children carry their flax auto-names.

    ``child(attr, module)`` registers ``module`` under ``attr`` and names it
    ``<Class>_<i>`` in ``flax_names``, counting per class in the order the
    flax module constructs its layers (``nn.Linear`` counts as ``Dense``)."""

    def __init__(self):
        super().__init__()
        self.flax_names: dict[str, str] = {}
        self._flax_counts: dict[str, int] = {}

    def child(self, attr: str, module: nn.Module) -> nn.Module:
        cls = "Dense" if isinstance(module, nn.Linear) else \
            type(module).__name__
        i = self._flax_counts.get(cls, 0)
        self._flax_counts[cls] = i + 1
        self.flax_names[f"{cls}_{i}"] = attr
        if "." not in attr:
            setattr(self, attr, module)
        return module


def init_like_flax(model: nn.Module, generator: torch.Generator) -> None:
    """flax ``Dense`` initialisation, drawn from ``generator`` in module
    order: lecun-normal kernels (a normal truncated at ±2σ, scaled to
    variance 1 / fan_in) and zero biases, so that an untrained port has the
    JAX model's scale."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Linear):
                std = math.sqrt(1.0 / m.in_features) / 0.87962566103423978
                w = torch.empty(m.weight.shape)
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()


def max_pool_points(x: torch.Tensor) -> torch.Tensor:
    """Global feature: max over the point axis. (B, N, C) -> (B, C)."""
    return x.amax(-2)


def gen_grid_up(up_ratio: int, grid_size: float = 0.2) -> torch.Tensor:
    """(up_ratio, 2) grid offsets for folding decoders."""
    sqrted = int(math.sqrt(up_ratio)) + 1
    num_x, num_y = 1, up_ratio
    for i in reversed(range(1, sqrted + 1)):
        if up_ratio % i == 0:
            num_x, num_y = i, up_ratio // i
            break
    gx = np.linspace(-grid_size, grid_size, num_x, dtype=np.float32)
    gy = np.linspace(-grid_size, grid_size, num_y, dtype=np.float32)
    x, y = np.meshgrid(gx, gy, indexing="ij")
    return torch.from_numpy(np.stack([x, y], -1).reshape(up_ratio, 2))


def get_edge_features(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) × (B, M, k) -> (B, M, k, C) neighbour features."""
    return gather_edge_features(x, idx)


def get_graph_feature(x: torch.Tensor, k: int = 20,
                      minus_center: bool = True) -> torch.Tensor:
    """DGCNN edge features: (B, N, C) -> (B, N, k, 2C), [center, neighbour -
    center] (or [center, neighbour]). Its kNN runs in the feature space, so
    for C > 8 it runs only on CPU tensors until the wide kernel is ported."""
    idx = knn_points(x, x, k)[1]
    neighbors = get_edge_features(x, idx)
    center = x[:, :, None, :].expand_as(neighbors)
    if minus_center:
        return torch.cat([center, neighbors - center], -1)
    return torch.cat([center, neighbors], -1)


def edge_preserve_sampling(features: torch.Tensor, points: torch.Tensor,
                           num_samples: int, k: int = 10,
                           precomputed: tuple | None = None):
    """FPS + neighbourhood-max pooling.

    features (B, N, C), points (B, N, 3) ->
    (pooled (B, M, 2C), fps_idx (B, M), sampled points (B, M, 3)).
    ``precomputed``: the (p_idx, pn_idx, sampled) triple of
    ``vrcnet.saskn_geometry``."""
    if precomputed is not None:
        p_idx, pn_idx, sampled = precomputed
    else:
        p_idx = furthest_point_sample(points, num_samples,
                                      device=points.device)
        sampled = gather_rows(points, p_idx)
        pn_idx = knn_points(sampled, points, min(k, points.shape[1]))[1]
    neighbor = get_edge_features(features, pn_idx).amax(2)   # (B, M, C)
    center = gather_rows(features, p_idx)
    return torch.cat([center, neighbor], -1), p_idx, sampled
