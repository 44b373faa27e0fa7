"""Voxel indices of points (counterpart of ``houv_tpu/ops/voxel.py``'s
``voxel_grid_indices``).

Grid convention of the reference: with volume [min_b, max_b] and grid size
G, interval = (max_b - min_b) / (G - 1) and index = floor((clip(x) - min_b)
/ interval), clipped to [0, G - 1]. The division is an f32 division by the
f32-rounded interval, as in the JAX package: a point on a cell boundary
lands in the same voxel there and here. (PyTorch turns a division by a
Python number on the card into a multiplication by its reciprocal, which
moves boundary points; so the interval goes in as a tensor.)
"""

from __future__ import annotations

import torch


def voxel_grid_indices(xyz: torch.Tensor, grid_size: int = 50,
                       min_bound: float = -0.5,
                       max_bound: float = 0.5) -> torch.Tensor:
    """(..., N, 3) points -> (..., N, 3) int64 voxel indices in
    [0, grid_size - 1]."""
    interval = torch.tensor((max_bound - min_bound) / (grid_size - 1),
                            dtype=torch.float32, device=xyz.device)
    clipped = torch.clamp(xyz.float(), min_bound, max_bound)
    idx = torch.floor((clipped - min_bound) / interval).long()
    return torch.clamp(idx, 0, grid_size - 1)
