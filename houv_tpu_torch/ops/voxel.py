"""Voxel indices of points, voxel means, occupancy grids and voxel-mean
feature grids (counterpart of ``houv_tpu/ops/voxel.py``:
``voxel_grid_indices``, ``voxelize_mean``, ``voxelize_occupancy``,
``voxelize_features_mean``).

Grid convention of the reference: with volume [min_b, max_b] and grid size
G, interval = (max_b - min_b) / (G - 1) and index = floor((clip(x) - min_b)
/ interval), clipped to [0, G - 1]. The division is an f32 division by the
f32-rounded interval, as in the JAX package: a point on a cell boundary
lands in the same voxel there and here. (PyTorch turns a division by a
Python number on the card into a multiplication by its reciprocal, which
moves boundary points; so the interval goes in as a tensor.)

``voxelize_mean`` sums each voxel's points and counts them with one K4
scatter (``ops/scatter.py:scatter_add``, the CUDA kernel on the card) of
[1, x, y, z]: each sum starts from +0.0 and adds in point order, as the
JAX package's ``.at[].add`` does on the CPU. ``voxelize_features_mean``
scatters [1, features] likewise, in K4 launches of at most 8 channels;
``voxelize_occupancy`` marks the voxels whose K4 count is not 0.
"""

from __future__ import annotations

import torch

from houv_tpu_torch.ops.scatter import scatter_add


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


def voxelize_mean(xyz: torch.Tensor, grid_size: int = 50,
                  min_bound: float = -0.5, max_bound: float = 0.5):
    """Mean point per occupied voxel: (B, N, 3) -> (voxel_points (B, N, 3),
    counts (B,) int64). The occupied voxels' means fill the first
    ``counts[b]`` rows in flat voxel order (as ``np.unique`` orders them);
    the other rows are zero."""
    bsz, n, _ = xyz.shape
    g = grid_size
    flat = _flat_voxels(xyz, g, min_bound, max_bound)
    xyz = xyz.float()
    sums = scatter_add(flat, torch.cat([torch.ones_like(xyz[..., :1]), xyz],
                                       -1), g ** 3, device=xyz.device)
    cnt = sums[..., 0]
    occupied = cnt > 0
    means = sums[..., 1:] / torch.clamp_min(cnt, 1.0)[..., None]
    # occupied voxel j goes to row (#occupied before it); the rest to row n,
    # dropped (each occupied voxel holds a point, so fewer than n of them)
    dest = torch.where(occupied, torch.cumsum(occupied, 1) - 1, n)
    out = torch.zeros((bsz, n + 1, 3), dtype=torch.float32,
                      device=xyz.device)
    out.scatter_(1, dest[..., None].expand(-1, -1, 3), means)
    return out[:, :n], occupied.sum(1)


def _flat_voxels(xyz, grid_size, min_bound, max_bound) -> torch.Tensor:
    ind = voxel_grid_indices(xyz, grid_size, min_bound, max_bound)
    return (ind[..., 0] * grid_size + ind[..., 1]) * grid_size + ind[..., 2]


def voxelize_occupancy(xyz: torch.Tensor, grid_size: int = 50,
                       min_bound: float = -0.5,
                       max_bound: float = 0.5) -> torch.Tensor:
    """(B, N, 3) -> (B, G, G, G) f32 occupancy: 1 where a point falls."""
    g = grid_size
    flat = _flat_voxels(xyz, g, min_bound, max_bound)
    ones = torch.ones((*flat.shape, 1), dtype=torch.float32,
                      device=xyz.device)
    cnt = scatter_add(flat, ones, g ** 3, device=xyz.device)[..., 0]
    return (cnt > 0).float().reshape(-1, g, g, g)


def voxelize_features_mean(xyz: torch.Tensor, features: torch.Tensor,
                           grid_size: int = 50, min_bound: float = -0.5,
                           max_bound: float = 0.5) -> torch.Tensor:
    """(B, N, 3) points, (B, N, C) features -> (B, G, G, G, C) f32: each
    voxel's mean feature over its points, 0 where it holds none."""
    g = grid_size
    feats = features.float()
    flat = _flat_voxels(xyz, g, min_bound, max_bound)
    vals = torch.cat([torch.ones_like(feats[..., :1]), feats], -1)
    # K4 takes at most 8 channels a launch
    sums = torch.cat([scatter_add(flat, vals[..., c:c + 8], g ** 3,
                                  device=vals.device)
                      for c in range(0, vals.shape[-1], 8)], -1)
    means = sums[..., 1:] / torch.clamp_min(sums[..., :1], 1.0)
    return means.reshape(-1, g, g, g, feats.shape[-1])
