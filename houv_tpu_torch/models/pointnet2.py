"""PointNet++ set abstraction and feature propagation, and the points
sampler (counterpart of ``houv_tpu/models/pointnet2.py``).

Layout: features last, (B, N, C). ``PointSAModule`` samples its centres by
FPS (``ops/sampling.py``, the K2 kernel on the card), groups each centre's
neighbourhood by ball query, or by kNN (the K6 kernel) where a radius is
None, and max-pools a per-group ``PointMLP``; several radii are the MSG
variant. ``PointFPModule`` upsamples features to a denser cloud by
inverse-distance weights over its three nearest points (K6), then a
``PointMLP``. ``points_sampler`` picks centre indices by 'd-fps'
(euclidean FPS), 'f-fps' (FPS over distances in [coordinates, features])
or 'random' (distinct indices drawn from a ``torch.Generator``; they
cannot equal ``jax.random.choice``'s).
"""

from __future__ import annotations

from typing import Sequence

import torch

from houv_tpu_torch.models.common import FlaxNamed, PointMLP
from houv_tpu_torch.ops.chamfer import pairwise_sqdist
from houv_tpu_torch.ops.grouping import index_points, query_and_group
from houv_tpu_torch.ops.interpolate import (three_interpolate,
                                            three_nn_upsampling)
from houv_tpu_torch.ops.sampling import (furthest_point_sample,
                                         furthest_point_sample_with_dist)


def points_sampler(points: torch.Tensor, num: int, strategy: str = "d-fps",
                   features: torch.Tensor | None = None,
                   generator: torch.Generator | None = None) -> torch.Tensor:
    """(B, N, 3) -> (B, num) int64 sample indices: 'd-fps', 'f-fps' (over
    [points, features] when ``features`` (B, N, C) is given) or 'random'
    (``num`` distinct indices a cloud, from ``generator``, drawn on the
    CPU)."""
    if strategy == "d-fps":
        return furthest_point_sample(points, num, device=points.device)
    if strategy == "f-fps":
        feats = points if features is None else torch.cat(
            [points, features], -1)
        return furthest_point_sample_with_dist(
            pairwise_sqdist(feats, feats), num)
    if strategy == "random":
        if generator is None:
            raise ValueError("random strategy needs a torch.Generator")
        b, n, _ = points.shape
        idx = torch.stack([torch.randperm(n, generator=generator)[:num]
                           for _ in range(b)])
        return idx.to(points.device)
    raise ValueError(f"unknown strategy {strategy!r}")


class PointSAModule(FlaxNamed):
    """Set abstraction: ``npoint`` centres by FPS, each radius's group
    (ball query, or kNN where the radius is None) through its own
    ``PointMLP`` and max-pooled. ``in_features`` is the point features'
    width C (0 without features). Returns (new_xyz (B, npoint, 3),
    new_features (B, npoint, sum of the MLPs' last widths))."""

    def __init__(self, npoint: int, in_features: int = 0,
                 radii: Sequence[float | None] = (0.2,),
                 nsamples: Sequence[int] = (32,),
                 mlps: Sequence[Sequence[int]] = ((64, 64, 128),),
                 use_xyz: bool = True):
        super().__init__()
        self.npoint, self.use_xyz = npoint, use_xyz
        self.radii, self.nsamples = tuple(radii), tuple(nsamples)
        width = in_features + (3 if use_xyz or not in_features else 0)
        self.mlps = torch.nn.ModuleList()
        for i, mlp in enumerate(mlps):
            self.mlps.append(self.child(
                f"mlps.{i}", PointMLP(tuple(mlp), width, relu_last=True)))

    def forward(self, xyz: torch.Tensor, features: torch.Tensor | None = None,
                train: bool = False):
        idx = furthest_point_sample(xyz, self.npoint, device=xyz.device)
        new_xyz = index_points(xyz, idx)
        feats_cm = None if features is None else features.transpose(1, 2)
        outs = []
        for radius, nsample, mlp in zip(self.radii, self.nsamples,
                                        self.mlps):
            grouped = query_and_group(xyz, new_xyz, feats_cm,
                                      nsample=nsample, max_radius=radius,
                                      use_xyz=self.use_xyz)
            h = mlp(grouped.permute(0, 2, 3, 1))     # (B, npoint, ns, C)
            outs.append(h.amax(2))
        return new_xyz, torch.cat(outs, -1)


class PointFPModule(FlaxNamed):
    """Feature propagation: the source features at each target point, by
    inverse-distance weights over its three nearest source points, beside
    the target's own features (``target_features`` wide, 0 without them),
    through a ``PointMLP``. -> (B, N_target, mlp[-1])."""

    def __init__(self, source_features: int, target_features: int = 0,
                 mlp: Sequence[int] = (128, 128)):
        super().__init__()
        self.child("mlp", PointMLP(tuple(mlp),
                                   source_features + target_features,
                                   relu_last=True))

    def forward(self, target_xyz: torch.Tensor, source_xyz: torch.Tensor,
                target_feats: torch.Tensor | None,
                source_feats: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        idx, w = three_nn_upsampling(target_xyz, source_xyz)
        up = three_interpolate(source_feats.transpose(1, 2), idx,
                               w).transpose(1, 2)
        if target_feats is not None:
            up = torch.cat([target_feats, up], -1)
        return self.mlp(up)
