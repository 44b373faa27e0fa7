"""3-NN search and inverse-distance-weighted interpolation.

Counterpart of ``houv_tpu/ops/interpolate.py``. ``three_nn`` is the kNN
kernel (``csrc/knn.cu`` on CUDA tensors) with k = 3; the distances are then
recomputed from the selected pairs in the diff form and floored, which is
exact at coincident points where the expansion form is not.
"""

from __future__ import annotations

import torch

from houv_tpu_torch.ops.grouping import index_points, knn_indices


def three_nn(target: torch.Tensor, source: torch.Tensor):
    """For each target point, its 3 nearest source points.

    (B, N, 3) × (B, M, 3) -> (dist (B, N, 3), idx (B, N, 3) int64); dist is
    the euclidean (not squared) distance, floored at 1e-6 (sqrt of 1e-12)
    so that its gradient stays finite at coincident points."""
    idx = knn_indices(target, source, 3, device=target.device)
    diff = target[:, :, None, :] - index_points(source, idx)  # (B, N, 3, 3)
    dist = torch.sqrt(torch.clamp_min((diff * diff).sum(-1), 1e-12))
    return dist, idx


def three_interpolate(features: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """Weighted sum of 3 gathered source features.

    features (B, C, M), idx (B, N, 3), weight (B, N, 3) -> (B, C, N)."""
    bsz, c, _ = features.shape
    n = idx.shape[1]
    gathered = torch.gather(
        features, 2, idx.reshape(bsz, 1, n * 3).expand(-1, c, -1),
    ).reshape(bsz, c, n, 3)
    return (gathered * weight[:, None]).sum(-1)


def three_nn_upsampling(target: torch.Tensor, source: torch.Tensor):
    """idx + normalised inverse-distance weights for feature upsampling
    (distances clamped at 1e-10)."""
    dist, idx = three_nn(target, source)
    inv = 1.0 / torch.clamp_min(dist, 1e-10)
    return idx, inv / inv.sum(-1, keepdim=True)
