"""2-D image ops the reference re-exports from mmcv (counterpart of
``houv_tpu/ops/image.py``): ``sigmoid_focal_loss`` and ``roi_align``, which
the MVP workloads do not call. Plain PyTorch on the tensors' device (NMS is
``ops/boxes.py:nms_bev``)."""

from __future__ import annotations

import torch


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       gamma: float = 2.0, alpha: float = 0.25,
                       reduction: str = "mean") -> torch.Tensor:
    """mmcv's focal loss for {0, 1} targets: -α_t (1 - p_t)^γ log p_t with
    a stable BCE with logits; 'mean', 'sum' or per element."""
    p = torch.sigmoid(logits)
    ce = (torch.clamp_min(logits, 0) - logits * targets
          + torch.log1p(torch.exp(-torch.abs(logits))))
    p_t = p * targets + (1 - p) * (1 - targets)
    alpha_t = alpha * targets + (1 - alpha) * (1 - targets)
    loss = alpha_t * (1 - p_t) ** gamma * ce
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def _bilinear(feat: torch.Tensor, y: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """feat (C, H, W), y and x (...) -> (..., C) bilinear samples, the
    coordinates clamped to the map."""
    h, w = feat.shape[1], feat.shape[2]
    y0 = torch.clamp(torch.floor(y), 0, h - 1)
    x0 = torch.clamp(torch.floor(x), 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    wy = torch.clamp(y - y0, 0.0, 1.0)
    wx = torch.clamp(x - x0, 0.0, 1.0)
    y0i, y1i, x0i, x1i = (a.long() for a in (y0, y1, x0, x1))
    top = feat[:, y0i, x0i] * (1 - wx) + feat[:, y0i, x1i] * wx
    bot = feat[:, y1i, x0i] * (1 - wx) + feat[:, y1i, x1i] * wx
    return torch.movedim(top * (1 - wy) + bot * wy, 0, -1)


def roi_align(features: torch.Tensor, rois: torch.Tensor,
              output_size: int = 7, spatial_scale: float = 1.0,
              sampling_ratio: int = 2) -> torch.Tensor:
    """RoIAlign with mmcv's ``aligned=True``: features (B, C, H, W), rois
    (R, 5) as (batch index, x1, y1, x2, y2) -> (R, C, out, out), each bin
    the mean of sampling_ratio² bilinear samples at the half-pixel-shifted
    grid."""
    out, sr = output_size, sampling_ratio
    rois = rois.float()
    dev = features.device
    grid = torch.arange(out, dtype=torch.float32, device=dev)
    sub = (torch.arange(sr, dtype=torch.float32, device=dev) + 0.5) / sr
    iy = grid[:, None, None, None] + sub[None, :, None, None]
    ix = grid[None, None, :, None] + sub[None, None, None, :]
    res = []
    for roi in rois:
        x1, y1, x2, y2 = (roi[i] * spatial_scale - 0.5 for i in range(1, 5))
        bw = torch.clamp_min(x2 - x1, 1e-6) / out
        bh = torch.clamp_min(y2 - y1, 1e-6) / out
        ys = (y1 + iy * bh).expand(out, sr, out, sr)
        xs = (x1 + ix * bw).expand(out, sr, out, sr)
        samples = _bilinear(features[int(roi[0])], ys, xs)
        res.append(torch.movedim(samples.mean((1, 3)), -1, 0))
    return torch.stack(res) if res else features.new_zeros(
        (0, features.shape[1], out, out))
