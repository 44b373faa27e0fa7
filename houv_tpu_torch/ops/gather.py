"""Row and neighbour gathers (counterpart of ``houv_tpu/ops/gather.py``).

The TPU package gathered rows as a one-hot matmul because its native row
gather was slow there; on the GPU ``torch.gather`` is the direct form.
"""

from __future__ import annotations

import torch


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (B, M, C), idx (B, L) int64 -> (B, L, C)."""
    return torch.gather(
        table, 1, idx[..., None].expand(-1, -1, table.shape[-1]))


def gather_edge_features(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """kNN neighbour gather: (B, U, C) × (B, M, k) int64 -> (B, M, k, C)."""
    b, m, k = idx.shape
    return gather_rows(x, idx.reshape(b, m * k)).reshape(b, m, k, x.shape[-1])
