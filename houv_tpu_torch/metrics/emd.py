"""EMD metric (counterpart of ``houv_tpu/metrics/emd.py``)."""

from __future__ import annotations

import torch

from houv_tpu_torch.ops.emd import emd_auction


def calc_emd(output: torch.Tensor, gt: torch.Tensor, eps: float = 0.005,
             iterations: int = 50) -> torch.Tensor:
    """Mean matched L2 distance per cloud: the square root of the auction
    EMD's squared distances, averaged. The train setting is ε 0.005 with 50
    rounds; VRCNet's validation uses ε 0.004 with 3000."""
    dist, _ = emd_auction(output, gt, eps, iterations)
    return torch.sqrt(dist).mean(-1)
