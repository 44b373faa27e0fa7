"""PCN encoder (counterpart of ``houv_tpu/models/pcn.py:PCNEncoder``).
The PCN model itself is not ported yet (ROADMAP.md Queue 1, item 11)."""

from __future__ import annotations

import torch
from torch import nn

from houv_tpu_torch.models.common import FlaxNamed, max_pool_points


class PCNEncoder(FlaxNamed):
    """(B, N, 3) -> (B, output_size) global feature: a two-stage PointNet
    with the first stage's global feature concatenated to every point."""

    def __init__(self, output_size: int = 1024):
        super().__init__()
        self.child("fc1", nn.Linear(3, 128))
        self.child("fc2", nn.Linear(128, 256))
        self.child("fc3", nn.Linear(512, 512))
        self.child("fc4", nn.Linear(512, output_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc2(torch.relu(self.fc1(x)))
        g = max_pool_points(h)
        h = torch.cat([h, g[:, None, :].expand_as(h)], -1)
        return max_pool_points(self.fc4(torch.relu(self.fc3(h))))
