"""Cascade-GAN training of the completion models, LSGAN form (counterpart of
``houv_tpu/train/gan.py``).

- generator loss = mean((D(fake) − 1)²) + gan_weight · completion loss
- critic loss    = 0.5 · (mean(D(fake)²) + mean((D(real) − 1)²))

``fake`` is the first ``crop`` points (2048, or ``num_points`` where that is
fewer) of the model's fine cloud, ``real`` the same crop of the ground
truth. The step itself is ``CompletionTrainer.train_step`` under
``use_gan`` (``train/harness.py``): the generator steps first against the
critic's current weights, then the critic steps on the same fake cloud,
detached. The critic runs no kernel of its own: a PointNet of dense layers
and a max over the points.
"""

from __future__ import annotations

import torch
from torch import nn

from houv_tpu_torch.models.common import FlaxNamed, PointMLP, max_pool_points


class PointDiscriminator(FlaxNamed):
    """PointNet critic: (B, N, 3) -> (B,) real-valued score. Layers named
    as flax names them (``PointMLP_0``, ``Dense_0``, ``Dense_1``), so
    ``state.state_from_flax`` carries a JAX critic's ``d_params``
    across."""

    def __init__(self):
        super().__init__()
        self.child("mlp", PointMLP((64, 128, 256), 3, relu_last=True))
        self.child("fc0", nn.Linear(256, 128))
        self.child("fc1", nn.Linear(128, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # a flax Dense promotes its input to the parameters' dtype
        x = x.to(torch.promote_types(x.dtype, self.fc0.weight.dtype))
        g = max_pool_points(self.mlp(x))
        return self.fc1(torch.relu(self.fc0(g)))[..., 0]


def lsgan_losses(d_fake: torch.Tensor, d_real: torch.Tensor):
    """(generator adversarial loss, critic loss), LSGAN form."""
    g_loss = ((d_fake - 1.0) ** 2).mean()
    d_loss = 0.5 * ((d_fake ** 2).mean() + ((d_real - 1.0) ** 2).mean())
    return g_loss, d_loss


def gan_crop(num_points: int) -> int:
    """The points of each cloud the critic sees."""
    return min(2048, num_points)
