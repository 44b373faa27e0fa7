"""Epoch-level schedules (counterpart of ``houv_tpu/train/schedules.py``):
pure functions of (config, epoch)."""

from __future__ import annotations

from houv_tpu_torch.train.config import Config


def alpha_schedule(cfg: Config, epoch: int) -> float | None:
    """The fine term's loss weight: ``varying_constant`` steps up at
    ``varying_constant_epochs`` (0.01 -> 0.1 -> 0.5 -> 1 at epochs 5, 15, 30
    by default)."""
    if not cfg.varying_constant:
        return None
    epochs = cfg.varying_constant_epochs or ()
    for ind, ep in enumerate(epochs):
        if epoch < ep:
            return cfg.varying_constant[ind]
    return cfg.varying_constant[len(epochs)]


def lr_schedule(cfg: Config, epoch: int) -> float:
    """Multiplicative interval decay or step decay, clipped at lr_clip."""
    lr = cfg.lr
    if cfg.lr_decay:
        if cfg.lr_decay_interval:
            lr = cfg.lr * cfg.lr_decay_rate ** (epoch // cfg.lr_decay_interval)
        elif cfg.lr_step_decay_epochs:
            for ep, rate in zip(cfg.lr_step_decay_epochs,
                                cfg.lr_step_decay_rates):
                if epoch >= ep:
                    lr *= rate
        if cfg.lr_clip:
            lr = max(lr, cfg.lr_clip)
    return lr
