"""Completion harness, inference half (counterpart of
``houv_tpu/train/harness.py:CompletionTrainer``).

``CompletionTrainer`` builds the config's model, initialises it from a seed
(``init_state``), runs the no-gt test step (``predict_batch``) and the
validation metrics (``validate``). The latent noise of each batch comes from
a ``torch.Generator`` seeded by (0, batch index), as the JAX harness folds
the batch index into ``PRNGKey(0)``. Training and checkpoints are not ported
yet: ``validate`` tracks the best values but writes no checkpoint
(ROADMAP.md Queue 1, item 11).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from houv_tpu_torch._device import resolve_device
from houv_tpu_torch.data.pipeline import batch_iterator
from houv_tpu_torch.models.common import init_like_flax
from houv_tpu_torch.models.vrcnet import VRCNet
from houv_tpu_torch.train.config import Config
from houv_tpu_torch.utils.meters import AverageValueMeter

logger = logging.getLogger("houv_tpu_torch")

# completion models of the JAX package the port does not run yet
_NOT_PORTED = {
    "pcn": "ROADMAP.md Queue 1, item 11",
    "ecg": "ROADMAP.md Queue 1, item 11, and the wide kNN, Queue 2, item 4",
    "transformer": "ROADMAP.md Queue 1, item 11",
    "vrcnet_knn": "ROADMAP.md Queue 1, items 8 and 11",
}


def model_from_config(cfg: Config) -> VRCNet:
    """The config's completion model; VRCNet only, f32 only."""
    if cfg.model_name != "vrcnet":
        where = _NOT_PORTED.get(cfg.model_name, "ROADMAP.md Queue 1")
        raise NotImplementedError(
            f"completion model {cfg.model_name!r} is not ported yet ({where})")
    if cfg.compute_dtype not in (None, "float32"):
        raise NotImplementedError(
            f"compute_dtype={cfg.compute_dtype!r}: only f32 is ported")
    return VRCNet(
        num_points=cfg.num_points, num_coarse_raw=cfg.num_coarse_raw,
        num_fps=cfg.num_fps, num_coarse=cfg.num_coarse,
        layers=tuple(cfg.layers), knn_list=tuple(cfg.knn_list), pk=cfg.pk,
        points_label=cfg.points_label, local_folding=cfg.local_folding,
        eval_emd=cfg.eval_emd)


def latent_generator(step: int) -> torch.Generator:
    """The latent noise generator of batch ``step``."""
    seed = int(np.random.SeedSequence([0, step]).generate_state(1)[0])
    return torch.Generator().manual_seed(seed)


class CompletionTrainer:
    """VRCNet inference and validation on one device."""

    def __init__(self, cfg: Config, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model_from_config(cfg)
        self.best = {m: (0, float("inf")) for m in ("cd_p", "cd_t")}
        self.best["f1"] = (0, -float("inf"))
        if cfg.eval_emd:
            self.best["emd"] = (0, float("inf"))

    def init_state(self) -> VRCNet:
        """Seeded flax-like initialisation (``manual_seed``, default 2021)."""
        if self.cfg.load_model:
            raise NotImplementedError(
                "checkpoints are not ported yet (ROADMAP.md Queue 1, "
                "item 11)")
        init_like_flax(self.model, torch.Generator().manual_seed(
            self.cfg.manual_seed or 2021))
        self.model.to(self.device).eval()
        return self.model

    def _tensor(self, batch: dict, key: str) -> torch.Tensor:
        return torch.as_tensor(batch[key], device=self.device)

    def predict_batch(self, batch: dict, step: int = 0) -> torch.Tensor:
        """The no-gt test step on one batch: (B, num_points, 3)."""
        with torch.inference_mode():
            return self.model(self._tensor(batch, "partial"), prefix="test",
                              generator=latent_generator(step))["result"]

    def validate(self, val_ds, epoch: int = 0) -> dict:
        """Mean cd_p, cd_t, f1 (and emd with ``eval_emd``) over the full
        batches of ``val_ds``."""
        names = ["cd_p", "cd_t", "f1"]
        if self.cfg.eval_emd:
            names.insert(2, "emd")
        meters = {m: AverageValueMeter() for m in names}
        n_batches = 0
        for i, batch in enumerate(batch_iterator(
                val_ds, self.cfg.batch_size, drop_last=True)):
            with torch.inference_mode():
                out = self.model(self._tensor(batch, "partial"),
                                 self._tensor(batch, "gt"), prefix="val",
                                 generator=latent_generator(i))
            for m, meter in meters.items():
                meter.update(float(out[m].mean()), len(batch["partial"]))
            n_batches += 1
        for m, meter in meters.items():
            better = (meter.avg > self.best[m][1] if m == "f1"
                      else meter.avg < self.best[m][1])
            if better and n_batches:
                self.best[m] = (epoch, meter.avg)
        logger.info("val: " + "".join(
            f"curr_{m}: {v.avg:f}; " for m, v in meters.items()))
        return {m: v.avg for m, v in meters.items()}
