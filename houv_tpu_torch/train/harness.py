"""Completion harness (counterpart of
``houv_tpu/train/harness.py:CompletionTrainer``).

``CompletionTrainer`` builds the config's model and optimizer, initialises
the model from a seed or from ``load_model`` (``init_state``), trains it
(``train_step``, ``fit``, ``fit_steps``: alpha and lr from the schedules,
the lr written into the optimizer each step), runs the no-gt test step
(``predict_batch``) and the validation metrics (``validate``, which writes
``best_<metric>_network.ckpt`` when a metric improves; ``fit`` writes
``network.ckpt``), all under ``<work_dir>/<model>_<loss>_<flag>/``.

Randomness is seeded per step: the latent noise of test or val batch i comes
from a ``torch.Generator`` seeded by (0, i), as the JAX harness folds the
batch index into ``PRNGKey(0)``; the noise and dropout masks of train step s
from one seeded by (manual_seed, s).
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from houv_tpu_torch._device import resolve_device
from houv_tpu_torch.data.pipeline import batch_iterator
from houv_tpu_torch.models.common import init_like_flax
from houv_tpu_torch.models.vrcnet import VRCNet
from houv_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from houv_tpu_torch.train.config import Config
from houv_tpu_torch.train.schedules import alpha_schedule, lr_schedule
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
            f"compute_dtype={cfg.compute_dtype!r}: only f32 is ported "
            "(ROADMAP.md Queue 1, item 11)")
    return VRCNet(
        num_points=cfg.num_points, num_coarse_raw=cfg.num_coarse_raw,
        num_fps=cfg.num_fps, num_coarse=cfg.num_coarse,
        layers=tuple(cfg.layers), knn_list=tuple(cfg.knn_list), pk=cfg.pk,
        points_label=cfg.points_label, local_folding=cfg.local_folding,
        eval_emd=cfg.eval_emd, remat=cfg.use_remat,
        distribution_loss=cfg.distribution_loss, train_loss=cfg.loss)


def _seeded(*entropy: int) -> torch.Generator:
    seed = int(np.random.SeedSequence(list(entropy)).generate_state(1)[0])
    return torch.Generator().manual_seed(seed)


def latent_generator(step: int) -> torch.Generator:
    """The latent noise generator of test or val batch ``step``."""
    return _seeded(0, step)


def _make_optimizer(cfg: Config, params) -> torch.optim.Optimizer:
    """Adam, or AdamW when ``weight_decay`` is set; eps 1e-8 outside the
    square root, where optax places it too."""
    if cfg.optimizer.lower() not in ("adam", "adamw"):
        raise NotImplementedError(cfg.optimizer)
    betas = (cfg.betas[0], cfg.betas[-1])
    if cfg.weight_decay:
        return torch.optim.AdamW(params, lr=cfg.lr, betas=betas,
                                 weight_decay=cfg.weight_decay)
    return torch.optim.Adam(params, lr=cfg.lr, betas=betas)


class CompletionTrainer:
    """VRCNet training, validation and inference on one device."""

    def __init__(self, cfg: Config, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        if cfg.use_gan:
            raise NotImplementedError(
                "use_gan (the cascade-GAN branch) is not ported yet "
                "(ROADMAP.md Queue 1, item 11)")
        self.model = model_from_config(cfg)
        self.optimizer = _make_optimizer(cfg, self.model.parameters())
        self.seed = cfg.manual_seed or 2021
        self.epoch = 0
        self.log_dir = os.path.join(
            cfg.work_dir, f"{cfg.model_name}_{cfg.loss}_{cfg.flag}")
        self.best = {m: (0, float("inf")) for m in ("cd_p", "cd_t")}
        self.best["f1"] = (0, -float("inf"))
        if cfg.eval_emd:
            self.best["emd"] = (0, float("inf"))

    def init_state(self) -> VRCNet:
        """Seeded flax-like initialisation (``manual_seed``, default 2021),
        then ``load_model``'s weights (and optimizer state and epoch, when
        the checkpoint has them) over it."""
        init_like_flax(self.model, torch.Generator().manual_seed(self.seed))
        self.model.to(self.device).eval()
        if self.cfg.load_model:
            self.epoch = load_checkpoint(self.cfg.load_model, self.model,
                                         self.optimizer)
            logger.info("%s's previous weights loaded.", self.cfg.model_name)
        return self.model

    def save(self, name: str) -> str:
        return save_checkpoint(os.path.join(self.log_dir, name), self.model,
                               self.optimizer, self.epoch)

    def _tensor(self, batch: dict, key: str) -> torch.Tensor:
        return torch.as_tensor(batch[key], device=self.device)

    def train_step(self, batch: dict, epoch: int, step: int) -> torch.Tensor:
        """One optimizer step on ``batch`` at the epoch's alpha and lr;
        returns the total loss (taken before the update). The gradients
        stay on the parameters until the next step."""
        lr = lr_schedule(self.cfg, epoch)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.zero_grad(set_to_none=True)
        out = self.model(self._tensor(batch, "partial"),
                         self._tensor(batch, "gt"), prefix="train",
                         alpha=alpha_schedule(self.cfg, epoch),
                         generator=_seeded(self.seed, step))
        loss = out["total_loss"]
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def fit_steps(self, loader, n_steps: int, epoch_len: int = 1000,
                  val_ds=None) -> VRCNet:
        """Step-based training from a loader with ``next_batch()``."""
        meter = AverageValueMeter()
        t0 = time.time()
        for step in range(n_steps):
            loss = float(self.train_step(loader.next_batch(),
                                         step // epoch_len, step))
            meter.update(loss)
            if step % self.cfg.step_interval_to_print == 0:
                logger.info("step %d loss %.6f", step, loss)
        logger.info("fit_steps done: mean loss %.6f (%.1fs)", meter.avg,
                    time.time() - t0)
        if val_ds is not None:
            self.validate(val_ds, epoch=n_steps // epoch_len)
        return self.model

    def fit(self, train_ds, val_ds=None) -> VRCNet:
        """Epochs ``start_epoch`` .. ``nepoch`` over shuffled full batches;
        ``network.ckpt`` after each ``epoch_interval_to_save``-th epoch,
        ``validate`` after each ``epoch_interval_to_val``-th. The per-step
        losses are kept in ``self.losses``."""
        cfg = self.cfg
        meter = AverageValueMeter()
        self.losses = []
        global_step = 0
        for epoch in range(cfg.start_epoch, cfg.nepoch):
            self.epoch = epoch
            meter.reset()
            t0 = time.time()
            for batch in batch_iterator(train_ds, cfg.batch_size,
                                        shuffle=True, drop_last=True,
                                        seed=self.seed + epoch):
                loss = float(self.train_step(batch, epoch, global_step))
                meter.update(loss)
                self.losses.append(loss)
                if global_step % cfg.step_interval_to_print == 0:
                    logger.info("epoch %d step %d loss %.6f", epoch,
                                global_step, loss)
                global_step += 1
            logger.info("epoch %d done: mean loss %.6f (%.1fs)", epoch,
                        meter.avg, time.time() - t0)
            if epoch % cfg.epoch_interval_to_save == 0:
                self.save("network.ckpt")
            if val_ds is not None and epoch % cfg.epoch_interval_to_val == 0:
                self.validate(val_ds, epoch)
        return self.model

    def predict_batch(self, batch: dict, step: int = 0) -> torch.Tensor:
        """The no-gt test step on one batch: (B, num_points, 3)."""
        with torch.inference_mode():
            return self.model(self._tensor(batch, "partial"), prefix="test",
                              generator=latent_generator(step))["result"]

    def validate(self, val_ds, epoch: int = 0) -> dict:
        """Mean cd_p, cd_t, f1 (and emd with ``eval_emd``) over the full
        batches of ``val_ds``; a metric that improved on its best writes
        ``best_<metric>_network.ckpt``."""
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
                self.save(f"best_{m}_network.ckpt")
                logger.info("Best %s net saved!", m)
        logger.info("val: " + "".join(
            f"curr_{m}: {v.avg:f}; " for m, v in meters.items()))
        return {m: v.avg for m, v in meters.items()}
