"""Train and eval harness (counterpart of ``houv_tpu/train/harness.py``'s
``CompletionTrainer`` and ``RegistrationTrainer``; the aux models'
trainers are in ``train/aux.py``).

The trainers share ``_Trainer``: it builds the config's model and
optimizer, initialises the model from a seed or from ``load_model`` (a
checkpoint of the port, or one of the JAX package's, ``init_state``),
trains it (``train_step``, ``fit``, ``fit_steps``: the lr from the
schedule written into the optimizer each step) and saves it, all under
``<work_dir>/<model>_<loss>_<flag>/``. Each trainer adds its model's train
loss, the no-gt test step (``predict_batch``) and the validation metrics
(``validate``, which writes ``best_<metric>_network.ckpt`` when a metric
improves; ``fit`` writes ``network.ckpt``). ``save`` refuses to write over
the file ``load_model`` names: with the yamls' ``work_dir: log/`` that is
where the JAX package's trained checkpoints lie.

Randomness is seeded per step: the latent noise of test or val batch i comes
from a ``torch.Generator`` seeded by (0, i), as the JAX harness folds the
batch index into ``PRNGKey(0)``; the noise, dropout masks and sampled
points of train step s from one seeded by (manual_seed, s).

A trainer runs over a ``mesh`` (``parallel.mesh.Mesh``; without one, over
``local_mesh``, the process alone). Over several ranks it is
data-parallel, as the JAX trainer is under a mesh: every rank builds the
same seeded splits and iterators and takes its rows of each global batch;
the step's draws are the global batch's, sliced (``models.common.RowShard``);
BatchNorm normalises by the global batch's statistics; the gradients are
averaged over the ranks before the optimizer's step, so the replicas stay
equal; validation meters are reduced as sums of value·count, so every rank
keeps the same best checkpoints; ``predict_batch`` returns the whole
batch's predictions on every rank; rank 0 writes the checkpoints.

``use_gan`` trains a completion model as the cascade-GAN's generator
(``train/gan.py``): each step takes a generator step against an LSGAN
critic, then a critic step (Adam at the constant ``lr``, never
scheduled); the critic's gradients are averaged over the ranks like the
model's. Its checkpoints hold the critic and its optimizer state beside
the model's; ``load_model`` restores the model, and the critic starts from
its initialisation, as in the JAX package.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from houv_tpu_torch._device import resolve_device
from houv_tpu_torch.data.pipeline import batch_iterator
from houv_tpu_torch.models import MODELS, get_model
from houv_tpu_torch.models.common import (RowShard, init_like_flax,
                                          set_batch_group)
from houv_tpu_torch.parallel.mesh import (all_gather_rows, all_reduce,
                                          average_gradients, local_mesh,
                                          replicate, shard_batch)
from houv_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from houv_tpu_torch.train.config import Config
from houv_tpu_torch.train.gan import PointDiscriminator, gan_crop, lsgan_losses
from houv_tpu_torch.train.schedules import alpha_schedule, lr_schedule
from houv_tpu_torch.utils.meters import AverageValueMeter, SplitMeterGrid

logger = logging.getLogger("houv_tpu_torch")

# the models each trainer of the port trains (the aux models'
# trainers: train/aux.py)
COMPLETION_MODELS = {"pcn", "ecg", "vrcnet", "vrcnet_knn", "transformer"}
LEARNED_REGISTRATION = {"dcp", "deepgmr", "idam"}
AUX_MODELS = {"model_embedding", "alignment_spconv", "voxel_asym"}
# models that draw random numbers (latent noise, dropout, sampled points)
# and so take a generator; PCN, ECG, the transformer, DCP and DeepGMR draw
# none, vrcnet_knn only its dropout masks, IDAM its train-time sampling
_MODEL_RNGS = {"vrcnet", "vrcnet_knn", "idam"}

# models that take the batch's class labels and voxel indices
_VOXEL_MODELS = {"vrcnet_knn"}


def model_from_config(cfg: Config) -> torch.nn.Module:
    """The config's completion model (pcn, ecg, vrcnet, vrcnet_knn or
    transformer), learned registration model (dcp, deepgmr or idam) or aux
    model (model_embedding, alignment_spconv or voxel_asym): the config's
    keys mapped onto the model's constructor, ``compute_dtype`` to every
    one of them, as the JAX factory does."""
    name, dt = cfg.model_name, cfg.compute_dtype
    if name not in MODELS:
        get_model(name)  # raises: no such model
    if name == "model_embedding":
        return get_model(name, compute_dtype=dt)
    if name in ("alignment_spconv", "voxel_asym"):
        return get_model(name, grid_size=cfg.grid_size, compute_dtype=dt)
    if name == "vrcnet_knn":
        return get_model(
            name, num_native=cfg.num_native, num_coarse=cfg.num_coarse,
            num_fine=cfg.num_fine, feature_size=cfg.feature_size,
            layers=tuple(cfg.layers), knn_list=tuple(cfg.knn_list),
            pk=cfg.pk, voxel_grid_size=cfg.grid_size,
            voxel_init_size=cfg.voxel_init_size, remat=cfg.use_remat,
            compute_dtype=dt, voxel_conv_remat=cfg.voxel_conv_remat,
            fused_cd=cfg.fused_cd)
    if name == "dcp":
        return get_model(name, cycle=cfg.cycle, compute_dtype=dt)
    if name == "deepgmr":
        return get_model(name, use_rri=cfg.use_rri, rri_size=cfg.rri_size,
                         num_groups=cfg.num_groups, compute_dtype=dt)
    if name == "idam":
        return get_model(name, descriptor_size=cfg.descriptor_size,
                         num_iters=cfg.num_iters, compute_dtype=dt)
    if name == "transformer":
        return get_model(name, num_points=cfg.num_points,
                         eval_emd=cfg.eval_emd, compute_dtype=dt)
    kw = dict(num_points=cfg.num_points, num_coarse=cfg.num_coarse,
              train_loss=cfg.loss, eval_emd=cfg.eval_emd, compute_dtype=dt)
    if name == "ecg":
        kw.update(num_input=cfg.num_input or cfg.num_points)
    elif name == "vrcnet":
        kw.update(n_input=cfg.num_input,
                  num_coarse_raw=cfg.num_coarse_raw, num_fps=cfg.num_fps,
                  layers=tuple(cfg.layers), knn_list=tuple(cfg.knn_list),
                  pk=cfg.pk, points_label=cfg.points_label,
                  local_folding=cfg.local_folding, remat=cfg.use_remat,
                  distribution_loss=cfg.distribution_loss)
    return get_model(name, **kw)


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




class _Trainer:
    """What the completion and registration trainers share: the model, its
    optimizer, initialisation and checkpoints, the train step and the
    loops over it. A trainer supplies ``_metrics`` (names, the higher-is-
    better ones in ``_higher``), ``_train_loss`` and ``validate``."""

    _metrics: tuple = ()
    _higher: frozenset = frozenset()

    def __init__(self, cfg: Config, device: str | torch.device = "cuda",
                 mesh=None):
        self.cfg = cfg
        self.mesh = mesh or local_mesh(resolve_device(device))
        self.device = self.mesh.device
        if cfg.batch_size % self.mesh.size:
            raise ValueError(
                f"batch_size {cfg.batch_size} is not divisible by "
                f"n_devices {self.mesh.size}")
        self.model = model_from_config(cfg)
        set_batch_group(self.model, self.mesh.group())
        self.optimizer = _make_optimizer(cfg, self.model.parameters())
        self.seed = cfg.manual_seed or 2021
        self.epoch = 0
        self.log_dir = os.path.join(
            cfg.work_dir, f"{cfg.model_name}_{cfg.loss}_{cfg.flag}")
        self.best = {m: (0, -float("inf") if m in self._higher
                         else float("inf")) for m in self._metrics}

    def _rng(self, generator: torch.Generator) -> dict:
        """The model call's ``generator`` argument, for a model that draws
        random numbers: the global batch's draws sliced to this rank's
        rows."""
        if self.cfg.model_name not in _MODEL_RNGS:
            return {}
        return {"generator": RowShard(generator, self.mesh.index(),
                                      self.mesh.size)}

    def _local(self, batch: dict) -> dict:
        """This rank's rows of a global batch."""
        return shard_batch(batch, self.mesh)

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of ``t``, in rank order."""
        return all_gather_rows(t, self.mesh)

    def _reduce_meters(self, meters) -> None:
        """Each meter's sum and count summed over the ranks (one
        all-reduce, in float64)."""
        meters = list(meters)
        if not meters:
            return
        t = torch.tensor([[m.sum, m.count] for m in meters],
                         dtype=torch.float64, device=self.device)
        t = all_reduce(t, self.mesh).tolist()
        for m, (total, count) in zip(meters, t):
            m.sum, m.count = total, int(count)

    def init_state(self) -> torch.nn.Module:
        """Seeded flax-like initialisation (``manual_seed``, default 2021),
        then ``load_model``'s weights over it: a checkpoint of the port
        (with its optimizer state and epoch, when it has them) or of the
        JAX package (its parameters, running statistics and epoch)."""
        init_like_flax(self.model, torch.Generator().manual_seed(self.seed))
        self.model.to(self.device).eval()
        if self.cfg.load_model:
            self.epoch = load_checkpoint(self.cfg.load_model, self.model,
                                         self.optimizer)
            logger.info("%s's previous weights loaded.", self.cfg.model_name)
        replicate(self.model, self.mesh)
        return self.model

    def save(self, name: str) -> str:
        """``<log_dir>/<name>``; raises ValueError where that is the file
        ``load_model`` names (a JAX checkpoint there would become a
        ``torch.save`` archive the JAX package cannot read)."""
        path = os.path.join(self.log_dir, name)
        if self.cfg.load_model and os.path.realpath(path) == \
                os.path.realpath(self.cfg.load_model):
            raise ValueError(
                f"{path} is the load_model checkpoint; set work_dir or flag "
                "to save elsewhere")
        return save_checkpoint(path, self.model, self.optimizer, self.epoch,
                               mesh=self.mesh, extra=self._extra_state())

    def _extra_state(self) -> dict:
        """What a checkpoint holds beside the model and its optimizer."""
        return {}

    def wrap_dataset(self, ds):
        """A split as this trainer's batches need it (the aux trainers'
        dataset views); the split itself by default."""
        return ds

    def _tensor(self, batch: dict, key: str) -> torch.Tensor:
        return torch.as_tensor(batch[key], device=self.device)

    def train_step(self, batch: dict, epoch: int, step: int) -> torch.Tensor:
        """One optimizer step on ``batch`` at the epoch's lr on
        ``_step_losses``, then ``_after_step``; returns the loss (taken
        before the update). The gradients stay on the
        parameters until the next step; BatchNorm's running statistics
        move here only. ``batch`` is the global batch: the rank takes its
        rows, the gradients (and the loss returned) are the ranks'
        mean."""
        lr = lr_schedule(self.cfg, epoch)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.zero_grad(set_to_none=True)
        local = self._local(batch)
        loss, reported = self._step_losses(local, epoch, step)
        loss.backward()
        average_gradients(self.model.parameters(), self.mesh)
        self.optimizer.step()
        self._after_step(local)
        return all_reduce(reported.detach(), self.mesh) / self.mesh.size

    def _step_losses(self, batch: dict, epoch: int, step: int):
        """(the loss the model's step descends, the loss ``train_step``
        returns) on the rank's rows: ``_train_loss`` for both."""
        loss = self._train_loss(batch, epoch, step)
        return loss, loss

    def _after_step(self, batch: dict) -> None:
        """Work of a train step after the model's update, on the rank's
        rows: none."""

    def fit_steps(self, loader, n_steps: int, epoch_len: int = 1000,
                  val_ds=None) -> torch.nn.Module:
        """Step-based training from a loader with ``next_batch()`` (such
        as ``data.native_loader.NativeRegistrationLoader``), each batch
        moved to the trainer's device as it comes; ``validate`` after the
        last step. The per-step losses are kept in ``self.losses``."""
        meter = AverageValueMeter()
        self.losses = []
        t0 = time.time()
        for step in range(n_steps):
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in loader.next_batch().items()}
            loss = float(self.train_step(batch, step // epoch_len, step))
            meter.update(loss)
            self.losses.append(loss)
            if step % self.cfg.step_interval_to_print == 0:
                logger.info("step %d loss %.6f", step, loss)
        logger.info("fit_steps done: mean loss %.6f (%.1fs)", meter.avg,
                    time.time() - t0)
        if val_ds is not None:
            self.validate(val_ds, epoch=n_steps // epoch_len)
        return self.model

    def fit(self, train_ds, val_ds=None) -> torch.nn.Module:
        """Epochs ``start_epoch`` .. ``nepoch`` over shuffled full batches
        of the splits as ``wrap_dataset`` gives them;
        ``network.ckpt`` after each ``epoch_interval_to_save``-th epoch,
        ``validate`` after each ``epoch_interval_to_val``-th. The per-step
        losses are kept in ``self.losses``."""
        cfg = self.cfg
        train_ds = self.wrap_dataset(train_ds)
        if val_ds is not None:
            val_ds = self.wrap_dataset(val_ds)
        meter = AverageValueMeter()
        self.losses = []
        global_step = 0
        profiler = self._start_profile()
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
                if profiler is not None and global_step >= cfg.profile_steps:
                    profiler = self._stop_profile(profiler)
            logger.info("epoch %d done: mean loss %.6f (%.1fs)", epoch,
                        meter.avg, time.time() - t0)
            if epoch % cfg.epoch_interval_to_save == 0:
                self.save("network.ckpt")
            if val_ds is not None and epoch % cfg.epoch_interval_to_val == 0:
                self.validate(val_ds, epoch)
        if profiler is not None:
            self._stop_profile(profiler)
        return self.model

    def _start_profile(self):
        """With ``profile_dir`` set, a started ``torch.profiler`` over the
        host and, on the card, the device, for the first ``profile_steps``
        train steps of ``fit``; else None."""
        if not self.cfg.profile_dir:
            return None
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        return prof

    def _stop_profile(self, prof) -> None:
        """Stop ``prof`` and write its Chrome trace into ``profile_dir`` as
        ``trace_rank<r>.json``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        os.makedirs(self.cfg.profile_dir, exist_ok=True)
        path = os.path.join(self.cfg.profile_dir,
                            f"trace_rank{self.mesh.rank}.json")
        prof.export_chrome_trace(path)
        logger.info("profile written to %s", path)
        return None

    def _keep_best(self, meters: dict, epoch: int, n_batches: int) -> None:
        """``best_<metric>_network.ckpt`` for each tracked metric (in
        ``best``) that improved."""
        for m, meter in meters.items():
            if m not in self.best:
                continue
            better = (meter.avg > self.best[m][1] if m in self._higher
                      else meter.avg < self.best[m][1])
            if better and n_batches:
                self.best[m] = (epoch, meter.avg)
                self.save(f"best_{m}_network.ckpt")
                logger.info("Best %s net saved!", m)
        logger.info("val: " + "".join(
            f"curr_{m}: {v.avg:f}; " for m, v in meters.items()))


class CompletionTrainer(_Trainer):
    """Training, validation and inference of a completion model (pcn, ecg,
    vrcnet, vrcnet_knn, transformer), on one device or data-parallel over a
    mesh; with ``use_gan`` against an LSGAN critic (``train/gan.py``), for
    a model without BatchNorm statistics."""

    _higher = frozenset({"f1"})

    def __init__(self, cfg: Config, device: str | torch.device = "cuda",
                 mesh=None):
        if cfg.model_name in LEARNED_REGISTRATION:
            raise ValueError(f"{cfg.model_name!r} is a registration model: "
                             "train it with RegistrationTrainer")
        if cfg.model_name in AUX_MODELS:
            raise ValueError(f"{cfg.model_name!r} is an aux model: train it "
                             "with its trainer of train/aux.py")
        self._metrics = ("cd_p", "cd_t", "f1") + (
            ("emd",) if cfg.eval_emd else ())
        super().__init__(cfg, device, mesh)
        self.critic = None
        if cfg.use_gan:
            if any(name.endswith("running_mean")
                   for name, _ in self.model.named_buffers()):
                raise NotImplementedError(
                    "use_gan supports models without batch_stats")
            self.critic = PointDiscriminator()
            # never scheduled, no weight decay (optax.adam(cfg.lr))
            self.critic_optimizer = torch.optim.Adam(
                self.critic.parameters(), lr=cfg.lr,
                betas=(cfg.betas[0], cfg.betas[-1]))
            self.critic_loss = self._fake = None

    def init_state(self) -> torch.nn.Module:
        """``_Trainer.init_state``; under ``use_gan`` the critic from its
        own seeded initialisation (``load_model`` does not restore it)."""
        super().init_state()
        if self.critic is not None:
            init_like_flax(self.critic, _seeded(self.seed, 17))
            self.critic.to(self.device)
            replicate(self.critic, self.mesh)
        return self.model

    def _extra_state(self) -> dict:
        if self.critic is None:
            return {}
        return {"critic": self.critic.state_dict(),
                "critic_optimizer": self.critic_optimizer.state_dict()}

    def _step_losses(self, batch: dict, epoch: int, step: int):
        """Under ``use_gan`` the generator's half of the GAN step, in the
        JAX package's order: one forward; the model descends
        mean((D(fake) − 1)²) + gan_weight · total_loss, the critic's
        current weights taking no gradient; ``train_step`` returns the
        model's ``total_loss``. The fake cloud is kept for
        ``_after_step``."""
        if self.critic is None:
            return super()._step_losses(batch, epoch, step)
        out = self._train_out(batch, epoch, step)
        self._fake = out["out2"][:, :gan_crop(self.cfg.num_points)]
        self.critic.requires_grad_(False)
        try:
            d_fake = self.critic(self._fake)
        finally:
            self.critic.requires_grad_(True)
        adv, _ = lsgan_losses(d_fake, torch.zeros_like(d_fake))
        return adv + self.cfg.gan_weight * out["total_loss"], \
            out["total_loss"]

    def _after_step(self, batch: dict) -> None:
        """Under ``use_gan`` the critic's step on the generator's fake
        cloud, detached, against the ground truth (repeated whole,
        ``torch.cat``, where the model's fine cloud has a multiple of its
        batch); its loss (the ranks' mean) is kept in ``critic_loss``."""
        if self.critic is None:
            return
        fake, self._fake = self._fake.detach(), None
        crop = gan_crop(self.cfg.num_points)
        gt = self._tensor(batch, "gt")
        if gt.shape[0] != fake.shape[0]:
            gt = torch.cat([gt] * (fake.shape[0] // gt.shape[0]))
        self.critic_optimizer.zero_grad(set_to_none=True)
        _, d_loss = lsgan_losses(self.critic(fake),
                                 self.critic(gt[:, :crop]))
        d_loss.backward()
        average_gradients(self.critic.parameters(), self.mesh)
        self.critic_optimizer.step()
        self.critic_loss = all_reduce(d_loss.detach(),
                                      self.mesh) / self.mesh.size

    def _inputs(self, batch: dict, epoch: int | None = None) -> dict:
        """The model call's inputs beside the clouds: vrcnet_knn's class
        labels and voxel indices (None where the batch has none); for the
        other models, in a train step (``epoch`` given), the epoch's
        alpha, the weight of the fine cloud's loss."""
        if self.cfg.model_name not in _VOXEL_MODELS:
            return {} if epoch is None else {
                "alpha": alpha_schedule(self.cfg, epoch)}
        return {k: self._tensor(batch, k).long() if k in batch else None
                for k in ("label", "coords")}

    def _train_out(self, batch: dict, epoch: int, step: int) -> dict:
        return self.model(self._tensor(batch, "partial"),
                          self._tensor(batch, "gt"), prefix="train",
                          **self._inputs(batch, epoch),
                          **self._rng(_seeded(self.seed, step)))

    def _train_loss(self, batch: dict, epoch: int, step: int):
        return self._train_out(batch, epoch, step)["total_loss"]

    def predict_batch(self, batch: dict, step: int = 0) -> torch.Tensor:
        """The no-gt test step on one batch: (B, num_points, 3); for
        vrcnet_knn its fine cloud, (B, num_coarse + num_points, 3)."""
        batch = self._local(batch)
        with torch.inference_mode():
            return self._gather(self.model(
                self._tensor(batch, "partial"), prefix="test",
                **self._inputs(batch),
                **self._rng(latent_generator(step)))["result"])

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
            batch = self._local(batch)
            with torch.inference_mode():
                out = self.model(self._tensor(batch, "partial"),
                                 self._tensor(batch, "gt"), prefix="val",
                                 **self._inputs(batch),
                                 **self._rng(latent_generator(i)))
            for m, meter in meters.items():
                meter.update(float(out[m].mean()), len(batch["partial"]))
            n_batches += 1
        self._reduce_meters(meters.values())
        self._keep_best(meters, epoch, n_batches)
        return {m: v.avg for m, v in meters.items()}


class RegistrationTrainer(_Trainer):
    """Training, validation and inference of a learned registration model
    (dcp, deepgmr, idam), on one device or data-parallel over a mesh. Its
    train loss is the model's
    ``loss``; validation tracks RotE, transE, MSE (geodesic rotation plus
    translation error), RMSE and recall (RMSE < 0.1) over all pairs and by
    (rot_level, match_level) bucket."""

    _metrics = ("RotE", "transE", "MSE", "RMSE", "recall")
    _higher = frozenset({"recall"})

    def __init__(self, cfg: Config, device: str | torch.device = "cuda",
                 mesh=None):
        if cfg.model_name not in LEARNED_REGISTRATION:
            raise ValueError(f"{cfg.model_name!r} is not a learned "
                             "registration model (dcp, deepgmr, idam)")
        super().__init__(cfg, device, mesh)

    def _clouds(self, batch: dict):
        return self._tensor(batch, "src"), self._tensor(batch, "tgt")

    def _train_loss(self, batch: dict, epoch: int, step: int):
        out = self.model(*self._clouds(batch),
                         self._tensor(batch, "transform"), prefix="train",
                         train=True, **self._rng(_seeded(self.seed, step)))
        return out["loss"]

    def predict_batch(self, batch: dict, step: int = 0) -> torch.Tensor:
        """The no-gt test step on one batch: the (B, 4, 4) transforms
        aligning each src to its tgt."""
        batch = self._local(batch)
        with torch.inference_mode():
            return self._gather(self.model(
                *self._clouds(batch), None, prefix="test", train=False,
                **self._rng(latent_generator(step))))

    def validate(self, val_ds, epoch: int = 0,
                 rmse_thresh: float = 0.1) -> dict:
        """Mean RotE, transE, MSE, RMSE and recall over the full batches of
        ``val_ds``, logged also by (rot_level, match_level) bucket where
        the split has them; a metric that improved on its best writes
        ``best_<metric>_network.ckpt``."""
        meters = {m: AverageValueMeter() for m in self._metrics}
        grid = SplitMeterGrid()
        n_batches = 0
        for batch in batch_iterator(val_ds, self.cfg.batch_size,
                                    drop_last=True):
            batch = self._local(batch)
            with torch.inference_mode():
                out = self.model(*self._clouds(batch),
                                 self._tensor(batch, "transform"),
                                 prefix="val", train=False)
            rmse = out["rmse"].cpu().numpy()
            vals = {"RotE": out["r_err"].cpu().numpy(),
                    "transE": out["t_err"].cpu().numpy(),
                    "MSE": out["rt_mse"].cpu().numpy(), "RMSE": rmse,
                    "recall": (rmse < rmse_thresh).astype(np.float32)}
            for m, arr in vals.items():
                meters[m].update(float(arr.mean()), len(batch["src"]))
            if "rot_level" in batch and "match_level" in batch:
                grid.update(batch["rot_level"], batch["match_level"], vals)
            n_batches += 1
        self._reduce_meters(meters.values())
        self._reduce_meters(m for row in grid.grid for cell in row
                            for m in cell.values())
        self._keep_best(meters, epoch, n_batches)
        for line in grid.logs():
            logger.info(line)
        return {m: v.avg for m, v in meters.items()}
