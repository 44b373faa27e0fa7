"""Typed configuration read from the repository's ``cfgs/*.yaml``.

Counterpart of ``houv_tpu/train/config.py`` for the keys the HOUV sweep
(its rescored mode included), the completion, learned registration and
auxiliary models (the instance embedding, the alignment classifier, the
voxel-occupancy net), their datasets (ModelNet's too), sweeps and
training read. Unknown keys land in ``extras``, as they do there. The
reference's comma-separated lists ("2, 2, 2, 2", "0.01, 0.1, 0.5, 1") are
parsed into tuples.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import yaml


def _parse_tuple(v, typ) -> tuple | None:
    """'2, 2, 2, 2', [2, 2, 2, 2] or 2 -> a tuple of ``typ``; None stays."""
    if v is None:
        return None
    if isinstance(v, str):
        v = v.split(",")
    elif not isinstance(v, (list, tuple)):
        v = [v]
    return tuple(typ(x.strip() if isinstance(x, str) else x) for x in v)


_TUPLE_FIELDS = {
    "betas": float,
    "varying_constant": float,
    "varying_constant_epochs": int,
    "lr_step_decay_epochs": int,
    "lr_step_decay_rates": float,
    "layers": int,
    "knn_list": int,
}


@dataclasses.dataclass
class Config:
    # experiment
    model_name: str = "houv"
    flag: str = "debug"
    work_dir: str = "log/"
    load_model: str | None = None    # a checkpoint of train/checkpoint.py
    manual_seed: int | None = None

    # data
    dataset: str = "mvp_rg"
    data_path: str | None = None
    num_points: int = 2048
    # points of a partial scan, where they differ from num_points (MVP's
    # scans hold 2048 at every resolution of the ground truth); the model
    # fixes its stages from it, and the synthetic split is made at it
    num_input: int | None = None
    batch_size: int = 32
    max_angle: float = 45.0          # registration pose synthesis (degrees)
    max_trans: float = 0.5
    # ModelNet variant (dataset: modelnet): clean | noisy | unseen | icl_nuim
    variant: str = "clean"
    category: int | None = None
    # size of the synthetic fallback split (None = 128 train / 64 other)
    synthetic_size: int | None = None
    # synthetic fixture shapes: 'blobs' | 'structured' (panel/bar objects
    # with MVP-like chamfer statistics, what the quality gates use)
    synthetic_shape: str = "blobs"
    scale_aug: bool = True           # completion train split only
    # 'bfloat16' runs a model's layers in bf16 where the JAX model does
    # (flax dtype=bf16, cast by cast); parameters, optimizer state and
    # running statistics stay f32
    compute_dtype: str | None = None

    # optimization
    nepoch: int = 100
    start_epoch: int = 0
    lr: float = 1e-4
    lr_decay: bool = True
    lr_decay_interval: int | None = 40
    lr_decay_rate: float = 0.7
    lr_step_decay_epochs: tuple | None = None
    lr_step_decay_rates: tuple | None = None
    lr_clip: float = 1e-6
    optimizer: str = "Adam"
    weight_decay: float = 0.0
    betas: tuple = (0.9, 0.999)
    varying_constant: tuple | None = (0.01, 0.1, 0.5, 1.0)
    varying_constant_epochs: tuple | None = (5, 15, 30)
    step_interval_to_print: int = 500
    epoch_interval_to_save: int = 1
    epoch_interval_to_val: int = 1

    # completion loss / eval
    loss: str = "cd"
    eval_emd: bool = False
    # the cascade-GAN branch (train/gan.py): an LSGAN critic on the fine
    # output; generator loss = adversarial + gan_weight * completion loss
    use_gan: bool = False
    gan_weight: float = 200.0

    # completion model hyperparameters (VRCNet)
    layers: tuple = (2, 2, 2, 2)
    knn_list: tuple = (10, 20)
    pk: int = 10
    points_label: bool = False
    local_folding: bool = False
    num_coarse: int = 1024
    num_coarse_raw: int = 1024
    num_fps: int = 2048
    # vrcnet_knn: the fine and the FPS-native clouds, and the width of the
    # global feature beside the voxel branch's (the JAX model reads neither
    # this nor the port: the width follows from the two branches)
    num_fine: int = 3072
    num_native: int = 2048
    feature_size: int = 2048
    distribution_loss: str = "KLD"
    # recompute the SK-SA units (vrcnet_knn: the whole SA-SKN encoder) in
    # the backward (batch headroom); no effect at inference
    use_remat: bool = False
    # vrcnet_knn: recompute the voxel branch's sparse conv bodies in the
    # backward instead of keeping their gathered neighbours
    voxel_conv_remat: bool = False
    # vrcnet_knn: the train loss's three chamfers as one, over the clouds
    # stacked on the batch axis (padded, masked)
    fused_cd: bool = False
    # vrcnet_knn: the voxel branch's init channel width (4x inside the
    # blocks, 8x the feature it returns)
    voxel_init_size: int = 128

    # learned registration: DCP's cycle-consistency term; DeepGMR's
    # rotation-invariant features over rri_size neighbours (else centred
    # coordinates) and its mixture components; IDAM's descriptor width
    # (its similarity iterations are num_iters)
    cycle: bool = False
    use_rri: bool = True
    rri_size: int = 20
    num_groups: int = 16
    descriptor_size: int = 64
    # the native C++ prefetching loader (native/houv_loader.cpp) for the
    # learned registration models: step-based training by fit_steps,
    # native_steps steps (0: nepoch times the split's batches)
    use_native_loader: bool = False
    native_steps: int = 0

    # HOUV solver (solvers/houv.py HOUVConfig)
    kernel: int = 64
    num_epochs: int = 500            # solver steps (reference naming)
    houv_lr: float = 0.1
    retry_threshold: float = 0.030
    angle_passes: int = 4
    retry_mode: str = "threshold"
    use_view_loss: bool = False
    houv_reparam: str = "sine"
    houv_objective: str = "trunc"
    two_bracket: bool = False
    nn_refresh: int = 1
    nn_refresh_schedule: str | None = None  # "N:R[:S],..." phases | "auto"
    window_select: str = "loss"
    # the classical solvers' iterations (train -c with icp, goicp, fgr;
    # goicp_bnb's BnB levels), each under its own floor in icp_eval_main;
    # IDAM's similarity iterations
    num_iters: int = 3
    # classifier-rescored restart selection (solvers/rescore.py): the
    # alignment classifier's checkpoint (a JAX flax msgpack file), its
    # voxel grid (also vrcnet_knn's and its dataset's), the candidates per
    # pair, their rotation-NMS angle, the logit margin an override needs
    # and the test-time rotations (1 = off)
    rescore_ckpt: str | None = None
    grid_size: int = 50
    rescore_cands: int = 16
    rescore_angle: float = 10.0
    rescore_margin: float = 0.0
    rescore_tta: int = 1
    # ranks of a sweep or of training (parallel/; unset: every visible card,
    # one process on the CPU)
    n_devices: int | None = None
    # a torch.profiler trace (Chrome JSON) of the first profile_steps train
    # steps of fit, written into profile_dir
    profile_dir: str | None = None
    profile_steps: int = 10

    extras: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Config":
        fields = {f.name for f in dataclasses.fields(cls)} - {"extras"}
        cfg = cls(**{k: _parse_tuple(v, _TUPLE_FIELDS[k])
                     if k in _TUPLE_FIELDS else v
                     for k, v in d.items() if k in fields})
        cfg.extras = {k: v for k, v in d.items() if k not in fields}
        return cfg


def parse_refresh_schedule(s: str | None) -> tuple | str | None:
    """'400:5,100:2' -> ((400, 5), (100, 2)); 'auto' passes through;
    None or '' -> None."""
    if not s:
        return None
    if s == "auto":
        return s
    return tuple(
        tuple(int(v) for v in part.split(":")) for part in s.split(",")
    )


def load_config(path: str) -> Config:
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    return Config.from_dict(raw)
