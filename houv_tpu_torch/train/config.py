"""Typed configuration read from the repository's ``cfgs/*.yaml``.

Counterpart of ``houv_tpu/train/config.py`` for the keys the HOUV sweep,
the VRCNet completion sweep and VRCNet training read. Keys of other models
land in ``extras``, as unknown keys do there. The reference's
comma-separated lists ("2, 2, 2, 2", "0.01, 0.1, 0.5, 1") are parsed into
tuples.
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
    batch_size: int = 32
    max_angle: float = 45.0          # registration pose synthesis (degrees)
    max_trans: float = 0.5
    category: int | None = None
    # size of the synthetic fallback split (None = 128 train / 64 other)
    synthetic_size: int | None = None
    # synthetic fixture shapes: 'blobs' | 'structured' (panel/bar objects
    # with MVP-like chamfer statistics, what the quality gates use)
    synthetic_shape: str = "blobs"
    scale_aug: bool = True           # completion train split only
    # 'bfloat16' AMP is not ported: None (f32) only
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
    use_gan: bool = False            # the cascade-GAN branch: not ported

    # completion model hyperparameters (VRCNet)
    layers: tuple = (2, 2, 2, 2)
    knn_list: tuple = (10, 20)
    pk: int = 10
    points_label: bool = False
    local_folding: bool = False
    num_coarse: int = 1024
    num_coarse_raw: int = 1024
    num_fps: int = 2048
    distribution_loss: str = "KLD"
    # recompute the SK-SA units in the backward (batch headroom); no effect
    # at inference, and the parameters keep their names either way
    use_remat: bool = False

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
    # classifier-rescored selection and multi-device sweeps: not ported
    rescore_ckpt: str | None = None
    n_devices: int | None = None

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
