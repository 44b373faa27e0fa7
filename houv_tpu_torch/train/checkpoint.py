"""Checkpoints of the port (counterpart of ``houv_tpu/train/checkpoint.py``).

A checkpoint is a ``torch.save`` of ``{"model": state_dict, "optimizer":
state_dict, "epoch": int}``; a file holding a bare model ``state_dict``
loads too. The JAX package's checkpoints (flax msgpack) are not read here:
its parameters are carried over as numpy arrays by
``houv_tpu_torch.state.vrcnet_state_from_flax``.
"""

from __future__ import annotations

import os

import torch


def save_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer | None = None,
                    epoch: int = 0) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    state = {"model": model.state_dict(), "epoch": int(epoch)}
    if optimizer is not None:
        state["optimizer"] = optimizer.state_dict()
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer | None = None) -> int:
    """Load ``path`` into ``model`` (strictly) and, when both are there,
    into ``optimizer``. Returns the checkpoint's epoch (0 for a model-only
    file). Tensors land on the device the model already lies on."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if "model" not in state:            # a bare state_dict
        state = {"model": state}
    model.load_state_dict(state["model"], strict=True)
    if optimizer is not None and "optimizer" in state:
        optimizer.load_state_dict(state["optimizer"])
    return int(state.get("epoch", 0))
