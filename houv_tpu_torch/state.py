"""State carried across from the JAX package, as plain numpy and fields.

``params_from_jax`` turns the output of ``houv_tpu.solvers.houv.init_params``
(converted to numpy by the caller) into the port's parameter tensors, so both
packages can be fed the same restarts. ``config_from_jax`` converts a JAX
``HOUVConfig`` field by field. ``vrcnet_state_from_flax`` turns the JAX
VRCNet's flax parameters into the port's ``state_dict``. None imports
anything of the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from houv_tpu_torch.solvers.houv import _PARAM_NAMES, HOUVConfig

# JAX HOUVConfig fields with no meaning in the port: the Pallas dispatch
# switch, the scatter path's score precision, and tuning knobs of the
# two-bracket and consensus modes, which are not ported.
_JAX_ONLY = {"use_pallas", "exact_scores", "bracket_preference",
             "consensus_angle", "consensus_loss_ratio",
             "consensus_window_ratio"}


def params_from_jax(params: dict[str, np.ndarray],
                    device: str | torch.device) -> dict:
    """JAX ``init_params`` output (as numpy) -> the port's parameter dict.
    ``angle_xyz`` drives only the unported Euler rotation mode and is
    dropped."""
    return {k: torch.tensor(np.asarray(params[k], np.float32), device=device)
            for k in _PARAM_NAMES}


def config_from_jax(jax_cfg) -> HOUVConfig:
    """A JAX ``HOUVConfig`` -> the port's, field by field. Raises
    NotImplementedError for a field the port lacks that is set away from
    its default (the port's own check covers the fields it keeps)."""
    ours = {f.name for f in dataclasses.fields(HOUVConfig)}
    kwargs = {}
    for f in dataclasses.fields(jax_cfg):
        value = getattr(jax_cfg, f.name)
        if f.name in ours:
            kwargs[f.name] = value
        elif f.name not in _JAX_ONLY and value != f.default:
            raise NotImplementedError(
                f"HOUVConfig.{f.name}={value!r} is not ported yet")
    return HOUVConfig(**kwargs)


def _flax_to_torch(module: nn.Module, tree: dict, prefix: str,
                   out: dict) -> None:
    """Walk a flax parameter tree beside ``module``: each flax child name
    maps to the torch attribute recorded in ``module.flax_names``; a flax
    ``Dense`` kernel (in, out) becomes ``Linear.weight`` (out, in)."""
    for flax_name, sub in tree.items():
        try:
            attr = module.flax_names[flax_name]
        except KeyError:
            raise KeyError(f"no counterpart of flax '{prefix}{flax_name}' in "
                           f"{type(module).__name__}") from None
        child = module.get_submodule(attr)
        if isinstance(child, nn.Linear):
            out[f"{prefix}{attr}.weight"] = torch.tensor(
                np.asarray(sub["kernel"], np.float32).T)
            if "bias" in sub:
                out[f"{prefix}{attr}.bias"] = torch.tensor(
                    np.asarray(sub["bias"], np.float32))
        else:
            _flax_to_torch(child, sub, f"{prefix}{attr}.", out)


def vrcnet_state_from_flax(params: dict, model: nn.Module) -> dict:
    """The JAX VRCNet's parameters (the nested dict of ``init``'s
    ``params``, leaves as numpy arrays, with or without the top-level
    ``'params'`` key) -> a ``state_dict`` for ``model``, the port's
    ``models.vrcnet.VRCNet`` of the same configuration (or one of its
    modules, given that module's flax parameters). Every flax name must
    have a counterpart; ``model.load_state_dict(..., strict=True)`` then
    checks the converse."""
    tree = params.get("params", params)
    out: dict = {}
    _flax_to_torch(model, tree, "", out)
    return out
