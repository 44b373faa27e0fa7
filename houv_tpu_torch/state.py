"""State carried across from the JAX package, as plain numpy and fields.

``params_from_jax`` turns the output of ``houv_tpu.solvers.houv.init_params``
(converted to numpy by the caller) into the port's parameter tensors, so both
packages can be fed the same restarts. ``config_from_jax`` converts a JAX
``HOUVConfig`` field by field. ``state_from_flax`` turns the flax variables
of a JAX model (any model of the factory, ``PCNTransformer``, or one of
their modules: ``params``, and ``batch_stats`` where the model has
BatchNorm) into the port's ``state_dict``; a cascade-GAN critic
(``train/gan.py:PointDiscriminator``) takes a JAX trainer state's
``d_params`` so. None imports anything of the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from houv_tpu_torch.solvers.houv import _PARAM_NAMES, HOUVConfig

# JAX HOUVConfig fields with no meaning in the port: the Pallas dispatch
# switch and the scatter path's score precision.
_JAX_ONLY = {"use_pallas", "exact_scores"}


def params_from_jax(params: dict[str, np.ndarray],
                    device: str | torch.device) -> dict:
    """JAX ``init_params`` output (as numpy) -> the port's parameter dict,
    ``angle_xyz`` (the Euler angles) included."""
    return {k: torch.tensor(np.asarray(params[k], np.float32), device=device)
            for k in _PARAM_NAMES}


def config_from_jax(jax_cfg) -> HOUVConfig:
    """A JAX ``HOUVConfig`` -> the port's, field by field (the ``_JAX_ONLY``
    fields left out)."""
    return HOUVConfig(**{f.name: getattr(jax_cfg, f.name)
                         for f in dataclasses.fields(jax_cfg)
                         if f.name not in _JAX_ONLY})


def _flax_to_torch(module: nn.Module, tree: dict, prefix: str,
                   out: dict) -> None:
    """Walk a flax parameter tree beside ``module``: each flax child name
    maps to the torch attribute recorded in ``module.flax_names``; a flax
    ``Dense`` kernel (in, out) becomes ``Linear.weight`` (out, in), an
    ``Embed`` table ``Embedding.weight``, and a leaf of a module with
    ``flax_leaves`` the tensor that names (a sparse conv's (K, Cin, Cout)
    and a dense conv's (kx, ky, kz, Cin, Cout) ``kernel`` and
    ``down_kernel`` as they are; BatchNorm's ``scale``, ``bias``, ``mean``
    and ``var`` its ``weight``, ``bias``, ``running_mean`` and
    ``running_var``)."""
    for flax_name, sub in tree.items():
        if not isinstance(sub, dict):
            try:
                attr = module.flax_leaves[flax_name]
            except (AttributeError, KeyError):
                raise KeyError(f"no counterpart of flax '{prefix}{flax_name}'"
                               f" in {type(module).__name__}") from None
            out[f"{prefix}{attr}"] = torch.tensor(
                np.asarray(sub, np.float32))
            continue
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
        elif isinstance(child, nn.Embedding):
            out[f"{prefix}{attr}.weight"] = torch.tensor(
                np.asarray(sub["embedding"], np.float32))
        else:
            _flax_to_torch(child, sub, f"{prefix}{attr}.", out)


def state_from_flax(params: dict, model: nn.Module) -> dict:
    """A JAX model's variables -> a ``state_dict`` for ``model``, the port's
    model of the same class and configuration (``PCN``, ``ECG``,
    ``VRCNet``, ``VRCNetKNN`` with its voxel branch dense from 13³ or fully
    sparse, the learned registration models, the transformers,
    ``InstanceEmbedding``, ``AlignmentClassifier``, ``VoxAsym``, or one of
    their ``FlaxNamed`` modules, given that module's flax variables). ``params`` is the nested
    dict of ``init``'s ``params`` (leaves as numpy arrays), or a dict
    holding it under ``'params'`` and, for a model with BatchNorm, its
    running statistics under ``'batch_stats'`` (either alone gives its
    part of the ``state_dict``) (a checkpoint's two trees;
    other keys, such as an optimizer state, are not model state). Layers
    pair up by flax auto-name (``PCNEncoder_0``, ``ECGDecoder_0``,
    ``DenseConv_2``, ``ResBlock_1``, ``BatchNorm_3``, ``Dense_7``). Every
    flax leaf must have a counterpart; ``model.load_state_dict(...,
    strict=True)`` then checks the converse. Layers pair up by flax
    auto-name (``PCNEncoderLabel_0``, ``Asymm3DSpconv_0``,
    ``DenseResBlock_0`` or ``ResBlock_2``, ``KNNDecoder_0``)."""
    out: dict = {}
    if not {"params", "batch_stats"} & set(params):
        _flax_to_torch(model, params, "", out)
        return out
    for tree in (params.get("params") or {}, params.get("batch_stats") or {}):
        _flax_to_torch(model, tree, "", out)
    return out


# the name it had while VRCNet was the only model carried across
vrcnet_state_from_flax = state_from_flax
