"""Completion models of the port, by config name (counterpart of
``houv_tpu/models/__init__.py:get_model`` for the models ported)."""

from houv_tpu_torch.models.ecg import ECG
from houv_tpu_torch.models.pcn import PCN, PCNEncoder
from houv_tpu_torch.models.vrcnet import VRCNet

MODELS = {"pcn": PCN, "ecg": ECG, "vrcnet": VRCNet}


def get_model(name: str, **kwargs):
    """The model class registered under ``name``, constructed."""
    try:
        cls = MODELS[name]
    except KeyError:
        raise NotImplementedError(
            f"model {name!r} is not ported yet; the port has "
            f"{sorted(MODELS)}") from None
    return cls(**kwargs)


__all__ = ["ECG", "MODELS", "PCN", "PCNEncoder", "VRCNet", "get_model"]
