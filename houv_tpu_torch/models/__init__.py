"""Models of the port, by config name (counterpart of
``houv_tpu/models/__init__.py:get_model`` for the models ported): the
completion models and the registration rescorer's alignment classifier."""

from houv_tpu_torch.models.alignment import AlignmentClassifier
from houv_tpu_torch.models.ecg import ECG
from houv_tpu_torch.models.pcn import PCN, PCNEncoder
from houv_tpu_torch.models.vrcnet import VRCNet
from houv_tpu_torch.models.vrcnet_knn import VRCNetKNN

MODELS = {"pcn": PCN, "ecg": ECG, "vrcnet": VRCNet, "vrcnet_knn": VRCNetKNN,
          "alignment_spconv": AlignmentClassifier}
# models of the JAX package's factory the port lacks, by the ROADMAP.md
# Queue 1 items that port them
_NOT_PORTED = {"transformer": "item 11", "voxel_asym": "items 8b and 12",
               "model_embedding": "item 12",
               "dcp": "item 12", "deepgmr": "item 12", "idam": "item 12"}


def get_model(name: str, **kwargs):
    """The model class registered under ``name``, constructed."""
    try:
        cls = MODELS[name]
    except KeyError:
        item = _NOT_PORTED.get(name)
        where = "ROADMAP.md Queue 1" + (f", {item}" if item else "")
        raise NotImplementedError(
            f"model {name!r} is not ported yet ({where}); the port has "
            f"{sorted(MODELS)}") from None
    return cls(**kwargs)


__all__ = ["AlignmentClassifier", "ECG", "MODELS", "PCN", "PCNEncoder",
           "VRCNet", "VRCNetKNN", "get_model"]
