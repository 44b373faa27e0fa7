"""Models of the port, by config name (counterpart of
``houv_tpu/models/__init__.py:get_model`` for the models ported): the
completion models, the learned registration models and the registration
rescorer's alignment classifier."""

from houv_tpu_torch.models.alignment import AlignmentClassifier
from houv_tpu_torch.models.dcp import DCP
from houv_tpu_torch.models.deepgmr import DeepGMR
from houv_tpu_torch.models.ecg import ECG
from houv_tpu_torch.models.embedding import TransformerCompletion
from houv_tpu_torch.models.idam import IDAM
from houv_tpu_torch.models.pcn import PCN, PCNEncoder
from houv_tpu_torch.models.vrcnet import VRCNet
from houv_tpu_torch.models.vrcnet_knn import VRCNetKNN

MODELS = {"pcn": PCN, "ecg": ECG, "vrcnet": VRCNet, "vrcnet_knn": VRCNetKNN,
          "transformer": TransformerCompletion, "dcp": DCP,
          "deepgmr": DeepGMR, "idam": IDAM,
          "alignment_spconv": AlignmentClassifier}
# models of the JAX package's factory the port lacks, by the ROADMAP.md
# Queue 1 items that port them
_NOT_PORTED = {"voxel_asym": "items 8b and 12", "model_embedding": "item 12"}


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


__all__ = ["AlignmentClassifier", "DCP", "DeepGMR", "ECG", "IDAM", "MODELS",
           "PCN", "PCNEncoder", "TransformerCompletion", "VRCNet",
           "VRCNetKNN", "get_model"]
