"""Models of the port, by config name (counterpart of
``houv_tpu/models/__init__.py:get_model``): the completion models, the
learned registration models and the auxiliary models (the alignment
classifier, the voxel-occupancy net, the instance embedding); and, as the
JAX package exports them, PointNet++'s set-abstraction and
feature-propagation modules and the points sampler."""

from houv_tpu_torch.models.alignment import (AlignmentClassifier, VoxAsym,
                                             alignment_bce_loss,
                                             make_aligned_pairs)
from houv_tpu_torch.models.dcp import DCP
from houv_tpu_torch.models.deepgmr import DeepGMR
from houv_tpu_torch.models.ecg import ECG
from houv_tpu_torch.models.embedding import (InstanceEmbedding,
                                             PCNTransformer,
                                             TransformerCompletion,
                                             triplet_loss)
from houv_tpu_torch.models.idam import IDAM
from houv_tpu_torch.models.pcn import PCN, PCNEncoder
from houv_tpu_torch.models.pointnet2 import (PointFPModule, PointSAModule,
                                             points_sampler)
from houv_tpu_torch.models.vrcnet import VRCNet
from houv_tpu_torch.models.vrcnet_knn import VRCNetKNN

MODELS = {"pcn": PCN, "ecg": ECG, "vrcnet": VRCNet, "vrcnet_knn": VRCNetKNN,
          "transformer": TransformerCompletion, "dcp": DCP,
          "deepgmr": DeepGMR, "idam": IDAM,
          "alignment_spconv": AlignmentClassifier, "voxel_asym": VoxAsym,
          "model_embedding": InstanceEmbedding}


def get_model(name: str, **kwargs):
    """The model class registered under ``name``, constructed."""
    try:
        cls = MODELS[name]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; available: "
                       f"{sorted(MODELS)}") from None
    return cls(**kwargs)


__all__ = ["AlignmentClassifier", "DCP", "DeepGMR", "ECG", "IDAM",
           "InstanceEmbedding", "MODELS", "PCN", "PCNEncoder",
           "PCNTransformer", "PointFPModule", "PointSAModule",
           "TransformerCompletion", "VRCNet", "VRCNetKNN", "VoxAsym",
           "alignment_bce_loss", "get_model", "make_aligned_pairs",
           "points_sampler", "triplet_loss"]
