from houv_tpu_torch.models.pcn import PCNEncoder
from houv_tpu_torch.models.vrcnet import VRCNet

__all__ = ["PCNEncoder", "VRCNet"]
