from houv_tpu_torch.geometry.kabsch import kabsch, weighted_kabsch
from houv_tpu_torch.geometry.rotations import (
    normalize_translation,
    rmse_loss,
    rodrigues,
    rotation_error,
    rotation_geodesic_error,
    rt_to_transformation,
    translation_error,
)

__all__ = [
    "kabsch", "normalize_translation", "rmse_loss", "rodrigues",
    "rotation_error", "rotation_geodesic_error", "rt_to_transformation",
    "translation_error", "weighted_kabsch",
]
