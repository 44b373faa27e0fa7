from houv_tpu_torch.geometry.kabsch import kabsch, weighted_kabsch
from houv_tpu_torch.geometry.rotations import (
    axis_angle_from_matrix,
    mat2euler,
    normalize_translation,
    quat2mat,
    random_pose,
    rmse_loss,
    rodrigues,
    rotation_error,
    rotation_from_axis_angle,
    rotation_geodesic_error,
    rotation_xyz,
    rt_to_transformation,
    transform_points,
    translation_error,
)

__all__ = [
    "axis_angle_from_matrix", "mat2euler", "quat2mat", "random_pose",
    "rotation_from_axis_angle", "rotation_xyz", "transform_points",
    "kabsch", "normalize_translation", "rmse_loss", "rodrigues",
    "rotation_error", "rotation_geodesic_error", "rt_to_transformation",
    "translation_error", "weighted_kabsch",
]
