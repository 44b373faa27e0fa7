from houv_tpu_torch.ops.boxes import (
    assign_score_withk,
    boxes_iou_bev,
    boxes_iou_bev_sampled,
    boxes_overlap_bev,
    nms_bev,
    points_in_boxes,
)
from houv_tpu_torch.ops.chamfer import (
    chamfer_indices,
    chamfer_reference,
    nn_select,
    pairwise_sqdist,
)
from houv_tpu_torch.ops.emd import emd_auction, emd_auction_with_stats
from houv_tpu_torch.ops.gather import gather_edge_features, gather_rows
from houv_tpu_torch.ops.grouping import (
    ball_query,
    gather_points,
    grouping_operation,
    index_points,
    knn,
    knn_indices,
    knn_points,
    query_and_group,
)
from houv_tpu_torch.ops.image import roi_align, sigmoid_focal_loss
from houv_tpu_torch.ops.interpolate import (
    three_interpolate,
    three_nn,
    three_nn_upsampling,
)
from houv_tpu_torch.ops.sampling import furthest_point_sample
from houv_tpu_torch.ops.scatter import gather_rows_kernel, scatter_add
from houv_tpu_torch.ops.voxel import (
    voxel_grid_indices,
    voxelize_features_mean,
    voxelize_mean,
    voxelize_occupancy,
)

__all__ = [
    "assign_score_withk", "boxes_iou_bev", "boxes_iou_bev_sampled",
    "boxes_overlap_bev", "nms_bev", "points_in_boxes",
    "roi_align", "sigmoid_focal_loss",
    "voxel_grid_indices", "voxelize_features_mean", "voxelize_mean",
    "voxelize_occupancy",
    "chamfer_indices", "chamfer_reference", "nn_select", "pairwise_sqdist",
    "emd_auction", "emd_auction_with_stats",
    "gather_edge_features", "gather_rows",
    "ball_query", "gather_points", "grouping_operation", "index_points",
    "knn", "knn_indices", "knn_points", "query_and_group",
    "three_interpolate", "three_nn", "three_nn_upsampling",
    "furthest_point_sample", "gather_rows_kernel", "scatter_add",
]
