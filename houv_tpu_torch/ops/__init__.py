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
from houv_tpu_torch.ops.interpolate import (
    three_interpolate,
    three_nn,
    three_nn_upsampling,
)
from houv_tpu_torch.ops.sampling import furthest_point_sample
from houv_tpu_torch.ops.scatter import gather_rows_kernel, scatter_add

__all__ = [
    "chamfer_indices", "chamfer_reference", "nn_select", "pairwise_sqdist",
    "emd_auction", "emd_auction_with_stats",
    "gather_edge_features", "gather_rows",
    "ball_query", "gather_points", "grouping_operation", "index_points",
    "knn", "knn_indices", "knn_points", "query_and_group",
    "three_interpolate", "three_nn", "three_nn_upsampling",
    "furthest_point_sample", "gather_rows_kernel", "scatter_add",
]
