from houv_tpu_torch.ops.chamfer import (
    chamfer_indices,
    chamfer_reference,
    pairwise_sqdist,
)
from houv_tpu_torch.ops.emd import emd_auction, emd_auction_with_stats
from houv_tpu_torch.ops.gather import gather_edge_features, gather_rows
from houv_tpu_torch.ops.grouping import (
    gather_points,
    grouping_operation,
    index_points,
    knn,
    knn_indices,
    knn_points,
)
from houv_tpu_torch.ops.interpolate import (
    three_interpolate,
    three_nn,
    three_nn_upsampling,
)
from houv_tpu_torch.ops.sampling import furthest_point_sample
from houv_tpu_torch.ops.scatter import scatter_add

__all__ = [
    "chamfer_indices", "chamfer_reference", "pairwise_sqdist",
    "emd_auction", "emd_auction_with_stats",
    "gather_edge_features", "gather_rows",
    "gather_points", "grouping_operation", "index_points", "knn",
    "knn_indices", "knn_points",
    "three_interpolate", "three_nn", "three_nn_upsampling",
    "furthest_point_sample", "scatter_add",
]
