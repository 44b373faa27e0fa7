from houv_tpu_torch.solvers.fgr import estimate_normals, fgr_solve, fpfh
from houv_tpu_torch.solvers.goicp_bnb import (build_distance_field,
                                              goicp_bnb_solve)
from houv_tpu_torch.solvers.houv import (
    HOUVConfig,
    evaluate_solution,
    houv_pass,
    houv_solve,
    init_params,
)
from houv_tpu_torch.solvers.icp import icp_solve

__all__ = ["HOUVConfig", "evaluate_solution", "houv_pass", "houv_solve",
           "init_params", "icp_solve", "fgr_solve", "fpfh",
           "estimate_normals", "build_distance_field", "goicp_bnb_solve"]
