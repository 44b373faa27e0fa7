from houv_tpu_torch.metrics.cd import (
    calc_cd,
    fscore,
    smallest_k_sqrt_mean_fast,
)
from houv_tpu_torch.metrics.emd import calc_emd

__all__ = ["calc_cd", "calc_emd", "fscore", "smallest_k_sqrt_mean_fast"]
