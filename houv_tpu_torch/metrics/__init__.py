from houv_tpu_torch.metrics.cd import (
    calc_cd,
    calc_cd_percent,
    calc_cd_percent_aligned,
    calc_cd_percent_len,
    fscore,
    loss_view,
    smallest_k_sqrt_mean_fast,
)
from houv_tpu_torch.metrics.emd import calc_emd

__all__ = ["calc_cd", "calc_cd_percent", "calc_cd_percent_aligned",
           "calc_cd_percent_len", "calc_emd", "fscore", "loss_view",
           "smallest_k_sqrt_mean_fast"]
