from houv_tpu_torch.data.mvp import (
    ModelNetDataset,
    MVPCompletionDataset,
    MVPRegistrationDataset,
    load_h5,
    jitter_pcd,
    random_pose_np,
    synthesize_completion_set,
    synthesize_modelnet_set,
    synthesize_registration_pairs,
    write_mvp_cp_fixture,
    write_mvp_rg_fixture,
)
from houv_tpu_torch.data.pipeline import batch_iterator, shard_ranges

__all__ = ["ModelNetDataset", "MVPCompletionDataset", "MVPRegistrationDataset",
           "batch_iterator", "jitter_pcd", "load_h5", "random_pose_np",
           "shard_ranges", "synthesize_completion_set",
           "synthesize_modelnet_set", "synthesize_registration_pairs",
           "write_mvp_cp_fixture", "write_mvp_rg_fixture"]
