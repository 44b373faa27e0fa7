from houv_tpu_torch.data.mvp import (
    MVPCompletionDataset,
    MVPRegistrationDataset,
    load_h5,
    random_pose_np,
    synthesize_completion_set,
    synthesize_registration_pairs,
)
from houv_tpu_torch.data.pipeline import batch_iterator, shard_ranges

__all__ = ["MVPCompletionDataset", "MVPRegistrationDataset", "batch_iterator",
           "load_h5", "random_pose_np", "shard_ranges",
           "synthesize_completion_set", "synthesize_registration_pairs"]
