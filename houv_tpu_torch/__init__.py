"""houv_tpu_torch — the HOUV registration sweep (its quality modes
included), the classical and learned registration baselines, and PCN,
ECG, VRCNet, vrcnet_knn and transformer completion in PyTorch and CUDA.

The PyTorch/CUDA counterpart of ``houv_tpu``, module for module:

- ``houv_tpu_torch.ops``       nearest-neighbour search (indices, or the
  matched coordinates), furthest-point sampling, k nearest neighbours on
  coordinates and in feature space, the auction EMD, scatter-add and row
  gather, each a hand-written CUDA kernel (``csrc/``) with a plain PyTorch
  version beside it for CPU tensors; ball query, grouping and three-NN
  interpolation; voxel indices and sparse 3D convolutions.
- ``houv_tpu_torch.geometry``  rigid-transform math (Rodrigues, errors,
  weighted Kabsch).
- ``houv_tpu_torch.metrics``   chamfer (cd_p, cd_t, F1), EMD, and the
  bisected truncated chamfer mean.
- ``houv_tpu_torch.solvers``   the HOUV hybrid solver (canonical objective,
  view loss) and its classifier-rescored selection.
- ``houv_tpu_torch.models``    PCN, ECG, VRCNet, vrcnet_knn and the
  transformer, DCP, DeepGMR and IDAM with their in-model losses
  (inference, validation, training); the alignment classifier.
- ``houv_tpu_torch.data``      MVP registration and completion data,
  synthetic fixtures, batching.
- ``houv_tpu_torch.train``     YAML configs, results.h5 writer, test CLI,
  the solvers' evaluation, the completion and registration harness,
  checkpoints (the JAX package's flax files read too).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
The package imports neither JAX nor anything of ``houv_tpu``.
"""

__version__ = "0.1.0"
