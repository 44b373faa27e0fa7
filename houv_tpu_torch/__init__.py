"""houv_tpu_torch — the HOUV registration sweep and PCN, ECG and VRCNet
completion in PyTorch and CUDA.

The PyTorch/CUDA counterpart of ``houv_tpu``, module for module:

- ``houv_tpu_torch.ops``       nearest-neighbour search (indices, or the
  matched coordinates), furthest-point sampling, k nearest neighbours on
  coordinates and in feature space, the auction EMD, scatter-add and row
  gather, each a hand-written CUDA kernel (``csrc/``) with a plain PyTorch
  version beside it for CPU tensors; ball query, grouping and three-NN
  interpolation.
- ``houv_tpu_torch.geometry``  rigid-transform math (Rodrigues, errors).
- ``houv_tpu_torch.metrics``   chamfer (cd_p, cd_t, F1), EMD, and the
  bisected truncated chamfer mean.
- ``houv_tpu_torch.solvers``   the HOUV hybrid solver, canonical objective.
- ``houv_tpu_torch.models``    PCN, ECG and VRCNet with their in-model
  losses (inference, validation, training).
- ``houv_tpu_torch.data``      MVP registration and completion data,
  synthetic fixtures, batching.
- ``houv_tpu_torch.train``     YAML configs, results.h5 writer, test CLI,
  the completion harness.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
The package imports neither JAX nor anything of ``houv_tpu``.
"""

__version__ = "0.1.0"
