"""k nearest neighbours and point gathers.

Counterpart of ``houv_tpu/ops/grouping.py``. ``knn_points`` launches the
hand-written CUDA kernel ``csrc/knn.cu`` (replacing the TPU kernel
``_knn_kernel``, the coordinate form) on CUDA tensors and runs its plain
PyTorch version ``_knn_plain`` on CPU tensors. The contract:

- indices (B, M, k) int64 ascending by distance, ties to the smaller index;
- values are the NEGATED squared distances, descending, recomputed from the
  selected pairs (differentiable in both clouds, as through ``top_k``).

Both the kernel and the plain version select on the exact f32 diff-form
distance; the TPU kernel selected at 2^-(23-idx_bits) relative and the JAX
package's XLA path on the expansion form, so indices differ from JAX only at
near-ties. The wide feature-space form (C > 8, ``_knn_kernel_wide``) is not
ported to CUDA yet and runs only on CPU tensors. ``ball_query`` and
``query_and_group`` are not ported yet.
"""

from __future__ import annotations

import torch

from houv_tpu_torch._device import check_on, resolve_device

# Keeps the plain version's (rows, M, N) temporaries under ~1 GB.
_PLAIN_CHUNK_ELEMS = 1 << 26


def gather_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, C, N) × (B, M) int -> (B, C, M)."""
    return torch.gather(features, 2,
                        idx[:, None, :].expand(-1, features.shape[1], -1))


def grouping_operation(features: torch.Tensor,
                       idx: torch.Tensor) -> torch.Tensor:
    """(B, C, N) × (B, npoint, nsample) int -> (B, C, npoint, nsample)."""
    bsz, c, _ = features.shape
    npoint, nsample = idx.shape[1], idx.shape[2]
    flat = gather_points(features, idx.reshape(bsz, npoint * nsample))
    return flat.reshape(bsz, c, npoint, nsample)


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) × (B, ...) int -> (B, ..., C)."""
    bsz, c = points.shape[0], points.shape[-1]
    flat = idx.reshape(bsz, -1)
    out = torch.gather(points, 1, flat[..., None].expand(-1, -1, c))
    return out.reshape(*idx.shape, c)


def _sqdist_diff(query: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """(B, M, C) × (B, N, C) -> (B, M, N) squared distances in the diff form,
    Σ_c (q_c - r_c)² summed channel by channel and rounded op by op, as the
    CUDA kernels compute it."""
    d = None
    for c in range(query.shape[-1]):
        diff = query[:, :, None, c] - ref[:, None, :, c]
        d = diff * diff if d is None else d + diff * diff
    return d


def _knn_plain(query: torch.Tensor, ref: torch.Tensor, k: int) -> torch.Tensor:
    """The kernel's selection in plain PyTorch: diff-form distances, a stable
    sort (ties keep the smaller index first), the first k. Rows go in
    chunks so the temporaries stay bounded."""
    bsz, m, _ = query.shape
    n = ref.shape[1]
    idx = torch.empty((bsz, m, k), dtype=torch.int64, device=query.device)
    chunk = max(1, _PLAIN_CHUNK_ELEMS // max(n, 1))
    for b in range(bsz):
        for r0 in range(0, m, chunk):
            d = _sqdist_diff(query[b:b + 1, r0:r0 + chunk], ref[b:b + 1])
            idx[b, r0:r0 + chunk] = torch.sort(
                d[0], dim=-1, stable=True).indices[:, :k]
    return idx


def _knn_cuda(query: torch.Tensor, ref: torch.Tensor, k: int) -> torch.Tensor:
    from houv_tpu_torch.kernels import check, load

    lib = load()
    if k > lib.houv_knn_max_k():
        raise ValueError(
            f"the knn kernel takes k <= {lib.houv_knn_max_k()}, got {k}")
    bsz, m, _ = query.shape
    n = ref.shape[1]
    out = torch.empty((bsz, m, k), dtype=torch.int64, device=query.device)
    if bsz == 0 or m == 0:
        return out
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream(query.device).cuda_stream
        err = lib.houv_knn(query.data_ptr(), ref.data_ptr(), bsz, m, n, k,
                           out.data_ptr(), stream)
    check(lib, err, "knn")
    knn_indices.launches += 1
    return out


def knn_indices(query: torch.Tensor, ref: torch.Tensor, k: int,
                device: str | torch.device = "cuda") -> torch.Tensor:
    """(B, M, C) × (B, N, C) -> (B, M, k) int64 indices of the k nearest
    refs, ascending by distance, ties to the smaller index; no gradients.

    On ``cuda`` this launches ``csrc/knn.cu`` (C == 3) and counts the launch
    in ``knn_indices.launches``; the plain version runs only for tensors on
    the CPU, with ``device="cpu"``."""
    dev = resolve_device(device)
    check_on(dev, query, ref)
    if query.dim() != 3 or ref.dim() != 3 or query.shape[0] != ref.shape[0] \
            or query.shape[-1] != ref.shape[-1]:
        raise ValueError(
            f"expected (B, M, C) and (B, N, C), got {query.shape}, {ref.shape}")
    if not 1 <= k <= ref.shape[1]:
        raise ValueError(f"need 1 <= k <= N = {ref.shape[1]}, got k={k}")
    query = query.detach().float().contiguous()
    ref = ref.detach().float().contiguous()
    if dev.type == "cuda":
        if query.shape[-1] > 8:
            raise NotImplementedError(
                "the wide (C > 8) kNN kernel is not ported yet "
                "(ROADMAP.md Queue 2, item 4: K6-wide)")
        if query.shape[-1] != 3:
            raise ValueError("the knn kernel takes 3-D points (C == 3), "
                             f"got C={query.shape[-1]}")
        return _knn_cuda(query, ref, k)
    return _knn_plain(query, ref, k)


knn_indices.launches = 0


def knn_points(query: torch.Tensor, ref: torch.Tensor, k: int):
    """k nearest ref points for each query point, on the query's device.

    (B, M, C) query × (B, N, C) ref -> (neg_sqdist (B, M, k), idx (B, M, k)).
    Values are the negated squared distances, descending, recomputed from
    the selected pairs in the selection's own arithmetic (so they are
    exactly sorted) and differentiable in both clouds."""
    idx = knn_indices(query, ref, k, device=query.device)
    nb = index_points(ref, idx)                           # (B, M, k, C)
    d = None
    for c in range(query.shape[-1]):
        diff = query[:, :, None, c] - nb[..., c]
        d = diff * diff if d is None else d + diff * diff
    return -d, idx


def knn(x: torch.Tensor, k: int) -> torch.Tensor:
    """Self-kNN over channel-major features: (B, C, N) -> (B, N, k) indices
    (includes self)."""
    pts = x.transpose(1, 2)
    return knn_points(pts, pts, k)[1]
