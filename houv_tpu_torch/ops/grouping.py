"""k nearest neighbours and point gathers.

Counterpart of ``houv_tpu/ops/grouping.py``. ``knn_points`` launches a
hand-written CUDA kernel on CUDA tensors, ``csrc/knn.cu`` for 3-D points
(replacing the TPU kernel ``_knn_kernel``, the coordinate form) and
``csrc/knn_wide.cu`` for any other channel count (replacing
``_knn_kernel_wide``, the feature-space form), and runs their plain PyTorch
version ``_knn_plain`` on CPU tensors. The contract:

- indices (B, M, k) int64 ascending by distance, ties to the smaller index;
- values are the NEGATED squared distances, descending, recomputed from the
  selected pairs (differentiable in both clouds, as through ``top_k``).

Both kernels and the plain version select on the exact f32 diff-form
distance Σ_c (q_c - r_c)², summed in ascending c and rounded op by op; the
TPU kernels selected at 2^-(23-idx_bits) relative, the wide one on the
expansion form |q|² - 2q·r + |r|² clamped at 0, as the JAX package's XLA
path does, so indices differ from JAX only at near-ties (commoner in a
learned feature space than on coordinates). ``ball_query`` and
``query_and_group`` are plain tensor code, as in the JAX package.
"""

from __future__ import annotations

import torch

from houv_tpu_torch._device import check_on, resolve_device
from houv_tpu_torch.ops.chamfer import pairwise_sqdist

# Keeps the plain version's (rows, M, N) temporaries under ~1 GB.
_PLAIN_CHUNK_ELEMS = 1 << 26

# the card's SMs; csrc/knn_wide.cu's launch plan: queries per block and the
# step of a part's length (a multiple of the refs a thread sums at once)
_SMS = 132
_WIDE_QUERIES = 128
_WIDE_STEP = 16

# csrc/knn.cu's launch plan: threads a block; the largest k for two
# queries a thread; the step of a part's length; packed clouds: fewer
# queries than _KNN_PACK_QUERIES and at most _KNN_PACK_REFS refs
_KNN_THREADS = 128
_KNN_TWO_MAX_K = 16
_KNN_STEP = 32
_KNN_PACK_QUERIES = 64
_KNN_PACK_REFS = 256


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


def _wide_plan(b: int, m: int, n: int, k: int) -> tuple[int, int]:
    """(refs per part, parts) of ``csrc/knn_wide.cu`` for B clouds of M
    queries and N refs. With fewer blocks (B * ceil(M / 128)) than SMs, the
    refs split into parts of consecutive indices until about two blocks an
    SM are in flight; a part holds at least k refs, in multiples of 16, and
    a merge pass joins the parts' lists."""
    blocks = b * -(-m // _WIDE_QUERIES)
    want = 1 if blocks >= _SMS else -(-2 * _SMS // blocks)
    length = max(-(-n // want), k)
    length = -(-length // _WIDE_STEP) * _WIDE_STEP
    if length >= n:
        return n, 1
    return length, -(-n // length)


def _knn_plan(b: int, m: int, n: int, k: int, blocks_per_sm: int | None = None,
              min_part: int | None = None,
              max_per: int = 2) -> tuple[int, int, int]:
    """(refs per part, parts, queries a thread) of ``csrc/knn.cu`` for B
    clouds of M queries and N refs; 0 queries a thread: packed clouds, a
    lane per (cloud, query) row.

    - Packed: fewer than 64 queries and at most 256 refs.
    - Two queries a thread (k <= 16) where B * ceil(M / 256) blocks still
      give two an SM; else one.
    - With fewer blocks (B * ceil(M / (128 x queries a thread))) than
      ``blocks_per_sm`` an SM, the refs split into parts of consecutive
      indices until there are about that many; a part holds at least k and
      ``min_part`` refs, in multiples of 32, and a merge pass joins the
      parts' lists. A part pays its own start (its first refs all enter its
      list) and the merge pass a launch: so where the list is short (k <=
      4) the refs split until two blocks an SM in parts of 256 or more,
      else until one in parts of 512 or more.

    ``blocks_per_sm``, ``min_part`` and ``max_per`` override those choices
    (variants of the kernel)."""
    if n <= _KNN_PACK_REFS and m < _KNN_PACK_QUERIES:
        return n, 1, 0
    short = k <= 4
    if blocks_per_sm is None:
        blocks_per_sm = 2 if short else 1
    if min_part is None:
        min_part = 256 if short else 512
    target = blocks_per_sm * _SMS
    per = 1
    if max_per >= 2 and k <= _KNN_TWO_MAX_K and \
            b * -(-m // (2 * _KNN_THREADS)) >= 2 * _SMS:
        per = 2
    blocks = b * -(-m // (_KNN_THREADS * per))
    want = 1 if blocks >= target else -(-target // blocks)
    length = max(-(-n // want), k, min_part)
    length = -(-length // _KNN_STEP) * _KNN_STEP
    if length >= n:
        return n, 1, per
    return length, -(-n // length), per


def _knn_cuda(query: torch.Tensor, ref: torch.Tensor, k: int) -> torch.Tensor:
    from houv_tpu_torch.kernels import check, load

    lib = load()
    bsz, m, c = query.shape
    n = ref.shape[1]
    wide = c != 3
    max_k = lib.houv_knn_wide_max_k() if wide else lib.houv_knn_max_k()
    if k > max_k:
        raise ValueError(f"the knn kernels take k <= {max_k}, got {k}")
    out = torch.empty((bsz, m, k), dtype=torch.int64, device=query.device)
    if bsz == 0 or m == 0:
        return out
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream(query.device).cuda_stream
        if wide:
            length, parts = _wide_plan(bsz, m, n, k)
        else:
            length, parts, per = _knn_plan(bsz, m, n, k)
        # the parts' (distance, index) lists, merged by the kernel
        scratch = None if parts == 1 else torch.empty(
            2 * parts * bsz * m * k, dtype=torch.int32, device=query.device)
        scratch_ptr = None if scratch is None else scratch.data_ptr()
        if wide:
            err = lib.houv_knn_wide(
                query.data_ptr(), ref.data_ptr(), bsz, m, n, c, k, length,
                scratch_ptr, out.data_ptr(), stream)
        else:
            err = lib.houv_knn(
                query.data_ptr(), ref.data_ptr(), bsz, m, n, k, per, length,
                scratch_ptr, out.data_ptr(), stream)
    check(lib, err, "knn_wide" if wide else "knn")
    if wide:
        knn_indices.wide_launches += 1
    else:
        knn_indices.launches += 1
    return out


def knn_indices(query: torch.Tensor, ref: torch.Tensor, k: int,
                device: str | torch.device = "cuda") -> torch.Tensor:
    """(B, M, C) × (B, N, C) -> (B, M, k) int64 indices of the k nearest
    refs, ascending by distance, ties to the smaller index; no gradients.

    On ``cuda`` this launches ``csrc/knn.cu`` (C == 3), counted in
    ``knn_indices.launches``, or ``csrc/knn_wide.cu`` (any other C), counted
    in ``knn_indices.wide_launches``; the plain version runs only for
    tensors on the CPU, with ``device="cpu"``."""
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
        return _knn_cuda(query, ref, k)
    return _knn_plain(query, ref, k)


knn_indices.launches = 0
knn_indices.wide_launches = 0


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
    return knn_indices(pts, pts, k, device=x.device)


def ball_query(min_radius: float, max_radius: float, nsample: int,
               xyz: torch.Tensor, center_xyz: torch.Tensor) -> torch.Tensor:
    """Fixed-radius neighbourhood indices: xyz (B, N, 3), center_xyz
    (B, M, 3) -> (B, M, nsample) int64.

    - a point qualifies if d² == 0 or min_r² <= d² < max_r² (d² in the
      expansion form, as in the JAX package),
    - the first ``nsample`` qualifying points in index order are returned,
    - slots past the count repeat the first qualifying index,
    - centers with no qualifying point return all zeros."""
    n = xyz.shape[1]
    d2 = pairwise_sqdist(center_xyz.detach(), xyz.detach())      # (B, M, N)
    mask = (d2 == 0.0) | ((d2 >= min_radius ** 2) & (d2 < max_radius ** 2))
    # key = own index where valid, n + index where not: the nsample smallest
    # keys are the first valid indices in index order
    pos = torch.arange(n, device=xyz.device)
    keys = torch.where(mask, pos, pos + n)
    idx = torch.topk(keys, nsample, dim=-1, largest=False).indices
    count = mask.sum(-1, keepdim=True)
    slot = torch.arange(nsample, device=xyz.device)
    idx = torch.where(slot < count, idx, idx[..., :1])
    return torch.where(count > 0, idx, torch.zeros_like(idx))


def query_and_group(xyz: torch.Tensor, center_xyz: torch.Tensor,
                    features: torch.Tensor | None, *, nsample: int,
                    max_radius: float | None, min_radius: float = 0.0,
                    use_xyz: bool = True,
                    normalize_xyz: bool = False) -> torch.Tensor:
    """Ball query (or kNN when ``max_radius`` is None), grouping and centre
    subtraction: xyz (B, N, 3), center_xyz (B, M, 3), features (B, C, N) or
    None -> (B, C(+3), M, nsample)."""
    if max_radius is None:
        idx = knn_indices(center_xyz, xyz, nsample, device=xyz.device)
    else:
        idx = ball_query(min_radius, max_radius, nsample, xyz, center_xyz)
    grouped_xyz = grouping_operation(xyz.transpose(1, 2), idx)
    grouped_xyz = grouped_xyz - center_xyz.transpose(1, 2)[..., None]
    if normalize_xyz and max_radius is not None:
        grouped_xyz = grouped_xyz / max_radius
    if features is None:
        return grouped_xyz
    grouped = grouping_operation(features, idx)
    if use_xyz:
        return torch.cat([grouped_xyz, grouped], 1)
    return grouped
