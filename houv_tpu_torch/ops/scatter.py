"""Batched scatter-add, the chamfer backward's op, and its transpose, the
batched row gather.

Counterpart of ``houv_tpu/ops/scatter.py``: ``scatter_add_matmul`` and
``gather_rows_matmul``.
``scatter_add`` launches the hand-written CUDA kernel ``csrc/scatter.cu``
(replacing the TPU kernel ``_scatter_kernel``) on CUDA tensors and runs its
plain PyTorch version, ``_scatter_add_plain``, on CPU tensors:

    out[b, r, :] = Σ_{i : idx[b, i] == r} vals[b, i, :]

Indices outside [0, m) are dropped. The sum is f32 and is taken in ascending
``i`` by the kernel and by the plain version alike, so the two are equal bit
for bit and a result does not change from run to run. (The TPU kernel
rounds ``vals`` to bf16 for its matrix unit; that is not carried over.)

``gather_rows_kernel`` launches ``csrc/gather_rows.cu`` (replacing the TPU
kernel ``_gather_kernel``) on CUDA tensors and runs ``_gather_rows_plain`` on
CPU tensors: out[b, i, :] = src[b, idx[b, i], :], an exact copy, a row of
zeros for an index outside [0, M). Like its TPU counterpart it is an
exported op with no caller in the package: the models and the solver gather
with ``ops/gather.py:gather_rows``.
"""

from __future__ import annotations

import torch

from houv_tpu_torch._device import check_on, resolve_device


def _scatter_add_plain(idx: torch.Tensor, vals: torch.Tensor,
                       m: int) -> torch.Tensor:
    """The kernel's sum in plain PyTorch, in the kernel's order. The
    elements that share a target row are ranked by ascending ``i`` (a
    stable sort); pass r adds every row's rank-r element, so within a pass
    no two updates meet and across passes each row adds in ascending
    ``i``. As many passes as the fullest row has elements."""
    bsz, n = idx.shape
    c = vals.shape[-1]
    out = torch.zeros((bsz * m, c), dtype=torch.float32, device=vals.device)
    rows = torch.arange(bsz, device=idx.device)[:, None] * m + idx
    keep = ((idx >= 0) & (idx < m)).reshape(-1).nonzero()[:, 0]
    if keep.numel():
        key = rows.reshape(-1)[keep]
        v = vals.reshape(bsz * n, c)[keep]
        skey, order = torch.sort(key, stable=True)
        pos = torch.arange(skey.numel(), device=skey.device)
        rank = pos - torch.searchsorted(skey, skey)      # place in its run
        for r in range(int(rank.max()) + 1):
            sel = rank == r
            out[skey[sel]] += v[order[sel]]
    return out.reshape(bsz, m, c)


# A block of csrc/scatter.cu keeps the running sums of its rows in shared
# memory, rows * C words beside a chunk's 2048 vals rows and items: at most
# 125 KB of the card's 227 KB.
_SCATTER_SUM_WORDS = 12288


def _scatter_rows(m: int, c: int) -> int:
    """Output rows per block of ``csrc/scatter.cu``; each of the
    ceil(m / rows) blocks of a batch entry reads the entry's indices. One
    block covers all m rows while m * C <= 12288, as at every shape of the
    train steps and the solver."""
    return max(1, min(m, _SCATTER_SUM_WORDS // c))


def _scatter_add_cuda(idx: torch.Tensor, vals: torch.Tensor,
                      m: int) -> torch.Tensor:
    from houv_tpu_torch.kernels import check, load

    lib = load()
    bsz, n = idx.shape
    c = vals.shape[-1]
    if c > lib.houv_scatter_max_channels():
        raise ValueError(f"the scatter kernel takes at most "
                         f"{lib.houv_scatter_max_channels()} channels, "
                         f"got {c}")
    if bsz == 0 or m == 0 or c == 0:
        return torch.zeros((bsz, m, c), dtype=torch.float32,
                           device=vals.device)
    if n == 0:
        idx = idx.new_full((bsz, 1), -1)
        vals = vals.new_zeros((bsz, 1, c))
        n = 1
    out = torch.empty((bsz, m, c), dtype=torch.float32, device=vals.device)
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        err = lib.houv_scatter_add(idx.data_ptr(), vals.data_ptr(), bsz, n,
                                   m, c, _scatter_rows(m, c), out.data_ptr(),
                                   stream)
    check(lib, err, "scatter_add")
    scatter_add.launches += 1
    return out


def scatter_add(idx: torch.Tensor, vals: torch.Tensor, m: int,
                device: str | torch.device = "cuda") -> torch.Tensor:
    """(B, N) int64 × (B, N, C) f32 -> (B, m, C) f32 with
    out[b, r] = Σ vals[b, i] over the i with idx[b, i] == r, added in
    ascending i; indices < 0 or >= m are dropped. No gradients.

    On ``cuda`` this launches ``csrc/scatter.cu`` (C <= 8) and counts the
    launch in ``scatter_add.launches``; the plain version runs only for
    tensors on the CPU, with ``device="cpu"``."""
    dev = resolve_device(device)
    check_on(dev, idx, vals)
    if idx.dim() != 2 or vals.dim() != 3 or vals.shape[:2] != idx.shape:
        raise ValueError(f"expected idx (B, N) and vals (B, N, C), got "
                         f"{tuple(idx.shape)}, {tuple(vals.shape)}")
    if idx.dtype != torch.int64:
        raise ValueError(f"idx must be int64, got {idx.dtype}")
    if m < 0 or m >= 2**31 or idx.shape[1] >= 2**31:
        raise ValueError(f"need 0 <= m < 2^31 and N < 2^31, got m={m}")
    idx = idx.detach().contiguous()
    vals = vals.detach().float().contiguous()
    if dev.type == "cuda":
        return _scatter_add_cuda(idx, vals, m)
    return _scatter_add_plain(idx, vals, m)


scatter_add.launches = 0


def _gather_rows_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The kernel's copy in plain PyTorch: rows by index, zeros where the
    index names no row."""
    ok = (idx >= 0) & (idx < src.shape[1])
    rows = torch.arange(src.shape[0], device=src.device)[:, None]
    out = src[rows, torch.where(ok, idx, torch.zeros_like(idx))]
    return out * ok[..., None].to(out.dtype)


def _gather_rows_cuda(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    from houv_tpu_torch.kernels import check, load

    lib = load()
    bsz, m, c = src.shape
    n = idx.shape[1]
    out = torch.empty((bsz, n, c), dtype=torch.float32, device=src.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = lib.houv_gather_rows(src.data_ptr(), idx.data_ptr(), bsz, m, n,
                                   c, out.data_ptr(), stream)
    check(lib, err, "gather_rows")
    gather_rows_kernel.launches += 1
    return out


def gather_rows_kernel(src: torch.Tensor, idx: torch.Tensor,
                       device: str | torch.device = "cuda") -> torch.Tensor:
    """(B, M, C) f32 × (B, N) int64 -> (B, N, C) f32 with
    out[b, i] = src[b, idx[b, i]], copied exactly; an index < 0 or >= M
    gives a row of zeros. No gradients.

    On ``cuda`` this launches ``csrc/gather_rows.cu`` and counts the launch
    in ``gather_rows_kernel.launches``; the plain version runs only for
    tensors on the CPU, with ``device="cpu"``."""
    dev = resolve_device(device)
    check_on(dev, src, idx)
    if src.dim() != 3 or idx.dim() != 2 or src.shape[0] != idx.shape[0]:
        raise ValueError(f"expected src (B, M, C) and idx (B, N), got "
                         f"{tuple(src.shape)}, {tuple(idx.shape)}")
    if idx.dtype != torch.int64:
        raise ValueError(f"idx must be int64, got {idx.dtype}")
    if max(src.shape[1], idx.shape[1], src.shape[2]) >= 2**31:
        raise ValueError("gather_rows_kernel takes M, N, C < 2^31")
    src = src.detach().float().contiguous()
    idx = idx.detach().contiguous()
    if dev.type == "cuda":
        return _gather_rows_cuda(src, idx)
    return _gather_rows_plain(src, idx)


gather_rows_kernel.launches = 0
