"""Batched scatter-add, the chamfer backward's op.

Counterpart of ``houv_tpu/ops/scatter.py:scatter_add_matmul``.
``scatter_add`` launches the hand-written CUDA kernel ``csrc/scatter.cu``
(replacing the TPU kernel ``_scatter_kernel``) on CUDA tensors and runs its
plain PyTorch version, ``_scatter_add_plain``, on CPU tensors:

    out[b, r, :] = Σ_{i : idx[b, i] == r} vals[b, i, :]

Indices outside [0, m) are dropped. The sum is f32 and is taken in ascending
``i`` by the kernel and by the plain version alike, so the two are equal bit
for bit and a result does not change from run to run. (The TPU kernel
rounds ``vals`` to bf16 for its matrix unit; that is not carried over.)
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
                                   m, c, out.data_ptr(), stream)
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
