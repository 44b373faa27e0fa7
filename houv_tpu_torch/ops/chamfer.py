"""Nearest-neighbour search both ways — the HOUV solver's hottest op.

Counterpart of ``houv_tpu/ops/chamfer.py``. ``chamfer_indices`` launches the
hand-written CUDA kernel ``csrc/nn_both.cu`` (replacing the TPU kernel
``_nn_both_kernel``) on CUDA tensors and runs its plain PyTorch version,
``_nn_both_plain``, on CPU tensors. ``chamfer`` recomputes exact distances
from those indices and carries the gradient of ``_nn_both_gather``: direct
terms elementwise, cross terms through ``ops/scatter.py:scatter_add`` (the
``scatter`` kernel on CUDA tensors). ``pairwise_sqdist`` and
``chamfer_reference`` are the dense golden model.

Unlike the TPU kernel, which selects by a key holding 16 index bits (2^-12
relative on distances), both the CUDA kernel and the plain version select on
the exact f32 diff-form distance, so indices differ only at near-ties.
"""

from __future__ import annotations

import torch

from houv_tpu_torch._device import check_on, resolve_device
from houv_tpu_torch.ops.gather import gather_rows
from houv_tpu_torch.ops.scatter import scatter_add

# Keeps the plain version's (rows, N, M) temporaries under ~1 GB.
_PLAIN_CHUNK_ELEMS = 1 << 26


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) × (..., M, 3) -> (..., N, M) squared euclidean distances
    (expansion form, clamped at 0, like the JAX golden model)."""
    a2 = (a * a).sum(-1)[..., :, None]
    b2 = (b * b).sum(-1)[..., None, :]
    ab = torch.einsum("...nc,...mc->...nm", a, b)
    return torch.clamp_min(a2 + b2 - 2.0 * ab, 0.0)


def chamfer_reference(a: torch.Tensor, b: torch.Tensor):
    """Dense golden chamfer. (B,N,3),(B,M,3) -> d1 (B,N), d2 (B,M), i1, i2."""
    d = pairwise_sqdist(a, b)
    d1, i1 = d.min(-1)
    d2, i2 = d.min(-2)
    return d1, d2, i1, i2


def _nn_both_plain(a: torch.Tensor, b: torch.Tensor):
    """The kernel's arithmetic in plain PyTorch: exact diff-form f32
    distances, argmin both ways (first index on ties). Shared-query layout:
    ``a`` (Bq, N, 3) serves Bk / Bq consecutive rows of ``b`` (Bk, M, 3).
    Rows go in chunks so the temporaries stay bounded."""
    bq, n, _ = a.shape
    bk, m, _ = b.shape
    share = bk // bq
    i1 = torch.empty((bk, n), dtype=torch.int64, device=b.device)
    i2 = torch.empty((bk, m), dtype=torch.int64, device=b.device)
    chunk = max(1, _PLAIN_CHUNK_ELEMS // max(n * m, 1))
    pair_of_row = torch.arange(bk, device=b.device) // share
    for r0 in range(0, bk, chunk):
        r1 = min(r0 + chunk, bk)
        qa = a[pair_of_row[r0:r1]]                       # (c, N, 3)
        d = None
        for c in range(3):                               # (c, N, M) each
            diff = qa[:, :, None, c] - b[r0:r1, None, :, c]
            d = diff * diff if d is None else d + diff * diff
        i1[r0:r1] = d.argmin(-1)
        i2[r0:r1] = d.argmin(-2)
    return i1, i2


def _nn_both_cuda(a: torch.Tensor, b: torch.Tensor):
    from houv_tpu_torch.kernels import check, load

    lib = load()
    bq, n, _ = a.shape
    bk, m, _ = b.shape
    i1 = torch.empty((bk, n), dtype=torch.int64, device=b.device)
    key2 = torch.empty((bk, m), dtype=torch.int64, device=b.device)
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        err = lib.houv_nn_both(a.data_ptr(), b.data_ptr(), bq, bk, n, m,
                               i1.data_ptr(), key2.data_ptr(), stream)
    check(lib, err, "nn_both")
    chamfer_indices.launches += 1
    return i1, key2 & 0xFFFFFFFF


def chamfer_indices(a: torch.Tensor, b: torch.Tensor,
                    device: str | torch.device = "cuda"):
    """Nearest-neighbour indices both ways, no gradients:
    i1[r, i] = argmin_j |a_i - b_j|², i2[r, j] = argmin_i |a_i - b_j|²,
    both int64, ties to the smaller index.

    ``a`` may carry a smaller batch than ``b`` (shared-query layout: each
    ``a`` row serves Bk / Bq consecutive ``b`` rows); outputs follow b's
    batch. On ``cuda`` this launches ``csrc/nn_both.cu`` and counts the
    launch in ``chamfer_indices.launches``; the plain version runs only for
    tensors on the CPU, with ``device="cpu"``."""
    dev = resolve_device(device)
    check_on(dev, a, b)
    if a.dim() != 3 or b.dim() != 3 or a.shape[-1] != 3 or b.shape[-1] != 3:
        raise ValueError(f"expected (B, N, 3) clouds, got {a.shape}, {b.shape}")
    if a.shape[0] == 0 or b.shape[0] % a.shape[0]:
        raise ValueError(
            f"query batch {a.shape[0]} does not divide {b.shape[0]}")
    a = a.detach().float().contiguous()
    b = b.detach().float().contiguous()
    if dev.type == "cuda":
        if a.shape[1] >= 2**31 or b.shape[1] >= 2**31:
            raise ValueError("nn_both takes fewer than 2^31 points per cloud")
        return _nn_both_cuda(a, b)
    return _nn_both_plain(a, b)


chamfer_indices.launches = 0


def _chamfer_forward(a: torch.Tensor, b: torch.Tensor):
    """One ``chamfer_indices`` pass, then the matched pairs' differences:
    d1, d2, i1, i2, diff1 (B, N, 3), diff2 (B, M, 3), without gradients."""
    i1, i2 = chamfer_indices(a, b, device=a.device)
    a = a.detach().float()
    b = b.detach().float()
    diff1 = a - gather_rows(b, i1)
    diff2 = b - gather_rows(a, i2)
    return ((diff1 * diff1).sum(-1), (diff2 * diff2).sum(-1), i1, i2,
            diff1, diff2)


class _ChamferFunction(torch.autograd.Function):
    """``chamfer`` with the gradient of the matched-pair distances, the
    matches held fixed: d1[i] = |a_i - b_{i1[i]}|² sends 2·g1·diff1 to a_i
    and its negative to b_{i1[i]} (a scatter-add over i1); d2 likewise."""

    @staticmethod
    def forward(ctx, a, b):
        d1, d2, i1, i2, diff1, diff2 = _chamfer_forward(a, b)
        ctx.save_for_backward(i1, i2, diff1, diff2)
        ctx.dtypes = (a.dtype, b.dtype)
        ctx.mark_non_differentiable(i1, i2)
        return d1, d2, i1, i2

    @staticmethod
    def backward(ctx, g1, g2, _gi1, _gi2):
        i1, i2, diff1, diff2 = ctx.saved_tensors
        n, m = diff1.shape[1], diff2.shape[1]
        t1 = 2.0 * g1[..., None] * diff1       # (B, N, 3) d1 direct term
        t2 = 2.0 * g2[..., None] * diff2       # (B, M, 3) d2 direct term
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = (t1 + scatter_add(i2, -t2, n, device=t2.device)).to(
                ctx.dtypes[0])
        if ctx.needs_input_grad[1]:
            gb = (t2 + scatter_add(i1, -t1, m, device=t1.device)).to(
                ctx.dtypes[1])
        return ga, gb


def chamfer(a: torch.Tensor, b: torch.Tensor):
    """Bidirectional squared chamfer on a's device:
    (B, N, 3), (B, M, 3) -> d1 (B, N), d2 (B, M), i1 (B, N), i2 (B, M).

    d1[i] = |a_i - b_{i1[i]}|², d2 symmetric: one ``chamfer_indices`` pass
    (the ``nn_both`` kernel on CUDA tensors), then exact distances from the
    matched pairs. Differentiable in a and b with the matches held fixed;
    the backward makes one ``scatter_add`` (the ``scatter`` kernel on CUDA
    tensors) for each input that needs a gradient. With gradients off, or
    when neither input needs one, it is the forward alone."""
    if a.shape[0] != b.shape[0]:
        raise ValueError(f"batch sizes differ: {a.shape}, {b.shape}")
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _ChamferFunction.apply(a, b)
    return _chamfer_forward(a, b)[:4]
