"""Earth mover's distance by the auction algorithm.

Counterpart of ``houv_tpu/ops/emd.py``. ``emd_auction``
launches the hand-written CUDA kernel ``csrc/emd.cu`` (replacing the TPU
kernel ``_emd_kernel``) on CUDA tensors and runs its plain PyTorch version
``_auction_plain`` on CPU tensors. The contract is ``_auction_single``'s:

- fixed-ε Jacobi rounds: every unassigned bidder bids (best − second best
  value) + ε on its best item (ties to the smaller item); each item goes to
  its largest bid (ties to the smaller bidder), evicts its owner and raises
  its price by the bid;
- early exit once every bidder is assigned, else after ``iters`` rounds;
- bidders left unassigned take their nearest item (ties to the smaller);
- dist[b, i] = |x1[b, i] − x2[b, assignment[b, i]]|² (squared).

Both take n != m too (the coarse stages of VRCNet's ``loss: emd``
training auction 1024 or 3072 points against 2048; the JAX package runs
those outside its TPU kernel, which takes n == m only).

The kernel and the plain version compute the distances in the diff form,
rounded op by op, and the same f32 increments and prices, so they run the
same rounds to the same assignment. The gradient goes to x1 only, with the
assignment held fixed: 2·g·(x1 − x2[assignment]); it needs no kernel.
"""

from __future__ import annotations

import torch

from houv_tpu_torch._device import check_on, resolve_device
from houv_tpu_torch.ops.gather import gather_rows
from houv_tpu_torch.ops.grouping import _sqdist_diff


def _auction_plain(x1: torch.Tensor, x2: torch.Tensor, eps: float,
                   iters: int):
    """The kernel's rounds in plain PyTorch, every pair of the batch at once
    (a pair with no unassigned bidder makes no bids, so it stands still).
    x1 (B, N, 3) bidders, x2 (B, M, 3) items. Returns dist (B, N),
    assignment (B, N) int64, rounds (B,) and bids (B,), each bid a scan of
    the M items."""
    bsz, n, _ = x1.shape
    m = x2.shape[1]
    dev = x1.device
    dist = _sqdist_diff(x1, x2)                               # (B, N, M)
    eps_t = torch.tensor(eps, dtype=torch.float32, device=dev)
    neg_inf = torch.tensor(float("-inf"), device=dev)
    rows = torch.arange(n, device=dev).expand(bsz, n)
    items = torch.arange(m, device=dev).expand(bsz, m)
    assignment = torch.full((bsz, n + 1), -1, dtype=torch.int64, device=dev)
    owner = torch.full((bsz, m), -1, dtype=torch.int64, device=dev)
    price = torch.zeros((bsz, m), dtype=torch.float32, device=dev)
    rounds = torch.zeros(bsz, dtype=torch.int64, device=dev)
    bids = torch.zeros(bsz, dtype=torch.int64, device=dev)
    for _ in range(iters):
        unass = assignment[:, :n] < 0
        n_unass = unass.sum(-1)
        if not bool(n_unass.any()):
            break
        rounds += n_unass > 0
        bids += n_unass
        value = (-dist) - price[:, None, :]
        best_idx = value.argmax(-1)                           # first max
        best = value.gather(-1, best_idx[..., None])[..., 0]
        better = value.scatter(-1, best_idx[..., None],
                               float("-inf")).amax(-1)
        inc = (best - better) + eps_t
        # the winning bid per item: the largest increment, then the
        # smallest row
        win_inc = torch.full_like(price, float("-inf")).scatter_reduce(
            -1, best_idx, torch.where(unass, inc, neg_inf), "amax")
        is_winner = unass & (inc == win_inc.gather(-1, best_idx))
        win_row = torch.full_like(owner, n).scatter_reduce(
            -1, best_idx, torch.where(is_winner, rows, n), "amin")
        has = win_row < n
        # evict the previous owners (column n of assignment is a sink for
        # the items without a change), then seat the winners
        assignment.scatter_(-1, torch.where(has & (owner >= 0), owner, n),
                            -1)
        assignment.scatter_(-1, torch.where(has, win_row, n),
                            torch.where(has, items, -1))
        owner = torch.where(has, win_row, owner)
        price = torch.where(has, price + win_inc, price)
    assignment = assignment[:, :n]
    assignment = torch.where(assignment < 0, dist.argmin(-1), assignment)
    d = dist.gather(-1, assignment[..., None])[..., 0]
    return d, assignment, rounds, bids


def _emd_cuda(x1: torch.Tensor, x2: torch.Tensor, eps: float, iters: int):
    from houv_tpu_torch.kernels import check, load

    bsz, n, _ = x1.shape
    m = x2.shape[1]
    lib = load()
    if lib.houv_emd_smem_bytes(n, m) > lib.houv_emd_max_smem_bytes():
        raise ValueError(
            f"the emd kernel keeps a pair's state in shared memory: {n} "
            f"bidders and {m} items need {lib.houv_emd_smem_bytes(n, m)} "
            f"bytes of at most {lib.houv_emd_max_smem_bytes()}")
    dist = torch.empty((bsz, n), dtype=torch.float32, device=x1.device)
    assignment = torch.empty((bsz, n), dtype=torch.int64, device=x1.device)
    stats = torch.empty((bsz, 2), dtype=torch.int64, device=x1.device)
    if bsz == 0:
        return dist, assignment, stats[:, 0], stats[:, 1]
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream(x1.device).cuda_stream
        err = lib.houv_emd(x1.data_ptr(), x2.data_ptr(), bsz, n, m, eps, iters,
                           dist.data_ptr(), assignment.data_ptr(),
                           stats.data_ptr(), stream)
    check(lib, err, "emd")
    emd_auction_with_stats.launches += 1
    return dist, assignment, stats[:, 0], stats[:, 1]


def emd_auction_with_stats(x1: torch.Tensor, x2: torch.Tensor,
                           eps: float = 0.005, iters: int = 50,
                           device: str | torch.device = "cuda"):
    """``emd_auction`` plus, per pair, the rounds run and the bids made
    (each bid scans N items): what the work of this call was.

    On ``cuda`` this launches ``csrc/emd.cu`` and counts the launch in
    ``emd_auction_with_stats.launches``; the plain version runs only for
    tensors on the CPU, with ``device="cpu"``."""
    dev = resolve_device(device)
    check_on(dev, x1, x2)
    if x1.dim() != 3 or x1.shape[-1] != 3 or x2.shape[:1] != x1.shape[:1] \
            or x2.dim() != 3 or x2.shape[-1] != 3:
        raise ValueError(
            f"expected (B, N, 3) clouds, got {x1.shape}, {x2.shape}")
    if x1.shape[1] < 1 or x2.shape[1] < 1 or not eps > 0 or iters < 0:
        raise ValueError(f"need n >= 1, eps > 0 and iters >= 0, got "
                         f"n={x1.shape[1]}, eps={eps}, iters={iters}")
    x1 = x1.detach().float().contiguous()
    x2 = x2.detach().float().contiguous()
    if dev.type == "cuda":
        return _emd_cuda(x1, x2, float(eps), int(iters))
    return _auction_plain(x1, x2, float(eps), int(iters))


emd_auction_with_stats.launches = 0


class _EmdFunction(torch.autograd.Function):
    """The auction with the gradient of its matched distances, the
    assignment held fixed: 2·g·(x1 − x2[assignment]) to x1, none to x2."""

    @staticmethod
    def forward(ctx, x1, x2, eps, iters):
        dist, assignment, _, _ = emd_auction_with_stats(
            x1, x2, eps, iters, device=x1.device)
        ctx.save_for_backward(x1, x2, assignment)
        ctx.mark_non_differentiable(assignment)
        return dist, assignment

    @staticmethod
    def backward(ctx, g_dist, _g_assignment):
        x1, x2, assignment = ctx.saved_tensors
        g1 = None
        if ctx.needs_input_grad[0]:
            matched = gather_rows(x2.detach().float(), assignment)
            g1 = (2.0 * g_dist[..., None]
                  * (x1.detach().float() - matched)).to(x1.dtype)
        return g1, None, None, None


def emd_auction(x1: torch.Tensor, x2: torch.Tensor, eps: float = 0.005,
                iters: int = 50):
    """Approximate EMD assignment on x1's device.
    (B, N, 3) × (B, M, 3) -> dist (B, N) squared, assignment (B, N) int64.
    The defaults are the reference's train setting. The gradient goes to x1
    only, with the assignment held fixed; x2 gets none."""
    if torch.is_grad_enabled() and x1.requires_grad:
        return _EmdFunction.apply(x1, x2, eps, iters)
    dist, assignment, _, _ = emd_auction_with_stats(x1, x2, eps, iters,
                                                    device=x1.device)
    return dist, assignment
