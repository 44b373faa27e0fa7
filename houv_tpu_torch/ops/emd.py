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
same rounds to the same assignment. The kernel runs a pair on one block or
on a cluster of blocks (``_emd_plan``); a pair whose state passes one
block's shared memory (about 6428 x 6428) goes to ``csrc/emd_large.cu``
(its items split over a cluster's shared memory, up to about 17000 x
17000), a larger one to ``csrc/emd_global.cu`` (the same rounds with the
state in global memory, any size; ``_emd_route``). The gradient goes to x1 only, with the
assignment held fixed: 2·g·(x1 − x2[assignment]); it needs no kernel.
"""

from __future__ import annotations

import functools

import torch

from houv_tpu_torch._device import check_on, resolve_device
from houv_tpu_torch.ops.gather import gather_rows
from houv_tpu_torch.ops.grouping import _sqdist_diff

# csrc/emd.cu's cluster sizes (blocks a pair), the largest first: an H100
# holds 39 clusters of 3 and 66 of 2, which the paths' batches of 32 and 64
# pairs fill; a larger size would fit one wave only below 31 pairs
_EMD_CLUSTERS = (3, 2)
# csrc/emd_large.cu's and csrc/emd_global.cu's cluster sizes, the largest
# first (8 is the portable limit): their pairs are few and large, so more
# SMs a pair
_EMD_LARGE_CLUSTERS = (8, 4, 2)


def _auction_plain(x1: torch.Tensor, x2: torch.Tensor, eps: float,
                   iters: int, counts: list | None = None):
    """The kernel's rounds in plain PyTorch, every pair of the batch at once
    (a pair with no unassigned bidder makes no bids, so it stands still).
    x1 (B, N, 3) bidders, x2 (B, M, 3) items. Returns dist (B, N),
    assignment (B, N) int64, rounds (B,) and bids (B,), each bid a scan of
    the M items. ``counts``, if given, receives each round's unassigned
    bidders per pair, (B,) int64."""
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
        if counts is not None:
            counts.append(n_unass)
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


def _emd_plan(b: int, sms: int, max_clusters: dict[int, int]) -> int:
    """Blocks a pair of ``csrc/emd.cu`` (C) for a batch of b pairs: the
    largest C of ``_EMD_CLUSTERS`` of which the card holds b clusters at
    once (``max_clusters[C]``, read from the card at the pair's size: a
    second wave would double the time), or 1 where b blocks fill the card's
    ``sms`` SMs or no cluster size fits."""
    if b >= sms:
        return 1
    return next((c for c in _EMD_CLUSTERS if b <= max_clusters[c]), 1)


@functools.lru_cache(maxsize=None)
def _max_clusters(n: int, m: int, device_index: int) -> dict[int, int]:
    """The most clusters of each size the card holds at once for pairs of n
    bidders and m items."""
    from houv_tpu_torch.kernels import check, load

    lib = load()
    out = {}
    with torch.cuda.device(device_index):
        for c in _EMD_CLUSTERS:
            count = lib.houv_emd_max_clusters(n, m, c)
            check(lib, max(0, -count), f"emd occupancy of clusters of {c}")
            out[c] = count
    return out


def _card_plan(b: int, n: int, m: int, device: torch.device) -> int:
    """``_emd_plan`` for b pairs of n bidders and m items on ``device``."""
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    return _emd_plan(
        b, torch.cuda.get_device_properties(index).multi_processor_count,
        _max_clusters(n, m, index))


def _emd_route(smem_bytes: int, large_bytes: int, max_smem_bytes: int
               ) -> str:
    """Which kernel takes a pair whose state needs ``smem_bytes`` of one
    block's shared memory in ``csrc/emd.cu`` (``houv_emd_smem_bytes(n,
    m)``) and ``large_bytes`` of each block's of a cluster of 8 in
    ``csrc/emd_large.cu`` (``houv_emd_large_smem_bytes(n, m, 8)``): the
    first ("emd") or the second ("emd_large") where it fits
    ``houv_emd_max_smem_bytes()``, else ``csrc/emd_global.cu``
    ("emd_global": the state in global memory, any n and m)."""
    if smem_bytes <= max_smem_bytes:
        return "emd"
    return "emd_large" if large_bytes <= max_smem_bytes else "emd_global"


def _emd_large_plan(b: int, smem_bytes, max_smem_bytes: int, held) -> int:
    """Blocks a pair of ``csrc/emd_large.cu``: of the C of
    ``_EMD_LARGE_CLUSTERS`` whose blocks hold their share of the pair
    (``smem_bytes(C)`` within ``max_smem_bytes``), the one of least time:
    the waves in which the card runs b clusters (``held(C)`` at once, read
    from the card) over C, a pair's scans split over its C SMs; ties go to
    the larger C."""
    fits = [c for c in _EMD_LARGE_CLUSTERS
            if smem_bytes(c) <= max_smem_bytes]
    if not fits:
        raise ValueError("the pair passes emd_large's shared memory")
    return min(fits, key=lambda c: -(-b // max(1, held(c))) / c)


@functools.lru_cache(maxsize=None)
def _large_held(n: int, m: int, c: int, device_index: int) -> int:
    """The most clusters of c blocks of ``csrc/emd_large.cu`` the card holds
    at once for pairs of n bidders and m items."""
    from houv_tpu_torch.kernels import check, load

    lib = load()
    with torch.cuda.device(device_index):
        count = lib.houv_emd_large_max_clusters(n, m, c)
    check(lib, max(0, -count), f"emd_large occupancy of clusters of {c}")
    return count


def _large_card_plan(b: int, n: int, m: int, device: torch.device) -> int:
    """``_emd_large_plan`` for b pairs of n bidders and m items on
    ``device``."""
    from houv_tpu_torch.kernels import load

    lib = load()
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    return _emd_large_plan(
        b, lambda c: lib.houv_emd_large_smem_bytes(n, m, c),
        lib.houv_emd_max_smem_bytes(),
        lambda c: _large_held(n, m, c, index))


def _emd_global_plan(b: int, max_clusters: dict[int, int]) -> int:
    """Blocks a pair of ``csrc/emd_global.cu``: the largest C of
    ``_EMD_LARGE_CLUSTERS`` of which the card holds all b clusters at once
    (``max_clusters[C]``, read from the card), else 1."""
    return next((c for c in _EMD_LARGE_CLUSTERS if b <= max_clusters[c]), 1)


@functools.lru_cache(maxsize=None)
def _max_global_clusters(device_index: int) -> dict[int, int]:
    """The most clusters of each size of ``csrc/emd_global.cu`` the card
    holds at once."""
    from houv_tpu_torch.kernels import check, load

    lib = load()
    out = {}
    with torch.cuda.device(device_index):
        for c in _EMD_LARGE_CLUSTERS:
            count = lib.houv_emd_global_max_clusters(c)
            check(lib, max(0, -count), f"emd_global occupancy of {c}")
            out[c] = count
    return out


def _emd_outputs(x1: torch.Tensor):
    """dist (B, N) f32, assignment (B, N) int64 and the (B, 2) int64 rounds
    and bids, empty on ``x1``'s device."""
    bsz, n, _ = x1.shape
    new = functools.partial(torch.empty, device=x1.device)
    return (new((bsz, n), dtype=torch.float32),
            new((bsz, n), dtype=torch.int64), new((bsz, 2), dtype=torch.int64))


def _emd_large_cuda(x1: torch.Tensor, x2: torch.Tensor, eps: float,
                    iters: int, clusters: int | None = None):
    """``csrc/emd_large.cu``'s launch (no scratch: the state lives in the
    cluster's shared memory); ``clusters`` overrides ``_emd_large_plan``'s
    blocks a pair. ``_emd_cuda`` routes the pairs past K7's shared memory
    that fit it here."""
    from houv_tpu_torch.kernels import check, load

    bsz, n, _ = x1.shape
    m = x2.shape[1]
    if clusters is None:
        clusters = _large_card_plan(bsz, n, m, x1.device)
    dist, assignment, stats = _emd_outputs(x1)
    lib = load()
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream(x1.device).cuda_stream
        err = lib.houv_emd_large(
            x1.data_ptr(), x2.data_ptr(), bsz, n, m, eps, iters, clusters,
            dist.data_ptr(), assignment.data_ptr(), stats.data_ptr(), stream)
    check(lib, err, "emd_large")
    emd_auction_with_stats.large_launches += 1
    return dist, assignment, stats[:, 0], stats[:, 1]


def _emd_global_cuda(x1: torch.Tensor, x2: torch.Tensor, eps: float,
                     iters: int, clusters: int | None = None):
    """``csrc/emd_global.cu``'s launch, its scratch allocated here;
    ``clusters`` overrides ``_emd_global_plan``'s blocks a pair.
    ``_emd_cuda`` routes the pairs past ``csrc/emd_large.cu`` here."""
    from houv_tpu_torch.kernels import check, load

    bsz, n, _ = x1.shape
    m = x2.shape[1]
    if clusters is None:
        index = x1.device.index
        if index is None:
            index = torch.cuda.current_device()
        clusters = _emd_global_plan(bsz, _max_global_clusters(index))
    dist, assignment, stats = _emd_outputs(x1)
    new = functools.partial(torch.empty, device=x1.device)
    items = new((bsz, m, 4), dtype=torch.float32)
    key = new((bsz, m), dtype=torch.int64)
    owner = new((bsz, m), dtype=torch.int32)
    lists = new((bsz, 2 * n), dtype=torch.int32)
    item = new((bsz, n), dtype=torch.int32)
    cnt = new((bsz, 2), dtype=torch.int32)
    lib = load()
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream(x1.device).cuda_stream
        err = lib.houv_emd_global(
            x1.data_ptr(), x2.data_ptr(), bsz, n, m, eps, iters, clusters,
            items.data_ptr(), key.data_ptr(), owner.data_ptr(),
            lists.data_ptr(), item.data_ptr(), cnt.data_ptr(),
            dist.data_ptr(), assignment.data_ptr(), stats.data_ptr(), stream)
    check(lib, err, "emd_global")
    emd_auction_with_stats.global_launches += 1
    return dist, assignment, stats[:, 0], stats[:, 1]


def _emd_cuda(x1: torch.Tensor, x2: torch.Tensor, eps: float, iters: int,
              clusters: int | None = None):
    """The kernel's launch, or for pairs past its shared memory
    (``_emd_route``) the large or the global design's; ``clusters``
    overrides the plan's blocks a pair."""
    from houv_tpu_torch.kernels import check, load

    bsz, n, _ = x1.shape
    m = x2.shape[1]
    if bsz == 0:
        dist, assignment, stats = _emd_outputs(x1)
        return dist, assignment, stats[:, 0], stats[:, 1]
    lib = load()
    route = _emd_route(lib.houv_emd_smem_bytes(n, m),
                       lib.houv_emd_large_smem_bytes(n, m, 8),
                       lib.houv_emd_max_smem_bytes())
    if route == "emd_large":
        return _emd_large_cuda(x1, x2, eps, iters, clusters)
    if route == "emd_global":
        return _emd_global_cuda(x1, x2, eps, iters, clusters)
    if clusters is None:
        clusters = _card_plan(bsz, n, m, x1.device)
    dist, assignment, stats = _emd_outputs(x1)
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream(x1.device).cuda_stream
        err = lib.houv_emd(x1.data_ptr(), x2.data_ptr(), bsz, n, m, eps, iters,
                           clusters, dist.data_ptr(), assignment.data_ptr(),
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
    ``emd_auction_with_stats.launches``, or for pairs above its shared
    memory ``csrc/emd_large.cu``, counted in ``.large_launches``, or above
    that one's ``csrc/emd_global.cu``, counted in ``.global_launches``; the
    plain version runs only for tensors on the CPU, with
    ``device="cpu"``."""
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
emd_auction_with_stats.large_launches = 0
emd_auction_with_stats.global_launches = 0


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
