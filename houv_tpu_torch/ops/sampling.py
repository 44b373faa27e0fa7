"""Furthest point sampling.

Counterpart of ``houv_tpu/ops/sampling.py``. ``furthest_point_sample``
launches the hand-written CUDA kernel ``csrc/fps.cu`` (replacing the TPU
kernel ``_fps_kernel``) on CUDA tensors and runs its plain PyTorch version
``_fps_plain`` (the loop of ``_fps_xla``) on CPU tensors; clouds above
``fps.cu``'s 8192 points go to ``csrc/fps_large.cu`` (a cluster of blocks a
cloud, up to 65536 points), larger ones to ``csrc/fps_global.cu``, which
takes any size (``_fps_route``). Contract: indices
(B, K) int64, the first is 0, then the point furthest from the selected set,
ties to the first occurrence. ``furthest_point_sample_with_dist`` runs the
same selection over a precomputed distance matrix (plain PyTorch, as its
JAX counterpart is plain JAX).
"""

from __future__ import annotations

import functools

import torch

from houv_tpu_torch._device import check_on, resolve_device

# csrc/fps.cu's launch plan: points a thread (a power of two up to 32) and
# the most threads a block of that many may have (the kernel's launch
# bounds); the block's target size, (up to N points, threads): the fastest
# of 32 to 1024 threads at the paths' cloud sizes on an H100
# (scripts/time_fps_variants.py, PERF.md), each taking the sizes up to it
_FPS_MAX_THREADS = {1: 1024, 2: 1024, 4: 1024, 8: 512, 16: 512, 32: 256}
_FPS_THREADS = ((256, 32), (2048, 128), (3072, 512), (4096, 128),
                (8192, 256))
# csrc/fps_large.cu's cluster sizes, the largest first (8 is the portable
# limit; 16, which an H100 admits, was no faster: PERF.md), and the most
# points a block of it holds (fps.cu's register cap)
_FPS_CLUSTERS = (8, 4, 2)
_FPS_BLOCK_POINTS = 8192
# a step of csrc/fps_large.cu costs about a block's pass over this many
# points more than the pass over its own (PERF.md: 1.56, 1.90 and 2.32 ms
# at 2048, 4096 and 8192 points a block, (4, 16384) -> 2048 on an H100)
_FPS_CHAIN_POINTS = 10000


def _fps_plain(points: torch.Tensor, k: int) -> torch.Tensor:
    """One (B, N) min/argmax step per selected point. The distance is
    (x-lx)² + (y-ly)² + (z-lz)² as separate elementwise ops, so it rounds
    the same on every device; the CUDA kernel rounds it the same way."""
    bsz, n, _ = points.shape
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    rows = torch.arange(bsz, device=points.device)
    min_d = torch.full((bsz, n), 1e10, dtype=points.dtype, device=points.device)
    idxs = torch.zeros((bsz, k), dtype=torch.int64, device=points.device)
    last = torch.zeros(bsz, dtype=torch.int64, device=points.device)
    for i in range(1, k):
        dx = x - x[rows, last][:, None]
        dy = y - y[rows, last][:, None]
        dz = z - z[rows, last][:, None]
        d = dx * dx + dy * dy + dz * dz
        min_d = torch.minimum(min_d, d)
        last = min_d.argmax(-1)
        idxs[:, i] = last
    return idxs


def _fps_plan(n: int, threads: int | None = None) -> tuple[int, int]:
    """(warps, points a thread) of ``csrc/fps.cu`` for clouds of n points:
    the fewest points a thread (a power of two up to 32) whose block of
    ``threads`` threads (by default ``_FPS_THREADS``'s for n; a variant's
    override) covers the cloud, more where that block would pass the
    kernel's bound for so many points a thread, then the fewest warps that
    cover the cloud."""
    if threads is None:
        threads = next((t for most, t in _FPS_THREADS if n <= most),
                       _FPS_THREADS[-1][1])
    pers = list(_FPS_MAX_THREADS)
    per = next((p for p in pers if p * threads >= n), pers[-1])
    for per in pers[pers.index(per):]:
        warps = -(-n // (32 * per))
        if 32 * warps <= _FPS_MAX_THREADS[per]:
            return warps, per
    raise ValueError(f"the fps kernel takes at most "
                     f"{pers[-1] * _FPS_MAX_THREADS[pers[-1]]} points, got "
                     f"{n}")


def _fps_cluster_plan(n: int, b: int, held, threads: int | None = None
                      ) -> tuple[int, int, int]:
    """(C, warps, points a thread) of ``csrc/fps_large.cu`` for b clouds of
    n points: each of the C blocks of a cloud's cluster takes nb =
    ceil(n / C) points with ``_fps_plan``'s block (``threads`` a variant's
    override). Of the C of ``_FPS_CLUSTERS`` whose blocks hold their points
    and which the card admits, the one of least time: the waves in which
    the card runs b clusters (``held(C, warps, per)`` at once, read from
    the card) times a step's cost, ``_FPS_CHAIN_POINTS`` + nb; ties go to
    the larger C."""
    best, least = None, None
    for c in _FPS_CLUSTERS:
        nb = -(-n // c)
        if nb > _FPS_BLOCK_POINTS:
            break
        warps, per = _fps_plan(nb, threads)
        count = held(c, warps, per)
        if count < 1:
            continue
        cost = -(-b // count) * (_FPS_CHAIN_POINTS + nb)
        if least is None or cost < least:
            best, least = (c, warps, per), cost
    if best is None:
        raise ValueError(f"the fps_large kernel takes at most "
                         f"{_FPS_CLUSTERS[0] * _FPS_BLOCK_POINTS} points, "
                         f"got {n}")
    return best


def _fps_route(n: int, max_points: int, capacity: int) -> str:
    """Which kernel takes clouds of n points: ``csrc/fps.cu`` ("fps") up to
    its limit (``houv_fps_max_points()``, 8192), ``csrc/fps_large.cu``
    ("fps_large": a cluster of blocks a cloud, its points in their
    registers) up to its capacity (``houv_fps_large_max_points()``, 65536),
    ``csrc/fps_global.cu`` ("fps_global": the cloud and its minima in
    global memory, any n) above it."""
    if n <= max_points:
        return "fps"
    return "fps_large" if n <= capacity else "fps_global"


@functools.lru_cache(maxsize=None)
def _held(c: int, warps: int, per: int, device_index: int) -> int:
    """The most clusters of c blocks of ``csrc/fps_large.cu`` (warps and
    points a thread) the card holds at once; 0 for a size it does not
    admit."""
    from houv_tpu_torch.kernels import check, load

    lib = load()
    with torch.cuda.device(device_index):
        count = lib.houv_fps_large_max_clusters(c, warps, per)
    check(lib, max(0, -count), f"fps_large occupancy of clusters of {c}")
    return count


def _fps_large_cuda(points: torch.Tensor, k: int,
                    clusters: int | None = None) -> torch.Tensor:
    """``csrc/fps_large.cu``'s launch at ``_fps_cluster_plan``'s cluster
    size, or at ``clusters`` blocks a cloud (the card's checks)."""
    from houv_tpu_torch.kernels import check, load

    lib = load()
    bsz, n, _ = points.shape
    if clusters is None:
        index = points.device.index
        if index is None:
            index = torch.cuda.current_device()
        c, warps, per = _fps_cluster_plan(
            n, bsz, lambda c, w, p: _held(c, w, p, index))
    else:
        c, (warps, per) = clusters, _fps_plan(-(-n // clusters))
    out = torch.empty((bsz, k), dtype=torch.int64, device=points.device)
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream(points.device).cuda_stream
        err = lib.houv_fps_large(points.data_ptr(), bsz, n, k, c, warps, per,
                                 out.data_ptr(), stream)
    check(lib, err, "fps_large")
    furthest_point_sample.large_launches += 1
    return out


def _fps_global_cuda(points: torch.Tensor, k: int) -> torch.Tensor:
    """``csrc/fps_global.cu``'s launch, its scratch allocated here."""
    from houv_tpu_torch.kernels import check, load

    lib = load()
    bsz, n, _ = points.shape
    out = torch.empty((bsz, k), dtype=torch.int64, device=points.device)
    work = torch.empty((bsz, n, 4), dtype=torch.float32, device=points.device)
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream(points.device).cuda_stream
        err = lib.houv_fps_global(points.data_ptr(), bsz, n, k,
                                  work.data_ptr(), out.data_ptr(), stream)
    check(lib, err, "fps_global")
    furthest_point_sample.global_launches += 1
    return out


def _fps_cuda(points: torch.Tensor, k: int) -> torch.Tensor:
    from houv_tpu_torch.kernels import check, load

    lib = load()
    bsz, n, _ = points.shape
    max_points = lib.houv_fps_max_points()
    if n > max_points:
        if _fps_route(n, max_points,
                      lib.houv_fps_large_max_points()) == "fps_large":
            return _fps_large_cuda(points, k)
        return _fps_global_cuda(points, k)
    out = torch.empty((bsz, k), dtype=torch.int64, device=points.device)
    warps, per = _fps_plan(n)
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream(points.device).cuda_stream
        err = lib.houv_fps(points.data_ptr(), bsz, n, k, warps, per,
                           out.data_ptr(), stream)
    check(lib, err, "fps")
    furthest_point_sample.launches += 1
    return out


def furthest_point_sample(points: torch.Tensor, k: int,
                          device: str | torch.device = "cuda") -> torch.Tensor:
    """(B, N, 3) -> (B, k) int64 indices; the first is always 0.

    On ``cuda`` this launches ``csrc/fps.cu`` and counts the launch in
    ``furthest_point_sample.launches``, or for clouds above its limit
    ``csrc/fps_large.cu``, counted in ``.large_launches``, or above that
    one's capacity ``csrc/fps_global.cu``, counted in ``.global_launches``;
    the plain version runs only for tensors on the CPU, with
    ``device="cpu"``."""
    dev = resolve_device(device)
    check_on(dev, points)
    if points.dim() != 3 or points.shape[-1] != 3:
        raise ValueError(f"expected (B, N, 3) points, got {points.shape}")
    if not 1 <= k or points.shape[1] < 1:
        raise ValueError(f"need k >= 1 and at least one point, got k={k}")
    points = points.detach().float().contiguous()
    if dev.type == "cuda":
        return _fps_cuda(points, k)
    return _fps_plain(points, k)


furthest_point_sample.launches = 0
furthest_point_sample.large_launches = 0
furthest_point_sample.global_launches = 0


def furthest_point_sample_with_dist(dist: torch.Tensor, k: int) -> torch.Tensor:
    """FPS over a precomputed (B, N, N) squared-distance matrix -> (B, k)
    int64 indices: the first is 0, each next one the point furthest from
    those taken (its least distance to them, from rows of ``dist``), ties
    to the lowest index."""
    bsz, n, _ = dist.shape
    rows = torch.arange(bsz, device=dist.device)
    min_d = torch.full((bsz, n), 1e10, dtype=dist.dtype, device=dist.device)
    idxs = torch.zeros((bsz, k), dtype=torch.int64, device=dist.device)
    last = torch.zeros(bsz, dtype=torch.int64, device=dist.device)
    for i in range(1, k):
        min_d = torch.minimum(min_d, dist[rows, last])
        last = min_d.argmax(-1)
        idxs[:, i] = last
    return idxs
