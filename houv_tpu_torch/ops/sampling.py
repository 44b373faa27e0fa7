"""Furthest point sampling.

Counterpart of ``houv_tpu/ops/sampling.py``. ``furthest_point_sample``
launches the hand-written CUDA kernel ``csrc/fps.cu`` (replacing the TPU
kernel ``_fps_kernel``) on CUDA tensors and runs its plain PyTorch version
``_fps_plain`` (the loop of ``_fps_xla``) on CPU tensors; clouds above
``fps.cu``'s 8192 points go to ``csrc/fps_large.cu``, which takes any size. Contract: indices
(B, K) int64, the first is 0, then the point furthest from the selected set,
ties to the first occurrence. ``furthest_point_sample_with_dist`` runs the
same selection over a precomputed distance matrix (plain PyTorch, as its
JAX counterpart is plain JAX).
"""

from __future__ import annotations

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


def _fps_route(n: int, max_points: int) -> str:
    """Which kernel takes clouds of n points: ``csrc/fps.cu`` ("fps") up to
    its limit (``houv_fps_max_points()``, 8192), ``csrc/fps_large.cu``
    ("fps_large": the cloud and its minima in global memory, any n) above
    it."""
    return "fps" if n <= max_points else "fps_large"


def _fps_cuda(points: torch.Tensor, k: int) -> torch.Tensor:
    from houv_tpu_torch.kernels import check, load

    lib = load()
    bsz, n, _ = points.shape
    out = torch.empty((bsz, k), dtype=torch.int64, device=points.device)
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream(points.device).cuda_stream
        if _fps_route(n, lib.houv_fps_max_points()) == "fps_large":
            work = torch.empty((bsz, n, 4), dtype=torch.float32,
                               device=points.device)
            err = lib.houv_fps_large(points.data_ptr(), bsz, n, k,
                                     work.data_ptr(), out.data_ptr(), stream)
            check(lib, err, "fps_large")
            furthest_point_sample.large_launches += 1
            return out
        warps, per = _fps_plan(n)
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
    ``csrc/fps_large.cu``, counted in ``.large_launches``; the plain
    version runs only for tensors on the CPU, with ``device="cpu"``."""
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
