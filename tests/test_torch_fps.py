"""The launch plan and the selection of the furthest-point sampling kernel
(``csrc/fps.cu``), on the CPU.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``). Here its plan (``ops/sampling.py:_fps_plan``) is checked
for every cloud size it takes, the wrapper's launch on a faked card, the
order of a non-negative float's bits that the warp argmax relies on, and a
numpy model of the kernel's whole selection (each thread's points, in
ascending index, reduced in a tree with strict >; the warp's largest key,
then the smallest index among the lanes that hold it; the slots of the
warps reduced the same way) against ``_fps_plain`` index for index, on
clouds full of exact ties; the model fails when its tie rule is
flipped. JAX parity at K == N and on a grid of ties completes
``tests/test_torch_sampling.py``.
"""

import contextlib
import importlib
import math
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from houv_tpu_torch.ops import sampling as ts

jsampling = importlib.import_module("houv_tpu.ops.sampling")

NONE = 0xFFFFFFFF                # an index no point has
SCAN_WARPS = 4                   # csrc/fps.cu's kScanWarps
TARGETS = (32, 128, 256, 512, 1024)


def _warp_argmax(keys, idx, first=True):
    """Two redux.sync over the last axis: the largest key, then the
    smallest index among the lanes that hold it (the largest with
    ``first=False``)."""
    m = keys.max(-1)
    held = keys == m[..., None]
    if first:
        return m, np.where(held, idx, NONE).min(-1)
    return m, np.where(held, idx, 0).max(-1)


def _scan_slots(keys, idx, first=True):
    """The kernel's scan of up to 4 slots (B, warps): pairwise in a tree,
    a slot beating another with a larger key, or the same and a smaller
    index (a larger with ``first=False``); absent slots hold (0, none)
    (with ``first=False``, (0, 0))."""
    pad = 4 - keys.shape[1]
    keys = np.pad(keys, ((0, 0), (0, pad)))
    idx = np.pad(idx, ((0, 0), (0, pad)), constant_values=NONE if first else 0)

    def beats(j, i):
        closer = idx[:, j] < idx[:, i] if first else idx[:, j] > idx[:, i]
        return (keys[:, j] > keys[:, i]) | ((keys[:, j] == keys[:, i])
                                            & closer)

    for i, j in ((0, 1), (2, 3), (0, 2)):
        take = beats(j, i)
        keys[:, i] = np.where(take, keys[:, j], keys[:, i])
        idx[:, i] = np.where(take, idx[:, j], idx[:, i])
    return idx[:, 0]


def model_fps(pts, k, warps, per, strict=True, first=True):
    """The kernel's picks for (B, N, 3) f32 points with ``warps`` warps of
    ``per`` points a thread: point i = q * 32 warps + t lives in thread t;
    padding holds the key 0 and indices >= N. ``strict=False`` takes >= in
    the thread's tree, ``first=False`` the largest index in the warp and
    slot reductions."""
    b, n, _ = pts.shape
    threads = 32 * warps
    span = threads * per
    assert span >= n
    xyz = np.zeros((b, span, 3), np.float32)
    xyz[:, :n] = pts
    mind = np.zeros((b, span), np.float32)
    mind[:, :n] = 1e10
    rows = np.arange(b)
    out = np.zeros((b, k), np.int64)
    last = np.zeros(b, np.int64)
    for step in range(1, k):
        lx, ly, lz = (xyz[rows, last, c][:, None] for c in range(3))
        dx, dy, dz = xyz[..., 0] - lx, xyz[..., 1] - ly, xyz[..., 2] - lz
        mind = np.minimum(mind, (dx * dx + dy * dy) + dz * dz)
        v = mind.reshape(b, per, threads).copy()
        ids = np.broadcast_to(np.arange(per)[:, None], v.shape).copy()
        s = 1
        while s < per:                # lower indices on the left
            for q in range(0, per - s, 2 * s):
                right, left = v[:, q + s], v[:, q]
                take = right > left if strict else right >= left
                v[:, q] = np.where(take, right, left)
                ids[:, q] = np.where(take, ids[:, q + s], ids[:, q])
            s *= 2
        keys = v[:, 0].view(np.uint32).astype(np.int64)
        idx = ids[:, 0] * threads + np.arange(threads)
        wk, wi = _warp_argmax(keys.reshape(b, warps, 32),
                              idx.reshape(b, warps, 32), first)
        if 1 < warps <= SCAN_WARPS:   # every thread scans the slots
            wi = _scan_slots(wk, wi, first)
        elif warps > 1:           # lanes past the slots: (0, none), never won
            wk, wi = _warp_argmax(wk, wi, first)
        last = wi.reshape(b)
        out[:, step] = last
    return out


def _plain(pts, k):
    return ts._fps_plain(torch.as_tensor(pts), k).numpy()


def _grid(rng, b, n, c):
    return rng.integers(0, c, (b, n, 3)).astype(np.float32)


def _twice(rng, b, n):
    half = rng.standard_normal((b, n // 2, 3)).astype(np.float32)
    return np.concatenate([half, half], 1)


@pytest.mark.parametrize("threads", TARGETS)
@pytest.mark.parametrize("case", ["normal", "grid", "twice"])
def test_model_matches_plain(rng, threads, case):
    """Index for index, at every target block size: random clouds, integer
    grids (the running minima tie everywhere) and every point twice at
    K == N (the last picks' minima are all 0)."""
    if case == "normal":
        pts, k = rng.standard_normal((3, 1000, 3)).astype(np.float32), 300
    elif case == "grid":
        pts, k = _grid(rng, 2, 700, 4), 700
    else:
        pts, k = _twice(rng, 2, 512), 512
    warps, per = ts._fps_plan(pts.shape[1], threads)
    np.testing.assert_array_equal(model_fps(pts, k, warps, per),
                                  _plain(pts, k))


@pytest.mark.parametrize("n,k", [(1, 1), (1, 4), (5, 8), (31, 31), (33, 33),
                                 (257, 257), (1025, 300)])
@pytest.mark.parametrize("threads", (32, 256, 1024))
def test_model_off_the_blocks(rng, n, k, threads):
    """N off a warp's and a block's multiple (padding in the last warp or
    in whole warps), one point, and K > N."""
    pts = _grid(rng, 2, n, 3)
    warps, per = ts._fps_plan(n, threads)
    np.testing.assert_array_equal(model_fps(pts, k, warps, per),
                                  _plain(pts, k))


@pytest.mark.parametrize("threads", (128, 512))
@pytest.mark.parametrize("flip", ["strict", "first"])
def test_model_fails_with_the_tie_rule_flipped(rng, flip, threads):
    """>= in the thread's tree, or the largest index in the warp's and the
    slots' reductions (the slot scan of 2 to 4 warps, the redux of more),
    picks other points on a grid of ties: the tests above can see a wrong
    tie rule."""
    pts = _grid(rng, 2, 700, 4)
    warps, per = ts._fps_plan(700, threads)
    assert warps > 1 and per > 1 and (warps <= SCAN_WARPS) == (threads < 256)
    flipped = model_fps(pts, 300, warps, per, strict=flip != "strict",
                        first=flip != "first")
    assert (flipped != _plain(pts, 300)).any()


def _bits(x):
    return int(np.float32(x).view(np.uint32))


@settings(max_examples=300, deadline=None)
@given(st.floats(min_value=0.0, width=32, allow_subnormal=True),
       st.floats(min_value=0.0, width=32, allow_subnormal=True))
@example(0.0, 1e-45)
@example(1e-45, 1.1754942e-38)
@example(1.1754942e-38, 1.1754944e-38)
@example(1e10, 3.4028235e38)
@example(1e10, 1e10)
def test_uint_order_of_non_negative_floats(a, b):
    """For floats >= +0 (0, subnormals, 1e10, inf) the bits compare as
    unsigned ints exactly as the floats compare."""
    assert math.copysign(1.0, a) > 0 and math.copysign(1.0, b) > 0
    assert (a < b) == (_bits(a) < _bits(b))
    assert (a == b) == (_bits(a) == _bits(b))


@settings(max_examples=300, deadline=None)
@given(st.lists(st.floats(width=32, allow_nan=False, allow_infinity=False,
                          allow_subnormal=True), min_size=6, max_size=6))
@example([0.0, -0.0, 0.0, 0.0, -0.0, 0.0])
@example([-1e-45, 0.0, 1e-45, 0.0, 0.0, -0.0])
def test_a_distance_is_never_negative_zero(c):
    """A distance rounded op by op is a sum of squares: its sign bit is
    never set, so its key is never above inf's or below +0's."""
    x, y, z, lx, ly, lz = (np.float32(v) for v in c)
    with np.errstate(over="ignore"):
        dx, dy, dz = x - lx, y - ly, z - lz
        d = (dx * dx + dy * dy) + dz * dz
    assert not np.signbit(d)


@pytest.mark.parametrize("threads", (None,) + TARGETS)
def test_plan_covers_every_size_to_the_limit(threads):
    """For every N from 1 to 8192: points a thread a power of two up to 32,
    the block within the kernel's bound for them, the threads' points
    covering the cloud, and no warp of padding alone."""
    for n in range(1, 8193):
        warps, per = ts._fps_plan(n, threads)
        assert per in ts._FPS_MAX_THREADS
        assert 1 <= warps and 32 * warps <= ts._FPS_MAX_THREADS[per]
        assert 32 * warps * per >= n > 32 * (warps - 1) * per
    with pytest.raises(ValueError, match="at most 8192 points"):
        ts._fps_plan(8193, threads)


def test_plan_at_the_paths_cloud_sizes():
    """The default plan, (warps, points a thread), at the sizes K2 runs on:
    the fastest measured block for each."""
    want = {256: (1, 8), 768: (3, 8), 1024: (4, 8), 1536: (3, 16),
            2048: (4, 16), 3072: (12, 8), 4096: (4, 32), 8192: (8, 32)}
    assert {n: ts._fps_plan(n) for n in want} == want


def test_plan_keeps_to_its_target_where_it_can():
    """The block is the target's size or smaller while the target's
    points a thread stay within the kernel's bound for them."""
    for threads in TARGETS:
        for n in (1, 64, 256, 1024, 2048, 3072, 4096, 8192):
            warps, per = ts._fps_plan(n, threads)
            if n <= threads * 32 and threads <= ts._FPS_MAX_THREADS[per]:
                assert 32 * warps <= threads


class _FakeLib:
    """Stands in for the built kernel library: records the entry's sizes
    and plan, and launches nothing."""

    def __init__(self):
        self.calls = []

    def houv_fps_max_points(self):
        return 8192

    def houv_fps(self, pts, b, n, k, warps, per, out, stream):
        self.calls.append((b, n, k, warps, per))
        return 0


@pytest.mark.parametrize("n,k", [(1, 1), (256, 64), (2048, 1024),
                                 (3072, 2048), (8192, 300)])
def test_fps_hands_the_kernel_its_plan(monkeypatch, n, k):
    """On ``cuda`` the wrapper passes ``_fps_plan``'s warps and points a
    thread; one launch counted, the plain version never run (card,
    placement and stream faked: the routing is Python)."""
    from houv_tpu_torch import kernels

    lib = _FakeLib()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(ts, "check_on", lambda dev, *tensors: None)
    monkeypatch.setattr(kernels, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(ts, "_fps_plain", None)
    monkeypatch.setattr(ts.furthest_point_sample, "launches", 0)
    out = ts.furthest_point_sample(torch.zeros((2, n, 3)), k, device="cuda")
    assert out.shape == (2, k) and out.dtype == torch.int64
    assert lib.calls == [(2, n, k, *ts._fps_plan(n))]
    assert ts.furthest_point_sample.launches == 1


def test_fps_refuses_more_than_the_limit_before_launching(monkeypatch):
    """Above fps.cu's 8192 points the kernel is never launched: the cloud
    goes to ``csrc/fps_large.cu`` (``tests/test_torch_large_clouds.py``),
    counted apart; nothing raises."""
    from houv_tpu_torch import kernels

    lib = _FakeLib()
    large = []
    lib.houv_fps_large_max_points = lambda: 65536
    lib.houv_fps_large = lambda pts, b, n, k, c, warps, per, out, stream: (
        large.append((b, n, k)) or 0)
    monkeypatch.setattr(ts, "_held", lambda c, warps, per, index: 16)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(ts, "check_on", lambda dev, *tensors: None)
    monkeypatch.setattr(kernels, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(ts.furthest_point_sample, "launches", 0)
    monkeypatch.setattr(ts.furthest_point_sample, "large_launches", 0)
    ts.furthest_point_sample(torch.zeros((1, 8193, 3)), 4, device="cuda")
    assert lib.calls == [] and ts.furthest_point_sample.launches == 0
    assert large == [(1, 8193, 4)]
    assert ts.furthest_point_sample.large_launches == 1


@pytest.mark.parametrize("case", ["k_equals_n", "grid"])
def test_plain_matches_jax_at_k_equals_n_and_on_ties(rng, case):
    """The plain version against the TPU kernel (interpreted) and
    ``_fps_xla``: every point picked, and an integer grid where the
    running minima tie at every step."""
    if case == "k_equals_n":
        pts, k = rng.standard_normal((2, 96, 3)).astype(np.float32), 96
    else:
        pts, k = _grid(rng, 2, 200, 3), 120
    ours = _plain(pts, k)
    pallas = jsampling._fps_pallas(jnp.asarray(pts), k, interpret=True)
    xla = jsampling._fps_xla(jnp.asarray(pts), k)
    np.testing.assert_array_equal(ours, np.asarray(xla))
    np.testing.assert_array_equal(ours, np.asarray(pallas))
