"""Clouds above the card kernels' size limits, on the CPU: which kernel the
wrappers send each size to (pure Python over a faked card), and the plain
versions that the card's variants are held to, against the JAX package.

K2 (``csrc/fps.cu``) takes up to 8192 points a cloud; above that
``ops/sampling.py`` sends the cloud to ``csrc/fps_large.cu``. K7
(``csrc/emd.cu``) keeps a pair's state in one block's shared memory (28
bytes an item, 8 a bidder, at most 231424 bytes); above that
``ops/emd.py`` sends the pair to ``csrc/emd_large.cu``. Below the limits
both plans are as before, and no size raises. The plain FPS at 9000 points
picks what JAX's ``furthest_point_sample(use_pallas=False)`` picks, index
for index; the plain auction above K7's limit returns JAX's assignment."""

import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from houv_tpu.ops import emd as jemd
from houv_tpu.ops import sampling as jsampling
from houv_tpu_torch import kernels
from houv_tpu_torch.ops import emd as temd
from houv_tpu_torch.ops import sampling as tsampling

FPS_MAX = 8192
EMD_MAX_SMEM = 232448 - 1024


def _emd_smem(n, m):
    """``houv_emd_smem_bytes``: the items' float4, key and owner, the
    bidders' two lists."""
    return 28 * m + 8 * n


@pytest.mark.parametrize("n,route", [(1, "fps"), (2048, "fps"),
                                     (8192, "fps"), (8193, "fps_large"),
                                     (16384, "fps_large"),
                                     (10 ** 7, "fps_large")])
def test_fps_routes_each_size_to_a_kernel(n, route):
    assert tsampling._fps_route(n, FPS_MAX) == route
    if route == "fps":
        warps, per = tsampling._fps_plan(n)
        assert 32 * warps * per >= n


@pytest.mark.parametrize("n,m,route", [
    (2048, 2048, "emd"), (6428, 6428, "emd"), (28924, 1, "emd"),
    (1, 8264, "emd"), (6429, 6429, "emd_large"), (28925, 1, "emd_large"),
    (1, 8265, "emd_large"), (8192, 8192, "emd_large"),
    (16384, 16384, "emd_large"), (3000, 40000, "emd_large")])
def test_emd_routes_each_size_to_a_kernel(n, m, route):
    assert temd._emd_route(_emd_smem(n, m), EMD_MAX_SMEM) == route


@pytest.mark.parametrize("b,plan", [(1, 8), (2, 8), (15, 8), (16, 4),
                                    (30, 4), (31, 2), (66, 2), (67, 1),
                                    (500, 1)])
def test_emd_large_plan_takes_the_largest_cluster_that_fits(b, plan):
    # an H100's counts for emd_large.cu's blocks of 1024 threads
    assert temd._emd_large_plan(b, {8: 15, 4: 30, 2: 66}) == plan


class _FakeLib:
    """The built library's entries, recording what they are handed."""

    def __init__(self):
        self.calls = []

    def houv_fps_max_points(self):
        return FPS_MAX

    def houv_fps(self, pts, b, n, k, warps, per, out, stream):
        self.calls.append(("fps", b, n, k))
        return 0

    def houv_fps_large(self, pts, b, n, k, work, out, stream):
        self.calls.append(("fps_large", b, n, k))
        return 0

    def houv_emd_smem_bytes(self, n, m):
        return _emd_smem(n, m)

    def houv_emd_max_smem_bytes(self):
        return EMD_MAX_SMEM

    def houv_emd(self, *args):
        self.calls.append(("emd", *args[2:5], args[7]))
        return 0

    def houv_emd_large(self, *args):
        self.calls.append(("emd_large", *args[2:5], args[7]))
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for mod in (tsampling, temd):
        monkeypatch.setattr(mod, "check_on", lambda dev, *tensors: None)
    monkeypatch.setattr(kernels, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(temd, "_max_large_clusters",
                        lambda index: {8: 15, 4: 30, 2: 66})
    monkeypatch.setattr(temd, "_card_plan", lambda b, n, m, dev: 3)
    for fn in (tsampling.furthest_point_sample, temd.emd_auction_with_stats):
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "large_launches", 0)
    return lib


def test_fps_launches_the_large_variant_above_the_limit(fake_card):
    fps = tsampling.furthest_point_sample
    for n in (8192, 8193, 20000):
        out = fps(torch.zeros((2, n, 3)), 64, device="cuda")
        assert out.shape == (2, 64) and out.dtype == torch.int64
    assert fake_card.calls == [("fps", 2, 8192, 64),
                               ("fps_large", 2, 8193, 64),
                               ("fps_large", 2, 20000, 64)]
    assert (fps.launches, fps.large_launches) == (1, 2)


def test_emd_launches_the_large_variant_above_the_limit(fake_card):
    run = temd.emd_auction_with_stats
    for n, m in ((6428, 6428), (6429, 6429), (2, 20000)):
        d, a, r, b = run(torch.zeros((2, n, 3)), torch.zeros((2, m, 3)),
                         0.004, 10, device="cuda")
        assert d.shape == a.shape == (2, n) and r.shape == b.shape == (2,)
    assert fake_card.calls == [("emd", 2, 6428, 6428, 3),
                               ("emd_large", 2, 6429, 6429, 8),
                               ("emd_large", 2, 2, 20000, 8)]
    assert (run.launches, run.large_launches) == (1, 2)
    # the variant's launch at a size that fits emd.cu (the card's checks)
    temd._emd_large_cuda(torch.zeros((3, 50, 3)), torch.zeros((3, 60, 3)),
                         0.005, 5, clusters=2)
    assert fake_card.calls[-1] == ("emd_large", 3, 50, 60, 2)


def test_plain_fps_above_the_limit_matches_jax(rng):
    pts = rng.standard_normal((2, 9000, 3)).astype(np.float32)
    ref = np.asarray(jsampling.furthest_point_sample(
        jnp.asarray(pts), 300, use_pallas=False))
    got = tsampling.furthest_point_sample(torch.as_tensor(pts), 300,
                                          device="cpu")
    np.testing.assert_array_equal(got.numpy(), ref)


def test_plain_auction_above_the_limit_matches_jax(rng):
    """6500 bidders against 6500 items, past K7's shared memory: the
    assignment JAX's XLA auction gives; the distances the matched pairs'
    (diff form, 1e-6 relative) and JAX's within 1e-6 (JAX forms them from
    the expansion |a|² + |b|² - 2 a·b, about 1e-7 off at these
    coordinates)."""
    x1 = rng.uniform(-0.5, 0.5, (1, 6500, 3)).astype(np.float32)
    x2 = rng.uniform(-0.5, 0.5, (1, 6500, 3)).astype(np.float32)
    assert _emd_smem(6500, 6500) > EMD_MAX_SMEM
    d, a = temd.emd_auction(torch.as_tensor(x1), torch.as_tensor(x2),
                            0.005, 3)
    jd, ja = jemd.emd_auction(jnp.asarray(x1), jnp.asarray(x2), 0.005, 3)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    matched = np.take_along_axis(x2, a.numpy()[..., None], 1)
    np.testing.assert_allclose(d.numpy(), ((x1 - matched) ** 2).sum(-1),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=1e-6)
