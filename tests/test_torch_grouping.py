"""The port's kNN, gathers and three-NN interpolation against the JAX
package's, on the CPU.

The JAX side runs as its own tests run it: the TPU kNN kernel in interpret
mode (``knn_indices_pallas``, whose packed key selects at 2^-(23-idx_bits)
relative, idx_bits the bits of the padded ref count) and the XLA path of
``knn_points`` (selection on the expansion form |q|²-2q·r+|r|², off by up to
a few 2^-24·(|q|²+|r|²) absolute). The port selects on the exact f32 diff
form. So indices are compared where consecutive candidates are further
apart than both selections' errors, and everywhere the distances of each
package's picks agree within that package's own selection error.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from houv_tpu.ops import grouping as jg
from houv_tpu.ops import interpolate as ji
from houv_tpu_torch.ops import grouping as tg
from houv_tpu_torch.ops import interpolate as ti

def _sqdist64(q, r):
    return ((q[:, :, None].astype(np.float64)
             - r[:, None].astype(np.float64)) ** 2).sum(-1)


def _tpu_key_rel(n):
    """Relative selection precision of the TPU kernel's packed key."""
    idx_bits = (-(-n // 128) * 128 - 1).bit_length()
    return 2.0 ** -(23 - idx_bits)


def _clear_rows(q, r, k, gap):
    """Per query, True where each of the k+1 nearest leads the next by more
    than ``gap`` relative: there the order of the first k is unambiguous."""
    d = np.sort(_sqdist64(q, r), -1)[..., :k + 1]
    gaps = (d[..., 1:] - d[..., :-1]) / np.maximum(d[..., 1:], 1e-30)
    return (gaps > gap).all(-1)


@pytest.mark.parametrize("b,m,n,k", [(2, 200, 300, 8), (1, 129, 1000, 20),
                                     (3, 64, 17, 17)])
def test_knn_points_against_jax(rng, b, m, n, k):
    q = rng.standard_normal((b, m, 3)).astype(np.float32)
    r = rng.standard_normal((b, n, 3)).astype(np.float32)
    neg, idx = tg.knn_points(torch.tensor(q), torch.tensor(r), k)
    ours = idx.numpy()
    assert idx.dtype == torch.int64 and ours.shape == (b, m, k)
    # values: negated squared distances, exactly descending, equal to the
    # distances of the selected pairs
    assert (neg[..., :-1] >= neg[..., 1:]).all()
    d64 = np.take_along_axis(_sqdist64(q, r), ours, -1)
    np.testing.assert_allclose(-neg.numpy(), d64, rtol=1e-6, atol=0)
    key_rel = _tpu_key_rel(n)
    expansion_abs = 8 * 2.0**-24 * float((q**2).sum(-1).max()
                                         + (r**2).sum(-1).max())
    clear = _clear_rows(q, r, k, 2 * key_rel)
    assert clear.mean() > 0.5
    jneg, jidx = jg.knn_points(jnp.asarray(q), jnp.asarray(r), k)
    pidx = jg.knn_indices_pallas(jnp.asarray(q), jnp.asarray(r), k,
                                 interpret=True)
    for ref, tol in ((np.asarray(jidx), dict(rtol=0, atol=expansion_abs)),
                     (np.asarray(pidx), dict(rtol=2 * key_rel, atol=0))):
        np.testing.assert_array_equal(ours[clear], ref[clear])
        # elsewhere the picks are equally near, within that selection's
        # error
        np.testing.assert_allclose(
            d64, np.take_along_axis(_sqdist64(q, r), ref.astype(np.int64),
                                    -1), **tol)
    np.testing.assert_allclose(neg.numpy(), np.asarray(jneg), rtol=1e-5,
                               atol=1e-6)


def test_knn_exact_ties_go_to_the_smaller_index(rng):
    r = rng.standard_normal((1, 60, 3)).astype(np.float32)
    r[0, 30:] = r[0, :30]                      # every point twice
    _, idx = tg.knn_points(torch.tensor(r), torch.tensor(r), 4)
    pidx = jg.knn_indices_pallas(jnp.asarray(r), jnp.asarray(r), 4,
                                 interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(pidx))
    assert (idx[0, :30, 0].numpy() == np.arange(30)).all()
    assert (idx[0, :30, 1].numpy() == np.arange(30, 60)).all()


def test_knn_self_and_gathers(rng):
    x = rng.standard_normal((2, 5, 40)).astype(np.float32)   # (B, C, N)
    np.testing.assert_array_equal(
        tg.knn(torch.tensor(x[:, :3]), 6).numpy(),
        np.asarray(jg.knn(jnp.asarray(x[:, :3]), 6)))
    idx = rng.integers(0, 40, (2, 7, 3))
    np.testing.assert_array_equal(
        tg.grouping_operation(torch.tensor(x), torch.tensor(idx)).numpy(),
        np.asarray(jg.grouping_operation(jnp.asarray(x), jnp.asarray(idx))))
    np.testing.assert_array_equal(
        tg.gather_points(torch.tensor(x), torch.tensor(idx[..., 0])).numpy(),
        np.asarray(jg.gather_points(jnp.asarray(x), jnp.asarray(idx[..., 0]))))
    pts = np.swapaxes(x, 1, 2)
    np.testing.assert_array_equal(
        tg.index_points(torch.tensor(pts), torch.tensor(idx)).numpy(),
        np.asarray(jg.index_points(jnp.asarray(pts), jnp.asarray(idx))))


def test_knn_feature_space_runs_plain_on_the_cpu(rng):
    """The wide form (any C but 3) on CPU tensors: the plain version serves it,
    with the coordinate form's contract."""
    q = rng.standard_normal((2, 50, 24)).astype(np.float32)
    r = rng.standard_normal((2, 80, 24)).astype(np.float32)
    neg, idx = tg.knn_points(torch.tensor(q), torch.tensor(r), 5)
    d = _sqdist64(q, r)
    np.testing.assert_array_equal(idx.numpy(),
                                  np.argsort(d, -1, kind="stable")[..., :5])
    np.testing.assert_allclose(-neg.numpy(),
                               np.sort(d, -1)[..., :5], rtol=1e-5)


class _FakeLib:
    """Stands in for the built kernel library: records which entry the
    wrapper calls and with what sizes, and launches nothing."""

    def __init__(self):
        self.calls = []

    def houv_knn_max_k(self):
        return 64

    def houv_knn_wide_max_k(self):
        return 64

    def houv_knn(self, q, r, b, m, n, k, per, length, scratch, out,
                 stream):
        self.calls.append(("houv_knn", b, m, n, k))
        return 0

    def houv_knn_wide(self, q, r, b, m, n, c, k, length, scratch, out,
                      stream):
        self.calls.append(("houv_knn_wide", b, m, n, c, k))
        self.plan = (length, scratch is not None)
        return 0


@pytest.mark.parametrize("c,entry", [(24, "houv_knn_wide"), (5, "houv_knn_wide"),
                                     (3, "houv_knn")])
def test_knn_on_cuda_takes_its_kernel_and_never_the_plain_version(
        monkeypatch, c, entry):
    """With ``device="cuda"`` the wide form (any C but 3) reaches
    ``_knn_cuda``'s wide entry, the coordinate form the other, each counted
    in its own counter, and ``_knn_plain`` is never called. A card, the
    tensors' placement, the stream and the library are faked here: the
    routing is Python."""
    import contextlib
    import types

    from houv_tpu_torch import kernels

    lib = _FakeLib()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tg, "check_on", lambda dev, *tensors: None)
    monkeypatch.setattr(kernels, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))

    def no_plain(*args):
        raise AssertionError("the plain version ran for device='cuda'")

    monkeypatch.setattr(tg, "_knn_plain", no_plain)
    monkeypatch.setattr(tg.knn_indices, "launches", 0)
    monkeypatch.setattr(tg.knn_indices, "wide_launches", 0)
    q = torch.zeros((2, 16, c))
    out = tg.knn_indices(q, q[:, :9], 4, device="cuda")
    assert out.shape == (2, 16, 4) and out.dtype == torch.int64
    wide = entry == "houv_knn_wide"
    assert lib.calls == [(entry, 2, 16, 9) + ((c, 4) if wide else (4,))]
    assert (tg.knn_indices.launches, tg.knn_indices.wide_launches) == \
        ((0, 1) if wide else (1, 0))
    # a launch the card refuses raises: nothing falls back
    lib.houv_knn_wide = lambda *a: 1
    lib.houv_knn = lambda *a: 1
    lib.houv_error_string = lambda err: b"invalid argument"
    with pytest.raises(RuntimeError, match="launch failed"):
        tg.knn_indices(q, q, 4, device="cuda")


@pytest.mark.parametrize("m,n,k,plan", [(16, 9, 4, (9, False)),
                                        (16, 300, 4, (16, True)),
                                        (300, 70, 40, (48, True))])
def test_wide_knn_hands_the_kernel_its_plan_and_scratch(monkeypatch, m, n, k,
                                                        plan):
    """The wrapper passes ``_wide_plan``'s part length, and scratch for the
    parts' lists only when the refs split (faked card, as above)."""
    import contextlib
    import types

    from houv_tpu_torch import kernels

    lib = _FakeLib()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tg, "check_on", lambda dev, *tensors: None)
    monkeypatch.setattr(kernels, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(tg.knn_indices, "wide_launches", 0)
    tg.knn_indices(torch.zeros((1, m, 24)), torch.zeros((1, n, 24)), k,
                   device="cuda")
    assert lib.plan == plan
    assert plan[0] == tg._wide_plan(1, m, n, k)[0]
    assert tg.knn_indices.wide_launches == 1


def test_knn_rejects_k_above_n():
    pts = torch.zeros((1, 5, 3))
    with pytest.raises(ValueError, match="k <= N"):
        tg.knn_points(pts, pts, 6)


@pytest.mark.parametrize("coincide", [False, True])
def test_three_nn_interpolate_and_upsampling(rng, coincide):
    tgt = rng.standard_normal((2, 48, 3)).astype(np.float32)
    src = rng.standard_normal((2, 20, 3)).astype(np.float32)
    if coincide:                      # FPS-derived targets hit sources
        tgt[:, :20] = src
    dist, idx = ti.three_nn(torch.tensor(tgt), torch.tensor(src))
    jdist, jidx = ji.three_nn(jnp.asarray(tgt), jnp.asarray(src))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(dist.numpy(), np.asarray(jdist), rtol=1e-6)
    idx_u, w = ti.three_nn_upsampling(torch.tensor(tgt), torch.tensor(src))
    jidx_u, jw = ji.three_nn_upsampling(jnp.asarray(tgt), jnp.asarray(src))
    np.testing.assert_array_equal(idx_u.numpy(), np.asarray(jidx_u))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-7)
    feats = rng.standard_normal((2, 7, 20)).astype(np.float32)
    out = ti.three_interpolate(torch.tensor(feats), idx_u, w)
    jout = ji.three_interpolate(jnp.asarray(feats), jidx_u, jw)
    assert out.shape == (2, 7, 48)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-6)
