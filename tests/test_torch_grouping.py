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
    """The wide form (C > 8) has no CUDA kernel yet; on CPU tensors the
    plain version serves it, with the same contract."""
    q = rng.standard_normal((2, 50, 24)).astype(np.float32)
    r = rng.standard_normal((2, 80, 24)).astype(np.float32)
    neg, idx = tg.knn_points(torch.tensor(q), torch.tensor(r), 5)
    d = _sqdist64(q, r)
    np.testing.assert_array_equal(idx.numpy(),
                                  np.argsort(d, -1, kind="stable")[..., :5])
    np.testing.assert_allclose(-neg.numpy(),
                               np.sort(d, -1)[..., :5], rtol=1e-5)


def test_knn_wide_raises_on_cuda(monkeypatch):
    """C > 8 asked of the card raises NotImplementedError naming the
    ROADMAP item (a card and the tensors' placement are faked here, since
    the check comes before any launch)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tg, "check_on", lambda dev, *tensors: None)
    q = torch.zeros((1, 16, 24))
    with pytest.raises(NotImplementedError, match="K6-wide"):
        tg.knn_indices(q, q, 4, device="cuda")


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
