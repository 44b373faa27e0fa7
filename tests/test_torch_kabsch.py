"""``houv_tpu_torch/geometry/kabsch.py`` against ``houv_tpu/geometry/
kabsch.py`` on the CPU: the same (R, t) within 1e-5 on random, weighted,
reflected and batched point sets (an SVD is not unique, so R and t are
compared, never U or V), and det(R) = +1."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from houv_tpu.geometry.kabsch import kabsch as j_kabsch
from houv_tpu.geometry.kabsch import weighted_kabsch as j_weighted
from houv_tpu.geometry.rotations import rodrigues as j_rodrigues
from houv_tpu_torch.geometry import kabsch, weighted_kabsch
from houv_tpu_torch.geometry.kabsch import det3

TOL = 1e-5


def _pose(rng, lead):
    axes = rng.normal(size=lead + (3,)).astype(np.float32)
    angles = rng.uniform(0.1, 3.0, lead).astype(np.float32)
    r = np.asarray(j_rodrigues(jnp.asarray(angles), jnp.asarray(axes)))
    return r, rng.uniform(-0.5, 0.5, lead + (3,)).astype(np.float32)


def _case(rng, kind):
    """(src, tgt, weights) of one kind of problem."""
    lead = (3, 2) if kind == "batched" else (5,)
    n = 64
    src = rng.normal(size=lead + (n, 3)).astype(np.float32)
    r, t = _pose(rng, lead)
    tgt = np.einsum("...ij,...nj->...ni", r, src) + t[..., None, :]
    w = np.ones(lead + (n,), np.float32)
    if kind == "noisy":
        tgt = tgt + 0.05 * rng.normal(size=tgt.shape)
    elif kind == "weighted":
        tgt = tgt + 0.05 * rng.normal(size=tgt.shape)
        w = rng.uniform(0, 2, w.shape).astype(np.float32)
        w[..., ::3] = 0.0                     # outliers out
        tgt[..., ::3, :] += 3.0
    elif kind == "reflection":
        # the best orthogonal map is a reflection: the fix must turn it
        # into the best rotation, det +1
        tgt = src * np.array([1.0, 1.0, -1.0], np.float32) \
            + 0.01 * rng.normal(size=src.shape)
    elif kind == "planar":
        src[..., 2] = 0.0                     # a degenerate direction
        tgt = np.einsum("...ij,...nj->...ni", r, src) + t[..., None, :]
    return src, tgt.astype(np.float32), w


@pytest.mark.parametrize("kind", ["exact", "noisy", "weighted", "reflection",
                                  "planar", "batched"])
def test_weighted_kabsch_matches_jax(rng, kind):
    src, tgt, w = _case(rng, kind)
    rj, tj = j_weighted(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(w))
    r, t = weighted_kabsch(torch.tensor(src), torch.tensor(tgt),
                           torch.tensor(w))
    np.testing.assert_allclose(r.numpy(), np.asarray(rj), atol=TOL)
    np.testing.assert_allclose(t.numpy(), np.asarray(tj), atol=TOL)
    np.testing.assert_allclose(det3(r).numpy(), 1.0, atol=TOL)
    if kind == "exact":
        # noise-free: the pose itself
        np.testing.assert_allclose(
            np.einsum("...ij,...nj->...ni", r.numpy(), src)
            + t.numpy()[..., None, :], tgt, atol=1e-4)


def test_kabsch_is_uniform_weights_and_matches_jax(rng):
    src, tgt, _ = _case(rng, "noisy")
    rj, tj = j_kabsch(jnp.asarray(src), jnp.asarray(tgt))
    r, t = kabsch(torch.tensor(src), torch.tensor(tgt))
    np.testing.assert_allclose(r.numpy(), np.asarray(rj), atol=TOL)
    np.testing.assert_allclose(t.numpy(), np.asarray(tj), atol=TOL)
    # weights need not be normalised
    r2, t2 = weighted_kabsch(torch.tensor(src), torch.tensor(tgt),
                             torch.full(src.shape[:-1], 7.0))
    np.testing.assert_allclose(r2.numpy(), r.numpy(), atol=TOL)
    np.testing.assert_allclose(t2.numpy(), t.numpy(), atol=TOL)


def test_det3_matches_numpy(rng):
    m = rng.normal(size=(10, 3, 3)).astype(np.float32)
    np.testing.assert_allclose(det3(torch.tensor(m)).numpy(),
                               np.linalg.det(m), rtol=1e-5, atol=1e-6)
