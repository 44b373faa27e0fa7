"""The port's DeepGMR (``models/deepgmr.py``: ``get_rri``, ``gmm_params``,
``gmm_register``, ``GMRBackbone``, ``DeepGMR``) against the JAX package, on
the CPU.

Size: batch 2, 64 points, ``rri_size`` 20 (a kNN at k 21, the point itself
dropped), the backbone at its full widths, 16 components. Weights and
running statistics are numpy draws in the flax tree carried across by
``state_from_flax``; both packages first pick the same kNN graph.

Tolerances: the RRI features 1e-4 absolute (angles in radians from
arccos and atan2 of f32 dot products), the transforms 1e-4, the loss and
the running statistics after a train step 1e-4 relative, the rotation
error 1e-2 degrees. Gradients against JAX in f64 with both SVDs in f64
(see tests/test_torch_dcp.py), each to 1e-5 of the largest entry of its
tensor or of the whole gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from houv_tpu.models import deepgmr as jd
from houv_tpu.ops.grouping import knn_points as jknn_points
from houv_tpu_torch.models import deepgmr as td
from houv_tpu_torch.models import get_model
from houv_tpu_torch.ops.grouping import knn_indices
from test_torch_dcp import (assert_outputs_match, assert_same_stats,
                            f64_grads, flax_variables, jax_apply, ported,
                            registration_pair, t)

B, N, K = 2, 64, 20


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs one process per core."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _same_graph(x, k=K + 1):
    _, jidx = jknn_points(jnp.asarray(x), jnp.asarray(x), k)
    tidx = knn_indices(t(x), t(x), k, device="cpu")
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))


def test_rri_features_match_jax():
    src, tgt, _ = registration_pair(3)
    for x in (src, tgt):
        _same_graph(x)
        ref = np.asarray(jax.jit(jd.get_rri, static_argnums=1)(
            jnp.asarray(x), K))
        out = td.get_rri(t(x), K).numpy()
        assert out.shape == (B, N, 4 * K)
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
        # φ: the smallest positive angle, in [0, 2π)
        phi = out.reshape(B, N, K, 4)[..., 3]
        assert (phi >= 0).all() and (phi < 2 * np.pi).all()


def test_gmm_params_and_register_match_jax(rng):
    pts = rng.uniform(-0.5, 0.5, (B, N, 3)).astype(np.float32)
    logits = rng.standard_normal((B, N, 16)).astype(np.float32)
    gamma = np.asarray(jax.nn.softmax(jnp.asarray(logits), -1))
    ref = jax.jit(jd.gmm_params)(jnp.asarray(gamma), jnp.asarray(pts))
    out = td.gmm_params(t(gamma), t(pts))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    pi, mu_s, _ = out
    mu_t = mu_s @ torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0],
                                [0.0, 0.0, 1.0]]).T + 0.1
    sigma_t = out[2]
    ref = jax.jit(jd.gmm_register)(*(jnp.asarray(a.numpy()) for a in
                                     (pi, mu_s, mu_t, sigma_t)))
    got = td.gmm_register(pi, mu_s, mu_t, sigma_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    # the 90° turn about z and the shift are recovered
    np.testing.assert_allclose(got[:, :3, 3].numpy(), 0.1, atol=1e-5)


def _deepgmr(seed=0, use_rri=True):
    src, tgt, t_gt = registration_pair(seed)
    if use_rri:
        _same_graph(src)
        _same_graph(tgt)
    jm = jd.DeepGMR(use_rri=use_rri, rri_size=K)
    v = flax_variables(jm, src, tgt, t_gt, seed=seed)
    tm = ported(td.DeepGMR(use_rri=use_rri, rri_size=K), v)
    return jm, v, tm, (src, tgt, t_gt)


@pytest.mark.parametrize("use_rri", [True, False])
def test_deepgmr_val_and_test_match_jax(use_rri):
    jm, v, tm, (src, tgt, t_gt) = _deepgmr(4, use_rri)
    ref = jax_apply(jm, v, src, tgt, t_gt, prefix="val", train=False)
    with torch.no_grad():
        out = tm(t(src), t(tgt), t(t_gt), prefix="val", train=False)
        bare = tm(t(src), t(tgt), None, prefix="test")
    assert_outputs_match(out, ref)
    np.testing.assert_allclose(bare.numpy(), np.asarray(
        jax_apply(jm, v, src, tgt, None, prefix="test")), atol=1e-4)


def test_deepgmr_train_loss_and_running_stats_match_jax():
    """The backbone runs on both clouds: each BatchNorm's statistics move
    twice a step, in both packages."""
    jm, v, tm, (src, tgt, t_gt) = _deepgmr(5)
    ref, upd = jax_apply(jm, v, src, tgt, t_gt, prefix="train", train=True,
                         mutable=["batch_stats"])
    with torch.no_grad():
        out = tm(t(src), t(tgt), t(t_gt), prefix="train", train=True)
    assert_outputs_match(out, ref)
    assert_same_stats(tm, {"batch_stats": upd["batch_stats"]})
    assert tm.flax_names == {"GMRBackbone_0": "backbone"}
    assert tm.backbone.flax_names == {"PointMLP_0": "enc",
                                      "PointMLP_1": "dec", "Dense_0": "head"}


def _gmm_register_in_dtype(pi_s, mu_s, mu_t, sigma_t):
    """``houv_tpu/models/deepgmr.py:gmm_register`` with its SVD in the
    mixtures' dtype (the JAX function casts to f32)."""
    c_s = jnp.einsum("bj,bjc->bc", pi_s, mu_s)[:, None]
    c_t = jnp.einsum("bj,bjc->bc", pi_s, mu_t)[:, None]
    ms = jnp.einsum("bj,bjc,bjd,bjde->bce", pi_s, mu_s - c_s, mu_t - c_t,
                    jnp.linalg.inv(sigma_t))
    u, _, vt = jnp.linalg.svd(ms)
    v = jnp.swapaxes(vt, -1, -2)
    det = jnp.linalg.det(v @ jnp.swapaxes(u, -1, -2))
    d = jnp.stack([jnp.ones_like(det), jnp.ones_like(det), det], -1)
    r = (v * d[:, None, :]) @ jnp.swapaxes(u, -1, -2)
    t_ = c_t[:, 0] - jnp.einsum("bij,bj->bi", r, c_s[:, 0])
    return jd.rt_to_transformation(r, t_)


def test_deepgmr_f64_gradient_through_the_svd_matches_jax():
    jm, v, tm, args = _deepgmr(6)
    f64_grads(jm, v, args, dict(prefix="train", train=True), tm,
              lambda m, a: m(*a, prefix="train", train=True),
              patches=((jd, "gmm_register", _gmm_register_in_dtype),))


def test_deepgmr_factory_keys():
    tm = get_model("deepgmr", use_rri=False, num_groups=8)
    assert tm.backbone.head.out_features == 8
    assert tm.backbone.enc.fc0.in_features == 3
    assert get_model("deepgmr").backbone.enc.fc0.in_features == 80
