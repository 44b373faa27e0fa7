"""The port's truncated chamfer means against ``houv_tpu.metrics.cd``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from houv_tpu.metrics import cd as jcd
from houv_tpu_torch.metrics import cd as tcd


@pytest.mark.parametrize("k", [1, 100, 255])
def test_smallest_k_sqrt_mean_fast_values_and_gradients(rng, k):
    # squared distances, with exact zeros (coincident points) and ties
    d = rng.uniform(0, 0.5, (6, 256)).astype(np.float32) ** 2
    d[0, :10] = 0.0
    d[1, 20:40] = d[1, 0]
    jval, jgrad = jax.value_and_grad(
        lambda x: jcd.smallest_k_sqrt_mean_fast(x, k).sum())(jnp.asarray(d))
    td = torch.as_tensor(d).requires_grad_(True)
    val = tcd.smallest_k_sqrt_mean_fast(td, k)
    (grad,) = torch.autograd.grad(val.sum(), td)
    # same bisection in the same f32 arithmetic: the thresholds, hence the
    # masks, are identical; the masked sums differ only in summation
    # order (1e-6 relative)
    np.testing.assert_allclose(val.sum().item(), float(jval), rtol=1e-6)
    np.testing.assert_allclose(
        val.detach().numpy(),
        np.asarray(jcd.smallest_k_sqrt_mean_fast(jnp.asarray(d), k)),
        rtol=1e-6)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-6)


def test_safe_sqrt_and_smallest_k(rng):
    d = rng.uniform(0, 1, (4, 64)).astype(np.float32)
    d[0, 0] = 0.0
    np.testing.assert_allclose(tcd._safe_sqrt(torch.as_tensor(d)).numpy(),
                               np.asarray(jcd._safe_sqrt(jnp.asarray(d))),
                               rtol=1e-7)
    ours = np.sort(tcd._smallest_k(torch.as_tensor(d), 16).numpy(), -1)
    ref = np.sort(np.asarray(jcd._smallest_k(jnp.asarray(d), 16)), -1)
    np.testing.assert_array_equal(ours, ref)


def _pair(rng, n=300, m=257):
    a = rng.uniform(-0.5, 0.5, (3, n, 3)).astype(np.float32)
    b = (a[:, :m] + 0.01 * rng.standard_normal((3, m, 3))).astype(np.float32)
    return a, b


def test_chamfer_forward_against_jax(rng):
    """d1, d2 exact from the matched pairs; indices equal (the data are far
    from near-ties at 1e-6 relative, checked by the distances)."""
    from houv_tpu.ops.chamfer import chamfer as jchamfer
    from houv_tpu_torch.ops.chamfer import chamfer as tchamfer

    a, b = _pair(rng)
    d1, d2, i1, i2 = tchamfer(torch.tensor(a), torch.tensor(b))
    jd1, jd2, ji1, ji2 = jchamfer(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(d1.numpy(), np.asarray(jd1), rtol=1e-6,
                               atol=1e-12)
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), rtol=1e-6,
                               atol=1e-12)
    np.testing.assert_array_equal(i1.numpy(), np.asarray(ji1))
    np.testing.assert_array_equal(i2.numpy(), np.asarray(ji2))
    assert not d1.requires_grad


@pytest.mark.parametrize("calc_f1", [False, True])
def test_calc_cd_against_jax(rng, calc_f1):
    """cd_p, cd_t (and f1) per cloud, the reference's direction: d1 per gt
    point. 1e-6 relative: the same distances, summed in another order."""
    a, b = _pair(rng)
    ours = tcd.calc_cd(torch.tensor(b), torch.tensor(a), calc_f1=calc_f1)
    ref = jcd.calc_cd(jnp.asarray(b), jnp.asarray(a), calc_f1=calc_f1)
    assert len(ours) == len(ref) == (3 if calc_f1 else 2)
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6)


def test_fscore_against_jax(rng):
    d1 = rng.uniform(0, 3e-4, (4, 100)).astype(np.float32)
    d2 = rng.uniform(0, 3e-4, (4, 80)).astype(np.float32)
    d1[3] = d2[3] = 1.0            # cloud 3: p1 = p2 = 0, so f1 is 0
    for o, r in zip(tcd.fscore(torch.tensor(d1), torch.tensor(d2)),
                    jcd.fscore(jnp.asarray(d1), jnp.asarray(d2))):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6)
    assert float(tcd.fscore(torch.tensor(d1), torch.tensor(d2))[0][3]) == 0
