"""Values and gradients of the port's chamfer and EMD losses against the JAX
package's, on the CPU.

The same numpy clouds (seeded, uniform in the unit cube: away from
near-ties) go through ``jax.value_and_grad`` and ``torch.autograd``. JAX runs
its XLA path (``use_pallas=False``), as its own tests do on the CPU; the port
runs the plain versions of its kernels. Each test first asserts that both
packages found the same matches: a gradient is defined by them. Tolerances:
the same f32 arithmetic in another order, 1e-5 relative on values and 1e-4
of each gradient's largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from houv_tpu.metrics import cd as jcd
from houv_tpu.metrics.emd import calc_emd as jcalc_emd
from houv_tpu.ops.chamfer import chamfer as jchamfer
from houv_tpu.ops.chamfer import chamfer_indices as jchamfer_indices
from houv_tpu.ops.emd import emd_auction as jemd_auction
from houv_tpu_torch.metrics import cd as tcd
from houv_tpu_torch.metrics.emd import calc_emd
from houv_tpu_torch.ops import chamfer as tch
from houv_tpu_torch.ops.emd import emd_auction
from houv_tpu_torch.ops.scatter import scatter_add


def _clouds(rng, b, n, m):
    return (rng.uniform(-0.5, 0.5, (b, n, 3)).astype(np.float32),
            rng.uniform(-0.5, 0.5, (b, m, 3)).astype(np.float32))


def _leaf(x):
    return torch.tensor(x, requires_grad=True)


def _assert_same_matches(a, b):
    """chamfer(a, b)'s matches in both packages."""
    ji1, ji2 = jchamfer_indices(jnp.asarray(a), jnp.asarray(b),
                                use_pallas=False)
    ti1, ti2 = tch.chamfer_indices(torch.as_tensor(a), torch.as_tensor(b),
                                   device="cpu")
    assert (ti1.numpy() == np.asarray(ji1)).all() and \
        (ti2.numpy() == np.asarray(ji2)).all(), \
        "a near-tie flipped a match; the gradients cannot be compared"


def _close_grad(ours, ref, name=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max(), err_msg=name)


def _compare(jfun, tfun, *arrays):
    """Scalar jfun(*jax arrays) against tfun(*torch leaves): the value and
    the gradient with respect to every array."""
    jval, jgrads = jax.value_and_grad(jfun, argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(x) for x in arrays])
    leaves = [_leaf(x) for x in arrays]
    tval = tfun(*leaves)
    grads = torch.autograd.grad(tval, leaves, allow_unused=True)
    np.testing.assert_allclose(tval.item(), float(jval), rtol=1e-5)
    for i, (g, jg) in enumerate(zip(grads, jgrads)):
        if g is None:
            assert not np.asarray(jg).any(), f"argument {i}"
        else:
            _close_grad(g, jg, f"argument {i}")


@pytest.mark.parametrize("n,m", [(200, 200), (256, 96), (64, 300)])
def test_chamfer_gradients(rng, n, m):
    a, b = _clouds(rng, 3, n, m)
    _assert_same_matches(a, b)
    w1 = rng.standard_normal((3, n)).astype(np.float32)
    w2 = rng.standard_normal((3, m)).astype(np.float32)

    def jfun(a, b):
        d1, d2, _, _ = jchamfer(a, b, use_pallas=False)
        return (d1 * w1).sum() + (d2 * w2).sum()

    def tfun(a, b):
        d1, d2, i1, i2 = tch.chamfer(a, b)
        assert not i1.requires_grad and not i2.requires_grad
        return (d1 * torch.as_tensor(w1)).sum() + \
            (d2 * torch.as_tensor(w2)).sum()

    _compare(jfun, tfun, a, b)


def test_chamfer_backward_scatters_only_for_inputs_that_need_it(rng,
                                                                monkeypatch):
    """One ``scatter_add`` per input that needs a gradient, none with
    gradients off; the forward values do not depend on which path ran."""
    a, b = _clouds(rng, 2, 80, 70)
    calls = []
    monkeypatch.setattr(tch, "scatter_add", lambda *args, **kw: (
        calls.append(args[2]), scatter_add(*args, **kw))[1])
    d1, d2, _, _ = tch.chamfer(torch.as_tensor(a), _leaf(b))
    (d1.sum() + d2.sum()).backward()
    assert calls == [70]
    calls.clear()
    e1, e2, _, _ = tch.chamfer(_leaf(a), _leaf(b))
    (e1.sum() + e2.sum()).backward()
    assert sorted(calls) == [70, 80]
    calls.clear()
    with torch.inference_mode():
        f1, f2, _, _ = tch.chamfer(torch.as_tensor(a), torch.as_tensor(b))
    with torch.no_grad():
        g1, _, _, _ = tch.chamfer(_leaf(a), _leaf(b))
    assert calls == [] and not g1.requires_grad
    assert torch.equal(f1, d1.detach()) and torch.equal(f2, e2.detach())
    assert torch.equal(g1, d1.detach())


def test_chamfer_gradient_against_finite_differences(rng):
    """Central differences of the dense f64 chamfer along random directions
    against the analytic gradient (matches fixed under a 1e-6 step). The
    analytic gradient is f32: 1e-4 relative."""
    a, b = _clouds(rng, 2, 60, 50)
    w1 = rng.standard_normal((2, 60))
    w2 = rng.standard_normal((2, 50))

    def dense(a64, b64):
        d1, d2, _, _ = tch.chamfer_reference(a64, b64)
        return float((d1 * torch.as_tensor(w1)).sum()
                     + (d2 * torch.as_tensor(w2)).sum())

    ta, tb = _leaf(a), _leaf(b)
    d1, d2, _, _ = tch.chamfer(ta, tb)
    ((d1 * torch.as_tensor(w1, dtype=torch.float32)).sum()
     + (d2 * torch.as_tensor(w2, dtype=torch.float32)).sum()).backward()
    a64, b64 = torch.tensor(a).double(), torch.tensor(b).double()
    eps = 1e-6
    for _ in range(5):
        ua = torch.as_tensor(rng.standard_normal(a.shape))
        ub = torch.as_tensor(rng.standard_normal(b.shape))
        fd = (dense(a64 + eps * ua, b64 + eps * ub)
              - dense(a64 - eps * ua, b64 - eps * ub)) / (2 * eps)
        analytic = float((ta.grad.double() * ua).sum()
                         + (tb.grad.double() * ub).sum())
        np.testing.assert_allclose(analytic, fd, rtol=1e-4)


def test_calc_cd_gradients(rng):
    out, gt = _clouds(rng, 3, 192, 256)
    _assert_same_matches(gt, out)

    def jfun(o, g):
        cd_p, cd_t = jcd.calc_cd(o, g, use_pallas=False)
        return cd_p.sum() + 3.0 * cd_t.sum()

    def tfun(o, g):
        cd_p, cd_t = tcd.calc_cd(o, g)
        return cd_p.sum() + 3.0 * cd_t.sum()

    _compare(jfun, tfun, out, gt)


def test_safe_sqrt_gradient_is_finite_at_zero_distance(rng):
    """Coincident points (d == 0): the floor keeps the gradient finite, and
    equal to JAX's."""
    out, gt = _clouds(rng, 2, 64, 64)
    out[:, :16] = gt[:, :16]

    def jfun(o, g):
        return jcd.calc_cd(o, g, use_pallas=False)[0].sum()

    o = _leaf(out)
    tcd.calc_cd(o, torch.as_tensor(gt))[0].sum().backward()
    assert torch.isfinite(o.grad).all()
    jg = jax.grad(jfun)(jnp.asarray(out), jnp.asarray(gt))
    _close_grad(o.grad, jg)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("percent", [0.5, 0.8, 1.0])
def test_calc_cd_percent_gradients(rng, percent, fast):
    out, gt = _clouds(rng, 3, 200, 240)
    _assert_same_matches(gt, out)

    def jfun(o, g):
        cd_p, cd_t = jcd.calc_cd_percent(o, g, percent, use_pallas=False,
                                         fast=fast)
        return cd_p.sum() + 2.0 * cd_t.sum()

    def tfun(o, g):
        cd_p, cd_t = tcd.calc_cd_percent(o, g, percent, fast=fast)
        return cd_p.sum() + 2.0 * cd_t.sum()

    _compare(jfun, tfun, out, gt)


def test_calc_cd_percent_aligned_and_len(rng):
    out, gt = _clouds(rng, 2, 120, 160)
    _assert_same_matches(gt, out)
    ours = tcd.calc_cd_percent_aligned(torch.as_tensor(out),
                                       torch.as_tensor(gt), 0.6)
    ref = jcd.calc_cd_percent_aligned(jnp.asarray(out), jnp.asarray(gt), 0.6,
                                      use_pallas=False)
    for o, r in zip(ours[:2], ref[:2]):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5)
    for o, r in zip(ours[2:], ref[2:]):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))

    mask_o = (rng.uniform(size=(2, 120)) < 0.7).astype(np.float32)
    mask_g = (rng.uniform(size=(2, 160)) < 0.7).astype(np.float32)

    def jfun(o, g):
        cd_p, cd_t, f1 = jcd.calc_cd_percent_len(
            o, g, jnp.asarray(mask_o), jnp.asarray(mask_g), calc_f1=True,
            use_pallas=False)
        return cd_p.sum() + cd_t.sum()

    def tfun(o, g):
        cd_p, cd_t, f1 = tcd.calc_cd_percent_len(
            o, g, torch.as_tensor(mask_o), torch.as_tensor(mask_g),
            calc_f1=True)
        return cd_p.sum() + cd_t.sum()

    _compare(jfun, tfun, out, gt)
    plain = tcd.calc_cd_percent_len(torch.as_tensor(out), torch.as_tensor(gt))
    for o, r in zip(plain, tcd.calc_cd(torch.as_tensor(out),
                                       torch.as_tensor(gt))):
        np.testing.assert_allclose(o.numpy(), r.numpy(), rtol=1e-6)


@pytest.mark.parametrize("dim", [0, 1, 2])
def test_loss_view_gradients(rng, dim):
    src, tgt = _clouds(rng, 2, 150, 150)
    mask = np.ones(3, np.float32)
    mask[dim] = 0.0
    _assert_same_matches(tgt * mask, src * mask)

    def jfun(s, t):
        cd_p, cd_t = jcd.loss_view(s, t, dim=dim, percent=0.7,
                                   use_pallas=False)
        return cd_p.sum() + cd_t.sum()

    def tfun(s, t):
        cd_p, cd_t = tcd.loss_view(s, t, dim=dim, percent=0.7)
        return cd_p.sum() + cd_t.sum()

    _compare(jfun, tfun, src, tgt)


@pytest.mark.parametrize("n,m", [(128, 128), (64, 128), (160, 128)])
def test_calc_emd_gradients(rng, n, m):
    """The train setting (eps 0.005, 50 rounds), also between clouds of
    different sizes (VRCNet's coarse stages): the gradient goes to the first
    cloud only."""
    out, gt = _clouds(rng, 2, n, m)
    _, jassign = jemd_auction(jnp.asarray(out), jnp.asarray(gt), 0.005, 50)
    _, tassign = emd_auction(torch.as_tensor(out), torch.as_tensor(gt),
                             0.005, 50)
    assert (tassign.numpy() == np.asarray(jassign)).all(), \
        "a near-tie changed the auction; the gradients cannot be compared"
    _compare(lambda o, g: jcalc_emd(o, g).sum(),
             lambda o, g: calc_emd(o, g).sum(), out, gt)
