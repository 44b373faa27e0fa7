"""The port's ``nn_select`` and the solver's ``nn_select=True`` branch against
the JAX package, on the CPU.

The JAX side runs its Pallas kernel in interpret mode. That kernel picks by a
key holding 16 index bits (2^-12 relative on distances) and reads the
coordinates back through hi/lo bf16 planes (2^-16 relative, its stated
contract); the port picks on exact f32 distances and copies exact f32
coordinates. So: where both picked the same neighbour the coordinates agree
to 2^-16 relative; where a near-equidistant alternate was picked the matched
distances agree to 5e-4 (the JAX package's own tolerance for its kernel);
and nearly all picks are the same.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from houv_tpu.ops.chamfer import nn_select_pallas
from houv_tpu.solvers import houv as jhouv
from houv_tpu_torch.ops import chamfer as tc
from houv_tpu_torch.solvers import houv as thouv
from houv_tpu_torch.state import config_from_jax, params_from_jax
from test_torch_houv import _jax_params, _jax_pass_losses, _pairs


@pytest.mark.parametrize("bsz,share,n,m", [(2, 8, 96, 100), (1, 16, 130, 64)])
def test_nn_select_matches_the_pallas_kernel(rng, bsz, share, n, m):
    a = rng.standard_normal((bsz, n, 3)).astype(np.float32)
    b = rng.standard_normal((bsz * share, m, 3)).astype(np.float32)
    r1, r2 = (np.asarray(c) for c in nn_select_pallas(
        jnp.asarray(a), jnp.asarray(b), interpret=True))
    c1, c2 = (c.numpy() for c in tc.nn_select(torch.tensor(a),
                                              torch.tensor(b), device="cpu"))
    assert c1.shape == r1.shape == (bsz * share, n, 3)
    assert c2.shape == r2.shape == (bsz * share, m, 3)
    a_rep = np.repeat(a, share, axis=0)
    for ours, ref, own in ((c1, r1, a_rep), (c2, r2, b)):
        same = np.isclose(ours, ref, rtol=2.0 ** -16, atol=2.0 ** -16).all(-1)
        assert same.mean() > 0.995
        np.testing.assert_allclose(((own - ours) ** 2).sum(-1),
                                   ((own - ref) ** 2).sum(-1),
                                   rtol=5e-4, atol=1e-6)


def test_nn_select_is_the_exact_gather_of_its_own_search(rng):
    """Bit for bit the rows ``chamfer_indices`` names, shared-query layout
    with a share that is no multiple of 8 (the TPU kernel's batch block is
    not carried over), exact ties to the smaller index, no gradients."""
    a = rng.standard_normal((2, 50, 3)).astype(np.float32)
    b = rng.standard_normal((6, 40, 3)).astype(np.float32)
    b[:, 30:] = b[:, :10]                       # duplicated rows: exact ties
    at, bt = torch.tensor(a), torch.tensor(b, requires_grad=True)
    c1, c2 = tc.nn_select(at, bt, device="cpu")
    assert not c1.requires_grad and not c2.requires_grad
    i1, i2 = tc.chamfer_indices(at, bt, device="cpu")
    assert int(i1.max()) < 30                   # the smaller index of a tie
    np.testing.assert_array_equal(
        c1.numpy(), np.take_along_axis(b, i1.numpy()[..., None], 1))
    np.testing.assert_array_equal(
        c2.numpy(), np.take_along_axis(np.repeat(a, 3, 0),
                                       i2.numpy()[..., None], 1))
    d = ((np.repeat(a, 3, 0)[:, :, None] - b[:, None]) ** 2).sum(-1)
    np.testing.assert_array_equal(i1.numpy(), d.argmin(-1))
    with pytest.raises(ValueError, match="does not divide"):
        tc.nn_select(at, bt[:5], device="cpu")
    with pytest.raises(ValueError, match="expected"):
        tc.nn_select(at[..., :2], bt, device="cpu")


@pytest.fixture
def jax_select_in_interpret_mode(monkeypatch):
    """The JAX solver takes its ``nn_select`` branch only on a TPU or when
    ``_pair_matches`` is told to interpret the kernel: tell it."""
    orig = jhouv._pair_matches
    monkeypatch.setattr(
        jhouv, "_pair_matches",
        lambda *a, **kw: orig(*a, **dict(kw, interpret=True)))


def test_select_objective_and_gradient_match_at_step0(
        jax_select_in_interpret_mode):
    """``nn_select=True`` in both packages: the step-0 loss, the
    per-replica metric and the gradients. A pick that differs at a
    near-equidistant alternate moves one distance by 2^-12 relative: 1e-4
    on the loss."""
    src, tgt, _ = _pairs(2, 128)
    jcfg = jhouv.HOUVConfig(kernel=8, use_pallas=False, nn_select=True)
    cfg = config_from_jax(jcfg)
    assert cfg.nn_select is True
    p_np = _jax_params(0, 2, 8)

    def f(p):
        return jhouv._objective_gather(p, jnp.asarray(src), jnp.asarray(tgt),
                                       0.0, jcfg)

    (jloss, jmin1), jgrad = jax.value_and_grad(f, has_aux=True)(
        {k: jnp.asarray(v) for k, v in p_np.items()})
    params = {k: v.requires_grad_(True)
              for k, v in params_from_jax(p_np, "cpu").items()}
    loss, min1 = thouv._objective_gather(
        params, torch.as_tensor(src), torch.as_tensor(tgt), 0.0, cfg)
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(min1.detach().numpy(), np.asarray(jmin1),
                               rtol=1e-4)
    for name, g in zip(params, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrad[name]),
                                   rtol=2e-3, atol=1e-5, err_msg=name)
    # and the port's select branch is its index branch up to the rounding
    # of R^T (c1 - t): the same loss to 1e-5
    base, _ = thouv._objective_gather(
        params, torch.as_tensor(src), torch.as_tensor(tgt), 0.0,
        dataclasses.replace(cfg, nn_select=False))
    np.testing.assert_allclose(loss.item(), base.item(), rtol=1e-5)


def test_select_per_step_losses_match_jax(jax_select_in_interpret_mode):
    """Eight Adam steps with a refresh block of 2: the matched coordinates
    are cached across a block in both packages."""
    src, tgt, _ = _pairs(2, 128)
    jcfg = jhouv.HOUVConfig(kernel=8, steps=8, use_pallas=False,
                            nn_select=True, nn_refresh=2)
    cfg = config_from_jax(jcfg)
    p_np = _jax_params(1, 2, 8)
    jlosses, _ = _jax_pass_losses(
        jnp.asarray(src), jnp.asarray(tgt),
        {k: jnp.asarray(v) for k, v in p_np.items()}, jcfg)
    params = params_from_jax(p_np, "cpu")
    tc.nn_select.launches = 0
    _, _, losses = thouv._adam_loop(
        torch.as_tensor(src), torch.as_tensor(tgt), 0.0, cfg, params,
        thouv._adam_init(params), 8)
    assert tc.nn_select.launches == 0           # CPU tensors: the plain one
    np.testing.assert_allclose(losses.numpy(), jlosses, rtol=2e-4)


def test_select_solve_runs_and_scatter_mode_rejects_it():
    src, tgt, _ = _pairs(2, 96)
    cfg = thouv.HOUVConfig(kernel=4, steps=6, angle_passes=2,
                           retry_mode="always", nn_select=True)
    out = thouv.houv_solve(torch.as_tensor(src), torch.as_tensor(tgt), cfg,
                           device="cpu")
    assert out["transform"].shape == (2, 4, 4)
    assert torch.isfinite(out["transform"]).all()
    assert torch.isfinite(out["rmse"]).all()
    with pytest.raises(ValueError, match="gather"):
        thouv.HOUVConfig(nn_select=True, grad_mode="scatter")
