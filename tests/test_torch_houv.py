"""The port's HOUV solver against the JAX solver, on the CPU.

Every case draws the restarts with the JAX package's ``init_params`` and
feeds them to both solvers through ``state.params_from_jax``; the clouds come
from the synthetic fixture (numpy, seeded). The port runs the plain versions
of its kernels here; the JAX side runs its XLA path (``use_pallas=False``),
as the JAX package's own solver tests do on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from houv_tpu.data import synthesize_registration_pairs
from houv_tpu.solvers import houv as jhouv
from houv_tpu_torch.solvers import houv as thouv
from houv_tpu_torch.state import config_from_jax, params_from_jax


def _pairs(n_pairs, n_points, seed=11):
    d = synthesize_registration_pairs(
        n_pairs, n_points=n_points, max_angle_deg=90.0, max_trans=0.5,
        seed=seed, shape_mode="structured", rot_mix=True)
    return d["rotated_src"], d["rotated_tgt"], d["transforms"]


def _jax_params(seed, batch, kernel):
    p = jhouv.init_params(jax.random.PRNGKey(seed), batch, kernel)
    return {k: np.asarray(v) for k, v in p.items()}


def test_objective_and_gradient_match_at_step0():
    src, tgt, _ = _pairs(2, 128)
    jcfg = jhouv.HOUVConfig(kernel=8, use_pallas=False)
    cfg = config_from_jax(jcfg)
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
    # f32 sums in another order (einsum vs bmm): 1e-5 relative on the loss
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(min1.detach().numpy(), np.asarray(jmin1),
                               rtol=1e-5)
    for name, g in zip(params, grads):
        # gradients are means over B·K replicas of terms ~1e-2: 1e-4
        # relative plus 1e-7 absolute covers the reordered f32 sums
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrad[name]),
                                   rtol=1e-4, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("use_view_loss", [False, True])
def test_scatter_mode_objective_and_gradient_match_at_step0(use_view_loss):
    """``grad_mode='scatter'``: the loss through ``calc_cd_percent`` (and
    with ``use_view_loss`` the three projected CDs), differentiated by the
    chamfer op's own scatter-add backward, against JAX's
    ``_objective_scatter``."""
    src, tgt, _ = _pairs(2, 128)
    jcfg = jhouv.HOUVConfig(kernel=8, use_pallas=False, grad_mode="scatter",
                            use_view_loss=use_view_loss)
    cfg = config_from_jax(jcfg)
    assert cfg.grad_mode == "scatter" and cfg.use_view_loss == use_view_loss
    p_np = _jax_params(0, 2, 8)

    def f(p):
        return jhouv._objective(p, jnp.asarray(src), jnp.asarray(tgt), 0.0,
                                jcfg)

    (jloss, jmin1), jgrad = jax.value_and_grad(f, has_aux=True)(
        {k: jnp.asarray(v) for k, v in p_np.items()})
    params = {k: v.requires_grad_(True)
              for k, v in params_from_jax(p_np, "cpu").items()}
    loss, min1 = thouv._objective(
        params, torch.as_tensor(src), torch.as_tensor(tgt), 0.0, cfg)
    grads = torch.autograd.grad(loss, list(params.values()))
    # the tolerances of the gather-mode test above: the same f32 sums in
    # another order
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(min1.detach().numpy(), np.asarray(jmin1),
                               rtol=1e-5)
    for name, g in zip(params, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrad[name]),
                                   rtol=1e-4, atol=1e-7, err_msg=name)
    if not use_view_loss:
        # both formulations are one objective: equal value, and gradients
        # equal up to the order of the sums
        gcfg = dataclasses.replace(cfg, grad_mode="gather")
        gleaves = {k: v.detach().clone().requires_grad_(True)
                   for k, v in params.items()}
        gloss, _ = thouv._objective(gleaves, torch.as_tensor(src),
                                    torch.as_tensor(tgt), 0.0, gcfg)
        ggrads = torch.autograd.grad(gloss, list(gleaves.values()))
        np.testing.assert_allclose(gloss.item(), loss.item(), rtol=1e-6)
        for name, g, gg in zip(params, grads, ggrads):
            np.testing.assert_allclose(g.numpy(), gg.numpy(), rtol=1e-4,
                                       atol=1e-7, err_msg=name)


def test_scatter_mode_solve_runs_and_rejects_what_jax_rejects():
    src, tgt, _ = _pairs(2, 96)
    cfg = thouv.HOUVConfig(kernel=4, steps=6, angle_passes=2,
                           retry_mode="always", grad_mode="scatter")
    key = jax.random.PRNGKey(2)
    p_np = {k: np.asarray(v)
            for k, v in jhouv.init_params(key, 2, 4).items()}
    out = thouv.houv_solve(torch.as_tensor(src), torch.as_tensor(tgt), cfg,
                           params0=params_from_jax(p_np, "cpu"),
                           device="cpu")
    jcfg = jhouv.HOUVConfig(kernel=4, steps=6, angle_passes=2,
                            retry_mode="always", grad_mode="scatter",
                            use_pallas=False)
    jout = jhouv.houv_solve_chunked(jnp.asarray(src), jnp.asarray(tgt), key,
                                    jcfg)
    # 6 Adam steps per window from identical restarts
    np.testing.assert_allclose(out["transform"].numpy(),
                               np.asarray(jout["transform"]), atol=1e-3)
    np.testing.assert_allclose(out["rmse"].numpy(), np.asarray(jout["rmse"]),
                               rtol=1e-3)
    # as in the JAX solver: no correspondence reuse outside the canonical
    # objective; the view loss under 'gather' is not ported
    with pytest.raises(NotImplementedError, match="nn_refresh"):
        thouv.houv_solve(torch.as_tensor(src), torch.as_tensor(tgt),
                         dataclasses.replace(cfg, nn_refresh=2),
                         device="cpu")
    with pytest.raises(NotImplementedError, match="7c"):
        thouv.HOUVConfig(use_view_loss=True)
    with pytest.raises(ValueError, match="grad_mode"):
        thouv.HOUVConfig(grad_mode="dense")


def _jax_pass_losses(src, tgt, params, jcfg):
    """JAX's per-step losses over the schedule, stepped as ``_adam_loop``
    steps (matches once per refresh block, then optax Adam)."""
    opt = optax.adam(jcfg.lr)
    opt_state = opt.init(params)
    losses = []
    for n_steps, refresh, sub in jhouv._refresh_phases(jcfg):
        cfg_r = dataclasses.replace(jcfg, nn_refresh=refresh,
                                    nn_refresh_schedule=None)
        src_p, tgt_p = jhouv._phase_clouds(src, tgt, sub)
        vg = jax.jit(jax.value_and_grad(
            lambda p, m: jhouv._objective_cached(p, m, src_p, tgt_p, 0.0,
                                                 cfg_r)[0]))
        for _ in range(n_steps // refresh):
            matches = jhouv._objective_matches(params, src_p, tgt_p, 0.0,
                                               cfg_r)
            for _ in range(refresh):
                loss, grads = vg(params, matches)
                updates, opt_state = opt.update(grads, opt_state, params)
                params = optax.apply_updates(params, updates)
                losses.append(float(loss))
    return np.asarray(losses), params


def test_per_step_losses_match_over_fps_schedule():
    src, tgt, _ = _pairs(2, 256)
    jcfg = jhouv.HOUVConfig(kernel=8, steps=10, use_pallas=False,
                            nn_refresh_schedule=((4, 2, 4), (4, 2, 2),
                                                 (2, 1)))
    cfg = config_from_jax(jcfg)
    p_np = _jax_params(1, 2, 8)
    jlosses, jparams = _jax_pass_losses(
        jnp.asarray(src), jnp.asarray(tgt),
        {k: jnp.asarray(v) for k, v in p_np.items()}, jcfg)

    params = params_from_jax(p_np, "cpu")
    opt_state = thouv._adam_init(params)
    losses = []
    src_t, tgt_t = torch.as_tensor(src), torch.as_tensor(tgt)
    for n_steps, refresh, sub in thouv._refresh_phases(cfg):
        cfg_r = dataclasses.replace(cfg, nn_refresh=refresh,
                                    nn_refresh_schedule=None)
        src_p, tgt_p = thouv._phase_clouds(src_t, tgt_t, sub)
        params, opt_state, step_losses = thouv._adam_loop(
            src_p, tgt_p, 0.0, cfg_r, params, opt_state, n_steps)
        losses.extend(step_losses.tolist())
    # the FPS phases select identical points (exact), so only f32 sum
    # order separates the two; over 10 Adam steps that stays < 1e-4
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    for name, v in params.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jparams[name]),
                                   rtol=1e-3, atol=1e-4, err_msg=name)


def test_houv_solve_matches_jax_over_two_windows():
    src, tgt, _ = _pairs(2, 128)
    jcfg = jhouv.HOUVConfig(kernel=8, steps=10, angle_passes=2,
                            retry_mode="always", use_pallas=False,
                            nn_refresh_schedule=((4, 2, 4), (4, 2, 2),
                                                 (2, 1)))
    key = jax.random.PRNGKey(5)
    jout = jhouv.houv_solve_chunked(jnp.asarray(src), jnp.asarray(tgt), key,
                                    jcfg)
    p_np = {k: np.asarray(v)
            for k, v in jhouv.init_params(key, 2, 8).items()}
    out = thouv.houv_solve(torch.as_tensor(src), torch.as_tensor(tgt),
                           config_from_jax(jcfg),
                           params0=params_from_jax(p_np, "cpu"),
                           device="cpu")
    assert out["n_retry"] == int(jout["n_retry"]) == 2
    # 20 Adam steps per window from identical restarts; reordered f32 sums
    # drift the parameters by ~1e-5, so the transforms agree to 1e-3
    np.testing.assert_allclose(out["transform"].numpy(),
                               np.asarray(jout["transform"]), atol=1e-3)
    np.testing.assert_allclose(out["rmse"].numpy(), np.asarray(jout["rmse"]),
                               rtol=1e-3)


@pytest.mark.slow
def test_quality_gate_on_mvp_statistics_fixture():
    """The CPU quality gate of tests/test_quality_gate.py on the port:
    seed 11, 8 pairs, 384 points, K=16, 200 steps, 4 windows. Slow tier:
    about 90 s on the CPU, where the plain nearest-neighbour search runs
    800 times over (128, 384, 384) distance blocks."""
    src, tgt, gt = _pairs(8, 384)
    cfg = thouv.HOUVConfig(kernel=16, steps=200, angle_passes=4,
                           retry_threshold=0.030)
    p_np = {k: np.asarray(v) for k, v in
            jhouv.init_params(jax.random.PRNGKey(3), 8, 16).items()}
    out = thouv.houv_solve(torch.as_tensor(src), torch.as_tensor(tgt), cfg,
                           params0=params_from_jax(p_np, "cpu"),
                           device="cpu")
    r_err, t_err = thouv.evaluate_solution(out["transform"],
                                           torch.as_tensor(gt))
    r, t = r_err.numpy(), t_err.numpy()
    assert np.median(r) < 10.0, r
    assert (r < 10.0).sum() >= 5, r
    assert np.median(t) < 0.08, t
    assert out["n_retry"] >= 1


@pytest.mark.parametrize("field,value", [
    ("objective", "multi_percent"), ("use_view_loss", True),
    ("two_bracket", True), ("nn_select", True),
    ("voxel_downsample", 32), ("window_select", "consensus"),
    ("rotation_mode", "euler"), ("reparam", "sigmoid"),
])
def test_unported_options_raise(field, value):
    with pytest.raises(NotImplementedError):
        thouv.HOUVConfig(**{field: value})
    with pytest.raises(NotImplementedError):
        config_from_jax(jhouv.HOUVConfig(**{field: value}))


def test_refresh_schedule_resolution_matches_jax():
    for steps in (20, 77, 500):
        jcfg = jhouv.HOUVConfig(steps=steps, nn_refresh_schedule="auto")
        assert thouv._refresh_phases(config_from_jax(jcfg)) == \
            jhouv._refresh_phases(jcfg)
    bad = thouv.HOUVConfig(steps=10, nn_refresh_schedule=((6, 4, 2), (4, 2)))
    with pytest.raises(ValueError):
        thouv._refresh_phases(bad)
