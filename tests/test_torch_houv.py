"""The port's HOUV solver against the JAX solver, on the CPU.

Every case draws the restarts with the JAX package's ``init_params`` and
feeds them to both solvers through ``state.params_from_jax``; the clouds come
from the synthetic fixture (numpy, seeded). The port runs the plain versions
of its kernels here; the JAX side runs its XLA path (``use_pallas=False``),
as the JAX package's own solver tests do on the CPU.
"""

import dataclasses
import importlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from houv_tpu.data import synthesize_registration_pairs
from houv_tpu.solvers import houv as jhouv
from houv_tpu_torch.ops.chamfer import _nn_both_plain
from houv_tpu_torch.solvers import houv as thouv
from houv_tpu_torch.state import config_from_jax, params_from_jax


def _grads(loss, params: dict) -> list:
    """d loss / d params, in order; zeros for a parameter the objective
    does not read (``angle_xyz`` outside the Euler mode, as JAX's zero
    gradient)."""
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params.values(), grads)]


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
    grads = _grads(loss, params)
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
    grads = _grads(loss, params)
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
        ggrads = _grads(gloss, gleaves)
        np.testing.assert_allclose(gloss.item(), loss.item(), rtol=1e-6)
        for name, g, gg in zip(params, grads, ggrads):
            np.testing.assert_allclose(g.numpy(), gg.numpy(), rtol=1e-4,
                                       atol=1e-7, err_msg=name)


def _view_pairs(n, m):
    """Two structured pairs with n source and m target points."""
    src, tgt, _ = _pairs(2, max(n, m))
    return src[:, :n].copy(), tgt[:, :m].copy()


@pytest.mark.parametrize("n,m", [(128, 128), (96, 128), (128, 80)])
def test_view_loss_gather_objective_and_gradient_match_at_step0(n, m):
    """``use_view_loss`` under ``grad_mode='gather'``: the canonical loss
    plus three projected searches, each rebuilt from matched rows, against
    JAX's ``_objective_gather``: the loss to 1e-5 relative (f32 both), the
    gradient to 1e-4 of its largest entry against JAX in f64. N != M both
    ways: k is the source count and truncates both sides."""
    src, tgt = _view_pairs(n, m)
    jcfg = jhouv.HOUVConfig(kernel=8, use_pallas=False, use_view_loss=True)
    cfg = config_from_jax(jcfg)
    assert cfg.use_view_loss and cfg.grad_mode == "gather"
    p_np = _jax_params(0, 2, 8)

    def f(p, s, t):
        return jhouv._objective_gather(p, s, t, 0.0, jcfg)

    jloss, jmin1 = f({k: jnp.asarray(v) for k, v in p_np.items()},
                     jnp.asarray(src), jnp.asarray(tgt))
    with jax.enable_x64(True):
        as64 = lambda a: jnp.asarray(np.asarray(a), jnp.float64)
        jgrad = jax.grad(lambda p: f(p, as64(src), as64(tgt))[0])(
            {k: as64(v) for k, v in p_np.items()})
        jgrad = {k: np.asarray(v) for k, v in jgrad.items()}
    params = {k: v.requires_grad_(True)
              for k, v in params_from_jax(p_np, "cpu").items()}
    loss, min1 = thouv._objective_gather(
        params, torch.as_tensor(src), torch.as_tensor(tgt), 0.0, cfg)
    grads = _grads(loss, params)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(min1.detach().numpy(), np.asarray(jmin1),
                               rtol=1e-5)
    for name, g in zip(params, grads):
        ref = jgrad[name]
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max(),
                                   err_msg=name)
    # the views add to the loss and leave the selection metric alone
    base, bmin1 = thouv._objective_gather(
        params, torch.as_tensor(src), torch.as_tensor(tgt), 0.0,
        dataclasses.replace(cfg, use_view_loss=False))
    assert loss.item() > base.item()
    np.testing.assert_array_equal(min1.detach().numpy(),
                                  bmin1.detach().numpy())


@pytest.fixture
def jax_exact_search(monkeypatch):
    """JAX's solver searching with the port's exact diff-form selection.
    Its CPU path ranks by the expansion form, which orders near-ties
    differently, and the projected clouds of the view terms are full of
    them; with one selection on both sides the objective's own arithmetic
    is what is compared."""
    jchamfer = importlib.import_module("houv_tpu.ops.chamfer")

    def exact(a, b, *args, **kwargs):
        def search(a, b):
            i1, i2 = _nn_both_plain(torch.tensor(np.asarray(a)),
                                    torch.tensor(np.asarray(b)))
            return i1.numpy().astype(np.int32), i2.numpy().astype(np.int32)

        rows = b.shape[0]
        out = (jax.ShapeDtypeStruct((rows, a.shape[1]), jnp.int32),
               jax.ShapeDtypeStruct((rows, b.shape[1]), jnp.int32))
        return jax.pure_callback(search, out,
                                 jax.lax.stop_gradient(a).astype(jnp.float32),
                                 jax.lax.stop_gradient(b).astype(jnp.float32))

    monkeypatch.setattr(jchamfer, "chamfer_indices", exact)


def test_view_loss_gather_per_step_losses_match_jax(jax_exact_search):
    """The view-loss objective along JAX's own 20 Adam steps from the same
    restarts, both packages selecting exactly (``jax_exact_search``): at
    every step the port's loss agrees to 1e-5 relative and its gradient to
    1e-4 of the largest entry, and the port's Adam step from the same
    moments and gradients gives JAX's next parameters. (Each package's own
    f32 run parts from the other after a few steps: Adam divides a
    gradient by its own scale, so a component near zero moves by O(lr) in
    a direction its rounding decides.)"""
    src, tgt = _view_pairs(96, 128)
    jcfg = jhouv.HOUVConfig(kernel=8, steps=20, use_pallas=False,
                            use_view_loss=True)
    cfg = config_from_jax(jcfg)
    p_np = _jax_params(3, 2, 8)
    params = {k: jnp.asarray(v) for k, v in p_np.items()}
    opt = optax.adam(jcfg.lr)
    opt_state = opt.init(params)
    vg = jax.jit(jax.value_and_grad(
        lambda p: jhouv._objective_gather(p, jnp.asarray(src),
                                          jnp.asarray(tgt), 0.0, jcfg)[0]))
    tparams = params_from_jax(p_np, "cpu")
    state = thouv._adam_init(tparams)
    losses = []
    for _ in range(jcfg.steps):
        loss, grads = vg(params)
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in tparams.items()}
        tloss, _ = thouv._objective_gather(
            leaves, torch.as_tensor(src), torch.as_tensor(tgt), 0.0, cfg)
        tgrads = _grads(tloss, leaves)
        np.testing.assert_allclose(tloss.item(), float(loss), rtol=1e-5)
        for name, g in zip(leaves, tgrads):
            ref = np.asarray(grads[name])
            np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                       atol=1e-4 * np.abs(ref).max(),
                                       err_msg=name)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        with torch.no_grad():
            tparams = thouv._adam_update(
                tparams, {k: torch.tensor(np.asarray(grads[k]))
                          for k in tparams}, state, jcfg.lr)
        for name, v in tparams.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(params[name]),
                                       rtol=1e-6, atol=1e-6, err_msg=name)
        # the next step starts from JAX's parameters exactly
        tparams = params_from_jax({k: np.asarray(v) for k, v in
                                   params.items()}, "cpu")
        losses.append(float(loss))
    assert losses[-1] < 0.5 * losses[0]              # the steps descend


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
    # objective, the view loss under 'gather' included
    with pytest.raises(NotImplementedError, match="nn_refresh"):
        thouv.houv_solve(torch.as_tensor(src), torch.as_tensor(tgt),
                         dataclasses.replace(cfg, nn_refresh=2),
                         device="cpu")
    with pytest.raises(NotImplementedError, match="nn_refresh"):
        thouv.houv_solve(torch.as_tensor(src), torch.as_tensor(tgt),
                         thouv.HOUVConfig(kernel=4, steps=6, nn_refresh=2,
                                          use_view_loss=True),
                         device="cpu")
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
    ("objective", "multi_percent"),
    ("two_bracket", True),
    ("voxel_downsample", 32), ("window_select", "consensus"),
    ("rotation_mode", "euler"), ("reparam", "sigmoid"),
])
def test_unported_options_raise(field, value):
    """The solver ablations, once refused as unported, carry across from
    JAX's config; what the JAX package refuses with each is refused here,
    with its exception and message (solves of each option:
    tests/test_torch_houv_ablations.py)."""
    from houv_tpu.parallel.mesh import make_mesh_2d, sharded_houv_solve_2d
    from houv_tpu.solvers.rescore import houv_candidate_pools
    from houv_tpu_torch.parallel.mesh import Mesh
    from houv_tpu_torch.parallel.mesh import \
        sharded_houv_solve_2d as t_solve_2d
    from houv_tpu_torch.solvers.rescore import houv_solve_rescored

    jcfg = jhouv.HOUVConfig(kernel=4, steps=2, use_pallas=False,
                            **{field: value})
    cfg = config_from_jax(jcfg)
    assert getattr(cfg, field) == value
    src, tgt, _ = _pairs(2, 32)
    key = jax.random.PRNGKey(0)
    params = params_from_jax(_jax_params(0, 2, 4), "cpu")
    js, jt = jnp.asarray(src), jnp.asarray(tgt)
    ts, tt = torch.as_tensor(src), torch.as_tensor(tgt)
    split = Mesh(("data", "restart"), (1, 2), (0, 0), (None, None),
                 torch.device("cpu"))
    refusals = {
        "objective": [
            (lambda: jhouv._objective(
                {k: jnp.asarray(v) for k, v in _jax_params(0, 2, 4).items()},
                js, jt, 0.0, dataclasses.replace(jcfg, grad_mode="scatter")),
             lambda: thouv._objective(params, ts, tt, 0.0, dataclasses.replace(
                 cfg, grad_mode="scatter"))),
            (lambda: jhouv._check_refresh_supported(jcfg),
             lambda: thouv._adam_loop(
                 ts, tt, 0.0, dataclasses.replace(cfg, nn_refresh=2),
                 params, thouv._adam_init(params), 2))],
        "two_bracket": [
            (lambda: houv_candidate_pools(js, jt, key, jcfg),
             lambda: houv_solve_rescored(ts, tt, cfg, None, device="cpu")),
            (lambda: sharded_houv_solve_2d(js, jt, key, make_mesh_2d(1, 2),
                                           jcfg),
             lambda: t_solve_2d(ts, tt, split, cfg))],
        "window_select": [
            (lambda: houv_candidate_pools(js, jt, key, jcfg),
             lambda: houv_solve_rescored(ts, tt, cfg, None, device="cpu")),
            (lambda: sharded_houv_solve_2d(js, jt, key, make_mesh_2d(1, 2),
                                           jcfg),
             lambda: t_solve_2d(ts, tt, split, cfg))],
    }
    for jax_call, port_call in refusals.get(field, ()):
        with pytest.raises((NotImplementedError, ValueError)) as jerr:
            jax_call()
        with pytest.raises(jerr.type, match=re.escape(str(jerr.value))):
            port_call()


def test_refresh_schedule_resolution_matches_jax():
    for steps in (20, 77, 500):
        jcfg = jhouv.HOUVConfig(steps=steps, nn_refresh_schedule="auto")
        assert thouv._refresh_phases(config_from_jax(jcfg)) == \
            jhouv._refresh_phases(jcfg)
    bad = thouv.HOUVConfig(steps=10, nn_refresh_schedule=((6, 4, 2), (4, 2)))
    with pytest.raises(ValueError):
        thouv._refresh_phases(bad)
