"""The HOUV solver's ablations in the port against the JAX solver
(``houv_tpu/solvers/houv.py``), on the CPU.

Restarts come from the JAX package's ``init_params`` (``params_from_jax``,
``angle_xyz`` included); clouds from the synthetic fixture. Tolerances:
rotations and translations of ``reparametrize`` to 1e-5 relative (f32
both, the same ops); the bracket, agreement and consensus picks index for
index; objectives to 1e-5 relative (f32 both) and their gradients to 1e-4
of a tensor's largest entry against JAX in f64, both packages searching
with one exact selection (``jax_exact_search``); ``voxelize_mean`` bit for
bit (the sums start from +0.0 and add in point order in both); the tiny
solves (2 pairs of 64 points, 4 restarts, 4 Adam steps, 2 windows) to the
1e-3 of tests/test_torch_houv.py's two-window solve.
"""

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from houv_tpu.ops import voxel as jvoxel
from houv_tpu.solvers import houv as jhouv
from houv_tpu.train import config as jconfig
from houv_tpu_torch.ops import voxel as tvoxel
from houv_tpu_torch.solvers import houv as thouv
from houv_tpu_torch.state import _JAX_ONLY, config_from_jax, params_from_jax
from houv_tpu_torch.train import cli as tcli
from houv_tpu_torch.train import config as tconfig
from test_torch_houv import _grads, _pairs, jax_exact_search  # noqa: F401

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_params(seed, batch, kernel, two_bracket=False):
    p = jhouv.init_params(jax.random.PRNGKey(seed), batch, kernel, True,
                          two_bracket)
    return {k: np.asarray(v) for k, v in p.items()}


@pytest.mark.parametrize("reparam", ["sine", "sigmoid", "v3",
                                     "unconstrained"])
def test_reparametrize_matches_jax_on_the_port(reparam):
    """Each reparam × rotation mode × bracket split, at windows 0 and 2;
    and both halves of a two-bracket draw seeded on the lattice."""
    for two_bracket in (False, True):
        p_np = _jax_params(1, 3, 8, two_bracket)
        params = params_from_jax(p_np, "cpu")
        for rotation_mode in ("axis_angle", "euler"):
            for base in (0.0, 2.0):
                jr, jt = jhouv.reparametrize(
                    {k: jnp.asarray(v) for k, v in p_np.items()}, base,
                    "mvp", reparam, rotation_mode, two_bracket)
                r, t = thouv.reparametrize(params, base, "mvp", reparam,
                                           rotation_mode, two_bracket)
                np.testing.assert_allclose(r.numpy(), np.asarray(jr),
                                           rtol=1e-5, atol=1e-6)
                np.testing.assert_allclose(t.numpy(), np.asarray(jt),
                                           rtol=1e-5, atol=1e-6)
    ours = thouv.init_params(torch.Generator().manual_seed(0), 2, 8,
                             two_bracket=True, device="cpu")
    lattice = _jax_params(0, 2, 8, True)["v_c"]
    np.testing.assert_array_equal(ours["v_c"][:, :4].numpy(), lattice[:, :4])
    np.testing.assert_array_equal(ours["v_c"][:, 4:].numpy(), lattice[:, 4:])
    assert set(ours) == set(p_np) and ours["angle_xyz"].shape == (2, 8, 3)
    with pytest.raises(ValueError, match="unknown reparam"):
        thouv.HOUVConfig(reparam="cosine")


def test_best_restart_and_consensus_picks_match_jax(rng):
    """``_best_restart`` with and without brackets (planted ties, bracket
    1 better by more and by less than the preference), and
    ``_restart_agreement``, ``_consensus_merge`` and ``_window_candidate``
    on planted pools: index for index."""
    loss = np.full((4, 8), 0.5, np.float32)
    loss[0, [1, 6]] = 0.10                  # a tie across the brackets
    loss[1, 2], loss[1, 5] = 0.20, 0.10     # bracket 1 better by 2x
    loss[2, 3], loss[2, 7] = 0.12, 0.10     # ... by less than 1.3x
    loss[3, [4, 5]] = 0.05                  # a tie inside bracket 1
    for cfg in (dict(), dict(two_bracket=True),
                dict(two_bracket=True, bracket_preference=1.1)):
        jcfg = jhouv.HOUVConfig(**cfg)
        jv, ji = jhouv._best_restart(jnp.asarray(loss), jcfg)
        tv, ti = thouv._best_restart(torch.as_tensor(loss),
                                     config_from_jax(jcfg))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))

    # agreement: restarts about one axis a pair, near-optimal in loss for
    # the first four (within 1.3x of the best), 0°, 3°, 5°, 20° and more
    # from each other; each pair's restarts rolled
    jcfg = jhouv.HOUVConfig()
    cfg = config_from_jax(jcfg)
    axis = np.repeat(rng.standard_normal((4, 1, 3)), 8, 1).astype(np.float32)
    angle = np.array([0.0, 0.05, 0.09, 0.35, 1.5, 0.08, 2.0, 0.02],
                     np.float32)
    near = np.array([0.10, 0.11, 0.12, 0.125, 0.5, 0.2, 0.3, 0.4],
                    np.float32)
    angle = np.stack([np.roll(angle, i) for i in range(4)])
    loss_a = np.stack([np.roll(near, i) for i in range(4)])
    r = np.array(jhouv.rodrigues(jnp.asarray(angle), jnp.asarray(axis)))
    t = rng.standard_normal((4, 8, 3)).astype(np.float32)
    jc = jhouv._window_candidate(jnp.asarray(loss_a), jnp.asarray(r),
                                 jnp.asarray(t), jcfg)
    tc = thouv._window_candidate(torch.as_tensor(loss_a), torch.as_tensor(r),
                                 torch.as_tensor(t), cfg)
    for ours, ref in zip(tc, jc):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert np.asarray(jc[1]).tolist() == [3.0] * 4

    # the merge: windows within the ratio, then agreement, then loss;
    # +inf for windows a pair never entered
    cand_loss = np.array([[0.10, 0.12, 0.30, np.inf],
                          [0.10, 0.10, 0.11, 0.09],
                          [0.20, np.inf, np.inf, np.inf],
                          [0.0, 0.0, 1e-5, 0.2]], np.float32)
    cand_agree = np.array([[3, 7, 9, 0], [4, 4, 4, 2], [1, 0, 0, 0],
                           [2, 5, 5, 9]], np.float32)
    for ratio in (1.5, 1.05):
        jcfg = jhouv.HOUVConfig(consensus_window_ratio=ratio)
        np.testing.assert_array_equal(
            thouv._consensus_merge(torch.as_tensor(cand_loss),
                                   torch.as_tensor(cand_agree),
                                   config_from_jax(jcfg)).numpy(),
            np.asarray(jhouv._consensus_merge(jnp.asarray(cand_loss),
                                              jnp.asarray(cand_agree),
                                              jcfg)))


@pytest.mark.parametrize("extra", [
    dict(objective="multi_percent"),
    dict(select_percent=1.0),
    dict(select_percent=0.3, rotation_mode="euler"),
], ids=["multi_percent", "select_full", "select_30-euler"])
def test_ablation_objectives_and_gradients_match_jax(jax_exact_search,
                                                     extra):
    """The objective (loss to 1e-5, the selection metric to 1e-5) and its
    gradient (1e-4 of each tensor's largest entry, against JAX in f64) of
    'multi_percent' (three view searches beside the main one) and of
    ``select_percent``; the selection metric is the 10% min-CD, or the
    min-CD at ``select_percent``."""
    src, tgt, _ = _pairs(2, 64)
    jcfg = jhouv.HOUVConfig(kernel=4, use_pallas=False, **extra)
    cfg = config_from_jax(jcfg)
    p_np = _jax_params(2, 2, 4)

    def f(p, s, t):
        return jhouv._objective_gather(p, s, t, 0.0, jcfg)

    jloss, jsel = f({k: jnp.asarray(v) for k, v in p_np.items()},
                    jnp.asarray(src), jnp.asarray(tgt))
    with jax.enable_x64(True):
        def as64(a):
            return jnp.asarray(np.asarray(a), jnp.float64)

        jgrad = jax.jit(jax.grad(lambda p, s, t: f(p, s, t)[0]))(
            {k: as64(v) for k, v in p_np.items()}, as64(src), as64(tgt))
        jgrad = {k: np.asarray(v) for k, v in jgrad.items()}
    params = {k: v.requires_grad_(True)
              for k, v in params_from_jax(p_np, "cpu").items()}
    loss, sel = thouv._objective_gather(
        params, torch.as_tensor(src), torch.as_tensor(tgt), 0.0, cfg)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(sel.detach().numpy(), np.asarray(jsel),
                               rtol=1e-5)
    for name, g in zip(params, _grads(loss, params)):
        ref = jgrad[name]
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max(),
                                   err_msg=name)


def test_voxelize_mean_matches_jax_bit_for_bit(rng):
    """Random clouds, points on cell boundaries, outside the volume and
    repeated, at grid 50 on [-1, 1] (``voxel_downsample``) and grid 7 on
    the default volume; and ``voxel_downsample_clouds``."""
    pts = rng.uniform(-1.1, 1.1, (3, 300, 3)).astype(np.float32)
    edges = np.float32(-1.0) + np.arange(50, dtype=np.float32) * np.float32(
        2.0 / 49)
    pts[0, :50, 0] = edges                        # on the cell boundaries
    pts[1, 100:200] = pts[1, 0]                    # one voxel, many points
    for grid, lo, hi in ((50, -1.0, 1.0), (7, -0.5, 0.5)):
        jvp, jcnt = jvoxel.voxelize_mean(jnp.asarray(pts), grid, lo, hi)
        vp, cnt = tvoxel.voxelize_mean(torch.as_tensor(pts), grid, lo, hi)
        assert vp.numpy().tobytes() == np.asarray(jvp).tobytes()
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    jcfg = jhouv.HOUVConfig(voxel_downsample=20)
    js, jt = jhouv.voxel_downsample_clouds(jnp.asarray(pts),
                                           jnp.asarray(pts[::-1]), jcfg)
    ts, tt = thouv.voxel_downsample_clouds(
        torch.as_tensor(pts), torch.as_tensor(pts[::-1].copy()),
        config_from_jax(jcfg))
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    assert tt.numpy().tobytes() == np.asarray(jt).tobytes()


@pytest.mark.parametrize("extra", [
    dict(reparam="sigmoid", window_select="consensus"),
    dict(reparam="unconstrained", voxel_downsample=16,
         rotation_mode="euler"),
    # scripts/quality_gate.py's 'v3' bundle
    dict(reparam="v3", objective="multi_percent", two_bracket=True,
         lr=0.01),
], ids=["sigmoid-consensus", "unconstrained-voxel-euler", "v3"])
def test_houv_solve_ablations_match_jax(jax_exact_search, extra):
    """A tiny two-window solve (``retry_mode='always'``) of each option
    that a yaml reaches (``houv_reparam``, ``houv_objective``,
    ``two_bracket``, ``window_select``), and of ``voxel_downsample`` and
    ``rotation_mode``, against JAX's ``houv_solve_chunked`` from the same
    restarts."""
    src, tgt, _ = _pairs(2, 64)
    jcfg = jhouv.HOUVConfig(kernel=4, steps=4, angle_passes=2,
                            retry_mode="always", use_pallas=False, **extra)
    key = jax.random.PRNGKey(5)
    jout = jhouv.houv_solve_chunked(jnp.asarray(src), jnp.asarray(tgt), key,
                                    jcfg)
    p_np = {k: np.asarray(v) for k, v in jhouv.init_params(
        key, 2, 4, True, jcfg.two_bracket).items()}
    out = thouv.houv_solve(torch.as_tensor(src), torch.as_tensor(tgt),
                           config_from_jax(jcfg),
                           params0=params_from_jax(p_np, "cpu"),
                           device="cpu")
    assert out["n_retry"] == int(jout["n_retry"]) == 2
    assert np.isfinite(out["transform"].numpy()).all()
    np.testing.assert_allclose(out["transform"].numpy(),
                               np.asarray(jout["transform"]), atol=1e-3)
    np.testing.assert_allclose(out["rmse"].numpy(), np.asarray(jout["rmse"]),
                               rtol=1e-3)


def test_ablation_refusals_match_jax():
    """What the JAX solver refuses with the ablations, with its exception
    and message: a refresh cadence with 'multi_percent' or
    ``select_percent``, and both under ``grad_mode='scatter'`` (the other
    refusals: tests/test_torch_houv.py::test_unported_options_raise)."""
    src, tgt, _ = _pairs(2, 32)
    p_np = _jax_params(0, 2, 4)
    params = params_from_jax(p_np, "cpu")
    ts, tt = torch.as_tensor(src), torch.as_tensor(tgt)
    for extra in (dict(objective="multi_percent"), dict(select_percent=1.0)):
        jcfg = jhouv.HOUVConfig(kernel=4, use_pallas=False, **extra)
        cfg = config_from_jax(jcfg)
        with pytest.raises(NotImplementedError) as jerr:
            jhouv._check_refresh_supported(jcfg)
        with pytest.raises(NotImplementedError,
                           match=re.escape(str(jerr.value))):
            thouv._adam_loop(ts, tt, 0.0, dataclasses.replace(cfg,
                                                              nn_refresh=2),
                             params, thouv._adam_init(params), 2)
        scatter = dataclasses.replace(jcfg, grad_mode="scatter")
        with pytest.raises(NotImplementedError) as jerr:
            jhouv._objective({k: jnp.asarray(v) for k, v in p_np.items()},
                             jnp.asarray(src), jnp.asarray(tgt), 0.0,
                             scatter)
        with pytest.raises(NotImplementedError,
                           match=re.escape(str(jerr.value))):
            thouv.houv_solve(ts, tt, config_from_jax(scatter),
                             params0=params, device="cpu")
    with pytest.raises(ValueError, match="unknown window_select"):
        thouv.HOUVConfig(window_select="vote")


# the JAX Config fields nothing in houv_tpu/ reads (ROADMAP.md, Queue 1)
_NO_READER = {"every_batch_size", "workers", "use_fpfh", "use_tnet"}
# the fields of ROADMAP.md Queue 1 still to port: none
_QUEUED = set()


def test_no_jax_config_field_is_dropped_on_the_port():
    """Every field of the JAX package's ``HOUVConfig`` and ``Config``
    exists in the port's, or is JAX-only (``state._JAX_ONLY``), or is on
    ROADMAP.md's list of fields still queued or read by nothing; the yaml
    keys of the ablations reach the port's solver config."""
    def names(cls):
        return {f.name for f in dataclasses.fields(cls)}

    assert names(jhouv.HOUVConfig) - names(thouv.HOUVConfig) == _JAX_ONLY
    missing = names(jconfig.Config) - names(tconfig.Config)
    assert missing <= _NO_READER | _QUEUED, missing - _NO_READER - _QUEUED
    with open(os.path.join(_REPO, "ROADMAP.md")) as f:
        roadmap = f.read()
    for name in _NO_READER | _QUEUED:
        assert f"`{name}`" in roadmap, name
    raw = dict(model_name="houv", houv_reparam="v3",
               houv_objective="multi_percent", two_bracket=True,
               window_select="consensus", use_gan=True, gan_weight=50.0)
    cfg = tconfig.Config.from_dict(raw)
    assert (cfg.use_gan, cfg.gan_weight) == (True, 50.0)
    scfg = tcli.solver_config(cfg)
    assert (scfg.reparam, scfg.objective, scfg.two_bracket,
            scfg.window_select) == ("v3", "multi_percent", True, "consensus")
