"""The port's classifier-rescored selection (``solvers/rescore.py``) and its
CLI wiring (``train/cli.py:make_rescorer``) against the JAX package, on the
CPU.

Candidate extraction and the pick rule are held exactly (masked windows,
the duplicate tail, a logit exactly at the margin); the rescored solve with
the oracle scorer on a tiny config picks what JAX picks from the same
restarts; at margin +inf it is ``houv_solve``'s transform; the classifier
scorer (micro-batches with a ragged tail, test-time rotations, the gap
input) gives JAX's scorer's logits.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from houv_tpu.models.alignment import AlignmentClassifier as JClassifier
from houv_tpu.solvers import houv as jhouv
from houv_tpu.solvers import rescore as jrescore
from houv_tpu_torch.models.alignment import AlignmentClassifier
from houv_tpu_torch.solvers import houv as thouv
from houv_tpu_torch.solvers import rescore as trescore
from houv_tpu_torch.state import config_from_jax, params_from_jax, \
    state_from_flax
from houv_tpu_torch.train import cli as tcli
from houv_tpu_torch.train.config import Config
from test_torch_houv import _pairs


def _random_rotations(rng, shape):
    """Rotations (…, 3, 3) from random axis-angles, f32."""
    axis = rng.standard_normal(shape + (3,))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    ang = rng.uniform(0, np.pi, shape)[..., None, None]
    k = np.zeros(shape + (3, 3))
    k[..., 0, 1], k[..., 0, 2] = -axis[..., 2], axis[..., 1]
    k[..., 1, 0], k[..., 1, 2] = axis[..., 2], -axis[..., 0]
    k[..., 2, 0], k[..., 2, 1] = -axis[..., 1], axis[..., 0]
    r = np.eye(3) + np.sin(ang) * k + (1 - np.cos(ang)) * (k @ k)
    return r.astype(np.float32)


def _pool(rng, b=3, p=24):
    """Pools with masked windows (+inf), exact loss ties, and one pair
    whose restarts share two basins (fewer diverse picks than asked)."""
    loss = rng.uniform(0.01, 0.1, (b, p)).astype(np.float32)
    loss[0, 12:] = np.inf                      # a window pair 0 never ran
    loss[1, 3] = loss[1, 7]                    # an exact tie
    rots = _random_rotations(rng, (b, p))
    # pair 2: every restart within 3 degrees of one of two rotations
    base = _random_rotations(rng, (2,))
    jitter = _random_rotations(rng, (p,))
    small = np.einsum("pij->pij", jitter)
    angle = np.radians(rng.uniform(0, 3, p))
    small = np.stack([np.eye(3)] * p).astype(np.float32)
    small[:, 0, 0] = small[:, 1, 1] = np.cos(angle)
    small[:, 0, 1], small[:, 1, 0] = -np.sin(angle), np.sin(angle)
    rots[2] = np.einsum("pij,pjk->pik", small, base[np.arange(p) % 2])
    trans = rng.standard_normal((b, p, 3)).astype(np.float32)
    return loss, rots, trans


@pytest.mark.parametrize("n_cand,angle", [(8, 10.0), (4, 30.0), (16, 10.0)])
def test_extract_candidates_matches_jax_exactly(rng, n_cand, angle):
    loss, rots, trans = _pool(rng)
    ref = [np.asarray(x) for x in jrescore.extract_candidates(
        jnp.asarray(loss), jnp.asarray(rots), jnp.asarray(trans), n_cand,
        angle)]
    out = [x.numpy() for x in trescore.extract_candidates(
        torch.tensor(loss), torch.tensor(rots), torch.tensor(trans), n_cand,
        angle)]
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o, r)
    cand_loss = out[0]
    assert np.isfinite(cand_loss[0]).all()     # a masked slot is no pick
    assert cand_loss[0, 0] == loss[0].min()
    # two basins: the tail repeats the first slot in loss order
    np.testing.assert_array_equal(cand_loss[2, 2:],
                                  np.full(n_cand - 2, loss[2].min()))


def test_rescore_pick_matches_jax_at_the_margin():
    """An override needs a logit MORE than the margin above candidate 0's:
    exactly at the margin stays with candidate 0; the first of equal best
    logits is the challenger."""
    logits = np.float32([[0.0, 3.0, 1.0],        # exactly at margin 3
                         [0.0, 3.5, 3.5],        # tie: the first wins
                         [2.0, 1.0, 0.5],        # candidate 0 is best
                         [-1.0, 2.5, 0.0]])      # above the margin
    loss = np.zeros_like(logits)
    for margin in (3.0, 0.0, float("inf")):
        ref = np.asarray(jrescore.rescore_pick(
            jnp.asarray(loss), jnp.asarray(logits), margin))
        out = trescore.rescore_pick(torch.tensor(loss), torch.tensor(logits),
                                    margin).numpy()
        np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(
        trescore.rescore_pick(torch.tensor(loss), torch.tensor(logits),
                              3.0).numpy(), [0, 1, 0, 1])


def _tiny_solve(seed=4, steps=3):
    """Two pairs, 8 restarts, 2 windows, a few steps: each package's f32
    Adam run of a restart parts from the other's after a handful of steps
    (a gradient component that is rounding noise moves by O(lr), signed by
    the rounding), so the pools are compared early; random axes, since a
    lattice axis has such components from the first step."""
    src, tgt, gt = _pairs(2, 96, seed=seed)
    jcfg = jhouv.HOUVConfig(kernel=8, steps=steps, angle_passes=2,
                            retry_mode="always", use_pallas=False,
                            lattice_init=False)
    key = jax.random.PRNGKey(7)
    p_np = {k: np.asarray(v) for k, v in
            jhouv.init_params(key, 2, 8, lattice_init=False).items()}
    return src, tgt, gt, jcfg, key, p_np


def test_oracle_rescored_solve_picks_as_jax():
    """The rescored solve with the oracle scorer from JAX's restarts,
    each package on its own pools: the pools agree to 1e-3, and the
    candidates, picks and overrides are JAX's. On JAX's pools the port's
    extraction, logits, picks and transforms are JAX's exactly."""
    src, tgt, gt, jcfg, key, p_np = _tiny_solve()
    cfg = config_from_jax(jcfg)
    jpools = jrescore.houv_candidate_pools(jnp.asarray(src), jnp.asarray(tgt),
                                           key, jcfg)
    pools = trescore.houv_candidate_pools(
        torch.tensor(src), torch.tensor(tgt), cfg,
        params0=params_from_jax(p_np, "cpu"), device="cpu")
    assert pools[3] == int(jpools[3]) == 2
    np.testing.assert_allclose(pools[0].numpy(), np.asarray(jpools[0]),
                               rtol=1e-3)
    np.testing.assert_allclose(pools[1].numpy(), np.asarray(jpools[1]),
                               atol=1e-3)

    def run_jax(pools_in):
        return jrescore.houv_solve_rescored(
            jnp.asarray(src), jnp.asarray(tgt), key, jcfg,
            jrescore.make_oracle_scorer(jnp.asarray(gt)), n_cand=4,
            angle_deg=10.0, margin=0.5, pools=pools_in)

    def run_port(pools_in):
        return trescore.houv_solve_rescored(
            torch.tensor(src), torch.tensor(tgt), cfg,
            trescore.make_oracle_scorer(torch.tensor(gt)), n_cand=4,
            angle_deg=10.0, margin=0.5, device="cpu", pools=pools_in)

    jout = run_jax(jpools)
    out = run_port(pools)
    np.testing.assert_array_equal(out["pick"].numpy(),
                                  np.asarray(jout["pick"]))
    assert out["n_override"] == int(jout["n_override"])
    np.testing.assert_allclose(out["cand_loss"].numpy(),
                               np.asarray(jout["cand_loss"]), rtol=1e-3)
    np.testing.assert_allclose(out["transform"].numpy(),
                               np.asarray(jout["transform"]), atol=1e-3)
    shared = run_port(tuple(torch.tensor(np.asarray(x)) for x in jpools[:3])
                      + (int(jpools[3]),))
    np.testing.assert_array_equal(shared["pick"].numpy(),
                                  np.asarray(jout["pick"]))
    np.testing.assert_array_equal(shared["cand_loss"].numpy(),
                                  np.asarray(jout["cand_loss"]))
    np.testing.assert_allclose(shared["cand_logits"].numpy(),
                               np.asarray(jout["cand_logits"]), atol=1e-3)
    np.testing.assert_allclose(shared["transform"].numpy(),
                               np.asarray(jout["transform"]), atol=1e-6)


def test_margin_inf_is_houv_solve():
    src, tgt, _, jcfg, _, p_np = _tiny_solve(seed=6, steps=10)
    cfg = config_from_jax(jcfg)
    params0 = params_from_jax(p_np, "cpu")
    base = thouv.houv_solve(torch.tensor(src), torch.tensor(tgt), cfg,
                            params0=params0, device="cpu")

    def never(moved, tgt, cand_r, cand_t, cand_loss=None):
        return torch.randn(cand_r.shape[:2]) * 100

    out = trescore.houv_solve_rescored(
        torch.tensor(src), torch.tensor(tgt), cfg, never, n_cand=4,
        margin=float("inf"), params0=params0, device="cpu")
    assert out["n_override"] == 0 and not out["pick"].any()
    np.testing.assert_array_equal(out["transform"].numpy(),
                                  base["transform"].numpy())
    np.testing.assert_array_equal(out["rmse"].numpy(), base["rmse"].numpy())


def test_classifier_scorer_matches_jax_scorer(rng):
    """Micro-batches of 4 over 2 pairs x 5 candidates (a ragged tail, which
    the port does not pad), 3 test-time rotations, the loss-gap input."""
    assert np.allclose(trescore._tta_rotations(5).numpy(),
                       np.asarray(jrescore._tta_rotations(5)), atol=1e-6)
    src = rng.uniform(-0.7, 0.7, (2, 48, 3)).astype(np.float32)
    tgt = rng.uniform(-0.7, 0.7, (2, 40, 3)).astype(np.float32)
    cand_r = _random_rotations(rng, (2, 5)) * 0 + np.eye(3, dtype=np.float32)
    cand_r[:, 1:] = _random_rotations(rng, (2, 4))
    cand_t = (0.05 * rng.standard_normal((2, 5, 3))).astype(np.float32)
    cand_loss = np.sort(rng.uniform(0.01, 0.05, (2, 5)), 1).astype(
        np.float32)
    jm = JClassifier(grid_size=12, init_size=4, n_extra=1)
    v = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(1), jnp.asarray(src), jnp.asarray(tgt), False))
    v["params"]["Dense_2"]["kernel"] = np.float32([[0.8]])
    jscorer = jrescore.make_classifier_scorer(jm, v, micro_batch=4, n_aug=3,
                                              use_gap=True)
    moved = jrescore.apply_candidates(jnp.asarray(src), jnp.asarray(cand_r),
                                      jnp.asarray(cand_t))
    ref = np.asarray(jscorer(moved, jnp.asarray(tgt), cand_r, cand_t,
                             cand_loss=jnp.asarray(cand_loss)))
    model = AlignmentClassifier(grid_size=12, init_size=4, n_extra=1)
    model.load_state_dict(state_from_flax(v, model), strict=True)
    model.eval()
    scorer = trescore.make_classifier_scorer(model, micro_batch=4, n_aug=3,
                                             use_gap=True)
    tmoved = trescore.apply_candidates(torch.tensor(src),
                                       torch.tensor(cand_r),
                                       torch.tensor(cand_t))
    np.testing.assert_allclose(tmoved.numpy(), np.asarray(moved), atol=1e-6)
    out = scorer(tmoved, torch.tensor(tgt), cand_r, cand_t,
                 cand_loss=torch.tensor(cand_loss))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)
    assert scorer.calls == 3                    # 10 rows, 4 at a time
    with pytest.raises(ValueError, match="cand_loss"):
        scorer(tmoved, torch.tensor(tgt), cand_r, cand_t)


def test_make_rescorer_warns_without_checkpoint_and_raises_on_a_bad_one(
        tmp_path, caplog):
    cfg = Config(rescore_ckpt=str(tmp_path / "none.ckpt"))
    with caplog.at_level(logging.WARNING):
        assert tcli.make_rescorer(cfg, logging.getLogger("t"), "cpu") is None
    assert "WITHOUT rescoring" in caplog.text
    assert tcli.make_rescorer(Config(), logging.getLogger("t"), "cpu") is None
    bad = tmp_path / "bad.ckpt"
    bad.write_bytes(b"\x81\xa6params\xc1")
    with pytest.raises(ValueError):
        tcli.make_rescorer(Config(rescore_ckpt=str(bad)),
                           logging.getLogger("t"), "cpu")
