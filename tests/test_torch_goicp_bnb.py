"""``houv_tpu_torch/solvers/goicp_bnb.py`` against ``houv_tpu/solvers/
goicp_bnb.py`` on the CPU: the distance field within 1e-5 of JAX's, the
lookup and a cube's bounds on the same cubes, the top-k tie rule (the lower
index first), and the certificate tests of ``tests/test_goicp_bnb.py``
rerun on the port: the field's floor and ceiling bound the true distance
inside and outside the grid, a cube's LB never exceeds the objective inside
it, the planted 60° case is recovered with a certificate (e within 1e-5 of
JAX's), and the certificate's fields are well formed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from houv_tpu.geometry.rotations import rodrigues as j_rodrigues
from houv_tpu.solvers import goicp_bnb as jbnb
from houv_tpu_torch.geometry.rotations import rodrigues
from houv_tpu_torch.ops import sampling
from houv_tpu_torch.solvers import goicp_bnb as tbnb

TOL = 1e-5


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _cloud(rng, n):
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    return pts / (2.0 * np.abs(pts).max())  # inside [-0.5, 0.5]³


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("grid,lo,hi", [(24, -1.2, 1.2), (32, -1.5, 1.5)])
def test_distance_field_matches_jax(rng, grid, lo, hi):
    tgt = np.stack([_cloud(rng, 64), _cloud(rng, 80)[:64]])
    fj, cj = jbnb.build_distance_field(jnp.asarray(tgt), grid, lo, hi)
    ft, ct = tbnb.build_distance_field(_t(tgt), grid, lo, hi)
    assert ft.shape == (2, grid, grid, grid) and ct == pytest.approx(cj)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), atol=TOL)


def test_field_lookup_matches_jax(rng):
    tgt = _cloud(rng, 64)[None]
    field, cell = tbnb.build_distance_field(_t(tgt), 24, -1.2, 1.2)
    qry = rng.uniform(-3.0, 3.0, (1, 300, 3)).astype(np.float32)
    fj, dj = jbnb._field_lookup(jnp.asarray(field.numpy()[0]),
                                jnp.asarray(qry[0]), -1.2, cell)
    ft, dt = tbnb._field_lookup(field, _t(qry), -1.2, cell)
    np.testing.assert_allclose(ft.numpy()[0], np.asarray(fj), atol=TOL)
    np.testing.assert_allclose(dt.numpy()[0], np.asarray(dj), atol=TOL)


def test_cube_bounds_match_jax_on_the_same_cubes(rng):
    """The JAX solver's ``bounds`` (a closure) recomputed from its own
    pieces, ``rodrigues`` and ``_field_lookup``, on the same cubes."""
    src = np.stack([_cloud(rng, 48), _cloud(rng, 48)])
    tgt = np.stack([_cloud(rng, 64), _cloud(rng, 64)])
    field, cell = tbnb.build_distance_field(_t(tgt), 24, -1.5, 1.5)
    k = 40
    rot_c = rng.uniform(-3.0, 3.0, (2, k, 3)).astype(np.float32)
    rot_c[0, 0] = 0.0                                  # the identity cube
    sig_r = rng.uniform(0.05, 0.8, (2, k)).astype(np.float32)
    tr_c = rng.uniform(-0.3, 0.3, (2, k, 3)).astype(np.float32)
    sig_t = rng.uniform(0.02, 0.5, (2, k)).astype(np.float32)
    active = rng.uniform(size=(2, k)) > 0.2
    p_norm = np.linalg.norm(src, axis=-1)
    lb, ub, _ = tbnb.cube_bounds(field, cell, -1.5, _t(src), _t(p_norm),
                                 _t(rot_c), _t(sig_r), _t(tr_c), _t(sig_t),
                                 _t(active))

    angle = jnp.linalg.norm(rot_c, axis=-1)
    axis = rot_c / jnp.maximum(angle, 1e-12)[..., None]
    r = j_rodrigues(angle.reshape(-1), axis.reshape(-1, 3)).reshape(
        2, k, 3, 3)
    moved = jnp.einsum("bkij,bnj->bkni", r, src) + tr_c[:, :, None, :]
    f, node_d = jax.vmap(lambda fb, mb: jbnb._field_lookup(
        fb, mb, -1.5, cell))(jnp.asarray(field.numpy()), moved)
    gamma = (2.0 * jnp.sin(jnp.minimum(jnp.sqrt(3.0) * sig_r, jnp.pi)
                           [..., None] / 2.0) * p_norm[:, None, :])
    tau = (jnp.sqrt(3.0) * sig_t)[..., None]
    lb_pt = jnp.maximum(f - node_d - gamma - tau, 0.0)
    ub_pt = f + node_d
    j_lb = jnp.where(active, jnp.mean(lb_pt * lb_pt, -1), jnp.inf)
    j_ub = jnp.where(active, jnp.mean(ub_pt * ub_pt, -1), jnp.inf)
    np.testing.assert_allclose(lb.numpy(), np.asarray(j_lb), atol=TOL)
    np.testing.assert_allclose(ub.numpy(), np.asarray(j_ub), atol=TOL)


def test_selection_takes_top_k_tie_rule(rng):
    """``_smallest(x, k)`` is ``lax.top_k(-x, k)``'s indices: ties (LB 0
    everywhere at early levels, +inf on inactive slots) go to the lower
    index."""
    x = rng.integers(0, 4, (3, 200)).astype(np.float32) * 0.25
    x[:, ::7] = np.inf
    x[1] = 0.0
    for k in (1, 4, 25, 200):
        _, j_idx = jax.lax.top_k(-jnp.asarray(x), k)
        np.testing.assert_array_equal(tbnb._smallest(_t(x), k).numpy(),
                                      np.asarray(j_idx))


def test_distance_field_floor_is_lower_bound(rng):
    tgt = _cloud(rng, 64)[None]
    field, cell = tbnb.build_distance_field(_t(tgt), grid=24, lo=-1.2,
                                            hi=1.2)
    qry = rng.uniform(-0.9, 0.9, (1, 200, 3)).astype(np.float32)
    true_d = np.sqrt(((qry[0][:, None] - tgt[0][None]) ** 2).sum(-1)
                     .min(-1))
    f, node_d = (x.numpy()[0] for x in
                 tbnb._field_lookup(field, _t(qry), -1.2, cell))
    half_diag = np.sqrt(3.0) / 2.0 * cell
    assert np.all(f - node_d <= true_d + 1e-5)
    assert np.all(f + node_d >= true_d - 1e-5)
    assert np.all(node_d <= half_diag + 1e-6)
    assert np.mean(np.abs(f - true_d)) < 2.0 * half_diag


def test_field_bounds_valid_outside_grid(rng):
    tgt = _cloud(rng, 64)[None]
    field, cell = tbnb.build_distance_field(_t(tgt), grid=24, lo=-1.2,
                                            hi=1.2)
    qry = np.concatenate([rng.uniform(1.2, 3.0, (100, 3)),
                          rng.uniform(-3.0, 3.0, (200, 3)),
                          np.array([[2.1, 0.0, 0.0]])]).astype(np.float32)
    true_d = np.sqrt(((qry[:, None] - tgt[0][None]) ** 2).sum(-1).min(-1))
    f, node_d = (x.numpy()[0] for x in
                 tbnb._field_lookup(field, _t(qry[None]), -1.2, cell))
    assert np.all(f - node_d <= true_d + 1e-5)
    assert np.all(f + node_d >= true_d - 1e-5)


def test_cube_lower_bound_validity_on_the_port(rng):
    """For random SE(3) cubes and a transform drawn inside each, the
    objective there is at least the cube's LB."""
    src = _cloud(rng, 48)
    tgt = _cloud(rng, 64)
    field, cell = tbnb.build_distance_field(_t(tgt[None]), grid=24,
                                            lo=-1.5, hi=1.5)
    p_norm = np.linalg.norm(src, axis=-1)
    for trial in range(20):
        rc = rng.uniform(-2.0, 2.0, 3).astype(np.float32)
        sr = float(rng.uniform(0.05, 0.6))
        tc = rng.uniform(-0.3, 0.3, 3).astype(np.float32)
        st = float(rng.uniform(0.02, 0.2))
        lb, _, _ = tbnb.cube_bounds(
            field, cell, -1.5, _t(src[None]), _t(p_norm[None]),
            _t(rc[None, None]), torch.tensor([[sr]]), _t(tc[None, None]),
            torch.tensor([[st]]), torch.tensor([[True]]))
        rr = rc + rng.uniform(-sr, sr, 3).astype(np.float32)
        tt = tc + rng.uniform(-st, st, 3).astype(np.float32)
        ang = np.linalg.norm(rr)
        r_in = rodrigues(torch.tensor([ang], dtype=torch.float32),
                         _t((rr / max(ang, 1e-9))[None]))[0].numpy()
        moved = src @ r_in.T + tt
        e_true = float(((moved[:, None] - tgt[None]) ** 2).sum(-1).min(-1)
                       .mean())
        assert e_true >= float(lb[0, 0]) - 1e-5, (trial, e_true, lb)


def test_bnb_recovers_rotation_with_certificate_on_the_port(rng):
    """The planted 60° case: the incumbent reaches the planted objective
    (e <= 1e-5, within 1e-5 of JAX's), the gap collapses (<= 5e-4) and
    the rotation is within 2° — vanilla ICP from the identity fails here,
    so this is the search at work."""
    src = _cloud(rng, 96)
    axis = np.array([0.3, 1.0, -0.2], np.float32)
    r_gt = rodrigues(torch.tensor([np.radians(60.0)], dtype=torch.float32),
                     _t(axis[None]))[0].numpy()
    t_gt = np.array([0.1, -0.05, 0.08], np.float32)
    tgt = src @ r_gt.T + t_gt
    kw = dict(trans_half=0.2, n_src=48, grid=32, frontier=1024, levels=12,
              icp_iters=8)
    out = tbnb.goicp_bnb_solve(_t(src[None]), _t(tgt[None]), device="cpu",
                               **kw)
    j_out = jbnb.goicp_bnb_solve(jnp.asarray(src[None]),
                                 jnp.asarray(tgt[None]), **kw)
    e, gap = float(out["e"][0]), float(out["gap"][0])
    assert np.isfinite(e) and gap >= -1e-6
    assert e <= 1e-5, e
    assert gap <= 5e-4, gap
    assert abs(e - float(j_out["e"][0])) <= 1e-5
    r_est = out["transform"][0, :3, :3].numpy()
    rot_err = np.degrees(np.arccos(np.clip((np.trace(r_est.T @ r_gt) - 1)
                                           / 2, -1, 1)))
    assert rot_err < 2.0, rot_err


def test_bnb_certificate_fields_shapes(rng):
    src = _t(np.stack([_cloud(rng, 40), _cloud(rng, 40)]))
    tgt = _t(np.stack([_cloud(rng, 40), _cloud(rng, 40)]))
    sampling.furthest_point_sample.launches = 0
    out = tbnb.goicp_bnb_solve(src, tgt, trans_half=0.1, n_src=16, grid=16,
                               frontier=64, levels=4, icp_iters=2,
                               device="cpu")
    assert out["transform"].shape == (2, 4, 4)
    assert out["certified"].shape == (2,)
    assert out["n_active"].shape == (2,)
    assert bool((out["gap"] >= -1e-6).all())
    # the lb trace is monotone non-decreasing per pair (shrinking cubes)
    tr = out["lb_trace"].numpy()                          # (levels, B)
    assert tr.shape == (4, 2)
    for b in range(2):
        col = tr[np.isfinite(tr[:, b]), b]
        assert np.all(np.diff(col) >= -1e-5)
    # the plain FPS on the CPU: no kernel launch counted
    assert sampling.furthest_point_sample.launches == 0


def test_bnb_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = torch.randn(1, 32, 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbnb.goicp_bnb_solve(pts, pts)
