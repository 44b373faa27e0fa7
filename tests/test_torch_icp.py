"""``houv_tpu_torch/solvers/icp.py`` against ``houv_tpu/solvers/icp.py`` on
the CPU (the port's plain nearest-neighbour search; JAX with
``use_pallas=False``).

ICP iterates, and two packages' f32 runs part after a few iterations, so
one iteration is held from JAX's own state (the matches equal away from
ties, R and t within 1e-5) and the solvers end to end on quality: the
convergence, multistart and grid tests of ``tests/test_solvers.py`` rerun
on the port, the multistart with JAX's own restart axes and angles."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from houv_tpu.geometry.rotations import rodrigues as j_rodrigues
from houv_tpu.ops.chamfer import chamfer as j_chamfer
from houv_tpu.solvers.icp import icp_solve as j_icp_solve
from houv_tpu.solvers.icp import so3_grid as j_so3_grid
from houv_tpu_torch.ops.chamfer import chamfer_indices
from houv_tpu_torch.solvers import icp as ticp
from houv_tpu_torch.solvers.houv import evaluate_solution

TOL = 1e-5


def _full_overlap_problem(rng, bsz=2, n=128, max_angle_deg=40.0):
    """``tests/test_solvers.py:_full_overlap_problem``."""
    src = rng.uniform(-0.5, 0.5, (bsz, n, 3)).astype(np.float32)
    axes = rng.standard_normal((bsz, 3)).astype(np.float32)
    angles = np.radians(rng.uniform(5, max_angle_deg, bsz)).astype(np.float32)
    r = np.asarray(j_rodrigues(jnp.asarray(angles), jnp.asarray(axes)))
    t = rng.uniform(-0.3, 0.3, (bsz, 3)).astype(np.float32)
    tgt = np.einsum("bij,bnj->bni", r, src) + t[:, None]
    pose = np.zeros((bsz, 4, 4), np.float32)
    pose[:, :3, :3] = r
    pose[:, :3, 3] = t
    pose[:, 3, 3] = 1
    return src, tgt.astype(np.float32), pose


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("threshold", [1.0, 0.05])
def test_one_iteration_from_jax_state_matches(rng, threshold):
    src, tgt, _ = _full_overlap_problem(rng, bsz=3, n=160, max_angle_deg=60)
    tgt = tgt + 0.01 * rng.normal(size=tgt.shape).astype(np.float32)
    # JAX's state after 3 iterations, then one more iteration each side
    state = j_icp_solve(jnp.asarray(src), jnp.asarray(tgt),
                        threshold=threshold, max_iters=3, use_pallas=False)
    tf3 = np.asarray(state["transform"])
    jnext = j_icp_solve(jnp.asarray(src), jnp.asarray(tgt),
                        threshold=threshold, max_iters=1,
                        init_transform=jnp.asarray(tf3), use_pallas=False)
    nxt = ticp.icp_solve(_t(src), _t(tgt), threshold=threshold, max_iters=1,
                         init_transform=_t(tf3), device="cpu")
    np.testing.assert_allclose(nxt["transform"].numpy(),
                               np.asarray(jnext["transform"]), atol=TOL)
    np.testing.assert_allclose(nxt["inlier_rmse"].numpy(),
                               np.asarray(jnext["inlier_rmse"]), atol=TOL)
    # the iteration's matches: equal but at near-ties of the two forms
    moved = (np.einsum("bnc,bdc->bnd", src, tf3[:, :3, :3])
             + tf3[:, None, :3, 3]).astype(np.float32)
    _, _, ij, _ = j_chamfer(jnp.asarray(moved), jnp.asarray(tgt),
                            use_pallas=False)
    it, _ = chamfer_indices(_t(moved), _t(tgt), device="cpu")
    ij, it = np.asarray(ij), it.numpy()
    m64, t64 = moved.astype(np.float64), tgt.astype(np.float64)
    rows = np.arange(3)[:, None]
    dj = ((m64 - t64[rows, ij]) ** 2).sum(-1)
    dt = ((m64 - t64[rows, it]) ** 2).sum(-1)
    differ = ij != it
    assert differ.mean() < 0.01
    assert np.all(dt <= dj + 1e-12)
    assert np.all(np.abs(dj - dt)[differ] <= 1e-6)


def test_icp_converges_small_perturbation(rng):
    """``tests/test_solvers.py::test_icp_converges_small_perturbation``."""
    src, tgt, pose = _full_overlap_problem(rng, bsz=2, n=256,
                                           max_angle_deg=15.0)
    out = ticp.icp_solve(_t(src), _t(tgt), threshold=1.0, max_iters=50,
                         device="cpu")
    r_err, t_err = evaluate_solution(out["transform"], _t(pose))
    assert float(r_err.max()) < 1.0, r_err
    assert float(t_err.max()) < 0.01


def test_icp_multistart_beats_vanilla_with_jax_restarts(rng):
    """``tests/test_solvers.py::test_icp_multistart_beats_vanilla_on_large_
    rotation`` with JAX's restart axes and angles (key 3) handed over:
    restart 0 is the identity, so the winner's inlier RMSE never exceeds
    vanilla ICP's."""
    src, tgt, _ = _full_overlap_problem(rng, bsz=2, n=128,
                                        max_angle_deg=170.0)
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    axes = np.asarray(jax.random.normal(k1, (16, 2, 3)))
    angles = np.asarray(jax.random.uniform(k2, (16, 2), maxval=2 * jnp.pi))
    plain = ticp.icp_solve(_t(src), _t(tgt), threshold=1.0, max_iters=30,
                           device="cpu")
    multi = ticp.icp_solve_multistart(_t(src), _t(tgt), n_restarts=16,
                                      threshold=1.0, max_iters=30,
                                      axes=_t(axes), angles=_t(angles),
                                      device="cpu")
    assert float((multi["inlier_rmse"] - plain["inlier_rmse"]).max()) <= 1e-5
    # and from a generator: restart 0 the identity likewise
    gen = ticp.icp_solve_multistart(_t(src), _t(tgt),
                                    torch.Generator().manual_seed(0),
                                    n_restarts=4, threshold=1.0,
                                    max_iters=30, device="cpu")
    assert float((gen["inlier_rmse"] - plain["inlier_rmse"]).max()) <= 1e-5


def test_so3_grid_matches_jax():
    grid = ticp.so3_grid()
    assert grid.shape == (105, 3, 3)
    np.testing.assert_allclose(grid.numpy(), np.asarray(j_so3_grid()),
                               atol=1e-6)


def test_goicp_grid_beats_vanilla_on_large_rotation(rng):
    """``tests/test_solvers.py::test_goicp_grid_beats_vanilla_on_large_
    rotation`` on the port: the SO(3)-grid global ICP recovers rotations
    far outside vanilla ICP's basin."""
    from houv_tpu.data import synthesize_registration_pairs
    from houv_tpu.data.mvp import random_pose_np

    data = synthesize_registration_pairs(3, n_points=192, seed=5,
                                         shape_mode="structured")
    src = data["src"].astype(np.float32)
    poses = np.stack([random_pose_np(rng, np.pi, 0.2,
                                     min_angle=np.radians(120.0))
                      for _ in range(3)]).astype(np.float32)
    tgt = (np.einsum("bij,bnj->bni", poses[:, :3, :3], src)
           + poses[:, None, :3, 3]).astype(np.float32)
    out_g = ticp.goicp_solve(_t(src), _t(tgt), max_iters=25, device="cpu")
    out_v = ticp.icp_solve(_t(src), _t(tgt), threshold=0.1, max_iters=60,
                           device="cpu")
    r_g, _ = evaluate_solution(out_g["transform"], _t(poses))
    r_v, _ = evaluate_solution(out_v["transform"], _t(poses))
    assert float(r_g.median()) < 10.0
    assert float(r_g.mean()) < float(r_v.mean())


def test_goicp_refinement_is_monotone_on_the_port(rng):
    """``tests/test_solvers.py::test_goicp_refinement_is_monotone``."""
    src, tgt, _ = _full_overlap_problem(rng, bsz=2, n=96,
                                        max_angle_deg=120.0)
    out0 = ticp.goicp_solve(_t(src), _t(tgt), max_iters=10, refine_levels=0,
                            device="cpu")
    out2 = ticp.goicp_solve(_t(src), _t(tgt), max_iters=10, refine_levels=2,
                            device="cpu")
    assert float((out2["inlier_rmse"] - out0["inlier_rmse"]).max()) <= 1e-6


@pytest.mark.parametrize("max_iters,levels", [(4, 2), (2, 0)])
def test_goicp_searches_in_chunks_of_five(monkeypatch, max_iters, levels):
    """The derived K1 count: 21 grid chunks and 6 chunks a refinement
    level, each an ICP of max_iters + 1 searches on a (5·B, N, 3) batch
    (1353 a batch at max_iters 40, 2145 at the 64 that cfgs/fgr.yaml's
    num_iters gives goicp)."""
    shapes = []

    def counted(a, b, device):
        shapes.append((tuple(a.shape), tuple(b.shape)))
        return chamfer_indices(a, b, device=device)

    monkeypatch.setattr(ticp, "chamfer_indices", counted)
    src = torch.rand(2, 40, 3) - 0.5
    ticp.goicp_solve(src, src.flip(1), max_iters=max_iters,
                     refine_levels=levels, device="cpu")
    assert len(shapes) == (21 + 6 * levels) * (max_iters + 1)
    assert set(shapes) == {((10, 40, 3), (10, 40, 3))}


def test_icp_entry_points_raise_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = torch.randn(1, 16, 3)
    for fn in (ticp.icp_solve, ticp.goicp_solve):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(pts, pts)
