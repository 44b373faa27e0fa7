"""``houv_tpu_torch/solvers/fgr.py`` against ``houv_tpu/solvers/fgr.py`` on
the CPU.

FPFH bins are hard, so a normal that moves by 1e-7 can move a bin: each
stage is held on the other package's inputs. Normals up to sign (an
eigenvector's sign is free; where n·p ≈ 0 the orientation flip is itself a
tie) on the same neighbours; FPFH with JAX's normals and neighbour indices
handed in; the mutual nearest neighbours on JAX's features, equal but at
the near-ties of JAX's expansion form; the GNC loop on JAX's
correspondences, one iteration within 1e-5 and the whole loop within
1e-3."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from houv_tpu.ops.grouping import knn_points as j_knn_points
from houv_tpu.solvers import fgr as jfgr
from houv_tpu_torch.geometry.rotations import rodrigues
from houv_tpu_torch.ops import grouping
from houv_tpu_torch.solvers import fgr as tfgr
from houv_tpu_torch.solvers.houv import evaluate_solution


@pytest.fixture(scope="module")
def pair():
    from houv_tpu.data import synthesize_registration_pairs

    data = synthesize_registration_pairs(2, n_points=256, seed=5,
                                         shape_mode="structured")
    return data["src"].astype(np.float32), data["tgt"].astype(np.float32)


def _t(x):
    return torch.tensor(np.asarray(x))


def test_normals_match_jax_up_to_sign(pair):
    src, _ = pair
    _, j_idx = j_knn_points(jnp.asarray(src), jnp.asarray(src), 16)
    t_idx = grouping.knn_indices(_t(src), _t(src), 16, device="cpu")
    # the same neighbours first (JAX's CPU search is the expansion form)
    assert (np.asarray(j_idx) == t_idx.numpy()).all()
    nj = np.asarray(jfgr.estimate_normals(jnp.asarray(src)))
    nt = tfgr.estimate_normals(_t(src)).numpy()
    np.testing.assert_allclose(np.abs((nj * nt).sum(-1)), 1.0, atol=1e-5)
    # oriented alike wherever the orientation is not itself a tie
    facing = np.abs((nj * src).sum(-1)) > 1e-3 * np.linalg.norm(src, axis=-1)
    assert facing.mean() > 0.9
    np.testing.assert_allclose(nt[facing], nj[facing], atol=1e-4)


def test_darboux_angles_and_bins_match_jax(rng):
    p1, p2 = (rng.normal(size=(2, 50, 1, 3)).astype(np.float32),
              rng.normal(size=(2, 50, 7, 3)).astype(np.float32))
    n1, n2 = (x / np.linalg.norm(x, axis=-1, keepdims=True) for x in
              (rng.normal(size=p1.shape).astype(np.float32),
               rng.normal(size=p2.shape).astype(np.float32)))
    ja = jfgr._darboux_angles(*(jnp.asarray(x) for x in (p1, n1, p2, n2)))
    ta = tfgr._darboux_angles(*(_t(x) for x in (p1, n1, p2, n2)))
    for j, t in zip(ja, ta):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)
    x = rng.uniform(-3.5, 3.5, (4, 30, 16)).astype(np.float32)
    for lo, hi in ((-1.0, 1.0), (-np.pi, np.pi)):
        np.testing.assert_array_equal(
            tfgr._hist11(_t(x), lo, hi).numpy(),
            np.asarray(jfgr._hist11(jnp.asarray(x), lo, hi)))


def test_fpfh_matches_jax_given_its_normals_and_neighbours(pair):
    """2e-4: the neighbour weights 1/|p - q| come from JAX's expansion-form
    distances there and the exact ones here."""
    for cloud in pair:
        nj = jfgr.estimate_normals(jnp.asarray(cloud))
        _, j_idx = j_knn_points(jnp.asarray(cloud), jnp.asarray(cloud), 17)
        fj = np.asarray(jfgr.fpfh(jnp.asarray(cloud), nj))
        ft = tfgr.fpfh(_t(cloud), _t(nj), idx=_t(j_idx).long()).numpy()
        assert ft.shape == (2, 256, 33)
        np.testing.assert_allclose(ft, fj, atol=2e-4)


def test_mutual_correspondences_on_jax_features(pair):
    """Equal picks but where JAX's expansion-form distance misorders a
    near-tie: there the port's pick is the nearer in f64, and JAX's is no
    farther than the form's rounding, 1e-5·(|a|² + |b|²)."""
    fs = np.asarray(jfgr.fpfh(jnp.asarray(pair[0])))
    ft = np.asarray(jfgr.fpfh(jnp.asarray(pair[1])))
    j_idx, j_mut = (np.asarray(x) for x in
                    jfgr.mutual_correspondences(jnp.asarray(fs),
                                                jnp.asarray(ft)))
    t_idx, t_mut = (x.numpy() for x in
                    tfgr.mutual_correspondences(_t(fs), _t(ft)))
    a, b = fs.astype(np.float64), ft.astype(np.float64)
    rows = np.arange(2)[:, None]
    dj = ((a - b[rows, j_idx]) ** 2).sum(-1)
    dt = ((a - b[rows, t_idx]) ** 2).sum(-1)
    differ = j_idx != t_idx
    assert differ.mean() < 0.05
    assert np.all(dt <= dj + 1e-12)
    scale = (a * a).sum(-1) + (b[rows, j_idx] ** 2).sum(-1)
    assert np.all((dj - dt)[differ] <= 1e-5 * scale[differ])
    # the mutual flag agrees wherever both searches agree
    t_back = grouping.knn_indices(_t(ft), _t(fs), 1, device="cpu")[..., 0]
    j_back = np.asarray(j_knn_points(jnp.asarray(ft), jnp.asarray(fs), 1,
                                     use_pallas=False)[1])[..., 0]
    same = ~differ & (np.take_along_axis(t_back.numpy(), t_idx, 1)
                      == np.take_along_axis(j_back, j_idx, 1))
    assert same.mean() > 0.9
    np.testing.assert_array_equal(t_mut[same], j_mut[same])


@pytest.mark.parametrize("iters,tol", [(1, 1e-5), (48, 1e-3)])
def test_gnc_matches_jax_on_its_correspondences(monkeypatch, pair, iters,
                                                tol):
    """JAX's own GNC scan (``fgr_solve`` run unjitted, its feature stages
    replaced by JAX's correspondences computed beforehand: under one jit
    XLA fuses FPFH differently, which moves hard bins) against
    ``fgr_gnc`` on the same correspondences."""
    src, tgt = pair
    idx, mutual = jfgr.mutual_correspondences(jfgr.fpfh(jnp.asarray(src)),
                                              jfgr.fpfh(jnp.asarray(tgt)))
    monkeypatch.setattr(jfgr, "fpfh", lambda pts, k=16: pts)
    monkeypatch.setattr(jfgr, "mutual_correspondences",
                        lambda fs, ft: (idx, mutual))
    j_out = jfgr.fgr_solve.__wrapped__(jnp.asarray(src), jnp.asarray(tgt),
                                       iters=iters)
    q = np.take_along_axis(tgt, np.asarray(idx)[..., None].astype(np.int64),
                           1)
    r, t = tfgr.fgr_gnc(_t(src), _t(q), _t(mutual).float(), iters)
    tf = np.asarray(j_out["transform"])
    np.testing.assert_allclose(r.numpy(), tf[:, :3, :3], atol=tol)
    np.testing.assert_allclose(t.numpy(), tf[:, :3, 3], atol=tol)


def test_fgr_recovers_a_full_overlap_pose(pair):
    """Same points, rotated, moved and shuffled: the FPFH features match,
    and FGR recovers the pose."""
    src = _t(pair[0])
    gen = torch.Generator().manual_seed(0)
    r = rodrigues(torch.tensor([0.7, 1.2]), torch.randn((2, 3),
                                                         generator=gen))
    t = torch.rand((2, 3), generator=gen) * 0.4 - 0.2
    tgt = (torch.einsum("bij,bnj->bni", r, src) + t[:, None])[
        :, torch.randperm(256, generator=gen)]
    out = tfgr.fgr_solve(src, tgt, iters=48, device="cpu")
    pose = torch.zeros((2, 4, 4))
    pose[:, :3, :3], pose[:, :3, 3], pose[:, 3, 3] = r, t, 1.0
    r_err, t_err = evaluate_solution(out["transform"], pose)
    assert float(r_err.max()) < 1.0, r_err
    assert float(t_err.max()) < 0.01, t_err


def test_fgr_searches_four_coordinate_and_two_feature_knns(monkeypatch,
                                                           pair):
    """The derived launches of a batch: K6 at k 16 (normals) and k 17
    (FPFH) on each cloud, K6-wide at k 1 in the 33-dim space both ways."""
    calls = []

    def counted(query, ref, k, device):
        calls.append((query.shape[-1], k))
        return grouping.knn_indices(query, ref, k, device=device)

    monkeypatch.setattr(tfgr, "knn_indices", counted)
    tfgr.fgr_solve(_t(pair[0]), _t(pair[1]), iters=2, device="cpu")
    assert sorted(calls) == [(3, 16), (3, 16), (3, 17), (3, 17), (33, 1),
                             (33, 1)]


def test_fgr_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = torch.randn(1, 32, 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfgr.fgr_solve(pts, pts)
