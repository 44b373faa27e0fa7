"""The port's MVPN preprocessing (``houv_tpu_torch/data/preprocess.py``)
against the JAX package's, on the CPU, at the JAX test's sizes (8 to 24
clouds of 48 to 64 points).

Tolerances: the F1 matrix within 1e-6 (a ratio of counts of distances under
the threshold, each distance rounded alike); kNN indices equal wherever the
k-th and (k+1)-th scores differ, elsewhere the scores at the picks equal;
clusters, voxel-seed counts and the combined dataset's graph exact; the
fused clouds within 1e-5 of their largest coordinate (ten Adam steps of
optax's arithmetic, chamfer sums in another order)."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from houv_tpu.data import preprocess as jpre
from houv_tpu.data import synthesize_completion_set
from houv_tpu.metrics import calc_cd as j_calc_cd
from houv_tpu.models.embedding import InstanceEmbedding as JEmbedding
from houv_tpu_torch.data import preprocess as tpre
from houv_tpu_torch.models import get_model
from houv_tpu_torch.state import state_from_flax
from houv_tpu_torch.train.checkpoint import read_flax_msgpack

EMBED_CKPT = (Path(__file__).resolve().parents[1] / "log"
              / "model_embedding_cd_embed" / "best_acc_network.ckpt")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs one process per core."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _class_of_views(n_models=4, views=4, n=48, seed=5):
    data = synthesize_completion_set(n_models, views_per_model=views,
                                     n_partial=n, n_complete=n, seed=seed)
    return data["incomplete_pcds"].astype(np.float32), data["labels"]


def _jax_f1(partials):
    """JAX's F1 of every pair, as its ``pairwise_f1_knn`` computes a row."""
    n = len(partials)
    a = jnp.asarray(np.repeat(partials, n, 0))
    b = jnp.asarray(np.tile(partials, (n, 1, 1)))
    return np.asarray(j_calc_cd(a, b, calc_f1=True)[2]).reshape(n, n)


def _assert_knn_matches(knn, ref, score, k):
    """Indices equal where each row's k-th and (k+1)-th scores differ;
    elsewhere the scores at the picks equal."""
    s = np.array(score, copy=True)
    np.fill_diagonal(s, -np.inf)
    srt = -np.sort(-s, axis=1)
    rows = np.take_along_axis
    for i in range(len(knn)):
        if srt[i, k - 1] != srt[i, k]:
            np.testing.assert_array_equal(np.sort(knn[i]), np.sort(ref[i]))
        np.testing.assert_array_equal(rows(s[i], knn[i], 0),
                                      rows(s[i], ref[i], 0))


def test_pairwise_f1_and_knn_match_jax(rng):
    partials, _ = _class_of_views()
    ref = _jax_f1(partials)
    # blocks smaller than the class: rows and columns both in parts
    f1 = tpre.pairwise_f1(partials, chunk=5, row_chunk=3, device="cpu")
    np.testing.assert_allclose(f1, ref, rtol=0, atol=1e-6)
    assert np.ptp(f1) > 0.1
    knn = tpre.pairwise_f1_knn(partials, k=4, chunk=7, device="cpu")
    _assert_knn_matches(knn, jpre.pairwise_f1_knn(partials, k=4), ref, 4)


def test_embedding_knn_on_the_trained_embedding_matches_jax(rng):
    partials = rng.uniform(-0.5, 0.5, (12, 64, 3)).astype(np.float32)
    state = read_flax_msgpack(str(EMBED_CKPT))
    jm = JEmbedding()
    ref = jpre.embedding_knn(
        partials, lambda x: jm.apply({"params": state["params"]}, x)[0], k=3,
        batch=8)
    tm = get_model("model_embedding")
    tm.load_state_dict(state_from_flax(state, tm), strict=True)
    tm.eval()
    knn = tpre.embedding_knn(partials, lambda x: tm(x)[0], k=3, batch=5,
                             device="cpu")
    e = np.asarray(jm.apply({"params": state["params"]}, partials)[0])
    _assert_knn_matches(knn, ref, e @ e.T, 3)


def test_bfs_clusters_match_jax(rng):
    for topk in (1, 2, 3):
        knn = rng.integers(0, 40, (40, 3))
        got = tpre.bfs_clusters(knn, topk=topk)
        ref = jpre.bfs_clusters(knn, topk=topk)
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)


def test_voxel_seed_and_fuse_cluster_match_jax(rng):
    gt = rng.uniform(-0.5, 0.5, (64, 3)).astype(np.float32)
    members = np.stack([gt[rng.choice(64, 48, replace=False)]
                        for _ in range(4)])
    for n_target in (16, 2048):
        np.testing.assert_allclose(
            tpre._voxel_seed(members, n_target, device="cpu"),
            jpre._voxel_seed(members, n_target), rtol=0, atol=1e-7)
    gts = gt[None].repeat(4, 0)
    fused, metrics = tpre.fuse_cluster(members, gts, epochs=10,
                                       device="cpu")
    ref, ref_metrics = jpre.fuse_cluster(members, gts, epochs=10)
    np.testing.assert_allclose(fused, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    assert metrics.keys() == ref_metrics.keys()
    for key in metrics:
        np.testing.assert_allclose(metrics[key], ref_metrics[key],
                                   rtol=1e-5)
    # the seed moved
    assert np.abs(fused - tpre._voxel_seed(members, device="cpu")).max() > 0


def _centroid_embedding(x):
    """Unit (mean, std) of each cloud's coordinates: (b, P, 3) -> (b, 6);
    one numpy function for both packages, so the graphs are compared
    exactly (the trained embedding is held to JAX's above)."""
    x = np.asarray(x, np.float64)
    e = np.concatenate([x.mean(1), x.std(1)], -1)
    return (e / np.linalg.norm(e, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("mode", ["f1", "embedding"])
def test_combine_dataset_matches_jax_on_the_port(mode):
    partials, labels = _class_of_views(n_models=4, views=4, n=48, seed=9)
    labels = labels % 2                       # two classes of 8 clouds
    kw, port_kw = {}, {}
    if mode == "embedding":
        kw = {"embed_fn": _centroid_embedding}
        port_kw = {"embed_fn": lambda x: torch.as_tensor(
            _centroid_embedding(x.numpy()))}
    ref = jpre.combine_dataset(partials, labels, k=3, epochs=2, mode=mode,
                               **kw)
    stages = {}
    got = tpre.combine_dataset(partials, labels, k=3, epochs=2, mode=mode,
                               device="cpu", stages=stages, **port_kw)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_allclose(got[1], ref[1], rtol=0,
                               atol=1e-5 * np.abs(ref[1]).max())
    assert set(stages) == {"knn", "clusters", "fuse"}
    for i in range(len(labels)):
        assert (labels[got[0][i]] == labels[i]).all()
