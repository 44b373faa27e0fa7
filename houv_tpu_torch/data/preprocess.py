"""MVPN preprocessing: the data-mining pipeline (counterpart of
``houv_tpu/data/preprocess.py``).

Per class of partial scans: a kNN graph (the k other clouds of highest
chamfer F1, or the nearest in a trained instance embedding), its connected
components by BFS, and for each component one fused cloud, a voxel-mean seed
refined by 10 Adam steps on the chamfer distance to every member. Returns
the ``*_knn.npy`` neighbour lists and the ``*_combine*.npy`` fused clouds of
the reference's pipeline.

The all-pairs F1 runs ``metrics.cd.calc_cd(calc_f1=True)`` over blocks of
``row_chunk`` x ``chunk`` cloud pairs a call (K1, ``csrc/nn_both.cu``, on
the card); the seed's voxel means run ``ops.voxel.voxelize_mean`` (K4,
``csrc/scatter.cu``); the Adam steps K1 forward and K4 backward. Clustering
is numpy. Unlike the reference's ``combine_dataset``, the port's computes no
metric of the fused clouds against the ground truth, which it would drop.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from houv_tpu_torch._device import resolve_device
from houv_tpu_torch.metrics.cd import calc_cd
from houv_tpu_torch.ops.voxel import voxelize_mean
from houv_tpu_torch.solvers.houv import _adam_init, _adam_update


def pairwise_f1(partials: np.ndarray, chunk: int = 1024, row_chunk: int = 16,
                device: str | torch.device = "cuda") -> np.ndarray:
    """Chamfer F1 of every pair of clouds: (N, P, 3) -> (N, N) f32, entry
    (i, j) the F1 of cloud i as output against cloud j as ground truth (F1
    is symmetric in the two). Each ``calc_cd`` call takes ``row_chunk``
    rows against ``chunk`` columns."""
    dev = resolve_device(device)
    pts = torch.as_tensor(np.asarray(partials, np.float32), device=dev)
    n = pts.shape[0]
    out = torch.empty((n, n), dtype=torch.float32, device=dev)
    with torch.no_grad():
        for r0 in range(0, n, row_chunk):
            rows = pts[r0:r0 + row_chunk]
            for c0 in range(0, n, chunk):
                cols = pts[c0:c0 + chunk]
                r, c = rows.shape[0], cols.shape[0]
                a = rows[:, None].expand(r, c, *rows.shape[1:])
                b = cols[None].expand(r, c, *cols.shape[1:])
                f1 = calc_cd(a.reshape(r * c, *rows.shape[1:]),
                             b.reshape(r * c, *cols.shape[1:]),
                             calc_f1=True)[2]
                out[r0:r0 + r, c0:c0 + c] = f1.reshape(r, c)
    return out.cpu().numpy()


def _top_k(score: np.ndarray, k: int) -> np.ndarray:
    """Each row's k highest-scoring other columns (the diagonal excluded),
    as the reference ranks them (``np.argsort`` of the negated scores)."""
    score = np.array(score, copy=True)
    np.fill_diagonal(score, -np.inf)
    return np.argsort(-score, axis=1)[:, :k].astype(np.int64)


def pairwise_f1_knn(partials: np.ndarray, k: int = 6, chunk: int = 1024,
                    row_chunk: int = 16,
                    device: str | torch.device = "cuda") -> np.ndarray:
    """For every cloud, the k other clouds of highest chamfer F1 (the
    reference's subsolve3). partials (N, P, 3) -> (N, k) int64."""
    return _top_k(pairwise_f1(partials, chunk, row_chunk, device), k)


def embedding_knn(partials: np.ndarray, apply_fn, k: int = 6,
                  batch: int = 64,
                  device: str | torch.device = "cuda") -> np.ndarray:
    """kNN over instance embeddings (the reference's solve2_embedding):
    ``apply_fn`` maps a (b, P, 3) tensor on ``device`` to (b, D) unit
    embeddings (e.g. ``lambda x: model(x)[0]`` for ``InstanceEmbedding``);
    the k most similar other clouds by cosine. (N, P, 3) -> (N, k) int64."""
    dev = resolve_device(device)
    embs = []
    with torch.no_grad():
        for start in range(0, len(partials), batch):
            x = torch.as_tensor(
                np.asarray(partials[start:start + batch], np.float32),
                device=dev)
            embs.append(apply_fn(x).float().cpu().numpy())
    e = np.concatenate(embs, 0)
    return _top_k(e @ e.T, k)


def bfs_clusters(knn_list: np.ndarray, topk: int = 6) -> list[np.ndarray]:
    """Connected components of the directed kNN graph by BFS from each
    unvisited cloud in order (the reference's bfs/getSet)."""
    n = len(knn_list)
    visited = np.zeros(n, bool)
    clusters = []
    for start in range(n):
        if visited[start]:
            continue
        queue = collections.deque([start])
        visited[start] = True
        members = []
        while queue:
            cur = queue.popleft()
            members.append(cur)
            for nb in knn_list[cur][:topk]:
                nb = int(nb)
                if not visited[nb]:
                    visited[nb] = True
                    queue.append(nb)
        clusters.append(np.asarray(members))
    return clusters


def _voxel_seed(data: np.ndarray, n_target: int = 2048,
                device: str | torch.device = "cuda") -> np.ndarray:
    """The fused cloud's seed: the grid size (binary search in [20, 100])
    whose voxel means over every member's points keep at least
    min(n_target, points) voxels, those means over the first member's
    points (the reference Dnn's search)."""
    dev = resolve_device(device)
    merged = torch.as_tensor(
        np.asarray(data, np.float32).reshape(1, -1, 3), device=dev)
    mi, mx = float(merged.min()), float(merged.max())
    need = min(n_target, merged.shape[1])

    def voxels(g):
        vp, cnt = voxelize_mean(merged, grid_size=g, min_bound=mi,
                                max_bound=mx)
        return vp[0], int(cnt[0])

    lo, hi = 20, 100
    best = None
    while lo < hi:
        mid = (lo + hi) // 2
        vp, count = voxels(mid)
        if count < need:
            lo = mid + 1
        else:
            hi = mid
            best = (vp, count)
    if best is None:
        best = voxels(hi)
    vp, count = best
    seed = np.array(data[0], np.float32, copy=True)
    take = min(count, n_target, len(seed))
    seed[:take] = vp[:take].cpu().numpy()
    return seed


def _optimize_fused(seed: torch.Tensor, members: torch.Tensor,
                    epochs: int = 10, lr: float = 1e-4) -> torch.Tensor:
    """``epochs`` Adam steps (optax's) on a free point set against every
    member: loss (0.1 cd_p + cd_t) averaged over the members (the reference
    Dnn loop)."""
    params = {"w": seed.detach().clone()}
    state = _adam_init(params)
    for _ in range(epochs):
        w = params["w"].detach().requires_grad_(True)
        cd_p, cd_t = calc_cd(w[None].expand_as(members), members)
        (grad,) = torch.autograd.grad((cd_p * 0.1 + cd_t).mean(), [w])
        params = _adam_update({"w": w.detach()}, {"w": grad}, state, lr)
    return params["w"]


def fuse_cluster(data: np.ndarray, gt: np.ndarray | None = None,
                 epochs: int = 10, device: str | torch.device = "cuda"):
    """The fused cloud of one cluster (the reference Dnn): data (M, P, 3)
    members -> (fused (P, 3), metrics); with ``gt`` (M, P', 3) the metrics
    hold the fused cloud's mean cd_t and f1 against it, else none."""
    dev = resolve_device(device)
    seed = torch.as_tensor(_voxel_seed(data, device=dev), device=dev)
    members = torch.as_tensor(np.asarray(data, np.float32), device=dev)
    fused = _optimize_fused(seed, members, epochs)
    metrics = {}
    if gt is not None:
        g = torch.as_tensor(np.asarray(gt, np.float32), device=dev)
        with torch.no_grad():
            _, cd_t, f1 = calc_cd(fused[None].expand(len(g), *fused.shape),
                                  g, calc_f1=True)
        metrics = {"cd_t": float(cd_t.mean()), "f1": float(f1.mean())}
    return fused.cpu().numpy(), metrics


def combine_dataset(partials: np.ndarray, labels: np.ndarray, k: int = 6,
                    epochs: int = 10, mode: str = "f1", embed_fn=None,
                    device: str | torch.device = "cuda",
                    stages: dict | None = None):
    """The pipeline per class: kNN graph, clusters, one fused cloud per
    cluster given to each member (the reference's solve_knn and
    combineDataset). Returns (knn (N, k) int64, fused (N, P, 3) f32,
    cluster_id (N,) int64). ``mode`` 'f1' builds the graph from all-pairs
    chamfer F1, 'embedding' from ``embed_fn`` (see ``embedding_knn``).
    ``stages``, if given, receives the seconds of each stage ('knn',
    'clusters', 'fuse')."""
    if mode not in ("f1", "embedding"):
        raise ValueError(f"mode is 'f1' or 'embedding', got {mode!r}")
    if mode == "embedding" and embed_fn is None:
        raise ValueError("mode='embedding' needs embed_fn")
    dev = resolve_device(device)
    n = len(partials)
    knn_all = np.zeros((n, k), np.int64)
    fused_all = np.array(partials, np.float32, copy=True)
    cluster_id = np.full(n, -1, np.int64)
    seconds = dict.fromkeys(("knn", "clusters", "fuse"), 0.0)
    next_cluster = 0
    for cls in np.unique(labels):
        idx = np.nonzero(labels == cls)[0]
        if len(idx) < 2:
            cluster_id[idx] = next_cluster
            next_cluster += 1
            continue
        t = time.perf_counter()
        kk = min(k, len(idx) - 1)
        if mode == "embedding":
            knn = embedding_knn(partials[idx], embed_fn, k=kk, device=dev)
        else:
            knn = pairwise_f1_knn(partials[idx], k=kk, device=dev)
        pad = k - knn.shape[1]
        if pad:
            knn = np.concatenate([knn, np.repeat(knn[:, :1], pad, 1)], 1)
        knn_all[idx] = idx[knn]
        seconds["knn"] += time.perf_counter() - t
        t = time.perf_counter()
        clusters = bfs_clusters(knn)
        seconds["clusters"] += time.perf_counter() - t
        t = time.perf_counter()
        for members in clusters:
            rows = idx[members]
            fused_all[rows] = fuse_cluster(partials[rows], None, epochs,
                                           device=dev)[0]
            cluster_id[rows] = next_cluster
            next_cluster += 1
        seconds["fuse"] += time.perf_counter() - t
    if stages is not None:
        stages.update(seconds)
    return knn_all, fused_all, cluster_id
