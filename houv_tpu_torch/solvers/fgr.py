"""FPFH features and Fast Global Registration, batched.

Counterpart of ``houv_tpu/solvers/fgr.py`` (the reference's Open3D FPFH and
FGR, registration/model_utils.py:118-148, train_ICP.py:156-185), over the
whole batch of pairs at once:

- normals: the smallest eigenvector of each point's kNN covariance
  (``torch.linalg.eigh`` on the tensors' device), oriented to the origin;
- FPFH: the 33-bin descriptor, per point an SPFH (11 hard bins for each
  Darboux angle) plus the distance-weighted mean of its neighbours' SPFHs;
- correspondences: mutual nearest neighbours in the 33-dim feature space;
- the pose: graduated non-convexity over Geman-McClure weights, a
  closed-form weighted Kabsch an iteration with a shrinking ``mu``.

The coordinate searches (k 16 for the normals, k + 1 for FPFH, on each
cloud) launch the ``knn`` kernel on CUDA tensors, the two feature-space
searches the ``knn_wide`` kernel: 4 + 2 launches a batch. (The JAX package
runs the feature-space search without its Pallas kernel; the function is
the same exact k = 1 selection.)
"""

from __future__ import annotations

import math

import torch

from houv_tpu_torch._device import check_on, resolve_device
from houv_tpu_torch.geometry.kabsch import weighted_kabsch
from houv_tpu_torch.ops.gather import gather_rows
from houv_tpu_torch.ops.grouping import index_points, knn_indices


def _sq_dists(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Squared distances of each point to its neighbours ``idx`` (B, N, k),
    summed over the coordinates in order, as ``knn_points`` recomputes
    them."""
    nb = index_points(points, idx)
    d = None
    for c in range(points.shape[-1]):
        diff = points[:, :, None, c] - nb[..., c]
        d = diff * diff if d is None else d + diff * diff
    return d


# the covariances go to ``torch.linalg.eigh`` in batches of at most this
# many: cuSOLVER's batched eigensolver refuses the 32,768 of a batch of 16
# clouds of 2048 points (CUSOLVER_STATUS_INVALID_VALUE on an H100)
_EIGH_BATCH = 4096


def estimate_normals(points: torch.Tensor, k: int = 16) -> torch.Tensor:
    """(B, N, 3) -> (B, N, 3) unit normals, the smallest axis of each
    point's k-neighbour covariance, flipped to face the origin (Open3D's
    default)."""
    idx = knn_indices(points, points, k, device=points.device)
    nb = index_points(points, idx)                      # (B, N, k, 3)
    centered = nb - nb.mean(2, keepdim=True)
    cov = torch.einsum("bnkc,bnkd->bncd", centered, centered) / k
    flat = cov.reshape(-1, 3, 3)
    n = torch.cat([torch.linalg.eigh(part)[1][..., 0]   # ascending
                   for part in flat.split(_EIGH_BATCH)]).reshape(points.shape)
    flip = (n * points).sum(-1, keepdim=True) > 0
    return torch.where(flip, -n, n)


def _normalize(v: torch.Tensor) -> torch.Tensor:
    norm = torch.sqrt((v * v).sum(-1, keepdim=True))
    return v / torch.clamp_min(norm, 1e-9)


def _darboux_angles(p1, n1, p2, n2):
    """The angle features (alpha, phi, theta) of the pair (p1, n1) ->
    (p2, n2)."""
    d = _normalize(p2 - p1)
    u = n1.expand_as(d)
    v = _normalize(torch.cross(d, u, dim=-1))
    w = torch.cross(u, v, dim=-1)
    alpha = (v * n2).sum(-1)                            # in [-1, 1]
    phi = (u * d).sum(-1)                               # in [-1, 1]
    theta = torch.atan2((w * n2).sum(-1), (u * n2).sum(-1))
    return alpha, phi, theta


def _hist11(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Hard histogram: (..., k) values -> (..., 11) bin counts. The width
    divides as a tensor (a division by a Python number is a product by its
    reciprocal on the card, which moves values on bin edges)."""
    width = torch.tensor(hi - lo, dtype=x.dtype, device=x.device)
    bins = torch.clamp(((x - lo) / width * 11).to(torch.int32), 0, 10)
    return torch.nn.functional.one_hot(bins.long(), 11).float().sum(-2)


def fpfh(points: torch.Tensor, normals: torch.Tensor | None = None,
         k: int = 16, idx: torch.Tensor | None = None) -> torch.Tensor:
    """(B, N, 3) -> (B, N, 33) FPFH descriptors. ``normals`` default to
    ``estimate_normals(points, k)``; ``idx`` (B, N, k + 1), self first,
    gives the neighbours instead of the search."""
    if normals is None:
        normals = estimate_normals(points, k)
    if idx is None:
        idx = knn_indices(points, points, k + 1, device=points.device)
    idx = idx[..., 1:]                                  # drop self
    sqd = _sq_dists(points, idx)
    nb_p = index_points(points, idx)                    # (B, N, k, 3)
    nb_n = index_points(normals, idx)
    alpha, phi, theta = _darboux_angles(
        points[:, :, None], normals[:, :, None], nb_p, nb_n)
    spfh = torch.cat([_hist11(alpha, -1.0, 1.0), _hist11(phi, -1.0, 1.0),
                      _hist11(theta, -math.pi, math.pi)], dim=-1) / k
    # FPFH = SPFH + the neighbours' SPFHs weighted by 1 / distance
    nb_spfh = index_points(spfh, idx)                   # (B, N, k, 33)
    w = 1.0 / torch.clamp_min(torch.sqrt(torch.clamp_min(sqd, 0.0)), 1e-6)
    return spfh + (nb_spfh * w[..., None]).sum(2) \
        / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)


def mutual_correspondences(feat_src: torch.Tensor, feat_tgt: torch.Tensor):
    """Mutual nearest neighbours in feature space: (B, N, D) × (B, M, D)
    -> (idx_tgt (B, N) int64, mutual (B, N) bool), per source point its
    nearest target feature, flagged where that target's nearest source
    feature is the point itself."""
    i_st = knn_indices(feat_src, feat_tgt, 1, device=feat_src.device)[..., 0]
    i_ts = knn_indices(feat_tgt, feat_src, 1, device=feat_src.device)[..., 0]
    back = torch.gather(i_ts, 1, i_st)
    own = torch.arange(feat_src.shape[1], device=feat_src.device)
    return i_st, back == own[None, :]


def fgr_gnc(p: torch.Tensor, q: torch.Tensor, base_w: torch.Tensor,
            iters: int = 64, mu_init: float = 1.0, div_factor: float = 1.4,
            mu_min: float = 1e-3):
    """The graduated non-convexity loop on fixed correspondences p_i <->
    q_i (B, N, 3) with weights ``base_w`` (B, N): each iteration weighs a
    pair by (mu / (mu + r²))², solves the weighted Kabsch and divides mu by
    ``div_factor`` down to ``mu_min``. ``mu`` is an f32 scalar on the
    device. -> (R (B, 3, 3), t (B, 3))."""
    bsz, dev = p.shape[0], p.device
    r = torch.eye(3, device=dev).expand(bsz, 3, 3)
    t = torch.zeros((bsz, 3), device=dev)
    mu = torch.tensor(mu_init, dtype=torch.float32, device=dev)
    div = torch.tensor(div_factor, dtype=torch.float32, device=dev)
    floor = torch.tensor(mu_min, dtype=torch.float32, device=dev)
    for _ in range(iters):
        moved = torch.einsum("bij,bnj->bni", r, p) + t[:, None]
        res2 = ((moved - q) ** 2).sum(-1)
        w = base_w * (mu / (mu + res2)) ** 2
        r, t = weighted_kabsch(p, q, w)
        mu = torch.maximum(mu / div, floor)
    return r, t


def fgr_solve(src: torch.Tensor, tgt: torch.Tensor, iters: int = 64,
              k: int = 16, mu_init: float = 1.0, div_factor: float = 1.4,
              mu_min: float = 1e-3,
              device: str | torch.device = "cuda") -> dict:
    """Fast Global Registration of a batch of pairs on ``device``:
    (B, N, 3), (B, M, 3) -> {'transform': (B, 4, 4)}. Correspondences are
    the mutual FPFH nearest neighbours; the pose minimises the
    Geman-McClure objective by ``fgr_gnc`` (Zhou et al., ECCV 2016,
    eq. 5-7)."""
    dev = resolve_device(device)
    check_on(dev, src, tgt)
    # the rigid-transform products must run in full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    src = src.float()
    tgt = tgt.float()
    idx, mutual = mutual_correspondences(fpfh(src, k=k), fpfh(tgt, k=k))
    r, t = fgr_gnc(src, gather_rows(tgt, idx), mutual.float(), iters,
                   mu_init, div_factor, mu_min)
    bsz = src.shape[0]
    tf = torch.zeros((bsz, 4, 4), device=src.device)
    tf[:, :3, :3] = r
    tf[:, :3, 3] = t
    tf[:, 3, 3] = 1.0
    return {"transform": tf}
