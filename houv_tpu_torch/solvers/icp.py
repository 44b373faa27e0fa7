"""Batched point-to-point ICP, its random-restart form and the systematic
SO(3)-grid global ICP (the Go-ICP role).

Counterpart of ``houv_tpu/solvers/icp.py`` (the reference's per-pair Open3D
loop, registration/train_ICP.py:137-154, and the Go-ICP baseline,
test_goicp.py:153-177). Every pair of the batch iterates at once: an
iteration is one nearest-neighbour search of the moved source against the
target (``ops/chamfer.py:chamfer_indices``, the ``nn_both`` kernel on CUDA
tensors), the matched rows, inlier weights at the threshold and a weighted
Kabsch; one more search gives the inlier RMSE. So ``icp_solve`` launches
the kernel ``max_iters + 1`` times, and ``goicp_solve`` runs its 105 grid
rotations and each refinement level's 26 deltas (padded to 30) as ICPs of
``chunk`` rotations at once, a (chunk·B, N, 3) batch each:
(21 + 6·refine_levels)·(max_iters + 1) launches at the defaults.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from houv_tpu_torch._device import check_on, resolve_device
from houv_tpu_torch.geometry.kabsch import weighted_kabsch
from houv_tpu_torch.geometry.rotations import rodrigues, rt_to_transformation
from houv_tpu_torch.ops.chamfer import chamfer_indices
from houv_tpu_torch.ops.gather import gather_rows


def _nearest(moved: torch.Tensor, tgt: torch.Tensor):
    """Each moved point's nearest target point and its squared distance
    (one ``chamfer_indices`` search, the distance from the matched pair)."""
    i1, _ = chamfer_indices(moved, tgt, device=moved.device)
    matched = gather_rows(tgt, i1)
    diff = moved - matched
    return (diff * diff).sum(-1), matched


def _move(src: torch.Tensor, r: torch.Tensor, t: torch.Tensor):
    return torch.einsum("bnc,bdc->bnd", src, r) + t[:, None, :]


def icp_solve(src: torch.Tensor, tgt: torch.Tensor, *,
              threshold: float = 0.02, max_iters: int = 50,
              init_transform: torch.Tensor | None = None,
              device: str | torch.device = "cuda") -> dict:
    """(B, N, 3) × (B, M, 3) -> dict(transform (B, 4, 4), inlier_rmse (B,)).

    ``threshold``: the largest correspondence distance (Open3D's meaning:
    pairs beyond it are left out of the Kabsch update and the inlier RMSE;
    a pair with no inlier falls back to uniform weights)."""
    dev = resolve_device(device)
    check_on(dev, src, tgt)
    # the rigid-transform products must run in full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    src = src.float()
    tgt = tgt.float()
    bsz = src.shape[0]
    if init_transform is None:
        r = torch.eye(3, device=src.device).expand(bsz, 3, 3)
        t = torch.zeros((bsz, 3), device=src.device)
    else:
        r = init_transform[:, :3, :3].float()
        t = init_transform[:, :3, 3].float()
    thresh_sq = threshold * threshold
    for _ in range(max_iters):
        d1, matched = _nearest(_move(src, r, t), tgt)
        w = (d1 < thresh_sq).float()
        any_in = w.sum(1, keepdim=True) > 0
        w = torch.where(any_in, w, torch.ones_like(w))
        r, t = weighted_kabsch(src, matched, w)
    d1, _ = _nearest(_move(src, r, t), tgt)
    inlier = (d1 < thresh_sq).float()
    denom = torch.clamp_min(inlier.sum(1), 1.0)
    rmse = torch.sqrt((d1 * inlier).sum(1) / denom)
    return {"transform": rt_to_transformation(r, t), "inlier_rmse": rmse}


def _best(transforms: torch.Tensor, rmses: torch.Tensor):
    """Per pair, the run of least inlier RMSE (the first on ties):
    (R, B, 4, 4), (R, B) -> (B, 4, 4), (B,)."""
    best = rmses.argmin(0)
    cols = torch.arange(rmses.shape[1], device=rmses.device)
    return transforms[best, cols], rmses[best, cols]


def icp_solve_multistart(src: torch.Tensor, tgt: torch.Tensor,
                         generator: torch.Generator | None = None, *,
                         n_restarts: int = 8, threshold: float = 0.1,
                         max_iters: int = 50,
                         axes: torch.Tensor | None = None,
                         angles: torch.Tensor | None = None,
                         device: str | torch.device = "cuda") -> dict:
    """Random-rotation restarts, the least inlier RMSE wins. Restart 0 is
    the identity. The restarts' axes (n_restarts, B, 3) and angles
    (n_restarts, B) are drawn from ``generator`` (seed 0 when None) unless
    given."""
    bsz = src.shape[0]
    if axes is None or angles is None:
        generator = generator or torch.Generator().manual_seed(0)
        axes = torch.randn((n_restarts, bsz, 3), generator=generator)
        angles = torch.rand((n_restarts, bsz), generator=generator) \
            * (2.0 * math.pi)
    angles = angles.clone()
    angles[0] = 0.0
    axes = axes.to(src.device, torch.float32)
    angles = angles.to(src.device, torch.float32)
    transforms, rmses = [], []
    for axis, angle in zip(axes, angles):
        init = rt_to_transformation(rodrigues(angle, axis),
                                    torch.zeros((bsz, 3), device=src.device))
        out = icp_solve(src, tgt, threshold=threshold, max_iters=max_iters,
                        init_transform=init, device=device)
        transforms.append(out["transform"])
        rmses.append(out["inlier_rmse"])
    tf, rm = _best(torch.stack(transforms), torch.stack(rmses))
    return {"transform": tf, "inlier_rmse": rm}


def _lattice_axes() -> np.ndarray:
    """The 26 unit axes of the 3x3x3 integer lattice without its origin
    (the HOUV initialisation lattice), in the JAX package's order."""
    axes = np.array([(x, y, z) for x in (-1, 0, 1) for y in (-1, 0, 1)
                     for z in (-1, 0, 1) if (x, y, z) != (0, 0, 0)],
                    np.float32)
    return axes / np.linalg.norm(axes, axis=1, keepdims=True)


def so3_grid(n_axes: int = 26, angles=(45.0, 90.0, 135.0, 180.0),
             device: str | torch.device = "cpu") -> torch.Tensor:
    """A deterministic covering of SO(3): the identity, then each angle
    ring over the lattice axes -> (n_axes·len(angles) + 1, 3, 3). Any
    rotation lies within about 30° of one of them."""
    axes = torch.as_tensor(_lattice_axes()[:n_axes], device=device)
    rots = [torch.eye(3, device=device)[None]]
    for ang in angles:
        rots.append(rodrigues(torch.full((len(axes),), math.radians(ang),
                                         device=device), axes))
    return torch.cat(rots)


def _pad_chunks(rots: torch.Tensor, chunk: int) -> torch.Tensor:
    """(G, 3, 3) padded with identities to a multiple of ``chunk`` ->
    (G', 3, 3)."""
    pad = (-rots.shape[0]) % chunk
    eye = torch.eye(3, device=rots.device).expand(pad, 3, 3)
    return torch.cat([rots, eye])


def goicp_solve(src: torch.Tensor, tgt: torch.Tensor, *,
                threshold: float = 0.1, max_iters: int = 40, chunk: int = 5,
                refine_levels: int = 2,
                device: str | torch.device = "cuda") -> dict:
    """Systematic global ICP: ICP from every rotation of ``so3_grid``, the
    least inlier RMSE wins; then ``refine_levels`` levels each perturb the
    pair's incumbent rotation by 30°/2^level about the 26 lattice axes and
    keep a result only if its RMSE is lower (so every level is monotone).
    Optimality is resolution-bounded, not certified (``goicp_bnb`` is).

    (B, N, 3) × (B, M, 3) -> dict(transform (B, 4, 4), inlier_rmse (B,))."""
    dev = resolve_device(device)
    check_on(dev, src, tgt)
    bsz = src.shape[0]
    src_rep = src.float().repeat(chunk, 1, 1)
    tgt_rep = tgt.float().repeat(chunk, 1, 1)
    zeros = torch.zeros((chunk * bsz, 3), device=src.device)

    def run(inits):
        """ICP from per-run rotations (R, B, 3, 3), ``chunk`` runs a call
        -> (R, B, 4, 4), (R, B)."""
        tfs, rms = [], []
        for c in range(0, inits.shape[0], chunk):
            init = rt_to_transformation(
                inits[c:c + chunk].reshape(chunk * bsz, 3, 3), zeros)
            out = icp_solve(src_rep, tgt_rep, threshold=threshold,
                            max_iters=max_iters, init_transform=init,
                            device=device)
            tfs.append(out["transform"].reshape(chunk, bsz, 4, 4))
            rms.append(out["inlier_rmse"].reshape(chunk, bsz))
        return torch.cat(tfs), torch.cat(rms)

    grid = _pad_chunks(so3_grid(device=src.device), chunk)
    tf, rm = _best(*run(grid[:, None].expand(-1, bsz, 3, 3)))
    axes = torch.as_tensor(_lattice_axes(), device=src.device)
    for level in range(1, refine_levels + 1):
        radius = math.radians(30.0 / (2.0 ** level))
        deltas = _pad_chunks(rodrigues(
            torch.full((axes.shape[0],), radius, device=src.device), axes),
            chunk)
        r_inc = tf[:, :3, :3]
        tf2, rm2 = _best(*run(torch.einsum("dij,bjk->dbik", deltas, r_inc)))
        better = rm2 < rm
        tf = torch.where(better[:, None, None], tf2, tf)
        rm = torch.where(better, rm2, rm)
    return {"transform": tf, "inlier_rmse": rm}
