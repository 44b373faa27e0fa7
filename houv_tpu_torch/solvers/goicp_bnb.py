"""Certified branch-and-bound global registration (Go-ICP), batched.

Counterpart of ``houv_tpu/solvers/goicp_bnb.py`` (the reference's py_goicp,
registration/test_goicp.py:153-177), with the same bounds and certificate:

- Go-ICP's distance transform is a dense distance field on a G³ grid per
  target: exact node-to-cloud distances in the expansion form, chunked
  over G² nodes. For a query x and its nearest in-grid node v,
  f(v) - |x - v| bounds the true point-to-cloud distance from below and
  f(v) + |x - v| from above, inside the grid or not.
- The priority queue is a fixed frontier of K cube slots per pair,
  advanced a level at a time: every cube's bounds at once, cubes pruned
  against the incumbent, the S = K/8 best survivors kept and each split
  into 8 children, along its rotation or its translation dimensions,
  whichever gives the larger uncertainty radius.

Bounds (Go-ICP Lemmas 1-2, through the field):
  rotation radius    gamma_i = 2 sin(min(sqrt(3) sigma_r, pi) / 2) |p_i|
  translation radius tau     = sqrt(3) sigma_t
  per-point LB l_i = max(f(v_i) - |x_i - v_i| - gamma_i - tau, 0),
    x_i = R_c p_i + t_c
  cube LB = mean l_i²  <=  min over the cube of E
  cube UB = mean (f(v_i) + |x_i - v_i|)²  >=  E(centre)
E(R, t) = mean_i min_j |R p_i + t - q_j|² over an FPS subsample of the
source (``n_src`` points: one ``furthest_point_sample``, the ``fps`` kernel
on CUDA tensors) against the whole target. The returned ``gap`` always
bounds suboptimality, E* >= e - gap: its floor folds in the surviving
leaves' LBs, the LBs of cubes the frontier had to drop (``dropped_floor``)
and e - eps for pruned cubes. ``certified`` is True where the frontier
never dropped an unprunable cube (an exhaustive search, like the
reference's unbounded queue).

Every selection takes JAX's ``lax.top_k`` tie rule, the lower index first
(a stable sort of the score): at early levels every LB is 0, so ties are
real. The field, ``exact_e`` and the ICP polish are f32 products with TF32
off: a field that understated a distance would break the lower bound.
"""

from __future__ import annotations

import math

import torch

from houv_tpu_torch._device import check_on, resolve_device
from houv_tpu_torch.geometry.kabsch import fix_reflection
from houv_tpu_torch.geometry.rotations import rodrigues, rt_to_transformation
from houv_tpu_torch.ops.gather import gather_rows
from houv_tpu_torch.ops.sampling import furthest_point_sample

_SQRT3 = math.sqrt(3.0)


def _sqdist_expansion(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) × (..., M, 3) -> (..., N, M): |a|² - 2a·b + |b|², in that
    order, unclamped (the JAX package's form)."""
    return ((a * a).sum(-1)[..., :, None]
            - 2.0 * (a @ b.transpose(-1, -2))
            + (b * b).sum(-1)[..., None, :])


def build_distance_field(tgt: torch.Tensor, grid: int = 64,
                         lo: float = -1.2, hi: float = 1.2):
    """Exact node-to-cloud distance on a G³ grid per batch element:
    tgt (B, M, 3) -> (field (B, G, G, G), cell). G slabs of G² nodes each,
    the batch at once."""
    g = grid
    ax = torch.linspace(lo, hi, g, dtype=tgt.dtype, device=tgt.device)
    nodes = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), dim=-1)
    slabs = nodes.reshape(g, g * g, 3)
    field = torch.stack([
        torch.sqrt(torch.clamp_min(
            _sqdist_expansion(slab, tgt).min(-1).values, 0.0))
        for slab in slabs], dim=1)                       # (B, G, G²)
    return field.reshape(tgt.shape[0], g, g, g), (hi - lo) / (g - 1)


def _field_lookup(field: torch.Tensor, pts: torch.Tensor, lo: float,
                  cell: float):
    """The field at each point's nearest in-grid node and the exact
    distance to that node: field (B, G, G, G), pts (B, ..., 3) ->
    (f, d), each (B, ...). f - d <= dist(pt, cloud) <= f + d for any node,
    so the bounds hold for points outside [lo, hi]³ too. The cell divides
    as a tensor (on the card a division by a Python number is a product by
    its reciprocal, which moves points on rounding edges)."""
    bsz, g = field.shape[0], field.shape[-1]
    cell_t = torch.tensor(cell, dtype=pts.dtype, device=pts.device)
    idx = torch.clamp(torch.round((pts - lo) / cell_t).to(torch.int64),
                      0, g - 1)
    node = lo + idx.to(pts.dtype) * cell
    diff = pts - node
    d = torch.sqrt((diff * diff).sum(-1))
    flat = ((idx[..., 0] * g + idx[..., 1]) * g + idx[..., 2]).reshape(
        bsz, -1)
    f = torch.gather(field.reshape(bsz, -1), 1, flat).reshape(d.shape)
    return f, d


def _rotations(rot_c: torch.Tensor) -> torch.Tensor:
    """Axis-angle vectors (..., 3) -> rotations (..., 3, 3)."""
    angle = torch.sqrt((rot_c * rot_c).sum(-1))
    axis = rot_c / torch.clamp_min(angle, 1e-12)[..., None]
    return rodrigues(angle.reshape(-1), axis.reshape(-1, 3)).reshape(
        rot_c.shape + (3,))


def cube_bounds(field, cell, lo, p, p_norm, rot_c, sig_r, tr_c, sig_t,
                active):
    """(B, K) lower and upper bounds of the frontier's cubes (+inf where
    inactive) and their centre rotations (B, K, 3, 3). p (B, n, 3) the
    subsample, p_norm (B, n) its norms; rot_c, tr_c (B, K, 3) the centres,
    sig_r, sig_t (B, K) the half-widths."""
    r = _rotations(rot_c)
    moved = torch.einsum("bkij,bnj->bkni", r, p) + tr_c[:, :, None, :]
    f, node_d = _field_lookup(field, moved, lo, cell)       # (B, K, n)
    gamma = (2.0 * torch.sin(torch.clamp_max(_SQRT3 * sig_r, math.pi)
                             [..., None] / 2.0) * p_norm[:, None, :])
    tau = (_SQRT3 * sig_t)[..., None]
    lb_pt = torch.clamp_min(f - node_d - gamma - tau, 0.0)
    ub_pt = f + node_d
    lb = (lb_pt * lb_pt).mean(-1)
    ub = (ub_pt * ub_pt).mean(-1)
    inf = torch.full_like(lb, math.inf)
    return torch.where(active, lb, inf), torch.where(active, ub, inf), r


def _smallest(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest scores per row, ascending, the lower index
    first on ties (``lax.top_k`` of the negated score)."""
    return torch.sort(score, dim=1, stable=True).indices[:, :k]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` (B, S) of x (B, K, ...) -> (B, S, ...)."""
    shape = idx.shape + (1,) * (x.dim() - 2)
    return torch.gather(x, 1, idx.reshape(shape).expand(
        idx.shape + x.shape[2:]))


# the 8 children's offsets, in half-widths
_CHILD_OFFSETS = tuple((i, j, l) for i in (-0.5, 0.5) for j in (-0.5, 0.5)
                       for l in (-0.5, 0.5))


def goicp_bnb_solve(src: torch.Tensor, tgt: torch.Tensor, *,
                    trans_half: float = 0.5, eps: float = 1e-4,
                    n_src: int = 256, grid: int = 64, frontier: int = 1024,
                    levels: int = 14, icp_iters: int = 8,
                    field_lo: float = -1.5, field_hi: float = 1.5,
                    device: str | torch.device = "cuda") -> dict:
    """Certified BnB over SE(3) for B pairs at once on ``device``.

    (B, N, 3) × (B, M, 3) -> dict(transform (B, 4, 4), e (B,) the
    incumbent's objective, gap (B,) the certified suboptimality bound,
    certified (B,) bool, n_active (B,) surviving leaves, lb_trace
    (levels, B) each level's least LB). The module docstring gives the
    certificate's exact meaning."""
    dev = resolve_device(device)
    check_on(dev, src, tgt)
    # the field and the polish must run in full f32: a TF32 distance that
    # understates the true one breaks the lower bound
    torch.backends.cuda.matmul.allow_tf32 = False
    src = src.float()
    tgt = tgt.float()
    bsz = src.shape[0]
    k = frontier
    s_keep = k // 8
    n_src = min(n_src, src.shape[1])
    rows = torch.arange(bsz, device=src.device)

    # the FPS subsample defines the certified objective's source points
    p = gather_rows(src, furthest_point_sample(src, n_src,
                                               device=src.device))
    p_norm = torch.sqrt((p * p).sum(-1))                  # (B, n)
    field, cell = build_distance_field(tgt, grid, field_lo, field_hi)

    def exact_e(r, t, pts=p, cloud=tgt):
        """mean_i min_j |R p_i + t - q_j|² for each row."""
        moved = torch.einsum("bij,bnj->bni", r, pts) + t[:, None, :]
        d2 = _sqdist_expansion(moved, cloud)
        return torch.clamp_min(d2.min(-1).values, 0.0).mean(-1)

    def icp_refine(r, t, pts=p, cloud=tgt):
        """``icp_iters`` exact-NN Kabsch iterations from (r, t)."""
        pc = pts - pts.mean(1, keepdim=True)
        for _ in range(icp_iters):
            moved = torch.einsum("bij,bnj->bni", r, pts) + t[:, None, :]
            q = gather_rows(cloud, _sqdist_expansion(moved, cloud).argmin(-1))
            qc = q - q.mean(1, keepdim=True)
            h = torch.einsum("bni,bnj->bij", pc, qc)
            u, _, vt = torch.linalg.svd(h)
            r = fix_reflection(u, vt)
            t = q.mean(1) - torch.einsum("bij,bj->bi", r, pts.mean(1))
        return r, t

    # the frontier: a 4x4x4 split of the axis-angle cube [-pi, pi]³
    n0 = 4
    axc = ((torch.arange(n0, dtype=torch.float32, device=src.device) + 0.5)
           / n0 * 2.0 * math.pi - math.pi)
    rc0 = torch.stack(torch.meshgrid(axc, axc, axc, indexing="ij"),
                      -1).reshape(-1, 3)                  # (64, 3)
    rot_c = torch.zeros((bsz, k, 3), device=src.device)
    rot_c[:, :64] = rc0
    sig_r = torch.full((bsz, k), math.pi / n0, device=src.device)
    tr_c = torch.zeros((bsz, k, 3), device=src.device)
    sig_t = torch.full((bsz, k), trans_half, device=src.device)
    active = torch.zeros((bsz, k), dtype=torch.bool, device=src.device)
    active[:, :64] = True

    # the incumbent: the identity polished by ICP
    r_inc, t_inc = icp_refine(
        torch.eye(3, device=src.device).expand(bsz, 3, 3),
        torch.zeros((bsz, 3), device=src.device))
    e_inc = exact_e(r_inc, t_inc)
    overflow = torch.zeros(bsz, dtype=torch.bool, device=src.device)
    dropped_floor = torch.full((bsz,), math.inf, device=src.device)
    offsets = torch.tensor(_CHILD_OFFSETS, device=src.device)  # (8, 3)
    r_max = p_norm.max(1).values                           # (B,)
    # the polish of the 4 best-UB cube centres runs as one batch of 4B
    p4, tgt4 = p.repeat(4, 1, 1), tgt.repeat(4, 1, 1)
    lb_trace = []
    for _ in range(levels):
        lb, ub, r_all = cube_bounds(field, cell, field_lo, p, p_norm, rot_c,
                                    sig_r, tr_c, sig_t, active)
        # refresh the incumbent from the 4 best-UB centres (one can sit in
        # a wrong basin; four rarely all do), in order, keep-if-better
        bidx = _smallest(ub, 4).T.reshape(-1)              # (4B,) j-major
        brows = rows.repeat(4)
        r_ref, t_ref = icp_refine(r_all[brows, bidx], tr_c[brows, bidx],
                                  p4, tgt4)
        e_ref = exact_e(r_ref, t_ref, p4, tgt4)
        for j in range(4):
            sl = slice(j * bsz, (j + 1) * bsz)
            better = e_ref[sl] < e_inc
            r_inc = torch.where(better[:, None, None], r_ref[sl], r_inc)
            t_inc = torch.where(better[:, None], t_ref[sl], t_inc)
            e_inc = torch.minimum(e_inc, e_ref[sl])

        # prune the cubes that provably cannot beat the incumbent - eps
        active2 = active & ~(lb >= (e_inc[:, None] - eps))
        inf = torch.full_like(lb, math.inf)
        lb2 = torch.where(active2, lb, inf)
        # keep the S best survivors by LB with a UB tie-break (early levels
        # have LB 0 everywhere); an unprunable cube dropped breaks the
        # pair's certificate, and its LB joins the floor
        score = lb2 + 1e-2 * torch.where(active2, ub, inf)
        keep_idx = _smallest(score, s_keep)                # (B, S)
        kept = torch.zeros_like(active2).scatter_(1, keep_idx, True)
        dropped = active2 & ~kept
        overflow = overflow | dropped.any(1)
        dropped_floor = torch.minimum(
            dropped_floor, torch.where(dropped, lb, inf).min(1).values)

        k_rot, k_tr = _take(rot_c, keep_idx), _take(tr_c, keep_idx)
        k_sr, k_st = _take(sig_r, keep_idx), _take(sig_t, keep_idx)
        k_act = _take(active2, keep_idx) & torch.isfinite(_take(lb2,
                                                                keep_idx))

        # split the rotation dims where their radius dominates, else the
        # translation dims: 8 children a cube
        rot_radius = (2.0 * torch.sin(torch.clamp_max(_SQRT3 * k_sr, math.pi)
                                      / 2.0) * r_max[:, None])
        split_rot = (rot_radius >= _SQRT3 * k_st)[..., None]   # (B, S, 1)
        rot_child = torch.where(
            split_rot[..., None], k_rot[:, :, None] + offsets
            * k_sr[..., None, None], k_rot[:, :, None].expand(-1, -1, 8, 3))
        tr_child = torch.where(
            split_rot[..., None], k_tr[:, :, None].expand(-1, -1, 8, 3),
            k_tr[:, :, None] + offsets * k_st[..., None, None])
        sr_child = torch.where(split_rot, k_sr[..., None] * 0.5,
                               k_sr[..., None].expand(-1, -1, 8))
        st_child = torch.where(split_rot, k_st[..., None].expand(-1, -1, 8),
                               k_st[..., None] * 0.5)
        rot_c = rot_child.reshape(bsz, k, 3)
        tr_c = tr_child.reshape(bsz, k, 3)
        sig_r = sr_child.reshape(bsz, k)
        sig_t = st_child.reshape(bsz, k)
        active = k_act[..., None].expand(-1, -1, 8).reshape(bsz, k)
        lb_trace.append(lb2.min(1).values)

    # the final leaves' bounds make the certificate: the global minimum is
    # at least min(surviving LBs, dropped LBs, e - eps), since every pruned
    # cube had lb >= e - eps
    lb, _, _ = cube_bounds(field, cell, field_lo, p, p_norm, rot_c, sig_r,
                           tr_c, sig_t, active)
    floor = torch.minimum(torch.minimum(lb.min(1).values, dropped_floor),
                          e_inc - eps)
    gap = e_inc - torch.where(torch.isfinite(floor), floor, e_inc - eps)
    return {"transform": rt_to_transformation(r_inc, t_inc), "e": e_inc,
            "gap": gap, "certified": ~overflow,
            "n_active": active.sum(1), "lb_trace": torch.stack(lb_trace)}
