"""Rotated-box ops and PAConv scoring (counterpart of
``houv_tpu/ops/boxes.py``): the reference's vendored iou3d (rotated BEV
overlap, IoU and NMS), roiaware_pool3d's points-in-boxes and paconv's
``assign_score_withk``, which the MVP workloads do not call. Plain PyTorch
on the tensors' device. Boxes are (x, y, z, dx, dy, dz, yaw) (mmdet3d's
LiDAR convention). The BEV overlap is the exact polygon clip of
iou3d_kernel.cu: Sutherland–Hodgman with static shapes over every pair at
once, each step's at most two vertices an edge compacted in order.
"""

from __future__ import annotations

import torch

_MAXV = 16  # a quad clipped by a quad keeps at most 8 vertices


def _in_rotated_rect(px, py, boxes):
    """(..., P) points against (..., 7) boxes (broadcast): inside the BEV
    footprint."""
    cx, cy = boxes[..., 0:1], boxes[..., 1:2]
    dx, dy = boxes[..., 3:4], boxes[..., 4:5]
    yaw = boxes[..., 6:7]
    c, s = torch.cos(-yaw), torch.sin(-yaw)
    lx = (px - cx) * c - (py - cy) * s
    ly = (px - cx) * s + (py - cy) * c
    return (torch.abs(lx) <= dx / 2) & (torch.abs(ly) <= dy / 2)


def _rect_corners(box: torch.Tensor) -> torch.Tensor:
    """(P, 7) boxes -> (P, 4, 2) counter-clockwise BEV corners."""
    cx, cy, dx, dy, yaw = (box[:, i:i + 1] for i in (0, 1, 3, 4, 6))
    c, s = torch.cos(yaw), torch.sin(yaw)
    lx = box.new_tensor([0.5, -0.5, -0.5, 0.5]) * dx
    ly = box.new_tensor([0.5, 0.5, -0.5, -0.5]) * dy
    return torch.stack([cx + lx * c - ly * s, cy + lx * s + ly * c], -1)


def _next_vertices(poly: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Each polygon's vertex after each slot, cyclic over its m valid ones."""
    idx = torch.arange(_MAXV, device=poly.device)
    nxt = torch.remainder(idx[None] + 1, torch.clamp_min(m, 1)[:, None])
    return torch.gather(poly, 1, nxt[..., None].expand(-1, -1, 2))


def _clip_halfplane(poly, m, p0, p1):
    """One Sutherland–Hodgman step: (P, MAXV, 2) polygons of m valid
    counter-clockwise vertices clipped to the half-plane left of p0 -> p1
    ((P, 2) each)."""
    nxt = _next_vertices(poly, m)
    d = (p1 - p0)[:, None]

    def side(v):
        return (d[..., 0] * (v[..., 1] - p0[:, None, 1])
                - d[..., 1] * (v[..., 0] - p0[:, None, 0]))

    s_cur, s_nxt = side(poly), side(nxt)
    in_cur, in_nxt = s_cur >= 0, s_nxt >= 0
    denom = s_cur - s_nxt
    t = s_cur / torch.where(torch.abs(denom) > 1e-12, denom,
                            torch.full_like(denom, 1e-12))
    inter = poly + t[..., None] * (nxt - poly)
    active = torch.arange(_MAXV, device=poly.device)[None] < m[:, None]
    keep_cur = in_cur & active
    keep_int = (in_cur != in_nxt) & active
    # [cur_i, inter_i] interleaved, compacted in order; slots past MAXV drop
    verts = torch.stack([poly, inter], 2).reshape(-1, 2 * _MAXV, 2)
    valid = torch.stack([keep_cur, keep_int], 2).reshape(-1, 2 * _MAXV)
    dest = torch.cumsum(valid.long(), 1) - 1
    dest = torch.where(valid, dest, torch.full_like(dest, 2 * _MAXV))
    out = poly.new_zeros((poly.shape[0], 2 * _MAXV + 1, 2))
    out.scatter_(1, dest[..., None].expand(-1, -1, 2), verts)
    return out[:, :_MAXV], valid.sum(1)


def _overlap_exact(box_a: torch.Tensor, box_b: torch.Tensor) -> torch.Tensor:
    """(P, 7) × (P, 7) -> (P,) exact BEV intersection areas."""
    p = box_a.shape[0]
    poly = box_a.new_zeros((p, _MAXV, 2))
    poly[:, :4] = _rect_corners(box_a)
    m = torch.full((p,), 4, dtype=torch.long, device=box_a.device)
    cb = _rect_corners(box_b)
    for e in range(4):
        poly, m = _clip_halfplane(poly, m, cb[:, e], cb[:, (e + 1) % 4])
    nxt = _next_vertices(poly, m)
    cross = poly[..., 0] * nxt[..., 1] - poly[..., 1] * nxt[..., 0]
    active = torch.arange(_MAXV, device=poly.device)[None] < m[:, None]
    cross = torch.where(active, cross, torch.zeros_like(cross))
    area = 0.5 * torch.abs(cross.sum(1))
    return torch.where(m >= 3, area, torch.zeros_like(area))


def boxes_overlap_bev(boxes_a: torch.Tensor,
                      boxes_b: torch.Tensor) -> torch.Tensor:
    """(Na, 7) × (Nb, 7) -> (Na, Nb) exact rotated BEV overlap areas
    (iou3d_kernel.cu's ``boxes_overlap_bev_gpu``)."""
    na, nb = boxes_a.shape[0], boxes_b.shape[0]
    a = boxes_a[:, None].expand(na, nb, 7).reshape(-1, 7)
    b = boxes_b[None].expand(na, nb, 7).reshape(-1, 7)
    return _overlap_exact(a, b).reshape(na, nb)


def _iou(inter, boxes_a, boxes_b):
    area_a = boxes_a[:, 3] * boxes_a[:, 4]
    area_b = boxes_b[:, 3] * boxes_b[:, 4]
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / torch.clamp_min(union, 1e-9)


def boxes_iou_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """(Na, 7) × (Nb, 7) -> (Na, Nb) exact rotated BEV IoU."""
    return _iou(boxes_overlap_bev(boxes_a, boxes_b), boxes_a, boxes_b)


def boxes_iou_bev_sampled(boxes_a: torch.Tensor, boxes_b: torch.Tensor,
                          samples: int = 24) -> torch.Tensor:
    """(Na, 7) × (Nb, 7) -> (Na, Nb) rotated BEV IoU, the overlap estimated
    from a samples × samples grid inside each a-box."""
    u = (torch.arange(samples, dtype=boxes_a.dtype, device=boxes_a.device)
         + 0.5) / samples - 0.5
    gx, gy = torch.meshgrid(u, u, indexing="ij")
    gx, gy = gx.reshape(-1), gy.reshape(-1)
    yaw = boxes_a[:, 6:7]
    c, s = torch.cos(yaw), torch.sin(yaw)
    px = (boxes_a[:, 0:1] + gx[None] * boxes_a[:, 3:4] * c
          - gy[None] * boxes_a[:, 4:5] * s)
    py = (boxes_a[:, 1:2] + gx[None] * boxes_a[:, 3:4] * s
          + gy[None] * boxes_a[:, 4:5] * c)
    inside = _in_rotated_rect(px[:, None, :], py[:, None, :],
                              boxes_b[None, :, :])
    inter = inside.to(boxes_a.dtype).mean(-1) * (boxes_a[:, 3]
                                                 * boxes_a[:, 4])[:, None]
    return _iou(inter, boxes_a, boxes_b)


def nms_bev(boxes: torch.Tensor, scores: torch.Tensor,
            iou_threshold: float = 0.5, max_out: int = 128):
    """Greedy rotated-BEV NMS (iou3d's ``nms_gpu``): the highest-scoring
    box left (the first of equal scores) is kept and suppresses itself and
    every box above the IoU threshold with it. Returns (indices (max_out,)
    int64 padded with -1, their mask)."""
    n = boxes.shape[0]
    iou = boxes_iou_bev(boxes, boxes)
    keep = torch.full((max_out,), -1, dtype=torch.long, device=boxes.device)
    alive = torch.ones(n, dtype=torch.bool, device=boxes.device)
    neg = torch.full_like(scores, float("-inf"))
    for i in range(min(max_out, n)):
        if not bool(alive.any()):
            break
        cand = int(torch.argmax(torch.where(alive, scores, neg)))
        keep[i] = cand
        suppress = iou[cand] > iou_threshold
        suppress[cand] = True
        alive &= ~suppress
    return keep, keep >= 0


def points_in_boxes(points: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) × (B, K, 7) -> (B, N) int64: the first box that holds the
    point, -1 where none does (roiaware_pool3d's points_in_boxes)."""
    px = points[:, :, None, 0:1]
    py = points[:, :, None, 1:2]
    pz = points[..., 2][:, :, None]
    in_bev = _in_rotated_rect(px, py, boxes[:, None, :, :])[..., 0]
    cz, dz = boxes[..., 2], boxes[..., 5]
    in_z = torch.abs(pz - cz[:, None, :]) <= dz[:, None, :] / 2
    inside = in_bev & in_z
    first = torch.argmax(inside.to(torch.uint8), -1)
    return torch.where(inside.any(-1), first, torch.full_like(first, -1))


def assign_score_withk(scores: torch.Tensor, point_feats: torch.Tensor,
                       center_feats: torch.Tensor,
                       knn_idx: torch.Tensor) -> torch.Tensor:
    """PAConv's position-adaptive aggregation: scores (B, N, K, M) kernel
    weights, point_feats (B, N', M, C), center_feats (B, N, M, C), knn_idx
    (B, N, K) -> (B, N, K, C) with out[b, n, k] = Σ_m scores[b, n, k, m] ·
    (point_feats[b, knn_idx[b, n, k], m] - center_feats[b, n, m])."""
    b, n, k = knn_idx.shape
    m, c = point_feats.shape[-2:]
    gathered = torch.gather(
        point_feats, 1,
        knn_idx.reshape(b, n * k)[..., None, None].expand(-1, -1, m, c),
    ).reshape(b, n, k, m, c)
    diff = gathered - center_feats[:, :, None]
    return torch.einsum("bnkm,bnkmc->bnkc", scores, diff)
