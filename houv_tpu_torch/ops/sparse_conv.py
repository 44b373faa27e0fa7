"""Sparse 3D convolution on fixed-capacity voxel lists (counterpart of
``houv_tpu/ops/sparse_conv.py``, its lookup-grid form).

Voxels live in a list of fixed capacity V with a validity mask; the
neighbours of a site are found through a dense (B, G³) lookup grid of row
indices, one gather for all kernel offsets, and each conv is one
(B·V, K·Cin) × (K·Cin, Cout) product. Row-order invariant, as in the JAX
package: both constructors (``from_point_voxels``, ``downsample_sites``)
emit the valid rows ascending in x-major flat id, the masked tail last.

- ``subm_conv``: submanifold conv (output sites = input sites),
  spconv.SubMConv3d with factorised kernels ((1,3,3), (3,1,3), ...).
- ``sparse_conv_down``: strided conv, kernel 3, padding 1, with the exact
  spconv output-site rule (``downsample_sites``), which also counts the
  sites it drops beyond the list's capacity.
- ``to_dense``: the list scattered into a (B, G, G, G, C) volume, where
  the hybrid encoder's dense levels take over.

With ``compute_dtype='bfloat16'`` the conv rounds both operands of its
product to bf16 and multiplies them in f32 (a bf16 × bf16 product is exact
in f32), as the JAX package's ``preferred_element_type=f32`` contraction
does; callers keep TF32 off. The JAX package's one-hot match, banded and
scatter-match forms exist for the TPU's matrix unit and are not carried
over.
"""

from __future__ import annotations

import dataclasses
import itertools

import torch


@dataclasses.dataclass
class SparseGrid:
    """Fixed-capacity sparse voxel tensor (the SparseConvTensor analogue).

    features (B, V, C) float; coords (B, V, 3) int64 in [0, grid_size);
    mask (B, V) bool, the valid rows; grid_size the spatial extent;
    dropped (B,) int64, the sites ``downsample_sites`` found beyond the
    capacity (None for a grid made from points)."""

    features: torch.Tensor
    coords: torch.Tensor
    mask: torch.Tensor
    grid_size: int
    dropped: torch.Tensor | None = None


def kernel_offsets(kernel_size) -> list[tuple[int, int, int]]:
    """Offsets of an odd factorised kernel, centred (padding k // 2)."""
    ranges = [range(-(k // 2), k // 2 + 1) for k in kernel_size]
    return list(itertools.product(*ranges))


def _flat(coords: torch.Tensor, g: int) -> torch.Tensor:
    return (coords[..., 0] * g + coords[..., 1]) * g + coords[..., 2]


def from_point_voxels(grid_ind: torch.Tensor, point_features: torch.Tensor,
                      grid_size: int) -> SparseGrid:
    """Point voxel indices (B, N, 3) + features (B, N, C) -> the
    deduplicated SparseGrid of capacity N: a voxel's feature is the mean of
    its points' features (summed in point order on every device), its row
    the rank of its flat id among the occupied ones."""
    b, n, _ = grid_ind.shape
    c = point_features.shape[-1]
    g = grid_size
    dev = grid_ind.device
    flat = _flat(grid_ind.long(), g)                              # (B, N)
    occupied = torch.zeros((b, g ** 3), dtype=torch.bool, device=dev)
    occupied.scatter_(1, flat, True)
    rank = torch.cumsum(occupied, 1) - 1                          # (B, G³)
    dest = rank.gather(1, flat)                                   # (B, N)
    rows = (dest + torch.arange(b, device=dev)[:, None] * n).reshape(-1)
    cnt = torch.zeros(b * n, device=dev).index_add_(
        0, rows, torch.ones(b * n, device=dev))
    # A voxel's points are summed in point order, one point a voxel a pass
    # (the pass adds exact zeros everywhere else), so that the sum does not
    # hang on the order in which the card's atomic adds land: the same
    # cloud gives the same features, bit for bit.
    order = torch.argsort(rows, stable=True)
    sorted_rows = rows[order]
    pos = torch.arange(b * n, device=dev)
    first = torch.ones(b * n, dtype=torch.bool, device=dev)
    first[1:] = sorted_rows[1:] != sorted_rows[:-1]
    start = torch.cummax(torch.where(first, pos, 0), 0).values
    rank = torch.empty_like(pos)
    rank[order] = pos - start                  # the point's place in its voxel
    src = point_features.float().reshape(b * n, c)
    sums = torch.zeros((b * n, c), device=dev)
    for r in range(int(rank.max()) + 1):
        sums = sums.index_add(0, rows, torch.where((rank == r)[:, None], src,
                                                   0.0))
    feats = (sums / cnt.clamp_min(1.0)[:, None]).reshape(b, n, c)
    # every point of a voxel writes the same coordinates
    coords = torch.zeros((b, n, 3), dtype=torch.long, device=dev).scatter_(
        1, dest[..., None].expand(b, n, 3), grid_ind.long())
    count = occupied.sum(1)
    valid = torch.arange(n, device=dev)[None] < count[:, None]
    return SparseGrid(feats * valid[..., None], coords, valid, grid_size)


def build_lookup(sg: SparseGrid) -> torch.Tensor:
    """(B, G³) int32 grid: the row of the voxel at each site, -1 where
    empty. Shared by every submanifold conv at that resolution."""
    g = sg.grid_size
    b, v, _ = sg.coords.shape
    dev = sg.coords.device
    flat = torch.where(sg.mask, _flat(sg.coords, g), g ** 3)
    rows = torch.arange(v, dtype=torch.int32, device=dev).expand(b, v)
    lookup = torch.full((b, g ** 3 + 1), -1, dtype=torch.int32, device=dev)
    lookup.scatter_(1, flat, rows)            # masked rows: the last column
    return lookup[:, :g ** 3]


def _neighbor_query_flat(base_coords: torch.Tensor, base_mask: torch.Tensor,
                         offsets, grid_size: int) -> torch.Tensor:
    """Flat grid ids of every (site, offset) neighbour, (B, V, K); -1 out
    of bounds or where the site is masked."""
    g = grid_size
    off = torch.tensor(offsets, dtype=torch.long, device=base_coords.device)
    nc = base_coords[:, :, None, :] + off                     # (B, V, K, 3)
    inside = ((nc >= 0) & (nc < g)).all(-1) & base_mask[..., None]
    return torch.where(inside, _flat(nc, g), -1)


def _gather_all_neighbors(features: torch.Tensor, lookup: torch.Tensor,
                          base_coords: torch.Tensor, base_mask: torch.Tensor,
                          offsets, grid_size: int) -> torch.Tensor:
    """Neighbour features for all kernel offsets in one gather: (B, V, K,
    C), zeros where absent. ``features`` is the SOURCE list the lookup
    indexes; ``base_coords``/``base_mask`` the (maybe coarser) sites being
    convolved, in the source grid's coordinates. Source validity comes from
    the lookup (-1), site validity from ``base_mask``."""
    b, v, _ = base_coords.shape
    u, c = features.shape[1:]
    k = len(offsets)
    flat = _neighbor_query_flat(base_coords, base_mask, offsets, grid_size)
    rows = lookup.gather(1, flat.clamp_min(0).reshape(b, v * k)).reshape(
        b, v, k).long()
    valid = (flat >= 0) & (rows >= 0)
    safe = torch.where(valid, rows, 0)
    safe = safe + torch.arange(b, device=safe.device)[:, None, None] * u
    nb = features.reshape(b * u, c).index_select(0, safe.reshape(-1))
    nb = nb.reshape(b, v, k, c)
    return torch.where(valid[..., None], nb, torch.zeros((), dtype=nb.dtype,
                                                         device=nb.device))


def _round(x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """x rounded to ``compute_dtype`` (None: as it is), back in f32."""
    if compute_dtype is None:
        return x.float()
    return x.to(getattr(torch, str(compute_dtype))).float()


def _conv_contract(nb: torch.Tensor, weights: torch.Tensor,
                   compute_dtype) -> torch.Tensor:
    """(B, V, K, C) × (K, C, D) -> (B, V, D) f32: one (B·V, K·C) × (K·C, D)
    product of operands rounded to ``compute_dtype``."""
    b, v, k, c = nb.shape
    d = weights.shape[-1]
    out = _round(nb, compute_dtype).reshape(b * v, k * c) @ _round(
        weights, compute_dtype).reshape(k * c, d)
    return out.reshape(b, v, d)


def subm_conv(sg: SparseGrid, lookup: torch.Tensor, weights: torch.Tensor,
              kernel_size, compute_dtype=None) -> SparseGrid:
    """Submanifold sparse conv: output at the input sites only.
    weights (K, Cin, Cout), K = prod(kernel_size), in ``kernel_offsets``
    order."""
    offsets = kernel_offsets(kernel_size)
    if weights.shape[0] != len(offsets):
        raise ValueError(f"{weights.shape[0]} taps for kernel {kernel_size}")
    feats = sg.features * sg.mask[..., None].to(sg.features.dtype)
    if compute_dtype is not None:     # the gather moves half the bytes
        feats = feats.to(getattr(torch, str(compute_dtype)))
    nb = _gather_all_neighbors(feats, lookup, sg.coords, sg.mask, offsets,
                               sg.grid_size)
    out = _conv_contract(nb, weights, compute_dtype)
    return SparseGrid(out, sg.coords, sg.mask, sg.grid_size)


def downsample_sites(sg: SparseGrid, stride, out_capacity: int | None = None):
    """(out_coords (B, V', 3), out_mask (B, V'), out_grid_size, dropped
    (B,)): the EXACT spconv output sites of a kernel-3 / padding-1 strided
    conv, packed ascending in flat id. Output site o covers input c iff
    o·s − 1 ≤ c ≤ o·s + 1 per dim, so an input gives o ∈ {c>>1} ∪
    {c>>1 + 1 if c odd} on a stride-2 dim and o ∈ {c−1, c, c+1} on a
    stride-1 dim. V' = ``out_capacity`` or the input's V. Sites beyond V'
    are dropped highest flat id first, as in the JAX package, and counted
    in ``dropped`` (the JAX package drops them silently)."""
    g = sg.grid_size
    b, v_in, _ = sg.coords.shape
    v = out_capacity or v_in
    dev = sg.coords.device
    dims_ext = [-(-g // s) for s in stride]
    out_g = max(dims_ext)
    num = out_g ** 3
    cands = [range(2) if s == 2 else range(3) for s in stride]
    flats = []
    for combo in itertools.product(*cands):
        o_dims = []
        valid = sg.mask
        for i, e in enumerate(combo):
            ci = sg.coords[..., i]
            if stride[i] == 2:
                o = (ci >> 1) + e
                if e:        # the +1 site is reachable only from odd coords
                    valid = valid & ((ci & 1) == 1) & (o < dims_ext[i])
            else:            # stride-1 dim: kernel 3 dilates ±1
                o = ci + (e - 1)
                valid = valid & (o >= 0) & (o < dims_ext[i])
            o_dims.append(o)
        flats.append(torch.where(valid, _flat(torch.stack(o_dims, -1), out_g),
                                 num))
    flat = torch.stack(flats, -1).reshape(b, -1)
    occ = torch.zeros((b, num + 1), dtype=torch.bool, device=dev)
    occ.scatter_(1, flat, True)
    occ = occ[:, :num]
    rank = torch.cumsum(occ, 1) - 1
    count = occ.sum(1)
    idx = torch.arange(num, device=dev)
    zyx = torch.stack([idx // (out_g * out_g), (idx // out_g) % out_g,
                       idx % out_g], -1)
    # rows past the capacity, and empty sites, go to a column cut off below
    dest = torch.where(occ, rank, v).clamp_max(v)
    out_coords = torch.zeros((b, v + 1, 3), dtype=torch.long, device=dev)
    out_coords.scatter_(1, dest[..., None].expand(b, num, 3),
                        zyx.expand(b, num, 3))
    out_mask = torch.arange(v, device=dev)[None] < count[:, None]
    return out_coords[:, :v], out_mask, out_g, (count - v).clamp_min(0)


def sparse_conv_down_features(sg: SparseGrid, lookup: torch.Tensor,
                              weights: torch.Tensor, out_coords: torch.Tensor,
                              out_mask: torch.Tensor, stride,
                              compute_dtype=None) -> torch.Tensor:
    """Feature half of the strided conv: each output site gathers its 27
    taps at out·stride + offset in one pass, one product."""
    s = torch.tensor(stride, dtype=torch.long, device=out_coords.device)
    feats = sg.features
    if compute_dtype is not None:
        feats = feats.to(getattr(torch, str(compute_dtype)))
    nb = _gather_all_neighbors(feats, lookup, out_coords * s, out_mask,
                               kernel_offsets((3, 3, 3)), sg.grid_size)
    return _conv_contract(nb, weights, compute_dtype)


def sparse_conv_down(sg: SparseGrid, lookup: torch.Tensor,
                     weights: torch.Tensor, stride=(2, 2, 2),
                     compute_dtype=None,
                     out_capacity: int | None = None) -> SparseGrid:
    """Strided sparse conv (kernel 3, padding 1) to grid ceil(G / stride),
    exact spconv sites (``downsample_sites``; the grid's ``dropped``
    counts what did not fit). weights (27, Cin, Cout)."""
    out_coords, out_mask, out_g, dropped = downsample_sites(sg, stride,
                                                            out_capacity)
    feats = sparse_conv_down_features(sg, lookup, weights, out_coords,
                                      out_mask, stride, compute_dtype)
    return SparseGrid(feats, out_coords, out_mask, out_g, dropped)


def to_dense(sg: SparseGrid) -> torch.Tensor:
    """(B, G, G, G, C) f32 volume (spconv's ``SparseConvTensor.dense()``):
    each valid row's features at its site, zeros elsewhere."""
    g = sg.grid_size
    b, v, c = sg.features.shape
    flat = torch.where(sg.mask, _flat(sg.coords, g), g ** 3)
    dense = torch.zeros((b, g ** 3 + 1, c), dtype=torch.float32,
                        device=sg.features.device)
    # masked rows all land in the last column, which is cut off
    dense = dense.scatter(1, flat[..., None].expand(b, v, c),
                          sg.features.float())
    return dense[:, :g ** 3].reshape(b, g, g, g, c)


def masked_max(sg: SparseGrid) -> torch.Tensor:
    """(B, C) max over the valid voxels; 0 for a grid with none."""
    neg = torch.where(sg.mask[..., None], sg.features,
                      torch.tensor(float("-inf"), device=sg.features.device))
    out = neg.amax(1)
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))
