"""The port's voxel indices and sparse convolutions (``ops/voxel.py``,
``ops/sparse_conv.py``) against the JAX package, on the CPU.

Integer results are held exactly: voxel indices (points placed on cell
boundaries included), the deduplicated sites and their order, the lookup
grid, the exact spconv output sites at strides (2,2,2) and (2,2,1).
Features agree to 1e-5: the voxel means, the gathered neighbours and the
products add in another order. In bf16 mode both packages round the
operands to bf16 and accumulate in f32, so the same holds there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from houv_tpu.ops import sparse_conv as js
from houv_tpu.ops.voxel import voxel_grid_indices as j_voxel_grid_indices
from houv_tpu_torch.ops import sparse_conv as ts
from houv_tpu_torch.ops.voxel import voxel_grid_indices


def _boundary_points(g, lo, hi):
    """f32 points on, just below and just above every cell boundary, and
    outside the volume."""
    interval = (hi - lo) / (g - 1)
    i = np.arange(-1, g + 1)
    on = (np.float32(lo) + i.astype(np.float32) * np.float32(interval))
    exact = (lo + i * interval).astype(np.float32)
    pts = np.concatenate([np.nextafter(on, np.float32(-np.inf)), on,
                          np.nextafter(on, np.float32(np.inf)), exact,
                          np.float32([lo - 1.0, hi + 1.0, lo, hi])])
    return pts.astype(np.float32)


@pytest.mark.parametrize("g,lo,hi", [(50, -1.0, 1.0), (12, -1.0, 1.0),
                                     (50, -0.5, 0.5), (7, -0.5, 0.5),
                                     (25, -1.0, 1.0)])
def test_voxel_grid_indices_exact_on_cell_boundaries(rng, g, lo, hi):
    pts = _boundary_points(g, lo, hi)
    x = np.stack([pts, pts[::-1], np.roll(pts, 7)], -1)[None]
    x = np.concatenate([x, rng.uniform(lo - 0.1, hi + 0.1, (1, 300, 3))
                        .astype(np.float32)], 1)
    ref = np.asarray(j_voxel_grid_indices(jnp.asarray(x), g, lo, hi))
    ours = voxel_grid_indices(torch.tensor(x), g, lo, hi)
    assert ours.dtype == torch.int64
    np.testing.assert_array_equal(ours.numpy(), ref)
    # a multiplication by the reciprocal moves some of these points
    recip = np.clip(np.floor((np.clip(x, lo, hi) - np.float32(lo))
                             * np.float32(1.0 / ((hi - lo) / (g - 1)))),
                    0, g - 1)
    if g != 7:
        assert (recip != ref).any()


def _grid_inputs(rng, b=2, n=40, g=8, c=5):
    grid_ind = rng.integers(0, g, (b, n, 3)).astype(np.int32)
    grid_ind[:, n // 2:n // 2 + 5] = grid_ind[:, :5]    # shared voxels
    feats = rng.standard_normal((b, n, c)).astype(np.float32)
    return grid_ind, feats


def _both(grid_ind, feats, g):
    jsg = js.from_point_voxels(jnp.asarray(grid_ind), jnp.asarray(feats), g)
    tsg = ts.from_point_voxels(torch.tensor(grid_ind), torch.tensor(feats), g)
    return jsg, tsg


def _same_grid(tsg, jsg, exact_features=False):
    assert tsg.grid_size == jsg.grid_size
    np.testing.assert_array_equal(tsg.mask.numpy(), np.asarray(jsg.mask))
    np.testing.assert_array_equal(tsg.coords.numpy(), np.asarray(jsg.coords))
    ref = np.asarray(jsg.features)
    np.testing.assert_allclose(tsg.features.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * max(np.abs(ref).max(), 1.0))


@pytest.mark.parametrize("b,n,g,c", [(2, 40, 8, 5), (3, 200, 12, 5),
                                     (1, 30, 4, 2)])
def test_from_point_voxels_and_lookup_match_jax(rng, b, n, g, c):
    grid_ind, feats = _grid_inputs(rng, b, n, g, c)
    jsg, tsg = _both(grid_ind, feats, g)
    _same_grid(tsg, jsg)
    assert tsg.dropped is None
    # valid rows ascend in flat id, the masked tail last
    flat = ((tsg.coords[..., 0] * g + tsg.coords[..., 1]) * g
            + tsg.coords[..., 2])
    for r in range(b):
        valid = flat[r][tsg.mask[r]]
        assert (valid[1:] > valid[:-1]).all()
        assert tsg.mask[r][:len(valid)].all()
    np.testing.assert_array_equal(ts.build_lookup(tsg).numpy(),
                                  np.asarray(js.build_lookup(jsg)))


@pytest.mark.parametrize("kernel_size", [(1, 3, 3), (3, 1, 3), (3, 3, 3)])
@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_subm_conv_matches_jax(rng, kernel_size, compute_dtype):
    grid_ind, feats = _grid_inputs(rng, 2, 60, 8, 5)
    jsg, tsg = _both(grid_ind, feats, 8)
    k = int(np.prod(kernel_size))
    w = (rng.standard_normal((k, 5, 7)) * 0.3).astype(np.float32)
    ref = js.subm_conv(jsg, js.build_lookup(jsg), jnp.asarray(w),
                       kernel_size, compute_dtype=compute_dtype)
    out = ts.subm_conv(tsg, ts.build_lookup(tsg), torch.tensor(w),
                       kernel_size, compute_dtype=compute_dtype)
    _same_grid(out, ref)
    assert not out.features[~out.mask].any()


@pytest.mark.parametrize("stride", [(2, 2, 2), (2, 2, 1)])
@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_sparse_conv_down_matches_jax(rng, stride, compute_dtype):
    grid_ind, feats = _grid_inputs(rng, 2, 25, 8, 4)
    jsg, tsg = _both(grid_ind, feats, 8)
    w = (rng.standard_normal((27, 4, 6)) * 0.3).astype(np.float32)
    # the dilation can outgrow 25 input rows: room for every exact site
    ref = js.sparse_conv_down(jsg, js.build_lookup(jsg), jnp.asarray(w),
                              stride, compute_dtype=compute_dtype,
                              out_capacity=192)
    out = ts.sparse_conv_down(tsg, ts.build_lookup(tsg), torch.tensor(w),
                              stride, compute_dtype=compute_dtype,
                              out_capacity=192)
    _same_grid(out, ref)
    assert out.grid_size == (4 if stride[2] == 2 else 8)
    assert not out.dropped.any() and out.mask.any()


def test_downsample_sites_counts_what_it_drops(rng):
    """Beyond the capacity the highest flat ids go, as in the JAX package,
    and the port counts them: the kept rows are JAX's rows, and the count
    is the exact site count less the capacity."""
    grid_ind, feats = _grid_inputs(rng, 2, 30, 8, 4)
    jsg, tsg = _both(grid_ind, feats, 8)
    _, full_mask, _, none = ts.downsample_sites(tsg, (2, 2, 2),
                                                out_capacity=128)
    assert not none.any()
    n_sites = full_mask.sum(1)
    cap = 16
    assert (n_sites > cap).all()
    coords, mask, out_g, dropped = ts.downsample_sites(tsg, (2, 2, 2),
                                                       out_capacity=cap)
    j_coords, j_mask, j_g = js.downsample_sites(jsg, (2, 2, 2),
                                                out_capacity=cap)
    assert out_g == j_g == 4
    np.testing.assert_array_equal(coords.numpy(), np.asarray(j_coords))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))
    np.testing.assert_array_equal(dropped.numpy(), (n_sites - cap).numpy())
    # at the input's own capacity (the default) these 30 rows still fit
    *_, dropped = ts.downsample_sites(tsg, (2, 2, 2))
    np.testing.assert_array_equal(dropped.numpy(),
                                  (n_sites - 30).clamp_min(0).numpy())


def test_masked_max_matches_jax_and_ignores_padding(rng):
    grid_ind, feats = _grid_inputs(rng, 3, 20, 6, 3)
    jsg, tsg = _both(grid_ind, feats, 6)
    poisoned = tsg.features.clone()
    poisoned[~tsg.mask] = 1e9
    out = ts.masked_max(ts.SparseGrid(poisoned, tsg.coords, tsg.mask, 6))
    np.testing.assert_allclose(out.numpy(), np.asarray(js.masked_max(jsg)),
                               rtol=1e-6)
    empty = ts.SparseGrid(poisoned, tsg.coords, torch.zeros_like(tsg.mask), 6)
    assert not ts.masked_max(empty).any()
