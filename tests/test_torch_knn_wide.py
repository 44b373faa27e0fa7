"""The port's feature-space kNN, ball query and grouping against the JAX
package, on the CPU.

The JAX side runs its wide Pallas kernel in interpret mode
(``knn_indices_pallas(..., interpret=True)``), which selects on the expansion
form |q|² - 2q·r + |r|² clamped at 0 with the index packed into the
distance's low ``idx_bits`` bits, i.e. at 2^-(23 - idx_bits) relative; the
port's plain version (the CUDA kernel's arithmetic) selects on the exact
diff form Σ (q_c - r_c)², rounded op by op. Away from near-ties both pick
the same neighbours; at one, JAX's pick lies within its key's quantum of the
exact one, so the picks' recomputed distances are held rank by rank at that
quantum (against 1e-6 where the quantum is smaller), and the indices must
agree on all but a small share of slots.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from houv_tpu.ops import grouping as jg
from houv_tpu_torch.ops import grouping as tg


def _dist64(q, r, idx):
    """f64 squared distances of the selected pairs: (B, M, k)."""
    q, r = q.astype(np.float64), r.astype(np.float64)
    nb = np.take_along_axis(r[:, None], idx[..., None], axis=2)
    return ((q[:, :, None] - nb) ** 2).sum(-1)


@pytest.mark.parametrize("c,m,n,k", [(24, 150, 260, 16), (48, 130, 130, 16),
                                     (48, 64, 64, 16), (256, 40, 96, 4)])
def test_wide_knn_matches_the_pallas_kernel(rng, c, m, n, k):
    """ECG's DenseConv widths (24 and 48 channels, k 16, the 64-point level
    included) and EFExpansion's (256 channels, k 4), ragged sizes; features
    after a ReLU, as DenseConv sees them."""
    q = np.maximum(rng.standard_normal((2, m, c)), 0).astype(np.float32)
    r = q if m == n else \
        np.maximum(rng.standard_normal((2, n, c)), 0).astype(np.float32)
    ref = np.asarray(jg.knn_indices_pallas(jnp.asarray(q), jnp.asarray(r), k,
                                           interpret=True))
    ours = tg.knn_indices(torch.tensor(q), torch.tensor(r), k,
                          device="cpu").numpy()
    assert ours.shape == ref.shape == (2, m, k)
    assert (ours == ref).mean() > 0.995
    idx_bits = int(-(-n // 128) * 128 - 1).bit_length()
    np.testing.assert_allclose(_dist64(q, r, ours), _dist64(q, r, ref),
                               rtol=max(1e-6, 2.0 ** -(23 - idx_bits)),
                               atol=1e-9)
    # the port's own pick is the exact one: a stable sort of f64 distances
    d = ((q[:, :, None].astype(np.float64) - r[:, None]) ** 2).sum(-1)
    np.testing.assert_allclose(_dist64(q, r, ours), np.sort(d, -1)[..., :k],
                               rtol=1e-6, atol=1e-9)


def test_wide_knn_contract(rng):
    """Ascending by distance, the self match first at distance exactly 0
    (what the TPU kernel needed its clamp for), exact ties to the smaller
    index, and values that are the negated diff-form distances with a
    gradient to both clouds."""
    x = rng.standard_normal((2, 60, 24)).astype(np.float32)
    x[:, 40:] = x[:, :20]                      # every row of 0..19 twice
    xt = torch.tensor(x, requires_grad=True)
    neg, idx = tg.knn_points(xt, xt, 6)
    d = _dist64(x, x, idx.numpy())
    assert (np.diff(d, axis=-1) >= -1e-5).all()
    # a duplicated row finds its smaller-index copy first, then itself
    first = idx[..., 0].numpy()
    np.testing.assert_array_equal(first[:, :40], np.broadcast_to(
        np.arange(40), (2, 40)))
    np.testing.assert_array_equal(first[:, 40:], np.broadcast_to(
        np.arange(20), (2, 20)))
    np.testing.assert_array_equal(idx[:, :20, 1].numpy(), np.broadcast_to(
        np.arange(40, 60), (2, 20)))
    assert (neg[..., 0] == 0).all()
    np.testing.assert_allclose(-neg.detach().numpy(), d, rtol=1e-5,
                               atol=1e-6)
    neg[..., 1:].sum().backward()
    assert torch.isfinite(xt.grad).all() and xt.grad.abs().sum() > 0
    # the plain version is the stable sort of the diff-form distances
    dd = ((x[:, :, None].astype(np.float64) - x[:, None]) ** 2).sum(-1)
    assert (np.sort(dd, -1)[..., :6] - d).max() < 1e-4


def test_ball_query_semantics_match_jax():
    """The cases of the JAX package's own test: in range, fewer hits than
    slots (repeat the first), no hit (zeros)."""
    xyz = np.array([[[10, 0, 0], [0.1, 0, 0], [5, 0, 0], [0, 0.2, 0],
                     [0, 0, 0.3], [0.05, 0, 0]]], np.float32)
    center = np.zeros((1, 1, 3), np.float32)
    for radius, nsample, want in ((0.5, 4, [1, 3, 4, 5]),
                                  (0.25, 4, [1, 3, 5, 1]),
                                  (0.01, 3, [0, 0, 0])):
        ours = tg.ball_query(0.0, radius, nsample, torch.tensor(xyz),
                             torch.tensor(center))
        ref = jg.ball_query(0.0, radius, nsample, jnp.asarray(xyz),
                            jnp.asarray(center))
        assert ours.dtype == torch.int64
        np.testing.assert_array_equal(ours[0, 0].numpy(), want)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("min_r,max_r", [(0.0, 0.2), (0.1, 0.35)])
def test_ball_query_and_grouping_match_jax_on_random_clouds(rng, min_r,
                                                            max_r):
    xyz = rng.uniform(-0.5, 0.5, (2, 200, 3)).astype(np.float32)
    # centres of their own: whether a cloud point's expansion-form
    # distance to itself rounds to exactly 0 (which qualifies it below
    # min_r) is a matter of each framework's product, in both packages
    centers = rng.uniform(-0.5, 0.5, (2, 24, 3)).astype(np.float32)
    feats = rng.standard_normal((2, 5, 200)).astype(np.float32)
    ours = tg.ball_query(min_r, max_r, 8, torch.tensor(xyz),
                         torch.tensor(centers))
    ref = jg.ball_query(min_r, max_r, 8, jnp.asarray(xyz),
                        jnp.asarray(centers))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    for kw in (dict(max_radius=max_r, min_radius=min_r),
               dict(max_radius=max_r, normalize_xyz=True, use_xyz=False),
               dict(max_radius=None)):
        for f in (feats, None):
            got = tg.query_and_group(
                torch.tensor(xyz), torch.tensor(centers),
                None if f is None else torch.tensor(f), nsample=8, **kw)
            want = jg.query_and_group(
                jnp.asarray(xyz), jnp.asarray(centers),
                None if f is None else jnp.asarray(f), nsample=8, **kw)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7)


# csrc/knn_wide.cu's plan and selection, modelled on the CPU: the kernel
# itself runs only on the card (tests/test_torch_cuda.py, chip_smoke.py)

@pytest.mark.parametrize("b,m,n,k,plan", [
    (32, 3072, 3072, 16, (3072, 1)),   # ECG's first DenseConv level
    (32, 1024, 1024, 16, (1024, 1)),
    (32, 256, 256, 16, (64, 4)),       # 64 blocks: the refs split in four
    (32, 64, 64, 16, (16, 4)),
    (32, 3072, 3072, 4, (3072, 1)),    # VRCNet's two EFExpansions
    (32, 2048, 2048, 4, (2048, 1)),
])
def test_wide_plan_at_the_paths_shapes(b, m, n, k, plan):
    assert tg._wide_plan(b, m, n, k) == plan


def test_wide_plan_keeps_its_parts_whole():
    """Every part non-empty, at least k refs (or all N), a multiple of 16
    refs unless it is the only one, and the grid's z within its limit."""
    for b in (1, 2, 5, 32):
        for m in (1, 5, 64, 127, 129, 256, 1999):
            for n in (1, 3, 15, 16, 17, 70, 257, 777, 100000):
                for k in (1, 4, 16, 17, 64):
                    if k > n:
                        continue
                    length, parts = tg._wide_plan(b, m, n, k)
                    assert (parts - 1) * length < n <= parts * length
                    assert length >= k
                    assert parts == 1 or length % 16 == 0
                    assert 1 <= parts <= 2 * 132
                    if b * -(-m // 128) >= 132:
                        assert parts == 1


def _insert(d, j, x, jx):
    """The kernel's sorted insertion: an equal entry stays ahead."""
    if not x < d[-1]:
        return
    t = len(d) - 1
    while t > 0 and x < d[t - 1]:
        d[t], j[t] = d[t - 1], j[t - 1]
        t -= 1
    d[t], j[t] = x, jx


def _wide_model(dist, k, length, flush_rng):
    """The kernel's selection on one query's distances (N,) f32: per part of
    ``length`` refs, 16 refs at a time tested against the list's last entry,
    hits queued (32 slots) and merged into the top-K list when the queue may
    overflow or, at random, when another lane of the warp forces a merge;
    then the parts' first-k lists merged in part order."""
    big_k = next(x for x in (4, 8, 16, 32, 64) if k <= x)
    n = len(dist)
    lists = []
    for jb in range(0, n, length):
        d, j, queue = [np.inf] * big_k, [0] * big_k, []
        je = min(n, jb + length)
        for s0 in range(jb, je, 16):
            queue += [(dist[x], x) for x in range(s0, min(s0 + 16, je))
                      if dist[x] < d[-1]]
            if len(queue) > 16 or flush_rng.random() < 0.3:
                for x, jx in queue:
                    _insert(d, j, x, jx)
                queue = []
        for x, jx in queue:
            _insert(d, j, x, jx)
        lists.append((d[:k], j[:k]))
    d, j = [np.inf] * big_k, [0] * big_k
    d[:k], j[:k] = lists[0]
    for pd, pj in lists[1:]:
        for x, jx in zip(pd, pj):
            _insert(d, j, x, jx)
    return j[:k]


@pytest.mark.parametrize("n,k,length", [(200, 16, 16), (200, 16, 64),
                                        (200, 5, 48), (200, 17, 32),
                                        (90, 33, 48), (70, 40, 200)])
def test_wide_selection_model_keeps_the_tie_rule(rng, n, k, length):
    """Exact ties everywhere (4 ReLU channels: many rows all 0, and every
    row copied to indices 33 and 130 further on, across lanes, warps and
    parts): the queued, merged and part-merged selection equals the plain
    version's stable sort index for index, whatever the merge times."""
    x = np.maximum(rng.standard_normal((1, n, 4)), 0).astype(np.float32)
    for shift in (s for s in (33, 130) if s < n):
        x[:, shift:] = np.where(rng.random((1, n - shift, 1)) < 0.5,
                                x[:, :n - shift], x[:, shift:])
    xt = torch.tensor(x)
    want = tg._knn_plain(xt[:, :40], xt, k)[0].numpy()
    dist = tg._sqdist_diff(xt[:, :40], xt)[0].numpy()
    flush_rng = np.random.default_rng(1)
    got = np.array([_wide_model(dist[i], k, length, flush_rng)
                    for i in range(40)])
    np.testing.assert_array_equal(got, want)
