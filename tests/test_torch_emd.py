"""The port's auction EMD against the JAX package's, on the CPU.

The JAX side runs as its own tests run it: the XLA auction
(``emd_auction`` on the CPU) and the TPU kernel in interpret mode
(``emd_auction_pallas``). Each ends within ε per bidder of an optimal
assignment's cost, so the mean matched squared distances of any two lie
within 2ε of each other, whatever near-ties each broke its own way; the
port's plain version must also return a permutation where they do.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from houv_tpu.ops.emd import emd_auction as jemd
from houv_tpu.ops.emd_kernel import emd_auction_pallas
from houv_tpu_torch.metrics.emd import calc_emd
from houv_tpu_torch.ops import emd as temd


def _is_perm(a):
    return all(len(np.unique(row)) == len(row) for row in np.asarray(a))


@pytest.mark.parametrize("eps,iters", [(0.005, 2000), (0.002, 5000)])
def test_auction_plain_against_jax(rng, eps, iters):
    x1 = rng.uniform(-0.5, 0.5, (2, 128, 3)).astype(np.float32)
    x2 = rng.uniform(-0.5, 0.5, (2, 128, 3)).astype(np.float32)
    d, a, rounds, bids = temd.emd_auction_with_stats(
        torch.tensor(x1), torch.tensor(x2), eps, iters, device="cpu")
    assert a.dtype == torch.int64 and _is_perm(a)
    assert (rounds < iters).all() and (bids >= 128).all()
    # dist is the squared distance of the assigned pair
    matched = np.take_along_axis(x2, a.numpy()[..., None], 1)
    np.testing.assert_allclose(d.numpy(), ((x1 - matched) ** 2).sum(-1),
                               rtol=1e-6, atol=1e-9)
    jd, ja = jemd(jnp.asarray(x1), jnp.asarray(x2), eps, iters)
    pd, pa = emd_auction_pallas(jnp.asarray(x1), jnp.asarray(x2), eps,
                                iters, interpret=True)
    for ref_d, ref_a in ((jd, ja), (pd, pa)):
        assert _is_perm(ref_a)
        np.testing.assert_allclose(d.numpy().mean(-1),
                                   np.asarray(ref_d).mean(-1), atol=2 * eps)


def test_identity_permutation_gives_zero(rng):
    x = rng.uniform(-0.5, 0.5, (2, 200, 3)).astype(np.float32)
    perm = rng.permutation(200)
    d, a = temd.emd_auction(torch.tensor(x), torch.tensor(x[:, perm]),
                            0.002, 500)
    assert float(d.max()) == 0.0
    np.testing.assert_array_equal(a.numpy(),
                                  np.tile(np.argsort(perm), (2, 1)))
    assert float(calc_emd(torch.tensor(x), torch.tensor(x)).max()) == 0.0


def test_cap_hit_falls_back_to_the_nearest_item(rng):
    """Capped at one round: with all prices 0 every bidder bid on its
    nearest item, one bidder per item won it, and every other bidder falls
    back to its nearest item (ties to the smaller), not to -1 — so all
    hold their nearest item, and the items collide."""
    x1 = rng.uniform(-0.5, 0.5, (1, 64, 3)).astype(np.float32)
    x2 = rng.uniform(-0.5, 0.5, (1, 64, 3)).astype(np.float32)
    d, a, rounds, bids = temd.emd_auction_with_stats(
        torch.tensor(x1), torch.tensor(x2), 0.005, 1, device="cpu")
    assert int(rounds[0]) == 1 and int(bids[0]) == 64
    sq = ((x1[:, :, None] - x2[:, None]) ** 2).sum(-1)
    np.testing.assert_array_equal(a.numpy(), sq.argmin(-1))
    assert not _is_perm(a)
    _, ja = jemd(jnp.asarray(x1), jnp.asarray(x2), 0.005, 1)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))


def test_zero_rounds_is_the_nearest_item(rng):
    x1 = rng.uniform(-0.5, 0.5, (2, 50, 3)).astype(np.float32)
    x2 = rng.uniform(-0.5, 0.5, (2, 50, 3)).astype(np.float32)
    d, a = temd.emd_auction(torch.tensor(x1), torch.tensor(x2), 0.005, 0)
    sq = ((x1[:, :, None] - x2[:, None]) ** 2).sum(-1)
    np.testing.assert_array_equal(a.numpy(), sq.argmin(-1))
    np.testing.assert_allclose(d.numpy(), sq.min(-1), rtol=1e-6)


@pytest.mark.parametrize("n,m", [(10, 12), (48, 32)],
                         ids=["fewer_bidders", "more_bidders"])
def test_n_not_m_matches_jax(rng, n, m):
    """The auction takes clouds of different sizes (VRCNet's coarse stages
    under ``loss: emd``), as JAX's XLA path does.
    With fewer bidders than items every bidder gets an item of its own; with
    more, those left at the round cap take their nearest item."""
    x1 = rng.uniform(-0.5, 0.5, (2, n, 3)).astype(np.float32)
    x2 = rng.uniform(-0.5, 0.5, (2, m, 3)).astype(np.float32)
    dist, assignment = temd.emd_auction(torch.tensor(x1), torch.tensor(x2))
    assert dist.shape == assignment.shape == (2, n)
    assert int(assignment.min()) >= 0 and int(assignment.max()) < m
    if n < m:
        assert all(len(torch.unique(row)) == n for row in assignment)
    jd, ja = jemd(jnp.asarray(x1), jnp.asarray(x2), 0.005, 50)
    np.testing.assert_array_equal(assignment.numpy(), np.asarray(ja))
    # JAX takes its distances in the expansion form: 1e-4 relative
    np.testing.assert_allclose(dist.numpy(), np.asarray(jd), rtol=1e-4,
                               atol=1e-8)


def test_calc_emd_is_the_mean_matched_distance(rng):
    x1 = rng.uniform(-0.5, 0.5, (2, 96, 3)).astype(np.float32)
    x2 = rng.uniform(-0.5, 0.5, (2, 96, 3)).astype(np.float32)
    d, _ = temd.emd_auction(torch.tensor(x1), torch.tensor(x2), 0.004, 3000)
    np.testing.assert_allclose(
        calc_emd(torch.tensor(x1), torch.tensor(x2), 0.004, 3000).numpy(),
        np.sqrt(d.numpy()).mean(-1), rtol=1e-6)
