"""The port's scatter-add against the JAX package's, on the CPU.

``scatter_add`` runs its plain version here (the CUDA kernel is held against
that version on the card, tests/test_torch_cuda.py and chip_smoke.py). The
JAX kernel ``scatter_add_matmul`` runs in interpret mode, as the JAX
package's own tests run it on the CPU; it rounds the values to bf16 (8
mantissa bits), so it is compared at a bf16-sized tolerance, and the
``.at[].add`` form it stands for is compared tightly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from houv_tpu.ops.scatter import scatter_add_matmul
from houv_tpu_torch.ops.scatter import _scatter_add_plain, scatter_add


def _at_add(idx, vals, m):
    """The dense form: ``zeros.at[idx].add(vals)`` per batch row, indices
    outside [0, m) dropped."""
    def one(i, v):
        return jnp.zeros((m, v.shape[-1]), jnp.float32).at[i].add(
            v, mode="drop")
    # a negative index would wrap in .at[]; send it out of range instead
    safe = jnp.where(idx < 0, m, idx)
    return np.asarray(jax.vmap(one)(safe, jnp.asarray(vals)))


def _case(rng, b, n, m, c, lo=0, hi=None):
    idx = rng.integers(lo, m if hi is None else hi, (b, n))
    vals = rng.standard_normal((b, n, c)).astype(np.float32)
    return idx, vals


@pytest.mark.parametrize("b,n,m,c", [(2, 256, 128, 3), (3, 200, 384, 3),
                                     (1, 129, 7, 8), (4, 64, 64, 1)])
def test_scatter_add_matches_jax(rng, b, n, m, c):
    idx, vals = _case(rng, b, n, m, c)
    ours = scatter_add(torch.as_tensor(idx), torch.as_tensor(vals), m,
                       device="cpu").numpy()
    assert ours.shape == (b, m, c) and ours.dtype == np.float32
    # f32 sums of at most ~10 terms in another order
    np.testing.assert_allclose(ours, _at_add(jnp.asarray(idx), vals, m),
                               rtol=1e-6, atol=1e-6)
    kernel = np.asarray(scatter_add_matmul(
        jnp.asarray(idx, jnp.int32), jnp.asarray(vals), m, interpret=True))
    # bf16 keeps 8 bits: 2^-8 relative on each term, terms of size <= ~4
    np.testing.assert_allclose(ours, kernel, rtol=2 ** -7, atol=2 ** -5)


def test_indices_out_of_range_are_dropped(rng):
    idx, vals = _case(rng, 3, 150, 40, 3, lo=-20, hi=60)
    assert (idx < 0).any() and (idx >= 40).any()
    ours = scatter_add(torch.as_tensor(idx), torch.as_tensor(vals), 40,
                       device="cpu").numpy()
    np.testing.assert_allclose(ours, _at_add(jnp.asarray(idx), vals, 40),
                               rtol=1e-6, atol=1e-6)
    kept = (idx >= 0) & (idx < 40)
    np.testing.assert_allclose(ours.sum(1), (vals * kept[..., None]).sum(1),
                               rtol=1e-4, atol=1e-4)
    # nothing in range: all zeros
    none = scatter_add(torch.full((2, 9), -1), torch.ones(2, 9, 3), 5,
                       device="cpu")
    assert not none.any()


def test_duplicates_add_in_ascending_order(rng):
    """Every index equal: the row is the sequential f32 sum in ascending i,
    bit for bit (what the kernel's owner thread computes)."""
    vals = (rng.standard_normal((2, 300, 3)) * 10 ** rng.uniform(
        -3, 3, (2, 300, 1))).astype(np.float32)
    idx = np.full((2, 300), 5)
    ours = _scatter_add_plain(torch.as_tensor(idx), torch.as_tensor(vals), 8)
    seq = np.zeros((2, 3), np.float32)
    for i in range(300):
        seq = seq + vals[:, i]
    np.testing.assert_array_equal(ours[:, 5].numpy(), seq)
    assert not ours[:, :5].any() and not ours[:, 6:].any()


def test_scatter_is_the_transpose_of_a_gather(rng):
    """<scatter(idx, v), s> == <v, gather(s, idx)> for in-range indices."""
    idx, vals = _case(rng, 2, 90, 30, 3)
    s = rng.standard_normal((2, 30, 3)).astype(np.float32)
    out = scatter_add(torch.as_tensor(idx), torch.as_tensor(vals), 30,
                      device="cpu").numpy()
    gathered = np.take_along_axis(s, idx[..., None], 1)
    np.testing.assert_allclose((out * s).sum(), (vals * gathered).sum(),
                               rtol=1e-4)


def test_shapes_and_types_are_checked():
    with pytest.raises(ValueError, match="int64"):
        scatter_add(torch.zeros(1, 4, dtype=torch.int32), torch.zeros(1, 4, 3),
                    4, device="cpu")
    with pytest.raises(ValueError, match="expected idx"):
        scatter_add(torch.zeros(1, 4, dtype=torch.int64), torch.zeros(1, 5, 3),
                    4, device="cpu")
    empty = scatter_add(torch.zeros(2, 0, dtype=torch.int64),
                        torch.zeros(2, 0, 3), 4, device="cpu")
    assert empty.shape == (2, 4, 3) and not empty.any()
