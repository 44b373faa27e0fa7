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
from houv_tpu_torch.ops import scatter as ts
from houv_tpu_torch.ops.scatter import (_scatter_add_plain, _scatter_rows,
                                        scatter_add)


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


def _sequential(idx, vals, m):
    """The contract as a loop: every row from +0.0, adding vals[b, i] in
    ascending i, in f32; indices outside [0, m) dropped."""
    out = np.zeros((vals.shape[0], m, vals.shape[2]), np.float32)
    for i in range(idx.shape[1]):
        ok = (idx[:, i] >= 0) & (idx[:, i] < m)
        b = np.nonzero(ok)[0]
        out[b, idx[b, i]] = out[b, idx[b, i]] + vals[b, i]
    return out


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def test_plain_sum_keeps_ascending_i_where_the_order_shows(rng):
    """+-1e8 and +-1 in every row: the f32 sum depends on its order; the
    plain version's equals the loop's bit for bit, the reversed loop's
    not."""
    idx = rng.integers(0, 128, (3, 2048))
    vals = (np.where(rng.random((3, 2048, 3)) < 0.5, 1e8, 1.0)
            * rng.choice([-1.0, 1.0], (3, 2048, 3))).astype(np.float32)
    ours = _scatter_add_plain(torch.as_tensor(idx), torch.as_tensor(vals),
                              128).numpy()
    np.testing.assert_array_equal(_bits(ours), _bits(_sequential(idx, vals,
                                                                 128)))
    rev = _sequential(idx[:, ::-1], vals[:, ::-1], 128)
    assert (_bits(rev) != _bits(ours)).any()


def test_negative_zero_alone_in_its_row_gives_positive_zero(rng):
    """The sum starts from +0.0, and +0.0 + -0.0 is +0.0: a kernel that
    started from the first element would keep the -0.0."""
    idx = np.stack([rng.permutation(64)[:40] for _ in range(2)])
    vals = rng.standard_normal((2, 40, 3)).astype(np.float32)
    vals[:, ::2] = -0.0
    ours = _scatter_add_plain(torch.as_tensor(idx), torch.as_tensor(vals),
                              64).numpy()
    np.testing.assert_array_equal(_bits(ours), _bits(_sequential(idx, vals,
                                                                 64)))
    single = ours[np.arange(2)[:, None], idx[:, ::2]]
    assert not single.any() and not np.signbit(single).any()


def test_one_row_receiving_all_of_4096_indices(rng):
    vals = (rng.standard_normal((2, 4096, 3))
            * 10 ** rng.uniform(-3, 3, (2, 4096, 1))).astype(np.float32)
    idx = np.full((2, 4096), 3)
    ours = _scatter_add_plain(torch.as_tensor(idx), torch.as_tensor(vals), 5)
    np.testing.assert_array_equal(_bits(ours.numpy()),
                                  _bits(_sequential(idx, vals, 5)))


def _kernel_model(idx, vals, m, rows, chunk):
    """csrc/scatter.cu step by step: per block of ``rows`` rows and chunk
    of ``chunk`` indices, items (row in the block, ``rows`` outside it)
    sorted by an LSD radix sort of 6-bit digits, each pass stable; then the
    head of each run of one row adds the run in order onto the row's sum,
    which starts from +0.0."""
    bsz, n, c = vals.shape
    out = np.zeros((bsz, m, c), np.float32)
    for b in range(bsz):
        for r0 in range(0, m, rows):
            nr = min(rows, m - r0)
            acc = np.zeros((nr, c), np.float32)
            for i0 in range(0, n, chunk):
                v = idx[b, i0:i0 + chunk]
                key = np.where((v >= r0) & (v < r0 + nr), v - r0, nr)
                place = np.arange(len(key))
                for shift in range(0, int(nr).bit_length(), 6):
                    order = np.argsort((key >> shift) & 63, kind="stable")
                    key, place = key[order], place[order]
                for r, p in zip(key, place):
                    if r < nr:
                        acc[r] = acc[r] + vals[b, i0 + p]
            out[b, r0:r0 + nr] = acc
    return out


@pytest.mark.parametrize("b,n,m,c,lo,hi,chunk", [
    (2, 300, 50, 3, -3, 53, 64),       # 2 row blocks, 5 chunks
    (3, 100, 9, 8, 4, 5, 32),          # every index one row
    (1, 257, 400, 1, -10, 410, 100),   # 5 row blocks, 2 digit passes
])
def test_the_kernels_row_blocks_and_chunks_keep_the_order(
        rng, monkeypatch, b, n, m, c, lo, hi, chunk):
    """The kernel's plan at a small budget of shared memory, so that one
    entry takes many row blocks and chunks: its algorithm equals the plain
    version bit for bit."""
    monkeypatch.setattr(ts, "_SCATTER_SUM_WORDS", 96)
    rows = _scatter_rows(m, c)
    idx = rng.integers(lo, hi, (b, n))
    vals = (rng.standard_normal((b, n, c))
            * 10 ** rng.uniform(-4, 4, (b, n, 1))).astype(np.float32)
    vals[:, ::7] = -0.0
    ours = _scatter_add_plain(torch.as_tensor(idx), torch.as_tensor(vals), m)
    np.testing.assert_array_equal(
        _bits(_kernel_model(idx, vals, m, rows, chunk)), _bits(ours.numpy()))


@pytest.mark.parametrize("m,c", [(1024, 3), (3072, 3), (2048, 3), (777, 3),
                                 (130, 8)])
def test_one_row_block_at_the_paths_shapes(m, c):
    """The train steps' chamfer backwards and the solver's scatter mode:
    one block holds all m rows, so each index is read once."""
    assert _scatter_rows(m, c) == m


@pytest.mark.parametrize("m,c,blocks", [
    (200000, 3, 49),           # rows beyond one block
    (16, 3, 1),                # one row receiving every index
    (4, 3, 1),                 # 70,000 entries of 4
    (3072, 8, 2),              # eight channels: fewer rows a block
    (1, 1, 1),
    (2**31 - 1, 1, 174763),
])
def test_plan_at_the_edges_fits_shared_memory(m, c, blocks):
    rows = _scatter_rows(m, c)
    assert -(-m // rows) == blocks
    # sums, a chunk of 2048 vals rows and items, the counts of 16 warps
    assert 4 * ((rows + 2048) * c + 2048 + 64 * 17) <= 232448
    assert rows < 2**20                 # the item's key field
