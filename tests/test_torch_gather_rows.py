"""The port's row-gather op against the JAX package's ``gather_rows_matmul``
(its Pallas kernel in interpret mode), on the CPU: exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from houv_tpu.ops.scatter import gather_rows_matmul
from houv_tpu_torch.ops import gather_rows, gather_rows_kernel
from houv_tpu_torch.ops import scatter as ts


@pytest.mark.parametrize("b,m,n,c", [(2, 64, 200, 3), (3, 37, 513, 8),
                                     (1, 5, 1, 1)])
def test_gather_rows_matches_the_pallas_kernel_exactly(rng, b, m, n, c):
    src = rng.standard_normal((b, m, c)).astype(np.float32)
    idx = rng.integers(0, m, (b, n))
    ref = np.asarray(gather_rows_matmul(jnp.asarray(src),
                                        jnp.asarray(idx, jnp.int32),
                                        interpret=True))
    ours = gather_rows_kernel(torch.tensor(src), torch.tensor(idx),
                              device="cpu")
    assert ours.shape == (b, n, c) and ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(), ref)
    # and it is the gather the models and the solver use
    np.testing.assert_array_equal(
        ours.numpy(), gather_rows(torch.tensor(src), torch.tensor(idx)))


def test_out_of_range_indices_give_zero_rows_as_on_the_tpu(rng):
    """An index that names no row matches no one-hot column on the TPU (its
    padding index is -1) and leaves the row 0; so here, below and above."""
    src = rng.standard_normal((2, 20, 3)).astype(np.float32)
    idx = rng.integers(-5, 25, (2, 64))
    ref = np.asarray(gather_rows_matmul(jnp.asarray(src),
                                        jnp.asarray(idx, jnp.int32),
                                        interpret=True))
    ours = gather_rows_kernel(torch.tensor(src), torch.tensor(idx),
                              device="cpu").numpy()
    np.testing.assert_array_equal(ours, ref)
    outside = (idx < 0) | (idx >= 20)
    assert outside.any() and not ours[outside].any()
    assert ours[~outside].any()


def test_gather_rows_kernel_checks_its_arguments():
    src = torch.zeros((2, 4, 3))
    with pytest.raises(ValueError, match="int64"):
        gather_rows_kernel(src, torch.zeros((2, 5), dtype=torch.int32),
                           device="cpu")
    with pytest.raises(ValueError, match="expected src"):
        gather_rows_kernel(src, torch.zeros((3, 5), dtype=torch.int64),
                           device="cpu")
    with pytest.raises(ValueError, match="device"):
        gather_rows_kernel(src, torch.zeros((2, 5), dtype=torch.int64),
                           device="meta")
    before = ts.gather_rows_kernel.launches
    out = gather_rows_kernel(src, torch.zeros((2, 0), dtype=torch.int64),
                             device="cpu")
    assert out.shape == (2, 0, 3)
    assert ts.gather_rows_kernel.launches == before


def test_many_batch_entries_of_one_channel(rng):
    """70,000 batch entries (more than a CUDA grid's 65535 in y) of one
    channel: rows by index, zero rows outside [0, M)."""
    src = rng.standard_normal((70000, 8, 1)).astype(np.float32)
    idx = rng.integers(-2, 10, (70000, 16))
    ours = gather_rows_kernel(torch.tensor(src), torch.tensor(idx),
                              device="cpu").numpy()
    ok = (idx >= 0) & (idx < 8)
    ref = np.take_along_axis(src, np.where(ok, idx, 0)[..., None], 1)
    np.testing.assert_array_equal(ours, np.where(ok[..., None], ref, 0))
