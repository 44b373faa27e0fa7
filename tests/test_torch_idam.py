"""The port's IDAM (``models/idam.py``) against the JAX package, on the CPU.

Size: batch 2, 96 points (16 kept a cloud, an even count: the median
gate averages the two middle weights, as ``jnp.median`` does),
``descriptor_size`` 16, three similarity iterations. A third of the target
is replaced by random points, so that the ground-truth sampling has
positives and negatives. Weights and running statistics are numpy draws
in the flax tree carried across by ``state_from_flax``; both packages
first pick the same kNN graph. Random similarity blocks would send every
kept source point to one target point, a covariance of rank 1 whose SVD
(and so the transform) any rounding turns: the similarity blocks are set
to score a pair by its closeness (plus small draws), so the matches
spread and each iteration's Procrustes problem is well posed.

JAX's Gumbel noise cannot come from a torch generator: the train step is
compared on the noise the JAX model drew (its ``_gumbel_choice``
intercepted, the noise returned beside the jitted step's outputs), handed
to the port as ``gumbel``. The port's own draw is
held to what the sampling promises: no index twice in a row, the first
half among the positives and the second among the negatives.

Tolerances: the transforms 1e-4, the loss and the running statistics
after a train step 1e-4 relative, the rotation error 1e-2 degrees.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from houv_tpu.models import idam as ji
from houv_tpu.ops.grouping import knn_points as jknn_points
from houv_tpu_torch.models import get_model
from houv_tpu_torch.models import idam as ti
from houv_tpu_torch.ops.grouping import knn_indices
from test_torch_dcp import (assert_outputs_match, assert_same_stats,
                            flax_variables, jax_apply, ported,
                            registration_pair, t)

B, N, EMB = 2, 96, 16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs one process per core."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pair(seed):
    src, tgt, t_gt = registration_pair(seed, n=N)
    rng = np.random.default_rng(seed + 100)
    tgt[:, 2 * N // 3:] = rng.uniform(-0.8, 0.8, (B, N - 2 * N // 3, 3))
    for x in (src, tgt):
        _, jidx = jknn_points(jnp.asarray(x), jnp.asarray(x), 12)
        np.testing.assert_array_equal(
            knn_indices(t(x), t(x), 12, device="cpu").numpy(),
            np.asarray(jidx))
    return src, tgt, t_gt


def _closeness_scores(v, seed):
    """The similarity blocks (``_ConvBlock_1`` to ``_6``) set to score a
    pair by 5·relu(3 − distance) through one channel, with draws of 1e-3
    on every weight."""
    rng = np.random.default_rng(seed)
    p, s = v["params"], v["batch_stats"]

    def small(a):
        return (1e-3 * rng.standard_normal(a.shape)).astype(np.float32)

    for i in range(1, 7):
        blk, st = p[f"_ConvBlock_{i}"], s[f"_ConvBlock_{i}"]
        for name, layer in blk.items():
            for leaf in layer:
                layer[leaf] = small(layer[leaf])
        blk["BatchNorm_0"]["scale"][:] = 1.0
        st["BatchNorm_0"]["var"][:] = 1.0
        st["BatchNorm_0"]["mean"][:] = 0.0
        if i <= 3:       # sim1: the distance channel in, its identity out
            blk["Dense_0"]["kernel"][2 * EMB, 0] = -1.0
            st["BatchNorm_0"]["mean"][0] = -3.0
            blk["Dense_1"]["kernel"][0, 0] = 1.0
        else:            # sim2: that channel, scaled by 5
            blk["Dense_0"]["kernel"][0, 0] = 1.0
            blk["Dense_1"]["kernel"][0, 0] = 5.0
    return v


def _idam(seed):
    src, tgt, t_gt = _pair(seed)
    jm = ji.IDAM(descriptor_size=EMB)
    v = _closeness_scores(flax_variables(jm, src, tgt, t_gt, seed=seed),
                          seed)
    tm = ported(ti.IDAM(descriptor_size=EMB), v)
    return jm, v, tm, (src, tgt, t_gt)


def test_idam_val_and_test_match_jax():
    jm, v, tm, (src, tgt, t_gt) = _idam(7)
    ref = jax_apply(jm, v, src, tgt, t_gt, prefix="val", train=False)
    with torch.no_grad():
        out = tm(t(src), t(tgt), t(t_gt), prefix="val", train=False)
        bare = tm(t(src), t(tgt), None, prefix="test")
    assert_outputs_match(out, ref)
    np.testing.assert_allclose(bare.numpy(), np.asarray(
        jax_apply(jm, v, src, tgt, None, prefix="test")), atol=1e-4)
    assert tm.flax_names["GNN_0"] == "emb_nn"
    assert [tm.flax_names[f"_ConvBlock_{i}"] for i in range(10)] == [
        "sig_fc", "sim1_0", "sim1_1", "sim1_2", "sim2_0", "sim2_1",
        "sim2_2", "weight_fc0", "weight_fc1", "weight_fc2"]


def test_idam_train_on_jax_noise_matches_jax(monkeypatch):
    """The train step on the Gumbel noise JAX drew: the loss, the
    transform and every running statistic (the GNN's and ``sig_fc``'s
    moved twice, once a cloud)."""
    jm, v, tm, (src, tgt, t_gt) = _idam(8)
    drawn = []
    real = ji._gumbel_choice

    def spy(key, logp, k):
        drawn.append(jax.random.gumbel(key, logp.shape))
        return real(key, logp, k)

    def step(variables):
        out = jm.apply(variables, src, tgt, t_gt, prefix="train", train=True,
                       mutable=["batch_stats"],
                       rngs={"sampling": jax.random.PRNGKey(3)})
        return out, tuple(drawn)

    monkeypatch.setattr(ji, "_gumbel_choice", spy)
    (ref, upd), drawn = jax.jit(step)(v)
    assert len(drawn) == 2
    with torch.no_grad():
        out = tm(t(src), t(tgt), t(t_gt), prefix="train", train=True,
                 gumbel=(t(drawn[0]), t(drawn[1])))
    assert_outputs_match(out, ref)
    assert float(out["loss"]) > 0
    assert_same_stats(tm, {"batch_stats": upd["batch_stats"]})


def test_idam_own_draw_keeps_its_promises():
    src, tgt, t_gt = _pair(9)
    tm = get_model("idam", descriptor_size=EMB)
    gen = torch.Generator().manual_seed(0)
    idx, tgt_idx, labels = tm._sample(t(src), t(tgt), t(t_gt), 16, None, gen)
    assert idx.shape == (B, 16) and tgt_idx.shape == (B, 16)
    for row in idx:
        assert len(set(row.tolist())) == 16
    # with more than 8 positives and 8 negatives a cloud, the first half
    # are positives and the second negatives
    assert labels[:, :8].eq(1).all() and labels[:, 8:].eq(0).all()
    again = tm._sample(t(src), t(tgt), t(t_gt), 16, None,
                       torch.Generator().manual_seed(0))[0]
    assert torch.equal(idx, again)
    other = tm._sample(t(src), t(tgt), t(t_gt), 16, None,
                       torch.Generator().manual_seed(1))[0]
    assert not torch.equal(idx, other)
    loss = tm(t(src), t(tgt), t(t_gt), prefix="train", train=True,
              generator=torch.Generator().manual_seed(0))["loss"]
    loss.backward()
    assert torch.isfinite(loss)


@pytest.mark.parametrize("m", [5, 6])
def test_median_and_top_k_ties_as_jax(m):
    w = torch.tensor([[0.3, 0.1, 0.7, 0.7, 0.2, 0.5][:m]])
    np.testing.assert_allclose(ti._median(w).numpy(),
                               np.asarray(jnp.median(w.numpy(), -1,
                                                     keepdims=True)))
    s = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0, 0.0][:m]])
    np.testing.assert_array_equal(ti._top_k(s, 3).numpy(),
                                  np.asarray(jax.lax.top_k(s.numpy(), 3)[1]))
