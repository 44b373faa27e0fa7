"""``compute_dtype: bfloat16`` in the port's learned registration models
(DCP, DeepGMR, IDAM) against the JAX package's bf16 models, on the CPU.

Sizes and weights as the f32 parity tests (``tests/test_torch_dcp.py``,
``test_torch_deepgmr.py``, ``test_torch_idam.py``): numpy draws in the JAX
model's flax tree, running statistics included, carried across by
``state_from_flax``. Both
packages must first pick the same kNN graph on the coordinates. IDAM
runs one similarity iteration (its test says why).

Bounds as ``test_torch_bf16_completion.py``'s: an output within 5e-3
absolute of JAX's bf16 one, where the port's f32 mode lies farther on
average; the train loss within 2e-3 relative. Where the transform cannot
show a cast (DeepGMR's mixture Procrustes and IDAM's top-k and argmax
picks turn a bf16 step into a 1e-2 turn, or another match), the held
output is an intermediate: DeepGMR's backbone logits (in a train step
too, with the running statistics, in place of its loss), IDAM's GNN
embedding. JAX is jitted with every bf16 rounding kept
(``test_torch_bf16_completion.jax_rounding``): with XLA's default, DCP's
transform lies 9.8e-3 from the port's (3.8e-3 with the roundings kept).
"""

import jax
import numpy as np
import pytest
import torch
from flax import linen as nn

from houv_tpu.models import dcp as jdcp
from houv_tpu.models import deepgmr as jd
from houv_tpu.models import idam as ji
from houv_tpu_torch.models import dcp as tdcp
from houv_tpu_torch.models import deepgmr as td
from houv_tpu_torch.models import idam as ti
from test_torch_bf16_completion import BF16, held, jax_rounding, loss_held
from test_torch_dcp import (assert_same_stats, flax_variables, ported,
                            registration_pair, t)
from test_torch_deepgmr import _same_graph
from test_torch_idam import _pair


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs one process per core."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def jax_with(jm, v, cls, *args, **kwargs):
    """``jm.apply`` (``jax_rounding``), and the first output of its ``cls``
    submodule (None for ``cls`` None)."""
    def run(variables, *arrays):
        seen = []

        def keep(next_fun, call_args, call_kwargs, ctx):
            out = next_fun(*call_args, **call_kwargs)
            if cls is not None and ctx.method_name == "__call__" \
                    and isinstance(ctx.module, cls):
                seen.append(out)
            return out

        with nn.intercept_methods(keep):
            out = jm.apply(variables, *arrays, **kwargs)
        return out, (seen[0] if seen else None)

    return jax_rounding(run, v, *args)


def port_with(tm, sub, *args, **kwargs):
    """``tm``'s output (no gradient) and the first output of its ``sub``
    module."""
    seen = []
    hook = sub.register_forward_hook(lambda m, i, o: seen.append(o))
    try:
        with torch.no_grad():
            out = tm(*args, **kwargs)
    finally:
        hook.remove()
    return out, seen[0]


def test_dcp_bf16_matches_jax_bf16_on_the_port():
    """The DGCNN (its BatchNorms included), the encoder and decoder
    LayerNorms, the attention and the feed-forward layers in bf16; the two
    final LayerNorms return f32, so the soft correspondence and the SVD
    head run in f32. The transform, and the train step's loss."""
    src, tgt, t_gt = registration_pair(3, n=64)
    _same_graph(src, 20)
    _same_graph(tgt, 20)
    jm = jdcp.DCP(emb_dims=32, compute_dtype=BF16)
    v = flax_variables(jm, src, tgt, t_gt)
    ref, _ = jax_with(jm, v, None, src, tgt, t_gt, prefix="val",
                      train=False)
    outs = {}
    for dt in (BF16, None):
        tm = ported(tdcp.DCP(emb_dims=32, compute_dtype=dt), v)
        outs[dt], emb = port_with(tm, tm.emb_nn, t(src), t(tgt), t(t_gt),
                                  prefix="val", train=False)
        assert emb.dtype == (torch.bfloat16 if dt else torch.float32)
    held(outs[BF16]["transform"], outs[None]["transform"], ref["transform"])
    (jtrain, _), _ = jax_with(jm, v, None, src, tgt, t_gt, prefix="train",
                              train=True, mutable=["batch_stats"])
    tm = ported(tdcp.DCP(emb_dims=32, compute_dtype=BF16), v)
    out = tm(t(src), t(tgt), t(t_gt), prefix="train", train=True)
    out["loss"].backward()
    loss_held(out["loss"].item(), jtrain["loss"])
    assert tm.emb_nn.bn0.running_mean.dtype == torch.float32


def test_deepgmr_bf16_matches_jax_bf16_on_the_port():
    """The backbone's two PointNets (their BatchNorms included) in bf16,
    returning f32; RRI, the mixtures and the SVD in f32. Held: the
    backbone's logits in eval mode and in a train step (the batch's
    statistics; there 5e-3 of the largest logit), and the running
    statistics that step moved (1e-3 of each tensor's largest entry). Not
    the transform or the loss: the mixture Procrustes of drawn weights
    turns the logits' bf16 steps into a transform 1e-2 apart, and a train
    loss that moves by 4e-3 between two compilations of the JAX model
    itself (its default ``jit`` and ``jax_rounding``)."""
    src, tgt, t_gt = registration_pair(4, n=64)
    _same_graph(src, 9)
    _same_graph(tgt, 9)
    jm = jd.DeepGMR(rri_size=8, compute_dtype=BF16)
    v = flax_variables(jm, src, tgt, t_gt)
    for train in (False, True):
        kw = dict(prefix="train", train=True, mutable=["batch_stats"]) \
            if train else dict(prefix="val", train=False)
        out, ref = jax_with(jm, v, jd.GMRBackbone, src, tgt, t_gt, **kw)
        logits = {}
        for dt in (BF16, None):
            tm = ported(td.DeepGMR(rri_size=8, compute_dtype=dt), v)
            _, logits[dt] = port_with(tm, tm.backbone, t(src), t(tgt),
                                      t(t_gt), **{k: w for k, w in kw.items()
                                                  if k != "mutable"})
            if train and dt:
                assert_same_stats(tm, {"batch_stats": out[1]["batch_stats"]},
                                  tol=1e-3)
        # the bound of an output at a cloud's scale, 5e-3, taken relative
        # to the largest logit: the train step's batch statistics put the
        # logits at ±3.2, where a bf16 step is 1.6e-2
        scale = max(1.0, float(np.abs(np.asarray(ref)).max()))
        held(logits[BF16], logits[None], ref, atol=5e-3 * scale)
    tm = ported(td.DeepGMR(rri_size=8, compute_dtype=BF16), v)
    loss = tm(t(src), t(tgt), t(t_gt), prefix="train", train=True)["loss"]
    loss.backward()
    assert np.isfinite(loss.item())


def test_idam_bf16_matches_jax_bf16_on_the_port(monkeypatch):
    """Every ``_ConvBlock`` (the GNN's, the significance score's and the
    similarity stacks', their BatchNorms included) in bf16, returning
    f32; one similarity iteration. Held: the GNN embedding of the source
    (the top-k and argmax picks downstream turn a bf16 step into another
    match), and the train step's loss on the Gumbel noise JAX drew
    (1.1e-3 relative; the f32 mode 5.8e-3). A second iteration starts from
    the source moved by the median-gated SVD, where one bf16 step at the
    gate moves the loss by about 3e-3 in either mode, so the model's three
    iterations would not tell the modes apart."""
    src, tgt, t_gt = _pair(7)
    jm = ji.IDAM(descriptor_size=16, num_iters=1, compute_dtype=BF16)
    v = flax_variables(jm, src, tgt, t_gt, seed=7)
    _, ref = jax_with(jm, v, ji.GNN, src, tgt, t_gt, prefix="val",
                      train=False)
    embs = {}
    for dt in (BF16, None):
        tm = ported(ti.IDAM(descriptor_size=16, num_iters=1,
                            compute_dtype=dt), v)
        _, embs[dt] = port_with(tm, tm.emb_nn, t(src), t(tgt), t(t_gt),
                                prefix="val", train=False)
    held(embs[BF16], embs[None], ref)

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
    (jtrain, _), drawn = jax_rounding(step, v)
    tm = ported(ti.IDAM(descriptor_size=16, num_iters=1,
                        compute_dtype=BF16), v)
    out = tm(t(src), t(tgt), t(t_gt), prefix="train", train=True,
             gumbel=(t(drawn[0]), t(drawn[1])))
    out["loss"].backward()
    loss_held(out["loss"].item(), jtrain["loss"])
    assert np.isfinite(out["loss"].item())
