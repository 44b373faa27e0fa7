"""``compute_dtype: bfloat16`` in the port's shared blocks
(``models/common.py``: ``BatchNorm``, ``LayerNorm``, ``MultiHeadAttention``
with its bf16 softmax, ``EFExpansion``; ECG's ``DenseConv``) and in the
transformer, the instance embedding and VoxAsym, against the JAX package
and flax on the CPU.

The normalisations: flax 0.12.3 reduces and normalises in f32 on the bf16
input and rounds the result to bf16 (its ``force_float32_reductions``);
the port's equals flax's bit for bit, in train and eval mode, running
statistics included, and its statistics over a process group are f32
sums. The attention: ``jax.nn.softmax`` rounds exp(x − max) to bf16 before
the sum divides it, where ``torch.softmax`` rounds once; the port's rounds
as JAX's and agrees with it in all but a few entries. ``DenseConv`` and
``EFExpansion`` pick their neighbours on their bf16 input cast to f32:
JAX's picks and the port's agree on all but 2% of the slots (JAX's CPU
kNN is the expansion form) and the outputs are held on equal picks.
Models: bounds as ``test_torch_bf16_completion.py``'s (5e-3 absolute on
an output, where the f32 mode lies farther on average; 2e-3 relative on
the train loss). JAX runs jitted with every bf16 rounding kept
(``jax_rounding``; with XLA's default, a fusion computes its bf16 stretch
in f32 and picks on unrounded values).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from houv_tpu.models import common as jc
from houv_tpu.models import ecg as je
from houv_tpu.models import get_model as jget_model
from houv_tpu.models.alignment import VoxAsym as JVoxAsym
from houv_tpu.models.embedding import InstanceEmbedding as JEmbedding
from houv_tpu.ops import grouping as jg
from houv_tpu.train.config import Config as JConfig
from houv_tpu_torch.models import common as tc
from houv_tpu_torch.models import ecg as te
from houv_tpu_torch.models import get_model
from houv_tpu_torch.models.alignment import VoxAsym
from houv_tpu_torch.models.embedding import InstanceEmbedding
from houv_tpu_torch.ops import grouping as tg
from houv_tpu_torch.train import cli as tcli
from houv_tpu_torch.train import config as tconfig
from test_torch_aux_trainers import (SMALL, TRAINERS, _carry, _jax_variables,
                                     _raw, _view_batch)
from test_torch_bf16_completion import BF16, held, jax_rounding, loss_held
from test_torch_dcp import flax_variables, ported, t
from test_torch_transformer import _clouds, _same_fps

BF = jnp.bfloat16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs one process per core."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _bits(x):
    """A tensor or array's values as f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("train", [False, True])
def test_batch_norm_bf16_is_flax_on_the_port(rng, train):
    """flax ``BatchNorm(dtype=bf16)`` on a bf16 input: the output bit for
    bit, in bf16; in train mode the running statistics (f32) too."""
    x = (3 + 2 * rng.standard_normal((4, 50, 24))).astype(np.float32)
    jm = nn.BatchNorm(use_running_average=not train, dtype=BF)
    v = flax_variables(jm, x)
    xb = jnp.asarray(x, BF)
    if train:
        ref, upd = jax_rounding(
            lambda vv, a: jm.apply(vv, a, mutable=["batch_stats"]), v, xb)
    else:
        ref = jax_rounding(jm.apply, v, xb)
    tm = ported(tc.BatchNorm(24, compute_dtype=BF16), v)
    out = tm(t(x).bfloat16(), train)
    assert out.dtype == torch.bfloat16 and ref.dtype == BF
    np.testing.assert_array_equal(_bits(out), _bits(ref))
    assert tm.running_mean.dtype == tm.running_var.dtype == torch.float32
    if train:
        np.testing.assert_allclose(tm.running_mean.numpy(),
                                   upd["batch_stats"]["mean"], rtol=1e-6)
        np.testing.assert_allclose(tm.running_var.numpy(),
                                   upd["batch_stats"]["var"], rtol=1e-6)


def test_batch_norm_bf16_sums_over_a_group_in_f32_on_the_port(
        rng, monkeypatch):
    """Over a process group (data-parallel training) a bf16 BatchNorm
    all-reduces f32 sums: here a group of one rank, its all-reduce the
    identity, gives the statistics of no group."""
    x = (3 + 2 * rng.standard_normal((4, 50, 24))).astype(np.float32)
    seen = []

    def all_reduce(tensor, group=None):
        seen.append(tensor.dtype)
        return tensor

    monkeypatch.setattr(tc.dist_nn, "all_reduce", all_reduce)
    alone, grouped = (tc.BatchNorm(24, compute_dtype=BF16) for _ in range(2))
    grouped.batch_group = "one rank"
    a, g = (bn(t(x).bfloat16(), True) for bn in (alone, grouped))
    assert seen == [torch.float32]
    torch.testing.assert_close(g, a, rtol=0, atol=0)
    torch.testing.assert_close(grouped.running_var, alone.running_var,
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", [BF16, None])
def test_layer_norm_on_bf16_input_is_flax_on_the_port(rng, dtype):
    """flax ``LayerNorm(dtype=bf16)``: bf16 out, bit for bit; without a
    dtype (DCP's final norms) a bf16 input gives f32, as flax's does."""
    x = (1 + 3 * rng.standard_normal((2, 40, 32))).astype(np.float32)
    jm = nn.LayerNorm(epsilon=1e-6, dtype=BF if dtype else None)
    v = flax_variables(jm, x)
    ref = jax_rounding(jm.apply, v, jnp.asarray(x, BF))
    out = ported(tc.LayerNorm(32, compute_dtype=dtype), v)(t(x).bfloat16())
    assert out.dtype == (torch.bfloat16 if dtype else torch.float32)
    assert ref.dtype == (BF if dtype else jnp.float32)
    if dtype:
        np.testing.assert_array_equal(_bits(out), _bits(ref))
    else:    # f32 sums in another order
        np.testing.assert_allclose(_bits(out), _bits(ref), rtol=0, atol=1e-6)


def test_multi_head_attention_bf16_softmax_is_jax_on_the_port(rng):
    """The attention in bf16: the port's softmax rounds where
    ``jax.nn.softmax`` does, so the output equals JAX's in all but a few
    entries (each a bf16 step of a sum's order apart); ``torch.softmax``
    on the same scores differs from JAX's in most."""
    x = rng.standard_normal((2, 96, 64)).astype(np.float32)
    m = rng.standard_normal((2, 128, 64)).astype(np.float32)
    jm = jc.MultiHeadAttention(4, 64, BF)
    v = flax_variables(jm, x, m, m)
    ref = jax_rounding(jm.apply, v, jnp.asarray(x, BF), m, m)
    outs = {}
    for dt in (BF16, None):
        tm = ported(tc.MultiHeadAttention(4, 64, dt), v)
        with torch.no_grad():
            outs[dt] = tm(t(x).bfloat16() if dt else t(x), t(m), t(m))
    assert outs[BF16].dtype == torch.bfloat16 and ref.dtype == BF
    same = (_bits(outs[BF16]) == _bits(ref)).mean()
    assert same >= 0.99, same
    held(_bits(outs[BF16]), _bits(outs[None]), ref)
    s = jnp.asarray(rng.standard_normal((4, 8, 128)), BF)
    own = tc.softmax(t(s.astype(jnp.float32)).bfloat16(), -1)
    jax_p = jax_rounding(lambda a: jax.nn.softmax(a, -1), s)
    assert (_bits(own) == _bits(jax_p)).mean() >= 0.99
    once = torch.softmax(t(s.astype(jnp.float32)).bfloat16(), -1)
    assert (_bits(once) == _bits(jax_p)).mean() < 0.9


def _feature_picks(x, k):
    """JAX's kNN picks (on its expansion form) and the port's, on the bf16
    values of ``x`` cast to f32, and their agreement."""
    xf = np.asarray(jnp.asarray(x, BF).astype(jnp.float32))
    ref = np.asarray(jg.knn_points(jnp.asarray(xf), jnp.asarray(xf), k)[1])
    ours = tg.knn_indices(t(xf), t(xf), k, device="cpu").numpy()
    return ref, (ours == ref).mean()


@pytest.mark.parametrize("block", ["dense_conv", "ef_expansion"])
def test_feature_graph_blocks_pick_on_bf16_values_on_the_port(
        rng, monkeypatch, block):
    """ECG's ``DenseConv`` (48 channels, k 16) and ``EFExpansion`` (256 ->
    64 at ratio 2, k 4) in bf16 on a bf16 input: each picks its
    neighbours on that input cast to f32 (JAX's picks and the port's agree
    on 98% of the slots), and on JAX's picks their outputs are held."""
    c, k = (48, 16) if block == "dense_conv" else (256, 4)
    x = np.maximum(rng.standard_normal((2, 80, c)), 0).astype(np.float32)
    idx, agree = _feature_picks(x, k)
    assert agree >= 0.98, agree
    given = []
    monkeypatch.setattr(jc, "knn_points", lambda q, r, kk, use_pallas=None:
                        (None, jnp.asarray(idx)))

    def port_pick(q, r, kk, device=None):
        given.append(q.dtype)
        return torch.as_tensor(idx.copy()).long()

    monkeypatch.setattr(tc, "knn_indices", port_pick)
    if block == "dense_conv":
        jm, make = je.DenseConv(24, 3, k, BF), \
            lambda dt: te.DenseConv(c, 24, 3, k, dt)
    else:
        jm, make = jc.EFExpansion(c, 64, 2, k, BF), \
            lambda dt: tc.EFExpansion(c, 64, 2, k, dt)
    xb = jnp.asarray(x, BF)
    v = flax_variables(jm, xb)
    ref = jax_rounding(jm.apply, v, xb)
    outs = {}
    for dt in (BF16, None):
        with torch.no_grad():
            outs[dt] = ported(make(dt), v)(t(x).bfloat16() if dt else t(x))
    assert given[0] == torch.float32 and outs[BF16].dtype == torch.float32
    held(outs[BF16], outs[None], ref)


def test_transformer_bf16_matches_jax_bf16_on_the_port():
    """128 points, 64 latent points (d 256, two blocks): the point MLP,
    LayerNorms, attention (its softmax rounded as ``jax.nn.softmax``
    rounds), feed-forward layers and head in bf16, each block's residual
    added in f32. The head's kernel and bias drawn at a
    quarter of their scale, so that the cloud lies at a completion's scale
    (|x| < 1, where a bf16 step is at most 3.9e-3)."""
    x, gt = _clouds(4, 2, 128)
    _same_fps(x, 64)
    jm = jget_model("transformer", num_points=128, num_latent=64,
                    compute_dtype=BF16)
    v = flax_variables(jm, x, gt, seed=1)
    head = v["params"]["TransformerRegressor_0"]["Dense_4"]   # (128, 3)
    head["kernel"], head["bias"] = head["kernel"] / 4, head["bias"] / 4
    ref = jax_rounding(lambda vv, a: jm.apply(vv, a, None, "test"), v,
                       x)["result"]
    jloss = jax_rounding(lambda vv, a, b: jm.apply(vv, a, b, "train"), v, x,
                         gt)["total_loss"]
    assert np.abs(np.asarray(ref)).max() < 1.0
    outs = {}
    for dt in (BF16, None):
        tm = ported(get_model("transformer", num_points=128, num_latent=64,
                              compute_dtype=dt), v)
        with torch.no_grad():
            outs[dt] = tm(t(x), None, "test")["result"]
    tm = ported(get_model("transformer", num_points=128, num_latent=64,
                          compute_dtype=BF16), v)
    loss = tm(t(x), t(gt), "train")["total_loss"]
    loss.backward()
    held(outs[BF16], outs[None], ref)
    loss_held(loss.item(), jloss)


def test_instance_embedding_bf16_matches_jax_bf16_on_the_port(tmp_path):
    """``embedding.yaml`` at its CPU size in bf16 (its point MLP and hidden
    Dense layers; the embedding and logits heads f32): the trainer's loss
    (triplet + cross-entropy over three clouds) against the JAX trainer's
    ``_make_loss_fn``; and with the attention variant, the anchor's
    logits."""
    name = "embedding.yaml"
    raw = _raw(name, tmp_path, **SMALL[name], compute_dtype=BF16)
    ours = tcli.make_trainer(tconfig.Config.from_dict(raw), "cpu")
    ours.init_state()
    ref = TRAINERS[name][1](JConfig.from_dict(raw))
    assert ours.model.mlp.fc0.weight.dtype == torch.float32
    batch = _view_batch(ours, "train", 4, seed=1)
    v = _jax_variables(ref, batch)
    _carry(ours, v)
    jloss, _ = jax_rounding(lambda p: ref._make_loss_fn(False)(
        p, {}, batch, 0.0, {}), v["params"])
    loss = ours._train_loss(batch, 0, 0)
    loss.backward()
    loss_held(loss.item(), jloss)
    jm = JEmbedding(use_attention=True, compute_dtype=BF16)
    v = flax_variables(jm, batch["anchor"], seed=2)
    _, jlogits = jax_rounding(jm.apply, v, batch["anchor"])
    logits = {}
    for dt in (BF16, None):
        tm = ported(InstanceEmbedding(use_attention=True, compute_dtype=dt),
                    v)
        with torch.no_grad():
            emb, logits[dt] = tm(t(batch["anchor"]))
        assert emb.dtype == torch.float32
    held(logits[BF16], logits[None], jlogits)


def test_vox_asym_bf16_matches_jax_bf16_on_the_port(tmp_path):
    """``spconv.yaml`` at its CPU size in bf16 (the point MLP and the
    context block's convs; the head and the softmax f32): the trainer's
    loss against the JAX trainer's ``_make_loss_fn`` (its BatchNorms in
    train mode), and the occupancy probabilities in eval mode."""
    name = "spconv.yaml"
    raw = _raw(name, tmp_path, **SMALL[name], compute_dtype=BF16)
    ours = tcli.make_trainer(tconfig.Config.from_dict(raw), "cpu")
    ours.init_state()
    ref = TRAINERS[name][1](JConfig.from_dict(raw))
    batch = _view_batch(ours, "train", 4, seed=1)
    v = _jax_variables(ref, batch)
    _carry(ours, v)
    assert ours.model.context.short1.compute_dtype == BF16
    jloss = jax_rounding(lambda p, s: ref._make_loss_fn(True)(
        p, s, batch, 0.0, {})[0], v["params"], v["batch_stats"])
    loss = ours._train_loss(batch, 0, 0)
    loss.backward()
    loss_held(loss.item(), jloss)
    jm = JVoxAsym(grid_size=12, compute_dtype=BF16)
    jprobs = jax_rounding(lambda vv: jm.apply(vv, batch["partial"],
                                              batch["coords"])[0], v)
    probs = {}
    for dt in (BF16, None):
        tm = ported(VoxAsym(grid_size=12, compute_dtype=dt), v).eval()
        with torch.no_grad():
            probs[dt] = tm(t(batch["partial"]), t(batch["coords"]))[0]
    held(probs[BF16], probs[None], jprobs)


def test_bf16_models_hand_the_kernels_f32_on_the_port(monkeypatch,
                                                      tmp_path):
    """Every kernel wrapper the nine models call in bf16 mode (kNN, FPS,
    the chamfer search and its backward's scatter, the auction) is handed
    f32 tensors: each model casts before it picks or measures, as the JAX
    models do (a wrapper would cast a bf16 tensor itself, silently)."""
    from houv_tpu_torch.models.common import init_like_flax
    from houv_tpu_torch.ops import chamfer, emd, grouping, sampling, scatter
    from houv_tpu_torch.train.cli import build_dataset, make_trainer

    seen = {}
    for mod, name in ((grouping, "knn_indices"),
                      (sampling, "furthest_point_sample"),
                      (chamfer, "chamfer_indices"),
                      (scatter, "scatter_add"),
                      (emd, "emd_auction_with_stats")):
        real = getattr(mod, name)

        def spy(*args, real=real, name=name, **kwargs):
            seen.setdefault(name, set()).update(
                a.dtype for a in args
                if isinstance(a, torch.Tensor) and a.is_floating_point())
            return real(*args, **kwargs)

        for holder in list(sys.modules.values()):
            if getattr(holder, "__name__", "").startswith("houv_tpu_torch") \
                    and getattr(holder, name, None) is real:
                monkeypatch.setattr(holder, name, spy)
    g = torch.Generator().manual_seed(0)
    x, gt = (torch.rand(2, 128, 3, generator=g) - 0.5 for _ in range(2))
    t_gt = torch.eye(4).expand(2, 4, 4).contiguous()
    models = {"pcn": dict(num_points=128, num_coarse=64, train_loss="emd"),
              "ecg": dict(num_points=128, num_coarse=64, num_input=128),
              "vrcnet": dict(num_points=256, num_coarse_raw=64, num_fps=128,
                             num_coarse=64, layers=(1, 1, 1, 1),
                             knn_list=(4,), pk=4, n_input=128,
                             eval_emd=True),
              "transformer": dict(num_points=128, num_latent=32),
              "dcp": dict(), "deepgmr": dict(rri_size=4),
              "idam": dict(descriptor_size=8)}
    for name, kw in models.items():
        tm = get_model(name, compute_dtype=BF16, **kw)
        init_like_flax(tm, torch.Generator().manual_seed(1))
        if name in ("dcp", "deepgmr", "idam"):
            out = tm(x, gt, t_gt, prefix="train", train=True,
                     **({"generator": g} if name == "idam" else {}))
            out["loss"].backward()
        else:
            tm(x, gt, "train", alpha=0.5, **(
                {"generator": g} if name == "vrcnet" else {})
               )["total_loss"].backward()
            with torch.no_grad():
                tm(x, gt, "val")
    for name in ("embedding.yaml", "spconv.yaml"):
        cfg = tconfig.Config.from_dict(_raw(name, tmp_path, **SMALL[name],
                                            compute_dtype=BF16))
        trainer = make_trainer(cfg, "cpu")
        trainer.init_state()
        batch = trainer.wrap_dataset(build_dataset(cfg, "train")).get_batch(
            np.arange(4), rng=np.random.default_rng(0))
        trainer._train_loss(batch, 0, 0).backward()
    assert set(seen) == {"knn_indices", "furthest_point_sample",
                         "chamfer_indices", "scatter_add",
                         "emd_auction_with_stats"}
    assert all(dtypes == {torch.float32} for dtypes in seen.values()), seen
