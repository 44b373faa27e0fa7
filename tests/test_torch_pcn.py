"""The port's PCN against the JAX package's, on the CPU.

Weights are the JAX modules' own flax trees (numpy values, non-zero biases)
carried across by ``state_from_flax``. Sizes: 128 points, 64 coarse, batch 2.
PCN makes no discrete pick in its forward, so outputs are held at 1e-5
relative (the same f32 arithmetic summed in another order; 1e-6 absolute).
The gradient reference is the JAX model in f64 on the same f32-valued
weights, as for VRCNet (tests/test_torch_train.py): the loss to 1e-4
relative, each parameter's gradient to 1e-4 of that tensor's largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from houv_tpu.models import get_model as jget_model
from houv_tpu.models import pcn as jp
from houv_tpu_torch.models import get_model
from houv_tpu_torch.models import pcn as tp
from houv_tpu_torch.state import state_from_flax, vrcnet_state_from_flax
from test_torch_vrcnet import _cloud, _params, _port, _t

TOL = dict(rtol=1e-5, atol=1e-6)
SMALL = dict(num_points=128, num_coarse=64)


def _close(ours, ref, **tol):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                               **(tol or TOL))


def test_pcn_decoder(rng):
    """The FC coarse cloud and the folding fine cloud (scale 4: the grid
    offsets, each coarse point repeated, the residual add)."""
    feat = rng.standard_normal((2, 1024)).astype(np.float32)
    jm = jp.PCNDecoder(32, 128, 4)
    params = _params(jm, jnp.asarray(feat))
    ref = jax.jit(jm.apply)(params, jnp.asarray(feat))
    ours = _port(tp.PCNDecoder(32, 128, 4), params)(_t(feat))
    assert ours[0].shape == (2, 32, 3) and ours[1].shape == (2, 128, 3)
    for a, b in zip(ours, ref):
        _close(a, b)


def test_pcn_encoder_label(rng):
    x = _cloud(rng, 2, 96)
    label = np.array([3, 15])
    jm = jp.PCNEncoderLabel(256)
    params = _params(jm, jnp.asarray(x), jnp.asarray(label))
    ref = jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(label))
    tm = _port(tp.PCNEncoderLabel(256), params)
    ours = tm(_t(x), torch.tensor(label))
    assert ours[0].shape == (2, 256) and ours[1].shape == (2, 96, 1024)
    for a, b in zip(ours, ref):
        _close(a, b)


@pytest.mark.parametrize("prefix", ["test", "val"])
def test_pcn_outputs_match_jax(rng, prefix):
    x, gt = _cloud(rng, 2, 128), _cloud(rng, 2, 128)
    jm = jget_model("pcn", eval_emd=True, **SMALL)
    params = _params(jm, jnp.asarray(x), jnp.asarray(gt), "train", 0.5)
    ref = jax.jit(lambda p, a, b: jm.apply(p, a, b, prefix))(
        params, jnp.asarray(x), jnp.asarray(gt))
    tm = _port(get_model("pcn", eval_emd=True, **SMALL), params)
    with torch.no_grad():
        ours = tm(_t(x), _t(gt), prefix)
    assert set(ours) == set(ref)
    if prefix == "test":
        assert ours["result"].shape == (2, 128, 3)
    for key in ref:
        if key == "emd":
            # each auction is within eps of the optimum matching
            _close(ours[key], ref[key], rtol=0, atol=2 * 0.004)
        else:
            _close(ours[key], ref[key])


@pytest.mark.parametrize("train_loss", ["cd", "emd"])
def test_pcn_train_loss_and_gradients_match_jax(rng, monkeypatch, train_loss):
    x, gt = _cloud(rng, 2, 128), _cloud(rng, 2, 128)
    jm = jget_model("pcn", train_loss=train_loss, **SMALL)
    params = _params(jm, jnp.asarray(x), jnp.asarray(gt), "train", 0.5)
    tm = _port(get_model("pcn", train_loss=train_loss, **SMALL), params)
    recorded = []
    if train_loss == "emd":
        # an auction is chaotic in its inputs: f32 and f64 runs end in
        # assignments that differ at a few points. JAX's are recorded and
        # handed to the port in order, as for VRCNet.
        from houv_tpu.ops.emd import emd_auction as jemd_auction
        from houv_tpu_torch.ops import emd as temd
        from houv_tpu_torch.ops.gather import gather_rows

        def jax_calc_emd(output, gt, eps=0.005, iterations=50):
            dist, assignment = jemd_auction(output, gt, eps, iterations)
            recorded.append(assignment)
            return jnp.sqrt(dist).mean(axis=-1)

        def port_auction(x1, x2, eps, iters, device=None):
            a = torch.as_tensor(np.asarray(recorded.pop(0))).long()
            diff = x1 - gather_rows(x2, a)
            return (diff * diff).sum(-1), a, None, None

        monkeypatch.setattr(jp, "calc_emd", jax_calc_emd)
        monkeypatch.setattr(temd, "emd_auction_with_stats", port_auction)

    def loss_fn(p, a, b):
        recorded.clear()
        out = jm.apply(p, a, b, "train", 0.5)
        return out["total_loss"], (out, list(recorded))

    with jax.enable_x64(True):
        def f64(a):
            return jnp.asarray(np.asarray(a), jnp.float64)

        (_, (jout, assignments)), jgrads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(
                jax.tree_util.tree_map(f64, params), f64(x), f64(gt))
        jout, jgrads = jax.tree_util.tree_map(np.asarray, (jout, jgrads))
        recorded[:] = [np.asarray(a) for a in assignments]
    out = tm(_t(x), _t(gt), "train", alpha=0.5)
    out["total_loss"].backward()
    np.testing.assert_allclose(out["total_loss"].item(),
                               float(jout["total_loss"]), rtol=1e-4)
    _close(out["loss2"], jout["loss2"], rtol=1e-4, atol=0)
    _close(out["out2"], jout["out2"])
    ref = state_from_flax(jgrads, tm)
    grads = {n: p.grad for n, p in tm.named_parameters()}
    assert set(grads) == set(ref)
    for name, r in ref.items():
        np.testing.assert_allclose(
            grads[name].numpy(), r.numpy(), rtol=0,
            atol=1e-4 * float(r.abs().max()) + 1e-12, err_msg=name)


def test_one_function_carries_every_model_and_keeps_its_old_name(rng):
    """``state_from_flax`` is the one carrier (``vrcnet_state_from_flax`` is
    the same function); a flax name without a counterpart raises, and a
    missing one fails the strict load."""
    assert vrcnet_state_from_flax is state_from_flax
    x = _cloud(rng, 1, 128)
    jm = jget_model("pcn", **SMALL)
    params = _params(jm, jnp.asarray(x), jnp.asarray(x), "train", 0.5)
    tm = get_model("pcn", **SMALL)
    state = state_from_flax(params, tm)
    assert set(state) == set(tm.state_dict())
    tree = dict(params["params"])
    tree["Dense_9"] = tree["PCNEncoder_0"]["Dense_0"]
    with pytest.raises(KeyError, match="Dense_9"):
        state_from_flax(tree, tm)
    del state["decoder.fold3.bias"]
    with pytest.raises(RuntimeError, match="fold3.bias"):
        tm.load_state_dict(state, strict=True)
    with pytest.raises(KeyError, match="unknown model"):
        get_model("pointnet")
    with pytest.raises(NotImplementedError):
        get_model("pcn", train_loss="l2")
