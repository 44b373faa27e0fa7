"""``compute_dtype: bfloat16`` in the port's PCN and VRCNet against the
JAX package's bf16 models, on the CPU (ECG: ``test_torch_bf16_ecg.py``;
the transformer and the shared blocks: ``test_torch_bf16_blocks.py``).

Sizes as the f32 parity tests (``tests/test_torch_pcn.py``,
``test_torch_vrcnet.py``); weights are numpy draws in the JAX model's
flax tree carried across by ``state_from_flax``. VRCNet picks points on
learned values (a bf16 step moves a near-tie), so the port's picks are
kept and handed to JAX and to the port's f32 run (``SharedPicks``).

The bounds of ``tests/test_torch_vrcnet_knn.py``'s bf16 test: the output
cloud within 5e-3 absolute of JAX's bf16 one, the train loss within 2e-3
relative; and the port's f32 mode on the same weights lies farther from
JAX's bf16 cloud, on average, than its bf16 mode does, so a cast that is
missing shows. Both packages round the same values to bf16 at the same
places; what stays apart is the order of a product's f32 sums, which now
and then moves a rounding by one bf16 step. JAX is jitted with XLA's
``xla_allow_excess_precision`` off (``jax_rounding``): by default XLA's
CPU compiler drops the bf16 roundings inside a fusion and computes there
in f32, and then the port's f32 mode lies about as near to JAX's bf16
output as its bf16 mode (VRCNet: 1.1 times as far, against 2.3 times);
with the option off the compiled program rounds as the JAX code does, op
by op.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from houv_tpu.models import get_model as jget_model
from houv_tpu.models import vrcnet as jv
from houv_tpu.ops import grouping as jg
from houv_tpu.ops import sampling as js
from houv_tpu_torch.models import get_model
from houv_tpu_torch.ops import grouping as tg
from houv_tpu_torch.ops import sampling as ts
from test_torch_ecg import _holders
from test_torch_vrcnet import _cloud, _params, _port, _t

BF16 = "bfloat16"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs one process per core."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def held(ours16, ours32, ref, atol=5e-3):
    """The port's bf16 output within ``atol`` of JAX's bf16 one, and its
    f32 output farther on average."""
    ref = np.asarray(ref, np.float64)
    d16 = np.abs(np.asarray(ours16, np.float64) - ref)
    d32 = np.abs(np.asarray(ours32, np.float64) - ref)
    assert d16.max() <= atol, (d16.max(), atol)
    assert d32.mean() > d16.mean(), (d32.mean(), d16.mean())


def loss_held(ours, ref, rtol=2e-3):
    np.testing.assert_allclose(float(ours), float(ref), rtol=rtol)


def jax_rounding(fn, *args):
    """``fn(*args)`` jitted with every bf16 rounding of the JAX code kept
    (``xla_allow_excess_precision`` off; by default XLA's CPU compiler
    computes a fusion's bf16 stretch in f32)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def test_pcn_bf16_matches_jax_bf16_on_the_port(rng):
    """PCN's encoder and decoder Dense layers in bf16, its parameters and
    clouds f32."""
    kw = dict(num_points=128, num_coarse=64)
    x, gt = _cloud(rng, 2, 128), _cloud(rng, 2, 128)
    jm = jget_model("pcn", compute_dtype=BF16, **kw)
    params = _params(jm, jnp.asarray(x), jnp.asarray(gt), "train", 0.5)
    ref = jax_rounding(lambda p, a: jm.apply(p, a, None, "test"), params, x)
    jloss = jax_rounding(lambda p, a, b: jm.apply(p, a, b, "train", 0.5),
                         params, x, gt)["total_loss"]
    outs = {}
    for dt in (BF16, None):
        tm = _port(get_model("pcn", compute_dtype=dt, **kw), params)
        with torch.no_grad():
            outs[dt] = tm(_t(x), None, "test")["result"]
        assert outs[dt].dtype == tm.encoder.fc1.weight.dtype == torch.float32
    loss = _port(get_model("pcn", compute_dtype=BF16, **kw), params)(
        _t(x), _t(gt), "train", 0.5)["total_loss"]
    loss.backward()
    held(outs[BF16], outs[None], ref["result"])
    loss_held(loss.item(), jloss)


class SharedPicks:
    """The port's picks (kNN, FPS, ball query) kept in call order and
    handed to JAX, or to another run of the port. ``record`` wraps the
    port's pick functions to keep what they return; ``to_jax`` stands in
    for JAX's, each returning the port's pick (kNN distances recomputed
    from the picked pairs); ``to_port`` stands in for the port's,
    returning the kept picks."""

    KINDS = (("knn", "knn_indices", "knn_points"),
             ("fps", "furthest_point_sample", "furthest_point_sample"),
             ("ball", "ball_query", "ball_query"))

    def __init__(self):
        self.kept = {k: [] for k, _, _ in self.KINDS}

    def _patch(self, monkeypatch, package, make):
        for kind, port_name, jax_name in self.KINDS:
            name = port_name if package == "houv_tpu_torch" else jax_name
            if kind == "fps":
                fn = getattr(ts if package == "houv_tpu_torch" else js, name)
            else:
                fn = getattr(tg if package == "houv_tpu_torch" else jg, name)
            stand_in = make(kind, fn)
            for mod in _holders(package, fn, name):
                monkeypatch.setattr(mod, name, stand_in)

    def record(self, monkeypatch):
        def make(kind, fn):
            def pick(*args, **kwargs):
                out = fn(*args, **kwargs)
                self.kept[kind].append(out.numpy().copy())
                return out
            return pick
        self._patch(monkeypatch, "houv_tpu_torch", make)

    def to_port(self, monkeypatch):
        given = {k: list(v) for k, v in self.kept.items()}

        def make(kind, fn):
            def pick(*args, **kwargs):
                return torch.as_tensor(given[kind].pop(0)).long()
            return pick
        self._patch(monkeypatch, "houv_tpu_torch", make)
        return given

    def to_jax(self, monkeypatch):
        at = dict.fromkeys(self.kept, 0)

        def take(kind):
            at[kind] += 1
            return jnp.asarray(self.kept[kind][at[kind] - 1])

        def make(kind, fn):
            if kind == "knn":
                def knn_points(query, ref, k, use_pallas=None):
                    idx = take(kind)
                    nb = jax.vmap(lambda r, i: r[i])(ref, idx)
                    return -jnp.sum((query[:, :, None, :] - nb) ** 2,
                                    -1), idx
                return knn_points
            return lambda *a, **kw: take(kind)
        self._patch(monkeypatch, "houv_tpu", make)
        return at


def test_vrcnet_bf16_matches_jax_bf16_on_the_port(rng):
    """The SA-SKN encoder and the fine stage's ``EFExpansion`` (64 -> 256
    channels at ratio 2: 256 coarse points, 512 fine) in bf16, the rest of
    VRCNet f32, as the JAX model. The port's picks are handed to JAX and
    to the port's f32 run. 'test' (its latent noise given), and the train
    loss (noise and dropout masks given, as ``test_torch_train``'s
    ``_JaxRandomness`` gives them)."""
    from test_torch_train import _draws, _JaxRandomness

    kw = dict(num_points=512, num_coarse_raw=128, num_fps=256,
              num_coarse=256, layers=(1, 1, 1, 1), knn_list=(4, 8), pk=8)
    x, gt = _cloud(rng, 2, 256), _cloud(rng, 2, 512)
    noise, masks = _draws(rng, 2)
    jm = jv.VRCNet(compute_dtype=BF16, **kw)
    params = _params(jm, jnp.asarray(x), jnp.asarray(gt), "train", 0.5)
    tkw = dict(kw, n_input=256)
    rngs = {"latent": jax.random.PRNGKey(5), "dropout": jax.random.PRNGKey(6)}

    def port_runs(prefix, **args):
        """The port's bf16 run (its picks kept), then its f32 run on
        those picks."""
        picks = SharedPicks()
        with pytest.MonkeyPatch.context() as mp:
            picks.record(mp)
            tm = _port(get_model("vrcnet", compute_dtype=BF16, **tkw),
                       params)
            with torch.set_grad_enabled(prefix == "train"):
                ours = tm(_t(x), _t(gt), prefix, **args)
        with pytest.MonkeyPatch.context() as mp:
            left = picks.to_port(mp)
            with torch.no_grad():
                ours32 = _port(get_model("vrcnet", **tkw), params)(
                    _t(x), _t(gt), prefix, **args)
        assert not any(left.values())
        return ours, ours32, picks

    ours, ours32, picks = port_runs("test", noise=_t(noise[0]))
    with pytest.MonkeyPatch.context() as mp:
        used = picks.to_jax(mp)
        mp.setattr(jax.random, "normal",
                   lambda key, shape, dtype=None: jnp.asarray(noise[0]))
        ref = jax_rounding(lambda p, a, b: jm.apply(p, a, b, "test",
                                                    rngs=rngs), params, x, gt)
    assert used == {k: len(v) for k, v in picks.kept.items()}
    assert ours["result"].shape == (2, 512, 3)
    held(ours["result"], ours32["result"], ref["result"])

    ours, _, picks = port_runs("train", alpha=0.5,
                               noise=[_t(n) for n in noise],
                               dropout_masks=[_t(m) for m in masks])
    with pytest.MonkeyPatch.context() as mp:
        picks.to_jax(mp)
        rand = _JaxRandomness(mp, noise, masks)

        def train(p, a, b):
            rand.rewind()
            with nn.intercept_methods(rand.intercept):
                return jm.apply(p, a, b, "train", alpha=0.5, rngs=rngs)

        ref = jax_rounding(train, params, x, gt)
    loss_held(ours["total_loss"].item(), ref["total_loss"])
    ours["total_loss"].backward()
