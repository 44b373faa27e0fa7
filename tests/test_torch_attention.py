"""The port's shared blocks of the learned models (``models/common.py``:
``attention``, ``MultiHeadAttention``, ``LayerNorm``, the unmasked
``BatchNorm``, ``PointMLP`` with BatchNorm, ``svd_head``) against the JAX
package's flax modules, on the CPU.

Weights are numpy draws in the flax tree (``test_torch_voxelnet.
draw_variables``) carried across by ``state_from_flax``. Tolerances: 1e-5
absolute on outputs of order 1 (the same f32 arithmetic summed in another
order); the running statistics after a train step 1e-6. flax's LayerNorm
(ε 1e-6) is held apart from ``torch.nn.LayerNorm``'s default ε (1e-5) on
an input whose variance is of the order of ε, where the two differ by more
than the tolerance.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from houv_tpu.models import common as jc
from houv_tpu_torch.models import common as tc
from houv_tpu_torch.state import state_from_flax
from test_torch_voxelnet import draw_variables


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs one process per core."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _variables(module, *args, seed=0, **kwargs):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args,
                                                **kwargs))
    return draw_variables(shapes, np.random.default_rng(seed))


def _port(tm, variables):
    tm.load_state_dict(state_from_flax(variables, tm), strict=True)
    return tm


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("masked", [False, True])
def test_multi_head_attention_matches_flax(rng, masked):
    q = rng.standard_normal((2, 7, 32)).astype(np.float32)
    kv = rng.standard_normal((2, 11, 32)).astype(np.float32)
    mask = (rng.uniform(size=(2, 1, 7, 11)) > 0.3).astype(np.float32)
    mask = mask if masked else None
    jm = jc.MultiHeadAttention(4, 32)
    v = _variables(jm, q, kv, kv, mask)
    ref = jm.apply(v, q, kv, kv, mask)
    tm = _port(tc.MultiHeadAttention(4, 32), v)
    with torch.no_grad():
        out = tm(torch.tensor(q), torch.tensor(kv), torch.tensor(kv),
                 None if mask is None else torch.tensor(mask))
    np.testing.assert_allclose(out.numpy(), _np(ref), rtol=0, atol=1e-5)
    # the flax names: q, k, v and the output projection, in that order
    assert tm.flax_names == {"Dense_0": "q", "Dense_1": "k",
                             "Dense_2": "v", "Dense_3": "out"}
    out_j, p_j = jc.attention(q[:, None], kv[:, None], kv[:, None])
    out_t, p_t = tc.attention(torch.tensor(q[:, None]),
                              torch.tensor(kv[:, None]),
                              torch.tensor(kv[:, None]))
    np.testing.assert_allclose(p_t.numpy(), _np(p_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(out_t.numpy(), _np(out_j), rtol=0, atol=1e-5)


@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_layer_norm_is_flax_not_torch_default(rng, eps):
    x = (1e-3 * rng.standard_normal((2, 5, 64))).astype(np.float32)
    jm = fnn.LayerNorm(epsilon=eps)
    v = _variables(jm, x)
    ref = _np(jm.apply(v, x))
    tm = _port(tc.LayerNorm(64, eps=eps), v)
    with torch.no_grad():
        out = tm(torch.tensor(x)).numpy()
        torch_default = torch.nn.functional.layer_norm(
            torch.tensor(x), (64,), tm.weight, tm.bias).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    np.testing.assert_allclose(tm(torch.tensor(x)).detach().numpy(),
                               _np(jm.apply(v, x)), rtol=0, atol=1e-5)
    if eps == 1e-6:
        # torch's default ε (1e-5) misses flax's on a spread of 1e-3
        assert np.abs(torch_default - ref).max() > 1e-2


@pytest.mark.parametrize("use_bias", [True, False])
def test_batch_norm_both_modes_and_two_calls_match_flax(rng, use_bias):
    """Train mode normalises by the batch and moves the running statistics
    (twice when the module runs on two inputs in one apply, as DCP's
    DGCNN does on src and tgt); eval mode normalises by them."""
    a = (1.0 + rng.standard_normal((2, 9, 4, 16))).astype(np.float32)
    b = (0.5 * rng.standard_normal((2, 9, 4, 16))).astype(np.float32)

    class Twice(fnn.Module):
        @fnn.compact
        def __call__(self, a, b, train):
            bn = fnn.BatchNorm(use_running_average=not train,
                               use_bias=use_bias)
            return bn(a), bn(b)

    jm = Twice()
    v = _variables(jm, a, b, False)
    (ja, jb), upd = jm.apply(v, a, b, True, mutable=["batch_stats"])
    tm = _port(tc.BatchNorm(16, use_bias=use_bias), {
        "params": v["params"]["BatchNorm_0"],
        "batch_stats": v["batch_stats"]["BatchNorm_0"]})
    assert (tm.bias is None) == (not use_bias)
    with torch.no_grad():
        ta, tb = tm(torch.tensor(a), True), tm(torch.tensor(b), True)
    np.testing.assert_allclose(ta.numpy(), _np(ja), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tb.numpy(), _np(jb), rtol=0, atol=1e-5)
    stats = upd["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(tm.running_mean.numpy(), _np(stats["mean"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tm.running_var.numpy(), _np(stats["var"]),
                               rtol=0, atol=1e-6)
    v2 = {"params": v["params"], "batch_stats": upd["batch_stats"]}
    ja, _ = jm.apply(v2, a, b, False)
    before = tm.running_mean.clone()
    with torch.no_grad():
        ta = tm(torch.tensor(a), False)
    np.testing.assert_allclose(ta.numpy(), _np(ja), rtol=0, atol=1e-5)
    assert torch.equal(tm.running_mean, before)


def test_point_mlp_with_batch_norm_matches_flax(rng):
    x = rng.standard_normal((2, 33, 5)).astype(np.float32)
    jm = jc.PointMLP((16, 32, 8), relu_last=True, use_bn=True)
    v = _variables(jm, x, False)
    tm = _port(tc.PointMLP((16, 32, 8), 5, relu_last=True, use_bn=True), v)
    ref, upd = jm.apply(v, x, True, mutable=["batch_stats"])
    with torch.no_grad():
        out = tm(torch.tensor(x), True)
    np.testing.assert_allclose(out.numpy(), _np(ref), rtol=0, atol=1e-5)
    for i in range(3):
        s = upd["batch_stats"][f"BatchNorm_{i}"]
        bn = getattr(tm, f"bn{i}")
        np.testing.assert_allclose(bn.running_var.numpy(), _np(s["var"]),
                                   rtol=1e-5, atol=1e-6)
    with torch.no_grad():
        out = tm(torch.tensor(x), False)
    ref = jm.apply({"params": v["params"], "batch_stats": upd["batch_stats"]},
                   x, False)
    np.testing.assert_allclose(out.numpy(), _np(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("stop_grad", [False, True])
def test_svd_head_matches_jax(rng, stop_grad):
    src = rng.standard_normal((3, 40, 3)).astype(np.float32)
    a = rng.standard_normal((3, 3))
    r_true = np.linalg.qr(a)[0] * np.sign(np.linalg.det(np.linalg.qr(a)[0]))
    tgt = (src @ r_true.T + 0.3 + 0.01 * rng.standard_normal(src.shape)
           ).astype(np.float32)
    w = rng.uniform(0.1, 1.0, (3, 40)).astype(np.float32)
    rj, tj = jc.svd_head(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(w),
                         stop_grad=stop_grad)
    s = torch.tensor(src, requires_grad=True)
    rt, tt = tc.svd_head(s, torch.tensor(tgt), torch.tensor(w),
                         stop_grad=stop_grad)
    np.testing.assert_allclose(rt.detach().numpy(), _np(rj), atol=1e-5)
    np.testing.assert_allclose(tt.detach().numpy(), _np(tj), atol=1e-5)
    assert rt.requires_grad != stop_grad
    r1, _ = tc.svd_head(torch.tensor(src), torch.tensor(tgt))
    r2, _ = jc.svd_head(jnp.asarray(src), jnp.asarray(tgt))
    np.testing.assert_allclose(r1.numpy(), _np(r2), atol=1e-5)
