"""The port's VRCNet modules against the JAX package's, on the CPU.

Weights are the JAX modules' own: a flax parameter tree (shapes from
``jax.eval_shape`` of ``init``, values drawn with numpy from a seed, biases
non-zero so that their mapping is checked) carried across by
``vrcnet_state_from_flax``. Sizes follow ``tests/test_models.py:56``: 256
points, ``coarse_raw`` 128, layers 1,1,1,1, and ``knn_list`` (4, 8) so that
the two-branch selective-kernel fusion runs. Tolerance 1e-4 absolute and
relative: the same f32 arithmetic, summed in another order.

The JAX package selects kNN on its CPU path by the expansion form
|a|²-2ab+|b|², the port by the exact diff form, so at a near-tie the two can
pick different neighbours. ``SASKNResEncoder`` is therefore fed the JAX
geometry; the whole-model tests first assert that both packages built the
same geometry and say so if a near-tie flipped a neighbour.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from houv_tpu.models import vrcnet as jv
from houv_tpu.models.vrcnet import VRCNet as JVRCNet
from houv_tpu_torch.models import vrcnet as tv
from houv_tpu_torch.state import vrcnet_state_from_flax

TOL = dict(atol=1e-4, rtol=1e-4)
SMALL = dict(num_points=256, num_coarse_raw=128, num_fps=256, num_coarse=256,
             layers=(1, 1, 1, 1), knn_list=(4, 8), pk=8)


def _params(module, *args, seed=0, **kwargs):
    """A flax parameter tree for ``module``: shapes from ``eval_shape`` of
    its init, kernels ~ N(0, 1/fan_in), biases ~ N(0, 0.1²), from numpy."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: module.init(
        {"params": jax.random.PRNGKey(0), "latent": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)}, *args, **kwargs))

    def draw(path, s):
        scale = (1.0 / np.sqrt(s.shape[0]) if path[-1].key == "kernel"
                 else 0.1)
        return (scale * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _port(module, params):
    module.load_state_dict(vrcnet_state_from_flax(params, module),
                           strict=True)
    return module.eval()


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(ours, ref):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), **TOL)


def _geo_to_torch(geo):
    return {"knn": [[_t(i).long() for i in lvl] for lvl in geo["knn"]],
            "eps": [tuple(_t(a).long() if j < 2 else _t(a)
                          for j, a in enumerate(e)) for e in geo["eps"]],
            "unpool": [(_t(i).long(), _t(w)) for i, w in geo["unpool"]]}


def _cloud(rng, b, n):
    return rng.uniform(-0.5, 0.5, (b, n, 3)).astype(np.float32)


def test_sa_module(rng):
    c, k = 64, 8
    x = rng.standard_normal((2, 96, c)).astype(np.float32)
    pts = _cloud(rng, 2, 96)
    idx = np.asarray(jax.lax.top_k(-((pts[:, :, None] - pts[:, None]) ** 2)
                                   .sum(-1), k)[1])
    jm = jv.SAModule(c // 16, c // 4, c, 8, k)
    params = _params(jm, jnp.asarray(x), jnp.asarray(idx))
    ref = jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(idx))
    ours = _port(tv.SAModule(c // 16, c // 4, c, 8, k), params)(
        _t(x), _t(idx).long())
    _close(ours, ref)


@pytest.mark.parametrize("layers", [1, 2])
def test_sk_modules(rng, layers):
    """SKSAModule inside SKNResUnit: two branches (k 4 and 8), softmax over
    the ks axis, residual projection."""
    c_in, c = 3, 64
    feat = _cloud(rng, 2, 80)
    d = ((feat[:, :, None] - feat[:, None]) ** 2).sum(-1)
    idxs = [np.argsort(d, -1, kind="stable")[..., :k] for k in (4, 8)]
    jm = jv.SKNResUnit(c, (4, 8), layers)
    args = (jnp.asarray(feat), [jnp.asarray(i) for i in idxs])
    params = _params(jm, *args)
    ref = jax.jit(jm.apply)(params, *args)
    ours = _port(tv.SKNResUnit(c_in, c, (4, 8), layers), params)(
        _t(feat), [_t(i).long() for i in idxs])
    _close(ours, ref)


def test_saskn_encoder_on_jax_geometry(rng):
    pts = _cloud(rng, 2, 384)
    n = 384
    pts_num = (n, n // 2, n // 4, n // 8)
    geo = jv.saskn_geometry(jnp.asarray(pts), pts_num, (4, 8), 8)
    jm = jv.SASKNResEncoder(ks=(4, 8), pk=8, output_size=256,
                            layers=(1, 1, 1, 1), pts_num=pts_num)
    params = _params(jm, jnp.asarray(pts), False, geo)
    ref = jax.jit(lambda p, x, g: jm.apply(p, x, False, g))(
        params, jnp.asarray(pts), geo)
    tm = _port(tv.SASKNResEncoder(3, (4, 8), 8, 256, (1, 1, 1, 1)), params)
    _close(tm(_t(pts), _geo_to_torch(geo)), ref)
    # without a geometry the encoder builds its own from the xyz channels:
    # the same one here (test_saskn_geometry_matches_jax)
    _close(tm(_t(pts)), ref)


def test_saskn_geometry_matches_jax(rng):
    """FPS pyramid, kNN graphs and three-NN weights from the same points."""
    pts = _cloud(rng, 2, 384)
    pts_num = (384, 192, 96, 48)
    ref = jv.saskn_geometry(jnp.asarray(pts), pts_num, (4, 8), 8)
    ours = tv.saskn_geometry(_t(pts), pts_num, (4, 8), 8)
    for a, b in zip(ours["knn"], ref["knn"]):
        for i, j in zip(a, b):
            np.testing.assert_array_equal(i.numpy(), np.asarray(j))
    for a, b in zip(ours["eps"], ref["eps"]):
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(b[0]))
        np.testing.assert_array_equal(a[1].numpy(), np.asarray(b[1]))
        np.testing.assert_array_equal(a[2].numpy(), np.asarray(b[2]))
    for (i, w), (ji, jw) in zip(ours["unpool"], ref["unpool"]):
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        _close(w, jw)


def _jax_run(jm, params, *args, **kwargs):
    """``jm.apply`` under jit; also returns the geometry its
    ``SASKNResEncoder`` was given inside that very run."""
    def run(p, *a):
        seen = {}

        def intercept(next_fun, call_args, call_kwargs, ctx):
            if ctx.method_name == "__call__" and \
                    isinstance(ctx.module, jv.SASKNResEncoder):
                seen["geo"] = call_args[2]
            return next_fun(*call_args, **call_kwargs)

        with nn.intercept_methods(intercept):
            out = jm.apply(p, *a, **kwargs)
        return out, seen["geo"]

    return jax.jit(run)(params, *args)


def _port_run(tm, *args, **kwargs):
    """The port module's output and the geometry its encoder was given."""
    seen = {}
    encoder = tm.decoder.encoder if isinstance(tm, tv.VRCNet) else tm.encoder

    def keep(_, args):
        seen["geo"] = args[1]

    hook = encoder.register_forward_pre_hook(keep)
    try:
        with torch.no_grad():
            out = tm(*args, **kwargs)
    finally:
        hook.remove()
    return out, seen["geo"]


def _assert_same_geometry(tgeo, jgeo):
    """Both packages built the same FPS pyramid, kNN graphs and three-NN
    neighbours from their (1e-5-close) clouds; otherwise a near-tie flipped
    a neighbour and the outputs cannot be compared."""
    picks = [("knn", lvl, i, a, b)
             for lvl, (la, lb) in enumerate(zip(tgeo["knn"], jgeo["knn"]))
             for i, (a, b) in enumerate(zip(la, lb))]
    picks += [("eps", lvl, i, a[i], b[i])
              for lvl, (a, b) in enumerate(zip(tgeo["eps"], jgeo["eps"]))
              for i in (0, 1)]
    picks += [("unpool", lvl, 0, a[0], b[0])
              for lvl, (a, b) in enumerate(zip(tgeo["unpool"],
                                               jgeo["unpool"]))]
    for name, lvl, i, a, b in picks:
        flips = int((a.numpy() != np.asarray(b)).sum())
        assert flips == 0, (
            f"{name}[{lvl}][{i}]: {flips} picks differ between the port's "
            "diff-form and JAX's expansion-form kNN / FPS (a near-tie "
            "flipped a neighbour); the outputs cannot be compared")


@pytest.mark.parametrize("c,minus_center", [(3, True), (16, False)])
def test_graph_feature_and_edge_pooling(rng, c, minus_center):
    """``get_graph_feature`` (its kNN in the feature space; C = 16 runs the
    plain version, on the CPU only) and ``edge_preserve_sampling`` building
    its own FPS + kNN neighbourhoods."""
    from houv_tpu.models import common as jc
    from houv_tpu_torch.models import common as tc

    x = rng.standard_normal((2, 64, c)).astype(np.float32)
    _close(tc.get_graph_feature(_t(x), 6, minus_center),
           jc.get_graph_feature(jnp.asarray(x), 6, minus_center))
    feats = rng.standard_normal((2, 64, 32)).astype(np.float32)
    pts = _cloud(rng, 2, 64)
    ours = tc.edge_preserve_sampling(_t(feats), _t(pts), 16, 5)
    ref = jc.edge_preserve_sampling(jnp.asarray(feats), jnp.asarray(pts),
                                    16, 5)
    for a, b in zip(ours, ref):
        _close(a, b)
    for ratio in (1, 4, 6, 7):
        _close(tc.gen_grid_up(ratio), jc.gen_grid_up(ratio))
    _close(tc.max_pool_points(_t(feats)), jc.max_pool_points(
        jnp.asarray(feats)))


@pytest.mark.parametrize("local_folding", [False, True])
def test_msap_skn_decoder(rng, local_folding):
    """The decoder at 256 input points; with local folding, num_coarse 128
    < num_points runs the score selection and ``Folding``."""
    kw = dict(SMALL, num_coarse=128 if local_folding else 256)
    # a global feature at this scale puts the coarse cloud in MVP's unit
    # cube; at 10x it spans ±1.8 and the expansion form's error (~1e-7·|a|²)
    # flips a near-tie at 2e-5 relative in JAX's level-0 kNN
    g = 0.1 * rng.standard_normal((2, 1024)).astype(np.float32)
    x = _cloud(rng, 2, 256)
    jm = jv.MSAPSKNDecoder(kw["num_coarse_raw"], kw["num_fps"],
                           kw["num_coarse"], kw["num_points"], kw["layers"],
                           kw["knn_list"], kw["pk"],
                           local_folding=local_folding)
    params = _params(jm, jnp.asarray(g), jnp.asarray(x))
    ref, jgeo = _jax_run(jm, params, jnp.asarray(g), jnp.asarray(x))
    tm = _port(tv.MSAPSKNDecoder(1024, 256, kw["num_coarse_raw"],
                                 kw["num_fps"], kw["num_coarse"],
                                 kw["num_points"], kw["layers"],
                                 kw["knn_list"], kw["pk"],
                                 local_folding=local_folding), params)
    ours, tgeo = _port_run(tm, _t(g), _t(x))
    _assert_same_geometry(tgeo, jgeo)
    assert ours[3].shape == (2, 256, 3)
    for a, b in zip(ours, ref):
        _close(a, b)


def _whole_model(rng, monkeypatch, prefix, **kw):
    """JAX VRCNet and the port on the same weights, input and latent noise
    (JAX's ``jax.random.normal`` draw replaced by the numpy noise the port
    is given). Returns both outputs, after checking that both built the same
    geometry."""
    x = _cloud(rng, 2, 256)
    gt = _cloud(rng, 2, 256)
    noise = rng.standard_normal((2, 128)).astype(np.float32)
    jm = JVRCNet(**kw)
    params = _params(jm, jnp.asarray(x), jnp.asarray(gt), "train", 0.5)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.asarray(noise))
    ref, jgeo = _jax_run(jm, params, jnp.asarray(x), jnp.asarray(gt),
                         prefix=prefix,
                         rngs={"latent": jax.random.PRNGKey(5)})
    tm = _port(tv.VRCNet(**kw), params)
    ours, tgeo = _port_run(tm, _t(x), _t(gt), prefix, noise=_t(noise))
    _assert_same_geometry(tgeo, jgeo)
    return ours, ref


def test_vrcnet_test_prefix(rng, monkeypatch):
    ours, ref = _whole_model(rng, monkeypatch, "test", **SMALL)
    assert ours["result"].shape == (2, 256, 3)
    _close(ours["result"], ref["result"])


def test_vrcnet_val_prefix_with_emd(rng, monkeypatch):
    """'val': the fine cloud and cd_p, cd_t, f1 and the auction EMD (ε 0.004,
    3000 rounds) of the port against JAX's."""
    ours, ref = _whole_model(rng, monkeypatch, "val", eval_emd=True, **SMALL)
    for key in ("out1", "out2", "cd_p", "cd_t", "f1"):
        _close(ours[key], ref[key])
    # each auction is within ε of the optimum matching, so the mean matched
    # distances agree within 2ε
    np.testing.assert_allclose(ours["emd"].numpy(), np.asarray(ref["emd"]),
                               atol=2 * 0.004)


def test_vrcnet_local_folding(rng, monkeypatch):
    ours, ref = _whole_model(rng, monkeypatch, "test", local_folding=True,
                             **dict(SMALL, num_coarse=128))
    _close(ours["result"], ref["result"])


def test_vrcnet_unknown_prefix_and_wrong_noise_count_raise():
    """A prefix the model does not know raises, and so does 'train' with
    the wrong number of noise tensors."""
    tm = tv.VRCNet(**SMALL)
    x = torch.zeros(1, 256, 3)
    with pytest.raises(ValueError, match="'train', 'val' or 'test'"):
        tm(x, x, "fit")
    with pytest.raises(ValueError, match="2 noise"):
        tm(x, x, "train", alpha=0.5, noise=[torch.zeros(1, 128)])
