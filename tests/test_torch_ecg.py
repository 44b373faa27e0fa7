"""The port's ECG modules and model against the JAX package's, on the CPU.

Weights are the JAX modules' own flax trees (numpy values, non-zero biases)
carried across by ``state_from_flax``.

ECG picks points all the way through: FPS, kNN on coordinates, kNN on
learned features (``DenseConv``, ``EFExpansion``) and ball queries. The JAX
package selects kNN on its CPU path by the expansion form |q|² - 2q·r +
|r|², the port by the exact diff form, and in a learned feature space
near-ties are common; a flipped neighbour is another function, and one
flipped FPS pick changes every later one. So the whole-model tests capture
the picks JAX made (its FPS, ``knn_points`` and ``ball_query`` are stood in
for, called, and their index outputs kept in call order) and hand them to
the port, whose own picks are still computed and compared: the per-row kNN
and ball-query picks must agree on all but 2% of slots. On equal picks the
outputs are held at 1e-5 relative (1e-6 absolute). The distances the
stand-in returns are recomputed from the picked pairs in the diff form, as
the JAX package's own kernel path and the port do (its CPU fallback returns
the expansion form's, whose 1e-8 cancellation noise the uniform loss's
sqrt(|d²| + 1e-8) would amplify at the repeated points of a ball query).

The gradient reference is the JAX model in f64 on the same picks: the loss to
1e-4 relative, each parameter's gradient to 1e-3 of that tensor's largest
entry. (VRCNet's are held at 1e-4, tests/test_torch_train.py; here the
uniform loss differentiates sqrt(|d²| + 1e-8) at neighbours 1e-3 apart,
where the f32 rounding of the coordinates is 3e-5 of their difference, and
the coarse cloud's output layer reads 1.4e-4 at 13 of its 196,608 entries.)
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from houv_tpu.models import common as jc
from houv_tpu.models import ecg as je
from houv_tpu.models import get_model as jget_model
from houv_tpu.models import vrcnet as jv
from houv_tpu.ops import grouping as jg
from houv_tpu.ops import sampling as js
from houv_tpu_torch.models import common as tc
from houv_tpu_torch.models import ecg as te
from houv_tpu_torch.models import get_model
from houv_tpu_torch.models import vrcnet as tv
from houv_tpu_torch.ops import grouping as tg
from houv_tpu_torch.ops import sampling as ts
from houv_tpu_torch.state import state_from_flax
from test_torch_vrcnet import _cloud, _params, _port, _t

TOL = dict(rtol=1e-5, atol=1e-6)
SMALL = dict(num_points=128, num_coarse=64, num_input=128)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close(ours, ref, **tol):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                               **(tol or TOL))


def _holders(prefix, fn, name):
    return [m for k, m in list(sys.modules.items())
            if (k == prefix or k.startswith(prefix + "."))
            and getattr(m, name, None) is fn]


class _JaxPicks:
    """Stands in for the JAX package's pick functions wherever its modules
    hold them. Recording (an eager run: the indices are concrete), it calls
    the real function and keeps the indices; replaying (under ``jit`` and
    ``grad``), it returns the kept ones. ``knn_points`` returns the negated
    diff-form distances of the picked pairs either way."""

    def __init__(self, monkeypatch):
        self.kept = {"knn": [], "fps": [], "ball": []}
        self.at = None
        for kind, fn, name in (("knn", jg.knn_points, "knn_points"),
                               ("fps", js.furthest_point_sample,
                                "furthest_point_sample"),
                               ("ball", jg.ball_query, "ball_query")):
            for mod in _holders("houv_tpu", fn, name):
                monkeypatch.setattr(mod, name, self._stand_in(kind, fn))

    def replay(self):
        self.at = dict.fromkeys(self.kept, 0)

    def _pick(self, kind, compute):
        if self.at is None:
            self.kept[kind].append(np.asarray(compute()))
            return jnp.asarray(self.kept[kind][-1])
        self.at[kind] += 1
        return jnp.asarray(self.kept[kind][self.at[kind] - 1])

    def _stand_in(self, kind, fn):
        if kind == "knn":
            def knn_points(query, ref, k, use_pallas=None):
                idx = self._pick(kind, lambda: fn(query, ref, k)[1])
                nb = jax.vmap(lambda r, i: r[i])(ref, idx)
                return -jnp.sum((query[:, :, None, :] - nb) ** 2, -1), idx
            return knn_points
        return lambda *a, **kw: self._pick(kind, lambda: fn(*a, **kw))


class _PortPicks:
    """Stands in for the port's pick functions: each is still called, its
    picks compared with the given ones (JAX's, in call order), and the given
    ones returned."""

    def __init__(self, monkeypatch, given):
        self.given = {k: list(v) for k, v in given.items()}
        self.differing = dict.fromkeys(given, 0)
        self.total = dict.fromkeys(given, 0)
        for kind, fn, name in (("knn", tg.knn_indices, "knn_indices"),
                               ("fps", ts.furthest_point_sample,
                                "furthest_point_sample"),
                               ("ball", tg.ball_query, "ball_query")):
            for mod in _holders("houv_tpu_torch", fn, name):
                monkeypatch.setattr(mod, name, self._stand_in(kind, fn))

    def _stand_in(self, kind, fn):
        def pick(*args, **kwargs):
            own = fn(*args, **kwargs)
            ref = torch.as_tensor(self.given[kind].pop(0).copy()).long()
            assert own.shape == ref.shape, (kind, own.shape, ref.shape)
            self.differing[kind] += int((own != ref).sum())
            self.total[kind] += ref.numel()
            return ref
        return pick

    def assert_all_used_and_close(self):
        assert not any(self.given.values()), \
            {k: len(v) for k, v in self.given.items()}
        for kind in ("knn", "ball"):
            if self.total[kind]:
                assert self.differing[kind] <= 0.02 * self.total[kind], \
                    (kind, self.differing, self.total)


# --- modules ---------------------------------------------------------------

def _with_knn_from(monkeypatch, idx):
    """Both packages' graph features take this kNN instead of their own."""
    monkeypatch.setattr(
        jc, "knn_points", lambda q, r, k, use_pallas=None:
        (None, jnp.asarray(idx)))
    monkeypatch.setattr(
        tc, "knn_indices", lambda q, r, k, device=None:
        torch.as_tensor(idx).long())


def _feature_knn(x, k):
    """The port's pick (exact diff form) and JAX's (expansion form), and
    the share of slots on which they agree."""
    ours = tg.knn_indices(_t(x), _t(x), k, device="cpu").numpy()
    ref = np.asarray(jg.knn_points(jnp.asarray(x), jnp.asarray(x), k)[1])
    return ours, (ours == ref).mean()


@pytest.mark.parametrize("c,dense_n", [(24, 3), (48, 3), (16, 4)])
def test_dense_conv(rng, monkeypatch, c, dense_n):
    """Indices away from ties: both packages pick the same graph on all but
    a small share of slots; outputs given equal indices. The last stacked
    layer has no ReLU."""
    x = np.maximum(rng.standard_normal((2, 80, c)), 0).astype(np.float32)
    idx, agree = _feature_knn(x, 16)
    assert agree > 0.98
    _with_knn_from(monkeypatch, idx)
    jm = je.DenseConv(24, dense_n, 16)
    params = _params(jm, jnp.asarray(x))
    ref = jax.jit(jm.apply)(params, jnp.asarray(x))
    tm = _port(te.DenseConv(c, 24, dense_n, 16), params)
    ours = tm(_t(x))
    assert ours.shape == (2, 80, c + 24 * dense_n)
    assert float(ours.detach()[..., -24:].min()) < 0   # its last layer: no ReLU
    _close(ours, ref)


@pytest.mark.parametrize("c_in,c_out,ratio", [(256, 64, 2), (64, 256, 3)])
def test_ef_expansion(rng, monkeypatch, c_in, c_out, ratio):
    """ECG's and VRCNet's widths; the reshape that turns each point's
    ``ratio`` channel groups into ``ratio`` new points."""
    x = rng.standard_normal((2, 40, c_in)).astype(np.float32)
    idx, agree = _feature_knn(x, 4)
    assert agree > 0.98
    _with_knn_from(monkeypatch, idx)
    jm = jc.EFExpansion(c_in, c_out, step_ratio=ratio, k=4)
    params = _params(jm, jnp.asarray(x))
    ref = jax.jit(jm.apply)(params, jnp.asarray(x))
    ours = _port(tc.EFExpansion(c_in, c_out, ratio, 4), params)(_t(x))
    assert ours.shape == (2, 40 * ratio, c_out)
    _close(ours, ref)


def test_ef_encoder_small_hierarchy(rng, monkeypatch):
    pts = _cloud(rng, 2, 96)
    jm = je.EFEncoder(hierarchy=(64, 32, 16), k=8, output_size=32)
    params = _params(jm, jnp.asarray(pts))
    picks = _JaxPicks(monkeypatch)
    ref = jm.apply(params, jnp.asarray(pts))
    assert [len(picks.kept[k]) for k in ("knn", "fps", "ball")] == [10, 3, 0]
    tm = _port(te.EFEncoder(hierarchy=(64, 32, 16), k=8, output_size=32),
               params)
    port = _PortPicks(monkeypatch, picks.kept)
    ours = tm(_t(pts))
    port.assert_all_used_and_close()
    assert port.differing["fps"] == 0
    assert ours.shape == (2, 96, 32)
    _close(ours, ref)


def test_uniform_loss_and_its_gradient(rng, monkeypatch):
    """The uniform loss and its gradient (finite where a ball query
    repeated its first hit and the nearest other point is at distance 0),
    JAX in f64 on the same picks as the reference."""
    pcd = _cloud(rng, 2, 256)
    picks = _JaxPicks(monkeypatch)
    ref32 = float(jc.get_uniform_loss(jnp.asarray(pcd)))
    balls = np.concatenate([b.reshape(-1, b.shape[-1]) for b in
                            picks.kept["ball"][:1]])
    assert (balls[:, 1:] == balls[:, :1]).any()   # some slots repeat
    picks.replay()
    with jax.enable_x64(True):
        loss64, grad64 = jax.value_and_grad(jc.get_uniform_loss)(
            jnp.asarray(pcd, jnp.float64))
    port = _PortPicks(monkeypatch, picks.kept)
    x = _t(pcd).requires_grad_(True)
    loss = tc.get_uniform_loss(x)
    loss.backward()
    port.assert_all_used_and_close()
    assert port.differing == {"knn": 0, "fps": 0, "ball": 0}
    np.testing.assert_allclose(loss.item(), float(loss64), rtol=1e-4)
    np.testing.assert_allclose(loss.item(), ref32, rtol=1e-3)
    assert torch.isfinite(x.grad).all()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(grad64), rtol=0,
                               atol=1e-4 * float(np.abs(grad64).max()))


def test_repulsion_loss_grids_and_symmetric_sample(rng):
    pcd = _cloud(rng, 2, 96)
    np.testing.assert_allclose(
        tc.get_repulsion_loss(_t(pcd)).item(),
        float(jc.get_repulsion_loss(jnp.asarray(pcd))), rtol=1e-5)
    for n in (2, 5):
        _close(tc.gen_grid(n), jc.gen_grid(n), rtol=1e-6, atol=1e-8)
        _close(tc.gen_1d_grid(n), jc.gen_1d_grid(n), rtol=1e-6, atol=1e-8)
    ours = tc.symmetric_sample(_t(pcd), 16)
    assert ours.shape == (2, 32, 3)
    _close(ours, jc.symmetric_sample(jnp.asarray(pcd), 16), rtol=0, atol=0)


@pytest.mark.parametrize("n,k", [(192, 1024), (5, 12), (64, 64)])
def test_fps_with_more_samples_than_points_matches_jax(rng, n, k):
    """``ECGDecoder`` builds ``EFEncoder`` with the hierarchy 1024/256/64
    whatever the cloud's size, so a small cloud asks FPS for more samples
    than it has points: once every point is taken the running minimum is 0
    everywhere and the arg-max is its first index, 0, from then on."""
    pts = _cloud(rng, 2, n)
    ours = ts.furthest_point_sample(_t(pts), k, device="cpu").numpy()
    ref = np.asarray(js.furthest_point_sample(jnp.asarray(pts), k))
    np.testing.assert_array_equal(ours, ref)
    if k > n:
        assert sorted(set(ours[0][:n])) == list(range(n))
        assert not ours[:, n:].any()


# --- the model ---------------------------------------------------------------

def _whole_model(rng, monkeypatch, prefix, gt_points=128, **kw):
    """JAX ECG (eager, its picks kept) and the port (given those picks) on
    the same weights and clouds: (port out, JAX out)."""
    kw = dict(SMALL, **kw)
    x, gt = _cloud(rng, 2, 128), _cloud(rng, 2, gt_points)
    jm = jget_model("ecg", **kw)
    params = _params(jm, jnp.asarray(x), jnp.asarray(gt), "train", 0.5)
    picks = _JaxPicks(monkeypatch)
    ref = jm.apply(params, jnp.asarray(x), jnp.asarray(gt), prefix)
    tm = _port(get_model("ecg", **kw), params)
    port = _PortPicks(monkeypatch, picks.kept)
    with torch.no_grad():
        ours = tm(_t(x), _t(gt), prefix)
    port.assert_all_used_and_close()
    assert set(ours) == set(ref)
    return ours, ref


def test_ecg_test_prefix(rng, monkeypatch):
    """192 points through the default hierarchy (FPS 1024 of 192)."""
    ours, ref = _whole_model(rng, monkeypatch, "test")
    assert ours["result"].shape == (2, 128, 3)
    _close(ours["result"], ref["result"])


def test_ecg_test_prefix_with_ef_expansion(rng, monkeypatch):
    """512 fine points from 192: ``EFExpansion`` at ratio 3, then the FPS
    trim 576 -> 512."""
    ours, ref = _whole_model(rng, monkeypatch, "test", gt_points=512,
                             num_points=512)
    assert ours["result"].shape == (2, 512, 3)
    _close(ours["result"], ref["result"])


def test_ecg_val_prefix_with_emd(rng, monkeypatch):
    ours, ref = _whole_model(rng, monkeypatch, "val", eval_emd=True)
    for key in ("out1", "out2", "cd_p", "cd_t", "f1"):
        _close(ours[key], ref[key])
    # each auction is within eps of the optimum matching
    _close(ours["emd"], ref["emd"], rtol=0, atol=2 * 0.004)


def test_ecg_train_loss_and_gradients_match_jax(rng, monkeypatch):
    """``loss: cd``: CD of the coarse and the fine cloud + 0.1 · their
    uniform losses. The picks are those of JAX's f32 run, replayed in its
    f64 run (the gradient reference) and in the port."""
    x, gt = _cloud(rng, 2, 128), _cloud(rng, 2, 128)
    jm = jget_model("ecg", **SMALL)
    params = _params(jm, jnp.asarray(x), jnp.asarray(gt), "train", 0.5)
    picks = _JaxPicks(monkeypatch)
    ref32 = jm.apply(params, jnp.asarray(x), jnp.asarray(gt), "train", 0.5)
    # forward: 10 kNN (4 graphs, 3 poolings, 3 three-NN) and 4 FPS; the two
    # uniform losses: 5 FPS, 5 ball queries and 5 kNN each
    assert [len(picks.kept[k]) for k in ("knn", "fps", "ball")] == \
        [20, 14, 10]

    def loss_fn(p, a, b):
        picks.replay()
        out = jm.apply(p, a, b, "train", 0.5)
        return out["total_loss"], out

    with jax.enable_x64(True):
        def f64(a):
            return jnp.asarray(np.asarray(a), jnp.float64)

        (_, jout), jgrads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(
                jax.tree_util.tree_map(f64, params), f64(x), f64(gt))
        jout, jgrads = jax.tree_util.tree_map(np.asarray, (jout, jgrads))

    tm = _port(get_model("ecg", **SMALL), params)
    port = _PortPicks(monkeypatch, picks.kept)
    out = tm(_t(x), _t(gt), "train", alpha=0.5)
    port.assert_all_used_and_close()
    out["total_loss"].backward()
    np.testing.assert_allclose(out["total_loss"].item(),
                               float(jout["total_loss"]), rtol=1e-4)
    np.testing.assert_allclose(out["total_loss"].item(),
                               float(ref32["total_loss"]), rtol=1e-4)
    _close(out["loss2"], jout["loss2"], rtol=1e-4, atol=0)
    _close(out["out2"], ref32["out2"])
    ref = state_from_flax(jgrads, tm)
    grads = {n: p.grad for n, p in tm.named_parameters()}
    assert set(grads) == set(ref)
    for name, r in ref.items():
        np.testing.assert_allclose(
            grads[name].numpy(), r.numpy(), rtol=0,
            atol=1e-3 * float(r.abs().max()) + 1e-12, err_msg=name)


@pytest.mark.parametrize("kw", [
    # no local folding: the fine stage is EFExpansion(64 -> 256) at ratio 2
    dict(num_coarse_raw=128, num_fps=256, num_coarse=128, num_fine=256),
    # a fine cloud of at least twice (coarse_raw + 2048) points: the
    # decoder's 256-channel features are doubled first, then FPS 768 -> 256
    # and the fine stage at ratio 8
    dict(num_coarse_raw=128, num_fps=256, num_coarse=256, num_fine=2200),
], ids=["fine-stage", "up-scale-and-fine-stage"])
def test_vrcnet_decoder_ef_expansion_branches(rng, monkeypatch, kw):
    """VRCNet's decoder where ``EFExpansion`` runs (without local folding,
    and with ``up_scale >= 2``), JAX's picks handed to the port."""
    g = 0.1 * rng.standard_normal((2, 1024)).astype(np.float32)
    x = _cloud(rng, 2, 256)
    jm = jv.MSAPSKNDecoder(kw["num_coarse_raw"], kw["num_fps"],
                           kw["num_coarse"], kw["num_fine"], (1, 1, 1, 1),
                           (4, 8), 8, local_folding=False)
    params = _params(jm, jnp.asarray(g), jnp.asarray(x))
    picks = _JaxPicks(monkeypatch)
    ref = jm.apply(params, jnp.asarray(g), jnp.asarray(x))
    tm = _port(tv.MSAPSKNDecoder(1024, 256, kw["num_coarse_raw"],
                                 kw["num_fps"], kw["num_coarse"],
                                 kw["num_fine"], (1, 1, 1, 1), (4, 8), 8,
                                 local_folding=False), params)
    port = _PortPicks(monkeypatch, picks.kept)
    with torch.no_grad():
        ours = tm(_t(g), _t(x))
    port.assert_all_used_and_close()
    assert ours[3].shape == ref[3].shape
    for a, b in zip(ours, ref):
        _close(a, b, rtol=1e-4, atol=1e-5)


def test_ecg_emd_loss_runs_and_other_losses_raise(rng):
    x, gt = _t(_cloud(rng, 2, 128)), _t(_cloud(rng, 2, 128))
    tm = get_model("ecg", train_loss="emd", **SMALL)
    tc.init_like_flax(tm, torch.Generator().manual_seed(3))
    out = tm(x, gt, "train", alpha=0.5)
    out["total_loss"].backward()
    assert torch.isfinite(out["total_loss"])
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in tm.parameters())
    with pytest.raises(NotImplementedError):
        get_model("ecg", train_loss="l2", **SMALL)
    with pytest.raises(ValueError, match="'train', 'val' or 'test'"):
        tm(x, gt, "fit")
