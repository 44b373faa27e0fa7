"""The port's DCP (``models/dcp.py``) against the JAX package, on the CPU.

Size: batch 2, 64 points, ``emb_dims`` 32 (the transformer at d 32, 4
heads, ff 1024), k 20. Weights and running statistics are numpy draws in
the JAX model's flax tree (``test_torch_voxelnet.draw_variables``) carried
across by ``state_from_flax``. Both packages must first pick the same kNN
graph (the JAX package's CPU kNN is the expansion form; the port's the
diff form).

Tolerances: the transform 1e-4 absolute, the loss and the running
statistics after a train step 1e-4 relative, the rotation error 1e-2
degrees (its arccos near 1 turns a 1e-7 trace into 1e-3°). Gradients
against JAX in f64 (jitted), each parameter's to 1e-5 of the largest
entry of that tensor or of the whole gradient (a key projection's bias
has none: the softmax cancels it). Two parts of the JAX model are swapped
for the gradient reference, each for one with the same value: the SVD
heads, whose JAX ``weighted_kabsch`` casts the covariance to f32 whatever
its dtype (the DGCNN's gradient, whose terms cancel, then moves by 40%),
run in f64 as the port's do; and the DGCNN's maximum over the k edges
takes its gradient from the first maximal edge, as a gather (jitted on the
CPU, ``jnp.max``'s gradient moves the DGCNN's by 40% from its own
op-by-op value, which the port's matches to 1e-6; ties occur only among
ReLU zeros, where the gradient is 0 either way).
"""

import contextlib
import functools
import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from houv_tpu.models import common as jcommon
from houv_tpu.models import dcp as jdcp
from houv_tpu.models.dcp import DCP as JDCP
from houv_tpu.ops.grouping import knn_points as jknn_points
from houv_tpu_torch.models import get_model
from houv_tpu_torch.models.dcp import DCP
from houv_tpu_torch.ops.grouping import knn_indices
from houv_tpu_torch.state import state_from_flax
from test_torch_voxelnet import draw_variables

B, N, EMB = 2, 64, 32


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs one process per core."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def registration_pair(seed, b=B, n=N, max_angle=45.0, noise=0.005):
    """(src, tgt, t_gt): a cloud of n uniform points and its copy moved by
    a random rotation (up to ``max_angle`` degrees) and translation, with
    a little noise; t_gt (B, 4, 4) aligns src to tgt."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-0.5, 0.5, (b, n, 3))
    t_gt = np.tile(np.eye(4), (b, 1, 1))
    for i in range(b):
        axis = rng.standard_normal(3)
        axis /= np.linalg.norm(axis)
        ang = np.radians(rng.uniform(0.2, 1.0) * max_angle)
        k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]])
        t_gt[i, :3, :3] = np.eye(3) + np.sin(ang) * k + (1 - np.cos(ang)) \
            * (k @ k)
        t_gt[i, :3, 3] = rng.uniform(-0.25, 0.25, 3)
    tgt = src @ t_gt[:, :3, :3].transpose(0, 2, 1) + t_gt[:, None, :3, 3]
    tgt = tgt + noise * rng.standard_normal(tgt.shape)
    perm = rng.permutation(n)
    return (src.astype(np.float32), tgt[:, perm].astype(np.float32),
            t_gt.astype(np.float32))


def flax_variables(jm, *args, seed=0, **kwargs):
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0),
         "sampling": jax.random.PRNGKey(1)}, *args, **kwargs))
    return jax.tree_util.tree_map(np.asarray, draw_variables(
        shapes, np.random.default_rng(seed)))


def jax_apply(jm, variables, *args, **kwargs):
    """``jm.apply`` jitted, the keyword arguments static (one compile runs
    in a fraction of the op-by-op dispatch's time, to within 1e-6 of it
    here)."""
    return jax.jit(functools.partial(jm.apply, **kwargs))(variables, *args)


def ported(tm, variables):
    """``tm`` with the flax ``variables`` carried across, every leaf used
    and every tensor of the port filled."""
    state = state_from_flax(variables, tm)
    assert len(state) == len(jax.tree_util.tree_leaves(variables)) \
        == len(tm.state_dict())
    tm.load_state_dict(state, strict=True)
    return tm


def t(x):
    return torch.tensor(np.asarray(x))


def assert_same_stats(tm, stats, tol=1e-4):
    """Every running statistic of ``tm`` against flax's ``batch_stats``
    (carried across by name), relative to its largest entry."""
    ref = state_from_flax(stats, tm)
    own = tm.state_dict()
    assert ref
    for name, value in ref.items():
        scale = max(float(value.abs().max()), 1e-6)
        err = float((own[name] - value).abs().max()) / scale
        assert err <= tol, (name, err)


def assert_outputs_match(out, ref, tol_loss=1e-4):
    np.testing.assert_allclose(out["transform"].detach().numpy(),
                               np.asarray(ref["transform"]), atol=1e-4)
    np.testing.assert_allclose(out["r_err"].detach().numpy(),
                               np.asarray(ref["r_err"]), atol=1e-2)
    for k in ("t_err", "rmse", "rt_mse"):
        np.testing.assert_allclose(out[k].detach().numpy(),
                                   np.asarray(ref[k]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(out["loss"]), float(ref["loss"]),
                               rtol=tol_loss, atol=1e-7)


def _first_max(x, axis=None, **kwargs):
    """``jnp.max`` over one axis as a gather of the first maximal entry
    (its gradient goes to that entry)."""
    i = jnp.argmax(x, axis=axis)
    return jnp.take_along_axis(x, jnp.expand_dims(i, axis), axis).squeeze(
        axis)


# ``jnp`` for ``houv_tpu/models/dcp.py`` with ``_first_max`` as its max
JNP_FIRST_MAX = types.SimpleNamespace(**dict(
    {k: getattr(jnp, k) for k in dir(jnp) if not k.startswith("__")},
    max=_first_max))


def _kabsch_in_dtype(src, tgt, weights):
    """``houv_tpu/geometry/kabsch.py:weighted_kabsch`` with its SVD in the
    clouds' dtype (the JAX function casts the covariance to f32)."""
    fix = importlib.import_module("houv_tpu.geometry.kabsch")._fix_reflection
    w = weights / jnp.maximum(jnp.sum(weights, -1, keepdims=True),
                              jnp.finfo(src.dtype).tiny)
    src_c = jnp.sum(src * w[..., None], -2, keepdims=True)
    tgt_c = jnp.sum(tgt * w[..., None], -2, keepdims=True)
    h = jnp.einsum("...ni,...n,...nj->...ij", src - src_c, w, tgt - tgt_c)
    u, _, vt = jnp.linalg.svd(h, full_matrices=False)
    r = fix(u, vt)
    return r, tgt_c[..., 0, :] - jnp.einsum("...ij,...j->...i", r,
                                            src_c[..., 0, :])


@contextlib.contextmanager
def svd_in_dtype(*patches):
    """JAX in f64 with the SVD heads' SVD in f64: ``common.svd_head``'s
    ``weighted_kabsch`` and each (module, name, function) of ``patches``
    replaced for the block."""
    patches = ((jcommon, "weighted_kabsch", _kabsch_in_dtype),) + patches
    saved = [(m, n, getattr(m, n)) for m, n, _ in patches]
    try:
        for m, n, f in patches:
            setattr(m, n, f)
        with jax.enable_x64(True):
            yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def f64_grads(jm, variables, args, kwargs, tm, call, patches=()):
    """JAX's f64 gradient of the train loss (jitted) beside the port's f64
    one, each parameter's to 1e-5 of the largest entry of that tensor or
    of the whole gradient."""
    with svd_in_dtype(*patches):
        v64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a), jnp.float64), variables)
        a64 = [jnp.asarray(np.asarray(a), jnp.float64) for a in args]

        def loss_fn(params):
            out, _ = jm.apply({"params": params,
                               "batch_stats": v64["batch_stats"]}, *a64,
                              mutable=["batch_stats"], **kwargs)
            return out["loss"]

        ref = jax.tree_util.tree_map(np.asarray,
                                     jax.jit(jax.grad(loss_fn))(v64["params"]))
    tm = tm.double()
    out = call(tm, [torch.tensor(np.asarray(a), dtype=torch.float64)
                    for a in args])
    out["loss"].backward()
    want = {k: v.double() for k, v in state_from_flax(
        {"params": jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64), ref)}, tm).items()}
    grads = dict(tm.named_parameters())
    assert set(want) == set(grads)
    floor = 1e-3 * max(float(g.abs().max()) for g in want.values())
    for name, g in want.items():
        got = grads[name].grad
        scale = max(float(g.abs().max()), floor)
        err = float((got - g).abs().max()) / scale
        assert err <= 1e-5, (name, err)


def _same_graph(x, k=20):
    _, jidx = jknn_points(jnp.asarray(x), jnp.asarray(x), k)
    tidx = knn_indices(t(x), t(x), k, device="cpu")
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))


def _dcp(cycle=False, seed=0):
    src, tgt, t_gt = registration_pair(seed)
    _same_graph(src)
    _same_graph(tgt)
    jm = JDCP(emb_dims=EMB, cycle=cycle)
    v = flax_variables(jm, src, tgt, t_gt, seed=seed)
    tm = ported(DCP(emb_dims=EMB, cycle=cycle), v)
    return jm, v, tm, (src, tgt, t_gt)


@pytest.mark.parametrize("cycle", [False, True])
def test_dcp_val_and_test_match_jax(cycle):
    jm, v, tm, (src, tgt, t_gt) = _dcp(cycle)
    ref = jax_apply(jm, v, src, tgt, t_gt, prefix="val", train=False)
    with torch.no_grad():
        out = tm(t(src), t(tgt), t(t_gt), prefix="val", train=False)
        bare = tm(t(src), t(tgt), None, prefix="test")
    assert_outputs_match(out, ref)
    np.testing.assert_allclose(bare.numpy(), np.asarray(
        jax_apply(jm, v, src, tgt, None, prefix="test")), atol=1e-4)
    assert bare.shape == (B, 4, 4)


def test_dcp_train_loss_and_running_stats_match_jax():
    """A train step's loss and the DGCNN's running statistics after it:
    its BatchNorms run on the source and then on the target, moving the
    statistics twice in both packages."""
    jm, v, tm, (src, tgt, t_gt) = _dcp(cycle=True, seed=1)
    ref, upd = jax_apply(jm, v, src, tgt, t_gt, prefix="train", train=True,
                         mutable=["batch_stats"])
    with torch.no_grad():
        out = tm(t(src), t(tgt), t(t_gt), prefix="train", train=True)
    assert_outputs_match(out, ref)
    assert_same_stats(tm, {"batch_stats": upd["batch_stats"]})
    # the statistics moved: the step is not a no-op
    before = state_from_flax({"batch_stats": v["batch_stats"]}, tm)
    moved = tm.state_dict()["emb_nn.bn0.running_mean"]
    assert not torch.allclose(moved, before["emb_nn.bn0.running_mean"])


def test_dcp_f64_gradient_through_the_svd_matches_jax():
    jm, v, tm, args = _dcp(cycle=True, seed=2)
    f64_grads(jm, v, args, dict(prefix="train", train=True), tm,
              lambda m, a: m(*a, prefix="train", train=True),
              patches=((jdcp, "jnp", JNP_FIRST_MAX),))


def test_dcp_flax_names_and_factory():
    tm = get_model("dcp", cycle=True)
    assert tm.cycle and tm.flax_names == {"DGCNN_0": "emb_nn",
                                          "Pointer_0": "pointer"}
    assert tm.pointer.flax_names == {
        "_EncoderLayer_0": "enc0", "_DecoderLayer_0": "dec0",
        "LayerNorm_0": "enc_norm", "LayerNorm_1": "dec_norm"}
    assert tm.emb_nn.flax_names["BatchNorm_4"] == "proj_bn"
    assert tm.emb_nn.bn0.bias is None
    n = sum(p.numel() for p in tm.parameters())
    src, tgt, t_gt = registration_pair(0, 1, 32)
    jv = jax.eval_shape(lambda: JDCP().init(jax.random.PRNGKey(0), src, tgt,
                                            t_gt))
    assert n == sum(int(np.prod(a.shape)) for a in
                    jax.tree_util.tree_leaves(jv["params"]))
