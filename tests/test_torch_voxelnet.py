"""The port's voxel encoder (``models/voxelnet.py``) against the JAX
package's, block by block, on the CPU.

Weights and running statistics are drawn with numpy into the flax tree of
the JAX module (kernels N(0, 1/fan_in), biases and means N(0, 0.1²), BN
scales 1 + N(0, 0.1²), variances U(0.5, 1.5)) and carried across by
``state_from_flax``. Sizes follow the JAX package's tests: grids of 5 to
20 cells, 256 points, a few channels.

Tolerances: f32 1e-5 absolute and relative (the same arithmetic summed in
another order); BatchNorm in train mode 1e-5 on the output and on the
moved running statistics. bf16: 99.9% of the outputs within 1e-5 and
every one within a bf16 rounding step (2⁻⁷ relative, 1e-5 absolute): both
packages round the same f32 sums, summed in another order, so a sum within
an f32 ulp of a bf16 rounding edge may round apart (none did on these
inputs: the dense blocks came out bit-equal). Each bf16 check also holds
the port's f32 mode to fail the first bound, so that the rounding is there
(it lies up to 7.5e-3 from JAX's bf16 output, at over half the entries).
Occupancy masks are compared bit for bit.

The JAX dense blocks run op by op: under ``jax.jit`` the CPU compiler
computes a bf16 conv in f32 and drops the rounding of its result that the
JAX code asks for (``_dense_conv``: a bf16 result, then cast to f32), which
the port keeps.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from houv_tpu.models import voxelnet as jv
from houv_tpu.ops import sparse_conv as jsc
from houv_tpu_torch.models import voxelnet as tv
from houv_tpu_torch.ops import sparse_conv as tsc
from houv_tpu_torch.state import state_from_flax

F32 = dict(atol=1e-5, rtol=1e-5)


def bf16_close(ours, ref) -> bool:
    """The bf16 bound of the module's note."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    d = np.abs(ours - ref)
    return bool((d <= 1e-5 + 1e-5 * np.abs(ref)).mean() >= 0.999
                and (d <= 1e-5 + 2.0 ** -7 * np.abs(ref)).all())


def draw_variables(shapes, rng):
    """numpy values for a flax variables tree of ``jax.eval_shape``
    results (see the module's note)."""
    def draw(path, s):
        name = path[-1].key
        if name in ("kernel", "down_kernel"):
            fan_in = int(np.prod(s.shape[:-1]))
            v = rng.standard_normal(s.shape) / np.sqrt(fan_in)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(s.shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, s.shape)
        else:
            v = 0.1 * rng.standard_normal(s.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _variables(module, rng, *args, **kwargs):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args,
                                                **kwargs))
    return draw_variables(shapes, rng)


def _port(module, variables):
    module.load_state_dict(state_from_flax(variables, module), strict=True)
    return module.eval()


def _t(x):
    return torch.tensor(np.asarray(x))


def _grid(rng, b=2, n=256, g=20, c=8):
    """Voxel indices of uniform points on a grid of g and point features:
    (grid_ind (B, N, 3) int32, feats (B, N, C) f32)."""
    x = rng.uniform(-0.5, 0.5, (b, n, 3))
    ind = np.clip(np.floor((x + 0.5) * (g - 1)), 0, g - 1).astype(np.int32)
    return ind, rng.standard_normal((b, n, c)).astype(np.float32)


def _sparse_pair(ind, feats, g):
    """The same SparseGrid in both packages."""
    jsg = jsc.from_point_voxels(jnp.asarray(ind), jnp.asarray(feats), g)
    tsg = tsc.from_point_voxels(_t(ind), _t(feats), g)
    np.testing.assert_array_equal(tsg.coords.numpy(), np.asarray(jsg.coords))
    return jsg, tsg


class _JaxBN(nn.Module):
    """flax BatchNorm through the JAX package's ``_masked_bn``."""

    @nn.compact
    def __call__(self, sg, train: bool):
        return jv._masked_bn(sg, nn.BatchNorm(use_running_average=not train))


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_masked_batchnorm_matches_flax(rng, train):
    """The output over the valid rows (the rest 0) and, in train mode, the
    running statistics after the step: 0.99 · old + 0.01 · the batch's
    biased mean and variance over the valid rows."""
    ind, feats = _grid(rng, c=16)
    feats = feats * 2.0 + 0.5
    jsg, tsg = _sparse_pair(ind, feats, 20)
    jm = _JaxBN()
    variables = _variables(jm, rng, jsg, train)
    out, upd = jax.jit(lambda v, sg: jm.apply(v, sg, train, mutable=[
        "batch_stats"]))(variables, jsg)
    bn = _port(tv.MaskedBatchNorm(16), {
        "params": variables["params"]["BatchNorm_0"],
        "batch_stats": variables["batch_stats"]["BatchNorm_0"]})
    ours = bn(tsg, train)
    np.testing.assert_allclose(ours.features.detach().numpy(),
                               np.asarray(out.features), **F32)
    assert not ours.features[~tsg.mask].any()
    stats = upd["batch_stats"]["BatchNorm_0"]
    for ref, buf in ((stats["mean"], bn.running_mean),
                     (stats["var"], bn.running_var)):
        np.testing.assert_allclose(buf.numpy(), np.asarray(ref), **F32)
    moved = not np.allclose(np.asarray(stats["mean"]), variables[
        "batch_stats"]["BatchNorm_0"]["mean"])
    assert moved == train


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_recon_block_matches_jax(rng, compute_dtype):
    ind, feats = _grid(rng, g=12, c=8)
    jsg, tsg = _sparse_pair(ind, feats, 12)
    lk = jsc.build_lookup(jsg)
    jm = jv.ReconBlock(8, compute_dtype, remat=False)
    variables = _variables(jm, rng, jsg, lk)
    ref = jax.jit(jm.apply)(variables, jsg, lk).features
    tm = _port(tv.ReconBlock(8, 8, compute_dtype), variables)
    ours = tm(tsg, tsc.build_lookup(tsg)).features.detach().numpy()
    np.testing.assert_allclose(ours, np.asarray(ref), **F32)


def _volume(rng, b, shape, c, share=0.6):
    """A dense (B, X, Y, Z, C) volume zero outside a random occupancy."""
    occ = rng.uniform(size=(b, *shape)) < share
    x = rng.standard_normal((b, *shape, c)).astype(np.float32) * occ[..., None]
    return x.astype(np.float32), occ


def _dense_check(ours, ref, f32_ours, compute_dtype):
    ref = np.asarray(ref)
    if compute_dtype is None:
        np.testing.assert_allclose(ours, ref, **F32)
        return
    assert bf16_close(ours, ref), np.abs(ours - ref).max()
    # the port without the rounding lies farther than that from JAX's bf16
    assert not bf16_close(f32_ours, ref)


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("height_pooling", [True, False])
def test_dense_res_block_matches_jax(rng, compute_dtype, height_pooling):
    """The pooled volume, its occupancy (bit for bit) and the pre-pool
    volume, on a 7 x 6 x 5 grid."""
    x, occ = _volume(rng, 2, (7, 6, 5), 8)
    jm = jv.DenseResBlock(8, height_pooling, compute_dtype)
    variables = _variables(jm, rng, jnp.asarray(x), jnp.asarray(occ))
    (jp, jocc), jres = jm.apply(variables, jnp.asarray(x), jnp.asarray(occ))
    outs = {}
    for dt in (compute_dtype, None):
        tm = _port(tv.DenseResBlock(8, 8, height_pooling, dt), variables)
        (tp, tocc), tres = tm(_t(x), _t(occ))
        outs[dt] = (tp.detach().numpy(), tocc.numpy(), tres.detach().numpy())
    tp, tocc, tres = outs[compute_dtype]
    np.testing.assert_array_equal(tocc, np.asarray(jocc))
    assert tp.shape == np.asarray(jp).shape
    _dense_check(tp, jp, outs[None][0], compute_dtype)
    _dense_check(tres, jres, outs[None][2], compute_dtype)


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_dense_recon_block_and_masked_max_match_jax(rng, compute_dtype):
    x, occ = _volume(rng, 2, (5, 5, 5), 8)
    occ[1] = False                       # a cloud with no occupied cell
    jm = jv.DenseReconBlock(8, compute_dtype)
    variables = _variables(jm, rng, jnp.asarray(x), jnp.asarray(occ))
    ref = jm.apply(variables, jnp.asarray(x), jnp.asarray(occ))
    ours = {dt: _port(tv.DenseReconBlock(8, 8, dt), variables)(
        _t(x), _t(occ)).detach() for dt in (compute_dtype, None)}
    _dense_check(ours[compute_dtype].numpy(), ref, ours[None].numpy(),
                 compute_dtype)
    pooled = tv.dense_masked_max(ours[compute_dtype], _t(occ)).numpy()
    ref_pooled = np.asarray(jv.dense_masked_max(ref, jnp.asarray(occ)))
    if compute_dtype is None:
        np.testing.assert_allclose(pooled, ref_pooled, **F32)
    else:
        assert bf16_close(pooled, ref_pooled)
    assert not pooled[1].any()


@pytest.mark.parametrize("shape,stride", [
    ((13, 13, 13), (2, 2, 2)), ((7, 7, 7), (2, 2, 2)),
    ((6, 9, 5), (2, 2, 2)), ((13, 13, 13), (2, 2, 1)),
    ((7, 8, 9), (2, 2, 1))])
def test_occ_downsample_matches_jax(rng, shape, stride):
    """Odd and even grids, stride (2, 2, 2) and (2, 2, 1): bit for bit."""
    occ = rng.uniform(size=(2, *shape)) < 0.15
    ours = tv._occ_downsample(_t(occ), stride).numpy()
    ref = np.asarray(jv._occ_downsample(jnp.asarray(occ), stride))
    assert ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)


def test_sparse_to_dense_matches_jax(rng):
    """``to_dense`` and the occupancy of a grid after a strided conv (a
    masked tail, rows beyond the capacity)."""
    ind, feats = _grid(rng, n=96, g=20, c=5)
    jsg, tsg = _sparse_pair(ind, feats, 20)

    @jax.jit
    def both(sg):
        coords, mask, g = jsc.downsample_sites(sg, (2, 2, 2))
        down = jsc.SparseGrid(sg.features, coords, mask, g)
        return jv.sparse_to_dense(sg), jv.sparse_to_dense(down)

    tcoords, tmask, tg, _ = tsc.downsample_sites(tsg, (2, 2, 2))
    tdown = tsc.SparseGrid(tsg.features, tcoords, tmask, tg)
    for (jd, jocc), t in zip(both(jsg), (tsg, tdown)):
        td, tocc = tv.sparse_to_dense(t)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(tocc.numpy(), np.asarray(jocc))


@functools.lru_cache(maxsize=None)
def _jax_encoder(dense_from: int):
    """JAX's Asymm3DSpconv (init 4, grid 20, f32) on fixed inputs: the
    variables, the train output with its moved statistics and, with the
    dense level, the f32 gradients of the train output's sum (the sparse
    levels' gradients are held in f64 in tests/test_torch_vrcnet_knn.py),
    and the eval output."""
    rng = np.random.default_rng(17)
    ind, feats = _grid(rng, c=32)
    jm = jv.Asymm3DSpconv(init_size=4, grid_size=20, dense_from=dense_from,
                          compute_dtype=None)
    variables = _variables(jm, rng, jnp.asarray(ind), jnp.asarray(feats),
                           True)

    @jax.jit
    def run(v):
        def train_sum(p):
            out, upd = jm.apply({"params": p,
                                 "batch_stats": v["batch_stats"]},
                                ind, feats, True, mutable=["batch_stats"])
            return out.sum(), (out, upd)

        if not dense_from:
            _, (out, upd) = train_sum(v["params"])
            return out, upd, None, jm.apply(v, ind, feats, False)
        (_, (out, upd)), grads = jax.value_and_grad(
            train_sum, has_aux=True)(v["params"])
        return out, upd, grads, jm.apply(v, ind, feats, False)

    out = jax.tree_util.tree_map(np.asarray, run(variables))
    return ind, feats, variables, out


@pytest.mark.parametrize("dense_from", [13, 0], ids=["dense13", "sparse"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_asymm3d_spconv_matches_jax(dense_from, train):
    """The whole encoder at grid 20 (20 -> 10 -> 5: the third level dense at
    ``dense_from`` 13, sparse at 0): the (B, 8 · init) feature; in train
    mode also the moved running statistics of the context block's four
    BatchNorms and, with the dense level, every parameter's gradient of the
    feature's sum, to 1e-4 of that tensor's largest entry."""
    ind, feats, variables, (out, upd, grads, out_eval) = _jax_encoder(
        dense_from)
    tm = _port(tv.Asymm3DSpconv(32, 4, 20, dense_from, None), variables)
    assert tm.dense == (dense_from == 13)
    ours = tm(_t(ind), _t(feats), train)
    np.testing.assert_allclose(ours.detach().numpy(),
                               out if train else out_eval, **F32)
    sites = [s["grid"] for s in tm.sites]
    assert sites == ([10, 5] if tm.dense else [10, 5, 3])
    assert (tm.dense_occupancy is not None) == tm.dense
    if not train:
        for name, buf in tm.named_buffers():
            ref = state_from_flax(variables, tm)[name]
            assert torch.equal(buf, ref), name
        return
    stats = state_from_flax({"params": {}, "batch_stats":
                             upd["batch_stats"]}, tm)
    for name, buf in tm.named_buffers():
        np.testing.assert_allclose(buf.numpy(), stats[name].numpy(), **F32,
                                   err_msg=name)
    if grads is None:
        return
    ours.sum().backward()
    ref_grads = state_from_flax(grads, tm)
    for name, p in tm.named_parameters():
        ref = ref_grads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max() + 1e-12,
                                   err_msg=name)
