"""The port's vrcnet_knn (``models/vrcnet_knn.py``), its data and its
training on the CPU, against the JAX package.

Sizes follow ``tests/test_models.py``'s vrcnet_knn tests: batch 2, 256
points, ``num_coarse`` 128, ``num_fine`` 384 (128 + 256), ``num_native``
256, layers 1,1,1,1, ``knn_list`` 8, ``pk`` 8, grid 20 and
``voxel_init_size`` 16, so that the voxel branch runs sparse at 20³ and
10³ and dense from 5³. Weights and running statistics are numpy draws in
the JAX model's flax tree (``test_torch_voxelnet.draw_variables``) carried
across by ``state_from_flax``; the dropout masks are numpy draws given to
both (flax's ``Dropout`` intercepted). Before outputs are compared, both
packages must have built the same geometry (FPS picks, kNN graphs).

Tolerances: f32 outputs 1e-4 absolute and relative, the loss 1e-5
relative, the running statistics 1e-5 (the same arithmetic summed in
another order); the native cloud, picked by FPS, as a point set (every
point within 1e-4 of one of the other). Gradients against JAX in f64
(JAX's f32 CPU gradient of the U-Net is off by up to 2.3e-3, see
tests/test_torch_train.py), each to 1e-4 of its tensor's largest entry, on
the fully sparse encoder (grid 56: JAX's dense conv casts its result to
f32, so its f64 run needs the sparse levels; the dense level's gradients
are held in tests/test_torch_voxelnet.py). bf16 against JAX's bf16: the
fine cloud to 5e-3 absolute, which the port's f32 mode misses, and the
loss to 2e-3 relative; looser than f32, as JAX's compiled CPU program
computes some of its bf16 layers in f32 and leaves their results unrounded
(see tests/test_torch_voxelnet.py), where the port rounds as the JAX code
asks.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import linen as nn

from houv_tpu.data import MVPCompletionDataset as JDataset
from houv_tpu.data import synthesize_completion_set as jsynth
from houv_tpu.models import vrcnet as jvrc
from houv_tpu.models.vrcnet_knn import VRCNetKNN as JVRCNetKNN
from houv_tpu.train.config import Config as JConfig
from houv_tpu_torch.data import MVPCompletionDataset as TDataset
from houv_tpu_torch.models import get_model
from houv_tpu_torch.models.vrcnet_knn import VRCNetKNN
from houv_tpu_torch.state import state_from_flax
from houv_tpu_torch.train import cli as tcli
from houv_tpu_torch.train import config as tconfig
from houv_tpu_torch.train import harness as tharness
from houv_tpu_torch.train.submission import read_results_h5
from test_torch_voxelnet import draw_variables
from test_torch_vrcnet import _assert_same_geometry

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(num_native=256, num_coarse=128, num_fine=384,
             layers=(1, 1, 1, 1), knn_list=(8,), pk=8, voxel_grid_size=20,
             voxel_init_size=16)
B = 2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs one process per core."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _coords(x, g):
    """The dataset's voxel indices of ``x`` on a grid of g."""
    return TDataset("test", data={"incomplete_pcds": x[:1],
                                  "labels": np.zeros(1)},
                    grid_size=g)._voxel_coords(x)


def _inputs(g=20, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.5, 0.5, (B, 256, 3)).astype(np.float32)
    gt = rng.uniform(-0.5, 0.5, (B, 256, 3)).astype(np.float32)
    masks = [(rng.uniform(size=(B, w)) >= 0.5).astype(np.float32)
             for w in (512, 1024)]
    return dict(x=x, gt=gt, label=np.array([3, 11], np.int32),
                coords=_coords(x, g)), masks


class _Intercept:
    """Every flax ``Dropout`` of a train call applies the numpy keep mask of
    its width, and ``SASKNResEncoder``'s geometry is kept in call order."""

    def __init__(self, masks):
        self.masks = {m.shape[-1]: m for m in masks}
        self.geo = []

    def __call__(self, next_fun, args, kwargs, ctx):
        if ctx.method_name == "__call__":
            if isinstance(ctx.module, jvrc.SASKNResEncoder):
                self.geo.append(args[2])
            if isinstance(ctx.module, nn.Dropout) and \
                    not ctx.module.deterministic:
                x = args[0]
                return x * jnp.asarray(self.masks[x.shape[-1]], x.dtype) / 0.5
        return next_fun(*args, **kwargs)


def _jax_variables(jm, inp, seed=0):
    """Drawn variables, the coarse cloud's layer scaled by 0.3: a coarse
    cloud in MVP's unit cube, like the input beside it (at 3x it spans ±2
    and the expansion form's error, ~1e-7·|a|², flips near-ties in JAX's
    level-0 kNN)."""
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        inp["x"], inp["gt"], inp["label"], inp["coords"], "train"))
    variables = draw_variables(shapes, np.random.default_rng(seed))
    variables["params"]["KNNDecoder_0"]["Dense_2"]["kernel"] *= 0.3
    return variables


@functools.lru_cache(maxsize=None)
def _jax_run(compute_dtype):
    """JAX's vrcnet_knn on the fixed inputs under one jit: the train
    outputs with the moved statistics, then the val and test outputs of the
    drawn variables, and the geometry of each call."""
    inp, masks = _inputs()
    kw = dict(SMALL, compute_dtype=compute_dtype)
    if compute_dtype is None:
        kw["voxel_compute_dtype"] = None
    jm = JVRCNetKNN(**kw)
    variables = _jax_variables(jm, inp)
    icpt = _Intercept(masks)

    @jax.jit
    def run(v):
        icpt.geo.clear()
        with nn.intercept_methods(icpt):
            train, upd = jm.apply(v, inp["x"], inp["gt"], inp["label"],
                                  inp["coords"], "train",
                                  mutable=["batch_stats"],
                                  rngs={"dropout": jax.random.PRNGKey(2)})
            val = jm.apply(v, inp["x"], inp["gt"], inp["label"],
                           inp["coords"], "val")
            test = jm.apply(v, inp["x"], label=inp["label"],
                            coords=inp["coords"], prefix="test")
        return train, upd, val, test, list(icpt.geo)

    out = jax.tree_util.tree_map(np.asarray, run(variables))
    return inp, masks, variables, out


def _t(x):
    return torch.tensor(np.asarray(x))


def _port(variables, **kw):
    tm = VRCNetKNN(**dict(SMALL, **kw))
    tm.load_state_dict(state_from_flax(variables, tm), strict=True)
    return tm.eval()


def _call(tm, inp, prefix, masks=None):
    """The port's outputs and the geometry its encoder was given."""
    seen = {}
    hook = tm.decoder.encoder.register_forward_pre_hook(
        lambda _, args: seen.__setitem__("geo", args[1]))
    try:
        out = tm(_t(inp["x"]), _t(inp["gt"]), prefix,
                 label=_t(inp["label"]), coords=_t(inp["coords"]),
                 dropout_masks=None if masks is None else
                 [_t(m) for m in masks])
    finally:
        hook.remove()
    return out, seen["geo"]


def _as_sets_close(ours, ref, tol=1e-4):
    d = torch.cdist(ours.detach().double(), torch.tensor(ref).double())
    assert float(torch.maximum(d.amin(-1).amax(-1),
                               d.amin(-2).amax(-1)).max()) <= tol


def _close(ours, ref, **tol):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                               **(tol or dict(atol=1e-4, rtol=1e-4)))


def test_vrcnet_knn_test_and_val_outputs_match_jax():
    inp, _, variables, (_, _, val, test, geo) = _jax_run(None)
    tm = _port(variables, voxel_compute_dtype=None)
    with torch.no_grad():
        ours, tgeo = _call(tm, inp, "test")
        _assert_same_geometry(tgeo, geo[2])
        assert ours["result"].shape == (B, 384, 3)
        _close(ours["result"], test["result"])
        ours, tgeo = _call(tm, inp, "val")
    _assert_same_geometry(tgeo, geo[1])
    _close(ours["out1"], val["out1"])
    _as_sets_close(ours["out2"], val["out2"])
    for key in ("cd_p", "cd_t"):
        _close(ours[key], val[key], rtol=1e-5, atol=0)
    # f1 counts points under a threshold: equal on the same clouds
    _close(ours["f1"], val["f1"], rtol=0, atol=1 / 256)
    # eval mode moved no running statistic
    for name, buf in tm.named_buffers():
        assert torch.equal(buf, state_from_flax(variables, tm)[name]), name


def test_vrcnet_knn_train_step_matches_jax():
    """'train': the loss (CD(coarse) + 2·CD(fine) + CD(native)), the fine
    cloud, cd_t of the native cloud, and the voxel branch's running
    statistics after the step."""
    inp, masks, variables, (train, upd, _, _, geo) = _jax_run(None)
    tm = _port(variables, voxel_compute_dtype=None)
    ours, tgeo = _call(tm, inp, "train", masks)
    _assert_same_geometry(tgeo, geo[0])
    np.testing.assert_allclose(ours["total_loss"].item(),
                               float(train["total_loss"]), rtol=1e-5)
    _close(ours["out2"], train["out2"])
    _close(ours["loss2"], train["loss2"], rtol=1e-5, atol=0)
    stats = state_from_flax({"params": {}, "batch_stats":
                             upd["batch_stats"]}, tm)
    assert len(stats) == 8        # the context block's 4 BatchNorms
    for name, buf in tm.named_buffers():
        _close(buf, stats[name], atol=1e-5, rtol=1e-5)


def _max_gaps(tm):
    """Hooks keeping, for the sparse encoder's two max-pooled sites lists,
    the smallest gap between a channel's two largest values, relative."""
    gaps = {}

    def keep(name):
        def hook(_, args, out):
            sg = out[0] if isinstance(out, tuple) else out
            f = torch.where(sg.mask[..., None], sg.features.detach(),
                            torch.tensor(-1e30))
            top = f.topk(2, dim=1).values
            gaps[name] = float(((top[:, 0] - top[:, 1])
                                / top[:, 0].abs()).min())
        return hook

    handles = [tm.voxel.down3.register_forward_hook(keep("down3")),
               tm.voxel.recon.register_forward_hook(keep("recon"))]
    return gaps, handles


def test_vrcnet_knn_gradients_match_jax_in_f64():
    """The train loss's gradient of every parameter on the fully sparse
    encoder (grid 56: 56 -> 28 -> 14 -> 7), against JAX in f64. The
    context block's BatchNorm scales are drawn at 1/20: with random
    weights, a conv of the PCN features' common mode leaves many channels
    nearly constant, which BatchNorm then divides by sqrt(ε) (×316), and at
    scale 1 the leaky-ReLU kinks downstream turn the packages' 1e-6 apart
    inputs into gradients 1% to 12% apart (the port's own gradient moves by
    28% when its point features are nudged by 1e-6). The max over sites
    must also be well clear of a tie (the two largest of every channel
    2e-5 apart, relative, 20 times the packages' difference there)."""
    inp, masks = _inputs(g=56, seed=9)
    kw = dict(SMALL, voxel_grid_size=56, voxel_compute_dtype=None)
    jm = JVRCNetKNN(**kw)
    variables = _jax_variables(jm, inp, seed=3)
    ctx = variables["params"]["Asymm3DSpconv_0"]["ResContextBlock_0"]
    for k in range(4):
        ctx[f"BatchNorm_{k}"]["scale"] *= 0.05
    icpt = _Intercept(masks)

    def loss_fn(p, x, gt):
        icpt.geo.clear()
        with nn.intercept_methods(icpt):
            out, _ = jm.apply({"params": p,
                               "batch_stats": variables["batch_stats"]},
                              x, gt, inp["label"], inp["coords"], "train",
                              mutable=["batch_stats"],
                              rngs={"dropout": jax.random.PRNGKey(2)})
        return out["total_loss"], (out, icpt.geo[0])

    with jax.enable_x64(True):
        def f64(a):
            return jnp.asarray(np.asarray(a), jnp.float64)

        (_, (jout, jgeo)), jgrads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(jax.tree_util.tree_map(
                f64, variables["params"]), f64(inp["x"]), f64(inp["gt"]))
        jout, jgeo, jgrads = jax.tree_util.tree_map(
            np.asarray, (jout, jgeo, jgrads))
    tm = VRCNetKNN(**kw)
    tm.load_state_dict(state_from_flax(variables, tm), strict=True)
    assert not tm.voxel.dense
    gaps, handles = _max_gaps(tm)
    try:
        ours, tgeo = _call(tm, inp, "train", masks)
    finally:
        for h in handles:
            h.remove()
    _assert_same_geometry(tgeo, jgeo)
    assert min(gaps.values()) > 2e-5, gaps
    np.testing.assert_allclose(ours["total_loss"].item(),
                               float(jout["total_loss"]), rtol=1e-5)
    ours["total_loss"].backward()
    ref = state_from_flax(jgrads, tm)
    assert set(ref) == {n for n, _ in tm.named_parameters()}
    for name, p in tm.named_parameters():
        r = ref[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=0,
                                   atol=1e-4 * np.abs(r).max() + 1e-12,
                                   err_msg=name)


def test_vrcnet_knn_bf16_matches_jax_bf16():
    """The yaml's mode: bf16 in the encoder, the U-Net and (by default) the
    voxel branch. The fine cloud within 5e-3 of JAX's bf16 one (3.2e-3
    seen), where the port's f32 mode lies farther (9.8e-3 seen); the train
    loss within 2e-3 relative (5e-4 seen)."""
    inp, masks, variables, (train, _, _, test, geo) = _jax_run("bfloat16")
    tm = _port(variables, compute_dtype="bfloat16")
    f32 = _port(variables, voxel_compute_dtype=None)
    with torch.no_grad():
        ours, tgeo = _call(tm, inp, "test")
        _assert_same_geometry(tgeo, geo[2])
        ref = test["result"]
        _close(ours["result"], ref, atol=5e-3, rtol=0)
        assert np.abs(_call(f32, inp, "test")[0]["result"].numpy()
                      - ref).max() > 5e-3
        loss = _call(tm, inp, "train", masks)[0]["total_loss"].item()
    np.testing.assert_allclose(loss, float(train["total_loss"]), rtol=2e-3)


def test_vrcnet_knn_fused_cd_matches_separate_on_the_port():
    """One chamfer over the stacked, padded and masked clouds gives the
    separate chamfers' loss and gradients."""
    inp, masks = _inputs()
    runs = []
    for fused in (False, True):
        tm = VRCNetKNN(**dict(SMALL, fused_cd=fused))
        tharness.init_like_flax(tm, torch.Generator().manual_seed(4))
        out, _ = _call(tm, inp, "train", masks)
        out["total_loss"].backward()
        runs.append((out, {n: p.grad for n, p in tm.named_parameters()}))
    (sep, gs), (fus, gf) = runs
    torch.testing.assert_close(fus["total_loss"], sep["total_loss"],
                               rtol=1e-6, atol=0)
    torch.testing.assert_close(fus["loss2"], sep["loss2"], rtol=1e-6, atol=0)
    for name, g in gs.items():
        torch.testing.assert_close(gf[name], g, rtol=1e-5,
                                   atol=1e-6 * float(g.abs().max()),
                                   msg=name)


def test_vrcnet_knn_remat_options_give_the_same_loss_and_gradients():
    """``use_remat`` (the SA-SKN encoder) and ``voxel_conv_remat`` (the
    sparse convs) recompute the same ops in the backward; the remat'd
    encoder keeps flax's name for it."""
    inp, masks = _inputs()
    runs = []
    for remat in (False, True):
        tm = VRCNetKNN(**dict(SMALL, remat=remat, voxel_conv_remat=remat))
        tharness.init_like_flax(tm, torch.Generator().manual_seed(4))
        out, _ = _call(tm, inp, "train", masks)
        out["total_loss"].backward()
        runs.append((out["total_loss"].item(),
                     {n: p.grad for n, p in tm.named_parameters()},
                     tm.decoder.flax_names))
    (loss, grads, names), (loss_r, grads_r, names_r) = runs
    assert loss == loss_r
    assert "SASKNResEncoder_0" in names
    assert "CheckpointSASKNResEncoder_0" in names_r
    for name, g in grads.items():
        torch.testing.assert_close(grads_r[name], g, rtol=1e-6, atol=1e-9,
                                   msg=name)


def test_missing_label_and_coords_and_unknown_prefix():
    """No label: class 0. No coords: a zero voxel feature (the voxel
    branch does not run). A prefix the model does not know raises."""
    inp, _ = _inputs()
    tm = VRCNetKNN(**SMALL)
    tharness.init_like_flax(tm, torch.Generator().manual_seed(4))
    x = _t(inp["x"])
    with torch.no_grad():
        zero = tm(x, label=torch.zeros(B, dtype=torch.long),
                  coords=_t(inp["coords"]))["result"]
        torch.testing.assert_close(tm(x, coords=_t(inp["coords"]))["result"],
                                   zero, rtol=0, atol=0)
        tm.voxel.sites = []
        no_vox = tm(x)["result"]
        assert tm.voxel.sites == []
        feat, _ = tm.encoder(x, torch.zeros(B, dtype=torch.long))
        coarse, fine, _ = tm.decoder(torch.cat(
            [feat, feat.new_zeros(B, 128)], -1), x)
        torch.testing.assert_close(no_vox, fine, rtol=0, atol=0)
    with pytest.raises(ValueError, match="'train', 'val' or 'test'"):
        tm(x, prefix="fit")


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_coords_are_bit_equal_to_jax(split):
    """``coords`` of every split (after the scale augmentation in train,
    with the same rng), on grids of 50 and 20, the rest of the batch
    byte-identical too."""
    data = jsynth(3, views_per_model=8, n_partial=64, n_complete=96, seed=7)
    for g in (50, 20):
        kw = dict(data=data, views_per_model=8, with_voxels=True,
                  grid_size=g)
        idx = np.array([0, 5, 7, 20])
        ours = TDataset(split, **kw).get_batch(
            idx, rng=np.random.default_rng(1))
        ref = JDataset(split, **kw).get_batch(
            idx, rng=np.random.default_rng(1))
        assert ours.keys() == ref.keys() and "coords" in ours
        for key in ref:
            assert ours[key].dtype == ref[key].dtype, key
            assert ours[key].tobytes() == ref[key].tobytes(), key
        assert ours["coords"].min() >= 0 and ours["coords"].max() < g
    if split == "train":   # the coords follow the scaled partial
        plain = TDataset(split, data=data, views_per_model=8,
                         with_voxels=True, scale_aug=False).get_batch(
            idx, rng=np.random.default_rng(1))
        assert not np.array_equal(plain["coords"], ours["coords"])


def test_vrcnet_knn_yamls_leave_no_extras_and_parse_like_jax():
    for name in ("vrcnet_knn.yaml", "vrcnet_knn_extratest.yaml"):
        with open(os.path.join(_REPO, "cfgs", name)) as f:
            raw = yaml.safe_load(f)
        ours, ref = tconfig.Config.from_dict(raw), JConfig.from_dict(raw)
        assert ours.extras == {}, name
        for key in raw:
            assert getattr(ours, key) == getattr(ref, key), (name, key)
        assert ours.compute_dtype == "bfloat16" and ours.knn_list == (16,)


_TINY = dict(num_points=256, num_coarse=128, num_fine=384, num_native=256,
             knn_list="8", pk=8, grid_size=20, voxel_init_size=16,
             batch_size=4, synthetic_size=16, scale_aug=True)


def _tiny_yaml(tmp_path, **extra):
    with open(os.path.join(_REPO, "cfgs", "vrcnet_knn.yaml")) as f:
        raw = yaml.safe_load(f)
    raw.update(_TINY, work_dir=str(tmp_path), **extra)
    path = tmp_path / "vrcnet_knn_tiny.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def test_vrcnet_knn_yaml_trains_and_sweeps_on_cpu(tmp_path):
    """A small copy of cfgs/vrcnet_knn.yaml (bf16, as the yaml) through the
    command line: two epochs of four steps, the checkpoints holding the
    BatchNorms' running statistics (moved by the train steps, not by
    validation), reloaded to bit-equal predictions, and ``test_main`` with
    ``load_model`` writing (N, 384, 3) completions."""
    path = _tiny_yaml(tmp_path, nepoch=2)
    out = tcli.main(["train", "-c", path, "--device", "cpu"])
    trainer = out["trainer"]
    assert len(out["losses"]) == 8 and np.isfinite(out["losses"]).all()
    assert os.path.basename(out["log_dir"]) == "vrcnet_knn_cd_debug"
    for name in ("network.ckpt", "best_cd_p_network.ckpt", "train.log"):
        assert os.path.getsize(os.path.join(out["log_dir"], name)) > 0
    saved = torch.load(out["checkpoint"], weights_only=True)["model"]
    bn = "voxel.context.short1_bn.running_mean"
    assert bn in saved and saved[bn].abs().sum() > 0
    assert torch.equal(saved[bn], trainer.model.state_dict()[bn])
    for p in trainer.model.parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all()

    swept = _tiny_yaml(tmp_path, load_model=out["checkpoint"])
    res = tcli.main(["-c", swept, "--device", "cpu"])
    results = read_results_h5(res["results_h5"])
    assert results.shape == (16, 384, 3) and np.isfinite(results).all()
    assert os.path.getsize(res["submission"]) > 0
    cfg = tconfig.load_config(swept)
    first = tcli.build_dataset(cfg, "test").get_batch(np.arange(4))
    assert first["coords"].shape == (4, 256, 3)
    np.testing.assert_array_equal(
        results[:4], trainer.predict_batch(first, step=0).numpy())
    reloaded = tharness.CompletionTrainer(cfg, "cpu")
    reloaded.init_state()
    for name, buf in reloaded.model.named_buffers():
        assert torch.equal(buf, saved[name]), name
    # a validation moves no running statistic
    before = {n: b.clone() for n, b in reloaded.model.named_buffers()}
    reloaded.validate(tcli.build_dataset(cfg, "val"))
    for name, buf in reloaded.model.named_buffers():
        assert torch.equal(buf, before[name]), name


def test_vrcnet_knn_from_config_and_registry():
    cfg = tconfig.Config.from_dict(dict(
        _TINY, model_name="vrcnet_knn", layers="1, 1, 1, 1",
        compute_dtype="bfloat16", fused_cd=True))
    model = tharness.model_from_config(cfg)
    assert isinstance(model, VRCNetKNN) and model.fused_cd
    assert model.encoder.dt == torch.bfloat16
    assert model.voxel.dense and model.voxel.grid_size == 20
    assert isinstance(get_model("vrcnet_knn", **SMALL), VRCNetKNN)


def test_the_bf16_casts_leave_f32_and_f64_runs_as_they_are():
    """The casts back to f32 act in bf16 mode only: without a compute
    dtype the encoder and the U-Net keep their input's dtype (f64 in the
    f64 reference runs), with bf16 they return f32."""
    from houv_tpu_torch.models.pcn import PCNEncoderLabel
    from houv_tpu_torch.models.vrcnet import SASKNResEncoder

    pts = torch.rand(1, 64, 3, dtype=torch.float64) - 0.5
    label = torch.zeros(1, dtype=torch.long)
    for dt, dtype in ((None, torch.float64), ("bfloat16", torch.float32)):
        enc = PCNEncoderLabel(32, dt).to(dtype)
        unet = SASKNResEncoder(3, (4,), 4, 16, (1, 1, 1, 1),
                               compute_dtype=dt).to(dtype)
        x = pts.to(dtype)
        assert [t.dtype for t in enc(x, label)] == [dtype, dtype]
        assert unet(x).dtype == dtype
