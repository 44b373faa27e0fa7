"""VRCNet training in the port against the JAX package, on the CPU.

Sizes follow tests/test_torch_vrcnet.py (256 points, coarse_raw 128, layers
1,1,1,1, knn_list 4,8, pk 8, batch 2). Weights are the JAX model's own flax
tree carried across by ``vrcnet_state_from_flax``; the latent noise and the
dropout masks are numpy draws given to both (JAX's ``jax.random.normal`` is
replaced and flax's ``Dropout`` intercepted, the port takes them as
tensors). Before any gradient is compared, both packages must have built the
same geometry (FPS picks, kNN graphs): the picks decide which terms a
gradient has.

The gradient reference is the JAX model run in f64 (``enable_x64``) on the
same f32-valued weights and inputs. In f32, JAX's CPU gradient of the
decoder's U-Net differs from its own f64 gradient by up to 2.3e-3 of a
tensor's largest entry (measured at this size; the three-NN unpooling
weights divide by distances floored at 1e-6), while the port's f32 gradient
stays within 4e-6 of the f64 one, so an f32 reference would only measure
JAX's rounding. Tolerances: 1e-4 relative on the losses; each parameter's
gradient to 1e-4 of that tensor's largest entry.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import linen as nn

from houv_tpu.models import vrcnet as jv
from houv_tpu.ops.emd import emd_auction as jemd_auction
from houv_tpu.train import config as jconfig
from houv_tpu.train import harness as jharness
from houv_tpu.train import schedules as jschedules
from houv_tpu_torch.models import vrcnet as tv
from houv_tpu_torch.ops import emd as temd
from houv_tpu_torch.ops.gather import gather_rows
from houv_tpu_torch.state import vrcnet_state_from_flax
from houv_tpu_torch.train import checkpoint as tcheckpoint
from houv_tpu_torch.train import cli as tcli
from houv_tpu_torch.train import config as tconfig
from houv_tpu_torch.train import harness as tharness
from houv_tpu_torch.train import schedules as tschedules
from houv_tpu_torch.train.submission import read_results_h5
from test_torch_vrcnet import (SMALL, _assert_same_geometry, _cloud, _params,
                               _port, _t)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs one process per core; a thread pool in each would
    make these many small CPU ops wait on one another."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _draws(rng, n_noise, batch=BATCH):
    """Latent noise (n_noise x (B, 128)) and the two dropout keep masks over
    the doubled batch, from numpy."""
    noise = [rng.standard_normal((batch, 128)).astype(np.float32)
             for _ in range(n_noise)]
    masks = [(rng.uniform(size=(2 * batch, w)) >= 0.5).astype(np.float32)
             for w in (512, 1024)]
    return noise, masks


class _JaxRandomness:
    """Feeds JAX the numpy draws: ``jax.random.normal`` returns the noise
    tensors in call order (k1, k2, then k3, k4 with MMD) and every flax
    ``Dropout`` applies the keep mask of its width. ``intercept`` also keeps
    the geometry ``SASKNResEncoder`` was given."""

    def __init__(self, monkeypatch, noise, masks):
        self.noise, self.masks = noise, {m.shape[-1]: m for m in masks}
        self.geo = None
        self._next = iter(())
        monkeypatch.setattr(jax.random, "normal", self._normal)

    def rewind(self):
        self._next = iter(self.noise)

    def _normal(self, key, shape, dtype=None):
        return jnp.asarray(next(self._next), dtype)

    def intercept(self, next_fun, args, kwargs, ctx):
        if ctx.method_name == "__call__":
            if isinstance(ctx.module, jv.SASKNResEncoder):
                self.geo = args[2]
            if isinstance(ctx.module, nn.Dropout):
                x = args[0]
                return x * jnp.asarray(self.masks[x.shape[-1]], x.dtype) / 0.5
        return next_fun(*args, **kwargs)


def _port_geometry(tm):
    seen = {}
    hook = tm.decoder.encoder.register_forward_pre_hook(
        lambda _, args: seen.__setitem__("geo", args[1]))
    return seen, hook


def _share_assignments(monkeypatch):
    """For ``loss: emd``. An auction is chaotic in its inputs: outputs 1e-6
    apart (two packages, or f32 and f64) end 50 rounds of price war in
    assignments that differ at a few points, and each moves one point's
    gradient term. What this file holds is the model's wiring and the EMD
    gradient, so JAX's ``calc_emd`` records the assignment of each of its
    auctions and the port's ``_EmdFunction`` is handed them in order, in
    place of its own auction's (which tests/test_torch_emd.py and
    tests/test_torch_chamfer_grad.py hold against JAX's)."""
    recorded = []

    def jax_calc_emd(output, gt, eps=0.005, iterations=50):
        dist, assignment = jemd_auction(output, gt, eps, iterations)
        recorded.append(assignment)
        return jnp.sqrt(dist).mean(axis=-1)

    def port_auction(x1, x2, eps, iters, device=None):
        assignment = torch.as_tensor(
            np.asarray(port_auction.assignments.pop(0))).long()
        diff = x1 - gather_rows(x2, assignment)
        return (diff * diff).sum(-1), assignment, None, None

    monkeypatch.setattr(jv, "calc_emd", jax_calc_emd)
    monkeypatch.setattr(temd, "emd_auction_with_stats", port_auction)
    return recorded, port_auction


def _train_parity(rng, monkeypatch, **kw):
    """JAX VRCNet (in f64) and the port, prefix 'train', alpha 0.5, on the
    same weights, clouds, noise and masks: (port out, port grads by
    state_dict name), (JAX out, JAX grads carried to those names)."""
    kw = dict(SMALL, **kw)
    recorded = port_auction = None
    if kw["train_loss"] == "emd":
        recorded, port_auction = _share_assignments(monkeypatch)
    x, gt = _cloud(rng, BATCH, 256), _cloud(rng, BATCH, 256)
    noise, masks = _draws(
        rng, 4 if kw.get("distribution_loss") == "MMD" else 2)
    jm = jv.VRCNet(**kw)
    params = _params(jm, jnp.asarray(x), jnp.asarray(gt), "train", 0.5)
    rand = _JaxRandomness(monkeypatch, noise, masks)

    def loss_fn(p, x64, gt64):
        rand.rewind()
        if recorded is not None:
            recorded.clear()
        with nn.intercept_methods(rand.intercept):
            out = jm.apply(p, x64, gt64, prefix="train", alpha=0.5,
                           rngs={"latent": jax.random.PRNGKey(5),
                                 "dropout": jax.random.PRNGKey(6)})
        return out["total_loss"], (out, rand.geo, list(recorded or ()))

    with jax.enable_x64(True):
        def f64(a):
            return jnp.asarray(np.asarray(a), jnp.float64)

        (_, (jout, jgeo, jassign)), jgrads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(
                jax.tree_util.tree_map(f64, params), f64(x), f64(gt))
        jout, jgeo, jgrads = jax.tree_util.tree_map(
            np.asarray, (jout, jgeo, jgrads))
    if port_auction is not None:
        assert len(jassign) == 4
        port_auction.assignments = list(jassign)

    tm = _port(tv.VRCNet(**kw), params)
    seen, hook = _port_geometry(tm)
    try:
        tout = tm(_t(x), _t(gt), "train", alpha=0.5,
                  noise=[_t(n) for n in noise],
                  dropout_masks=[_t(m) for m in masks])
    finally:
        hook.remove()
    _assert_same_geometry(seen["geo"], jgeo)
    tout["total_loss"].backward()
    tgrads = {n: p.grad for n, p in tm.named_parameters()}
    return tout, tgrads, jout, vrcnet_state_from_flax(jgrads, tm)


def _assert_train_parity(tout, tgrads, jout, jgrads, grad_tol=1e-4):
    np.testing.assert_allclose(tout["total_loss"].item(),
                               float(jout["total_loss"]), rtol=1e-4)
    np.testing.assert_allclose(tout["loss2"].detach().numpy(),
                               np.asarray(jout["loss2"]), rtol=1e-4)
    # the fine clouds as point sets (two near-equal scores may swap two rows
    # of the score selection's sorted order): every point of either cloud
    # within 1e-4 of one of the other
    d = torch.cdist(tout["out2"].detach().double(),
                    torch.tensor(np.asarray(jout["out2"])).double())
    assert float(torch.maximum(d.amin(-1).amax(-1),
                               d.amin(-2).amax(-1)).max()) <= 1e-4
    assert set(tgrads) == set(jgrads)
    for name, ref in jgrads.items():
        ours = tgrads[name]
        if ours is None:
            # reached through indices only (the score head feeds a top-k)
            assert not ref.any(), f"{name} got no gradient"
            continue
        scale = float(ref.abs().max())
        np.testing.assert_allclose(ours.numpy(), ref.numpy(), rtol=0,
                                   atol=grad_tol * scale + 1e-12,
                                   err_msg=name)


@pytest.mark.parametrize("kw", [
    dict(distribution_loss="KLD", train_loss="cd"),
    dict(distribution_loss="MMD", train_loss="cd"),
    dict(distribution_loss="KLD", train_loss="emd"),
    # num_coarse 128 < 256 points: the score selection (top-k on learned
    # scores; gradients flow through the gathers) and local folding
    dict(distribution_loss="KLD", train_loss="cd", local_folding=True,
         num_coarse=128),
], ids=["KLD-cd", "MMD-cd", "KLD-emd", "KLD-cd-scores-folding"])
def test_vrcnet_train_loss_and_gradients_match_jax(rng, monkeypatch, kw):
    _assert_train_parity(*_train_parity(rng, monkeypatch, **kw))


def test_use_remat_gives_the_same_loss_and_gradients(rng):
    x, gt = _t(_cloud(rng, BATCH, 256)), _t(_cloud(rng, BATCH, 256))
    noise, masks = _draws(rng, 2)
    runs = []
    for remat in (False, True):
        tm = tv.VRCNet(remat=remat, **SMALL)
        tharness.init_like_flax(tm, torch.Generator().manual_seed(3))
        out = tm(x, gt, "train", alpha=0.1, noise=[_t(n) for n in noise],
                 dropout_masks=[_t(m) for m in masks])
        out["total_loss"].backward()
        runs.append((out["total_loss"].item(),
                     {n: p.grad for n, p in tm.named_parameters()}))
    (loss, grads), (loss_r, grads_r) = runs
    # the recomputed forward repeats the same ops on the same inputs
    assert loss == loss_r
    for name, g in grads.items():
        torch.testing.assert_close(grads_r[name], g, rtol=1e-6, atol=1e-9,
                                   msg=name)


def test_train_randomness_comes_from_the_generator(rng):
    """The same generator seed gives the same loss; another seed another
    one; 'train' with MMD takes four noise tensors."""
    x, gt = _t(_cloud(rng, BATCH, 256)), _t(_cloud(rng, BATCH, 256))
    tm = tv.VRCNet(**SMALL)
    tharness.init_like_flax(tm, torch.Generator().manual_seed(3))

    def loss(seed):
        with torch.no_grad():
            return tm(x, gt, "train", alpha=0.5,
                      generator=torch.Generator().manual_seed(seed)
                      )["total_loss"].item()

    assert loss(1) == loss(1)
    assert loss(1) != loss(2)
    mmd = tv.VRCNet(distribution_loss="MMD", **SMALL)
    with pytest.raises(ValueError, match="4 noise"):
        mmd(x, gt, "train", alpha=0.5, noise=[torch.zeros(BATCH, 128)] * 2)
    with pytest.raises(NotImplementedError):
        tv.VRCNet(distribution_loss="JS", **SMALL)
    with pytest.raises(NotImplementedError):
        tv.VRCNet(train_loss="l2", **SMALL)


# --- the trainer -----------------------------------------------------------

_SMALL_YAML = dict(num_points=256, num_coarse_raw=128, num_fps=256,
                   num_coarse=256, layers="1, 1, 1, 1", knn_list="4, 8", pk=8,
                   batch_size=BATCH, synthetic_size=16, scale_aug=False)


def _raw_cfg(tmp_path, **extra):
    with open(os.path.join(_REPO, "cfgs", "vrcnet.yaml")) as f:
        raw = yaml.safe_load(f)
    raw.update(_SMALL_YAML, work_dir=str(tmp_path), **extra)
    return raw


def _write_cfg(tmp_path, **extra):
    path = tmp_path / "vrcnet_small.yaml"
    path.write_text(yaml.safe_dump(_raw_cfg(tmp_path, **extra)))
    return str(path)


def test_three_train_steps_match_the_jax_trainer(rng, monkeypatch, tmp_path):
    """Three optimizer steps (Adam, lr 1e-3) on one batch: the JAX
    trainer's jitted optax step against the port's ``train_step``, from the
    JAX trainer's own initial weights. Both use one set of noise and masks
    for every step (the JAX step bakes them in when it is traced). The
    first loss is the same forward (1e-5); Adam normalises each entry's
    gradient, so where JAX's f32 gradient is off (see the module's note) an
    entry moves differently by up to the full lr, and the loss, falling
    from 28 to 9 in two updates, differs by 2e-4 at the third step: 5e-4."""
    raw = _raw_cfg(tmp_path, lr=1e-3)
    jcfg = jconfig.Config.from_dict(raw)
    tcfg = tconfig.Config.from_dict(raw)
    batch = {"partial": _cloud(rng, BATCH, 256), "gt": _cloud(rng, BATCH, 256)}
    noise, masks = _draws(rng, 2)

    jtrainer = jharness.CompletionTrainer(jcfg)
    jtrainer.init_state(batch)
    params0 = jax.tree_util.tree_map(np.asarray, jtrainer.state["params"])
    rand = _JaxRandomness(monkeypatch, noise, masks)
    jlosses = []
    with nn.intercept_methods(rand.intercept):
        for step in range(3):
            rand.rewind()
            jlosses.append(float(jtrainer.train_step(batch, 0, step)))

    trainer = tharness.CompletionTrainer(tcfg, "cpu")
    trainer.model.load_state_dict(
        vrcnet_state_from_flax(params0, trainer.model), strict=True)
    forward = trainer.model.forward
    monkeypatch.setattr(
        trainer.model, "forward",
        lambda *a, generator=None, **kw: forward(
            *a, noise=[_t(n) for n in noise],
            dropout_masks=[_t(m) for m in masks], **kw))
    losses = [float(trainer.train_step(batch, 0, step)) for step in range(3)]
    # (a kNN or FPS pick flipped at a near-tie would show in the losses: the
    # jitted step keeps its geometry to itself)
    assert losses[0] != losses[1] != losses[2]
    np.testing.assert_allclose(losses[0], jlosses[0], rtol=1e-5)
    np.testing.assert_allclose(losses, jlosses, rtol=5e-4)


@pytest.mark.parametrize("extra", [
    {},
    dict(lr_decay_interval=None, lr_step_decay_epochs="10, 30, 60",
         lr_step_decay_rates="0.5, 0.5, 0.1", lr_clip=2e-6),
    dict(lr_decay=False, varying_constant=None),
], ids=["vrcnet.yaml", "step-decay", "constant"])
def test_schedules_match_jax_over_100_epochs(tmp_path, extra):
    with open(os.path.join(_REPO, "cfgs", "vrcnet.yaml")) as f:
        raw = dict(yaml.safe_load(f), **extra)
    jcfg = jconfig.Config.from_dict(raw)
    tcfg = tconfig.Config.from_dict(raw)
    assert tcfg.betas == jcfg.betas and tcfg.lr == jcfg.lr
    for epoch in range(100):
        assert tschedules.alpha_schedule(tcfg, epoch) == \
            jschedules.alpha_schedule(jcfg, epoch)
        assert tschedules.lr_schedule(tcfg, epoch) == \
            jschedules.lr_schedule(jcfg, epoch)
    if not extra:
        assert tschedules.alpha_schedule(tcfg, 0) == 0.01
        assert tschedules.alpha_schedule(tcfg, 99) == 1.0
        assert tschedules.lr_schedule(tcfg, 40) == pytest.approx(0.7e-4)


def test_train_step_writes_the_scheduled_lr(tmp_path):
    cfg = tconfig.Config.from_dict(_raw_cfg(tmp_path, lr_decay_interval=1))
    trainer = tharness.CompletionTrainer(cfg, "cpu")
    trainer.init_state()
    ds = tcli.build_dataset(cfg, "train")
    batch = ds.get_batch(np.arange(BATCH))
    before = [p.detach().clone() for p in trainer.model.parameters()]
    for epoch in (0, 3):
        loss = trainer.train_step(batch, epoch, epoch)
        assert torch.isfinite(loss)
        assert trainer.optimizer.param_groups[0]["lr"] == \
            pytest.approx(1e-4 * 0.7 ** epoch)
    for p, b in zip(trainer.model.parameters(), before):
        assert p.grad is not None and torch.isfinite(p.grad).all()
        assert not torch.equal(p.detach(), b)


def test_checkpoint_round_trip(tmp_path):
    cfg = tconfig.Config.from_dict(_raw_cfg(tmp_path))
    trainer = tharness.CompletionTrainer(cfg, "cpu")
    trainer.init_state()
    ds = tcli.build_dataset(cfg, "train")
    batch = ds.get_batch(np.arange(BATCH))
    trainer.train_step(batch, 0, 0)
    trainer.epoch = 7
    path = trainer.save("network.ckpt")
    assert path == os.path.join(trainer.log_dir, "network.ckpt")
    pred = trainer.predict_batch(batch)

    cfg2 = tconfig.Config.from_dict(_raw_cfg(tmp_path, load_model=path))
    again = tharness.CompletionTrainer(cfg2, "cpu")
    again.init_state()
    assert again.epoch == 7
    assert torch.equal(again.predict_batch(batch), pred)
    s1 = trainer.optimizer.state_dict()["state"]
    s2 = again.optimizer.state_dict()["state"]
    assert s1.keys() == s2.keys() and len(s1) > 0
    for k in s1:
        assert torch.equal(s1[k]["exp_avg_sq"], s2[k]["exp_avg_sq"])
    # both continue alike
    l1 = trainer.train_step(batch, 0, 1)
    l2 = again.train_step(batch, 0, 1)
    assert l1.item() == l2.item()

    # a file holding the bare state_dict loads too
    bare = str(tmp_path / "bare.ckpt")
    torch.save(trainer.model.state_dict(), bare)
    fresh = tharness.CompletionTrainer(cfg, "cpu")
    assert tcheckpoint.load_checkpoint(bare, fresh.model) == 0
    assert torch.equal(fresh.predict_batch(batch),
                       trainer.predict_batch(batch))


def test_train_main_on_cpu_writes_checkpoints_test_main_loads(tmp_path):
    """Two epochs of four steps on the synthetic split through the command
    line's entry; ``validate`` writes the best-metric checkpoints, ``fit``
    ``network.ckpt``; the sweep with ``load_model`` completes with the
    trained weights."""
    path = _write_cfg(tmp_path, nepoch=2, batch_size=4)
    out = tcli.main(["train", "-c", path, "--device", "cpu"])
    trainer = out["trainer"]
    assert len(out["losses"]) == 8 and np.isfinite(out["losses"]).all()
    assert out["checkpoint"] == os.path.join(out["log_dir"], "network.ckpt")
    for name in ("network.ckpt", "best_cd_p_network.ckpt",
                 "best_cd_t_network.ckpt", "best_f1_network.ckpt",
                 "train.log"):
        assert os.path.getsize(os.path.join(out["log_dir"], name)) > 0
    assert os.path.basename(out["log_dir"]) == "vrcnet_cd_debug"
    assert trainer.epoch == 1 and trainer.best["cd_p"][1] < float("inf")

    swept = _write_cfg(tmp_path, batch_size=4, load_model=out["checkpoint"])
    res = tcli.main(["-c", swept, "--device", "cpu"])
    results = read_results_h5(res["results_h5"])
    cfg = tconfig.load_config(swept)
    first = tcli.build_dataset(cfg, "test").get_batch(np.arange(4))
    np.testing.assert_array_equal(
        results[:4], trainer.predict_batch(first, step=0).numpy())
    # and not with the seeded initialisation
    cfg.load_model = None
    untrained = tharness.CompletionTrainer(cfg, "cpu")
    untrained.init_state()
    assert not np.array_equal(
        results[:4], untrained.predict_batch(first, step=0).numpy())


def _model_raw_cfg(tmp_path, model, **extra):
    with open(os.path.join(_REPO, "cfgs", f"{model}.yaml")) as f:
        raw = yaml.safe_load(f)
    raw.update(dict(num_points=128, num_coarse=64, batch_size=4,
                    synthetic_size=16, scale_aug=False,
                    work_dir=str(tmp_path)), **extra)
    return raw


@pytest.mark.parametrize("model", ["pcn", "ecg"])
def test_train_main_on_cpu_for_pcn_and_ecg(tmp_path, model):
    """Two epochs of four steps of cfgs/pcn.yaml and cfgs/ecg.yaml at 128
    points through the command line's entry: the checkpoints, a falling
    loss on a repeated batch, and the sweep with ``load_model`` completing
    with the trained weights, bit for bit."""
    path = tmp_path / f"{model}_small.yaml"
    path.write_text(yaml.safe_dump(_model_raw_cfg(tmp_path, model, nepoch=2)))
    out = tcli.main(["train", "-c", str(path), "--device", "cpu"])
    trainer = out["trainer"]
    assert len(out["losses"]) == 8 and np.isfinite(out["losses"]).all()
    assert os.path.basename(out["log_dir"]) == f"{model}_cd_debug"
    for name in ("network.ckpt", "best_cd_p_network.ckpt",
                 "best_cd_t_network.ckpt", "best_f1_network.ckpt",
                 "train.log"):
        assert os.path.getsize(os.path.join(out["log_dir"], name)) > 0
    assert trainer.epoch == 1
    for p in trainer.model.parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all()

    path.write_text(yaml.safe_dump(_model_raw_cfg(
        tmp_path, model, load_model=out["checkpoint"])))
    res = tcli.main(["-c", str(path), "--device", "cpu"])
    results = read_results_h5(res["results_h5"])
    cfg = tconfig.load_config(str(path))
    ds = tcli.build_dataset(cfg, "test")
    first = ds.get_batch(np.arange(4))
    np.testing.assert_array_equal(
        results[:4], trainer.predict_batch(first, step=0).numpy())
    cfg.load_model = None
    untrained = tharness.CompletionTrainer(cfg, "cpu")
    untrained.init_state()
    assert not np.array_equal(
        results[:4], untrained.predict_batch(first, step=0).numpy())

    batch = tcli.build_dataset(cfg, "train").get_batch(np.arange(4))
    untrained.cfg.lr = 1e-3
    losses = [float(untrained.train_step(batch, 0, s)) for s in range(4)]
    assert losses[-1] < losses[0], losses


def test_three_pcn_train_steps_match_the_jax_trainer(rng, tmp_path):
    """Three optimizer steps (Adam, lr 1e-3) of PCN on one batch: the JAX
    trainer's jitted optax step against the port's ``train_step``, from the
    JAX trainer's own initial weights. PCN draws no random numbers and picks
    nothing in its forward; the chamfer matches hold still under 1e-6
    differences, so three steps stay within 1e-4 relative."""
    raw = _model_raw_cfg(tmp_path, "pcn", lr=1e-3, batch_size=BATCH)
    jcfg = jconfig.Config.from_dict(raw)
    tcfg = tconfig.Config.from_dict(raw)
    batch = {"partial": _cloud(rng, BATCH, 128), "gt": _cloud(rng, BATCH, 128)}
    jtrainer = jharness.CompletionTrainer(jcfg)
    jtrainer.init_state(batch)
    params0 = jax.tree_util.tree_map(np.asarray, jtrainer.state["params"])
    jlosses = [float(jtrainer.train_step(batch, 0, s)) for s in range(3)]
    trainer = tharness.CompletionTrainer(tcfg, "cpu")
    trainer.model.load_state_dict(
        vrcnet_state_from_flax(params0, trainer.model), strict=True)
    losses = [float(trainer.train_step(batch, 0, s)) for s in range(3)]
    assert losses[0] != losses[1] != losses[2]
    np.testing.assert_allclose(losses[0], jlosses[0], rtol=1e-5)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)


def test_fit_steps_and_repeated_batch_lowers_the_loss(tmp_path):
    """``fit_steps`` from a loader; twelve steps on one repeated batch end
    below where they started (the JAX package's own training check)."""
    cfg = tconfig.Config.from_dict(_raw_cfg(tmp_path, lr=1e-3))
    trainer = tharness.CompletionTrainer(cfg, "cpu")
    trainer.init_state()
    ds = tcli.build_dataset(cfg, "train")
    batch = ds.get_batch(np.arange(BATCH))

    class Loader:
        calls = 0

        def next_batch(self):
            self.calls += 1
            return batch

    loader = Loader()
    assert trainer.fit_steps(loader, 2, epoch_len=1) is trainer.model
    assert loader.calls == 2
    losses = [float(trainer.train_step(batch, 0, s)) for s in range(12)]
    assert losses[-1] < losses[0], losses


def test_what_training_does_not_run_yet_raises(tmp_path):
    """What the port refuses still raises; what it refused before and runs
    now (``use_native_loader``, item 14; bf16, item 11) runs."""
    cfg = tmp_path / "c.yaml"
    for body, match in ((f"model_name: dcp\nuse_native_loader: true\n"
                         f"native_steps: 1\nnum_points: 32\nbatch_size: 2\n"
                         f"synthetic_size: 4\nwork_dir: {tmp_path}\n",
                         "native"),
                        ("model_name: vrcnet_knn\ndataset: mvp_cp\n"
                         "use_gan: true\n", "batch_stats"),
                        ("model_name: transformer\ndataset: mvp_cp\n"
                         "compute_dtype: bfloat16\n", None)):
        cfg.write_text(body)
        if match is None:
            # bf16 is ported (item 11): the model builds in it
            model = tharness.model_from_config(tconfig.load_config(str(cfg)))
            assert model.regressor.dt == torch.bfloat16
            continue
        if match == "native":
            # the native loader is ported (item 14): one step
            out = tcli.train_main(["-c", str(cfg), "--device", "cpu"])
            assert out["steps"] == 1 and len(out["losses"]) == 1
            continue
        with pytest.raises(NotImplementedError, match=match):
            tcli.train_main(["-c", str(cfg), "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="SGD"):
        tharness.CompletionTrainer(
            tconfig.Config.from_dict(_raw_cfg(tmp_path, optimizer="SGD")),
            "cpu")
    adamw = tharness.CompletionTrainer(
        tconfig.Config.from_dict(_raw_cfg(tmp_path, weight_decay=0.01)),
        "cpu")
    assert isinstance(adamw.optimizer, torch.optim.AdamW)
