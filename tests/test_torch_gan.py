"""The cascade-GAN trainer (``use_gan``) of the port against the JAX
package's ``houv_tpu/train/gan.py`` and ``CompletionTrainer``, on the CPU.

The critic and its LSGAN losses take JAX's ``d_params`` across and give
JAX's scores (1e-5 relative). Three GAN steps of PCN (cfgs/pcn.yaml at 128
points, batch 4, lr 1e-3) run from the JAX trainer's own weights and
critic, the port in f64 against JAX jitted under ``enable_x64`` (PCN's
casts to f32 sent to f64; both chamfers still match and measure in f32,
as their ops cast). The losses agree to 1e-5 relative. Each parameter
moved by up to 3·lr; the critic's moves agree to 1e-2·lr everywhere (the
largest difference measured, 7e-4·lr). The generator's do too, except
where a gradient entry is near zero: there Adam's normalised step follows
the f32 chamfer's last bits, so a few entries differ by up to the 6·lr
two diverging 3-step moves span (measured: at most 9e-5 of a tensor's
entries beyond 1e-2·lr, one at 2.6·lr). So the generator is held to: at
most 1e-3 of a tensor's entries beyond 1e-2·lr, a mean difference within
1e-3·lr, none beyond 6.2·lr. The losses carry the adversarial term: a
step that drops it, flips its sign, or weighs the reconstruction 1%
heavier misses the second step's recon loss by 7e-3, 1e-2 and 7e-3
relative; without the loss checks, the dropped term moves 40% of
decoder.fc1.weight's entries beyond 1e-2·lr.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import houv_tpu.models.pcn as jpcn
from houv_tpu.train import config as jconfig
from houv_tpu.train import gan as jgan
from houv_tpu.train import harness as jharness
from houv_tpu_torch.state import state_from_flax
from houv_tpu_torch.train import cli as tcli
from houv_tpu_torch.train import config as tconfig
from houv_tpu_torch.train import gan as tgan
from houv_tpu_torch.train import harness as tharness

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pcn_raw(tmp_path, **extra):
    with open(os.path.join(_REPO, "cfgs", "pcn.yaml")) as f:
        raw = yaml.safe_load(f)
    raw.update(dict(num_points=128, num_coarse=64, batch_size=4,
                    synthetic_size=16, scale_aug=False, use_gan=True,
                    work_dir=str(tmp_path)), **extra)
    return raw


def _clouds(rng, b=4, n=128):
    return {k: rng.uniform(-0.5, 0.5, (b, n, 3)).astype(np.float32)
            for k in ("partial", "gt")}


def test_critic_and_lsgan_losses_match_jax(rng):
    """``PointDiscriminator`` on JAX's initialised ``d_params`` (two
    clouds of 2048 and of 100 points) and ``lsgan_losses`` on its
    scores: 1e-5 relative."""
    disc = jgan.PointDiscriminator()
    ours = tgan.PointDiscriminator()
    for n in (2048, 100):
        x = rng.uniform(-0.5, 0.5, (3, n, 3)).astype(np.float32)
        params = disc.init(jax.random.PRNGKey(n), jnp.asarray(x))["params"]
        ours.load_state_dict(state_from_flax(
            jax.tree_util.tree_map(np.asarray, params), ours), strict=True)
        ref = np.asarray(disc.apply({"params": params}, jnp.asarray(x)))
        got = ours(torch.as_tensor(x)).detach().numpy()
        assert got.shape == (3,)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    d_fake, d_real = rng.standard_normal((2, 6)).astype(np.float32)
    ref = jgan.lsgan_losses(jnp.asarray(d_fake), jnp.asarray(d_real))
    got = tgan.lsgan_losses(torch.as_tensor(d_fake), torch.as_tensor(d_real))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.item(), float(r), rtol=1e-6)
    assert tgan.gan_crop(16384) == 2048 and tgan.gan_crop(128) == 128


class _F64:
    """``jnp`` with ``float32`` read as ``float64``: JAX's PCN casts its
    features to f32 by name, which would keep the reference in f32."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _assert_moves_close(ours: dict, ref: dict, init: dict, tight: bool):
    """Parameter by parameter: the port's ``ours`` against JAX's ``ref``,
    both ``init`` moved by 3 Adam steps at lr ``LR`` (see the module's
    note)."""
    assert ours.keys() == ref.keys()
    for name, r in ref.items():
        o = ours[name].detach().numpy()
        r = r.numpy()
        assert np.abs(r - init[name].numpy()).max() <= 3.1 * LR, name
        d = np.abs(o - r)
        off = d > 1e-2 * LR
        if tight:
            assert not off.any(), (name, d.max() / LR)
        else:
            assert off.mean() <= 1e-3, (name, off.sum())
            assert d.mean() <= 1e-3 * LR, (name, d.mean() / LR)
            assert d.max() <= 6.2 * LR, (name, d.max() / LR)


def test_three_gan_steps_match_the_jax_trainer(rng, monkeypatch, tmp_path):
    """Three GAN steps of ``CompletionTrainer(use_gan=True)`` on one batch,
    the port against the JAX trainer (tolerances in the module's note):
    ``recon_loss``, the critic's loss, and both parameter sets."""
    raw = _pcn_raw(tmp_path, lr=LR)
    jcfg = jconfig.Config.from_dict(raw)
    batch = _clouds(rng)
    jt = jharness.CompletionTrainer(jcfg)
    jt.init_state(batch)
    params0 = jax.tree_util.tree_map(np.asarray, jt.state["params"])
    d_params0 = jax.tree_util.tree_map(np.asarray, jt.state["d_params"])
    step = jgan.make_gan_step(jt.model, jt.disc, jt.opt, jt.d_opt,
                              gen_weight=jcfg.gan_weight, crop=128)
    d_losses = []

    def recording_step(*args):
        out = step(*args)
        d_losses.append(float(out[-1]["d_loss"]))
        return out

    jt._gan_step = recording_step
    monkeypatch.setattr(jpcn, "jnp", _F64())
    b64 = {k: v.astype(np.float64) for k, v in batch.items()}
    with jax.enable_x64(True):
        def f64(tree):
            return jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64), tree)

        p, d = f64(params0), f64(d_params0)
        jt.state.update(params=p, d_params=d, opt_state=jt.opt.init(p),
                        d_opt_state=jt.d_opt.init(d))
        jlosses = [float(jt.train_step(b64, 0, s)) for s in range(3)]
        jparams, jd_params = jax.tree_util.tree_map(
            np.asarray, (jt.state["params"], jt.state["d_params"]))

    trainer = tharness.CompletionTrainer(tconfig.Config.from_dict(raw), "cpu")
    trainer.init_state()
    init = state_from_flax(params0, trainer.model)
    d_init = state_from_flax(d_params0, trainer.critic)
    trainer.model.load_state_dict(init, strict=True)
    trainer.critic.load_state_dict(d_init, strict=True)
    trainer.model.double()
    trainer.critic.double()
    losses, critic_losses = [], []
    for s in range(3):
        losses.append(float(trainer.train_step(b64, 0, s)))
        critic_losses.append(float(trainer.critic_loss))
    assert losses[0] != losses[1] != losses[2]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    np.testing.assert_allclose(critic_losses, d_losses, rtol=1e-5)
    _assert_moves_close(dict(trainer.model.named_parameters()),
                        state_from_flax(jparams, trainer.model), init,
                        tight=False)
    _assert_moves_close(dict(trainer.critic.named_parameters()),
                        state_from_flax(jd_params, trainer.critic), d_init,
                        tight=True)
    # the critic's Adam runs at the constant lr, never scheduled
    assert trainer.critic_optimizer.param_groups[0]["lr"] == LR
    assert trainer.critic_optimizer.param_groups[0]["weight_decay"] == 0


def test_the_critic_sees_the_ground_truth_repeated_whole(tmp_path):
    """VRCNet's train step returns a fine cloud of twice the batch (its
    two paths): the critic's real batch is the ground truth concatenated
    twice (``torch.cat``, as JAX's ``jnp.concatenate``), and its fake
    batch the generator's own fine cloud, the same one it scored."""
    with open(os.path.join(_REPO, "cfgs", "vrcnet.yaml")) as f:
        raw = yaml.safe_load(f)
    raw.update(num_points=64, num_coarse_raw=32, num_fps=64, num_coarse=64,
               layers="1, 1, 1, 1", knn_list="4", pk=4, batch_size=2,
               use_gan=True, work_dir=str(tmp_path))
    trainer = tharness.CompletionTrainer(tconfig.Config.from_dict(raw), "cpu")
    trainer.init_state()
    seen = []
    trainer.critic.register_forward_pre_hook(
        lambda _, args: seen.append(args[0].detach().clone()))
    rng = np.random.default_rng(0)
    batch = _clouds(rng, 2, 64)
    loss = trainer.train_step(batch, 0, 0)
    assert torch.isfinite(loss) and torch.isfinite(trainer.critic_loss)
    fake_g, fake_d, real = seen
    assert fake_g.shape == (4, 64, 3)
    assert torch.equal(fake_g, fake_d)
    gt = torch.as_tensor(batch["gt"])
    assert torch.equal(real, torch.cat([gt, gt]))


def test_use_gan_refuses_batch_stats_and_round_trips_its_checkpoint(
        tmp_path):
    """vrcnet_knn (BatchNorm statistics) is refused with JAX's message. A
    GAN checkpoint holds the critic and its Adam state beside the model's;
    ``load_model`` restores the model and its optimizer, and the critic
    starts from its initialisation, as in the JAX package."""
    knn = dict(model_name="vrcnet_knn", num_points=256, num_coarse=128,
               num_fine=384, num_native=256, knn_list="8", pk=8,
               grid_size=20, voxel_init_size=16, use_gan=True)
    with pytest.raises(NotImplementedError,
                       match="use_gan supports models without batch_stats"):
        tharness.CompletionTrainer(tconfig.Config.from_dict(knn), "cpu")

    cfg = tconfig.Config.from_dict(_pcn_raw(tmp_path))
    trainer = tharness.CompletionTrainer(cfg, "cpu")
    trainer.init_state()
    fresh = {k: v.clone() for k, v in trainer.critic.state_dict().items()}
    batch = _clouds(np.random.default_rng(1))
    trainer.train_step(batch, 0, 0)
    trainer.epoch = 3
    path = trainer.save("network.ckpt")
    state = torch.load(path, weights_only=True)
    assert set(state) == {"model", "optimizer", "epoch", "critic",
                          "critic_optimizer"}
    for k, v in trainer.critic.state_dict().items():
        assert torch.equal(state["critic"][k], v)
        assert not torch.equal(v, fresh[k])
    assert len(state["critic_optimizer"]["state"]) == 10

    again = tharness.CompletionTrainer(tconfig.Config.from_dict(
        _pcn_raw(tmp_path, load_model=path)), "cpu")
    again.init_state()
    assert again.epoch == 3
    for k, v in again.model.state_dict().items():
        assert torch.equal(v, trainer.model.state_dict()[k])
    for k, v in again.critic.state_dict().items():
        assert torch.equal(v, fresh[k])
    assert not again.critic_optimizer.state


def test_train_main_trains_with_use_gan_on_the_cpu(tmp_path):
    """``train -c`` on a small PCN yaml with ``use_gan: true``: two epochs
    of four GAN steps, the checkpoints (the critic in them), and ten GAN
    steps on one repeated batch lower the completion loss."""
    path = tmp_path / "pcn_gan.yaml"
    path.write_text(yaml.safe_dump(_pcn_raw(tmp_path, nepoch=2)))
    out = tcli.main(["train", "-c", str(path), "--device", "cpu"])
    trainer = out["trainer"]
    assert len(out["losses"]) == 8 and np.isfinite(out["losses"]).all()
    assert "critic" in torch.load(out["checkpoint"], weights_only=True)
    assert os.path.getsize(os.path.join(out["log_dir"],
                                        "best_cd_p_network.ckpt")) > 0
    batch = tcli.build_dataset(trainer.cfg, "train").get_batch(np.arange(4))
    trainer.cfg.lr = 1e-3
    losses = [float(trainer.train_step(batch, 0, s)) for s in range(10)]
    assert losses[-1] < losses[0], losses
    assert np.isfinite(float(trainer.critic_loss))
