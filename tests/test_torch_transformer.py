"""The port's transformer completion model (``models/embedding.py``:
``TransformerRegressor``, ``TransformerCompletion``) against the JAX
package, on the CPU, on drawn weights and on the trained checkpoint in
``log/transformer_cd_debug/``.

Drawn weights: batch 2, 256 points, 64 latent points (d 256, 4 heads, two
blocks, as the yaml's model), numpy draws in the flax tree carried across
by ``state_from_flax``. The trained checkpoint: 2 clouds of 2048 points at
the yaml's width, read by the JAX package's flax and by the port's own
msgpack reader through ``load_model``. Both packages must first pick the
same FPS latent points.

Tolerances: coordinates 1e-4 absolute, cd_p, cd_t and the train loss 1e-4
relative, f1 exactly (a count of distances under a threshold; none lies
within rounding of it here).
"""

import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from houv_tpu.models.embedding import TransformerCompletion as JTransformer
from houv_tpu.ops.sampling import furthest_point_sample as jfps
from houv_tpu_torch.models import get_model
from houv_tpu_torch.models.embedding import TransformerCompletion
from houv_tpu_torch.ops.sampling import furthest_point_sample
from houv_tpu_torch.train import config as tconfig
from houv_tpu_torch.train import harness as tharness
from test_torch_dcp import flax_variables, jax_apply, ported, t

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(_REPO, "log", "transformer_cd_debug",
                    "best_cd_p_network.ckpt")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs one process per core."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _clouds(seed, b, n):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.5, 0.5, (b, n, 3)).astype(np.float32)
    gt = rng.uniform(-0.5, 0.5, (b, n, 3)).astype(np.float32)
    return x, gt


def _same_fps(x, k):
    np.testing.assert_array_equal(
        furthest_point_sample(t(x), k, device="cpu").numpy(),
        np.asarray(jfps(jnp.asarray(x), k)))


def test_transformer_matches_jax_in_every_mode():
    x, gt = _clouds(0, 2, 256)
    _same_fps(x, 64)
    jm = JTransformer(num_points=256, num_latent=64)
    v = flax_variables(jm, x, gt, seed=1)
    tm = ported(TransformerCompletion(num_points=256, num_latent=64), v)
    with torch.no_grad():
        res = tm(t(x), prefix="test")["result"]
        val = tm(t(x), t(gt), prefix="val")
        train = tm(t(x), t(gt), prefix="train", alpha=0.5)
    ref = jax_apply(jm, v, x, prefix="test")["result"]
    np.testing.assert_allclose(res.numpy(), np.asarray(ref), atol=1e-4)
    assert res.shape == (2, 256, 3)
    jval = jax_apply(jm, v, x, gt, prefix="val")
    for k in ("cd_p", "cd_t"):
        np.testing.assert_allclose(val[k].numpy(), np.asarray(jval[k]),
                                   rtol=1e-4)
    np.testing.assert_array_equal(val["f1"].numpy(), np.asarray(jval["f1"]))
    jtrain = jax_apply(jm, v, x, gt, prefix="train")
    np.testing.assert_allclose(float(train["total_loss"]),
                               float(jtrain["total_loss"]), rtol=1e-4)
    np.testing.assert_allclose(train["loss2"].numpy(),
                               np.asarray(jtrain["loss2"]), rtol=1e-4)
    # 2048 / 256 latent points: each repeated 8 times beside the offsets
    # -0.05 .. 0.05; 256 / 64 here: 4 times
    grid = tm.regressor.grid[:4, 0].numpy()
    np.testing.assert_allclose(grid, np.linspace(-0.05, 0.05, 4), atol=1e-9)
    with pytest.raises(ValueError, match="'train', 'val' or 'test'"):
        tm(t(x), prefix="fit")


def test_trained_checkpoint_gives_jax_result_at_full_width(tmp_path):
    """``load_model`` takes the JAX package's checkpoint (a flax msgpack
    file): the port's trainer maps its parameters, restores its epoch and
    completes 2 clouds of 2048 points as the JAX model does on them."""
    x, _ = _clouds(2, 2, 2048)
    _same_fps(x, 256)
    with open(CKPT, "rb") as f:
        tree = flax.serialization.msgpack_restore(f.read())
    ref = jax_apply(JTransformer(num_points=2048), {"params": tree["params"]},
                    jnp.asarray(x), prefix="test")["result"]
    with open(os.path.join(_REPO, "cfgs", "transformer.yaml")) as f:
        raw = yaml.safe_load(f)
    raw.update(load_model=CKPT, work_dir=str(tmp_path))
    cfg = tconfig.Config.from_dict(raw)
    assert cfg.extras == {}
    trainer = tharness.CompletionTrainer(cfg, "cpu")
    trainer.init_state()
    assert isinstance(trainer.model, TransformerCompletion)
    assert trainer.epoch == int(tree["epoch"])
    out = trainer.predict_batch({"partial": x}).numpy()
    assert out.shape == (2, 2048, 3)
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-4)
    # trained, not drawn: the completion lies near the partial cloud's
    # scale, and a model with drawn weights gives another cloud
    fresh = get_model("transformer")
    with torch.no_grad():
        other = fresh(t(x), prefix="test")["result"].numpy()
    assert np.abs(other - out).max() > 1e-2
