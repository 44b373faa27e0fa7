"""The port's learned registration trainer and the CLI paths of the
learned models (``train/harness.py:RegistrationTrainer``,
``train/cli.py``: ``make_trainer``, ``train_main``,
``_learned_registration_sweep``), on the CPU at small sizes.

``train -c`` on a small copy of a yaml writes ``network.ckpt`` and the
five ``best_<metric>_network.ckpt`` (RotE, transE, MSE, RMSE lower is
better, recall higher), then the sweep with ``load_model`` set writes the
(N, 4, 4) transforms of the trained weights, its tail batch padded (10
pairs at batch 4); likewise the transformer's (N, num_points, 3)
completions.
The yamls of the four models leave no key in ``extras``, and what the port
does not run yet still raises, citing its ROADMAP item.
"""

import os

import numpy as np
import pytest
import torch
import yaml

from houv_tpu_torch.models import get_model
from houv_tpu_torch.train import cli as tcli
from houv_tpu_torch.train import config as tconfig
from houv_tpu_torch.train import harness as tharness
from houv_tpu_torch.train.submission import read_results_h5

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRICS = ("RotE", "transE", "MSE", "RMSE", "recall")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs one process per core."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _yaml(tmp_path, name, **extra):
    with open(os.path.join(_REPO, "cfgs", name)) as f:
        raw = yaml.safe_load(f)
    raw.update(work_dir=str(tmp_path / "work"), **extra)
    path = tmp_path / f"{len(list(tmp_path.iterdir()))}_{name}"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


SMALL = {"idam.yaml": dict(num_points=96, descriptor_size=16),
         "deepgmr.yaml": dict(num_points=64, rri_size=8)}


@pytest.mark.parametrize("name", ["idam.yaml", "deepgmr.yaml"])
def test_train_then_sweep_learned_registration(tmp_path, name):
    path = _yaml(tmp_path, name, batch_size=4, synthetic_size=8, nepoch=2,
                 **SMALL[name])
    out = tcli.main(["train", "-c", path, "--device", "cpu"])
    trainer = out["trainer"]
    assert isinstance(trainer, tharness.RegistrationTrainer)
    assert len(out["losses"]) == 4 and np.isfinite(out["losses"]).all()
    files = set(os.listdir(out["log_dir"]))
    assert {f"best_{m}_network.ckpt" for m in METRICS} | {
        "network.ckpt"} <= files
    assert set(trainer.best) == set(METRICS)
    # recall is kept at its highest, the errors at their lowest
    assert trainer.best["recall"][1] >= 0.0
    path = _yaml(tmp_path, name, batch_size=4, synthetic_size=10,
                 load_model=out["checkpoint"], **SMALL[name])
    res = tcli.main(["-c", path, "--device", "cpu"])
    results = read_results_h5(res["results_h5"])
    assert results.shape == (10, 4, 4) and res["n_pairs"] == 10
    assert os.path.exists(res["submission"])
    np.testing.assert_allclose(results[:, 3], np.tile([0, 0, 0, 1.0],
                                                      (10, 1)))
    rot = results[:, :3, :3]
    np.testing.assert_allclose(rot @ rot.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), rot.shape),
                               atol=1e-5)
    # the sweep ran the trained weights: a trainer loading the checkpoint
    # predicts the first batch alike
    cfg = tconfig.load_config(path)
    again = tcli.make_trainer(cfg, "cpu")
    again.init_state()
    first = tcli.build_dataset(cfg, "test").get_batch(np.arange(4))
    np.testing.assert_allclose(again.predict_batch(first).numpy(),
                               results[:4], atol=1e-6)


def test_validate_meters_and_buckets(tmp_path):
    """``validate``'s five meters are the pair means of the model's own
    outputs, over whole batches; a metric that improved writes its best
    checkpoint."""
    path = _yaml(tmp_path, "deepgmr.yaml", batch_size=4, synthetic_size=8,
                 synthetic_shape="structured", **SMALL["deepgmr.yaml"])
    cfg = tconfig.load_config(path)
    trainer = tcli.make_trainer(cfg, "cpu")
    trainer.init_state()
    ds = tcli.build_dataset(cfg, "val")
    got = trainer.validate(ds, epoch=3)
    batch = ds.get_batch(np.arange(8))
    with torch.no_grad():
        out = trainer.model(torch.tensor(batch["src"]),
                            torch.tensor(batch["tgt"]),
                            torch.tensor(batch["transform"]), prefix="val")
    want = {"RotE": out["r_err"], "transE": out["t_err"],
            "MSE": out["rt_mse"], "RMSE": out["rmse"],
            "recall": (out["rmse"] < 0.1).float()}
    for m in METRICS:
        assert got[m] == pytest.approx(float(want[m].mean()), rel=1e-5)
        assert trainer.best[m] == (3, got[m])
        assert os.path.exists(os.path.join(trainer.log_dir,
                                           f"best_{m}_network.ckpt"))
    assert "rot_level" in batch and "match_level" in batch


def test_repeated_batch_loss_falls_and_generator_is_the_step_s(tmp_path):
    path = _yaml(tmp_path, "deepgmr.yaml", batch_size=4, synthetic_size=8,
                 use_rri=False, lr=1e-3, num_points=64)
    cfg = tconfig.load_config(path)
    trainer = tcli.make_trainer(cfg, "cpu")
    trainer.init_state()
    batch = tcli.build_dataset(cfg, "train").get_batch(
        np.arange(4), rng=np.random.default_rng(0))
    losses = [float(trainer.train_step(batch, 0, s)) for s in range(8)]
    assert losses[-1] < losses[0], losses
    idam = tcli.make_trainer(tconfig.load_config(_yaml(
        tmp_path, "idam.yaml", **SMALL["idam.yaml"])), "cpu")
    assert set(idam._rng(torch.Generator())) == {"generator"}
    assert trainer._rng(torch.Generator()) == {}


def test_transformer_train_then_sweep(tmp_path):
    path = _yaml(tmp_path, "transformer.yaml", num_points=256, batch_size=4,
                 synthetic_size=16, nepoch=1)
    out = tcli.main(["train", "-c", path, "--device", "cpu"])
    assert isinstance(out["trainer"], tharness.CompletionTrainer)
    assert {"best_cd_p_network.ckpt", "best_cd_t_network.ckpt",
            "best_f1_network.ckpt"} <= set(os.listdir(out["log_dir"]))
    path = _yaml(tmp_path, "transformer.yaml", num_points=256, batch_size=4,
                 synthetic_size=8, load_model=out["checkpoint"])
    res = tcli.main(["-c", path, "--device", "cpu"])
    assert read_results_h5(res["results_h5"]).shape == (res["n_clouds"],
                                                        256, 3)


@pytest.mark.parametrize("name", ["dcp.yaml", "deepgmr.yaml", "idam.yaml",
                                  "transformer.yaml"])
def test_learned_yamls_leave_no_extras(name):
    cfg = tconfig.load_config(os.path.join(_REPO, "cfgs", name))
    assert cfg.extras == {}
    model = tharness.model_from_config(cfg)
    assert type(model) is type(get_model(cfg.model_name))


@pytest.mark.parametrize("body,match", [
    ("model_name: model_embedding\ndataset: mvp_cp\ncompute_dtype: bfloat16\n"
     "num_points: 64\n", None),
    ("model_name: voxel_asym\ndataset: mvp_cp\ncompute_dtype: bfloat16\n"
     "num_points: 64\ngrid_size: 12\n", None),
    ("model_name: dcp\ndataset: mvp_rg\nuse_native_loader: true\n"
     "native_steps: 2\nnum_points: 64\n", "native"),
    ("model_name: transformer\ndataset: mvp_cp\ncompute_dtype: bfloat16\n"
     "num_points: 64\n", None),
])
def test_what_is_not_ported_still_raises(tmp_path, body, match):
    """What the port refused runs now: the models whose bf16 mode it
    refused (item 11) build and take a step in bf16 on the CPU, and
    ``use_native_loader`` (item 14) trains ``native_steps`` steps."""
    from test_torch_completion import one_bf16_step

    cfg = tmp_path / "c.yaml"
    cfg.write_text(body + f"work_dir: {tmp_path}\nbatch_size: 4\n"
                   "synthetic_size: 8\n")
    if match is None:
        one_bf16_step(str(cfg))
        return
    out = tcli.train_main(["-c", str(cfg), "--device", "cpu"])
    assert out["steps"] == 2 and len(out["losses"]) == 2
