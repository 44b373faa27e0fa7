"""Registration's quality modes through the port's CLI, on the CPU: the
meters of ``houv_eval_main`` (``utils/meters.py:SplitMeterGrid`` against the
JAX package's), the evaluation itself (``train -c`` with a houv yaml), the
config keys of the rescored mode, and small copies of
``cfgs/houv_quality.yaml`` and ``cfgs/houv_rescore.yaml`` through
``test_main`` (the rescored one with the trained classifier in ``log/``).
"""

import os

import numpy as np
import pytest
import torch
import yaml

from houv_tpu.train.config import load_config as j_load_config
from houv_tpu.utils.meters import SplitMeterGrid as JSplitMeterGrid
from houv_tpu_torch.train import cli as tcli
from houv_tpu_torch.train.config import load_config
from houv_tpu_torch.train.submission import read_results_h5
from houv_tpu_torch.utils.meters import SplitMeterGrid

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CKPT = os.path.join(_REPO, "log", "alignment_spconv_cd_rescorer_pool",
                     "best_acc_network.ckpt")
_METERS = ("RotE", "transE", "MSE", "RMSE", "recall", "GeoE")


def test_split_meter_grid_matches_jax(rng):
    ours = SplitMeterGrid(metrics=_METERS)
    ref = JSplitMeterGrid(metrics=_METERS)
    for n in (7, 1, 12):            # batches, one of them a single pair
        rot = rng.integers(0, 2, n)
        match = rng.integers(0, 2, n)
        vals = {m: rng.uniform(0, 5, n).astype(np.float32) for m in _METERS}
        ours.update(rot, match, vals)
        ref.update(rot, match, vals)
    assert list(ours.logs()) == list(ref.logs())
    for i in range(2):
        for j in range(2):
            for m in _METERS:
                assert ours.grid[i][j][m].count == ref.grid[i][j][m].count
                assert ours.grid[i][j][m].avg == ref.grid[i][j][m].avg
    ours.reset()
    assert all(m.count == 0 for row in ours.grid for meters in row
               for m in meters.values())


def _small(tmp_path, name, **extra):
    """A CPU-sized copy of cfgs/<name>: 8 restarts, 128 points, 10 steps,
    the split cut to 4 structured pairs."""
    with open(os.path.join(_REPO, "cfgs", name)) as f:
        raw = yaml.safe_load(f)
    raw.update(num_points=128, kernel=8, num_epochs=10, batch_size=4,
               synthetic_size=4, synthetic_shape="structured",
               work_dir=str(tmp_path / "work"))
    if raw.get("nn_refresh_schedule"):
        raw["nn_refresh_schedule"] = "4:2:4,4:2:2,2:2"
    if raw.get("rescore_ckpt"):
        raw["rescore_ckpt"] = _CKPT
    raw.update(extra)
    path = tmp_path / name
    path.write_text(yaml.safe_dump(raw))
    return str(path)


@pytest.mark.parametrize("name", ["houv_quality.yaml", "houv_rescore.yaml",
                                  "houv_extratest_rescore.yaml"])
def test_quality_yamls_parse_as_in_jax(name):
    path = os.path.join(_REPO, "cfgs", name)
    cfg, jcfg = load_config(path), j_load_config(path)
    for key in ("use_view_loss", "retry_mode", "rescore_ckpt", "grid_size",
                "rescore_cands", "rescore_angle", "rescore_margin",
                "rescore_tta", "nn_refresh_schedule", "angle_passes"):
        assert getattr(cfg, key) == getattr(jcfg, key), key
    assert not set(cfg.extras) & {"grid_size", "rescore_cands",
                                  "rescore_angle", "rescore_margin",
                                  "rescore_tta"}
    scfg = tcli.solver_config(cfg)
    assert scfg.use_view_loss == (name == "houv_quality.yaml")


def test_quality_and_rescore_sweeps_run_on_the_cpu(tmp_path):
    out = tcli.test_main(["-c", _small(tmp_path, "houv_quality.yaml"),
                          "--device", "cpu"])
    assert out["n_pairs"] == 4 and out["n_retry"] == 4
    assert "rescore" not in out
    out = tcli.test_main(["-c", _small(tmp_path, "houv_rescore.yaml",
                                       grid_size=12), "--device", "cpu"])
    diag = out["rescore"]
    assert diag["cand_logits"].shape == (4, 16)
    assert np.isfinite(diag["cand_logits"]).all()
    assert out["n_override"] == int((diag["pick"] != 0).sum())
    assert out["classifier_calls"] == 4           # 4 pairs x 16, 16 a call
    assert out["pool_seconds"] > 0 and out["score_seconds"] > 0
    assert read_results_h5(out["results_h5"]).shape == (4, 4, 4)
    # a checkpoint that is not there: solved without rescoring
    out = tcli.test_main(["-c", _small(tmp_path, "houv_rescore.yaml",
                                       rescore_ckpt=str(tmp_path / "x")),
                          "--device", "cpu"])
    assert "rescore" not in out and out["n_pairs"] == 4


@pytest.mark.parametrize("rescored", [False, True])
def test_houv_eval_main_returns_the_six_meters(tmp_path, rescored):
    """``train -c`` with a houv yaml runs the solver's evaluation on the
    labelled val split: the six meters, globally and by bucket."""
    extra = dict(grid_size=12) if rescored else dict(rescore_ckpt=None)
    path = _small(tmp_path, "houv_rescore.yaml", **extra)
    out = tcli.main(["train", "-c", path, "--device", "cpu"])
    assert set(_METERS) <= set(out)
    assert all(np.isfinite(out[m]) for m in _METERS)
    assert out["MSE"] == out["RMSE"]               # the reference's alias
    assert 0.0 <= out["recall"] <= 1.0
    assert out["n_pairs"] == 4
    buckets = out["buckets"]
    assert sum(b["n"] for b in buckets.values()) == 4
    mean = sum(b["RotE"] * b["n"] for b in buckets.values()) / 4
    np.testing.assert_allclose(mean, out["RotE"], rtol=1e-5)
    assert ("score_seconds" in out) == rescored
    assert os.path.exists(os.path.join(tmp_path, "work", "houv", "train.log"))


def test_houv_eval_needs_a_gpu_unless_asked_for_the_cpu(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["train", "-c", _small(tmp_path, "houv_quality.yaml")])
