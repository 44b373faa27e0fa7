"""The port's CLI for the classical solvers and the shard combine, on the
CPU: ``icp_eval_main`` (``train -c`` with icp, goicp, goicp_bnb or fgr)
with the JAX CLI's meters and iteration floors, and ``test_main
--combine``, whose merge of a sharded sweep is bit-equal to the unsharded
sweep and refuses overlapping or short shards."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import houv_tpu.solvers as j_solvers
import houv_tpu.solvers.goicp_bnb as j_bnb_mod
import houv_tpu.solvers.icp as j_icp_mod
from houv_tpu.train import cli as jcli
from houv_tpu.train.config import load_config as j_load_config
from houv_tpu_torch.train import cli as tcli
from houv_tpu_torch.train.config import load_config
from houv_tpu_torch.train.submission import read_results_h5, write_results_h5

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CLASSICAL = ("icp", "goicp", "goicp_bnb", "fgr")


def _yaml(tmp_path, name, model_name=None, **extra):
    """A copy of cfgs/<name> with ``extra`` over its keys (and another
    model name)."""
    with open(os.path.join(_REPO, "cfgs", name)) as f:
        raw = yaml.safe_load(f)
    if model_name:
        raw["model_name"] = model_name
    raw["work_dir"] = str(tmp_path / "work")
    raw.update(extra)
    path = tmp_path / f"{raw['model_name']}_{len(os.listdir(tmp_path))}.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def _classical_yaml(tmp_path, model, **extra):
    base = "goicp_bnb.yaml" if model == "goicp_bnb" else "fgr.yaml"
    return _yaml(tmp_path, base, model_name=model, **extra)


@pytest.mark.parametrize("name", ["fgr.yaml", "goicp_bnb.yaml"])
def test_num_iters_is_a_config_field(name):
    path = os.path.join(_REPO, "cfgs", name)
    cfg = load_config(path)
    assert cfg.num_iters == j_load_config(path).num_iters
    assert "num_iters" not in cfg.extras
    assert load_config(os.path.join(_REPO, "cfgs", "houv.yaml")).num_iters \
        == 3


@pytest.mark.parametrize("model", _CLASSICAL)
def test_icp_eval_main_calls_the_solvers_as_jax_does(monkeypatch, tmp_path,
                                                     model):
    """Each solver replaced by a recorder on both sides: the same keyword
    arguments (the iteration floors: fgr 48, goicp_bnb 10 levels, icp 50;
    goicp num_iters itself) and, on the same transforms, the same meters."""
    seen = {"jax": [], "port": []}

    def transform(src):
        # a fixed, pair-dependent answer: the first point's offset
        tf = np.tile(np.eye(4, dtype=np.float32), (len(src), 1, 1))
        tf[:, :3, 3] = np.asarray(src)[:, 0]
        return tf

    def j_fake(src, tgt, **kw):
        seen["jax"].append(kw)
        out = {"transform": jnp.asarray(transform(src))}
        if model == "goicp_bnb":
            out.update(e=jnp.ones(len(src)), gap=jnp.zeros(len(src)),
                       certified=jnp.ones(len(src), bool))
        return out

    def t_fake(src, tgt, device, **kw):
        seen["port"].append(kw)
        out = {"transform": torch.as_tensor(transform(src))}
        if model == "goicp_bnb":
            out.update(e=torch.ones(len(src)), gap=torch.zeros(len(src)),
                       certified=torch.ones(len(src), dtype=torch.bool))
        return out

    j_target = {"icp": (j_solvers, "icp_solve"),
                "goicp": (j_icp_mod, "goicp_solve"),
                "goicp_bnb": (j_bnb_mod, "goicp_bnb_solve"),
                "fgr": (j_solvers, "fgr_solve")}[model]
    monkeypatch.setattr(*j_target, j_fake)
    t_name = {"icp": "icp_solve", "goicp": "goicp_solve",
              "goicp_bnb": "goicp_bnb_solve", "fgr": "fgr_solve"}[model]
    monkeypatch.setattr(tcli, t_name, t_fake)
    path = _classical_yaml(tmp_path, model, num_iters=5, num_points=64,
                           synthetic_size=10, batch_size=4)
    log = tcli.setup_logging(None)
    j_out = jcli.icp_eval_main(j_load_config(path), log)
    t_out = tcli.icp_eval_main(load_config(path), log, torch.device("cpu"))
    assert seen["port"] == seen["jax"] and len(seen["port"]) == 2
    floors = {"icp": {"threshold": 0.02, "max_iters": 50},
              "goicp": {"threshold": 0.1, "max_iters": 5},
              "goicp_bnb": {"trans_half": 0.5, "levels": 10},
              "fgr": {"iters": 48}}
    assert seen["port"][0] == floors[model]
    assert set(j_out) == {"RotE", "transE", "recall"} <= set(t_out)
    for m in j_out:
        np.testing.assert_allclose(t_out[m], j_out[m], rtol=1e-5, atol=1e-6)
    assert t_out["n_pairs"] == 8                       # whole batches only
    assert t_out["transforms"].shape == (8, 4, 4)


def test_classical_models_run_through_train_on_the_cpu(tmp_path):
    """``train -c`` runs each classical solver end to end at a tiny width;
    on the CPU no kernel launch is counted."""
    for model in _CLASSICAL:
        path = _classical_yaml(tmp_path, model, num_iters=2, num_points=96,
                               synthetic_size=4, batch_size=2)
        out = tcli.main(["train", "-c", path, "--device", "cpu"])
        assert all(np.isfinite(out[m]) for m in ("RotE", "transE", "recall"))
        assert 0.0 <= out["recall"] <= 1.0
        assert out["n_pairs"] == 4 and out["seconds"] > 0
        assert set(out["launches"].values()) == {0}
        assert np.isfinite(out["transforms"]).all()
        if model == "goicp_bnb":
            assert (out["bnb"]["gap"] >= -1e-6).all()
            assert out["bnb"]["certified"].shape == (4,)


def test_classical_models_have_no_test_sweep(tmp_path):
    path = _classical_yaml(tmp_path, "icp", synthetic_size=2)
    with pytest.raises(NotImplementedError, match="train -c"):
        tcli.test_main(["-c", path, "--device", "cpu"])
    # a learned model's sweep and training over ranks that do not divide
    # the batch run in one process, as the JAX CLI runs them on one device
    path = _yaml(tmp_path, "fgr.yaml", model_name="dcp", n_devices=3,
                 synthetic_size=2, batch_size=2, num_points=32, nepoch=1)
    out = tcli.test_main(["-c", path, "--device", "cpu"])
    assert out["n_pairs"] == 2
    assert read_results_h5(out["results_h5"]).shape == (2, 4, 4)
    out = tcli.main(["train", "-c", path, "--device", "cpu"])
    assert "trainer" in out and np.isfinite(out["losses"]).all()


def _houv_yaml(tmp_path, work):
    """A CPU-sized houv_fast: 24 pairs in batches of 8, 8 restarts, 128
    points, a 10-step cadence."""
    return _yaml(tmp_path, "houv_fast.yaml", num_points=128, kernel=8,
                 num_epochs=10, batch_size=8, synthetic_size=24,
                 synthetic_shape="structured",
                 nn_refresh_schedule="4:2:4,4:2:2,2:2",
                 work_dir=str(tmp_path / work))


def test_combine_resolves_the_gap_bit_equal_to_an_unsharded_sweep(tmp_path):
    whole = tcli.test_main(["-c", _houv_yaml(tmp_path, "whole"),
                            "--device", "cpu"])
    path = _houv_yaml(tmp_path, "sharded")
    for l, r in ((0, 8), (16, 24)):
        tcli.test_main(["-c", path, "-l", str(l), "-r", str(r),
                        "--device", "cpu"])
    out = tcli.test_main(["-c", path, "--combine", "--device", "cpu"])
    assert out["resolved"] == [(8, 16)]
    merged = read_results_h5(out["results_h5"])
    expected = read_results_h5(whole["results_h5"])
    assert merged.shape == (24, 4, 4)
    assert merged.tobytes() == expected.tobytes()
    with open(out["manifest"]) as f:
        assert json.load(f) == {"total": 24,
                                "shards": [[0, 8], [8, 16], [16, 24]]}
    assert os.path.getsize(out["submission"]) > 0
    # restartable: a second combine solves nothing
    again = tcli.test_main(["-c", path, "--combine", "True", "--device",
                            "cpu"])
    assert again["resolved"] == []
    assert read_results_h5(again["results_h5"]).tobytes() \
        == expected.tobytes()


def _shard(cfg_path, l, r, rows=None, width=(4, 4)):
    cfg = load_config(cfg_path)
    path = os.path.join(cfg.work_dir, cfg.model_name, f"results_{l}_{r}.h5")
    data = np.full((r - l if rows is None else rows,) + width, float(l),
                   np.float32)
    return write_results_h5(path, data)


def test_combine_refuses_overlapping_and_short_shards(tmp_path):
    path = _houv_yaml(tmp_path, "bad")
    a = _shard(path, 0, 12)
    b = _shard(path, 8, 24)
    with pytest.raises(ValueError, match="overlap") as err:
        tcli.test_main(["-c", path, "--combine", "--device", "cpu"])
    assert a in str(err.value) and b in str(err.value)
    os.remove(b)
    short = _shard(path, 12, 24, rows=11)
    with pytest.raises(ValueError, match="11 rows") as err:
        tcli.test_main(["-c", path, "--combine", "--device", "cpu"])
    assert short in str(err.value)
    os.remove(short)
    past = _shard(path, 12, 30)
    with pytest.raises(ValueError, match="not a range") as err:
        tcli.test_main(["-c", path, "--combine", "--device", "cpu"])
    assert past in str(err.value)


def test_combine_merges_completion_shards(tmp_path):
    """Completion shards, (n, num_points, 3), merge alike when they cover
    the split (nothing to solve)."""
    path = _yaml(tmp_path, "pcn.yaml", num_points=32, synthetic_size=16)
    total = len(tcli.build_dataset(load_config(path), "test"))
    cut = total // 3
    for l, r in ((0, cut), (cut, total)):
        _shard(path, l, r, width=(32, 3))
    out = tcli.test_main(["-c", path, "--combine", "--device", "cpu"])
    merged = read_results_h5(out["results_h5"])
    assert merged.shape == (total, 32, 3) and out["resolved"] == []
    assert (merged[:cut] == 0).all() and (merged[cut:] == cut).all()


def test_combine_flag_values():
    assert tcli._flag(True) and tcli._flag("True") and tcli._flag("1")
    assert not any(tcli._flag(v) for v in ("0", "false", "False", "no"))
    assert tcli._missing_ranges(10, [(2, 4), (4, 6), (8, 9)]) == [
        (0, 2), (6, 8), (9, 10)]
    assert tcli._missing_ranges(3, []) == [(0, 3)]
    assert tcli._shard_range("x/results_3_17.h5") == (3, 17)
    assert tcli._shard_range("x/results_a_1.h5") is None
