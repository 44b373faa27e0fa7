"""The port's ModelNet registration data (``data/mvp.py``:
``synthesize_modelnet_set``, ``ModelNetDataset``, ``jitter_pcd``), the
completion split's triplet batches (``get_triplet_batch``), the CLI's
ModelNet splits (``train/cli.py:build_dataset``) and cfgs/modelnet.yaml
(DCP) through ``train -c`` and the sweep, on the CPU.

The data are numpy in both packages: the same seeded
``np.random.Generator`` must give the same arrays, bit for bit. The yaml
runs at 20 points a cloud (the yaml's 1024 is the card's); ModelNet's
synthetic splits hold 128 train and 64 other clouds, as in the JAX CLI.
"""

import os

import numpy as np
import pytest
import torch
import yaml

from houv_tpu.data import mvp as jmvp
from houv_tpu.train import cli as jcli
from houv_tpu.train.config import Config as JConfig
from houv_tpu_torch.data import mvp
from houv_tpu_torch.train import cli as tcli
from houv_tpu_torch.train import config as tconfig
from houv_tpu_torch.train.harness import RegistrationTrainer
from houv_tpu_torch.train.submission import read_results_h5

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs one process per core."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _same(ours: dict, ref: dict):
    assert set(ours) == set(ref)
    for k, v in ref.items():
        assert ours[k].dtype == v.dtype, k
        np.testing.assert_array_equal(ours[k], v, err_msg=k)


def _yaml(tmp_path, name, **extra):
    with open(os.path.join(_REPO, "cfgs", name)) as f:
        raw = yaml.safe_load(f)
    raw.update(work_dir=str(tmp_path / "work"), **extra)
    path = tmp_path / f"{len(list(tmp_path.iterdir()))}_{name}"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def test_synthetic_modelnet_set_and_jitter_match_jax():
    ours = mvp.synthesize_modelnet_set(6, n_points=96, seed=3)
    _same(ours, jmvp.synthesize_modelnet_set(6, n_points=96, seed=3))
    assert ours["points"].shape == (6, 96, 3)
    pcd = ours["points"]
    got = mvp.jitter_pcd(np.random.default_rng(1), pcd, 0.05, 0.03)
    want = jmvp.jitter_pcd(np.random.default_rng(1), pcd, 0.05, 0.03)
    np.testing.assert_array_equal(got, want)
    assert 0 < np.abs(got - pcd).max() <= 0.03 + 1e-7


@pytest.mark.parametrize("variant", ["clean", "noisy", "unseen", "icl_nuim"])
def test_modelnet_dataset_matches_jax(variant):
    """Each variant's pairs for one seeded generator, over two batches (so
    the draws continue alike); the clean pair is exact under its pose, the
    noisy one jittered, src and then tgt."""
    data = mvp.synthesize_modelnet_set(10, n_points=64, seed=4)
    kw = dict(variant=variant, max_angle_deg=30.0, max_trans=0.3,
              index_range=(1, 9))
    ours = mvp.ModelNetDataset("train", data=data, **kw)
    ref = jmvp.ModelNetDataset("train", data=data, **kw)
    assert len(ours) == len(ref) == 8
    g_ours, g_ref = np.random.default_rng(7), np.random.default_rng(7)
    for idx in (np.arange(4), np.array([7, 0, 3])):
        batch = ours.get_batch(idx, rng=g_ours)
        _same(batch, ref.get_batch(idx, rng=g_ref))
    t = batch["transform"]
    moved = np.einsum("bij,bnj->bni", t[:, :3, :3], data["points"][1:9][idx]) \
        + t[:, None, :3, 3]
    err = np.abs(moved - batch["tgt"]).max()
    if variant == "noisy":
        assert 1e-4 < err <= 0.05 + 1e-6
    else:
        assert err < 1e-6
    angle = np.degrees(np.arccos(np.clip(
        (np.trace(t[:, :3, :3], axis1=1, axis2=2) - 1) / 2, -1, 1)))
    assert (angle <= 30.0 + 1e-4).all()


def test_modelnet_dataset_reads_source_where_there_are_no_points():
    pts = mvp.synthesize_modelnet_set(3, n_points=16, seed=0)["points"]
    ds = mvp.ModelNetDataset("test", data={"source": pts})
    np.testing.assert_array_equal(ds.points, pts)
    with pytest.raises(ValueError, match="need path or data"):
        mvp.ModelNetDataset("test")


def test_triplet_batch_matches_jax():
    data = mvp.synthesize_completion_set(4, views_per_model=5, n_partial=32,
                                         n_complete=32, seed=2)
    kw = dict(data=data, views_per_model=5, index_range=(2, 18))
    ours = mvp.MVPCompletionDataset("train", **kw)
    ref = jmvp.MVPCompletionDataset("train", **kw)
    g_ours, g_ref = np.random.default_rng(9), np.random.default_rng(9)
    for idx in (np.arange(6), np.array([15, 3, 3, 9])):
        batch = ours.get_triplet_batch(idx, rng=g_ours)
        _same(batch, ref.get_triplet_batch(idx, rng=g_ref))
    # the positive is another view of the anchor's model, the negative a
    # view of another model
    model = ours.orig_idx // 5
    part = ours.partial
    for i, a in enumerate(idx):
        pos = [j for j in range(len(part))
               if np.array_equal(part[j], batch["positive"][i])]
        neg = [j for j in range(len(part))
               if np.array_equal(part[j], batch["negative"][i])]
        assert pos and all(model[j] == model[a] and j != a for j in pos)
        assert neg and all(model[j] != model[a] for j in neg)


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_cli_modelnet_splits_match_jax(split):
    """``build_dataset`` on cfgs/modelnet.yaml at 64 points: the JAX CLI's
    synthetic split (128 train or 64 other clouds, seeds 2021 and 7),
    whatever ``synthetic_size`` says, and the same first batch."""
    with open(os.path.join(_REPO, "cfgs", "modelnet.yaml")) as f:
        raw = yaml.safe_load(f)
    raw.update(num_points=64, variant="noisy", synthetic_size=8)
    ours = tcli.build_dataset(tconfig.Config.from_dict(raw), split)
    ref = jcli.build_dataset(JConfig.from_dict(raw), split)
    assert isinstance(ours, mvp.ModelNetDataset) and ours.variant == "noisy"
    assert len(ours) == len(ref) == (128 if split == "train" else 64)
    np.testing.assert_array_equal(ours.points, ref.points)
    _same(ours.get_batch(np.arange(4), rng=np.random.default_rng(1)),
          ref.get_batch(np.arange(4), rng=np.random.default_rng(1)))


def test_modelnet_yaml_leaves_no_extras():
    cfg = tconfig.load_config(os.path.join(_REPO, "cfgs", "modelnet.yaml"))
    assert cfg.extras == {} and cfg.variant == "clean"
    assert cfg.model_name == "dcp" and cfg.dataset == "modelnet"


def test_modelnet_yaml_trains_then_sweeps(tmp_path):
    """``train -c`` (4 steps of DCP at batch 32, the val split's two
    batches without a bucket grid), then the sweep over the 64-cloud test
    split with the trained weights: (64, 4, 4) rigid transforms. At 20
    points a cloud DCP's graph (k 20) holds every point."""
    path = _yaml(tmp_path, "modelnet.yaml", num_points=20, nepoch=1,
                 variant="noisy")
    out = tcli.main(["train", "-c", path, "--device", "cpu"])
    assert isinstance(out["trainer"], RegistrationTrainer)
    assert len(out["losses"]) == 4 and np.isfinite(out["losses"]).all()
    assert {"network.ckpt", "best_RotE_network.ckpt"} <= set(
        os.listdir(out["log_dir"]))
    assert all(np.isfinite(v[1]) for v in out["trainer"].best.values())
    path = _yaml(tmp_path, "modelnet.yaml", num_points=20, variant="noisy",
                 load_model=out["checkpoint"])
    res = tcli.main(["-c", path, "--device", "cpu"])
    results = read_results_h5(res["results_h5"])
    assert results.shape == (64, 4, 4) and res["n_pairs"] == 64
    rot = results[:, :3, :3]
    np.testing.assert_allclose(rot @ rot.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), rot.shape),
                               atol=1e-5)
