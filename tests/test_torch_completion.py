"""The port's completion sweep on the CPU: its data layer against the JAX
package's (byte-identical fixtures and batches), and ``test_main`` and
``validate`` end to end on a tiny VRCNet."""

import os

import numpy as np
import pytest
import yaml

from houv_tpu.data import MVPCompletionDataset as JDataset
from houv_tpu.data import synthesize_completion_set as jsynth
from houv_tpu.data.pipeline import batch_iterator as jbatches
from houv_tpu.data.pipeline import shard_ranges as jshards
from houv_tpu.train.config import load_config as jload
from houv_tpu_torch.data import MVPCompletionDataset as TDataset
from houv_tpu_torch.data import batch_iterator as tbatches
from houv_tpu_torch.data import shard_ranges as tshards
from houv_tpu_torch.data import synthesize_completion_set as tsynth
from houv_tpu_torch.train.cli import build_dataset
from houv_tpu_torch.train.cli import test_main as torch_test_main
from houv_tpu_torch.train.config import load_config
from houv_tpu_torch.train.harness import CompletionTrainer, model_from_config
from houv_tpu_torch.train.submission import read_results_h5
from houv_tpu_torch.utils.meters import AverageValueMeter

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TINY = dict(batch_size=5, num_points=256, num_coarse_raw=128, num_fps=256,
             num_coarse=256, layers="1, 1, 1, 1", knn_list="4, 8", pk=8,
             synthetic_size=16)


def _assert_same(ours: dict, ref: dict):
    assert ours.keys() == ref.keys()
    for key in ref:
        assert ours[key].dtype == ref[key].dtype, key
        assert ours[key].tobytes() == ref[key].tobytes(), key


@pytest.mark.parametrize("seed,views", [(7, 8), (2021, 26)])
def test_synthetic_completion_set_is_byte_identical(seed, views):
    kw = dict(views_per_model=views, n_partial=64, n_complete=96, seed=seed)
    _assert_same(tsynth(3, **kw), jsynth(3, **kw))


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_completion_batches_are_byte_identical(split):
    data = jsynth(4, views_per_model=8, n_partial=32, n_complete=48, seed=7)
    kw = dict(data=data, views_per_model=8, index_range=(3, 29))
    ours, ref = TDataset(split, **kw), JDataset(split, **kw)
    assert len(ours) == len(ref) == 26
    idx = np.array([0, 5, 7, 25])
    _assert_same(ours.get_batch(idx, rng=np.random.default_rng(1)),
                 ref.get_batch(idx, rng=np.random.default_rng(1)))


@pytest.mark.parametrize("mode", [dict(pad_last=True), dict(drop_last=True),
                                  dict(shuffle=True, seed=3)])
def test_batch_iterator_matches_jax(mode):
    data = jsynth(2, views_per_model=5, n_partial=16, n_complete=16, seed=7)
    ds_t = TDataset("val", data=data, views_per_model=5)
    ds_j = JDataset("val", data=data, views_per_model=5)
    ours = list(tbatches(ds_t, 4, **mode))
    ref = list(jbatches(ds_j, 4, **mode))
    assert len(ours) == len(ref) == (2 if mode.get("drop_last") else 3)
    for a, b in zip(ours, ref):
        _assert_same(a, b)
    if mode.get("pad_last"):
        assert int(ours[-1]["valid"]) == 2 and len(ours[-1]["partial"]) == 4


def test_shard_ranges_and_meter():
    for total, n in ((10, 4), (3, 4), (64, 1)):
        assert tshards(total, n) == jshards(total, n)
    m = AverageValueMeter()
    m.update(1.0, 3)
    m.update(3.0)
    assert m.avg == 1.5 and m.count == 4


def test_vrcnet_config_parses_like_jax():
    path = os.path.join(_REPO, "cfgs", "vrcnet.yaml")
    ours, ref = load_config(path), jload(path)
    for key in ("layers", "knn_list", "pk", "num_coarse_raw", "num_fps",
                "num_coarse", "local_folding", "points_label", "loss",
                "eval_emd", "distribution_loss", "scale_aug", "batch_size"):
        assert getattr(ours, key) == getattr(ref, key), key
    assert ours.layers == (2, 2, 2, 2) and ours.knn_list == (10, 20)


def _tiny_cfg(tmp_path, **extra):
    with open(os.path.join(_REPO, "cfgs", "vrcnet.yaml")) as f:
        raw = yaml.safe_load(f)
    raw.update(_TINY, work_dir=str(tmp_path), **extra)
    path = tmp_path / "vrcnet_tiny.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def test_completion_test_main_and_validate_on_cpu(tmp_path):
    """16 test clouds (2 models x 8 views) in batches of 5, the last one
    padded, then validate with eval_emd over the 3 full batches of a
    16-cloud val split."""
    path = _tiny_cfg(tmp_path, eval_emd=True)
    out = torch_test_main(["-c", path, "--device", "cpu"])
    results = read_results_h5(out["results_h5"])
    assert out["n_clouds"] == 16 and results.shape == (16, 256, 3)
    assert np.isfinite(results).all()
    assert os.path.getsize(out["submission"]) > 0
    # a second sweep gives the same clouds: the weights and the latent
    # noise of each batch come from seeds
    again = read_results_h5(torch_test_main(["-c", path, "--device", "cpu"])
                            ["results_h5"])
    np.testing.assert_array_equal(results, again)

    cfg = load_config(path)
    trainer = CompletionTrainer(cfg, "cpu")
    trainer.init_state()
    metrics = trainer.validate(build_dataset(cfg, "val"))
    assert set(metrics) == {"cd_p", "cd_t", "emd", "f1"}
    assert all(np.isfinite(v) for v in metrics.values())
    assert metrics["cd_p"] > 0 and metrics["emd"] > 0
    assert 0 <= metrics["f1"] <= 1
    assert trainer.best["cd_p"] == (0, metrics["cd_p"])


def test_completion_branch_raises_what_is_not_ported(tmp_path):
    for extra, match in ((dict(model_name="pcn"), "item 11"),
                         (dict(model_name="vrcnet_knn"), "items 8"),
                         (dict(compute_dtype="bfloat16"), "f32")):
        cfg = load_config(_tiny_cfg(tmp_path, **extra))
        with pytest.raises(NotImplementedError, match=match):
            model_from_config(cfg)
    cfg = load_config(_tiny_cfg(tmp_path, use_gan=True))
    with pytest.raises(NotImplementedError, match="use_gan"):
        CompletionTrainer(cfg, "cpu")
    # checkpoints are ported: a load_model that is not there is an error of
    # the file system, not of the port
    cfg = load_config(_tiny_cfg(tmp_path, load_model=str(tmp_path / "no.ckpt")))
    with pytest.raises(FileNotFoundError):
        CompletionTrainer(cfg, "cpu").init_state()
    with pytest.raises(NotImplementedError, match="voxel"):
        build_dataset(load_config(_tiny_cfg(tmp_path,
                                            model_name="vrcnet_knn")),
                      "test")
