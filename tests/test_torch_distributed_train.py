"""The port's data-parallel training and multi-rank CLI, on the CPU: two
gloo ranks (``parallel.distributed.launch``) each take half of the global
batch; their step is held to one process's on the whole batch: every
gradient within 1e-5 of its tensor's largest entry (in f64 for the
BatchNorm models, so that the comparison sees the statistics of the global
batch, not f32 rounding; a bias ahead of a BatchNorm, whose gradient is 0
in exact arithmetic, is held to that), the replicas bit-equal; PCN's GAN
step (``use_gan``) likewise, the critic's gradients beside the model's.
PCN's steps over two ranks are also held to the JAX trainer's on a
two-device mesh from the same weights. Then ``n_devices: 2 --device cpu`` through the
CLI: the sweep's rows bit-equal to one process, training's checkpoints
written once, the refusals. The rank functions are in
``torch_parallel_ranks.py``."""

import os

import h5py
import jax
import numpy as np
import pytest
import torch
import yaml

import torch_parallel_ranks as ranks
from houv_tpu.parallel import make_mesh as j_make_mesh
from houv_tpu.train import config as jconfig
from houv_tpu.train import harness as jharness
from houv_tpu_torch.parallel.distributed import launch
from houv_tpu_torch.state import vrcnet_state_from_flax
from houv_tpu_torch.train import cli as tcli
from houv_tpu_torch.train.config import Config
from houv_tpu_torch.train.submission import read_results_h5

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# seconds a two-rank job may take before it is killed: ~15 s alone, and
# under the suite's load several times that
TIMEOUT = 300

# each case: its yaml, what shrinks it, the dtype of the comparison
CASES = {
    "pcn": ("pcn.yaml", dict(num_points=128, num_coarse=64, scale_aug=False),
            torch.float32),
    # the GAN step: the critic's gradients averaged like the model's, the
    # LSGAN means the global batch's
    "pcn_gan": ("pcn.yaml", dict(num_points=128, num_coarse=64,
                                 scale_aug=False, use_gan=True),
                torch.float32),
    "vrcnet": ("vrcnet.yaml", dict(num_points=256, num_coarse_raw=128,
                                   num_fps=256, num_coarse=256,
                                   layers="1, 1, 1, 1", knn_list="4, 8",
                                   pk=8), torch.float32),
    # distribution_loss MMD: the latent samples gathered over the ranks,
    # the MMD the global batch's on every rank; in f64, so that the
    # comparison sees the gather's gradient sums, not f32 rounding
    "vrcnet_mmd": ("vrcnet.yaml", dict(num_points=256, num_coarse_raw=128,
                                       num_fps=256, num_coarse=256,
                                       layers="1, 1, 1, 1", knn_list="4, 8",
                                       pk=8, distribution_loss="MMD"),
                   torch.float64),
    "deepgmr": ("deepgmr.yaml", dict(num_points=64, rri_size=8),
                torch.float64),
    "spconv": ("spconv.yaml", dict(num_points=128, grid_size=12),
               torch.float64),
    "alignment": ("alignment.yaml", dict(num_points=64, grid_size=12),
                  torch.float32),
}
# Adam's step normalises each entry's gradient, so where f32 rounding
# decides the sign of a near-zero gradient an entry moves apart by up to
# lr: the states after the step are compared where the gradients are f64,
# or f32 and far from 0 (PCN)
STATE_CASES = ("pcn", "deepgmr", "spconv")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _launch(fn, *args, timeout=TIMEOUT):
    """Two gloo ranks on the CPU, one thread each (the suite runs a
    process per core)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return launch(fn, 2, "cpu", args=args, timeout=timeout)
    finally:
        torch.set_num_threads(before)


def _raw(name, tmp, **extra):
    with open(os.path.join(_REPO, "cfgs", name)) as f:
        raw = yaml.safe_load(f)
    raw.update(batch_size=4, synthetic_size=16, lr=1e-3, work_dir=str(tmp),
               **extra)
    return raw


def _global_batch(raw):
    cfg = Config.from_dict(raw)
    trainer = tcli.make_trainer(cfg, "cpu")
    ds = trainer.wrap_dataset(tcli.build_dataset(cfg, "train"))
    return ds.get_batch(np.arange(raw["batch_size"]),
                        rng=np.random.default_rng(0))


@pytest.fixture(scope="module")
def ddp_steps(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ddp")
    one, cases = {}, {}
    for name, (yml, small, dtype) in CASES.items():
        raw = _raw(yml, tmp, **small)
        batch = _global_batch(raw)
        one[name] = ranks.train_steps(raw, 1, batch, False, dtype)
        cases[name] = (raw, 1, batch, dtype)
    two = _launch(ranks.train_cases, cases)
    return one, two


@pytest.mark.parametrize("name", list(CASES))
def test_ddp_step_equals_one_process_on_the_port(ddp_steps, name):
    one, two = ddp_steps[0][name], ddp_steps[1][name]
    assert two["ranks"] == 2 and two["replicas_equal"]
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=1e-6)
    gmax = max(float(np.abs(g).max()) for g in one["grads"].values())
    zero = {k for k, g in one["grads"].items()
            if np.abs(g).max() <= 1e-12 * gmax}
    # only a BatchNorm model has gradients that vanish in exact arithmetic
    assert not zero or CASES[name][2] == torch.float64
    assert set(two["grads"]) == set(one["grads"])
    for k, g in one["grads"].items():
        d = np.abs(two["grads"][k] - g).max()
        if k in zero:
            assert d <= 2e-12 * gmax, k
        else:
            assert d <= 1e-5 * np.abs(g).max(), (k, d)
    if name in STATE_CASES:
        for k, v in one["state"].items():
            if k in zero:
                continue
            d = np.abs(two["state"][k] - v).max()
            assert d <= 1e-5 * max(np.abs(v).max(), 1e-30), (k, d)


def test_pcn_ddp_steps_match_the_jax_mesh_trainer_on_the_port(tmp_path):
    """Three steps (Adam, lr 1e-3) of PCN on one batch of 4, from the JAX
    trainer's own initial weights: JAX's ``CompletionTrainer`` on a mesh of
    two devices against the port over two ranks, at the bounds of
    ``test_torch_train.py``'s one-device comparison (the first loss 1e-5,
    three 1e-4)."""
    raw = _raw("pcn.yaml", tmp_path, num_points=128, num_coarse=64,
               scale_aug=False)
    batch = _global_batch(raw)
    jtrainer = jharness.CompletionTrainer(jconfig.Config.from_dict(raw),
                                          mesh=j_make_mesh(2))
    jtrainer.init_state(batch)
    params0 = jax.tree_util.tree_map(np.asarray, jtrainer.state["params"])
    jlosses = [float(jtrainer.train_step(batch, 0, s)) for s in range(3)]
    model = tcli.make_trainer(Config.from_dict(raw), "cpu").model
    state = {k: v.numpy() for k, v in
             vrcnet_state_from_flax(params0, model).items()}
    out = _launch(ranks.train_steps, raw, 3, batch, True, torch.float32,
                  state)
    assert out["ranks"] == 2 and out["replicas_equal"]
    np.testing.assert_allclose(out["losses"][0], jlosses[0], rtol=1e-5)
    np.testing.assert_allclose(out["losses"], jlosses, rtol=1e-4)


def _houv_yaml(tmp_path, name, **extra):
    """A CPU-sized houv_fast: 12 pairs in batches of 8 (the tail padded),
    8 restarts, 128 points, a 10-step cadence, rotations to 90°."""
    with open(os.path.join(_REPO, "cfgs", "houv_fast.yaml")) as f:
        raw = yaml.safe_load(f)
    raw.update(dict(num_points=128, kernel=8, num_epochs=10, batch_size=8,
                    synthetic_size=12, synthetic_shape="structured",
                    nn_refresh_schedule="4:2:4,4:2:2,2:2", max_angle=90.0,
                    work_dir=str(tmp_path / name)), **extra)
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def test_cli_sweep_over_two_ranks_is_bit_equal_on_the_port(tmp_path):
    one = tcli.test_main(["-c", _houv_yaml(tmp_path, "one"),
                          "--device", "cpu"])
    two = tcli.test_main(["-c", _houv_yaml(tmp_path, "two", n_devices=2),
                          "--device", "cpu"])
    assert two["n_pairs"] == 12 and two["n_retry"] == one["n_retry"] > 0
    rows = read_results_h5(two["results_h5"])
    assert rows.shape == (12, 4, 4)
    assert rows.tobytes() == read_results_h5(one["results_h5"]).tobytes()
    assert os.path.getsize(two["submission"]) > 0


def test_cli_trains_over_two_ranks_and_rank_0_writes_on_the_port(tmp_path):
    with open(os.path.join(_REPO, "cfgs", "pcn.yaml")) as f:
        raw = yaml.safe_load(f)
    raw.update(num_points=128, num_coarse=64, batch_size=4, synthetic_size=16,
               scale_aug=False, nepoch=2, n_devices=2,
               work_dir=str(tmp_path))
    path = tmp_path / "pcn_small.yaml"
    path.write_text(yaml.safe_dump(raw))
    out = tcli.main(["train", "-c", str(path), "--device", "cpu"])
    assert "trainer" not in out                 # rank 0's record, pickled
    assert len(out["losses"]) == 8 and np.isfinite(out["losses"]).all()
    files = sorted(os.listdir(out["log_dir"]))
    assert files == ["best_cd_p_network.ckpt", "best_cd_t_network.ckpt",
                     "best_f1_network.ckpt", "network.ckpt", "train.log"]
    # no rank left a temporary file of a checkpoint behind
    assert not [f for f in files if f.endswith(".tmp")]


def test_cli_refuses_what_does_not_divide_on_the_port(tmp_path,
                                                     monkeypatch):
    """The JAX CLI's rule for ranks that do not divide the batch: the HOUV
    sweep rounds its batch down to a multiple of the ranks (3 ranks at
    batch 8 solve batches of 6, bit-equal to one process at batch 6, as
    the JAX CLI at ``n_devices: 3`` does, with its row count), and
    training runs in one process (the checkpoint equal to ``n_devices:
    1``'s). What still refuses: a job whose size is not ``n_devices``."""
    from houv_tpu.train import cli as jcli

    three = tcli.test_main(["-c", _houv_yaml(tmp_path, "three",
                                             n_devices=3),
                            "--device", "cpu"])
    six = tcli.test_main(["-c", _houv_yaml(tmp_path, "six", batch_size=6),
                          "--device", "cpu"])
    assert three["n_pairs"] == six["n_pairs"] == 12
    assert three["n_retry"] == six["n_retry"] > 0
    rows = read_results_h5(three["results_h5"])
    assert rows.tobytes() == read_results_h5(six["results_h5"]).tobytes()
    with h5py.File(jcli.test_main(
            ["-c", _houv_yaml(tmp_path, "jax", n_devices=3)]), "r") as f:
        assert f["results"].shape == rows.shape == (12, 4, 4)

    ckpts = []
    for n in (3, 1):
        out = tcli.main(["train", "-c", _pcn_yaml(tmp_path, f"pcn{n}",
                                                  n_devices=n),
                         "--device", "cpu"])
        assert "trainer" in out                  # ran in this process
        ckpts.append(torch.load(out["checkpoint"], weights_only=False))
    for name, p in ckpts[1]["model"].items():
        assert torch.equal(ckpts[0]["model"][name], p), name

    # a job of one rank (torchrun's WORLD_SIZE 1) with n_devices 2
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(ValueError, match="job of 1"):
        tcli.test_main(["-c", _houv_yaml(tmp_path, "two", n_devices=2),
                        "--device", "cpu"])


def _pcn_yaml(tmp_path, name, **extra):
    """A CPU-sized pcn.yaml: batch 8 over 16 clouds, one epoch."""
    with open(os.path.join(_REPO, "cfgs", "pcn.yaml")) as f:
        raw = yaml.safe_load(f)
    raw.update(num_points=128, num_coarse=64, batch_size=8, synthetic_size=16,
               scale_aug=False, nepoch=1, work_dir=str(tmp_path / name),
               **extra)
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


@pytest.mark.parametrize("groups", [1, 2])
def test_row_shard_draws_are_the_global_batch_rows_on_the_port(groups):
    """A rank's draws (``models.common.RowShard``) are its rows of the
    global batch's draw: the two ranks' together are one process's, bit
    for bit, also for a doubled batch [x; y] (``groups`` 2, VRCNet's
    dropout masks), and the generator moves as one process's does."""
    from houv_tpu_torch.models.common import RowShard, draw_rows

    for sampler in (torch.rand, torch.randn):
        whole_gen = torch.Generator().manual_seed(3)
        whole = draw_rows(sampler, (groups * 6, 5), whole_gen)
        after = sampler((2,), generator=whole_gen)
        parts = []
        for rank in range(2):
            gen = torch.Generator().manual_seed(3)
            parts.append(draw_rows(sampler, (groups * 3, 5),
                                   RowShard(gen, rank, 2), groups))
            assert torch.equal(sampler((2,), generator=gen), after)
        joined = torch.cat([p.reshape(groups, 3, 5) for p in parts], 1)
        assert torch.equal(joined.reshape(groups * 6, 5), whole)
