"""The port's aux trainers (``train/aux.py``: ``EmbeddingTrainer``,
``AlignmentTrainer``, ``VoxelOccupancyTrainer`` and their dataset views)
and the CLI paths of the aux yamls (``train/cli.py``), against the JAX
package's ``houv_tpu/train/aux.py`` on the CPU; and every yaml of
``cfgs/`` built by the port.

Sizes: 64 to 128 points a cloud, batch 4, the voxel nets at grid 12
(``VoxAsym`` at its width of 64 and 32, the classifier at 32). Weights are
numpy draws in the JAX model's flax tree
(``test_torch_voxelnet.draw_variables``). Gradients: the port's f32 train
loss against the JAX trainer's own ``_make_loss_fn`` in f64 (jitted; its
f32 CPU gradients of sparse conv trunks are off by up to 2.3e-3, see
tests/test_torch_train.py), each parameter's within 1e-4 of its tensor's
largest entry. The view's draws (triplet partners, candidate transforms)
are made once and handed to both packages, since the JAX package's
``validate`` draws them from an unseeded generator; the meters then agree
to 1e-5 relative.
"""

import glob
import logging
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from houv_tpu.data import mvp as jmvp
from houv_tpu.train import aux as jaux
from houv_tpu.train.config import Config as JConfig
from houv_tpu_torch.data import mvp
from houv_tpu_torch.state import state_from_flax
from houv_tpu_torch.train import aux
from houv_tpu_torch.train import cli as tcli
from houv_tpu_torch.train import config as tconfig
from houv_tpu_torch.train import harness as tharness
from test_torch_voxelnet import draw_variables

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EMBED_CKPT = os.path.join(_REPO, "log", "model_embedding_cd_embed",
                          "best_acc_network.ckpt")

# the aux yamls at CPU size
SMALL = {"embedding.yaml": dict(num_points=64, batch_size=4,
                                synthetic_size=16),
         "spconv.yaml": dict(num_points=128, batch_size=4, synthetic_size=16,
                             grid_size=12),
         "alignment.yaml": dict(num_points=64, batch_size=4,
                                synthetic_size=12, grid_size=12),
         "rescore_alignment.yaml": dict(num_points=64, batch_size=4,
                                        synthetic_size=12, grid_size=12)}
TRAINERS = {"embedding.yaml": (aux.EmbeddingTrainer, jaux.EmbeddingTrainer),
            "spconv.yaml": (aux.VoxelOccupancyTrainer,
                            jaux.VoxelOccupancyTrainer),
            "alignment.yaml": (aux.AlignmentTrainer, jaux.AlignmentTrainer)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs one process per core."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _raw(name, tmp_path, **extra):
    with open(os.path.join(_REPO, "cfgs", name)) as f:
        raw = yaml.safe_load(f)
    raw.update({"work_dir": str(tmp_path / "work"), **extra})
    return raw


def _yaml(tmp_path, name, **extra):
    path = tmp_path / f"{len(list(tmp_path.iterdir()))}_{name}"
    path.write_text(yaml.safe_dump(_raw(name, tmp_path, **extra)))
    return str(path)


def _both(name, tmp_path):
    """The port's trainer (its model seeded) and the JAX package's, for the
    small copy of the yaml, and flax variables drawn for the JAX model
    carried into the port's."""
    raw = _raw(name, tmp_path, **SMALL[name])
    ours = tcli.make_trainer(tconfig.Config.from_dict(raw), "cpu")
    ours.init_state()
    ref = TRAINERS[name][1](JConfig.from_dict(raw))
    assert type(ours) is TRAINERS[name][0]
    return ours, ref


def _view_batch(trainer, split, n, seed):
    """``n`` items of the yaml's split through the port's view."""
    ds = trainer.wrap_dataset(tcli.build_dataset(trainer.cfg, split))
    return ds.get_batch(np.arange(n), rng=np.random.default_rng(seed))


def _jax_variables(ref, batch):
    args = ref._init_args(batch)
    shapes = jax.eval_shape(lambda: ref.model.init(jax.random.PRNGKey(0),
                                                   **args))
    v = draw_variables(shapes, np.random.default_rng(4))
    return {"params": v["params"], "batch_stats": v.get("batch_stats", {})}


def _carry(ours, variables):
    ours.model.load_state_dict(state_from_flax(variables, ours.model),
                               strict=True)


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_aux_train_step_gradients_match_jax_f64(tmp_path, name):
    ours, ref = _both(name, tmp_path)
    batch = _view_batch(ours, "train", 4, seed=1)
    v = _jax_variables(ref, batch)
    _carry(ours, v)
    has_bn = bool(jax.tree_util.tree_leaves(v["batch_stats"]))
    loss_fn = ref._make_loss_fn(has_bn)
    with jax.enable_x64(True):
        def f64(a):
            a = np.asarray(a)
            return jnp.asarray(a, jnp.float64 if a.dtype.kind == "f"
                               else a.dtype)

        jbatch = {k: f64(a) for k, a in batch.items()}
        v64 = jax.tree_util.tree_map(f64, v)
        (jloss, _), jgrads = jax.jit(jax.value_and_grad(
            lambda p: loss_fn(p, v64["batch_stats"], jbatch, 0.0, {}),
            has_aux=True))(v64["params"])
        jgrads = jax.tree_util.tree_map(np.asarray, jgrads)
    loss = ours._train_loss(batch, 0, 0)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    loss.backward()
    want = state_from_flax({"params": jgrads}, ours.model)
    grads = dict(ours.model.named_parameters())
    assert set(want) == set(grads)
    for pname, g in want.items():
        g = g.numpy()
        np.testing.assert_allclose(grads[pname].grad.numpy(), g, rtol=0,
                                   atol=1e-4 * np.abs(g).max() + 1e-12,
                                   err_msg=pname)
    assert loss.item() > 0


def _fixed_view(view, rows, per):
    """A dataset of the view's class (so both packages' ``wrap_dataset``
    keep it) giving the rows drawn once: item i is rows [per·i, per·i +
    per)."""
    class Fixed(view):
        def __init__(self):
            pass

        def __len__(self):
            return len(next(iter(rows.values()))) // per

        def get_batch(self, indices, rng=None):
            take = (np.asarray(indices)[:, None] * per
                    + np.arange(per)).reshape(-1)
            return {k: v[take] for k, v in rows.items()}

    return Fixed()


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_aux_validate_meters_match_jax(tmp_path, name):
    """The meters of both packages' ``validate`` on the same val batches
    (two full batches and a short one, dropped), each keeping its best and
    writing its best checkpoint."""
    ours, ref = _both(name, tmp_path)
    val = tcli.build_dataset(ours.cfg, "val")
    n = 2 * ours.cfg.batch_size + 2
    view_cls = {aux.TripletView: jaux.TripletView,
                aux.AlignedPairView: jaux.AlignedPairView,
                aux.VoxelTargetView: jaux.VoxelTargetView}[ours._view]
    per = 2 if view_cls is jaux.AlignedPairView else 1
    rows = ours.wrap_dataset(val).get_batch(np.arange(n),
                                            rng=np.random.default_rng(3))
    v = _jax_variables(ref, rows)
    _carry(ours, v)
    ref.state = {"params": v["params"], "batch_stats": v["batch_stats"],
                 "opt_state": ref.opt.init(v["params"]), "epoch": 0}
    want = ref.validate(_fixed_view(view_cls, rows, per), epoch=1)
    got = ours.validate(_fixed_view(ours._view, rows, per), epoch=1)
    assert set(got) == set(want) == set(ours._meters)
    for m in got:
        assert got[m] == pytest.approx(want[m], rel=1e-5, abs=1e-7), m
    (tracked,) = ours._metrics
    assert ours.best[tracked] == (1, got[tracked])
    assert os.path.exists(os.path.join(ours.log_dir,
                                       f"best_{tracked}_network.ckpt"))


def test_validate_is_seeded_by_default(tmp_path):
    """The port's ``validate`` draws the candidates from the trainer's
    seed (the JAX package's from an unseeded generator): two validations
    agree; a trainer of another ``manual_seed`` draws other candidates."""
    seen = []

    def watched(seed):
        trainer = tcli.make_trainer(tconfig.Config.from_dict(_raw(
            "alignment.yaml", tmp_path, manual_seed=seed,
            **SMALL["alignment.yaml"])), "cpu")
        trainer.init_state()
        real = trainer._batch_metrics

        def keep(batch):
            seen.append(batch["src_moved"].copy())
            return real(batch)

        trainer._batch_metrics = keep
        return trainer

    trainer = watched(None)
    val = tcli.build_dataset(trainer.cfg, "val")
    first = trainer.validate(val)
    assert trainer.validate(val) == first
    watched(5).validate(val)
    n = len(seen) // 3
    assert n == 3
    assert all(np.array_equal(a, b) for a, b in zip(seen[:n], seen[n:2 * n]))
    assert not np.array_equal(seen[0], seen[2 * n])


def test_views_match_jax(tmp_path):
    """``AlignedPairView`` (train and val splits, and the identity on the
    test split), ``PoolCandidateDataset`` (balanced, augmented),
    ``TripletView`` and ``VoxelTargetView``: the JAX package's arrays for
    the same seeded generator."""
    def same(a, b):
        assert set(a) == set(b)
        for k in b:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    reg = mvp.synthesize_registration_pairs(6, n_points=32, seed=1)
    for split in ("train", "val", "test"):
        ours = aux.AlignedPairView(mvp.MVPRegistrationDataset(split,
                                                              data=reg))
        ref = jaux.AlignedPairView(jmvp.MVPRegistrationDataset(split,
                                                               data=reg))
        g1, g2 = np.random.default_rng(5), np.random.default_rng(5)
        for idx in (np.arange(3), np.array([5, 1])):
            batch = ours.get_batch(idx, rng=g1)
            same(batch, ref.get_batch(idx, rng=g2))
        np.testing.assert_array_equal(batch["lbl"], [1, 0, 1, 0])
        assert batch["src_moved"].shape == (4, 32, 3)
    rng = np.random.default_rng(2)
    rows = {"src_moved": rng.standard_normal((10, 16, 3)).astype(np.float32),
            "tgt": rng.standard_normal((10, 16, 3)).astype(np.float32),
            "lbl": np.float32([1, 0, 0, 0, 0, 0, 0, 1, 0, 0])}
    ours = aux.PoolCandidateDataset(rows, seed=3, augment=True)
    ref = jaux.PoolCandidateDataset(rows, seed=3, augment=True)
    assert len(ours) == len(ref) == 8 + 2 * 4
    np.testing.assert_array_equal(ours._index, ref._index)
    g1, g2 = np.random.default_rng(6), np.random.default_rng(6)
    same(ours.get_batch(np.arange(5), rng=g1),
         ref.get_batch(np.arange(5), rng=g2))
    plain = aux.PoolCandidateDataset(rows, balance=False)
    assert len(plain) == 10
    same(plain.get_batch(np.arange(3)),
         {k: v[plain._index[:3]] for k, v in rows.items()})
    cp = mvp.synthesize_completion_set(3, views_per_model=4, n_partial=32,
                                       n_complete=32, seed=2)
    for view, jview, split in ((aux.TripletView, jaux.TripletView, "train"),
                               (aux.VoxelTargetView, jaux.VoxelTargetView,
                                "train"),
                               (aux.VoxelTargetView, jaux.VoxelTargetView,
                                "test")):
        ours = view(mvp.MVPCompletionDataset(split, data=cp,
                                             views_per_model=4))
        ref = jview(jmvp.MVPCompletionDataset(split, data=cp,
                                              views_per_model=4))
        g1, g2 = np.random.default_rng(8), np.random.default_rng(8)
        same(ours.get_batch(np.arange(5), rng=g1),
             ref.get_batch(np.arange(5), rng=g2))


@pytest.mark.parametrize("name", sorted(SMALL))
def test_aux_yaml_trains_then_evaluates(tmp_path, name):
    """``train -c`` on the small copy (two epochs, ``network.ckpt`` and the
    tracked meter's best checkpoint), then the aux "test": the val meters
    of the trained weights, those of a trainer loading them."""
    path = _yaml(tmp_path, name, nepoch=2, **SMALL[name])
    out = tcli.main(["train", "-c", path, "--device", "cpu"])
    trainer = out["trainer"]
    assert type(trainer) is tcli.AUX_TRAINERS[trainer.cfg.model_name]
    assert len(out["losses"]) >= 2 and np.isfinite(out["losses"]).all()
    (tracked,) = trainer._metrics
    assert {"network.ckpt", f"best_{tracked}_network.ckpt"} <= set(
        os.listdir(out["log_dir"]))
    if name == "rescore_alignment.yaml":
        assert trainer.model.context.short1.compute_dtype == "bfloat16"
    path = _yaml(tmp_path, name, load_model=out["checkpoint"],
                 **SMALL[name])
    metrics = tcli.main(["-c", path, "--device", "cpu"])
    assert set(metrics) == set(trainer._meters)
    assert all(np.isfinite(v) for v in metrics.values())
    assert metrics == trainer.validate(tcli.build_dataset(trainer.cfg, "val"))


def test_save_refuses_to_overwrite_the_load_model_file(tmp_path):
    """With ``work_dir`` and ``flag`` naming the directory of the trained
    JAX checkpoint, and ``load_model`` that checkpoint (by a path of
    another spelling), the aux "test" would write its best checkpoint over
    it: ``save`` raises and the file keeps its bytes. Elsewhere it
    saves."""
    work = tmp_path / "log"
    target = work / "model_embedding_cd_embed" / "best_acc_network.ckpt"
    target.parent.mkdir(parents=True)
    shutil.copy(EMBED_CKPT, target)
    before = target.read_bytes()
    roundabout = str(work / "model_embedding_cd_embed" / ".."
                     / "model_embedding_cd_embed" / "best_acc_network.ckpt")
    path = _yaml(tmp_path, "embedding.yaml", work_dir=str(work),
                 load_model=roundabout, **dict(SMALL["embedding.yaml"],
                                               num_points=2048))
    with pytest.raises(ValueError, match="load_model"):
        tcli.main(["-c", path, "--device", "cpu"])
    assert target.read_bytes() == before
    path = _yaml(tmp_path, "embedding.yaml", work_dir=str(tmp_path / "w2"),
                 load_model=str(target), **dict(SMALL["embedding.yaml"],
                                                num_points=2048))
    metrics = tcli.main(["-c", path, "--device", "cpu"])
    assert set(metrics) == {"acc", "cls_acc"}
    assert glob.glob(str(tmp_path / "w2" / "*" / "best_acc_network.ckpt"))
    assert target.read_bytes() == before


ALL_YAMLS = sorted(os.path.basename(p)
                   for p in glob.glob(os.path.join(_REPO, "cfgs", "*.yaml")))


def test_there_are_22_yamls():
    assert len(ALL_YAMLS) == 22


@pytest.mark.parametrize("name", ALL_YAMLS)
def test_every_yaml_builds_on_the_port(name):
    """Each yaml of ``cfgs/``: no key left in ``extras``, and its model (or
    the solver's config, and the rescorer's trained classifier), its
    trainer's view and its test and val splits built without
    NotImplementedError (the splits' synthetic size cut to 8 items)."""
    cfg = tconfig.load_config(os.path.join(_REPO, "cfgs", name))
    assert cfg.extras == {}
    cfg.synthetic_size = 8
    if cfg.model_name == "houv":
        assert tcli.solver_config(cfg).kernel == cfg.kernel
        log = logging.getLogger("houv_tpu_torch")
        assert (tcli.make_rescorer(cfg, log, "cpu") is None) == (
            not cfg.rescore_ckpt)
    elif cfg.model_name in tcli.AUX_TRAINERS:
        trainer = tcli.make_trainer(cfg, "cpu")
        assert type(trainer.model) is tharness.MODELS[cfg.model_name]
    elif cfg.model_name not in tcli.CLASSICAL_MODELS:
        model = tharness.model_from_config(cfg)
        assert type(model) is tharness.MODELS[cfg.model_name]
    for split in ("test", "val"):
        ds = tcli.build_dataset(cfg, split)
        if cfg.model_name in tcli.AUX_TRAINERS and split == "val":
            ds = trainer.wrap_dataset(ds)
        assert len(ds) > 0 and ds.get_batch(np.arange(2))
