"""The port's aux models (``models/embedding.py``: ``InstanceEmbedding``,
``triplet_loss``, ``PCNTransformer``; ``models/alignment.py``: ``VoxAsym``,
``make_aligned_pairs``, ``alignment_bce_loss``) and the voxel targets of
``train/aux.py`` against the JAX package, on the CPU.

Sizes: batch 2, 64 to 128 points, ``VoxAsym`` at grid 12 (its embedding 16
and context width 8 as in the JAX package's own test). Weights are numpy
draws in the flax tree (``test_torch_voxelnet.draw_variables``) carried
across by ``state_from_flax``; the trained checkpoints of ``log/`` are read
by ``read_flax_msgpack``. Tolerance: f32 outputs within 1e-5 of the
largest entry of the JAX output (the same arithmetic summed in another
order); the voxel targets' occupancy exact, their means within 1e-7.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from houv_tpu.models.alignment import VoxAsym as JVoxAsym
from houv_tpu.models.alignment import alignment_bce_loss as j_bce
from houv_tpu.models.alignment import make_aligned_pairs as j_pairs
from houv_tpu.models.embedding import InstanceEmbedding as JEmbedding
from houv_tpu.models.embedding import PCNTransformer as JPCNTransformer
from houv_tpu.models.embedding import triplet_loss as j_triplet
from houv_tpu.train.aux import _voxel_targets as j_voxel_targets
from houv_tpu_torch.models import get_model
from houv_tpu_torch.models.alignment import (VoxAsym, alignment_bce_loss,
                                             make_aligned_pairs)
from houv_tpu_torch.models.embedding import (InstanceEmbedding,
                                             PCNTransformer, triplet_loss)
from houv_tpu_torch.state import state_from_flax
from houv_tpu_torch.train.aux import _voxel_targets
from houv_tpu_torch.train.checkpoint import read_flax_msgpack
from test_torch_voxelnet import draw_variables

LOG = Path(__file__).resolve().parents[1] / "log"
EMBED_CKPT = LOG / "model_embedding_cd_embed" / "best_acc_network.ckpt"
VOX_CKPT = LOG / "voxel_asym_cd_vox" / "best_iou_network.ckpt"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs one process per core."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _variables(module, *args, seed=0, **kwargs):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args,
                                                **kwargs))
    return draw_variables(shapes, np.random.default_rng(seed))


def _japply(jm, variables, *args, **kwargs):
    """``jm.apply`` jitted (eager, the sparse convs' many small ops take
    four times as long on the CPU)."""
    return jax.jit(lambda v, *a: jm.apply(v, *a, **kwargs))(variables, *args)


def _port(tm, variables):
    tm.load_state_dict(state_from_flax(variables, tm), strict=True)
    return tm.eval()


def _close(out, ref, tol=1e-5):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-30))


def _cloud(rng, b, n, lo=-0.5, hi=0.5):
    return rng.uniform(lo, hi, (b, n, 3)).astype(np.float32)


def _voxel_coords(x, g):
    """The completion split's voxel indices (``_voxel_coords``)."""
    interval = np.float32(1.0 / (g - 1))
    idx = np.floor((np.clip(x, -0.5, 0.5) + 0.5) / interval).astype(np.int32)
    return np.clip(idx, 0, g - 1)


@pytest.mark.parametrize("use_attention", [False, True])
def test_instance_embedding_matches_jax(rng, use_attention):
    x = _cloud(rng, 2, 96)
    jm = JEmbedding(use_attention=use_attention)
    v = _variables(jm, x)
    emb_j, logits_j = jm.apply(v, x)
    tm = _port(InstanceEmbedding(use_attention=use_attention), v)
    with torch.no_grad():
        emb, logits = tm(torch.tensor(x))
    _close(emb.numpy(), emb_j)
    _close(logits.numpy(), logits_j)
    np.testing.assert_allclose(np.linalg.norm(emb.numpy(), axis=-1), 1.0,
                               rtol=1e-6)


def test_instance_embedding_flax_order_and_norm_floor():
    """flax builds the logits' Dense before the hidden one it applies it
    to: Dense_2 maps 512 -> 16, Dense_3 256 -> 512. An all-zero embedding
    stays zero (the norm floored at 1e-9), as in the JAX model."""
    tm = get_model("model_embedding")
    assert isinstance(tm, InstanceEmbedding)
    assert tm.flax_names == {"PointMLP_0": "mlp", "Dense_0": "fc",
                             "Dense_1": "embed", "Dense_2": "logits",
                             "Dense_3": "hidden"}
    assert tuple(tm.logits.weight.shape) == (16, 512)
    assert tuple(tm.hidden.weight.shape) == (512, 256)
    with torch.no_grad():
        tm.embed.weight.zero_()
        tm.embed.bias.zero_()
        emb, _ = tm(torch.rand(2, 16, 3))
    assert torch.equal(emb, torch.zeros(2, 32))


def test_trained_embedding_checkpoint_gives_jax_outputs(rng):
    """The trained ``model_embedding`` checkpoint at the yaml's width, 2048
    points a cloud."""
    state = read_flax_msgpack(str(EMBED_CKPT))
    x = _cloud(rng, 2, 2048)
    emb_j, logits_j = JEmbedding().apply({"params": state["params"]}, x)
    tm = _port(get_model("model_embedding"), state)
    with torch.no_grad():
        emb, logits = tm(torch.tensor(x))
    _close(emb.numpy(), emb_j)
    _close(logits.numpy(), logits_j)
    assert np.ptp(np.asarray(logits_j)) > 0


def test_pcn_transformer_matches_jax(rng):
    x = _cloud(rng, 2, 64)
    jm = JPCNTransformer(output_size=128)
    v = _variables(jm, x, seed=1)
    ref = jm.apply(v, x)
    tm = _port(PCNTransformer(output_size=128), v)
    assert tm.flax_names == {"Dense_0": "fc1", "Dense_1": "fc2",
                             "Dense_2": "fc3", "MultiHeadAttention_0": "attn",
                             "Dense_3": "out"}
    with torch.no_grad():
        out = tm(torch.tensor(x))
    _close(out.numpy(), ref)


def _vox_inputs(rng, b=2, n=128, g=12):
    pts = _cloud(rng, b, n)
    return pts, _voxel_coords(pts, g)


def _vox_port(v, g=12, **kw):
    return _port(VoxAsym(grid_size=g, **kw), v)


def test_vox_asym_forward_matches_jax(rng):
    pts, coords = _vox_inputs(rng)
    jm = JVoxAsym(grid_size=12, embedding_dim=16, init_size=8)
    v = _variables(jm, pts, coords, seed=2)
    probs_j, pos_j, vc_j, mask_j = _japply(jm, v, pts, coords)
    tm = _vox_port(v, embedding_dim=16, init_size=8)
    assert set(tm.flax_names) == {"PointMLP_0", "ResContextBlock_0",
                                  "Dense_0"}
    with torch.no_grad():
        probs, pos, vc, mask = tm(torch.tensor(pts), torch.tensor(coords))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_j))
    np.testing.assert_array_equal(vc.numpy(), np.asarray(vc_j))
    _close(probs.numpy(), probs_j)
    _close(pos.numpy(), pos_j)
    m = mask.numpy()
    assert 0 < m.sum() < m.size
    np.testing.assert_allclose(probs.numpy().sum(-1)[m], 1.0, rtol=1e-6)


def test_vox_asym_train_mode_outputs_and_running_stats_match_jax(rng):
    pts, coords = _vox_inputs(rng, n=100)
    jm = JVoxAsym(grid_size=12, embedding_dim=16, init_size=8)
    v = _variables(jm, pts, coords, seed=3)
    (probs_j, pos_j, _, _), upd = _japply(jm, v, pts, coords, train=True,
                                          mutable=["batch_stats"])
    tm = _vox_port(v, embedding_dim=16, init_size=8)
    with torch.no_grad():
        probs, pos, _, _ = tm(torch.tensor(pts), torch.tensor(coords),
                              train=True)
    _close(probs.numpy(), probs_j)
    _close(pos.numpy(), pos_j)
    want = state_from_flax({"batch_stats": jax.tree_util.tree_map(
        np.asarray, upd["batch_stats"])}, tm)
    before = state_from_flax({"batch_stats": v["batch_stats"]}, tm)
    got = tm.state_dict()
    assert len(want) == 8
    for name, w in want.items():
        _close(got[name].numpy(), w.numpy(), 1e-6)
        assert not torch.equal(got[name], before[name]), name


def test_trained_vox_asym_checkpoint_gives_jax_outputs(rng):
    """The trained ``voxel_asym`` checkpoint at the yaml's grid of 50, on
    two clouds of 300 points."""
    state = read_flax_msgpack(str(VOX_CKPT))
    pts, coords = _vox_inputs(rng, n=300, g=50)
    variables = {"params": state["params"],
                 "batch_stats": state["batch_stats"]}
    probs_j, pos_j, _, mask_j = _japply(JVoxAsym(grid_size=50), variables,
                                        pts, coords)
    tm = _port(get_model("voxel_asym"), state)
    with torch.no_grad():
        probs, pos, _, mask = tm(torch.tensor(pts), torch.tensor(coords))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_j))
    _close(probs.numpy(), probs_j)
    _close(pos.numpy(), pos_j)
    assert np.ptp(np.asarray(probs_j)[np.asarray(mask_j)]) > 0


def test_triplet_and_bce_losses_match_jax(rng):
    a, p, n = (rng.standard_normal((5, 8)).astype(np.float32)
               for _ in range(3))
    for margin in (0.2, 0.0, 5.0):
        got = triplet_loss(torch.tensor(a), torch.tensor(p), torch.tensor(n),
                           margin)
        np.testing.assert_allclose(float(got),
                                   float(j_triplet(a, p, n, margin)),
                                   rtol=1e-6)
    logits = np.float32([-40.0, -3.0, -0.1, 0.0, 0.2, 2.5, 60.0])
    labels = np.float32([0, 1, 0, 1, 1, 0, 1])
    got = alignment_bce_loss(torch.tensor(logits), torch.tensor(labels))
    np.testing.assert_allclose(float(got), float(j_bce(logits, labels)),
                               rtol=1e-6)
    assert np.isfinite(float(got))


def test_make_aligned_pairs_draws_as_jax():
    t_gt = np.eye(4)
    t_gt[:3, 3] = [0.1, -0.2, 0.3]
    ours = np.random.default_rng(5)
    ref = np.random.default_rng(5)
    for _ in range(20):
        t_true, t_false = make_aligned_pairs(ours, t_gt)
        j_true, j_false = j_pairs(ref, t_gt)
        np.testing.assert_array_equal(t_true, j_true)
        np.testing.assert_array_equal(t_false, j_false)
        cos = (np.trace(t_false[:3, :3] @ t_gt[:3, :3].T) - 1) / 2
        assert np.degrees(np.arccos(np.clip(cos, -1, 1))) >= 5.0 - 1e-9
        cos = (np.trace(t_true[:3, :3] @ t_gt[:3, :3].T) - 1) / 2
        assert np.degrees(np.arccos(np.clip(cos, -1, 1))) <= 5.0 + 1e-9


@pytest.mark.parametrize("g,n", [(12, 200), (50, 2048)])
def test_voxel_targets_match_jax(rng, g, n):
    """Occupancy exact, the means within 1e-7; repeated points (several a
    voxel) and points outside the volume clipped to its border."""
    gt = _cloud(rng, 2, n, -0.6, 0.6)
    gt[:, n // 2:] = gt[:, :n - n // 2]
    gc = _voxel_coords(gt, g)
    occ_j, mean_j = j_voxel_targets(jnp.asarray(gt), jnp.asarray(gc), g)
    occ, mean = _voxel_targets(torch.tensor(gt), torch.tensor(gc), g)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_j))
    np.testing.assert_allclose(mean.numpy(), np.asarray(mean_j), rtol=0,
                               atol=1e-7)
    assert occ.shape == (2, g ** 3) and mean.shape == (2, g ** 3, 3)
    assert 0 < occ.sum() < 2 * n
