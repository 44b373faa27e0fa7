"""The port's alignment classifier (``models/alignment.py``, on the blocks of
``models/voxelnet.py``), the flax-checkpoint reader
(``train/checkpoint.py:read_flax_msgpack``) and the flax-to-torch mapping of
its variables (``state.state_from_flax``) against the JAX package, on the
CPU.

The logits agree to 1e-4 in f32 and to 1e-5 in bf16 mode (both packages
round the convs' operands to bf16 and accumulate in f32; the rest adds in
another order). Each bf16 check also holds the port's f32 mode farther
than its tolerance from JAX's bf16 logits, so a build that skipped the
operands' rounding would fail it. The trained checkpoint in ``log/`` is
read leaf for leaf as flax reads it, and gives JAX's bf16 logits on a few
small overlays.
"""

from pathlib import Path

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from houv_tpu.models.alignment import AlignmentClassifier as JClassifier
from houv_tpu_torch.models import get_model
from houv_tpu_torch.models.alignment import AlignmentClassifier
from houv_tpu_torch.state import state_from_flax
from houv_tpu_torch.train.checkpoint import read_flax_msgpack

CKPT = (Path(__file__).resolve().parents[1] / "log"
        / "alignment_spconv_cd_rescorer_pool" / "best_acc_network.ckpt")


def _overlays(rng, b=3, n=64):
    src = rng.uniform(-0.8, 0.8, (b, n, 3)).astype(np.float32)
    tgt = rng.uniform(-0.8, 0.8, (b, n, 3)).astype(np.float32)
    return src, tgt


def _jax_variables(rng, model, src, tgt, n_extra):
    """Initialised variables with running statistics and a gap weight away
    from their initial values, so that every leaf matters."""
    v = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(0), jnp.asarray(src), jnp.asarray(tgt), False))
    stats = jax.tree_util.tree_map(
        lambda a: (a + rng.uniform(0.1, 0.5, a.shape)).astype(np.float32),
        v["batch_stats"])
    params = v["params"]
    if n_extra:
        params["Dense_2"]["kernel"] = np.float32([[0.7]])
        params["Dense_2"]["bias"] = np.float32([0.2])
    return {"params": params, "batch_stats": stats}


def _port_logits(variables, src, tgt, extra=None, **kw):
    """The port's classifier built by the factory with ``variables``
    carried across, on (src, tgt), in eval mode."""
    model = get_model("alignment_spconv", **kw)
    assert isinstance(model, AlignmentClassifier)
    model.load_state_dict(state_from_flax(variables, model), strict=True)
    model.eval()
    with torch.no_grad():
        out = model(torch.tensor(src), torch.tensor(tgt),
                    None if extra is None else torch.tensor(extra))
    assert model.sites_dropped.shape == ()
    return out.numpy()


@pytest.mark.parametrize("n_extra", [0, 1])
@pytest.mark.parametrize("compute_dtype,tol", [(None, 1e-4),
                                               ("bfloat16", 1e-5)])
def test_classifier_logits_match_jax(rng, n_extra, compute_dtype, tol):
    src, tgt = _overlays(rng)
    jm = JClassifier(grid_size=12, init_size=4, compute_dtype=compute_dtype,
                     n_extra=n_extra)
    variables = _jax_variables(rng, jm, src, tgt, n_extra)
    extra = rng.uniform(0.0, 2.0, (3, 1)).astype(np.float32)
    extra = extra if n_extra else None
    ref = np.asarray(jm.apply(variables, jnp.asarray(src), jnp.asarray(tgt),
                              False, extra=None if extra is None
                              else jnp.asarray(extra)))
    kw = dict(grid_size=12, init_size=4, n_extra=n_extra)
    out = _port_logits(variables, src, tgt, extra, compute_dtype=compute_dtype,
                       **kw)
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol)
    if compute_dtype == "bfloat16":
        f32 = _port_logits(variables, src, tgt, extra, **kw)
        assert np.abs(f32 - ref).max() > tol


def test_every_flax_leaf_of_the_classifier_has_a_counterpart(rng):
    src, tgt = _overlays(rng, 1, 16)
    jm = JClassifier(grid_size=12, init_size=4, n_extra=1)
    variables = _jax_variables(rng, jm, src, tgt, 1)
    model = AlignmentClassifier(grid_size=12, init_size=4, n_extra=1)
    state = state_from_flax(variables, model)
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    assert len(state) == n_leaves == len(model.state_dict())
    w = variables["params"]["ResBlock_1"]["SparseDownConv_0"]["kernel"]
    np.testing.assert_array_equal(state["down2.pool.kernel"].numpy(), w)
    bn = variables["batch_stats"]["ResContextBlock_0"]["BatchNorm_2"]
    np.testing.assert_array_equal(
        state["context.res1_bn.running_var"].numpy(), bn["var"])
    dense = variables["params"]["Dense_0"]["kernel"]
    np.testing.assert_array_equal(state["head.weight"].numpy(), dense.T)
    variables["params"]["ResBlock_0"]["SubMConv_9"] = {"kernel": w}
    with pytest.raises(KeyError, match="SubMConv_9"):
        state_from_flax(variables, model)
    del variables["params"]["ResBlock_0"]["SubMConv_9"]
    variables["batch_stats"]["ResContextBlock_0"]["BatchNorm_0"]["m"] = w
    with pytest.raises(KeyError, match="short1_bn.m"):
        state_from_flax(variables, model)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_msgpack_reader_gives_flax_tree_leaf_for_leaf():
    """Every leaf of ``flax.serialization.msgpack_restore``'s tree of the
    trained checkpoint: the same paths, and each leaf of the same type,
    dtype and shape with the same bytes."""
    data = CKPT.read_bytes()
    ref = _leaves(flax.serialization.msgpack_restore(data))
    ours = _leaves(read_flax_msgpack(str(CKPT)))
    assert list(ours) == list(ref)
    assert {p.split("/")[1] for p in ref} == {"params", "batch_stats",
                                               "opt_state", "epoch"}
    for path, value in ref.items():
        got = ours[path]
        assert type(got) is type(value), path
        assert got.dtype == value.dtype and got.shape == value.shape, path
        assert np.asarray(got).tobytes() == np.asarray(value).tobytes(), path


def test_msgpack_reader_types_and_refusals(tmp_path):
    """The msgpack types flax writes, decoded as msgpack does, and an
    extension type that is not flax's refused."""
    tree = {"a": np.arange(6, dtype=np.int32).reshape(2, 3),
            "b": {"s": np.float32(2.5), "f": 1.5, "i": -7, "big": 70000,
                  "neg": -40000, "t": True, "n": None, "x" * 40: "y" * 300,
                  "l": [1, 2, 3] * 6,
                  "e": np.zeros((0, 4), np.float64)},
            "c": {str(i): np.float32(i) for i in range(20)}}
    path = tmp_path / "t.ckpt"
    path.write_bytes(flax.serialization.msgpack_serialize(tree))
    ref = _leaves(flax.serialization.msgpack_restore(path.read_bytes()))
    ours = _leaves(read_flax_msgpack(str(path)))
    assert list(ours) == list(ref)
    for key, value in ref.items():
        if isinstance(value, np.ndarray | np.generic):
            assert np.asarray(ours[key]).tobytes() == np.asarray(
                value).tobytes()
            assert ours[key].dtype == value.dtype
        else:
            assert ours[key] == value and type(ours[key]) is type(value)
    path.write_bytes(bytes([0x81, 0xA1, 0x61, 0xD4, 0x05, 0x00]))
    with pytest.raises(ValueError, match="extension type 5"):
        read_flax_msgpack(str(path))
    path.write_bytes(bytes([0x81, 0xA1, 0x61]))
    with pytest.raises(ValueError, match="truncated"):
        read_flax_msgpack(str(path))


def test_trained_checkpoint_gives_jax_bf16_logits(rng):
    """The classifier in ``log/``, read by the port, built as the CLI builds
    it (grid 50, bf16 mode, no gap head), on 4 overlays of 128 points:
    JAX's bf16 logits within 1e-4, which its f32 mode misses."""
    state = read_flax_msgpack(str(CKPT))
    assert "Dense_2" not in state["params"]
    src, tgt = _overlays(rng, 2, 128)
    src = np.concatenate([src, src + 0.05], 0)
    tgt = np.concatenate([tgt, tgt], 0)
    jm = JClassifier(grid_size=50, compute_dtype="bfloat16")
    ref = np.asarray(jm.apply(
        {"params": state["params"], "batch_stats": state["batch_stats"]},
        jnp.asarray(src), jnp.asarray(tgt), False))
    out = _port_logits(state, src, tgt, grid_size=50,
                       compute_dtype="bfloat16")
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    assert np.isfinite(out).all() and np.ptp(ref) > 0
    f32 = _port_logits(state, src, tgt, grid_size=50)
    assert np.abs(f32 - ref).max() > 1e-4
