"""``compute_dtype: bfloat16`` in the port's ECG against the JAX package's
bf16 ECG, on the CPU, at the f32 parity tests' size
(``tests/test_torch_ecg.py``: 128 points, 64 coarse, the default
hierarchy), on numpy draws in the JAX model's flax tree.

ECG picks points on learned features, so the port's picks are kept and
handed to JAX and to the port's f32 run
(``test_torch_bf16_completion.SharedPicks``). JAX is jitted with every
bf16 rounding kept (``jax_rounding``): with XLA's default the U-Net's
fused layers lose theirs, and the port's f32 mode then lies only 1.1
times as far from JAX's cloud as the bf16 mode (rounding kept: 2.1
times). Bounds as in ``test_torch_bf16_completion.py``: the fine cloud
within 5e-3 absolute, the train loss within 2e-3 relative, the f32 mode
farther on average.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from houv_tpu.models import get_model as jget_model
from houv_tpu_torch.models import get_model
from test_torch_bf16_completion import (BF16, SharedPicks, held,
                                        jax_rounding, loss_held)
from test_torch_vrcnet import _cloud, _params, _port, _t


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs one process per core."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_ecg_bf16_matches_jax_bf16_on_the_port(rng):
    """``loss: cd``: each ``DenseConv`` picks its neighbours on its bf16
    input cast to f32 and runs its layers in bf16; the U-Net's upward
    layers, its last layer and the head return f32. The train step's fine
    cloud and loss."""
    kw = dict(num_points=128, num_coarse=64, num_input=128)
    x, gt = _cloud(rng, 2, 128), _cloud(rng, 2, 128)
    jm = jget_model("ecg", compute_dtype=BF16, **kw)
    params = _params(jm, jnp.asarray(x), jnp.asarray(gt), "train", 0.5)
    picks = SharedPicks()
    with pytest.MonkeyPatch.context() as mp:
        picks.record(mp)
        tm = _port(get_model("ecg", compute_dtype=BF16, **kw), params)
        ours = tm(_t(x), _t(gt), "train", 0.5)
    ours["total_loss"].backward()
    assert all(torch.isfinite(p.grad).all() for p in tm.parameters())
    # forward: 10 kNN (4 graphs, 3 poolings, 3 three-NN) and 4 FPS; the two
    # uniform losses: 5 FPS, 5 ball queries and 5 kNN each
    assert [len(picks.kept[k]) for k in ("knn", "fps", "ball")] == \
        [20, 14, 10]
    with pytest.MonkeyPatch.context() as mp:
        used = picks.to_jax(mp)
        ref = jax_rounding(lambda p, a, b: jm.apply(p, a, b, "train", 0.5),
                           params, x, gt)
    assert used == {k: len(v) for k, v in picks.kept.items()}
    with pytest.MonkeyPatch.context() as mp:
        left = picks.to_port(mp)
        with torch.no_grad():
            ours32 = _port(get_model("ecg", **kw), params)(
                _t(x), _t(gt), "train", 0.5)
    assert not any(left.values())
    assert ours["out2"].dtype == torch.float32
    held(ours["out2"].detach(), ours32["out2"], ref["out2"])
    loss_held(ours["total_loss"].item(), ref["total_loss"])
    np.testing.assert_array_equal(ours["loss2"].shape, (2,))
