"""The port's native loader (``houv_tpu_torch/data/native_loader.py``),
``use_native_loader`` / ``native_steps`` in ``train_main`` and
``profile_dir`` / ``profile_steps`` in ``fit``, on the CPU.

The loader's C++ source (``native/houv_loader.cpp``) is the JAX package's;
the port builds it into ``build/native/``. Its batches are held bit for bit
to the JAX wrapper's for one seed (one worker thread, so the order is
fixed), the JAX wrapper built into a temporary directory so that the JAX
package's own ``native/libhouv_loader.so`` is neither built nor raced on
here. ``train_main`` on a small ``deepgmr.yaml`` copy takes exactly
``native_steps`` steps; a profiled ``fit`` writes a Chrome trace naming
the step's operators."""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import houv_tpu.data.native_loader as jnative
from houv_tpu_torch.data import native_loader as tnative
from houv_tpu_torch.train import cli as tcli

_REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs one process per core."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _data(rng, n=16, pts=64):
    src = rng.uniform(-0.4, 0.4, (n, pts, 3)).astype(np.float32)
    tgt = src + rng.normal(0, 0.01, (n, pts, 3)).astype(np.float32)
    return src, tgt


def test_the_port_builds_the_loader_into_build(tmp_path):
    before = _REPO / "native" / "libhouv_loader.so"
    stamp = before.stat().st_mtime if before.exists() else None
    path = tnative.build_native()
    assert path == _REPO / "build" / "native" / "libhouv_loader.so"
    assert path.exists()
    after = before.stat().st_mtime if before.exists() else None
    assert after == stamp
    assert not list(path.parent.glob("*.tmp"))


@pytest.mark.parametrize("with_voxels", [False, True])
def test_batches_are_bit_equal_to_the_jax_wrappers(rng, tmp_path,
                                                   monkeypatch, with_voxels):
    monkeypatch.setattr(jnative, "_LIB", str(tmp_path / "libjax_loader.so"))
    monkeypatch.setattr(jnative, "_lib", None)
    src, tgt = _data(rng)
    kw = dict(batch_size=4, max_angle_deg=30.0, max_trans=0.4,
              jitter_sigma=0.01, seed=7, n_threads=1,
              with_voxels=with_voxels, grid_size=20)
    with jnative.NativeRegistrationLoader(src, tgt, **kw) as jl, \
            tnative.NativeRegistrationLoader(src, tgt, **kw) as tl:
        for _ in range(3):
            ref, got = jl.next_batch(), tl.next_batch()
            assert set(got) == set(ref)
            for key in ref:
                assert got[key].dtype == ref[key].dtype
                assert got[key].tobytes() == ref[key].tobytes(), key


def _deepgmr_yaml(tmp_path, **extra):
    with open(_REPO / "cfgs" / "deepgmr.yaml") as f:
        raw = yaml.safe_load(f)
    raw.update(num_points=48, rri_size=6, batch_size=4, synthetic_size=8,
               nepoch=2, work_dir=str(tmp_path / "work"), **extra)
    path = tmp_path / "deepgmr.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def test_train_main_takes_native_steps_with_the_loader(tmp_path):
    out = tcli.train_main(["-c", _deepgmr_yaml(
        tmp_path, use_native_loader=True, native_steps=3), "--device", "cpu"])
    assert out["steps"] == 3
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert out["queue_size"] >= 0
    # step-based training validates once after its last step
    assert out["trainer"].best["recall"][0] == 3 // max(8 // 4, 1)


def test_fit_writes_a_profile_of_its_first_steps(tmp_path):
    prof = tmp_path / "prof"
    out = tcli.train_main(["-c", _deepgmr_yaml(
        tmp_path, profile_dir=str(prof), profile_steps=2), "--device", "cpu"])
    assert len(out["losses"]) == 4
    trace = prof / "trace_rank0.json"
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    # the steps' operators, and the optimizer's step of the first
    # profile_steps steps alone
    assert any(n.startswith("aten::") for n in names)
    steps = [e for e in events if e.get("ph") == "X"
             and e.get("cat") != "gpu_user_annotation"
             and e.get("name", "").startswith("Optimizer.step")]
    assert len(steps) == 2
