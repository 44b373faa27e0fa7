"""The port's ``nn_select`` and the solver's ``nn_select=True`` branch against
the JAX package, on the CPU.

The JAX side runs its Pallas kernel in interpret mode. That kernel picks by a
key holding 16 index bits (2^-12 relative on distances) and reads the
coordinates back through hi/lo bf16 planes (2^-16 relative, its stated
contract); the port picks on exact f32 distances and copies exact f32
coordinates. So: where both picked the same neighbour the coordinates agree
to 2^-16 relative; where a near-equidistant alternate was picked the matched
distances agree to 5e-4 (the JAX package's own tolerance for its kernel);
and nearly all picks are the same.
"""

import contextlib
import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from houv_tpu.ops.chamfer import _nn_both_pallas, nn_select_pallas
from houv_tpu.solvers import houv as jhouv
from houv_tpu_torch.ops import chamfer as tc
from houv_tpu_torch.solvers import houv as thouv
from houv_tpu_torch.state import config_from_jax, params_from_jax
from test_torch_houv import _jax_params, _jax_pass_losses, _pairs
from test_torch_nn_both import NONE, _block_model, _clouds, _sqdist


@pytest.mark.parametrize("bsz,share,n,m", [(2, 8, 96, 100), (1, 16, 130, 64),
                                           (1, 64, 24, 40)])
def test_nn_select_matches_the_pallas_kernel(rng, bsz, share, n, m):
    a = rng.standard_normal((bsz, n, 3)).astype(np.float32)
    b = rng.standard_normal((bsz * share, m, 3)).astype(np.float32)
    r1, r2 = (np.asarray(c) for c in nn_select_pallas(
        jnp.asarray(a), jnp.asarray(b), interpret=True))
    c1, c2 = (c.numpy() for c in tc.nn_select(torch.tensor(a),
                                              torch.tensor(b), device="cpu"))
    assert c1.shape == r1.shape == (bsz * share, n, 3)
    assert c2.shape == r2.shape == (bsz * share, m, 3)
    a_rep = np.repeat(a, share, axis=0)
    for ours, ref, own in ((c1, r1, a_rep), (c2, r2, b)):
        same = np.isclose(ours, ref, rtol=2.0 ** -16, atol=2.0 ** -16).all(-1)
        assert same.mean() > 0.995
        np.testing.assert_allclose(((own - ours) ** 2).sum(-1),
                                   ((own - ref) ** 2).sum(-1),
                                   rtol=5e-4, atol=1e-6)


def test_nn_select_is_the_exact_gather_of_its_own_search(rng):
    """Bit for bit the rows ``chamfer_indices`` names, shared-query layout
    with a share that is no multiple of 8 (the TPU kernel's batch block is
    not carried over), exact ties to the smaller index, no gradients."""
    a = rng.standard_normal((2, 50, 3)).astype(np.float32)
    b = rng.standard_normal((6, 40, 3)).astype(np.float32)
    b[:, 30:] = b[:, :10]                       # duplicated rows: exact ties
    at, bt = torch.tensor(a), torch.tensor(b, requires_grad=True)
    c1, c2 = tc.nn_select(at, bt, device="cpu")
    assert not c1.requires_grad and not c2.requires_grad
    i1, i2 = tc.chamfer_indices(at, bt, device="cpu")
    assert int(i1.max()) < 30                   # the smaller index of a tie
    np.testing.assert_array_equal(
        c1.numpy(), np.take_along_axis(b, i1.numpy()[..., None], 1))
    np.testing.assert_array_equal(
        c2.numpy(), np.take_along_axis(np.repeat(a, 3, 0),
                                       i2.numpy()[..., None], 1))
    d = ((np.repeat(a, 3, 0)[:, :, None] - b[:, None]) ** 2).sum(-1)
    np.testing.assert_array_equal(i1.numpy(), d.argmin(-1))
    with pytest.raises(ValueError, match="does not divide"):
        tc.nn_select(at, bt[:5], device="cpu")
    with pytest.raises(ValueError, match="expected"):
        tc.nn_select(at[..., :2], bt, device="cpu")


def _nan_clouds(kind):
    """A seeded 50-point query cloud and 8 reference clouds of 40 that share
    it: one NaN coordinate in the queries and one in a reference cloud, or
    every query NaN."""
    rng = np.random.default_rng(50)
    a = rng.standard_normal((1, 50, 3)).astype(np.float32)
    b = rng.standard_normal((8, 40, 3)).astype(np.float32)
    if kind == "one_nan_point":
        a[0, 17, 1] = np.nan
        b[3, 5, 0] = np.nan
    else:
        a[:] = np.nan
    return a, b


@pytest.mark.parametrize("kind", ["one_nan_point", "all_nan_cloud"])
def test_plain_versions_never_pick_a_nan_like_the_pallas_kernels(kind):
    """A NaN distance never wins, as in the JAX package's own kernels on
    its main path (``_use_pallas``: the TPU): ``_nn_both_plain`` picks
    what ``_nn_both_pallas`` picks index for index, and a point whose every
    distance is NaN takes index 0 on both sides. ``nn_select_pallas`` reads
    its coordinates back through a one-hot product, which spreads a NaN to
    that coordinate of every row its cloud serves; elsewhere its
    coordinates are the rows ``_nn_select_plain`` copies, to 2^-16."""
    a, b = _nan_clouds(kind)
    j1, j2 = (np.asarray(x) for x in _nn_both_pallas(
        jnp.asarray(a), jnp.asarray(b), interpret=True))
    i1, i2 = tc._nn_both_plain(torch.tensor(a), torch.tensor(b))
    np.testing.assert_array_equal(i1.numpy(), j1)
    np.testing.assert_array_equal(i2.numpy(), j2)
    if kind == "all_nan_cloud":
        assert not i1.any() and not i2.any()
    else:
        assert (i2.numpy() != 17).all() and (i1.numpy()[3] != 5).all()
    r1, r2 = (np.asarray(x) for x in nn_select_pallas(
        jnp.asarray(a), jnp.asarray(b), interpret=True))
    c1, c2 = (x.numpy() for x in tc._nn_select_plain(torch.tensor(a),
                                                     torch.tensor(b)))
    a_rep = np.repeat(a, 8, 0)
    np.testing.assert_array_equal(
        c1, np.take_along_axis(b, i1.numpy()[..., None], 1))
    np.testing.assert_array_equal(
        c2, np.take_along_axis(a_rep, i2.numpy()[..., None], 1))
    for ours, ref, read in ((c1, r1, b), (c2, r2, a_rep)):
        # the one-hot read's NaN: a column of a cloud that holds one
        spread = np.isnan(read).any(1, keepdims=True) & np.isnan(ref)
        np.testing.assert_allclose(np.where(spread, 0.0, ours),
                                   np.where(spread, 0.0, ref),
                                   rtol=2.0 ** -16, atol=2.0 ** -16)
        assert (np.isnan(ref) == (spread | np.isnan(ours))).all()


@pytest.fixture
def jax_select_in_interpret_mode(monkeypatch):
    """The JAX solver takes its ``nn_select`` branch only on a TPU or when
    ``_pair_matches`` is told to interpret the kernel: tell it."""
    orig = jhouv._pair_matches
    monkeypatch.setattr(
        jhouv, "_pair_matches",
        lambda *a, **kw: orig(*a, **dict(kw, interpret=True)))


def test_select_objective_and_gradient_match_at_step0(
        jax_select_in_interpret_mode):
    """``nn_select=True`` in both packages: the step-0 loss, the
    per-replica metric and the gradients. A pick that differs at a
    near-equidistant alternate moves one distance by 2^-12 relative: 1e-4
    on the loss."""
    src, tgt, _ = _pairs(2, 128)
    jcfg = jhouv.HOUVConfig(kernel=8, use_pallas=False, nn_select=True)
    cfg = config_from_jax(jcfg)
    assert cfg.nn_select is True
    p_np = _jax_params(0, 2, 8)

    def f(p):
        return jhouv._objective_gather(p, jnp.asarray(src), jnp.asarray(tgt),
                                       0.0, jcfg)

    (jloss, jmin1), jgrad = jax.value_and_grad(f, has_aux=True)(
        {k: jnp.asarray(v) for k, v in p_np.items()})
    params = {k: v.requires_grad_(True)
              for k, v in params_from_jax(p_np, "cpu").items()}
    loss, min1 = thouv._objective_gather(
        params, torch.as_tensor(src), torch.as_tensor(tgt), 0.0, cfg)
    # zeros for angle_xyz, which the axis-angle objective does not read
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
        params.values(), torch.autograd.grad(loss, list(params.values()),
                                             allow_unused=True))]
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(min1.detach().numpy(), np.asarray(jmin1),
                               rtol=1e-4)
    for name, g in zip(params, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrad[name]),
                                   rtol=2e-3, atol=1e-5, err_msg=name)
    # and the port's select branch is its index branch up to the rounding
    # of R^T (c1 - t): the same loss to 1e-5
    base, _ = thouv._objective_gather(
        params, torch.as_tensor(src), torch.as_tensor(tgt), 0.0,
        dataclasses.replace(cfg, nn_select=False))
    np.testing.assert_allclose(loss.item(), base.item(), rtol=1e-5)


def test_select_per_step_losses_match_jax(jax_select_in_interpret_mode):
    """Eight Adam steps with a refresh block of 2: the matched coordinates
    are cached across a block in both packages."""
    src, tgt, _ = _pairs(2, 128)
    jcfg = jhouv.HOUVConfig(kernel=8, steps=8, use_pallas=False,
                            nn_select=True, nn_refresh=2)
    cfg = config_from_jax(jcfg)
    p_np = _jax_params(1, 2, 8)
    jlosses, _ = _jax_pass_losses(
        jnp.asarray(src), jnp.asarray(tgt),
        {k: jnp.asarray(v) for k, v in p_np.items()}, jcfg)
    params = params_from_jax(p_np, "cpu")
    tc.nn_select.launches = 0
    _, _, losses = thouv._adam_loop(
        torch.as_tensor(src), torch.as_tensor(tgt), 0.0, cfg, params,
        thouv._adam_init(params), 8)
    assert tc.nn_select.launches == 0           # CPU tensors: the plain one
    np.testing.assert_allclose(losses.numpy(), jlosses, rtol=2e-4)


def test_select_solve_runs_and_scatter_mode_rejects_it():
    src, tgt, _ = _pairs(2, 96)
    cfg = thouv.HOUVConfig(kernel=4, steps=6, angle_passes=2,
                           retry_mode="always", nn_select=True)
    out = thouv.houv_solve(torch.as_tensor(src), torch.as_tensor(tgt), cfg,
                           device="cpu")
    assert out["transform"].shape == (2, 4, 4)
    assert torch.isfinite(out["transform"]).all()
    assert torch.isfinite(out["rmse"]).all()
    with pytest.raises(ValueError, match="gather"):
        thouv.HOUVConfig(nn_select=True, grad_mode="scatter")


class _FakeLib:
    """Stands in for the built kernel library: records the entry's sizes,
    plan and which key scratch it was handed, and launches nothing."""

    def __init__(self):
        self.calls = []

    def houv_nn_select(self, a, b, bq, bk, n, m, qlen, rlen, c1, c2, key1,
                       key2, stream):
        self.calls.append((bq, bk, n, m, qlen, rlen, key1 is not None,
                           key2 is not None))
        return 0


@pytest.mark.parametrize("bq,bk,n,m,plan,split", [
    (16, 1024, 2048, 2048, (2048, 2048), (False, False)),  # the solver's
    (32, 32, 2048, 2048, (128, 2048), (False, True)),      # queries split
    (33, 264, 5, 3100, (128, 1664), (True, False)),        # refs split
    (2, 6, 300, 5000, (128, 2560), (True, True)),
])
def test_nn_select_on_cuda_takes_its_kernel_with_the_plan(
        monkeypatch, bq, bk, n, m, plan, split):
    """With ``device="cuda"`` ``nn_select`` hands ``_nn_plan``'s blocks to
    the C entry, allocates 64-bit key scratch for a direction the plan
    splits and for no other (none at the solver's shape), counts one launch
    and never runs the plain version; a launch the card refuses raises. A
    card, the tensors' placement, the stream and the library are faked
    here: the routing is Python."""
    from houv_tpu_torch import kernels

    lib = _FakeLib()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tc, "check_on", lambda dev, *tensors: None)
    monkeypatch.setattr(tc, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(kernels, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))

    def no_plain(*args):
        raise AssertionError("the plain version ran for device='cuda'")

    monkeypatch.setattr(tc, "_nn_select_plain", no_plain)
    monkeypatch.setattr(tc, "_nn_both_plain", no_plain)
    monkeypatch.setattr(tc.nn_select, "launches", 0)
    empty, made = torch.empty, []

    def recorded_empty(shape, **kw):
        made.append((tuple(shape), kw.get("dtype")))
        return empty(shape, **kw)

    monkeypatch.setattr(torch, "empty", recorded_empty)
    a = torch.zeros((bq, n, 3))
    b = torch.zeros((bk, m, 3))
    c1, c2 = tc.nn_select(a, b, device="cuda")
    assert c1.shape == (bk, n, 3) and c2.shape == (bk, m, 3)
    assert c1.dtype == c2.dtype == torch.float32
    assert lib.calls == [(bq, bk, n, m, *plan, *split)]
    keys = [shape for shape, dtype in made if dtype == torch.int64]
    assert keys == [s for s, on in zip(((bk, n), (bk, m)), split) if on]
    assert tc.nn_select.launches == 1
    lib.houv_nn_select = lambda *args: 1
    lib.houv_error_string = lambda err: b"invalid argument"
    with pytest.raises(RuntimeError, match="nn_select launch failed"):
        tc.nn_select(a, b, device="cuda")
    assert tc.nn_select.launches == 1


EMPTY = np.uint64(2 ** 64 - 1)


def _key(v, idx):
    """The 64-bit merge key: distance bits, then the index."""
    return (np.uint64(np.float32(v).view(np.uint32)) << np.uint64(32)) \
        | np.uint64(idx)


def _unpack(keys, src, share):
    """The unpack pass: each key's row of ``src[r // share]``, row 0 for a
    key never reached."""
    idx = np.where(keys == EMPTY, 0, keys & np.uint64(0xffffffff))
    rows = np.arange(keys.shape[0]) // share
    return src[rows[:, None], idx.astype(np.int64)]


def _select_model(a, b, qlen, rlen):
    """K3 on numpy clouds under the plan (qlen, rlen): each block's search
    (``_block_model``), then the coordinate epilogue. A direction a block
    owns whole is written from the block's own copy of the points (the
    refs' shared planes, the queries' rows), slot or row 0 where no
    distance compared; a split one is merged by 64-bit keys (atomicMin)
    and unpacked."""
    bq, n, _ = a.shape
    bk, m, _ = b.shape
    share = bk // bq
    rows_direct, cols_direct = m <= rlen, n <= qlen
    c1 = np.full((bk, n, 3), np.nan, np.float32)
    c2 = np.full((bk, m, 3), np.nan, np.float32)
    key1 = np.full((bk, n), EMPTY, np.uint64)
    key2 = np.full((bk, m), EMPTY, np.uint64)
    for r in range(bk):
        qa = a[r // share]
        dist = _sqdist(qa, b[r])
        for q0 in range(0, n, qlen):
            for j0 in range(0, m, rlen):
                refs, queries = b[r, j0:j0 + rlen], qa[q0:q0 + qlen]
                rows, cols = _block_model(dist[q0:q0 + qlen, j0:j0 + rlen],
                                          True)
                for i, (v, s) in enumerate(rows):
                    if rows_direct:
                        c1[r, q0 + i] = refs[0 if s == NONE else s]
                    elif s != NONE:
                        key1[r, q0 + i] = min(key1[r, q0 + i],
                                              _key(v, j0 + s))
                for j, (v, i) in enumerate(cols):
                    if cols_direct:
                        c2[r, j0 + j] = queries[0 if i == NONE else i]
                    elif i != NONE:
                        key2[r, j0 + j] = min(key2[r, j0 + j],
                                              _key(v, q0 + i))
    if not rows_direct:
        c1 = _unpack(key1, b, 1)
    if not cols_direct:
        c2 = _unpack(key2, a, share)
    return c1, c2


@pytest.mark.parametrize("bq,share,n,m,plan,kind", [
    (1, 2, 300, 400, (384, 512), "copies"),   # both direct
    (1, 2, 300, 400, (128, 512), "copies"),   # queries split: column keys
    (1, 1, 300, 400, (384, 256), "copies"),   # refs split: row keys
    (1, 1, 257, 385, (128, 128), "copies"),   # both split, ragged tiles
    (1, 2, 200, 300, (256, 256), "grid"),
    (1, 1, 200, 300, (128, 128), "grid"),
    (2, 1, 130, 150, (256, 256), "nan"),      # a NaN cloud each side
    (2, 1, 130, 150, (128, 128), "nan"),
    (1, 64, 600, 130, (512, 256), "copies"),  # the select solve's plan:
                                              # share 64, 512 queries
])
def test_nn_select_model_matches_plain_bit_for_bit(rng, bq, share, n, m,
                                                   plan, kind):
    """The modelled K3 copies what ``_nn_select_plain`` copies, bit for
    bit, at plans that keep both directions whole and that split rows,
    columns and both, exact ties everywhere; where a cloud is all NaN no
    distance compares, and both copy row 0."""
    a, b = _clouds(rng, bq, share, n, m, "grid" if kind == "grid" else
                   "copies")
    if kind == "nan":
        a[1] = np.nan
        b[0] = np.nan
    want = tc._nn_select_plain(torch.tensor(a), torch.tensor(b))
    got = _select_model(a, b, *plan)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.view(np.int32),
                                      w.numpy().view(np.int32))


def test_a_header_newer_than_the_library_makes_it_stale(monkeypatch,
                                                        tmp_path):
    """The kernels' library is rebuilt when any file of ``csrc/`` is newer,
    a header the sources include as much as a source; ``sources()`` stays
    the ``.cu`` files nvcc compiles."""
    from houv_tpu_torch.kernels import _build

    csrc, lib = tmp_path / "csrc", tmp_path / "libhouv_kernels.so"
    csrc.mkdir()
    for name in ("nn_both.cu", "nn_select.cu", "nn_search.cuh"):
        (csrc / name).write_text("")
        os.utime(csrc / name, (1000, 1000))
    lib.write_text("")
    os.utime(lib, (2000, 2000))
    monkeypatch.setattr(_build, "_CSRC", csrc)
    monkeypatch.setattr(_build, "_LIB_PATH", lib)
    assert [p.name for p in _build.sources()] == ["nn_both.cu",
                                                  "nn_select.cu"]
    assert not _build._stale()
    os.utime(csrc / "nn_search.cuh", (3000, 3000))
    assert _build._stale()
    os.utime(csrc / "nn_search.cuh", (1000, 1000))
    os.utime(csrc / "nn_select.cu", (3000, 3000))
    assert _build._stale()
    lib.unlink()
    assert _build._stale()
