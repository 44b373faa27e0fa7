"""The launch plan and the selection of the nearest-neighbour kernel
(``csrc/nn_both.cu``), on the CPU.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``).
Here its plan (``ops/chamfer.py:_nn_plan``) is checked at the paths' shapes
and for its invariants, the wrapper's launch on a faked card, and a numpy
model of its selection (micro-tile minima, the lazy index rescans, the
per-tile column merge and the merge across blocks) against
``_nn_both_plain`` index for index, on clouds with planted exact ties.
"""

import contextlib
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from houv_tpu_torch.ops import chamfer

TILE = 128
NONE = np.iinfo(np.int64).max
# a thread's 8 reference slots in a tile: 4tx..4tx+3 and 64+4tx..67+4tx
SLOTS = np.array([[4 * tx + k for k in range(4)]
                  + [64 + 4 * tx + k for k in range(4)] for tx in range(16)])


@pytest.mark.parametrize("bk,n,m,plan", [
    (6400, 2048, 2048, (2048, 2048)),   # houv.yaml's step: a block a row
    (1024, 2048, 2048, (2048, 2048)),   # houv_fast's final phase
    (1024, 512, 512, (512, 512)),       # houv_fast's N/4 phase
    (64, 2048, 3072, (128, 3072)),      # the train steps: queries split
    (64, 2048, 1024, (128, 1024)),
    (32, 2048, 2048, (128, 2048)),
    (528, 2047, 2049, (2048, 2176)),    # whole rows from 4 x 132 rows on
    (264, 2048, 2048, (1024, 2048)),
    (1, 300, 3073, (128, 1664)),        # refs over 3072 split evenly
    (1, 129, 6145, (128, 2176)),
    (64, 2048, 4096, (256, 2048)),
])
def test_nn_plan_at_the_paths_shapes(bk, n, m, plan):
    assert chamfer._nn_plan(bk, n, m, 132) == plan


def test_nn_plan_invariants():
    """Whole tiles of 128; at most 3072 refs a block; the parts cover the
    points with none empty; queries stay whole while the rows alone give
    every SM 4 blocks, and otherwise split until they do or one tile is
    left."""
    for bk in (1, 3, 32, 64, 131, 528, 1024, 6400):
        for n in (1, 127, 129, 1025, 2048, 5000):
            for m in (1, 3, 257, 3072, 3073, 9000):
                qlen, rlen = chamfer._nn_plan(bk, n, m, 132)
                assert qlen % TILE == 0 and rlen % TILE == 0
                assert TILE <= rlen <= 3072
                qparts, rparts = -(-n // qlen), -(-m // rlen)
                assert (qparts - 1) * qlen < n <= qparts * qlen
                assert (rparts - 1) * rlen < m <= rparts * rlen
                if bk * rparts >= 4 * 132:
                    assert qparts == 1
                elif qlen > TILE:
                    assert bk * qparts * rparts >= 4 * 132


class _FakeLib:
    """Stands in for the built kernel library: records the entry's sizes
    and plan, and launches nothing."""

    def __init__(self):
        self.calls = []

    def houv_nn_both(self, a, b, bq, bk, n, m, qlen, rlen, i1, i2, stream):
        self.calls.append((bq, bk, n, m, qlen, rlen))
        return 0


def test_nn_both_on_cuda_takes_its_kernel_with_the_plan(monkeypatch):
    """With ``device="cuda"`` ``chamfer_indices`` hands ``_nn_plan``'s
    blocks to the C entry, counts one launch and never runs the plain
    version; a launch the card refuses raises. A card, the tensors'
    placement, the stream and the library are faked here: the routing is
    Python."""
    from houv_tpu_torch import kernels

    lib = _FakeLib()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(chamfer, "check_on", lambda dev, *tensors: None)
    monkeypatch.setattr(chamfer, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(kernels, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))

    def no_plain(*args):
        raise AssertionError("the plain version ran for device='cuda'")

    monkeypatch.setattr(chamfer, "_nn_both_plain", no_plain)
    monkeypatch.setattr(chamfer.chamfer_indices, "launches", 0)
    a = torch.zeros((2, 300, 3))
    b = torch.zeros((6, 5000, 3))
    i1, i2 = chamfer.chamfer_indices(a, b, device="cuda")
    assert i1.shape == (6, 300) and i2.shape == (6, 5000)
    assert i1.dtype == i2.dtype == torch.int64
    assert lib.calls == [(2, 6, 300, 5000, 128, 2560)]
    assert chamfer.chamfer_indices.launches == 1
    lib.houv_nn_both = lambda *args: 1
    lib.houv_error_string = lambda err: b"invalid argument"
    with pytest.raises(RuntimeError, match="nn_both launch failed"):
        chamfer.chamfer_indices(a, b, device="cuda")
    assert chamfer.chamfer_indices.launches == 1


def _sqdist(q, r):
    """(P, 3) x (Q, 3) f32 -> (P, Q), ((dx² + dy²) + dz²) op by op."""
    d = None
    for c in range(3):
        diff = q[:, None, c] - r[None, :, c]
        d = diff * diff if d is None else d + diff * diff
    return d


def _first_equal(values, target, index):
    """The smallest index whose value equals ``target``, or NONE."""
    hit = values == target
    return index[hit].min() if hit.any() else NONE


def _block_model(dist, strict):
    """One block's search on its (qn, rn) distances: per query (value,
    local ref index or NONE), per ref (value, local query index or NONE)."""
    less = np.less if strict else np.less_equal
    qn, rn = dist.shape
    ntq, ntr = -(-qn // TILE), -(-rn // TILE)
    d = np.full((ntq * TILE, ntr * TILE), np.nan, np.float32)
    d[:qn, :rn] = dist
    rows = []
    cval = np.full(ntr * TILE, np.inf, np.float32)
    cwhere = np.zeros(ntr * TILE, np.int64)
    for qt in range(ntq):
        tile = d[qt * TILE:(qt + 1) * TILE]
        # rows: a lane's minimum over its 8 refs of a tile, kept by tile
        rm = np.fmin.reduce(tile.reshape(TILE, ntr, TILE)[:, :, SLOTS], 3)
        best = np.full((TILE, 16), np.inf, np.float32)
        bt = np.zeros((TILE, 16), np.int64)
        for rt in range(ntr):
            hit = less(rm[:, rt], best)
            best = np.where(hit, rm[:, rt], best)
            bt = np.where(hit, rt, bt)
        for i in range(min(TILE, qn - qt * TILE)):
            v = best[i].min()
            found = NONE
            for lane in np.flatnonzero(best[i] == v):
                refs = bt[i, lane] * TILE + SLOTS[lane]
                found = min(found, _first_equal(tile[i, refs], v, refs))
            rows.append((v, found))
        # columns: a thread row's minimum over its 8 queries, merged per tile
        cm = np.fmin.reduce(tile.reshape(16, 8, ntr * TILE), 1)
        v = np.fmin.reduce(cm, 0)
        w = np.argmax(cm == v, 0)
        hit = less(v, cval)
        cval = np.where(hit, v, cval)
        cwhere = np.where(hit, qt * TILE + w * 8, cwhere)
    cols = []
    for j in range(rn):
        q = np.arange(cwhere[j], min(cwhere[j] + 8, qn))
        cols.append((cval[j], _first_equal(d[q, j], cval[j], q)))
    return rows, cols


def _merge(parts):
    """The blocks' (value, index) per point, merged as the 64-bit atomicMin
    merges them: lexicographically, a block with no index left out; none at
    all gives 0."""
    got = [(v, i) for v, i in parts if i != NONE]
    return min(got)[1] if got else 0


def _kernel_model(a, b, qlen, rlen, strict=True):
    """The kernel on numpy clouds, block by block, under the plan
    (qlen, rlen)."""
    bq, n, _ = a.shape
    bk, m, _ = b.shape
    share = bk // bq
    i1 = np.zeros((bk, n), np.int64)
    i2 = np.zeros((bk, m), np.int64)
    for r in range(bk):
        dist = _sqdist(a[r // share], b[r])
        rows = [[] for _ in range(n)]
        cols = [[] for _ in range(m)]
        for q0 in range(0, n, qlen):
            for j0 in range(0, m, rlen):
                br, bc = _block_model(dist[q0:q0 + qlen, j0:j0 + rlen],
                                      strict)
                for i, (v, j) in enumerate(br):
                    rows[q0 + i].append((v, NONE if j == NONE else j0 + j))
                for j, (v, i) in enumerate(bc):
                    cols[j0 + j].append((v, NONE if i == NONE else q0 + i))
        i1[r] = [_merge(p) for p in rows]
        i2[r] = [_merge(p) for p in cols]
    return i1, i2


def _copies(x, offsets, rng):
    """Exact copies x[:, i + o] = x[:, i] for a few i per offset."""
    x = x.copy()
    for k, o in enumerate(offsets):
        if o < x.shape[1]:
            src = rng.permutation(x.shape[1] - o)[:4 + k]
            x[:, src + o] = x[:, src]
    return x


def _clouds(rng, bq, share, n, m, kind):
    if kind == "grid":   # integer coordinates: most distances tie
        return (rng.integers(0, 4, (bq, n, 3)).astype(np.float32),
                rng.integers(0, 4, (bq * share, m, 3)).astype(np.float32))
    a = rng.standard_normal((bq, n, 3)).astype(np.float32)
    b = rng.standard_normal((bq * share, m, 3)).astype(np.float32)
    # copies in the next query, thread row, half, tile and block, and of
    # refs in the next lane, half, tile and block
    return (_copies(a, (1, 8, 64, 128, 256), rng),
            _copies(b, (1, 4, 64, 128, 256), rng))


@pytest.mark.parametrize("bq,share,n,m,plan,kind", [
    (1, 2, 300, 400, (384, 512), "copies"),   # whole rows
    (1, 2, 300, 400, (128, 512), "copies"),   # queries split: column merge
    (1, 1, 300, 400, (384, 256), "copies"),   # refs split: row merge
    (1, 1, 257, 385, (128, 128), "copies"),   # both split, ragged tiles
    (1, 2, 200, 300, (256, 256), "grid"),
    (1, 1, 200, 300, (128, 128), "grid"),
])
def test_nn_both_model_matches_plain_index_for_index(rng, bq, share, n, m,
                                                     plan, kind):
    """The modelled kernel picks what ``_nn_both_plain`` picks at every
    plan, exact ties everywhere."""
    a, b = _clouds(rng, bq, share, n, m, kind)
    want = chamfer._nn_both_plain(torch.tensor(a), torch.tensor(b))
    got = _kernel_model(a, b, *plan)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())


@pytest.mark.parametrize("kind", ["copies", "grid"])
def test_nn_both_model_needs_its_strict_compares(rng, kind):
    """With <= in place of the strict compares between tiles (a later tile
    winning a tie) the model no longer picks the plain version's indices:
    the ties above reach those compares."""
    a, b = _clouds(rng, 1, 2, 300, 400, kind)
    want = chamfer._nn_both_plain(torch.tensor(a), torch.tensor(b))
    loose = _kernel_model(a, b, 384, 512, strict=False)
    assert (loose[0] != want[0].numpy()).any()
    assert (loose[1] != want[1].numpy()).any()


@pytest.fixture(scope="module")
def variants_script():
    path = (Path(__file__).resolve().parents[1] / "scripts"
            / "time_nn_both_variants.py")
    spec = importlib.util.spec_from_file_location("time_nn_both_variants",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_nn_variant_sources_edit_the_shared_search(variants_script):
    """The search's constants live in ``csrc/nn_search.cuh``, which both
    K1 and K3 include: a variant sets them there, makes a raw edit in
    every file that holds its text (K1's and K3's launch bounds alike) and
    refuses an edit that applies nowhere; both kernels keep their names
    and include the header, and ``nn_select.cu`` has no tile loop of its
    own."""
    base = variants_script.variant_sources("base", {})
    assert set(base) == {"nn_search.cuh", "nn_both.cu", "nn_select.cu"}
    for cu, kernel in (("nn_both.cu", "nn_both_kernel("),
                       ("nn_select.cu", "nn_select_kernel(")):
        assert '#include "nn_search.cuh"' in base[cu]
        assert kernel in base[cu] and "nn_search(" in base[cu]
        assert "__vimin3_s32" not in base[cu] and "for (int rt" not in \
            base[cu]
    got = variants_script.variant_sources("v", {
        "kMaxRefs": 2048, "_blocks_per_sm": 3,
        "_raw": [["__launch_bounds__(kThreads, 3)",
                  "__launch_bounds__(kThreads, 2)"]]})
    assert "constexpr int kMaxRefs = 2048;" in got["nn_search.cuh"]
    assert "constexpr int kMaxRefs = 3072;" in base["nn_search.cuh"]
    for cu in ("nn_both.cu", "nn_select.cu"):
        assert "__launch_bounds__(kThreads, 2)" in got[cu]
        assert "__launch_bounds__(kThreads, 3)" not in got[cu]
    with pytest.raises(ValueError, match="no constant"):
        variants_script.variant_sources("x", {"kNoSuchConstant": 1})
    with pytest.raises(ValueError, match="in the sources"):
        variants_script.variant_sources("x", {"_raw": [["no such text",
                                                        ""]]})
