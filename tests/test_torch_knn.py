"""The launch plan and the selection of the coordinate kNN kernel
(``csrc/knn.cu``), on the CPU.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``). Here its plan (``ops/grouping.py:_knn_plan``) is
checked at the paths' shapes and for its invariants, the wrapper's launch
on a faked card, and a numpy model of its whole selection (queries a
thread, thread queues merged when any lane of a warp could overflow, the
threshold read at each merge, ref parts and their merge, packed clouds)
against ``_knn_plain`` index for index, on clouds with planted exact ties.
"""

import bisect
import contextlib
import types

import numpy as np
import pytest
import torch

from houv_tpu_torch.ops import grouping as tg

THREADS, WARP = 128, 32
BATCH = 16                  # pairs a thread takes at once (16 / per refs)
BUCKETS = (4, 8, 16, 24, 32, 64)


def _bucket(k):
    return next(x for x in BUCKETS if k <= x)


def _insert(d, j, x, jx, strict):
    """The kernel's sorted insertion into the top-K list (K = len(d)): an
    equal entry stays ahead (behind it with ``strict=False``)."""
    t = (bisect.bisect_right if strict else bisect.bisect_left)(d, x)
    if t < len(d):
        d.insert(t, x)
        j.insert(t, jx)
        d.pop()
        j.pop()


def _part_lists(dist, k, jb, je, per, direct, strict):
    """One part [jb, je) of one cloud: dist (M, N) f32 -> per query its
    sorted top-K (distances, indices). Queries go to threads as the kernel
    puts them (thread t of block x: x * 128 per + t + 128 u, clamped to the
    last query), a warp's 32 threads run their batches of 16 / per refs
    together, and every queue (two batches long) merges when any query of
    the warp holds more than a batch of hits; ``direct`` (a list of 4 and
    parts of at most 128 refs) inserts each distance at once."""
    less = np.less if strict else np.less_equal
    m = dist.shape[0]
    big_k = _bucket(k)
    sub = BATCH // per
    span = -(-(je - jb) // sub) * sub
    cols = np.full((m, span), np.inf, np.float32)   # slots past je: +inf
    cols[:, :je - jb] = dist[:, jb:je]
    lists = {}
    for x0 in range(0, m, THREADS * per):
        for w in range(0, THREADS, WARP):
            rows = np.array([min(x0 + t + THREADS * u, m - 1)
                             for t in range(w, w + WARP) for u in range(per)])
            d = [[np.inf] * big_k for _ in rows]
            j = [[0] * big_k for _ in rows]
            thr = np.full(len(rows), np.inf, np.float32)
            queues = [[] for _ in rows]

            def merge():
                for a, queue in enumerate(queues):
                    for x, jx in queue:
                        _insert(d[a], j[a], x, jx, strict)
                    queue.clear()
                    thr[a] = d[a][k - 1]

            for s0 in range(0, span, sub):
                for r in range(sub):
                    x = cols[rows, s0 + r]
                    if direct:          # every distance inserted at once
                        for a in range(len(rows)):
                            _insert(d[a], j[a], x[a], jb + s0 + r, strict)
                        continue
                    for a in np.flatnonzero(less(x, thr)):
                        queues[a].append((x[a], jb + s0 + r))
                if any(len(q) > sub for q in queues):
                    merge()
            merge()
            for a, i in enumerate(rows):
                lists[int(i)] = (d[a], j[a])
    return [lists[i] for i in range(m)]


def _kernel_model(q, r, k, plan, strict=True):
    """The kernel's picks (B, M, k) under the plan (length, parts, queries
    a thread; 0: packed)."""
    length, parts, per = plan
    less = np.less if strict else np.less_equal
    dist = tg._sqdist_diff(torch.tensor(q), torch.tensor(r)).numpy()
    bsz, m, n = dist.shape
    out = np.zeros((bsz, m, k), np.int64)
    for b in range(bsz):
        if per == 0:    # packed: a lane per query, every ref inserted at once
            for i in range(m):
                d, j = [np.inf] * _bucket(k), [0] * _bucket(k)
                for jx in range(n):
                    _insert(d, j, dist[b, i, jx], jx, strict)
                out[b, i] = j[:k]
            continue
        direct = _bucket(k) <= 4 and min(length, n) <= 128
        lists = [_part_lists(dist[b], k, jb, min(n, jb + length), per,
                             direct, strict) for jb in range(0, n, length)]
        assert len(lists) == parts
        for i in range(m):
            d, j = list(lists[0][i][0]), list(lists[0][i][1])
            d[k:] = [np.inf] * (len(d) - k)
            for pd, pj in (lst[i] for lst in lists[1:]):
                for x, jx in zip(pd[:k], pj[:k]):
                    if not less(x, d[k - 1]):
                        break           # the part's list is sorted
                    _insert(d, j, x, jx, strict)
            out[b, i] = j[:k]
    return out


def _copies(x, offsets, rng):
    """Exact copies x[:, i + o] = x[:, i] for a few i per offset."""
    x = x.copy()
    for c, o in enumerate(offsets):
        if o < x.shape[1]:
            src = rng.permutation(x.shape[1] - o)[:3 + c]
            x[:, src + o] = x[:, src]
    return x


def _cloud(rng, b, n, kind):
    if kind == "grid":      # integer coordinates: most distances tie
        return rng.integers(0, 4, (b, n, 3)).astype(np.float32)
    x = rng.standard_normal((b, n, 3)).astype(np.float32)
    # copies in the next lane, warp, block (128 or 256 queries), tile (256
    # refs) and part
    return _copies(x, (1, 32, 96, 128, 200, 256, 300), rng)


def _uniform_groups(rng, clouds, n):
    """Ball groups as get_uniform_loss builds them: a ball with fewer hits
    than slots repeats its first hit, so many rows are equal."""
    pts = rng.uniform(-0.5, 0.5, (clouds, n, 3)).astype(np.float32)
    hits = rng.integers(1, n + 1, clouds)
    for c in range(clouds):
        pts[c, hits[c]:] = pts[c, 0]
    return pts


def _plain(q, r, k):
    return tg._knn_plain(torch.tensor(q), torch.tensor(r), k).numpy()


# plans chosen to cross every boundary of the scheme
@pytest.mark.parametrize("b,m,n,k,plan,kind", [
    (1, 300, 300, 20, (300, 1, 1), "copies"),       # one part, 3 blocks
    (1, 300, 300, 4, (300, 1, 2), "copies"),        # two queries a thread
    (1, 300, 300, 20, (96, 4, 1), "copies"),        # parts, the last short
    (2, 150, 400, 10, (128, 4, 1), "copies"),
    (2, 300, 400, 3, (128, 4, 2), "copies"),
    (1, 260, 300, 3, (300, 1, 2), "grid"),
    (1, 200, 300, 16, (64, 5, 1), "grid"),
    (6, 40, 40, 4, (40, 1, 0), "copies"),           # packed
    (6, 30, 50, 7, (50, 1, 0), "grid"),
])
def test_knn_model_matches_plain_index_for_index(rng, b, m, n, k, plan,
                                                 kind):
    q = _cloud(rng, b, max(m, n), kind)
    r = q[:, :n]
    q = q[:, :m]
    np.testing.assert_array_equal(_kernel_model(q, r, k, plan),
                                  _plain(q, r, k))


@pytest.mark.parametrize("k", [1, 4, 5, 8, 9, 16, 17, 24, 25, 32, 33, 64])
def test_knn_model_at_the_bucket_edges(rng, k):
    """Every k bucket's edge, self-kNN on an integer grid with its refs in
    two parts, and on planted copies in one."""
    x = _cloud(rng, 1, 200, "grid")
    np.testing.assert_array_equal(
        _kernel_model(x, x, k, (128, 2, 1)), _plain(x, x, k))
    y = _cloud(rng, 1, 160, "copies")
    np.testing.assert_array_equal(
        _kernel_model(y, y, k, (160, 1, 1)), _plain(y, y, k))


@pytest.mark.parametrize("n", [4, 8, 16, 24])
def test_knn_model_on_uniform_loss_groups(rng, n):
    """get_uniform_loss's balls at k 2: many clouds with repeated rows,
    packed, and the same clouds through the unpacked kernel."""
    g = _uniform_groups(rng, 40, n)
    want = _plain(g, g, 2)
    plan = tg._knn_plan(40, n, n, 2)
    assert plan == (n, 1, 0)
    np.testing.assert_array_equal(_kernel_model(g, g, 2, plan), want)
    for per in (1, 2):
        np.testing.assert_array_equal(_kernel_model(g, g, 2, (n, 1, per)),
                                      want)


@pytest.mark.parametrize("per", [1, 2, 4])
def test_knn_model_at_any_queries_a_thread(rng, per):
    """The queries a thread (and with them the refs a batch) change which
    queries share a warp's merges, not the picks."""
    x = _cloud(rng, 1, 300, "copies")
    np.testing.assert_array_equal(
        _kernel_model(x, x, 12, (300, 1, per)), _plain(x, x, 12))


@pytest.mark.parametrize("kind,plan", [("copies", (300, 1, 1)),
                                       ("grid", (96, 4, 2)),
                                       ("grid", (300, 1, 0))])
def test_knn_model_needs_its_strict_compares(rng, kind, plan):
    """With <= in place of the strict compares (the threshold test, the
    insertion, the merge of parts) the model no longer picks the plain
    version's indices: the ties above reach those compares."""
    x = _cloud(rng, 1, 300, kind)
    assert (_kernel_model(x, x, 8, plan, strict=False)
            != _plain(x, x, 8)).any()


@pytest.mark.parametrize("b,m,n,k,plan", [
    (32, 3072, 3072, 20, (3072, 1, 1)),   # VRCNet level 0, self
    (32, 3072, 3072, 10, (3072, 1, 2)),   # 384 blocks of 256 queries
    (32, 1536, 1536, 10, (1536, 1, 1)),   # 192 of 256: one query a thread
    (32, 384, 384, 20, (384, 1, 1)),      # parts would be under 512
    (32, 384, 768, 10, (512, 2, 1)),      # pk: 96 blocks, refs in 2 parts
    (32, 3072, 1536, 3, (1536, 1, 2)),    # three_nn
    (32, 1536, 768, 3, (768, 1, 1)),
    (32, 768, 384, 3, (256, 2, 1)),       # k <= 4: two blocks a SM
    (32, 1024, 3072, 16, (3072, 1, 1)),   # ECG's poolings
    (32, 256, 1024, 16, (512, 2, 1)),
    (32, 64, 256, 16, (256, 1, 1)),
    (32, 1024, 256, 3, (256, 1, 1)),      # ECG's three_nn
    (32, 256, 64, 3, (64, 1, 1)),
    (3264, 24, 24, 2, (24, 1, 0)),        # get_uniform_loss, packed
    (1632, 4, 4, 2, (4, 1, 0)),
])
def test_knn_plan_at_the_paths_shapes(b, m, n, k, plan):
    assert tg._knn_plan(b, m, n, k) == plan


def test_knn_plan_keeps_its_parts_whole():
    """Parts of at least k refs (or all N), and of 256 (k <= 4) or 512
    refs unless one, in multiples of 32, covering N in ascending order with
    none empty; one part where the blocks fill the SMs (twice over at k <=
    4); two queries a thread only up to k 16 and where their blocks fill
    the SMs twice over; packing exactly below its thresholds."""
    for b in (1, 2, 5, 32, 3264):
        for m in (1, 5, 63, 64, 127, 129, 256, 1999):
            for n in (1, 3, 17, 70, 256, 257, 777, 100000):
                for k in (1, 2, 4, 5, 16, 17, 64):
                    if k > n:
                        continue
                    length, parts, per = tg._knn_plan(b, m, n, k)
                    assert (per == 0) == (n <= 256 and m < 64)
                    assert (parts - 1) * length < n <= parts * length
                    assert length >= k
                    assert parts == 1 or (length % 32 == 0 and length >= (
                        256 if k <= 4 else 512))
                    assert 1 <= parts <= 2 * 132
                    assert per in (0, 1) or (
                        per == 2 and k <= 16 and b * -(-m // 256) >= 264)
                    per_sm = 2 if k <= 4 else 1
                    if per == 0 or b * -(-m // (128 * per)) >= per_sm * 132:
                        assert parts == 1


class _FakeLib:
    """Stands in for the built kernel library: records the coordinate
    entry's sizes and plan, and launches nothing."""

    def __init__(self):
        self.calls = []

    def houv_knn_max_k(self):
        return 64

    def houv_knn(self, q, r, b, m, n, k, per, length, scratch, out,
                 stream):
        self.calls.append((b, m, n, k, per, length, scratch is not None))
        return 0


@pytest.mark.parametrize("m,n,k,call", [
    (16, 9, 4, (2, 16, 9, 4, 0, 9, False)),        # packed
    (16, 300, 4, (2, 16, 300, 4, 1, 256, True)),   # refs in 2 parts
    (300, 70, 40, (2, 300, 70, 40, 1, 70, False)),
    (3000, 3000, 20, (2, 3000, 3000, 20, 1, 1024, True)),
])
def test_knn_hands_the_kernel_its_plan_and_scratch(monkeypatch, m, n, k,
                                                   call):
    """On ``cuda`` the coordinate form passes ``_knn_plan``'s queries a
    thread (0: packed) and part length, and scratch only when the refs
    split; one launch counted,
    the plain version never run (card, placement and stream faked: the
    routing is Python)."""
    from houv_tpu_torch import kernels

    lib = _FakeLib()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tg, "check_on", lambda dev, *tensors: None)
    monkeypatch.setattr(kernels, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(tg, "_knn_plain", None)
    monkeypatch.setattr(tg.knn_indices, "launches", 0)
    out = tg.knn_indices(torch.zeros((2, m, 3)), torch.zeros((2, n, 3)), k,
                         device="cuda")
    assert out.shape == (2, m, k)
    assert lib.calls == [call]
    assert tg.knn_indices.launches == 1
