"""Clouds above the card kernels' size limits, on the CPU: which kernel the
wrappers send each size to (pure Python over a faked card), the plans of
the cluster kernels, numpy models of their cross-block reductions, and the
plain versions that the card's kernels are held to, against the JAX
package.

K2 (``csrc/fps.cu``) takes up to 8192 points a cloud; above that
``ops/sampling.py`` sends the cloud to ``csrc/fps_large.cu`` (a cluster of
blocks a cloud, up to 65536 points), and larger ones to
``csrc/fps_global.cu``. K7 (``csrc/emd.cu``) keeps a pair's state in one
block's shared memory (28 bytes an item, 8 a bidder, at most 231424
bytes); above that ``ops/emd.py`` sends the pair to ``csrc/emd_large.cu``
(the items split over a cluster of 8 blocks' shared memory, the lists
copied into each: up to 17272 x 17272), and larger pairs to
``csrc/emd_global.cu``. Below the limits both plans are as before, and no
size raises. The plain FPS at 9000 points picks what JAX's
``furthest_point_sample(use_pallas=False)`` picks, index for index; the
plain auction above K7's limit returns JAX's assignment."""

import contextlib
import inspect
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from houv_tpu.ops import emd as jemd
from houv_tpu.ops import sampling as jsampling
from houv_tpu_torch import kernels
from houv_tpu_torch.kernels._build import _SIGNATURES
from houv_tpu_torch.ops import emd as temd
from houv_tpu_torch.ops import sampling as tsampling

FPS_MAX = 8192
FPS_CAPACITY = 8 * 8192
EMD_MAX_SMEM = 232448 - 1024
EMD_CAPACITY = 17272        # the largest square pair emd_large.cu holds
# an H100's most clusters at once, one block an SM (emd_large.cu's and
# emd_global.cu's blocks of 1024 threads; fps_large.cu's largest blocks)
H100_CLUSTERS = {16: 7, 8: 15, 4: 30, 2: 66}


def _emd_smem(n, m):
    """``houv_emd_smem_bytes``: the items' float4, key and owner, the
    bidders' two lists."""
    return 28 * m + 8 * n


def _emd_large_smem(n, m, c):
    """``houv_emd_large_smem_bytes``: a block's slice of the items (float4,
    key, owner), both lists, 16-byte aligned, and the partial triples of
    two chunks of 128 bidders from c blocks."""
    if n >= 65536 or m > 65536:
        return 2 ** 31 - 1
    lists = 28 * -(-m // c) + 8 * n
    return (lists + 15) // 16 * 16 + 2 * 128 * c * 16


def _emd_route(n, m):
    return temd._emd_route(_emd_smem(n, m), _emd_large_smem(n, m, 8),
                           EMD_MAX_SMEM)


@pytest.mark.parametrize("n,route", [(1, "fps"), (2048, "fps"),
                                     (8192, "fps"), (8193, "fps_large"),
                                     (16384, "fps_large"),
                                     (18432, "fps_large"),
                                     (FPS_CAPACITY, "fps_large"),
                                     (FPS_CAPACITY + 1, "fps_global"),
                                     (10 ** 7, "fps_global")])
def test_fps_routes_each_size_to_a_kernel(n, route):
    assert tsampling._fps_route(n, FPS_MAX, FPS_CAPACITY) == route
    if route == "fps":
        warps, per = tsampling._fps_plan(n)
        assert 32 * warps * per >= n
    if route == "fps_large":
        c, warps, per = tsampling._fps_cluster_plan(
            n, 4, lambda c, w, p: H100_CLUSTERS[c])
        assert c * 32 * warps * per >= n


@pytest.mark.parametrize("n,m,route", [
    (2048, 2048, "emd"), (6428, 6428, "emd"), (28924, 1, "emd"),
    (1, 8264, "emd"), (6429, 6429, "emd_large"), (8192, 8192, "emd_large"),
    (16384, 16384, "emd_large"), (EMD_CAPACITY, EMD_CAPACITY, "emd_large"),
    (1, 8265, "emd_large"), (1, 56752, "emd_large"),
    (3000, 40000, "emd_large"), (EMD_CAPACITY + 1, EMD_CAPACITY + 1,
                                 "emd_global"),
    (28925, 1, "emd_global"), (1, 56753, "emd_global"),
    (3000, 70000, "emd_global"), (70000, 3000, "emd_global")])
def test_emd_routes_each_size_to_a_kernel(n, m, route):
    assert _emd_route(n, m) == route


@pytest.mark.parametrize("n,b,plan", [
    (8192, 1, 8), (8192, 2, 8), (8192, 8, 8), (8192, 15, 8), (8192, 16, 8),
    (8192, 30, 8), (8192, 31, 8), (8192, 32, 8), (8192, 60, 8),
    (8192, 61, 2), (8192, 66, 2), (8192, 67, 8),
    (16384, 2, 8), (16384, 8, 8), (16384, 40, 8),
    (EMD_CAPACITY, 1, 8)])
def test_emd_large_plan_takes_the_largest_cluster_that_fits(n, b, plan):
    """Of the C whose blocks hold their share, the fewest waves of an
    H100's clusters per block a pair, ties to the larger C (at 16384 x
    16384 only 8 blocks hold it): validate's 32 pairs at 8192 take 8 in
    three waves (PERF.md: 544 ms, against 788 at 2 in one)."""
    got = temd._emd_large_plan(b, lambda c: _emd_large_smem(n, n, c),
                               EMD_MAX_SMEM, H100_CLUSTERS.get)
    assert got == plan


@pytest.mark.parametrize("b,plan", [(1, 8), (2, 8), (15, 8), (16, 4),
                                    (30, 4), (31, 2), (66, 2), (67, 1),
                                    (500, 1)])
def test_emd_global_plan_takes_the_largest_cluster_that_fits(b, plan):
    # an H100's counts for emd_global.cu's blocks of 1024 threads
    assert temd._emd_global_plan(b, {8: 15, 4: 30, 2: 66}) == plan


def _owners(n, c, warps, per):
    """How many (block, thread, point slot) of fps_large.cu's plan own each
    point of a cloud of n: block r owns [r nb, (r + 1) nb), its thread t the
    points r nb + t + T q, q < per."""
    threads = 32 * warps
    nb = -(-n // c)
    r, q, t = np.meshgrid(np.arange(c), np.arange(per), np.arange(threads),
                          indexing="ij")
    j = q * threads + t
    idx = r * nb + j
    return np.bincount(idx[(j < nb) & (idx < n)], minlength=n)


def test_fps_cluster_plans_cover_every_size_to_the_capacity():
    """Every N from 8193 to the capacity at the batches of the paths: the
    plan's C blocks hold the cloud within fps.cu's register caps (PER a
    power of two up to 32, at most its threads for that PER); each point is
    owned by exactly one thread of one block (counted at every 97th size
    and at the edges of the plan's blocks)."""
    def held(c, warps, per):
        return H100_CLUSTERS[c]

    def cost(n, b, c):
        nb = -(-n // c)
        return -(-b // H100_CLUSTERS[c]) * (10000 + nb)

    seen = set()
    for b in (1, 4, 8, 16, 64):
        for n in range(FPS_MAX + 1, FPS_CAPACITY + 1):
            c, warps, per = tsampling._fps_cluster_plan(n, b, held)
            nb = -(-n // c)
            assert per in tsampling._FPS_MAX_THREADS
            assert 32 * warps <= tsampling._FPS_MAX_THREADS[per]
            assert nb <= 32 * warps * per and nb <= FPS_MAX
            # the least cost of the sizes that hold the cloud, ties to the
            # larger C
            fits = [cc for cc in tsampling._FPS_CLUSTERS
                    if -(-n // cc) <= FPS_MAX]
            least = min(cost(n, b, cc) for cc in fits)
            assert c == max(cc for cc in fits if cost(n, b, cc) == least)
            seen.add((n, c, warps, per))
    sizes = {n for n in range(FPS_MAX + 1, FPS_CAPACITY + 1, 97)}
    sizes |= {FPS_MAX + 1, 16384, 18432, FPS_CAPACITY}
    for n, c, warps, per in seen:
        edge = -(-n // c) % (32 * warps) in (0, 1)
        if n in sizes or edge and n % 7 == 0:
            assert (_owners(n, c, warps, per) == 1).all()


@pytest.mark.parametrize("b,n,counts,plan", [
    (4, 16384, {8: 15, 4: 30, 2: 66}, 8),     # one wave at every C
    (64, 18432, {8: 32, 4: 30, 2: 66}, 8),    # 2 waves of 8 beat 3 of 4
    (30, 16384, {8: 15, 4: 30, 2: 66}, 4),    # 1 wave of 4 beats 2 of 8
    (16, 16384, {8: 0, 4: 30, 2: 66}, 4),     # 8 not admitted
    (1, FPS_CAPACITY, {8: 15, 4: 30, 2: 66}, 8)])
def test_fps_cluster_plan_weighs_waves_against_the_pass(b, n, counts, plan):
    """Waves times a step's cost (the chain, ``_FPS_CHAIN_POINTS``, plus a
    block's pass): on an H100 (64, 18432) -> 2048 took 4.34 ms at 8 blocks
    a cloud, 6.88 at the 4 of a one-wave-first plan (PERF.md)."""
    got = tsampling._fps_cluster_plan(n, b, lambda c, w, p: counts[c])
    assert got[0] == plan
    assert got[1:] == tsampling._fps_plan(-(-n // plan))


def test_fps_cluster_plan_refuses_a_card_that_admits_no_size():
    with pytest.raises(ValueError):
        tsampling._fps_cluster_plan(16384, 4, lambda c, w, p: 0)


class _FakeLib:
    """The built library's entries, recording what they are handed."""

    def __init__(self):
        self.calls = []

    def houv_fps_max_points(self):
        return FPS_MAX

    def houv_fps_large_max_points(self):
        return FPS_CAPACITY

    def houv_fps_large_max_clusters(self, c, warps, per):
        return H100_CLUSTERS[c]

    def houv_fps(self, pts, b, n, k, warps, per, out, stream):
        self.calls.append(("fps", b, n, k))
        return 0

    def houv_fps_large(self, pts, b, n, k, c, warps, per, out, stream):
        self.calls.append(("fps_large", b, n, k, c, warps, per))
        return 0

    def houv_fps_global(self, pts, b, n, k, work, out, stream):
        self.calls.append(("fps_global", b, n, k))
        return 0

    def houv_emd_smem_bytes(self, n, m):
        return _emd_smem(n, m)

    def houv_emd_max_smem_bytes(self):
        return EMD_MAX_SMEM

    def houv_emd_large_smem_bytes(self, n, m, c):
        return _emd_large_smem(n, m, c)

    def houv_emd_large_max_clusters(self, n, m, c):
        return H100_CLUSTERS[c]

    def houv_emd(self, x1, x2, b, n, m, eps, iters, clusters, dist, assign,
                 stats, stream):
        self.calls.append(("emd", b, n, m, clusters))
        return 0

    def houv_emd_large(self, x1, x2, b, n, m, eps, iters, clusters, dist,
                       assign, stats, stream):
        self.calls.append(("emd_large", b, n, m, clusters))
        return 0

    def houv_emd_global(self, x1, x2, b, n, m, eps, iters, clusters, items,
                        key, owner, lists, item, cnt, dist, assign, stats,
                        stream):
        self.calls.append(("emd_global", b, n, m, clusters))
        return 0


def test_the_faked_entries_take_the_built_signatures():
    """Every entry the fake stands in for has the arguments that
    ``kernels/_build.py`` types for the built library."""
    names = [n for n in vars(_FakeLib) if n.startswith("houv_")]
    assert {"houv_fps_large", "houv_fps_large_max_clusters",
            "houv_fps_global", "houv_emd_large", "houv_emd_large_smem_bytes",
            "houv_emd_large_max_clusters", "houv_emd_global"} <= set(names)
    for name in names:
        params = list(inspect.signature(getattr(_FakeLib, name)).parameters)
        assert len(params) - 1 == len(_SIGNATURES[name]), name


@pytest.fixture
def fake_card(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for mod in (tsampling, temd):
        monkeypatch.setattr(mod, "check_on", lambda dev, *tensors: None)
    monkeypatch.setattr(kernels, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(temd, "_max_global_clusters",
                        lambda index: {8: 15, 4: 30, 2: 66})
    monkeypatch.setattr(temd, "_large_held",
                        lambda n, m, c, index: H100_CLUSTERS[c])
    monkeypatch.setattr(tsampling, "_held",
                        lambda c, w, p, index: H100_CLUSTERS[c])
    monkeypatch.setattr(temd, "_card_plan", lambda b, n, m, dev: 3)
    for fn in (tsampling.furthest_point_sample, temd.emd_auction_with_stats):
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "large_launches", 0)
        monkeypatch.setattr(fn, "global_launches", 0)
    return lib


def test_fps_launches_the_large_variant_above_the_limit(fake_card):
    fps = tsampling.furthest_point_sample
    for n in (8192, 8193, 20000, FPS_CAPACITY + 1):
        out = fps(torch.zeros((2, n, 3)), 64, device="cuda")
        assert out.shape == (2, 64) and out.dtype == torch.int64
    held = lambda c, w, p: H100_CLUSTERS[c]  # noqa: E731
    assert fake_card.calls == [
        ("fps", 2, 8192, 64),
        ("fps_large", 2, 8193, 64, *tsampling._fps_cluster_plan(8193, 2,
                                                                 held)),
        ("fps_large", 2, 20000, 64, *tsampling._fps_cluster_plan(20000, 2,
                                                                 held)),
        ("fps_global", 2, FPS_CAPACITY + 1, 64)]
    assert fake_card.calls[1][4] == 8        # an H100 holds 2 clusters of 8
    assert (fps.launches, fps.large_launches, fps.global_launches) == (1, 2,
                                                                       1)


def test_emd_launches_the_large_variant_above_the_limit(fake_card):
    run = temd.emd_auction_with_stats
    for n, m in ((6428, 6428), (6429, 6429), (2, 20000),
                 (EMD_CAPACITY + 1, EMD_CAPACITY + 1)):
        d, a, r, b = run(torch.zeros((2, n, 3)), torch.zeros((2, m, 3)),
                         0.004, 10, device="cuda")
        assert d.shape == a.shape == (2, n) and r.shape == b.shape == (2,)
    assert fake_card.calls == [
        ("emd", 2, 6428, 6428, 3), ("emd_large", 2, 6429, 6429, 8),
        ("emd_large", 2, 2, 20000, 8),
        ("emd_global", 2, EMD_CAPACITY + 1, EMD_CAPACITY + 1, 8)]
    assert (run.launches, run.large_launches, run.global_launches) == (1, 2,
                                                                       1)
    # each design forced at a size that fits emd.cu (the card's checks)
    temd._emd_large_cuda(torch.zeros((3, 50, 3)), torch.zeros((3, 60, 3)),
                         0.005, 5, clusters=2)
    temd._emd_global_cuda(torch.zeros((3, 50, 3)), torch.zeros((3, 60, 3)),
                          0.005, 5, clusters=4)
    assert fake_card.calls[-2:] == [("emd_large", 3, 50, 60, 2),
                                    ("emd_global", 3, 50, 60, 4)]


def _fps_cluster_model(pts, k, c, warps, per, cross="first"):
    """``csrc/fps_large.cu``'s selection in numpy, one cloud: each thread's
    first largest running minimum (the f32 distance op by op), each warp's
    largest key and then smallest index, then the cluster's C W slots:
    ``cross`` "first" as the kernel (the largest key, then the smallest
    index), "largest_index" (the largest index among the largest keys) or
    "replace_on_equal" (a scan of the slots in order that replaces on >=:
    the last slot holding the largest key)."""
    n = pts.shape[0]
    threads = 32 * warps
    nb = -(-n // c)
    none = np.iinfo(np.int64).max
    r, q, t = np.meshgrid(np.arange(c), np.arange(per), np.arange(threads),
                          indexing="ij")
    j = q * threads + t
    idx = r * nb + j
    valid = (j < nb) & (idx < n)
    p = np.where(valid[..., None], pts[np.where(valid, idx, 0)], 0)
    p = p.astype(np.float32)
    mind = np.where(valid, np.float32(1e10), np.float32(0))
    out, last = [0], pts[0]
    for _ in range(1, k):
        dx, dy, dz = (p[..., a] - last[a] for a in range(3))
        d = (dx * dx + dy * dy) + dz * dz
        mind = np.minimum(mind, d)
        first = mind.argmax(axis=1)                       # (c, threads)
        key = np.take_along_axis(mind, first[:, None], 1)[:, 0]
        tidx = np.take_along_axis(np.where(valid, idx, none), first[:, None],
                                  1)[:, 0]
        key = key.reshape(c * warps, 32)
        tidx = tidx.reshape(c * warps, 32)
        wkey = key.max(axis=1)
        widx = np.where(key == wkey[:, None], tidx, none).min(axis=1)
        top = wkey.max()
        if cross == "first":
            win = widx[wkey == top].min()
        elif cross == "largest_index":
            win = widx[(wkey == top) & (widx != none)].max()
        else:
            best = 0
            for s in range(c * warps):
                if wkey[s] >= wkey[best]:
                    best = s
            win = widx[best]
        out.append(int(win))
        last = pts[win]
    return np.array(out)


def _fps_model_cases(rng):
    grid = rng.integers(0, 4, (500, 3)).astype(np.float32)
    twice = rng.standard_normal((250, 3)).astype(np.float32)
    return {"random": rng.standard_normal((513, 3)).astype(np.float32),
            "grid": grid, "every_point_twice": np.concatenate([twice,
                                                               twice])}


def test_fps_cluster_model_picks_what_the_plain_version_picks(rng):
    """The two-level argmax (threads, warps, then the cluster's slots) at
    4 blocks of 2 warps and 4 points a thread picks ``_fps_plain``'s
    indices on a random cloud, an integer grid and every point twice (K ==
    N there: every tie taken); a cross-block merge that keeps the largest
    index, or replaces on >=, does not on the grid or the duplicates."""
    for name, pts in _fps_model_cases(rng).items():
        k = pts.shape[0] if name != "random" else 200
        want = tsampling._fps_plain(torch.as_tensor(pts)[None], k)[0].numpy()
        got = _fps_cluster_model(pts, k, 4, 2, 4)
        np.testing.assert_array_equal(got, want, err_msg=name)
        for cross in ("largest_index", "replace_on_equal"):
            wrong = _fps_cluster_model(pts, k, 4, 2, 4, cross)
            if name == "random":
                np.testing.assert_array_equal(wrong, want)
            else:
                assert (wrong != want).any(), (name, cross)


def _slice_top2(v, lo, hi):
    """emd.cu's top-2 over items lo..hi - 1 of each row of v, in order: a
    value equal to the best goes to second and keeps the smaller item."""
    rows = v.shape[0]
    best = np.full(rows, -np.inf, np.float32)
    second = np.full(rows, -np.inf, np.float32)
    idx = np.full(rows, lo if lo < hi else np.iinfo(np.int64).max)
    for j in range(lo, hi):
        x = v[:, j]
        second = np.maximum(second, np.minimum(x, best))
        idx = np.where(x > best, j, idx)
        best = np.maximum(best, x)
    return best, idx, second


def _merge(a, b, smaller_item=True):
    """emd.cu's merge of partial (best, item, second) b into a: the larger
    best, on a tie the smaller item (``smaller_item`` False: the larger);
    second the largest value left at any other item."""
    (ab, ai, a2), (bb, bi, b2) = a, b
    tie = bi < ai if smaller_item else bi > ai
    take = (bb > ab) | ((bb == ab) & tie)
    return (np.where(take, bb, ab), np.where(take, bi, ai),
            np.where(take, np.maximum(ab, b2), np.maximum(a2, bb)))


def _split_top2(v, c, smaller_item=True):
    """``csrc/emd_large.cu``'s triple: the top-2 of each of the C slices of
    ceil(M / C) items, merged in rank order."""
    m = v.shape[1]
    mb = -(-m // c)
    out = _slice_top2(v, 0, 0)
    for r in range(c):
        out = _merge(out, _slice_top2(v, r * mb, min(m, (r + 1) * mb)),
                     smaller_item)
    return out


def test_emd_split_merge_equals_the_whole_scan(rng):
    """Random values, integer values (ties everywhere, second == best), a
    row of -inf and slices past M: the merged triple is the whole scan's,
    bit for bit; a merge that keeps the larger item on ties is not."""
    v = rng.standard_normal((40, 37)).astype(np.float32)
    ties = rng.integers(-3, 1, (40, 37)).astype(np.float32)
    ties[0] = -np.inf
    for name, vals in (("random", v), ("ties", ties)):
        whole = _slice_top2(vals, 0, vals.shape[1])
        for c in (2, 4, 8):
            split = _split_top2(vals, c)
            for w, s in zip(whole, split):
                np.testing.assert_array_equal(s, w, err_msg=f"{name} C{c}")
        if name == "ties":
            wrong = _split_top2(vals, 4, smaller_item=False)
            assert (wrong[1] != whole[1]).any()


def _auction_split(x1, x2, eps, iters, c):
    """The auction's rounds with ``_split_top2``'s bids (one pair): the
    winning bid per item the largest increment, then the smallest row,
    from the keys (increment bits << 32 | ~row); returns dist, assignment,
    rounds and bids as ``_auction_plain``."""
    n, m = x1.shape[0], x2.shape[0]
    diff = x1[:, None, :] - x2[None, :, :]
    dist = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) \
        + diff[..., 2] * diff[..., 2]
    price = np.zeros(m, np.float32)
    owner = np.full(m, -1)
    assign = np.full(n, -1)
    rounds = bids = 0
    eps = np.float32(eps)
    while rounds < iters and (assign < 0).any():
        rows = np.flatnonzero(assign < 0)
        best, item, second = _split_top2((-dist[rows]) - price, c)
        inc = (best - second) + eps
        key = np.zeros(m, np.uint64)
        for i, j, v in zip(rows, item, inc):
            if v == v:
                bid = (np.uint64(np.float32(v).view(np.uint32)) << 32) \
                    | np.uint64(~np.uint32(i) & 0xffffffff)
                key[j] = max(key[j], bid)
        for i, j in zip(rows, item):
            if key[j] and (int(key[j]) & 0xffffffff) == (~int(i) & 0xffffffff):
                if owner[j] >= 0:
                    assign[owner[j]] = -1
                owner[j], assign[i] = i, j
                price[j] = price[j] + np.uint32(int(key[j]) >> 32).view(
                    np.float32)
        rounds += 1
        bids += rows.size
    left = assign < 0
    assign[left] = dist[left].argmin(axis=1)
    return dist[np.arange(n), assign], assign, rounds, bids


@pytest.mark.parametrize("n,m,grid", [(96, 96, False), (80, 120, False),
                                      (120, 80, False), (64, 64, True)])
def test_emd_split_auction_matches_the_plain_version(rng, n, m, grid):
    """The rounds with the item-split merge over 4 slices return
    ``_auction_plain``'s assignment, distances, rounds and bids: the split
    does not change the auction (N != M both ways, and a grid of ties)."""
    if grid:
        x1 = rng.integers(0, 4, (n, 3)).astype(np.float32) / 4
        x2 = rng.integers(0, 4, (m, 3)).astype(np.float32) / 4
    else:
        x1 = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
        x2 = rng.uniform(-0.5, 0.5, (m, 3)).astype(np.float32)
    d, a, r, b = _auction_split(x1, x2, 0.005, 300, 4)
    pd, pa, pr, pb = temd._auction_plain(torch.as_tensor(x1)[None],
                                         torch.as_tensor(x2)[None], 0.005,
                                         300)
    np.testing.assert_array_equal(a, pa[0].numpy())
    np.testing.assert_array_equal(d.view(np.int32),
                                  pd[0].numpy().view(np.int32))
    assert (r, b) == (int(pr[0]), int(pb[0]))


def test_plain_fps_above_the_limit_matches_jax(rng):
    pts = rng.standard_normal((2, 9000, 3)).astype(np.float32)
    ref = np.asarray(jsampling.furthest_point_sample(
        jnp.asarray(pts), 300, use_pallas=False))
    got = tsampling.furthest_point_sample(torch.as_tensor(pts), 300,
                                          device="cpu")
    np.testing.assert_array_equal(got.numpy(), ref)


def test_plain_auction_above_the_limit_matches_jax(rng):
    """6500 bidders against 6500 items, past K7's shared memory: the
    assignment JAX's XLA auction gives; the distances the matched pairs'
    (diff form, 1e-6 relative) and JAX's within 1e-6 (JAX forms them from
    the expansion |a|² + |b|² - 2 a·b, about 1e-7 off at these
    coordinates)."""
    x1 = rng.uniform(-0.5, 0.5, (1, 6500, 3)).astype(np.float32)
    x2 = rng.uniform(-0.5, 0.5, (1, 6500, 3)).astype(np.float32)
    assert _emd_smem(6500, 6500) > EMD_MAX_SMEM
    d, a = temd.emd_auction(torch.as_tensor(x1), torch.as_tensor(x2),
                            0.005, 3)
    jd, ja = jemd.emd_auction(jnp.asarray(x1), jnp.asarray(x2), 0.005, 3)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    matched = np.take_along_axis(x2, a.numpy()[..., None], 1)
    np.testing.assert_allclose(d.numpy(), ((x1 - matched) ** 2).sum(-1),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=1e-6)
