"""The port's auction EMD against the JAX package's, on the CPU.

The JAX side runs as its own tests run it: the XLA auction
(``emd_auction`` on the CPU) and the TPU kernel in interpret mode
(``emd_auction_pallas``). Each ends within ε per bidder of an optimal
assignment's cost, so the mean matched squared distances of any two lie
within 2ε of each other, whatever near-ties each broke its own way; the
port's plain version must also return a permutation where they do.
"""

import importlib.util
import json
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from houv_tpu.ops.emd import emd_auction as jemd
from houv_tpu.ops.emd_kernel import emd_auction_pallas
from houv_tpu_torch.metrics.emd import calc_emd
from houv_tpu_torch.ops import emd as temd


def _is_perm(a):
    return all(len(np.unique(row)) == len(row) for row in np.asarray(a))


@pytest.mark.parametrize("eps,iters", [(0.005, 2000), (0.002, 5000)])
def test_auction_plain_against_jax(rng, eps, iters):
    x1 = rng.uniform(-0.5, 0.5, (2, 128, 3)).astype(np.float32)
    x2 = rng.uniform(-0.5, 0.5, (2, 128, 3)).astype(np.float32)
    d, a, rounds, bids = temd.emd_auction_with_stats(
        torch.tensor(x1), torch.tensor(x2), eps, iters, device="cpu")
    assert a.dtype == torch.int64 and _is_perm(a)
    assert (rounds < iters).all() and (bids >= 128).all()
    # dist is the squared distance of the assigned pair
    matched = np.take_along_axis(x2, a.numpy()[..., None], 1)
    np.testing.assert_allclose(d.numpy(), ((x1 - matched) ** 2).sum(-1),
                               rtol=1e-6, atol=1e-9)
    jd, ja = jemd(jnp.asarray(x1), jnp.asarray(x2), eps, iters)
    pd, pa = emd_auction_pallas(jnp.asarray(x1), jnp.asarray(x2), eps,
                                iters, interpret=True)
    for ref_d, ref_a in ((jd, ja), (pd, pa)):
        assert _is_perm(ref_a)
        np.testing.assert_allclose(d.numpy().mean(-1),
                                   np.asarray(ref_d).mean(-1), atol=2 * eps)


def test_identity_permutation_gives_zero(rng):
    x = rng.uniform(-0.5, 0.5, (2, 200, 3)).astype(np.float32)
    perm = rng.permutation(200)
    d, a = temd.emd_auction(torch.tensor(x), torch.tensor(x[:, perm]),
                            0.002, 500)
    assert float(d.max()) == 0.0
    np.testing.assert_array_equal(a.numpy(),
                                  np.tile(np.argsort(perm), (2, 1)))
    assert float(calc_emd(torch.tensor(x), torch.tensor(x)).max()) == 0.0


def test_cap_hit_falls_back_to_the_nearest_item(rng):
    """Capped at one round: with all prices 0 every bidder bid on its
    nearest item, one bidder per item won it, and every other bidder falls
    back to its nearest item (ties to the smaller), not to -1 — so all
    hold their nearest item, and the items collide."""
    x1 = rng.uniform(-0.5, 0.5, (1, 64, 3)).astype(np.float32)
    x2 = rng.uniform(-0.5, 0.5, (1, 64, 3)).astype(np.float32)
    d, a, rounds, bids = temd.emd_auction_with_stats(
        torch.tensor(x1), torch.tensor(x2), 0.005, 1, device="cpu")
    assert int(rounds[0]) == 1 and int(bids[0]) == 64
    sq = ((x1[:, :, None] - x2[:, None]) ** 2).sum(-1)
    np.testing.assert_array_equal(a.numpy(), sq.argmin(-1))
    assert not _is_perm(a)
    _, ja = jemd(jnp.asarray(x1), jnp.asarray(x2), 0.005, 1)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))


def test_zero_rounds_is_the_nearest_item(rng):
    x1 = rng.uniform(-0.5, 0.5, (2, 50, 3)).astype(np.float32)
    x2 = rng.uniform(-0.5, 0.5, (2, 50, 3)).astype(np.float32)
    d, a = temd.emd_auction(torch.tensor(x1), torch.tensor(x2), 0.005, 0)
    sq = ((x1[:, :, None] - x2[:, None]) ** 2).sum(-1)
    np.testing.assert_array_equal(a.numpy(), sq.argmin(-1))
    np.testing.assert_allclose(d.numpy(), sq.min(-1), rtol=1e-6)


@pytest.mark.parametrize("n,m", [(10, 12), (48, 32)],
                         ids=["fewer_bidders", "more_bidders"])
def test_n_not_m_matches_jax(rng, n, m):
    """The auction takes clouds of different sizes (VRCNet's coarse stages
    under ``loss: emd``), as JAX's XLA path does.
    With fewer bidders than items every bidder gets an item of its own; with
    more, those left at the round cap take their nearest item."""
    x1 = rng.uniform(-0.5, 0.5, (2, n, 3)).astype(np.float32)
    x2 = rng.uniform(-0.5, 0.5, (2, m, 3)).astype(np.float32)
    dist, assignment = temd.emd_auction(torch.tensor(x1), torch.tensor(x2))
    assert dist.shape == assignment.shape == (2, n)
    assert int(assignment.min()) >= 0 and int(assignment.max()) < m
    if n < m:
        assert all(len(torch.unique(row)) == n for row in assignment)
    jd, ja = jemd(jnp.asarray(x1), jnp.asarray(x2), 0.005, 50)
    np.testing.assert_array_equal(assignment.numpy(), np.asarray(ja))
    # JAX takes its distances in the expansion form: 1e-4 relative
    np.testing.assert_allclose(dist.numpy(), np.asarray(jd), rtol=1e-4,
                               atol=1e-8)


def test_calc_emd_is_the_mean_matched_distance(rng):
    x1 = rng.uniform(-0.5, 0.5, (2, 96, 3)).astype(np.float32)
    x2 = rng.uniform(-0.5, 0.5, (2, 96, 3)).astype(np.float32)
    d, _ = temd.emd_auction(torch.tensor(x1), torch.tensor(x2), 0.004, 3000)
    np.testing.assert_allclose(
        calc_emd(torch.tensor(x1), torch.tensor(x2), 0.004, 3000).numpy(),
        np.sqrt(d.numpy()).mean(-1), rtol=1e-6)


# --- a numpy model of csrc/emd.cu's rounds ---------------------------------
#
# The kernel deals a round's bidders out to the blocks of a cluster by list
# position (t mod C), S threads to a bidder within a block, a thread's items
# strided by S and scanned by a branch-free top-2; the S threads' triples
# merge by an xor tree within a warp and, past a warp, over the warps' slots.
# Bids go to 64-bit keys by atomicMax (any order); each list entry, rewritten
# as (item << 16 | row), then finds whether its row is in its item's key:
# winners take the item, and the evicted owners and the losers make the
# next list, in whatever order the atomics give. Once a cluster has kSolo or
# fewer bidders left, block 0 runs on alone. The model follows every one of
# those steps (the kernel's constants read from its source) and is held
# round by round (price bits, owners, the unassigned) against a numpy copy
# of _auction_plain's loop, itself held to _auction_plain.

_SRC = (Path(temd.__file__).resolve().parent.parent / "csrc"
        / "emd.cu").read_text()
THREADS = int(re.search(r"constexpr int kThreads = (\d+);", _SRC).group(1))
SOLO = int(re.search(r"constexpr int kSolo = (\d+);", _SRC).group(1))
F = np.float32
NONE = 0x7fffffff
MASK = 0xffffffff


def _sqdist(x1, x2):
    """(n, m) squared distances in the diff form, rounded op by op."""
    d = None
    for c in range(3):
        diff = x1[:, None, c] - x2[None, :, c]
        d = diff * diff if d is None else d + diff * diff
    return d


def _reference(d, eps, iters):
    """_auction_plain's loop for one pair: per round (price bits, owners,
    unassigned rows), then assignment, dist, rounds and bids."""
    n, m = d.shape
    eps = F(eps)
    rows = np.arange(n)
    price = np.zeros(m, F)
    owner = np.full(m, -1)
    assign = np.full(n, -1)
    states, bids = [], 0
    for _ in range(iters):
        unass = assign < 0
        if not unass.any():
            break
        bids += int(unass.sum())
        value = (-d) - price[None]
        bi = value.argmax(1)
        best = value[rows, bi]
        other = value.copy()
        other[rows, bi] = -np.inf
        inc = (best - other.max(1)) + eps
        win = np.full(m, -np.inf, F)
        np.maximum.at(win, bi[unass], inc[unass])
        is_w = unass & (inc == win[bi])
        wrow = np.full(m, n)
        np.minimum.at(wrow, bi[is_w], rows[is_w])
        j = np.nonzero(wrow < n)[0]
        prev = owner[j]
        assign[prev[prev >= 0]] = -1
        assign[wrow[j]] = j
        owner[j] = wrow[j]
        price[j] = price[j] + win[j]
        states.append((price.view(np.uint32).copy(), owner.copy(),
                       frozenset(np.nonzero(assign < 0)[0].tolist())))
    left = assign < 0
    assign[left] = d[left].argmin(1)
    return states, assign, d[rows, assign], len(states), bids


def _merge(a, b, larger_item=False):
    """The kernel's merge of (best, item, second) triples, elementwise."""
    (ab, ai, asec), (bb, bi, bsec) = a, b
    take = (bb > ab) | ((bb == ab) & ((bi > ai) if larger_item
                                      else (bi < ai)))
    return (np.where(take, bb, ab), np.where(take, bi, ai),
            np.where(take, np.fmax(ab, bsec), np.fmax(asec, bb)))


def _tree(t, width, larger_item):
    """The xor-shuffle merge over aligned groups of ``width`` lanes."""
    lanes = np.arange(t[0].shape[-1])
    off = width // 2
    while off:
        t = _merge(t, tuple(a[..., lanes ^ off] for a in t), larger_item)
        off //= 2
    return t


def _bidder_triples(values, larger_item):
    """The kernel's scan and merges for ``values`` (uc, m), one row a
    bidder of one block: (best, item, second) per bidder."""
    uc, m = values.shape
    s = 1 if uc >= THREADS else 1 << (THREADS // uc).bit_length() - 1
    lane = np.arange(s)
    best = np.full((uc, s), -np.inf, F)
    second = np.full((uc, s), -np.inf, F)
    idx = np.broadcast_to(np.where(lane < m, lane, NONE), (uc, s)).copy()
    for q in range(-(-m // s)):
        j = q * s + lane
        ok = j < m
        v = values[:, np.minimum(j, m - 1)]
        second = np.where(ok, np.fmax(second, np.fmin(v, best)), second)
        idx = np.where(ok & (v > best), j, idx)
        best = np.where(ok, np.fmax(best, v), best)
    t = _tree((best, idx, second), min(s, 32), larger_item)
    if s > 32:  # the warps' slots, merged by the warp that arrives last
        t = _tree(tuple(a[:, ::32] for a in t), s // 32, larger_item)
    return tuple(a[:, 0] for a in t)


def _model(d, eps, iters, clusters, rng, larger_item=False,
           larger_row=False):
    """csrc/emd.cu's rounds for one pair on a cluster of ``clusters``
    blocks: the same outputs as _reference, per round too."""
    n, m = d.shape
    eps = F(eps)
    price = np.zeros(m, F)
    key = np.zeros(m, np.uint64)
    owner = np.full(m, -1)
    cur = list(range(n))
    tag = (lambda i: i + 1) if larger_row else (lambda i: ~i & MASK)
    states, bids, c = [], 0, clusters

    def split(u):  # each block's positions of the list
        return [list(range(rank, u, c)) for rank in range(c)]

    while len(states) < iters and cur:
        if c > 1 and len(cur) <= SOLO:
            c = 1
        u = len(cur)
        for pos in split(u):
            if not pos:
                continue
            rows = np.array([cur[t] for t in pos])
            best, idx, second = _bidder_triples(
                (-d[rows]) - price[None], larger_item)
            inc = (best - second) + eps
            for k in rng.permutation(len(pos)):   # atomicMax, any order
                i, j = int(rows[k]), int(idx[k])
                if inc[k] == inc[k]:
                    bid = (int(inc[k:k + 1].view(np.uint32)[0]) << 32
                           | tag(i))
                    key[j] = max(int(key[j]), bid)
                cur[pos[k]] = j << 16 | i
        nxt = []
        for t in rng.permutation(u):             # phase B, any order
            rec = cur[t]
            j, i = rec >> 16, rec & 0xffff
            if int(key[j]) & MASK == tag(i):
                inc = np.array([int(key[j]) >> 32], np.uint32).view(F)[0]
                key[j] = 0
                if owner[j] >= 0:
                    nxt.append(int(owner[j]))
                owner[j] = i
                price[j] = price[j] + inc
            else:
                nxt.append(i)
        bids += u
        cur = nxt
        states.append((price.view(np.uint32).copy(), owner.copy(),
                       frozenset(cur)))
    assign = np.full(n, -1)
    dist = np.zeros(n, F)
    for pos in split(len(cur)):                  # the leftovers
        if pos:
            rows = np.array([cur[t] for t in pos])
            best, idx, _ = _bidder_triples(-d[rows], larger_item)
            assign[rows], dist[rows] = idx, -best
    seated = np.nonzero(owner >= 0)[0]
    assign[owner[seated]] = seated
    dist[owner[seated]] = d[owner[seated], seated]
    return states, assign, dist, len(states), bids


def _model_case(name):
    """(x1, x2, eps, iters) of one pair, made from a seed."""
    g = np.random.default_rng(7)
    u = lambda k: g.uniform(-0.5, 0.5, (k, 3)).astype(F)  # noqa: E731
    grid = lambda k: (g.integers(0, 4, (k, 3)) * 0.25).astype(F)  # noqa
    if name == "uniform":
        return u(96), u(96), 0.004, 3000
    if name == "repeated_points":
        x2 = u(96)
        x2[48:] = x2[:48]
        x1 = u(96)
        x1[64:] = x1[:32]
        return x1, x2, 0.004, 3000
    if name == "integer_grid":
        return grid(96), grid(96), 0.005, 3000
    if name == "permuted_copy":
        x1 = u(96)
        return x1, x1[g.permutation(96)], 0.002, 3000
    if name in ("bidders_48", "bidders_144"):
        return u(int(name[8:])), u(96), 0.005, 50
    if name in ("iters_0", "iters_1"):
        return u(96), u(96), 0.005, int(name[6:])
    raise ValueError(name)


MODEL_CASES = ("uniform", "repeated_points", "integer_grid", "permuted_copy",
               "bidders_48", "bidders_144", "iters_0", "iters_1")


@pytest.mark.parametrize("clusters", [1, 2, 3])
@pytest.mark.parametrize("case", MODEL_CASES)
def test_kernel_model_matches_plain_round_by_round(case, clusters):
    x1, x2, eps, iters = _model_case(case)
    d = _sqdist(x1, x2)
    ref = _reference(d, eps, iters)
    pd, pa, pr, pb = temd._auction_plain(
        torch.tensor(x1[None]), torch.tensor(x2[None]), eps, iters)
    np.testing.assert_array_equal(pa[0].numpy(), ref[1])
    np.testing.assert_array_equal(pd[0].numpy().view(np.uint32),
                                  ref[2].view(np.uint32))
    assert (int(pr[0]), int(pb[0])) == ref[3:]
    got = _model(d, eps, iters, clusters, np.random.default_rng(clusters))
    assert got[3:] == ref[3:]
    for r, ((gp, go, gu), (rp, ro, ru)) in enumerate(zip(got[0], ref[0])):
        np.testing.assert_array_equal(gp, rp, err_msg=f"prices, round {r}")
        np.testing.assert_array_equal(go, ro, err_msg=f"owners, round {r}")
        assert gu == ru, f"unassigned, round {r}"
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[2].view(np.uint32),
                                  ref[2].view(np.uint32))
    if case == "permuted_copy":
        assert float(got[2].max()) == 0.0


@pytest.mark.parametrize("mutation", ["larger_item", "larger_row"])
def test_kernel_model_fails_with_a_tie_to_the_larger_index(mutation):
    """The model (and so the test above) sees a merge that gives a tie to
    the larger item, and keys that give it to the larger row."""
    x1, x2, eps, iters = _model_case("integer_grid")
    d = _sqdist(x1, x2)
    ref = _reference(d, eps, iters)
    got = _model(d, eps, iters, 1, np.random.default_rng(0),
                 **{mutation: True})
    same = (got[3:] == ref[3:] and np.array_equal(got[1], ref[1])
            and all(np.array_equal(gp, rp) and np.array_equal(go, ro)
                    for (gp, go, _), (rp, ro, _) in zip(got[0], ref[0])))
    assert not same


def test_emd_plan():
    """C is the largest cluster size of which the card holds the batch in
    one wave; one block a pair from as many pairs as SMs."""
    held = {3: 39, 2: 66}
    assert set(held) == set(temd._EMD_CLUSTERS)
    assert [temd._emd_plan(b, 132, held)
            for b in (1, 30, 32, 39, 40, 64, 66, 67, 131, 132, 160)] == [
        3, 3, 3, 3, 2, 2, 2, 1, 1, 1, 1]
    assert temd._emd_plan(4, 132, dict.fromkeys(held, 0)) == 1
    assert temd._emd_plan(4, 4, held) == 1


_SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
_VARIANTS = json.loads((_SCRIPTS / "emd_variants.json").read_text())


@pytest.fixture(scope="module")
def variants_script():
    spec = importlib.util.spec_from_file_location(
        "time_emd_variants", _SCRIPTS / "time_emd_variants.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", list(_VARIANTS))
def test_emd_variant_sources_apply_to_the_kernel(variants_script, name):
    """Each variant PERF.md reports is still a text edit of csrc/emd.cu:
    the floor drops the item scan from the rounds, sizes above 3 blocks a
    pair are compiled in, constants and raw edits change the source."""
    subs = _VARIANTS[name]
    src = variants_script.variant_source(name, subs)
    assert (src == _SRC) == (set(subs) <= {"_clusters"}
                             and subs.get("_clusters", 1) <= 3)
    assert ("Triple tr = scan<kPrice>" in src) != bool(subs.get("_floor"))
    c = subs.get("_clusters", 1)
    assert all(f"return launch<{k}>" in src for k in range(1, max(c, 3) + 1))
    for const, value in subs.items():
        if not const.startswith("_"):
            assert f"constexpr int {const} = {value};" in src


def test_emd_variant_source_refuses_an_edit_that_does_not_apply(
        variants_script):
    with pytest.raises(ValueError, match="no constant"):
        variants_script.variant_source("x", {"kNoSuchConstant": 1})
    with pytest.raises(ValueError, match="in the source"):
        variants_script.variant_source("x", {"_raw": [["no such text", ""]]})
