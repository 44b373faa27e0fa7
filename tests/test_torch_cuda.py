"""The port's CUDA kernels against their plain versions, on the card.

Skips without a CUDA device. On a machine with one:
    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import pytest
import torch

from houv_tpu_torch.ops import chamfer, sampling

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator().manual_seed(0)


@pytest.mark.parametrize("bq,share,n,m", [(2, 8, 300, 257), (1, 1, 1025, 3),
                                          (3, 4, 1, 700)])
def test_nn_both_kernel_matches_plain(gen, bq, share, n, m):
    a = torch.randn((bq, n, 3), generator=gen).cuda()
    b = torch.randn((bq * share, m, 3), generator=gen).cuda()
    before = chamfer.chamfer_indices.launches
    ki1, ki2 = chamfer.chamfer_indices(a, b)
    assert chamfer.chamfer_indices.launches == before + 1
    pi1, pi2 = chamfer._nn_both_plain(a, b)
    torch.testing.assert_close(ki1, pi1, rtol=0, atol=0)
    torch.testing.assert_close(ki2, pi2, rtol=0, atol=0)


def test_nn_both_exact_ties_go_to_the_smaller_index(gen):
    a = torch.randn((1, 600, 3), generator=gen)
    a[0, 550:] = a[0, :50]          # duplicates across query blocks
    b = torch.randn((1, 300, 3), generator=gen)
    b[0, 280:] = b[0, 10:30]
    ki1, ki2 = chamfer.chamfer_indices(a.cuda(), b.cuda())
    pi1, pi2 = chamfer.chamfer_indices(a, b, device="cpu")
    torch.testing.assert_close(ki1.cpu(), pi1, rtol=0, atol=0)
    torch.testing.assert_close(ki2.cpu(), pi2, rtol=0, atol=0)


def _copies(x, offsets, gen):
    """Exact copies x[:, i + o] = x[:, i] for a few i per offset."""
    x = x.clone()
    for k, o in enumerate(offsets):
        if o < x.shape[1]:
            src = torch.randperm(x.shape[1] - o, generator=gen)[:4 + k]
            x[:, src + o] = x[:, src]
    return x


# tiles of 128 and their halves of 64; queries split over blocks of 128
# (few rows) or whole (528 rows: 4 blocks a SM); 3072 refs a block
@pytest.mark.parametrize("bq,share,n,m", [
    (2, 1, 127, 129), (2, 1, 129, 127), (2, 1, 63, 65), (2, 1, 65, 64),
    (2, 1, 255, 300), (2, 1, 257, 385), (4, 1, 2048, 1), (4, 1, 2048, 3),
    (4, 1, 2048, 257), (8, 66, 129, 257), (8, 66, 300, 129),
    (1, 1, 300, 3071), (1, 1, 300, 3073), (1, 1, 129, 6145),
    (8, 66, 129, 3073)])
def test_nn_both_kernel_at_its_edges_with_planted_copies(gen, bq, share, n,
                                                         m):
    """Index for index with the plain version, on random clouds and then
    with exact copies of points in the next query, thread row, tile and
    block, and of refs in the next lane, half, tile and ref block: the
    smaller index wins every tie."""
    a = torch.randn((bq, n, 3), generator=gen)
    b = torch.randn((bq * share, m, 3), generator=gen)
    for qa, rb in ((a, b), (_copies(a, (1, 8, 64, 128, 256), gen),
                            _copies(b, (1, 4, 64, 128, 3072), gen))):
        ki1, ki2 = chamfer.chamfer_indices(qa.cuda(), rb.cuda())
        pi1, pi2 = chamfer._nn_both_plain(qa, rb)
        torch.testing.assert_close(ki1.cpu(), pi1, rtol=0, atol=0)
        torch.testing.assert_close(ki2.cpu(), pi2, rtol=0, atol=0)


@pytest.mark.parametrize("bq,share", [(2, 3), (8, 66)])
def test_nn_both_kernel_on_integer_grids(gen, bq, share):
    """Integer coordinates: nearly every distance ties with others."""
    a = torch.randint(0, 4, (bq, 700, 3), generator=gen).float()
    b = torch.randint(0, 4, (bq * share, 500, 3), generator=gen).float()
    ki1, ki2 = chamfer.chamfer_indices(a.cuda(), b.cuda())
    pi1, pi2 = chamfer._nn_both_plain(a, b)
    torch.testing.assert_close(ki1.cpu(), pi1, rtol=0, atol=0)
    torch.testing.assert_close(ki2.cpu(), pi2, rtol=0, atol=0)


# one point, a warp, N beside each size where the plan's block or points a
# thread change, the limit; K == 1, K == N and K > N; a batch of 1 and 64
@pytest.mark.parametrize("b,n,k", [
    (3, 1000, 100), (2, 4096, 64), (1, 5000, 300), (4, 7, 7),
    (2, 1, 1), (2, 1, 4), (3, 31, 31), (3, 33, 33), (2, 127, 127),
    (2, 129, 129), (2, 255, 255), (2, 257, 257), (2, 511, 300),
    (2, 513, 513), (2, 767, 300), (2, 769, 769), (2, 1023, 300),
    (2, 1025, 1025), (2, 1535, 300), (2, 1537, 300), (2, 2047, 300),
    (2, 2049, 300), (2, 3071, 300), (2, 3073, 300), (2, 4095, 300),
    (2, 4097, 300), (1, 8192, 8192), (4, 2048, 1), (1, 2048, 1024),
    (64, 3072, 2048)])
def test_fps_kernel_matches_plain_exactly(gen, b, n, k):
    pts = torch.randn((b, n, 3), generator=gen).cuda()
    before = sampling.furthest_point_sample.launches
    ki = sampling.furthest_point_sample(pts, k)
    assert sampling.furthest_point_sample.launches == before + 1
    torch.testing.assert_close(ki, sampling._fps_plain(pts, k), rtol=0, atol=0)


@pytest.mark.parametrize("b,n,k,c", [(4, 700, 700, 4), (3, 2048, 1024, 6),
                                     (1, 8192, 2048, 8), (64, 256, 256, 3)])
def test_fps_kernel_on_integer_grids(gen, b, n, k, c):
    """Integer coordinates: the running minima tie all the time."""
    pts = torch.randint(0, c, (b, n, 3), generator=gen).float().cuda()
    torch.testing.assert_close(sampling.furthest_point_sample(pts, k),
                               sampling._fps_plain(pts, k), rtol=0, atol=0)


@pytest.mark.parametrize("b,n", [(2, 2048), (1, 8192), (64, 256)])
def test_fps_kernel_on_duplicated_rows(gen, b, n):
    """Every point twice, K == N: the second half comes after the first,
    and the last picks have a running minimum of 0."""
    pts = torch.randn((b, n, 3), generator=gen)
    pts[:, n // 2:] = pts[:, :n // 2]
    pts = pts.cuda()
    torch.testing.assert_close(sampling.furthest_point_sample(pts, n),
                               sampling._fps_plain(pts, n), rtol=0, atol=0)


def test_fps_kernel_refuses_more_than_its_limit(gen):
    """K2 takes no cloud above 8192 points: such a cloud runs
    ``csrc/fps_large.cu``, index for index as the plain version."""
    fps = sampling.furthest_point_sample
    for n in (8193, 16384):
        pts = torch.randn((2, n, 3), generator=gen).cuda()
        before = (fps.launches, fps.large_launches)
        got = fps(pts, 512)
        assert (fps.launches, fps.large_launches) == (before[0],
                                                      before[1] + 1)
        torch.testing.assert_close(got, sampling._fps_plain(pts, 512),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("clusters", [2, 4, 8, 16])
def test_fps_cluster_kernel_at_every_cluster_size(gen, clusters):
    """``csrc/fps_large.cu`` forced at each cluster size, index for index as
    the plain version (16 where the card admits it)."""
    if sampling._held(clusters, *sampling._fps_plan(-(-9001 // clusters)),
                      0) == 0:
        pytest.skip(f"the card admits no cluster of {clusters}")
    pts = torch.randn((2, 9001, 3), generator=gen).cuda()
    torch.testing.assert_close(sampling._fps_large_cuda(pts, 700, clusters),
                               sampling._fps_plain(pts, 700), rtol=0, atol=0)


def test_fps_past_the_cluster_capacity_runs_the_global_design(gen):
    """65536 points run ``csrc/fps_large.cu``, one more
    ``csrc/fps_global.cu``; each index for index as the plain version."""
    fps = sampling.furthest_point_sample
    for n, route in ((65536, 1), (65537, 2)):
        pts = torch.randn((1, n, 3), generator=gen).cuda()
        before = [fps.launches, fps.large_launches, fps.global_launches]
        got = fps(pts, 128)
        after = [fps.launches, fps.large_launches, fps.global_launches]
        assert [a - b for a, b in zip(after, before)] == [
            int(i == route) for i in range(3)]
        torch.testing.assert_close(got, sampling._fps_plain(pts, 128),
                                   rtol=0, atol=0)


def test_emd_past_the_cluster_capacity_runs_the_global_design(gen):
    """17272 bidders against 17272 items run ``csrc/emd_large.cu``,
    against 17281 ``csrc/emd_global.cu``; each equal to the plain
    version."""
    from houv_tpu_torch.ops import emd

    run = emd.emd_auction_with_stats
    x1 = torch.rand((1, 17272, 3), generator=gen).cuda()
    for m, route in ((17272, 1), (17281, 2)):
        x2 = torch.rand((1, m, 3), generator=gen).cuda()
        before = [run.launches, run.large_launches, run.global_launches]
        got = run(x1, x2, 0.005, 3)
        after = [run.launches, run.large_launches, run.global_launches]
        assert [a - b for a, b in zip(after, before)] == [
            int(i == route) for i in range(3)]
        for k, p in zip(got, emd._auction_plain(x1, x2, 0.005, 3)):
            torch.testing.assert_close(k, p, rtol=0, atol=0)


@pytest.mark.parametrize("b,m,n,k", [(2, 300, 257, 17), (1, 1025, 3, 3),
                                     (3, 129, 700, 64), (32, 384, 384, 20)])
def test_knn_kernel_matches_plain_exactly(gen, b, m, n, k):
    from houv_tpu_torch.ops import grouping

    q = torch.randn((b, m, 3), generator=gen).cuda()
    r = torch.randn((b, n, 3), generator=gen).cuda()
    before = grouping.knn_indices.launches
    ki = grouping.knn_indices(q, r, k)
    assert grouping.knn_indices.launches == before + 1
    torch.testing.assert_close(ki, grouping._knn_plain(q, r, k),
                               rtol=0, atol=0)


def test_knn_exact_ties_go_to_the_smaller_index(gen):
    from houv_tpu_torch.ops import grouping

    r = torch.randn((1, 500, 3), generator=gen)
    r[0, 250:] = r[0, :250]             # every point twice
    ki = grouping.knn_indices(r.cuda(), r.cuda(), 6)
    torch.testing.assert_close(ki.cpu(), grouping._knn_plain(r, r, 6),
                               rtol=0, atol=0)


def _knn_exact(q, r, k):
    """One coordinate-kNN launch, and the plain version's indices exactly."""
    from houv_tpu_torch.ops import grouping

    before = grouping.knn_indices.launches
    ki = grouping.knn_indices(q.cuda(), r.cuda(), k)
    assert grouping.knn_indices.launches == before + 1
    torch.testing.assert_close(ki.cpu(), grouping._knn_plain(q, r, k),
                               rtol=0, atol=0)
    return ki


# csrc/knn.cu's edges: fewer queries than a warp, sizes off the blocks,
# tiles and batches, N == k, refs in parts with a short last one, packed
# clouds at and beside the threshold (M < 64, N <= 256)
@pytest.mark.parametrize("b,m,n,k", [
    (3, 5, 700, 5), (2, 31, 3000, 20), (2, 33, 257, 10), (2, 129, 255, 3),
    (2, 257, 513, 16), (4, 300, 20, 20), (2, 100, 64, 64), (1, 700, 1, 1),
    (3, 384, 385, 20), (5, 200, 1000, 33), (1, 130, 3001, 64),
    (700, 63, 256, 8), (700, 64, 256, 8), (600, 63, 257, 4),
    (4000, 7, 7, 7), (3264, 24, 24, 2)])
def test_knn_kernel_at_its_edges_with_planted_copies(gen, b, m, n, k):
    """Index for index with the plain version, on random clouds and with
    exact copies of points in the next lane, warp, block, tile and part."""
    x = torch.rand((b, max(m, n), 3), generator=gen) - 0.5
    _knn_exact(x[:, :m], x[:, :n], k)
    x = _copies(x, (1, 32, 128, 256, 300, 1024), gen)
    _knn_exact(x[:, :m], x[:, :n], k)


@pytest.mark.parametrize("k", [1, 4, 5, 8, 9, 16, 17, 24, 25, 32, 33, 64])
def test_knn_kernel_at_its_bucket_edges_on_integer_grids(gen, k):
    """Ties everywhere, with the refs whole (32 clouds) and in parts (2)."""
    for b in (32, 2):
        g = torch.randint(0, 4, (b, 700, 3), generator=gen).float()
        _knn_exact(g, g, k)


def test_knn_kernel_on_equal_points_and_repeated_rows(gen):
    """Every point equal (the first k indices), and clouds whose rows
    repeat their first, as get_uniform_loss's balls, packed and not."""
    same = torch.full((4, 300, 3), 0.25)
    for k in (1, 20, 64):
        ki = _knn_exact(same, same, k)
        assert bool((ki.cpu() == torch.arange(k)).all())
    for clouds, n in ((3264, 24), (1632, 12), (40, 300)):
        g = torch.rand((clouds, n, 3), generator=gen) - 0.5
        hits = torch.randint(1, n + 1, (clouds,), generator=gen)
        g = torch.where(torch.arange(n)[None, :, None] < hits[:, None, None],
                        g, g[:, :1])
        _knn_exact(g, g, 2)


@pytest.mark.parametrize("b,n,eps,iters", [(3, 300, 0.005, 50),
                                           (2, 1024, 0.004, 3000),
                                           (4, 33, 0.01, 0)])
def test_emd_kernel_matches_plain(gen, b, n, eps, iters):
    from houv_tpu_torch.ops import emd

    x1 = torch.rand((b, n, 3), generator=gen).cuda()
    x2 = torch.rand((b, n, 3), generator=gen).cuda()
    before = emd.emd_auction_with_stats.launches
    kd, ka, kr, kb = emd.emd_auction_with_stats(x1, x2, eps, iters)
    assert emd.emd_auction_with_stats.launches == before + 1
    pd, pa, pr, pb = emd._auction_plain(x1, x2, eps, iters)
    # the same rounds in the same f32 arithmetic: identical assignments
    torch.testing.assert_close(ka, pa, rtol=0, atol=0)
    torch.testing.assert_close(kd, pd, rtol=0, atol=0)
    torch.testing.assert_close(kr, pr, rtol=0, atol=0)
    torch.testing.assert_close(kb, pb, rtol=0, atol=0)


@pytest.mark.parametrize("n,m", [(1024, 2048), (3072, 2048), (33, 7)])
def test_emd_kernel_takes_clouds_of_different_sizes(gen, n, m):
    from houv_tpu_torch.ops import emd

    x1 = torch.rand((3, n, 3), generator=gen).cuda() - 0.5
    x2 = torch.rand((3, m, 3), generator=gen).cuda() - 0.5
    kd, ka, kr, kb = emd.emd_auction_with_stats(x1, x2, 0.005, 50)
    pd, pa, pr, pb = emd._auction_plain(x1, x2, 0.005, 50)
    torch.testing.assert_close(ka, pa, rtol=0, atol=0)
    torch.testing.assert_close(kd, pd, rtol=0, atol=0)
    torch.testing.assert_close(kr, pr, rtol=0, atol=0)
    torch.testing.assert_close(kb, pb, rtol=0, atol=0)
    x1.requires_grad_(True)
    d, a = emd.emd_auction(x1, x2)
    d.sum().backward()
    ref = 2.0 * (x1.detach() - torch.gather(
        x2, 1, a[..., None].expand(-1, -1, 3)))
    torch.testing.assert_close(x1.grad, ref, rtol=0, atol=0)


@pytest.mark.parametrize("clusters", range(1, 4))
def test_emd_kernel_at_every_cluster_size(gen, clusters):
    """One block a pair and clusters of 2 and 3 (distributed shared
    memory, block 0 alone for the tail): the plain version's assignment,
    distances, rounds and bids, clouds of different sizes too."""
    from houv_tpu_torch.ops import emd

    for n, m, eps, iters in ((700, 700, 0.004, 3000), (300, 90, 0.005, 50)):
        x1 = torch.rand((3, n, 3), generator=gen).cuda()
        x2 = torch.rand((3, m, 3), generator=gen).cuda()
        got = emd._emd_cuda(x1, x2, eps, iters, clusters)
        for k, p in zip(got, emd._auction_plain(x1, x2, eps, iters)):
            torch.testing.assert_close(k, p, rtol=0, atol=0)


def test_emd_kernel_size_limit(gen):
    """28 bytes an item and 8 a bidder in one block's shared memory: 6428
    against 6428 and 1 against 8264 run on K7, one more point on
    ``csrc/emd_large.cu`` (a cluster's shared memory); each equal to the
    plain version."""
    from houv_tpu_torch.ops import emd

    run = emd.emd_auction_with_stats
    for n, m, large in ((6428, 6428, 0), (1, 8264, 0), (6429, 6429, 1),
                        (1, 8265, 1)):
        x1 = torch.rand((1, n, 3), generator=gen).cuda()
        x2 = torch.rand((1, m, 3), generator=gen).cuda()
        before = (run.launches, run.large_launches)
        got = run(x1, x2, 0.005, 5)
        assert (run.launches, run.large_launches) == (
            before[0] + 1 - large, before[1] + large)
        for k, p in zip(got, emd._auction_plain(x1, x2, 0.005, 5)):
            torch.testing.assert_close(k, p, rtol=0, atol=0)


@pytest.mark.parametrize("b,n,m,c", [(64, 2048, 3072, 3), (3, 1999, 777, 3),
                                     (5, 300, 130, 8), (2, 1, 4, 1),
                                     (2, 5000, 3, 2)])
def test_scatter_kernel_matches_plain_bit_for_bit(gen, b, n, m, c):
    from houv_tpu_torch.ops import scatter

    idx = torch.randint(-3, m + 3, (b, n), generator=gen).cuda()
    vals = torch.randn((b, n, c), generator=gen).cuda()
    before = scatter.scatter_add.launches
    out = scatter.scatter_add(idx, vals, m)
    assert scatter.scatter_add.launches == before + 1
    # both add in ascending i from 0: equal, not close
    torch.testing.assert_close(out, scatter._scatter_add_plain(idx, vals, m),
                               rtol=0, atol=0)
    torch.testing.assert_close(out, scatter.scatter_add(idx, vals, m),
                               rtol=0, atol=0)


def _scatter_edge(case, gen):
    """(idx, vals, m) on the card for one of the kernel's edges."""
    if case == "order_sensitive":           # +-1e8 and +-1 in every row
        idx = torch.randint(0, 128, (4, 2048), generator=gen)
        big = torch.rand((4, 2048, 3), generator=gen) < 0.5
        sign = torch.randn((4, 2048, 3), generator=gen).sign()
        return idx.cuda(), (torch.where(big, 1e8, 1.0) * sign).cuda(), 128
    if case == "negative_zero":             # -0.0 alone in its row
        idx = torch.stack([torch.randperm(1024, generator=gen)[:512]
                           for _ in range(4)])
        vals = torch.randn((4, 512, 3), generator=gen)
        vals[:, ::2] = -0.0
        return idx.cuda(), vals.cuda(), 1024
    if case == "one_row_N8192":             # two chunks of one row
        vals = (torch.randn((2, 8192, 3), generator=gen)
                * 10 ** (6 * torch.rand((2, 8192, 1), generator=gen) - 3))
        return torch.full((2, 8192), 7).cuda(), vals.cuda(), 16
    b, n, m = {"rows_M200000": (2, 4096, 200000),
               "batch_B70000": (70000, 4, 4)}[case]
    idx = torch.randint(-1, m + 1, (b, n), generator=gen)
    return idx.cuda(), torch.randn((b, n, 3), generator=gen).cuda(), m


@pytest.mark.parametrize("case", ["order_sensitive", "negative_zero",
                                  "one_row_N8192", "rows_M200000",
                                  "batch_B70000"])
def test_scatter_kernel_at_its_edges_bit_for_bit(gen, case):
    """Bits, not values: -0.0 and +0.0 differ there."""
    from houv_tpu_torch.ops import scatter

    idx, vals, m = _scatter_edge(case, gen)
    out = scatter.scatter_add(idx, vals, m)
    plain = scatter._scatter_add_plain(idx, vals, m)
    torch.testing.assert_close(out.view(torch.int32), plain.view(torch.int32),
                               rtol=0, atol=0)
    again = scatter.scatter_add(idx, vals, m)
    torch.testing.assert_close(again.view(torch.int32),
                               out.view(torch.int32), rtol=0, atol=0)


def test_scatter_kernel_calls_no_library_scatter(gen, monkeypatch):
    from houv_tpu_torch.ops import scatter

    def no_library(*args, **kwargs):
        raise AssertionError("a library scatter or gather ran")

    for owner, name in ((torch.Tensor, "scatter_add_"),
                        (torch.Tensor, "index_add_"), (torch, "gather")):
        monkeypatch.setattr(owner, name, no_library)
    idx, vals, m = _scatter_edge("order_sensitive", gen)
    assert scatter.scatter_add(idx, vals, m).shape == (4, 128, 3)


def test_scatter_kernel_rejects_what_it_does_not_take(gen):
    from houv_tpu_torch.ops import scatter

    idx = torch.zeros((1, 4), dtype=torch.int64).cuda()
    with pytest.raises(ValueError, match="channels"):
        scatter.scatter_add(idx, torch.zeros((1, 4, 9)).cuda(), 4)
    with pytest.raises(ValueError, match="device"):
        scatter.scatter_add(idx.cpu(), torch.zeros((1, 4, 3)).cuda(), 4)


def test_chamfer_gradient_on_the_card(gen):
    """The Function's gradients (two scatter launches) against autograd
    through the gathered form with the same matches; autograd's gather
    backward adds with atomics: 1e-5 of the largest entry."""
    from houv_tpu_torch.ops import scatter
    from houv_tpu_torch.ops.gather import gather_rows

    a = torch.rand((4, 700, 3), generator=gen).cuda().requires_grad_(True)
    b = torch.rand((4, 900, 3), generator=gen).cuda().requires_grad_(True)
    w1 = torch.randn((4, 700), generator=gen).cuda()
    w2 = torch.randn((4, 900), generator=gen).cuda()
    before = scatter.scatter_add.launches
    d1, d2, i1, i2 = chamfer.chamfer(a, b)
    ga, gb = torch.autograd.grad((d1 * w1).sum() + (d2 * w2).sum(), (a, b))
    assert scatter.scatter_add.launches == before + 2
    r1 = ((a - gather_rows(b, i1)) ** 2).sum(-1)
    r2 = ((b - gather_rows(a, i2)) ** 2).sum(-1)
    ra, rb = torch.autograd.grad((r1 * w1).sum() + (r2 * w2).sum(), (a, b))
    for ours, ref in ((ga, ra), (gb, rb)):
        torch.testing.assert_close(ours, ref, rtol=0,
                                   atol=1e-5 * float(ref.abs().max()))
    # gt needs no gradient: one launch
    before = scatter.scatter_add.launches
    d1, d2, _, _ = chamfer.chamfer(a.detach(), b)
    (d1.sum() + d2.sum()).backward()
    assert scatter.scatter_add.launches == before + 1


@pytest.mark.parametrize("b,m,n,c,k", [(32, 256, 256, 48, 16),
                                       (2, 300, 257, 24, 17),
                                       (1, 1025, 70, 9, 40),
                                       (3, 129, 700, 513, 64),
                                       (2, 5, 3, 12, 3), (4, 100, 90, 1, 4)])
def test_knn_wide_kernel_matches_plain_exactly(gen, b, m, n, c, k):
    from houv_tpu_torch.ops import grouping

    q = torch.relu(torch.randn((b, m, c), generator=gen)).cuda()
    r = torch.relu(torch.randn((b, n, c), generator=gen)).cuda()
    before = (grouping.knn_indices.launches,
              grouping.knn_indices.wide_launches)
    ki = grouping.knn_indices(q, r, k)
    assert (grouping.knn_indices.launches,
            grouping.knn_indices.wide_launches) == (before[0], before[1] + 1)
    # both sum the diff form in ascending c, op by op: equal, not close
    torch.testing.assert_close(ki, grouping._knn_plain(q, r, k),
                               rtol=0, atol=0)


def test_knn_wide_self_match_and_exact_ties(gen):
    from houv_tpu_torch.ops import grouping

    x = torch.randn((2, 600, 24), generator=gen)
    x[:, 300:] = x[:, :300]                 # every row twice
    neg, ki = grouping.knn_points(x.cuda(), x.cuda(), 6)
    torch.testing.assert_close(ki.cpu(), grouping._knn_plain(x, x, 6),
                               rtol=0, atol=0)
    assert bool((neg[..., :2] == 0).all())  # itself and its copy, exactly
    assert bool((ki[:, :, 0].cpu() == torch.arange(600) % 300).all())


def _knn_wide_exact(q, r, k):
    """One wide launch, and the plain version's indices exactly."""
    from houv_tpu_torch.ops import grouping

    before = grouping.knn_indices.wide_launches
    ki = grouping.knn_indices(q, r, k)
    assert grouping.knn_indices.wide_launches == before + 1
    torch.testing.assert_close(ki, grouping._knn_plain(q, r, k),
                               rtol=0, atol=0)
    return ki


@pytest.mark.parametrize("c", [23, 24, 25, 47, 48, 49, 63, 64, 65, 255, 256,
                               257])
def test_knn_wide_kernel_on_and_beside_its_compiled_widths(gen, c):
    q = torch.relu(torch.randn((2, 150, c), generator=gen)).cuda()
    r = torch.relu(torch.randn((2, 700, c), generator=gen)).cuda()
    _knn_wide_exact(q, r, 16)
    _knn_wide_exact(q, r, 4)


@pytest.mark.parametrize("k", [1, 4, 5, 8, 9, 16, 17, 31, 32, 33, 63, 64])
def test_knn_wide_kernel_at_its_bucket_and_queue_edges(gen, k):
    q = torch.relu(torch.randn((2, 130, 24), generator=gen)).cuda()
    r = torch.relu(torch.randn((2, 400, 24), generator=gen)).cuda()
    _knn_wide_exact(q, r, k)


@pytest.mark.parametrize("b,m,n,c,k", [(32, 256, 256, 48, 16),
                                       (32, 64, 64, 48, 16),
                                       (3, 50, 70, 24, 16),
                                       (2, 7, 5, 48, 3),
                                       (1, 1, 3000, 256, 4),
                                       (4, 100, 333, 9, 33)])
def test_knn_wide_kernel_with_its_refs_in_parts(gen, b, m, n, c, k):
    """Refs split into parts (N not a multiple of a part, N below one part),
    fewer queries than a block, and the merge of the parts' lists."""
    from houv_tpu_torch.ops import grouping

    assert grouping._wide_plan(b, m, n, k)[1] > 1 or n < 16
    q = torch.relu(torch.randn((b, m, c), generator=gen)).cuda()
    r = torch.relu(torch.randn((b, n, c), generator=gen)).cuda()
    _knn_wide_exact(q, r, k)


@pytest.mark.parametrize("n,c", [(256, 48), (600, 24), (600, 256),
                                 (300, 37)])
def test_knn_wide_exact_ties_across_lanes_warps_blocks_and_parts(gen, n, c):
    x = torch.relu(torch.randn((32, n, c), generator=gen))
    for i in (0, 5, 40):
        for shift in (1, 33, 130):        # another lane, warp, block
            x[:, i + shift] = x[:, i]
    x[:, 192:256] = x[:, :64]             # another part at 256 points
    ki = _knn_wide_exact(x.cuda(), x.cuda(), 16)
    assert bool((ki[:, 192:256, 0] < 64).all())


def test_knn_wide_kernel_on_rows_off_16_byte_alignment(gen):
    flat = torch.randn(2 * 400 * 24 + 1, generator=gen).cuda()
    x = flat[1:].view(2, 400, 24)
    assert x.data_ptr() % 16 != 0
    _knn_wide_exact(x, x, 16)


# random clouds at small shapes; refs split over blocks (M > 3072) with the
# queries whole (264 rows) and with both split; the solver's share at its
# whole plan, and split (4 pairs: 256 rows, 512 queries a block); the
# queries split (32 rows); planted copies at each plan
@pytest.mark.parametrize("bq,share,n,m,copies", [
    (2, 8, 300, 257, False), (1, 1, 1025, 3, False), (3, 5, 1, 700, False),
    (2, 64, 513, 600, False), (33, 8, 300, 3100, False),
    (1, 1, 300, 3100, False), (16, 64, 2048, 2048, False),
    (4, 64, 2048, 2048, False),
    (32, 1, 2048, 1024, False), (16, 64, 2048, 2048, True),
    (33, 8, 300, 3100, True), (1, 1, 300, 3100, True),
    (32, 1, 2048, 1024, True)])
def test_nn_select_kernel_matches_plain_bit_for_bit(gen, bq, share, n, m,
                                                    copies):
    """Bit for bit the plain version's coordinates, and the rows K1's own
    indices name."""
    from houv_tpu_torch.ops.gather import gather_rows

    a = torch.randn((bq, n, 3), generator=gen)
    b = torch.randn((bq * share, m, 3), generator=gen)
    if copies:
        a = _copies(a, (1, 8, 64, 128, 256, 2048), gen)
        b = _copies(b, (1, 4, 64, 128, 2048, 3072), gen)
    a, b = a.cuda(), b.cuda()
    b[:, -1] = b[:, 0]                      # an exact tie in every cloud
    before = chamfer.nn_select.launches
    k1, k2 = chamfer.nn_select(a, b)
    assert chamfer.nn_select.launches == before + 1
    p1, p2 = chamfer._nn_select_plain(a, b)
    torch.testing.assert_close(k1, p1, rtol=0, atol=0)
    torch.testing.assert_close(k2, p2, rtol=0, atol=0)
    i1, i2 = chamfer.chamfer_indices(a, b)
    assert torch.equal(k1, gather_rows(b, i1))
    assert torch.equal(k2, gather_rows(a, i2.reshape(bq, -1)).reshape(
        bq * share, m, 3))


@pytest.mark.parametrize("b,m,n,c", [(16, 2048, 4096, 3), (3, 777, 1999, 1),
                                     (5, 130, 300, 8), (2, 40, 64, 67)])
def test_gather_rows_kernel_matches_plain_bit_for_bit(gen, b, m, n, c):
    from houv_tpu_torch.ops import scatter

    src = torch.randn((b, m, c), generator=gen).cuda()
    idx = torch.randint(-3, m + 3, (b, n), generator=gen).cuda()
    before = scatter.gather_rows_kernel.launches
    out = scatter.gather_rows_kernel(src, idx)
    assert scatter.gather_rows_kernel.launches == before + 1
    torch.testing.assert_close(out, scatter._gather_rows_plain(src, idx),
                               rtol=0, atol=0)
    inside = idx.clamp(0, m - 1)
    torch.testing.assert_close(
        scatter.gather_rows_kernel(src, inside),
        torch.gather(src, 1, inside[..., None].expand(-1, -1, c)),
        rtol=0, atol=0)


def test_gather_rows_kernel_past_the_grid_limit(gen):
    """70,000 batch entries of one channel: two launches of the grid."""
    from houv_tpu_torch.ops import scatter

    src = torch.randn((70000, 8, 1), generator=gen).cuda()
    idx = torch.randint(-2, 10, (70000, 16), generator=gen).cuda()
    torch.testing.assert_close(scatter.gather_rows_kernel(src, idx),
                               scatter._gather_rows_plain(src, idx),
                               rtol=0, atol=0)


def test_cuda_tensors_never_reach_a_plain_version(gen, monkeypatch):
    """With tensors on the card every wrapper launches its kernel: the plain
    versions are made to raise here, and each count goes up by one."""
    from houv_tpu_torch.ops import emd, grouping, scatter

    def no_plain(*args, **kwargs):
        raise AssertionError("a plain version ran for CUDA tensors")

    for mod, name in ((chamfer, "_nn_both_plain"),
                      (chamfer, "_nn_select_plain"),
                      (sampling, "_fps_plain"), (grouping, "_knn_plain"),
                      (emd, "_auction_plain"),
                      (scatter, "_scatter_add_plain"),
                      (scatter, "_gather_rows_plain")):
        monkeypatch.setattr(mod, name, no_plain)
    pts = torch.rand((2, 64, 3), generator=gen).cuda()
    feats = torch.rand((2, 64, 24), generator=gen).cuda()
    idx = torch.randint(0, 64, (2, 64), generator=gen).cuda()
    counts = {"nn_both": (chamfer.chamfer_indices, "launches"),
              "nn_select": (chamfer.nn_select, "launches"),
              "fps": (sampling.furthest_point_sample, "launches"),
              "knn": (grouping.knn_indices, "launches"),
              "knn_wide": (grouping.knn_indices, "wide_launches"),
              "emd": (emd.emd_auction_with_stats, "launches"),
              "scatter": (scatter.scatter_add, "launches"),
              "gather_rows": (scatter.gather_rows_kernel, "launches")}
    before = {k: getattr(fn, attr) for k, (fn, attr) in counts.items()}
    chamfer.chamfer_indices(pts, pts)
    chamfer.nn_select(pts, pts)
    sampling.furthest_point_sample(pts, 8)
    grouping.knn_indices(pts, pts, 4)
    grouping.knn_indices(feats, feats, 4)
    emd.emd_auction_with_stats(pts, pts.flip(1), 0.01, 10)
    scatter.scatter_add(idx, pts, 64)
    scatter.gather_rows_kernel(pts, idx)
    torch.cuda.synchronize()
    assert {k: getattr(fn, attr) - before[k]
            for k, (fn, attr) in counts.items()} == dict.fromkeys(counts, 1)
