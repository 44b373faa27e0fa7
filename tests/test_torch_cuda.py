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
    a_rows = a.repeat_interleave(share, 0).double()
    rows = torch.arange(bq * share, device="cuda")[:, None]

    def d(i1, i2):
        return (((a_rows - b.double()[rows, i1]) ** 2).sum(-1),
                ((b.double() - a_rows[rows, i2]) ** 2).sum(-1))

    # the kernel may contract to FMA where the plain version rounds each
    # op: picks may differ only between candidates within 1e-6 relative
    for k, p in zip(d(ki1, ki2), d(pi1, pi2)):
        torch.testing.assert_close(k, p, rtol=1e-6, atol=0)


def test_nn_both_exact_ties_go_to_the_smaller_index(gen):
    a = torch.randn((1, 600, 3), generator=gen)
    a[0, 550:] = a[0, :50]          # duplicates across query blocks
    b = torch.randn((1, 300, 3), generator=gen)
    b[0, 280:] = b[0, 10:30]
    ki1, ki2 = chamfer.chamfer_indices(a.cuda(), b.cuda())
    pi1, pi2 = chamfer.chamfer_indices(a, b, device="cpu")
    torch.testing.assert_close(ki1.cpu(), pi1, rtol=0, atol=0)
    torch.testing.assert_close(ki2.cpu(), pi2, rtol=0, atol=0)


@pytest.mark.parametrize("b,n,k", [(3, 1000, 100), (2, 4096, 64),
                                   (1, 5000, 300), (4, 7, 7)])
def test_fps_kernel_matches_plain_exactly(gen, b, n, k):
    pts = torch.randn((b, n, 3), generator=gen).cuda()
    before = sampling.furthest_point_sample.launches
    ki = sampling.furthest_point_sample(pts, k)
    assert sampling.furthest_point_sample.launches == before + 1
    torch.testing.assert_close(ki, sampling._fps_plain(pts, k), rtol=0, atol=0)


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
