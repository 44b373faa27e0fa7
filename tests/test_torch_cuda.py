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
