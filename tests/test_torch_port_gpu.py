"""The port's CUDA kernels against their plain PyTorch versions on the card
(marked ``gpu``; each test skips where there is no CUDA device): the forward
kernels, the backward kernels (inter dTable / dW, intra df / dW) at a small
and a flagship shape, and the autograd Functions' launches.

Run on a machine with the card:
  python -m pytest tests/test_torch_port_gpu.py -q -m gpu --noconftest
(tests/conftest.py imports jax, which that machine does not need to have).
"""

import numpy as np
import pytest
import torch

from epn_pointcloud_tpu_torch.ops import icosahedron as tico
from epn_pointcloud_tpu_torch.ops import kernel_points as tkp
from epn_pointcloud_tpu_torch.ops import kernels as tkern
from epn_pointcloud_tpu_torch.ops import so3conv as tso3

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (hand-written kernels have no '
                    'CPU mode; their plain versions are tested on the CPU)')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def _ball_points(rng, b, n):
    v = rng.randn(b, n, 3)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return (v * rng.rand(b, n, 1) ** (1.0 / 3.0)).astype(np.float32)


def _conv_close(got, want, depth):
    """Normwise relative error <= 1e-5 and elementwise within the fp32
    reassociation bound of tests/test_pallas_inter_conv.py:294-303."""
    err = (got - want).norm() / want.norm().clamp(min=1e-30)
    assert float(err) <= 1e-5, float(err)
    torch.testing.assert_close(got, want, rtol=max(1e-5, depth * 1.3e-7),
                               atol=1e-4)


@pytest.mark.parametrize('b,n,m', [(4, 1024, 512), (3, 300, 77)])
def test_fps_kernel_equals_plain(cuda, b, n, m):
    x = torch.from_numpy(_ball_points(np.random.RandomState(n), b, n)).to(cuda)
    x[:, 3] = 0.0
    got = tkern.fps.fps(x, m)
    torch.cuda.synchronize()
    assert torch.equal(got, tkern.fps.fps_plain(x, m))


@pytest.mark.parametrize('m,n,ns,r', [(512, 1024, 32, 0.2), (64, 128, 16, 0.3),
                                      (16, 12, 32, 0.6), (30, 2100, 8, 0.05)])
def test_ball_query_kernel_equals_plain(cuda, m, n, ns, r):
    rng = np.random.RandomState(m)
    q = torch.from_numpy(_ball_points(rng, 2, m)).to(cuda)
    s = torch.from_numpy(_ball_points(rng, 2, n)).to(cuda)
    got = tkern.ball_query.ball_query(q, s, r, ns)
    torch.cuda.synchronize()
    assert torch.equal(got, tkern.ball_query.ball_query_plain(q, s, r, ns))


@pytest.mark.parametrize('p1,stride,nn,c,d', [(128, 2, 32, 64, 128),
                                              (64, 1, 16, 256, 256),
                                              (48, 1, 16, 24, 32),
                                              (64, 1, 48, 16, 64),
                                              (40, 2, 8, 32, 96)])
def test_inter_conv_kernel_matches_plain(cuda, p1, stride, nn, c, d):
    rng = np.random.RandomState(c)
    x = torch.from_numpy(_ball_points(rng, 2, p1)).to(cuda)
    f = torch.from_numpy(rng.randn(2, p1, 60, c).astype(np.float32)).to(cuda)
    kern = torch.from_numpy(tkp.get_spherical_kernel_points(0.28, 1)).to(cuda)
    anchors = torch.from_numpy(tico.get_anchors(60)).to(cuda)
    W = torch.from_numpy(
        (0.05 * rng.randn(24, c, d)).astype(np.float32)).to(cuda)
    gx, idx, _, _ = tso3.sampling.inter_grouping_ball(x, stride, 0.4, nn)
    rk, k2 = tso3.rotated_kernels(anchors, kern)
    args = (gx.contiguous(), idx, f, rk, k2, W, 0.08)
    got = tkern.inter_conv.inter_conv(*args)
    torch.cuda.synchronize()
    _conv_close(got, tkern.inter_conv.inter_conv_plain(*args), 24 * c)


def test_inter_conv_kernel_reads_shadow_index_as_zero(cuda):
    """Neighbor slots holding the shadow index q read a zero table row."""
    rng = np.random.RandomState(7)
    b, p2, nn, q, c, d = 2, 30, 16, 50, 32, 64
    gx = torch.from_numpy((0.2 * rng.randn(b, p2, nn, 3)).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, q + 1, (b, p2, nn)).astype(np.int32))
    idx[:, :, ::3] = q
    f = torch.from_numpy(rng.randn(b, q, 60, c).astype(np.float32))
    kern = torch.from_numpy(tkp.get_spherical_kernel_points(0.28, 1))
    rk, k2 = tso3.rotated_kernels(torch.from_numpy(tico.get_anchors(60)), kern)
    W = torch.from_numpy((0.05 * rng.randn(24, c, d)).astype(np.float32))
    args = [t.to(cuda) for t in (gx, idx, f, rk, k2, W)] + [0.08]
    got = tkern.inter_conv.inter_conv(*args)
    torch.cuda.synchronize()
    _conv_close(got, tkern.inter_conv.inter_conv_plain(*args), 24 * c)


@pytest.mark.parametrize('p,c,d', [(64, 64, 64), (16, 256, 256), (8, 40, 96)])
def test_intra_conv_kernel_matches_plain(cuda, p, c, d):
    rng = np.random.RandomState(p)
    f = torch.from_numpy(rng.randn(2, p, 60, c).astype(np.float32)).to(cuda)
    W = torch.from_numpy((0.05 * rng.randn(12, c, d)).astype(np.float32)).to(cuda)
    ti = torch.from_numpy(tico.get_intra_idx()).to(cuda)
    got = tkern.intra_conv.intra_conv(f, ti, W)
    torch.cuda.synchronize()
    _conv_close(got, tkern.intra_conv.intra_conv_plain(f, ti, W), 12 * c)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    f = torch.zeros(1, 2, 60, 8, device=cuda)
    ti = torch.from_numpy(tico.get_intra_idx()).to(cuda)
    with pytest.raises(ValueError):
        tkern.intra_conv.intra_conv(f, ti, torch.zeros(12, 8, 48, device=cuda))
    with pytest.raises(ValueError):
        tkern.intra_conv.intra_conv(f, ti.long(),
                                    torch.zeros(12, 8, 32, device=cuda))
    with pytest.raises(ValueError):          # c % 4 != 0
        tkern.intra_conv.intra_conv(torch.zeros(1, 2, 60, 6, device=cuda), ti,
                                    torch.zeros(12, 6, 32, device=cuda))


def _rel(got, want):
    return float((got - want).norm() / want.norm().clamp(min=1e-30))


def _inter_operands(cuda, b, p1, stride, nn, c, d, seed=0):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(_ball_points(rng, b, p1)).to(cuda)
    f = torch.from_numpy(rng.randn(b, p1, 60, c).astype(np.float32)).to(cuda)
    kern = torch.from_numpy(tkp.get_spherical_kernel_points(0.28, 1)).to(cuda)
    anchors = torch.from_numpy(tico.get_anchors(60)).to(cuda)
    W = torch.from_numpy(
        (0.05 * rng.randn(24, c, d)).astype(np.float32)).to(cuda)
    gx, idx, _, _ = tso3.sampling.inter_grouping_ball(x, stride, 0.4, nn)
    rk, k2 = tso3.rotated_kernels(anchors, kern)
    p2 = idx.shape[1]
    dout = torch.from_numpy(
        rng.randn(b, p2, 60, d).astype(np.float32)).to(cuda)
    return gx.contiguous(), idx, f, rk, k2, W, dout


# (b, p1, stride, nn, c, d): a small shape, and flagship L1 / L2 at b=12
BWD_SHAPES = [(2, 64, 1, 16, 64, 64), (12, 512, 1, 16, 64, 64),
              (12, 512, 2, 32, 64, 128)]


@pytest.mark.parametrize('b,p1,stride,nn,c,d', BWD_SHAPES)
def test_inter_conv_bwd_kernels_match_plain(cuda, b, p1, stride, nn, c, d):
    """dTable (normwise <= 1e-5; its atomics reorder the sums) and dW
    (normwise <= 1e-4: reductions over up to b*p*60 = 368,640 rows)."""
    gx, idx, f, rk, k2, W, dout = _inter_operands(cuda, b, p1, stride, nn, c,
                                                  d)
    ic = tkern.inter_conv
    dT = ic.inter_conv_dtable(gx, idx, p1, rk, k2, W, dout, 0.08)
    dW = ic.inter_conv_dw(gx, idx, f, rk, k2, dout, 0.08)
    torch.cuda.synchronize()
    assert _rel(dT, ic.inter_conv_dtable_plain(gx, idx, p1, rk, k2, W, dout,
                                               0.08)) <= 1e-5
    assert _rel(dW, ic.inter_conv_dw_plain(gx, idx, f, rk, k2, dout,
                                           0.08)) <= 1e-4


def test_inter_conv_dtable_skips_shadow_index(cuda):
    """Neighbor slots holding the shadow index q add nothing to dT."""
    rng = np.random.RandomState(8)
    b, p2, nn, q, c, d = 2, 30, 16, 50, 32, 64
    gx = torch.from_numpy((0.2 * rng.randn(b, p2, nn, 3)).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, q + 1, (b, p2, nn)).astype(np.int32))
    idx[:, :, ::3] = q
    kern = torch.from_numpy(tkp.get_spherical_kernel_points(0.28, 1))
    rk, k2 = tso3.rotated_kernels(torch.from_numpy(tico.get_anchors(60)), kern)
    W = torch.from_numpy((0.05 * rng.randn(24, c, d)).astype(np.float32))
    dout = torch.from_numpy(rng.randn(b, p2, 60, d).astype(np.float32))
    gx, idx, rk, k2, W, dout = [t.to(cuda) for t in (gx, idx, rk, k2, W, dout)]
    ic = tkern.inter_conv
    got = ic.inter_conv_dtable(gx, idx, q, rk, k2, W, dout, 0.08)
    torch.cuda.synchronize()
    assert got.shape == (b, q, 60, c)
    assert _rel(got, ic.inter_conv_dtable_plain(gx, idx, q, rk, k2, W, dout,
                                                0.08)) <= 1e-5


@pytest.mark.parametrize('b,p,c,d', [(2, 16, 64, 64), (12, 512, 64, 64),
                                     (12, 128, 256, 256)])
def test_intra_conv_bwd_kernels_match_plain(cuda, b, p, c, d):
    """df through the forward kernel on the inverse adjacency (normwise
    <= 1e-5) and the dW kernel (normwise <= 1e-4)."""
    rng = np.random.RandomState(p)
    f = torch.from_numpy(rng.randn(b, p, 60, c).astype(np.float32)).to(cuda)
    dout = torch.from_numpy(rng.randn(b, p, 60, d).astype(np.float32)).to(cuda)
    W = torch.from_numpy(
        (0.05 * rng.randn(12, c, d)).astype(np.float32)).to(cuda)
    ti = torch.from_numpy(tico.get_intra_idx()).to(cuda)
    inv = torch.from_numpy(tico.get_intra_inv_idx()).to(cuda)
    ik = tkern.intra_conv
    df = ik.intra_conv_df(dout, ti, inv, W)
    dW = ik.intra_conv_dw(f, ti, dout)
    torch.cuda.synchronize()
    assert _rel(df, ik.intra_conv_df_plain(dout, ti, W)) <= 1e-5
    assert _rel(dW, ik.intra_conv_dw_plain(f, ti, dout)) <= 1e-4


def test_cuda_backward_launches_the_kernels(cuda):
    """A backward on CUDA tensors goes through the kernels, never silently
    through the plain versions: every backward entry's count rises."""
    gx, idx, f, rk, k2, W, _ = _inter_operands(cuda, 2, 64, 1, 16, 64, 64)
    ti = torch.from_numpy(tico.get_intra_idx()).to(cuda)
    inv = torch.from_numpy(tico.get_intra_inv_idx()).to(cuda)
    f.requires_grad_(True)
    W.requires_grad_(True)
    W2 = (0.05 * torch.randn(12, 64, 64, generator=torch.Generator()
                             .manual_seed(0))).to(cuda).requires_grad_()
    tkern.reset_counts()
    out = tkern.inter_conv.InterConvFn.apply(gx, idx, f, rk, k2, W, 0.08)
    out = tkern.intra_conv.IntraConvFn.apply(out, ti, inv, W2)
    out.square().sum().backward()
    torch.cuda.synchronize()
    assert tkern.counts() == {'fps': 0, 'ball_query': 0, 'inter_conv': 1,
                              'inter_conv_dtable': 1, 'inter_conv_dw': 1,
                              'intra_conv': 2, 'intra_conv_dw': 1}
    assert f.grad is not None and W.grad is not None and W2.grad is not None
