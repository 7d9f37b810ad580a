"""The port's CUDA kernels against their plain PyTorch versions on the card
(marked ``gpu``; each test skips where there is no CUDA device).

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
