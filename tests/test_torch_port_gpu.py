"""The port's CUDA kernels against their plain PyTorch versions on the card
(marked ``gpu``; each test skips where there is no CUDA device): the forward
kernels, the backward kernels (inter dTable / dW, intra df / dW) at a small
and a flagship shape, the autograd Functions' launches, and the production
mode's kernels in bf16 (moments, grouped conv and its fused tail,
the prenorm intra conv, the bf16 inter conv) with their shape refusals, and
the production-mode backward kernels (the prenorm intra df / dss / dW,
the grouped conv's dx / dW / dbias in one launch and apart, the bf16
inter dTable / dW), their determinism
and a bf16 train step's launches; the W-off inter conv (fp32 and bf16)
with the composed route, and a bf16 inv train step's launches; the bf16
inter backward scatter on tensor cores and the fp32 one on the CUDA cores
(the fused dTable and the W-off dG) at every model layer and at their
edges, and the template off their envelopes;
the bf16 fused dW on tensor cores and the fp32 one on the CUDA cores at
model layers and at their edges, their determinism, and the template off
their envelopes; the bf16 intra dW on
tensor cores (B6 dW and the plain form's) at every model width, with a
fold for the batch and one a cloud, at point counts that leave its last
8-point group short, its determinism, and the SGEMM off its envelope;
the fp32 intra dW on the CUDA cores at every model layer shape and at its
edges, its determinism and its float64 error against the SGEMM's;
the fp32 intra forward and df on the CUDA cores at every model layer shape
and at their edges, the same checks, the SGEMM off their envelope, and the
kernel's SASS (FFMA, no tensor-core instruction);
the bf16 W-off F on tensor cores and the fp32 one on the CUDA cores at
every composed-route layer and at their edges (the fp32 one bitwise the
template's), their determinism, and the template off their envelopes;
the fp32 W-fused inter forward on the CUDA cores at every inter layer of
both models and at its edges, its determinism and its float64 error
against the template's, the template off its envelope, and the kernel's
SASS (FFMA, no tensor-core instruction);
the ball query's reference fill on both of its kernels; the inter forward,
dTable and dW at the reduced-anchor models' anchor counts (1, 20, 40);
the W-off F and dG below 60 anchors (1, 20, 40) on the template; the
plain intra route of a bf16 step and eval with dropout;
the ones conv in fp32 and bf16 at both models' layer-0 shapes and at its
edges (one neighbor, neighbor counts off the unroll and past 1816, point
and lane counts that leave a block or a pass part full, shadow neighbors
whose weights are exactly 0), its determinism, its float64 error against
the plain version's, and its refusals.

Run on a machine with the card:
  python -m pytest tests/test_torch_port_gpu.py -q -m gpu --noconftest
(tests/conftest.py imports jax, which that machine does not need to have).
"""

import json

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


@pytest.mark.parametrize('b,n,m', [(4, 1024, 512), (3, 300, 77),
                                   # the models' calls: cls b=32 and b=12,
                                   # inv b=16 and b=48, 1024 -> 512
                                   (32, 1024, 512), (12, 1024, 512),
                                   (16, 1024, 512), (48, 1024, 512),
                                   # the last points a thread part full,
                                   # one point past 1024; every point
                                   # picked; the largest register cloud
                                   (2, 1000, 250), (1, 1025, 300),
                                   (2, 300, 300),
                                   (2, tkern.fps.REG_MAX_N, 64),
                                   # the shared-memory kernel
                                   (2, tkern.fps.REG_MAX_N + 1, 64),
                                   (1, 12288, 40)])
def test_fps_kernel_equals_plain(cuda, b, n, m):
    x = torch.from_numpy(_ball_points(np.random.RandomState(n), b, n)).to(cuda)
    x[:, 3] = 0.0
    tkern.reset_counts()
    got = tkern.fps.fps(x, m)
    torch.cuda.synchronize()
    assert torch.equal(got, tkern.fps.fps_plain(x, m))
    want = 'reg' if n <= tkern.fps.REG_MAX_N else 'smem'
    assert tkern.fps.routes == {'reg': 0, 'smem': 0, want: 1}


def _fps_cloud(kind, rng, b, n):
    """[b, n, 3] clouds that the sampling kernels find hard: 'dup' every
    point four times (ties at every pick), 'shadow' every point
    shadow-guarded (the picks are all 0), 'mixed' a half of each."""
    x = _ball_points(rng, b, n)
    if kind == 'dup':
        x = np.repeat(x[:, :n // 4], 4, axis=1)
    elif kind == 'shadow':
        x *= 0.01
    else:
        x[:, 1::2] *= 0.01
    return x


@pytest.mark.parametrize('kind', ['dup', 'shadow', 'mixed'])
@pytest.mark.parametrize('n,m', [(1024, 512), (96, 96), (9000, 100)])
def test_fps_kernel_on_hard_clouds(cuda, kind, n, m):
    x = torch.from_numpy(_fps_cloud(kind, np.random.RandomState(3), 3,
                                    n)).to(cuda)
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


# the models' ball queries (m, n, n_sample, radius): cls_so3net_pn's 7
# layers (unit clouds), inv_so3net_pn's 8 (patches of radius 0.4)
CLS_BALL_QUERIES = ((512, 1024, 32, 0.2), (512, 512, 16, 0.2828),
                    (256, 512, 32, 0.4), (256, 256, 16, 0.4),
                    (128, 256, 32, 0.5657), (128, 128, 16, 0.5657),
                    (64, 128, 32, 0.8))
INV_BALL_QUERIES = ((512, 1024, 64, 0.08), (512, 512, 32, 0.1131),
                    (256, 512, 64, 0.16), (256, 256, 32, 0.16),
                    (128, 256, 64, 0.2263), (128, 128, 32, 0.2263),
                    (64, 128, 64, 0.32), (64, 64, 32, 0.32))


@pytest.mark.parametrize('model,b', [('cls', 32), ('cls', 12), ('inv', 16),
                                     ('inv', 48)])
def test_ball_query_kernel_at_model_shapes(cuda, model, b):
    rng = np.random.RandomState(b)
    scale = 1.0 if model == 'cls' else 0.4
    shapes = CLS_BALL_QUERIES if model == 'cls' else INV_BALL_QUERIES
    tkern.reset_counts()
    for m, n, ns, r in shapes:
        s = torch.from_numpy(scale * _ball_points(rng, b, n)).to(cuda)
        q = s[:, :m].contiguous()
        got = tkern.ball_query.ball_query(q, s, r, ns)
        torch.cuda.synchronize()
        assert torch.equal(got, tkern.ball_query.ball_query_plain(q, s, r,
                                                                  ns))
    assert tkern.ball_query.routes == {'warp': len(shapes), 'thread': 0}


def _last_point_hits(ns, n=70, m=6):
    """Queries whose ns-th hit is the support's last point: the support
    sits on a line, the query at its far end sees the last ns points."""
    s = np.zeros((2, n, 3), np.float32)
    s[:, :, 0] = np.arange(n, dtype=np.float32) / n
    q = np.zeros((2, m, 3), np.float32)
    q[:, :, 0] = 1.0 + np.arange(m, dtype=np.float32) / (8 * n)
    return q, s, (ns + 0.5) / n


@pytest.mark.parametrize('m,n,ns,r', [
    (48, 256, 64, 0.5),     # 64 slots: hits and fill past 32
    (40, 256, 64, 0.3),     # 64 slots, most rows filled periodically
    (24, 20, 16, 0.8),      # n < 32
    (24, 33, 32, 0.9),      # n = 33
    (20, 33, 48, 1.5),      # n_sample > n, every point a hit
    (37, 1500, 64, 0.3),    # two staged tiles, m off a block's queries
    (9, 300, 256, 0.9),     # the warp kernel's largest n_sample
    (9, 300, 257, 0.9),     # the thread kernel
])
def test_ball_query_kernel_edges(cuda, m, n, ns, r):
    rng = np.random.RandomState(n + ns)
    q = torch.from_numpy(_ball_points(rng, 3, m)).to(cuda)
    s = torch.from_numpy(_ball_points(rng, 3, n)).to(cuda)
    tkern.reset_counts()
    got = tkern.ball_query.ball_query(q, s, r, ns)
    torch.cuda.synchronize()
    assert torch.equal(got, tkern.ball_query.ball_query_plain(q, s, r, ns))
    want = 'warp' if ns <= tkern.ball_query.WARP_MAX_SAMPLE else 'thread'
    assert tkern.ball_query.routes == {'warp': 0, 'thread': 0, want: 1}


@pytest.mark.parametrize('ns', [1, 16, 33, 64])
def test_ball_query_kernel_with_a_hit_at_the_last_point(cuda, ns):
    q, s, r = (torch.from_numpy(a).to(cuda) if isinstance(a, np.ndarray)
               else a for a in _last_point_hits(ns))
    got = tkern.ball_query.ball_query(q, s, r, ns)
    torch.cuda.synchronize()
    assert torch.equal(got, tkern.ball_query.ball_query_plain(q, s, r, ns))
    assert bool((got == s.shape[1] - 1).any())


def _ref_fill_cloud(ns, b=2, m=10, radius=0.2, seed=4):
    """Queries far apart with 0, 1, ns - 1, ns and ns + 3 support points
    inside radius in turn (shuffled through the support's index order); the
    rest of the support far away."""
    rng = np.random.RandomState(seed)
    plan = [0, 1, ns - 1, ns, ns + 3]
    hits = [plan[j % len(plan)] for j in range(m)]
    n = sum(hits) + 16
    q = np.zeros((b, m, 3), np.float32)
    q[:, :, 0] = 10.0 * np.arange(m)
    s = 1000.0 + rng.rand(b, n, 3).astype(np.float32)
    for bi in range(b):
        slots, used = rng.permutation(n), 0
        for j, h in enumerate(hits):
            off = rng.randn(h, 3)
            off *= 0.5 * radius * rng.rand(h, 1) / np.linalg.norm(
                off, axis=1, keepdims=True)
            s[bi, slots[used:used + h]] = q[bi, j] + off
            used += h
    return q, s, radius, np.asarray(hits) == ns - 1


@pytest.mark.parametrize('ns', [2, 16, 64, 256, 257, 300])
def test_ball_query_kernel_reference_fill(cuda, ns):
    """The reference fill (the original EPN kernel's: exactly ns - 1 hits
    leave the last slot 0) on both kernels ('warp' up to 256 slots,
    'thread' beyond), index-equal to the plain version; the native fill
    of the same call differs at those queries only."""
    q, s, r, short = _ref_fill_cloud(ns)
    q, s = torch.from_numpy(q).to(cuda), torch.from_numpy(s).to(cuda)
    tkern.reset_counts()
    got = tkern.ball_query.ball_query(q, s, r, ns, True)
    native = tkern.ball_query.ball_query(q, s, r, ns, False)
    torch.cuda.synchronize()
    want = 'warp' if ns <= tkern.ball_query.WARP_MAX_SAMPLE else 'thread'
    assert tkern.ball_query.routes == {'warp': 0, 'thread': 0, want: 2}
    assert torch.equal(got, tkern.ball_query.ball_query_plain(q, s, r, ns,
                                                              True))
    assert bool((got[:, short, -1] == 0).all())
    differ = (got != native).any(-1).cpu().numpy()
    assert not differ[:, ~short].any() and differ[:, short].any()


@pytest.mark.parametrize('na', [1, 20, 40])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_inter_conv_at_reduced_anchors(cuda, na, dtype):
    """The W-fused inter forward and (fp32) its dTable and dW at the
    reduced-anchor cls models' anchor counts, at the shape of their second
    layer (c = d = 64, nn = 16): the template in fp32 and at one anchor,
    the tensor-core kernel in bf16 from MMA_MIN_NA anchors; each within its
    plain version's bound (the bf16 forward within 1e-3 of
    inter_conv_mma_plain)."""
    ic = tkern.inter_conv
    rng = np.random.RandomState(na)
    b, p1, p2, nn, c, d = 4, 512, 512, 16, 64, 64
    xyz = _ball_points(rng, b, p1)
    kern = torch.from_numpy(tkp.get_spherical_kernel_points(0.2, 1))
    anchors = torch.from_numpy(tico.get_anchors(na))
    rk, k2 = tso3.rotated_kernels(anchors, kern)
    idx = rng.randint(0, p1 + 1, (b, p2, nn)).astype(np.int32)
    gx = (xyz[np.arange(b)[:, None, None], np.minimum(idx, p1 - 1)]
          - xyz[:, :p2, None]).astype(np.float32)
    table = (0.5 * rng.randn(b, p1, na, c)).astype(np.float32)
    W = (0.1 * rng.randn(24, c, d)).astype(np.float32)
    args = [torch.from_numpy(a).to(cuda) for a in (gx, idx)]
    args += [torch.from_numpy(table).to(cuda, dtype), rk.to(cuda),
             k2.to(cuda), torch.from_numpy(W).to(cuda, dtype), 0.05]
    tkern.reset_counts()
    got = ic.inter_conv(*args)
    torch.cuda.synchronize()
    route = 'mma' if dtype == torch.bfloat16 and na >= ic.MMA_MIN_NA else \
        'sgemm'
    assert ic.routes[route] == 1, ic.routes
    rel = lambda g, w: float((g.float() - w.float()).norm() / w.float().norm())
    if dtype == torch.bfloat16:
        assert rel(got, ic.inter_conv_plain(*args)) <= 4e-3
        assert rel(got, ic.inter_conv_mma_plain(*args)) <= 1e-3
        return
    assert rel(got, ic.inter_conv_plain(*args)) <= 1e-5
    gx_, idx_, tab, rk_, k2_, W_, sigma = args
    dout = torch.randn(got.shape, device=cuda)
    dT = ic.inter_conv_dtable(gx_, idx_, p1, rk_, k2_, W_, dout, sigma)
    dW = ic.inter_conv_dw(gx_, idx_, tab, rk_, k2_, dout, sigma)
    torch.cuda.synchronize()
    assert ic.routes['dtable'] == 1 and ic.routes['dw'] == 1, ic.routes
    assert rel(dT, ic.inter_conv_dtable_plain(gx_, idx_, p1, rk_, k2_, W_,
                                              dout, sigma)) <= 1e-5
    assert rel(dW, ic.inter_conv_dw_plain(gx_, idx_, tab, rk_, k2_, dout,
                                          sigma)) <= 1e-4


@pytest.mark.parametrize('kernel', ['fps', 'ball_query'])
@pytest.mark.parametrize('route', [0, 1])
def test_sampling_kernels_repeat_and_capture(cuda, kernel, route):
    """A second call gives the same bits, and the wrapper's calls captured
    into a CUDA graph replay to the same indices (the device timer of
    chip_smoke.py times them so), on either route of the kernel (0: the
    models' 'reg' / 'warp', 1: 'smem' / 'thread')."""
    n = (1024, 9000)[route]
    rng = np.random.RandomState(n)
    x = torch.from_numpy(_ball_points(rng, 4, n)).to(cuda)
    if kernel == 'fps':
        def call():
            return tkern.fps.fps(x, 300)
    else:
        q = x[:, :256].contiguous()

        def call():
            return tkern.ball_query.ball_query(q, x, 0.2, (64, 300)[route])
    first = call()
    again = call()
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [call() for _ in range(3)]
    for o in outs:
        o.fill_(-1)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(o, first) for o in outs)


@pytest.mark.parametrize('p1,stride,nn,c,d', [(128, 2, 32, 64, 128),
                                              (64, 1, 16, 256, 256),
                                              (48, 1, 16, 24, 32),
                                              (64, 1, 48, 16, 64),
                                              (40, 2, 8, 32, 96)])
def test_inter_conv_kernel_matches_plain(cuda, p1, stride, nn, c, d):
    """fp32 forward calls: on the CUDA-core kernel ('fwd_f32') where c % 16
    == 0, else (c = 24) on the SGEMM template ('sgemm'); within 1e-5 of the
    plain version either way."""
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
    ic = tkern.inter_conv
    before = dict(ic.routes)
    got = ic.inter_conv(*args)
    torch.cuda.synchronize()
    assert {k: ic.routes[k] - before[k] for k in ic.routes
            if ic.routes[k] > before[k]} == {
                'sgemm' if c % 16 else 'fwd_f32': 1}
    _conv_close(got, ic.inter_conv_plain(*args), 24 * c)


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
    counts = tkern.counts()
    assert {k: v for k, v in counts.items() if v} == {
        'inter_conv': 1, 'inter_conv_dtable': 1, 'inter_conv_dw': 1,
        'intra_conv': 2, 'intra_conv_dw': 1}
    assert f.grad is not None and W.grad is not None and W2.grad is not None


# ------------------------------------------------------ production mode

BF16 = torch.bfloat16


def _rand(rng, shape, device, dtype=torch.float32, scale=1.0):
    return torch.from_numpy((scale * rng.randn(*shape)).astype(
        np.float32)).to(device=device, dtype=dtype)


# (b, p2, nn, na, K): random neighbors in a ball of radius 0.3, sigma 0.02
ONES_EDGES = {
    'nn1': (2, 40, 1, 60, 24),
    'nn_odd': (2, 40, 37, 60, 24),      # nn not a multiple of the unroll
    'pts_odd': (1, 37, 32, 60, 24),     # b * p2 not a multiple of a group
    'nn_wide': (1, 5, 2000, 60, 24),    # past the earlier kernel's 1816
    'lanes_odd': (2, 16, 9, 7, 5),      # L = 35: the last pass part full
    'one_anchor': (2, 16, 8, 1, 24),    # L = K: four idle passes a thread
    'lanes_many': (1, 6, 8, 60, 48),    # L = 2880 > 5 * 512: two lane groups
}


def _ones_model_operands(cuda, model, b):
    """Layer 0 of a model (cls_so3net_pn: radius 0.2, sigma 0.02, nn 32;
    inv_so3net_pn: 0.08, 0.0032, 64; reg_so3net: 0.2, 0.02, 64; stride 2
    from 1024 points): gx, rk, k2 and sigma from a ball query over random
    points in the unit ball (inv: a ball of radius 0.4; reg: normalized
    asymmetric airplanes, clustered)."""
    radius, sigma, nn, scale = {'cls': (0.2, 0.02, 32, 1.0),
                                'inv': (0.08, 0.0032, 64, 0.4),
                                'reg': (0.2, 0.02, 64, 1.0)}[model]
    rng = np.random.RandomState(1)
    if model == 'reg':
        from epn_pointcloud_tpu_torch.data import pc as tpc
        from epn_pointcloud_tpu_torch.data import synthetic
        x = np.stack([tpc.normalize_np(synthetic.make_asym_shape(
            rng, 1024).T).T for _ in range(b)]).astype(np.float32)
        x = torch.from_numpy(x).to(cuda)
    else:
        x = torch.from_numpy(scale * _ball_points(rng, b, 1024)).to(cuda)
    kern = torch.from_numpy(tkp.get_spherical_kernel_points(
        tkp.KERNEL_CONDENSE_RATIO * radius, 1)).to(cuda)
    rk, k2 = tso3.rotated_kernels(torch.from_numpy(tico.get_anchors(60))
                                  .to(cuda), kern)
    gx, _, _, _ = tso3.sampling.inter_grouping_ball(x, 2, radius, nn)
    return gx.contiguous(), rk, k2, sigma


@pytest.mark.parametrize('case', ['cls', 'inv', 'reg', *ONES_EDGES])
@pytest.mark.parametrize('dtype', [torch.float32, BF16])
def test_ones_conv_kernel_matches_plain(cuda, dtype, case):
    """The anchor-weight sum: fp32 F to a normwise 1e-5, bf16 F to 4e-3, at
    the models' layer-0 shapes (fp32: its float64 error at most 1.5x the
    plain fp32 version's) and at the kernel's edges; bitwise equal on a
    second call. Every point also has shadow neighbors far outside the
    ball (100 away), whose weights are exactly 0, and one point has no
    other: its F is exactly 0."""
    if case in ('cls', 'inv', 'reg'):
        gx, rk, k2, sigma = _ones_model_operands(cuda, case, 2)
    else:
        b, p2, nn, na, K = ONES_EDGES[case]
        rng = np.random.RandomState(nn + na * K)
        gx = torch.from_numpy(0.3 * _ball_points(rng, b, p2 * nn)).reshape(
            b, p2, nn, 3).to(cuda)
        kern = _rand(rng, (K, 3), cuda, scale=0.1)
        anchors = torch.from_numpy(tico.get_anchors(60)[:na]).to(cuda)
        rk, k2 = tso3.rotated_kernels(anchors, kern)
        sigma = 0.02
    b, p2, nn, _ = gx.shape
    na, K = rk.shape[:2]
    gx = gx.clone()
    gx[:, :, nn // 2:] = torch.where(gx[:, :, nn // 2:, :1] >= 0, 100.0,
                                     gx[:, :, nn // 2:])
    gx[0, 0] = 100.0
    got = tkern.ones_conv.ones_conv(gx, rk, k2, sigma, dtype)
    again = tkern.ones_conv.ones_conv(gx, rk, k2, sigma, dtype)
    torch.cuda.synchronize()
    want = tkern.ones_conv.ones_conv_plain(gx, rk, k2, sigma, dtype)
    assert got.dtype == dtype and got.shape == (b, p2, na, K)
    assert torch.equal(got, again)
    assert torch.count_nonzero(got[0, 0]) == 0
    assert _rel(got.float(), want.float()) <= (1e-5 if dtype ==
                                               torch.float32 else 4e-3)
    if case in ('cls', 'inv', 'reg') and dtype == torch.float32:
        w64 = tkern.ones_conv.ones_conv_plain(gx.double(), rk.double(),
                                              k2.double(), sigma,
                                              torch.float64)
        assert _rel(got.double(), w64) <= 1.5 * _rel(want.double(), w64)


def test_ones_conv_refuses_what_the_kernel_does_not_take(cuda):
    """nn past one point's neighbors in shared memory, K past a block."""
    rk, k2 = torch.zeros(2, 4, 3, device=cuda), torch.zeros(4, device=cuda)
    too_wide = tkern.ones_conv.MAX_NN + 1
    with pytest.raises(ValueError):
        tkern.ones_conv.ones_conv(torch.zeros(1, 1, too_wide, 3,
                                              device=cuda), rk, k2, 0.1)
    K = tkern.ones_conv.MAX_K + 1
    with pytest.raises(ValueError):
        tkern.ones_conv.ones_conv(torch.zeros(1, 1, 4, 3, device=cuda),
                                  torch.zeros(1, K, 3, device=cuda),
                                  torch.zeros(K, device=cuda), 0.1)
    full = tkern.ones_conv.ones_conv(
        torch.zeros(1, 1, tkern.ones_conv.MAX_NN, 3, device=cuda), rk, k2,
        0.1)
    torch.cuda.synchronize()
    assert torch.equal(full, torch.full_like(full, tkern.ones_conv.MAX_NN))


@pytest.mark.parametrize('dtype', [torch.float32, BF16])
def test_moments_kernel_matches_plain(cuda, dtype):
    """fp32 sums to a normwise 1e-5 (only the summation order differs)."""
    x = _rand(np.random.RandomState(2), (3, 200, 60 * 24), cuda, dtype)
    s, sq = tkern.moments.moments(x)
    torch.cuda.synchronize()
    ws, wsq = tkern.moments.moments_plain(x)
    assert s.dtype == sq.dtype == torch.float32
    assert _rel(s, ws) <= 1e-5 and _rel(sq, wsq) <= 1e-5


# (b, p, c, d, ssm batch): small and odd shapes (c % 8 != 0, d not a tile
# width, 840 rows); the cls head (256 -> 256 at b=32, p=64), cls L1 (64 ->
# 64 at p=511: rows no multiple of a row tile) and inv B0 (32 -> 32); c =
# 2564, where the bf16 W does not fit in shared memory and streams with x
GROUPED_SHAPES = [(3, 40, 64, 64, 3), (3, 40, 256, 256, 1),
                  (3, 40, 36, 96, 3), (2, 7, 36, 96, 2),
                  (32, 64, 256, 256, 1), (2, 511, 64, 64, 2),
                  (4, 512, 32, 32, 4), (2, 5, 2564, 96, 2)]


@pytest.mark.parametrize('dtype', [torch.float32, BF16])
@pytest.mark.parametrize('b,p,c,d,mb', GROUPED_SHAPES)
def test_grouped_conv_kernels_match_plain(cuda, dtype, b, p, c, d, mb):
    """The plain 1x1 conv and the fused tail: fp32 to a normwise 1e-5, bf16
    (rounded once) to 4e-3."""
    rng = np.random.RandomState(c)
    na = 60
    x = _rand(rng, (b, p, na, c), cuda, dtype)
    W = _rand(rng, (c, d), cuda, dtype, 0.1)
    bias = _rand(rng, (d,), cuda)
    y = _rand(rng, (b, p, na, d), cuda, dtype)
    ssk = torch.stack([_rand(rng, (1, na * d), cuda).abs() + 0.5,
                       _rand(rng, (1, na * d), cuda)], dim=1)
    ssm = torch.stack([_rand(rng, (mb, na * d), cuda).abs() + 0.5,
                       _rand(rng, (mb, na * d), cuda)], dim=1)
    gc = tkern.grouped_conv
    out = gc.grouped_conv(x, W, bias)
    tail = gc.grouped_conv_tail(x, W, bias, ssk, y, ssm)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 4e-3
    assert out.dtype == tail.dtype == dtype
    assert _rel(out.float(), gc.grouped_conv_plain(x, W, bias).float()) <= tol
    assert _rel(tail.float(), gc.grouped_conv_tail_plain(
        x, W, bias, ssk, y, ssm).float()) <= tol


@pytest.mark.parametrize('dtype', [torch.float32, BF16])
@pytest.mark.parametrize('p,c,d,sb', [(16, 64, 64, 2), (8, 256, 256, 1)])
def test_intra_conv_prenorm_kernel_matches_plain(cuda, dtype, p, c, d, sb):
    """z = leaky(f * scale + shift) rounded to the element type on load, then
    the intra conv: fp32 to a normwise 1e-5, bf16 to 4e-3."""
    rng = np.random.RandomState(p)
    f = _rand(rng, (2, p, 60, c), cuda, dtype)
    W = _rand(rng, (12, c, d), cuda, dtype, 0.05)
    ss = torch.stack([_rand(rng, (sb, 60 * c), cuda).abs() + 0.5,
                      _rand(rng, (sb, 60 * c), cuda, scale=0.3)], dim=1)
    ti = torch.from_numpy(tico.get_intra_idx()).to(cuda)
    ik = tkern.intra_conv
    got = ik.intra_conv_prenorm(f, ss, ti, W)
    plain_fwd = ik.intra_conv(f, ti, W)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 4e-3
    assert got.dtype == plain_fwd.dtype == dtype
    assert _rel(got.float(), ik.intra_conv_prenorm_plain(
        f, ss, ti, W).float()) <= tol
    assert _rel(plain_fwd.float(), ik.intra_conv_plain(f, ti, W).float()) \
        <= tol


@pytest.mark.parametrize('p1,stride,nn,c,d', [(128, 2, 32, 64, 128),
                                              (64, 1, 16, 256, 256)])
def test_inter_conv_bf16_kernel_matches_plain(cuda, p1, stride, nn, c, d):
    """bf16 table and W, fp32 coordinates and sums, bf16 out: against the
    plain version (the anchor weights and F in fp32) 4e-3, and against the
    tensor-core kernel's arithmetic (both rounded to bf16,
    inter_conv_mma_plain) 1e-3."""
    gx, idx, f, rk, k2, W, _ = _inter_operands(cuda, 2, p1, stride, nn, c, d)
    args = (gx, idx, f.to(BF16), rk, k2, W.to(BF16), 0.08)
    ic = tkern.inter_conv
    got = ic.inter_conv(*args)
    torch.cuda.synchronize()
    assert got.dtype == BF16
    assert _rel(got.float(), ic.inter_conv_plain(*args).float()) <= 4e-3
    assert _rel(got.float(), ic.inter_conv_mma_plain(*args).float()) <= 1e-3


# (c, d, nn) of every W-fused inter layer: cls_so3net_pn's six, then
# inv_so3net_pn's (B0L1, B1L0, B1L1, B2L0, B2L1 and B3L1, B3L0)
MODEL_INTER_SHAPES = [(64, 64, 16), (64, 128, 32), (128, 128, 16),
                      (128, 256, 32), (256, 256, 16), (256, 256, 32),
                      (32, 32, 32), (32, 64, 64), (64, 64, 32),
                      (64, 128, 64), (128, 128, 32), (128, 128, 64)]


def _bf16_inter_call(cuda, b, p1, stride, nn, c, d, shadow=False):
    """One bf16 forward by the wrapper: (the kernel it ran, out, out of a
    second call, the plain version's out, inter_conv_mma_plain's out)."""
    gx, idx, f, rk, k2, W, _ = _inter_operands(cuda, b, p1, stride, nn, c, d,
                                               seed=nn + c + d)
    if shadow:
        idx[:, :, ::3] = p1
    args = (gx, idx, f.to(BF16), rk, k2, W.to(BF16), 0.08)
    ic = tkern.inter_conv
    before = dict(ic.routes)
    got = ic.inter_conv(*args)
    again = ic.inter_conv(*args)
    torch.cuda.synchronize()
    route = [k for k in ic.routes if ic.routes[k] == before[k] + 2]
    return (route, got, again, ic.inter_conv_plain(*args),
            ic.inter_conv_mma_plain(*args))


@pytest.mark.parametrize('c,d,nn', MODEL_INTER_SHAPES)
def test_inter_conv_mma_kernel_matches_plain(cuda, c, d, nn):
    """The tensor-core kernel at every model layer's (c, d, nn), 33 points
    of 2 clouds (3960 rows: the last 64-row block runs past M): normwise
    <= 1e-3 of inter_conv_mma_plain (the same rounding points), <= 4e-3 of
    the plain version, and bitwise equal on a second call."""
    route, got, again, plain, rounded = _bf16_inter_call(cuda, 2, 66, 2, nn,
                                                         c, d)
    assert route == ['mma'] and got.dtype == BF16
    assert _rel(got.float(), rounded.float()) <= 1e-3
    assert _rel(got.float(), plain.float()) <= 4e-3
    assert torch.equal(got, again)


@pytest.mark.parametrize('b,p1,stride,nn,c,d,shadow,route', [
    (1, 2, 2, 16, 64, 64, False, 'mma'),      # one point: 60 rows, M < 64
    (2, 50, 1, 16, 128, 256, True, 'mma'),    # shadow slots
    (2, 40, 1, 20, 64, 128, True, 'mma'),     # nn = 20, padded to 32
    (2, 40, 1, 16, 32, 96, False, 'mma'),     # d = 96: three 32-wide blocks
    (2, 40, 1, 16, 40, 96, True, 'sgemm'),    # c % 32 != 0
    (2, 40, 1, 80, 64, 64, False, 'sgemm')])  # nn > 64
def test_inter_conv_bf16_routes_match_plain(cuda, b, p1, stride, nn, c, d,
                                            shadow, route):
    """The bf16 forward at the edges of the tensor-core kernel and off its
    route (the SGEMM template): both round the anchor weights and F to bf16
    where the TPU kernel does, so both are within 1e-3 (normwise) of
    inter_conv_mma_plain and 4e-3 of the plain version; bitwise equal on a
    second call."""
    taken, got, again, plain, rounded = _bf16_inter_call(
        cuda, b, p1, stride, nn, c, d, shadow)
    assert taken == [route]
    assert _rel(got.float(), rounded.float()) <= 1e-3
    assert _rel(got.float(), plain.float()) <= 4e-3
    assert torch.equal(got, again)


def test_production_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    ti = torch.from_numpy(tico.get_intra_idx()).to(cuda)
    gc, ik = tkern.grouped_conv, tkern.intra_conv
    x = torch.zeros(1, 2, 60, 8, device=cuda, dtype=BF16)
    bias = torch.zeros(32, device=cuda)
    with pytest.raises(ValueError):          # d % 32 != 0
        gc.grouped_conv(x, torch.zeros(8, 48, device=cuda, dtype=BF16),
                        torch.zeros(48, device=cuda))
    with pytest.raises(ValueError):          # W of another type than x
        gc.grouped_conv(x, torch.zeros(8, 32, device=cuda), bias)
    with pytest.raises(ValueError):          # the fp32 dx needs c % 32 == 0
        gc.grouped_conv_bwd(torch.zeros(1, 2, 60, 36, device=cuda),
                            torch.zeros(36, 32, device=cuda),
                            torch.zeros(1, 2, 60, 32, device=cuda))
    with pytest.raises(ValueError):          # fp16 is not a compute dtype
        gc.grouped_conv(x.half(), torch.zeros(8, 32, device=cuda).half(),
                        bias)
    y = torch.zeros(2, 2, 60, 32, device=cuda, dtype=BF16)
    ss = torch.zeros(1, 2, 60 * 32, device=cuda)
    with pytest.raises(ValueError):          # fold batch neither 1 nor b
        gc.grouped_conv_tail(torch.zeros(2, 2, 60, 8, device=cuda,
                                         dtype=BF16),
                             torch.zeros(8, 32, device=cuda, dtype=BF16),
                             bias, ss, y, torch.zeros(3, 2, 60 * 32,
                                                      device=cuda))
    with pytest.raises(ValueError):          # ss lanes != 60 * c
        ik.intra_conv_prenorm(x, ss, ti,
                              torch.zeros(12, 8, 32, device=cuda, dtype=BF16))
    with pytest.raises(ValueError):          # odd lane count
        tkern.moments.moments(torch.zeros(1, 4, 7, device=cuda))
    with pytest.raises(ValueError):          # misaligned view
        tkern.moments.moments(torch.zeros(1, 4 * 8 + 2, device=cuda)[:, 2:]
                              .reshape(1, 4, 8))
    with pytest.raises(ValueError):          # rk of another shape than K
        tkern.ones_conv.ones_conv(torch.zeros(1, 4, 8, 3, device=cuda),
                                  torch.zeros(60, 24, 3, device=cuda),
                                  torch.zeros(12, device=cuda), 0.1)


def test_bf16_forward_launches_the_kernels(cuda):
    """A bf16 eval forward of a small model on the card goes through the
    production kernels, never silently through the plain versions."""
    from epn_pointcloud_tpu_torch.app import config
    from epn_pointcloud_tpu_torch.models import cls_so3net_pn as tcls
    opt = config.parse_args(['experiment', '-d', 'unused', '--input-num',
                             '256'])
    opt.model.flag = 'attention'
    model = tcls.build_model(opt, mlps=((32, 32), (64,)), out_mlps=(64,),
                             seed=3).to(cuda).eval()
    x = torch.from_numpy(_ball_points(np.random.RandomState(3), 2, 256)).to(
        cuda)
    tkern.reset_counts()
    tso3.set_compute_dtype('bf16')
    try:
        with torch.no_grad():
            logits, _ = model(x)
            with tkern.plain():
                plain, _ = model(x)
        torch.cuda.synchronize()
    finally:
        tso3.set_compute_dtype('fp32')
    counts = {k: v for k, v in tkern.counts().items() if v}
    assert counts == {'fps': 1, 'ball_query': 3, 'ones_conv': 1,
                      'inter_conv': 2, 'intra_conv_prenorm': 3, 'moments': 3,
                      'grouped_conv_tail': 2, 'grouped_conv': 1}
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
    cos = torch.nn.functional.cosine_similarity(logits, plain, dim=-1)
    assert float(cos.min()) >= 0.9999


# -------------------------------------------- production-mode backward

def _prenorm_operands(cuda, dtype, b, p, c, d, sb, seed=0):
    rng = np.random.RandomState(seed)
    f = _rand(rng, (b, p, 60, c), cuda, dtype)
    W = _rand(rng, (12, c, d), cuda, dtype, 0.05)
    ss = torch.stack([_rand(rng, (sb, 60 * c), cuda).abs() + 0.5,
                      _rand(rng, (sb, 60 * c), cuda, scale=0.3)], dim=1)
    dout = _rand(rng, (b, p, 60, d), cuda, dtype)
    ti = torch.from_numpy(tico.get_intra_idx()).to(cuda)
    inv = torch.from_numpy(tico.get_intra_inv_idx()).to(cuda)
    return f, ss, ti, inv, W, dout


# (b, p, c, d, ss batch): small, and flagship L1 / L5 at b=12 with the train
# BatchNorm fold (batch 1); a per-cloud fold
PRENORM_BWD_SHAPES = [(2, 16, 64, 64, 2), (12, 512, 64, 64, 1),
                      (12, 128, 256, 256, 1), (3, 33, 32, 96, 3)]


@pytest.mark.parametrize('dtype', [torch.float32, BF16])
@pytest.mark.parametrize('b,p,c,d,sb', PRENORM_BWD_SHAPES)
def test_intra_conv_prenorm_bwd_kernels_match_plain(cuda, dtype, b, p, c, d,
                                                    sb):
    """B6: df (normwise 1e-5 in fp32, 8e-3 in bf16: rounded once), the
    fold's gradient dss and dW (fp32 sums: 1e-4 from fp32 operands, 1e-3
    from bf16 ones) against the plain versions written from the formula."""
    f, ss, ti, inv, W, dout = _prenorm_operands(cuda, dtype, b, p, c, d, sb)
    ik = tkern.intra_conv
    df, dss = ik.intra_conv_prenorm_df(dout, f, ss, ti, inv, W)
    dW = ik.intra_conv_prenorm_dw(f, ss, ti, dout)
    torch.cuda.synchronize()
    wdf, wdss = ik.intra_conv_prenorm_df_plain(dout, f, ss, ti, W)
    wdW = ik.intra_conv_prenorm_dw_plain(f, ss, ti, dout)
    assert df.dtype == dtype and dss.dtype == dW.dtype == torch.float32
    assert dss.shape == ss.shape and dW.shape == W.shape
    fp32 = dtype == torch.float32
    assert _rel(df.float(), wdf.float()) <= (1e-5 if fp32 else 8e-3)
    assert _rel(dss, wdss) <= (1e-4 if fp32 else 1e-3)
    assert _rel(dW, wdW) <= (1e-4 if fp32 else 1e-3)


@pytest.mark.parametrize('dtype', [torch.float32, BF16])
@pytest.mark.parametrize('b,p,c,d,sb', [(2, 16, 64, 64, 2),
                                        (12, 128, 256, 256, 1)])
def test_relu_slope_kernels_match_plain(cuda, dtype, b, p, c, d, sb):
    """The ReLU (slope 0, a launch argument): the prenorm forward, B6 df,
    dss and dW, and the fused tail against their plain versions at slope 0
    (the bounds of the leaky tests above), with inputs that put exact
    zeros of u on the mask; each differs from its leaky call."""
    f, ss, ti, inv, W, dout = _prenorm_operands(cuda, dtype, b, p, c, d, sb)
    f[:, 0] = 0
    ss[:, 1, :c] = 0                               # u == 0 exactly
    ik, gc = tkern.intra_conv, tkern.grouped_conv
    fp32 = dtype == torch.float32
    z = ik.intra_conv_prenorm(f, ss, ti, W, 0.0)
    df, dss = ik.intra_conv_prenorm_df(dout, f, ss, ti, inv, W, 0.0)
    dW = ik.intra_conv_prenorm_dw(f, ss, ti, dout, 0.0)
    torch.cuda.synchronize()
    assert _rel(z.float(), ik.intra_conv_prenorm_plain(
        f, ss, ti, W, 0.0).float()) <= (1e-5 if fp32 else 4e-3)
    wdf, wdss = ik.intra_conv_prenorm_df_plain(dout, f, ss, ti, W, 0.0)
    assert _rel(df.float(), wdf.float()) <= (1e-5 if fp32 else 8e-3)
    assert _rel(dss, wdss) <= (1e-4 if fp32 else 1e-3)
    assert _rel(dW, ik.intra_conv_prenorm_dw_plain(f, ss, ti, dout, 0.0)) \
        <= (1e-4 if fp32 else 1e-3)
    assert _rel(z.float(), ik.intra_conv_prenorm(f, ss, ti, W).float()) > 1e-3
    rng = np.random.RandomState(c)
    x = _rand(rng, (b, p, 60, c), cuda, dtype)
    Wg = _rand(rng, (c, d), cuda, dtype, 0.1)
    bias = _rand(rng, (d,), cuda)
    tail = gc.grouped_conv_tail(x, Wg, bias, ss, dout, ss, 0.0)
    torch.cuda.synchronize()
    assert _rel(tail.float(), gc.grouped_conv_tail_plain(
        x, Wg, bias, ss, dout, ss, 0.0).float()) <= (1e-5 if fp32 else 4e-3)


# (p, c = d) of the intra layers of both models: cls_so3net_pn's (blocks of
# 64, 128, 256 and 256 channels at 512, 256, 128 and 64 points), then
# inv_so3net_pn's (32, 64, 128, 128)
MODEL_INTRA_SHAPES = [(512, 64), (256, 128), (128, 256), (64, 256),
                      (512, 32), (256, 64), (128, 128), (64, 128)]


def _check_intra_bf16(f, ss, ti, inv, W, dout, route):
    """The bf16 prenorm forward, the plain-form forward and B6 df, each
    called twice: all six on ``route`` (the wrapper's counts), bitwise equal
    on the second call, the forwards within 4e-3 (normwise) of their plain
    versions, df within 8e-3 and dss within 1e-3 of theirs."""
    ik = tkern.intra_conv
    before = dict(ik.routes)
    runs = [(ik.intra_conv_prenorm(f, ss, ti, W), ik.intra_conv(f, ti, W))
            + ik.intra_conv_prenorm_df(dout, f, ss, ti, inv, W)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert {k: ik.routes[k] - before[k] for k in ik.routes} == \
        {k: 6 if k == route else 0 for k in ik.routes}
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    z, y, df, dss = runs[0]
    assert z.dtype == y.dtype == df.dtype == BF16
    assert _rel(z.float(), ik.intra_conv_prenorm_plain(f, ss, ti,
                                                       W).float()) <= 4e-3
    assert _rel(y.float(), ik.intra_conv_plain(f, ti, W).float()) <= 4e-3
    wdf, wdss = ik.intra_conv_prenorm_df_plain(dout, f, ss, ti, W)
    assert _rel(df.float(), wdf.float()) <= 8e-3
    assert _rel(dss, wdss) <= 1e-3


@pytest.mark.parametrize('sb', [1, 2])
@pytest.mark.parametrize('p,c', MODEL_INTRA_SHAPES)
def test_intra_conv_mma_kernels_match_plain(cuda, p, c, sb):
    """The tensor-core kernel (B5 in its prenorm and plain forms, B6 df) at
    every intra layer shape of both models, 2 clouds, with a fold a cloud
    (sb = 2) and one broadcast (sb = 1): ``_check_intra_bf16``."""
    _check_intra_bf16(*_prenorm_operands(cuda, BF16, 2, p, c, c, sb,
                                         seed=p + c), 'mma')


@pytest.mark.parametrize('b,p,c,d,sb,route', [
    (2, 7, 64, 64, 2, 'mma'),       # 7 points, 8 a block: rows past the last
    (3, 13, 128, 128, 3, 'mma'),    # 13 points, 4 a block
    (2, 21, 32, 32, 1, 'mma'),      # 21 points, 16 a block
    (1, 1, 256, 256, 1, 'mma'),     # one point: 60 rows, 4 m16 tiles
    (2, 9, 64, 96, 2, 'sgemm'),     # c != d
    (2, 9, 96, 96, 1, 'sgemm')])    # not a model width
def test_intra_conv_bf16_routes_match_plain(cuda, b, p, c, d, sb, route):
    """The bf16 intra forward and B6 df where the point count does not fill
    the tensor-core kernel's blocks, and off its route (the SGEMM):
    ``_check_intra_bf16``."""
    _check_intra_bf16(*_prenorm_operands(cuda, BF16, b, p, c, d, sb,
                                         seed=b + p), route)


def _intra_dw_case(cuda, b, p, c, d, sb, seed, dtype=BF16):
    """(routes taken, then for each form, B6 dW and the plain form's: the
    kernel's dW, a second call's, the plain version's) of two calls of each
    intra dW wrapper."""
    f, ss, ti, _, _, dout = _prenorm_operands(cuda, dtype, b, p, c, d, sb,
                                              seed=seed)
    ik = tkern.intra_conv
    before = dict(ik.routes)
    runs = [(ik.intra_conv_prenorm_dw(f, ss, ti, dout),
             ik.intra_conv_dw(f, ti, dout)) for _ in range(2)]
    torch.cuda.synchronize()
    routes = {k: ik.routes[k] - before[k] for k in ik.routes
              if ik.routes[k] > before[k]}
    want = (ik.intra_conv_prenorm_dw_plain(f, ss, ti, dout),
            ik.intra_conv_dw_plain(f, ti, dout))
    return routes, list(zip(runs[0], runs[1], want))


@pytest.mark.parametrize('sb', [1, 2])
@pytest.mark.parametrize('p,c', MODEL_INTRA_SHAPES)
def test_intra_dw_mma_kernel_matches_plain(cuda, p, c, sb):
    """The tensor-core dW (B6 dW and the plain form's) at every intra layer
    shape of both models, 2 clouds, with one fold for the batch (sb = 1)
    and one a cloud (sb = 2): taken by the wrapper, fp32 and finite, within
    1e-3 (normwise) of the plain version (z rounded to bf16 at the same
    point, fp32 sums), bitwise equal on a second call (fixed-order partial
    sums, no atomics)."""
    routes, forms = _intra_dw_case(cuda, 2, p, c, c, sb, seed=p + c + sb)
    assert routes == {'dw_mma': 4}
    for got, again, want in forms:
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert bool(torch.isfinite(got).all())
        assert _rel(got, want) <= 1e-3
        assert torch.equal(got, again)


@pytest.mark.parametrize('b,p,c,sb', [
    (2, 7, 64, 2),        # 7 points a cloud, 14 in all: the last group short
    (3, 13, 128, 3),      # 39 points: groups across clouds, a fold a cloud
    (1, 1, 256, 1),       # one point: one group of 60 live rows
    (2, 21, 32, 1),       # 42 points at D = 32 (32 columns a block)
    (12, 509, 64, 1)])    # 6108 points: many splits, the last group short
def test_intra_dw_mma_kernel_edges(cuda, b, p, c, sb):
    """The tensor-core dW where the points do not fill its 8-point groups
    (the rows past the end stage as zeros), groups that span two clouds'
    folds, and D = 32: within 1e-3 of the plain version, bitwise equal on a
    second call, both forms."""
    routes, forms = _intra_dw_case(cuda, b, p, c, c, sb, seed=b + p)
    assert routes == {'dw_mma': 4}
    for got, again, want in forms:
        assert bool(torch.isfinite(got).all())
        assert _rel(got, want) <= 1e-3 and torch.equal(got, again)


@pytest.mark.parametrize('dtype,c,d', [(torch.float32, 36, 64),
                                       (BF16, 64, 96), (BF16, 96, 96)])
def test_intra_dw_off_envelope_takes_the_sgemm(cuda, dtype, c, d):
    """fp32 channels off the CUDA-core dW's 32 grid (and the fp32 prenorm
    form), bf16 c != d and a bf16 width no model layer has run the SGEMM
    (``intra_dw_kernel``): 1e-4 of the plain version in fp32, 1e-3 in
    bf16."""
    routes, forms = _intra_dw_case(cuda, 2, 9, c, d, 2, seed=c + d,
                                   dtype=dtype)
    assert routes == {'dw': 4}
    for got, _, want in forms:
        assert _rel(got, want) <= (1e-4 if dtype == torch.float32 else 1e-3)


def _intra_dw_f32_case(cuda, b, p, c, d, seed):
    """(routes taken, the kernel's dW, a second call's, the plain
    version's, the kernel's and the SGEMM's normwise errors against the
    plain version in float64) of the fp32 plain-form intra dW; the SGEMM
    (this tree's epn_intra_conv_bwd_w, fp32) on the same inputs."""
    f, _, ti, _, _, dout = _prenorm_operands(cuda, torch.float32, b, p, c, d,
                                             1, seed=seed)
    ik = tkern.intra_conv
    before = dict(ik.routes)
    got, again = ik.intra_conv_dw(f, ti, dout), ik.intra_conv_dw(f, ti, dout)
    torch.cuda.synchronize()
    routes = {k: ik.routes[k] - before[k] for k in ik.routes
              if ik.routes[k] > before[k]}
    splits, _ = ik.dw_splits(b * p, 60, 12, c, d, False)
    ws = torch.empty((splits, 12, c, d), device=cuda)
    sgemm = torch.empty_like(got)
    err = ik.build.library().epn_intra_conv_bwd_w(
        f.data_ptr(), ti.data_ptr(), 0, dout.data_ptr(), ws.data_ptr(),
        sgemm.data_ptr(), b, p, 60, 12, c, d, 0, ik.build.LEAKY_SLOPE, splits,
        0, ik.build.stream(f))
    assert err == 0
    want = ik.intra_conv_dw_plain(f.double(), ti, dout.double())
    torch.cuda.synchronize()
    f64 = (_rel(got.double(), want), _rel(sgemm.double(), want))
    return routes, got, again, want.float(), f64


@pytest.mark.parametrize('b,p,c', [
    (12, 512, 64), (12, 256, 128), (12, 128, 256), (12, 64, 256),
    (16, 512, 32), (16, 256, 64), (16, 128, 128), (16, 64, 128),
    (16, 64, 256)])
def test_intra_dw_f32_kernel_matches_plain(cuda, b, p, c):
    """The fp32 CUDA-core dW (``intra_dw_f32_kernel``) at every intra layer
    shape of the three models at their train batches (cls b=12, inv b=16 a
    leg, reg b=8 pairs: its last layer, 256 channels at 64 points, is new):
    taken by the wrapper, finite, within 1e-5 (normwise; fp32 sums over up
    to 368,640 rows in another order: 1.5e-6..2.9e-6 measured on the
    card, where the SGEMM is held to 1e-4) of the plain version, bitwise
    equal on a second call (fixed-order partial sums, no atomics), and its
    error against the float64 plain version at most 1.5x the SGEMM's on
    the same inputs."""
    routes, got, again, want, (rel, sgemm_rel) = _intra_dw_f32_case(
        cuda, b, p, c, c, seed=p + c)
    assert routes == {'dw_f32': 2}
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) <= 1e-5
    assert torch.equal(got, again)
    assert rel <= 1.5 * sgemm_rel, (rel, sgemm_rel)


@pytest.mark.parametrize('b,p,c,d', [
    (12, 509, 64, 64),    # 6108 points: the last split short
    (1, 3, 64, 64),       # three points: three one-point splits
    (2, 7, 64, 128),      # c != d
    (3, 11, 128, 64),     # c != d, the other way
    (2, 5, 32, 96)])      # three 32-column blocks
def test_intra_dw_f32_kernel_edges(cuda, b, p, c, d):
    """The fp32 CUDA-core dW where the last split holds fewer points, at a
    handful of points, and at c != d: within 1e-5 of the plain version,
    bitwise equal on a second call, within 1.5x the SGEMM's float64
    error."""
    routes, got, again, want, (rel, sgemm_rel) = _intra_dw_f32_case(
        cuda, b, p, c, d, seed=b + p)
    assert routes == {'dw_f32': 2}
    assert _rel(got, want) <= 1e-5 and torch.equal(got, again)
    assert rel <= 1.5 * sgemm_rel, (rel, sgemm_rel)


def _intra_fwd_f32_case(cuda, b, p, c, d, seed):
    """(routes taken, then for the forward and the df: the kernel's output,
    a second call's, the plain version in float64, the kernel's and the
    SGEMM's normwise errors against it) of the fp32 plain-form intra
    forward and df, called twice each; the SGEMM (this tree's
    epn_intra_conv, fp32) on the same operands (the df's: dout, the
    inverse adjacency and W^T)."""
    f, _, ti, inv, W, dout = _prenorm_operands(cuda, torch.float32, b, p, c,
                                               d, 1, seed=seed)
    ik = tkern.intra_conv
    before = dict(ik.routes)
    runs = [(ik.intra_conv(f, ti, W), ik.intra_conv_df(dout, ti, inv, W))
            for _ in range(2)]
    torch.cuda.synchronize()
    routes = {k: ik.routes[k] - before[k] for k in ik.routes
              if ik.routes[k] > before[k]}
    wants = (ik.intra_conv_plain(f.double(), ti, W.double()),
             ik.intra_conv_df_plain(dout.double(), ti, W.double()))
    operands = ((f, ti, W), (dout, inv, W.transpose(1, 2).contiguous()))
    cases = []
    for (g, idx, Wk), got, again, want in zip(operands, runs[0], runs[1],
                                              wants):
        sgemm = torch.empty_like(got)
        err = ik.build.library().epn_intra_conv(
            g.data_ptr(), idx.data_ptr(), Wk.data_ptr(), 0, sgemm.data_ptr(),
            b, p, 60, 12, Wk.shape[1], Wk.shape[2], 0, ik.build.LEAKY_SLOPE,
            0, ik.build.stream(g))
        assert err == 0
        torch.cuda.synchronize()
        cases.append((got, again, want, _rel(got.double(), want),
                      _rel(sgemm.double(), want)))
    return routes, cases


@pytest.mark.parametrize('b,p,c', [
    (12, 512, 64), (12, 256, 128), (12, 128, 256), (12, 64, 256),
    (16, 512, 32), (16, 256, 64), (16, 128, 128), (16, 64, 128)])
def test_intra_fwd_f32_kernel_matches_plain(cuda, b, p, c):
    """The fp32 CUDA-core forward (``intra_fwd_f32_kernel``) and the df
    that runs it at every intra layer shape of both models at their train
    batches (cls b=12, inv b=16 a leg): taken by the wrapper, finite,
    within 1e-5 (normwise) of the plain version, bitwise equal on a second
    call (each output sums its 12C terms in one order), and its error
    against the float64 plain version at most 1.5x the SGEMM's on the same
    inputs."""
    routes, cases = _intra_fwd_f32_case(cuda, b, p, c, c, seed=p + c)
    assert routes == {'fwd_f32': 4}
    for got, again, want, rel, sgemm_rel in cases:
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert bool(torch.isfinite(got).all())
        assert _rel(got, want.float()) <= 1e-5
        assert torch.equal(got, again)
        assert rel <= 1.5 * sgemm_rel, (rel, sgemm_rel)


@pytest.mark.parametrize('b,p,c,d', [
    (1, 7, 64, 64),       # 7 points, 4 a block: the last block 3 points
    (3, 13, 32, 32),      # 39 points, 8 a block at 32 columns
    (1, 1, 256, 256),     # one point
    (2, 7, 64, 128),      # c != d
    (3, 11, 128, 64),     # c != d, the other way
    (2, 5, 32, 96)])      # three 32-column blocks (the df: 96 channels)
def test_intra_fwd_f32_kernel_edges(cuda, b, p, c, d):
    """The fp32 CUDA-core forward and df where the points leave the last
    block short, at one point, at c != d and at 32-column blocks: within
    1e-5 of the plain version, bitwise equal on a second call, within 1.5x
    the SGEMM's float64 error."""
    routes, cases = _intra_fwd_f32_case(cuda, b, p, c, d, seed=b + p + c)
    assert routes == {'fwd_f32': 4}
    for got, again, want, rel, sgemm_rel in cases:
        assert _rel(got, want.float()) <= 1e-5 and torch.equal(got, again)
        assert rel <= 1.5 * sgemm_rel, (rel, sgemm_rel)


def test_intra_fwd_off_envelope_takes_the_sgemm(cuda):
    """An fp32 forward with channels off the 32 grid and the fp32 prenorm
    form run the SGEMM (``intra_conv_kernel``): within 1e-5 of their plain
    versions."""
    f, ss, ti, _, W, _ = _prenorm_operands(cuda, torch.float32, 2, 9, 64, 64,
                                           2, seed=3)
    f36 = f[..., :36].contiguous()
    W36 = W[:, :36].contiguous()
    ik = tkern.intra_conv
    before = dict(ik.routes)
    got = (ik.intra_conv(f36, ti, W36), ik.intra_conv_prenorm(f, ss, ti, W))
    torch.cuda.synchronize()
    assert {k: ik.routes[k] - before[k] for k in ik.routes
            if ik.routes[k] > before[k]} == {'sgemm': 2}
    assert _rel(got[0], ik.intra_conv_plain(f36, ti, W36)) <= 1e-5
    assert _rel(got[1], ik.intra_conv_prenorm_plain(f, ss, ti, W)) <= 1e-5


def test_intra_fwd_f32_kernel_sass_is_ffma_only(cuda):
    """The built library's SASS of every instantiation of the fp32
    CUDA-core forward holds FFMA and no tensor-core instruction (HMMA,
    GMMA): full fp32 products, no TF32 (cuobjdump)."""
    import os
    import shutil
    import subprocess
    build = tkern.intra_conv.build
    build.library()
    cuobjdump = shutil.which('cuobjdump') or os.path.join(
        os.environ.get('CUDA_HOME', '/usr/local/cuda'), 'bin', 'cuobjdump')
    sass = subprocess.run([cuobjdump, '-sass', build.lib_path],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if 'Function :' in line:
            name = line.split('Function :', 1)[1].strip()
            fn = name if 'intra_fwd_f32_kernel' in name else None
            if fn:
                counts[fn] = dict.fromkeys(('FFMA', 'HMMA', 'GMMA'), 0)
        elif fn:
            for op in counts[fn]:
                counts[fn][op] += op in line
    assert len(counts) == 2, counts          # BN = 64 and 32
    for c in counts.values():
        assert c['FFMA'] > 0 and c['HMMA'] == c['GMMA'] == 0, counts


@pytest.mark.parametrize('dtype', [torch.float32, BF16])
@pytest.mark.parametrize('b,p,c,d', [(3, 40, 64, 64), (12, 256, 64, 128),
                                     (12, 128, 256, 256), (2, 7, 32, 96),
                                     (2, 7, 36, 96), (32, 64, 256, 256),
                                     (2, 511, 64, 64), (4, 512, 32, 32),
                                     (2, 7, 36, 288), (1, 3, 36, 2592)])
def test_grouped_conv_bwd_kernels_match_plain(cuda, dtype, b, p, c, d):
    """B9: dx = dout W^T (normwise 1e-5 in fp32, 8e-3 in bf16), dW = x^T
    dout and dbias = the sum of dout (fp32 sums: 1e-4 from fp32 operands,
    1e-3 from bf16 ones), together (bf16: one launch up to d = 256, dx apart
    beyond; at d = 2592 the bf16 dx streams W) and each alone; the fp32 dx
    takes c % 32 == 0 only, so at c = 36 fp32 checks dW and dbias."""
    rng = np.random.RandomState(c + d)
    x = _rand(rng, (b, p, 60, c), cuda, dtype)
    W = _rand(rng, (c, d), cuda, dtype, 0.1)
    dout = _rand(rng, (b, p, 60, d), cuda, dtype)
    gc = tkern.grouped_conv
    fp32 = dtype == torch.float32
    parts = 2 if fp32 and c % 32 else 3
    want = gc.grouped_conv_bwd_plain(x, W, dout, parts)
    for form in ((3, 1, 2) if parts == 3 else (parts,)):
        dx, dW, dbias = gc.grouped_conv_bwd(x, W, dout, form)
        torch.cuda.synchronize()
        if form & 1:
            assert dx.dtype == dtype
            assert _rel(dx.float(), want[0].float()) <= \
                (1e-5 if fp32 else 8e-3)
        else:
            assert dx is None
        if form & 2:
            assert dW.dtype == dbias.dtype == torch.float32
            assert dW.shape == (c, d) and dbias.shape == (d,)
            assert _rel(dW, want[1]) <= (1e-4 if fp32 else 1e-3)
            assert _rel(dbias, want[2]) <= (1e-4 if fp32 else 1e-3)
        else:
            assert dW is None and dbias is None


@pytest.mark.parametrize('b,p1,stride,nn,c,d', BWD_SHAPES)
def test_inter_conv_bwd_kernels_bf16_match_plain(cuda, b, p1, stride, nn, c,
                                                 d):
    """The bf16 builds of dTable and dW: bf16 table, W and dout widened on
    load, fp32 sums (normwise 1e-3 against the plain versions on the same
    bf16 operands)."""
    gx, idx, f, rk, k2, W, dout = _inter_operands(cuda, b, p1, stride, nn, c,
                                                  d)
    f, W, dout = f.to(BF16), W.to(BF16), dout.to(BF16)
    ic = tkern.inter_conv
    dT = ic.inter_conv_dtable(gx, idx, p1, rk, k2, W, dout, 0.08)
    dW = ic.inter_conv_dw(gx, idx, f, rk, k2, dout, 0.08)
    torch.cuda.synchronize()
    assert dT.dtype == dW.dtype == torch.float32
    assert _rel(dT, ic.inter_conv_dtable_plain(gx, idx, p1, rk, k2, W, dout,
                                               0.08)) <= 1e-3
    assert _rel(dW, ic.inter_conv_dw_plain(gx, idx, f, rk, k2, dout,
                                           0.08)) <= 1e-3


# (entry, b, p1, stride, nn, c, d): every bf16 backward scatter layer of
# both models at b=2: the fused dTable at cls L1-L6 and inv B1L1, B2L1,
# B3L1, the W-off dG at inv B0L1, B1L0, B2L0, B3L0
SCATTER_LAYERS = [('dtable', 2, 512, 1, 16, 64, 64),
                  ('dtable', 2, 512, 2, 32, 64, 128),
                  ('dtable', 2, 256, 1, 16, 128, 128),
                  ('dtable', 2, 256, 2, 32, 128, 256),
                  ('dtable', 2, 128, 1, 16, 256, 256),
                  ('dtable', 2, 128, 2, 32, 256, 256),
                  ('dtable', 2, 256, 1, 32, 64, 64),
                  ('dtable', 2, 128, 1, 32, 128, 128),
                  ('dtable', 2, 64, 1, 32, 128, 128),
                  ('dg', 2, 512, 1, 32, 32, 32), ('dg', 2, 512, 2, 64, 32, 64),
                  ('dg', 2, 256, 2, 64, 64, 128),
                  ('dg', 2, 128, 2, 64, 128, 128)]


def _scatter_case(cuda, entry, b, p1, stride, nn, c, d, shadow=False,
                  seed=0, dtype=BF16, first=0):
    """(route taken, the kernel's dT, a second call's dT, the plain
    version's dT) of one backward scatter call in ``dtype``; shadow: every
    third neighbor slot (first, first + 3, ...) holds the shadow index."""
    gx, idx, _, rk, k2, W, dout = _inter_operands(cuda, b, p1, stride, nn, c,
                                                  d, seed=seed)
    if shadow:
        idx[:, :, first::3] = p1
    ic = tkern.inter_conv
    W, dout = W.to(dtype), dout.to(dtype)
    if entry == 'dtable':
        args = (gx, idx, p1, rk, k2, W, dout, 0.08)
    else:
        dF = _rand(np.random.RandomState(seed + 1),
                   (b, idx.shape[1], 60, 24, c), cuda, dtype)
        args = (gx, idx, p1, rk, k2, dF, 0.08)
    before = dict(ic.routes)
    got = getattr(ic, f'inter_conv_{entry}')(*args)
    again = getattr(ic, f'inter_conv_{entry}')(*args)
    torch.cuda.synchronize()
    route = [k for k in ic.routes if ic.routes[k] > before[k]]
    return route, got, again, getattr(ic, f'inter_conv_{entry}_plain')(*args)


@pytest.mark.parametrize('entry,b,p1,stride,nn,c,d', SCATTER_LAYERS)
def test_inter_bwd_mma_kernel_matches_plain(cuda, entry, b, p1, stride, nn,
                                            c, d):
    """The tensor-core backward scatter at every model layer shape, both
    entries, a third of the slots shadow: taken by the wrapper, its fp32 dT
    within 1e-3 (normwise) of the plain version at the same rounding points
    (dF, the weights and each slot's sum in bf16), on both calls. Not
    equal: the atomics add in an order that changes from run to run, and
    the fp32 sums of dF and of a slot, taken in another order than the
    plain version's, flip a few bf16 roundings."""
    route, got, again, want = _scatter_case(cuda, entry, b, p1, stride, nn,
                                            c, d, shadow=True, seed=nn + c)
    assert route == [f'{entry}_mma']
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) <= 1e-3
    assert _rel(again, want) <= 1e-3


@pytest.mark.parametrize('entry,b,p1,stride,nn,c,d', [
    ('dtable', 3, 40, 1, 8, 16, 32), ('dtable', 1, 30, 2, 20, 48, 96),
    ('dtable', 2, 33, 1, 40, 32, 64), ('dg', 3, 40, 1, 20, 16, 32),
    ('dg', 1, 45, 3, 8, 48, 32), ('dg', 2, 64, 2, 40, 32, 32)])
def test_inter_bwd_mma_kernel_edges(cuda, entry, b, p1, stride, nn, c, d):
    """The tensor-core scatter's edges: nn padded to whole m16 tiles of
    slots (8, 20, 40), an odd number of points (a block's second point
    absent), 16 and 48 channels, d = 32 and 96, shadow slots: within 1e-3
    of the plain version."""
    route, got, again, want = _scatter_case(cuda, entry, b, p1, stride, nn,
                                            c, d, shadow=True, seed=p1 + nn)
    assert route == [f'{entry}_mma']
    assert _rel(got, want) <= 1e-3 and _rel(again, want) <= 1e-3


@pytest.mark.parametrize('entry,b,p1,stride,nn,c,d', SCATTER_LAYERS)
def test_inter_bwd_f32_kernel_matches_plain(cuda, entry, b, p1, stride, nn,
                                            c, d):
    """The fp32 CUDA-core backward scatter at every model layer shape, both
    entries, a third of the slots shadow: taken by the wrapper, its dT
    within 1e-5 (normwise; its atomics add in an order that changes from
    run to run, its sums over d and k run in another order than the plain
    version's) of the plain version, on both calls."""
    route, got, again, want = _scatter_case(cuda, entry, b, p1, stride, nn,
                                            c, d, shadow=True, seed=nn + c,
                                            dtype=torch.float32)
    assert route == [f'{entry}_f32']
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) <= 1e-5
    assert _rel(again, want) <= 1e-5


@pytest.mark.parametrize('entry,b,p1,stride,nn,c,d,first', [
    ('dtable', 3, 40, 1, 1, 16, 32, 1), ('dtable', 1, 45, 3, 64, 48, 96, 0),
    ('dtable', 1, 45, 1, 20, 48, 160, 2), ('dg', 3, 40, 1, 1, 16, 32, 1),
    ('dg', 1, 45, 3, 64, 48, 32, 0), ('dg', 1, 45, 1, 40, 48, 32, 2)])
def test_inter_bwd_f32_kernel_edges(cuda, entry, b, p1, stride, nn, c, d,
                                    first):
    """The fp32 scatter's edges: nn = 1 (no shadow slot) and 64, 20 and 40
    slots, 16 and 48 channels, d = 32, 96 and 160 (2, 6 and 10 of the
    fused entry's 16-deep slices), p2 < p1 (stride 3), 120 tiles (fewer than the card's
    SMs: one a block) and 135 (a last round of 3 tiles), shadow slots:
    within 1e-5 of the plain version on both calls."""
    route, got, again, want = _scatter_case(cuda, entry, b, p1, stride, nn,
                                            c, d, shadow=True, seed=p1 + nn,
                                            dtype=torch.float32, first=first)
    assert route == [f'{entry}_f32']
    assert _rel(got, want) <= 1e-5 and _rel(again, want) <= 1e-5


@pytest.mark.parametrize('entry,dtype,c,d', [
    ('dtable', torch.float32, 40, 64), ('dtable', BF16, 40, 64),
    ('dg', torch.float32, 40, 32), ('dg', BF16, 40, 32)])
def test_inter_bwd_off_envelope_takes_the_template(cuda, entry, dtype, c, d):
    """Channels that are not a multiple of 16, in fp32 and bf16, run the
    template (``inter_dtable_kernel``) as before: 1e-5 of the plain version
    in fp32; in bf16 4e-3, the bound the bf16 forward's SGEMM keeps against
    a plain version (the template rounds dF, the anchor weights and every
    slot's sum where the plain version does, as the W-off dG below 60
    anchors is held to 1e-3 in ``test_woff_kernels_at_reduced_anchors``)."""
    gx, idx, _, rk, k2, W, dout = _inter_operands(cuda, 2, 64, 1, 16, c, d)
    ic = tkern.inter_conv
    W, dout = W.to(dtype), dout.to(dtype)
    if entry == 'dtable':
        args = (gx, idx, 64, rk, k2, W, dout, 0.08)
    else:
        args = (gx, idx, 64, rk, k2,
                _rand(np.random.RandomState(c), (2, 64, 60, 24, c), cuda,
                      dtype), 0.08)
    before = dict(ic.routes)
    got = getattr(ic, f'inter_conv_{entry}')(*args)
    torch.cuda.synchronize()
    assert [k for k in ic.routes if ic.routes[k] > before[k]] == [entry]
    assert _rel(got, getattr(ic, f'inter_conv_{entry}_plain')(*args)) <= \
        (1e-5 if dtype == torch.float32 else 4e-3)


def _dw_case(cuda, b, p1, stride, nn, c, d, dtype=BF16, seed=0, shadow=0):
    """(routes taken, the kernel's dW, a second call's dW, the plain
    version's dW) of one inter_conv_dw call, a third of the neighbor slots
    shadow (slots shadow, shadow + 3, ...)."""
    gx, idx, f, rk, k2, _, dout = _inter_operands(cuda, b, p1, stride, nn, c,
                                                  d, seed=seed)
    idx[:, :, shadow::3] = p1
    f, dout = f.to(dtype), dout.to(dtype)
    ic = tkern.inter_conv
    before = dict(ic.routes)
    got = ic.inter_conv_dw(gx, idx, f, rk, k2, dout, 0.08)
    again = ic.inter_conv_dw(gx, idx, f, rk, k2, dout, 0.08)
    torch.cuda.synchronize()
    route = [k for k in ic.routes if ic.routes[k] > before[k]]
    return route, got, again, ic.inter_conv_dw_plain(gx, idx, f, rk, k2,
                                                     dout, 0.08)


# (b, p1, stride, nn, c, d): cls L1 and L5, inv B2L1
DW_MMA_LAYERS = [(4, 512, 1, 16, 64, 64), (4, 128, 1, 16, 256, 256),
                 (4, 128, 1, 32, 128, 128)]


@pytest.mark.parametrize('b,p1,stride,nn,c,d', DW_MMA_LAYERS)
def test_inter_dw_mma_kernel_matches_plain(cuda, b, p1, stride, nn, c, d):
    """The tensor-core dW at cls L1 and L5 and inv B2L1: taken by the
    wrapper, within 1e-3 (normwise) of the plain version at the same
    rounding points (the anchor weights and F in bf16, fp32 sums), and
    bitwise equal on a second call (fixed-order partial sums, no
    atomics)."""
    route, got, again, want = _dw_case(cuda, b, p1, stride, nn, c, d,
                                       seed=nn + c)
    assert route == ['dw_mma']
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) <= 1e-3
    assert torch.equal(got, again)


@pytest.mark.parametrize('b,p1,stride,nn,c,d', [
    (1, 33, 1, 8, 16, 64), (3, 45, 3, 40, 48, 192), (2, 64, 2, 64, 32, 128)])
def test_inter_dw_mma_kernel_edges(cuda, b, p1, stride, nn, c, d):
    """The tensor-core dW's edges: rows not a whole number of 64-row tiles
    (33 and 15 points), nn padded to whole k16 steps of neighbors (8, 40)
    and nn = 64, 16 and 48 channels, d = 192: within 1e-3 of the plain
    version, bitwise equal on a second call."""
    route, got, again, want = _dw_case(cuda, b, p1, stride, nn, c, d,
                                       seed=p1 + nn)
    assert route == ['dw_mma']
    assert _rel(got, want) <= 1e-3 and torch.equal(got, again)


@pytest.mark.parametrize('b,p1,stride,nn,c,d', DW_MMA_LAYERS)
def test_inter_dw_f32_kernel_matches_plain(cuda, b, p1, stride, nn, c, d):
    """The fp32 CUDA-core dW at cls L1 and L5 and inv B2L1: taken by the
    wrapper, within 1e-4 (normwise; sums over up to 122,880 rows in
    another order) of the plain version, and bitwise equal on a second call
    (fixed-order partial sums, no atomics)."""
    route, got, again, want = _dw_case(cuda, b, p1, stride, nn, c, d,
                                       dtype=torch.float32, seed=nn + c)
    assert route == ['dw_f32']
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) <= 1e-4
    assert torch.equal(got, again)


@pytest.mark.parametrize('b,p1,stride,nn,c,d,shadow', [
    (1, 33, 1, 1, 16, 64, 1), (3, 45, 3, 40, 48, 192, 0),
    (2, 64, 2, 64, 32, 128, 0), (2, 37, 1, 16, 16, 256, 2)])
def test_inter_dw_f32_kernel_edges(cuda, b, p1, stride, nn, c, d, shadow):
    """The fp32 dW's edges: rows not a whole number of 32-row tiles (33,
    15 and 37 points), shadow neighbor slots (a third of them; none at nn
    = 1), nn = 1, 40 and 64, 16, 32 and 48 channels, d = 192 (three 64-column
    blocks) and 256 (one 256-column block): within 1e-4 of the plain
    version, bitwise equal on a second call."""
    route, got, again, want = _dw_case(cuda, b, p1, stride, nn, c, d,
                                       dtype=torch.float32, seed=p1 + nn,
                                       shadow=shadow)
    assert route == ['dw_f32']
    assert _rel(got, want) <= 1e-4 and torch.equal(got, again)


@pytest.mark.parametrize('dtype,c,d', [(torch.float32, 40, 64),
                                       (BF16, 40, 64), (BF16, 64, 64)])
def test_inter_dw_off_envelope_takes_the_template(cuda, dtype, c, d):
    """fp32 and bf16 channels that are not a multiple of 16, and bf16 at 12
    anchors (the tensor-core kernel takes 60) run the template
    (``inter_dw_kernel``): 1e-4 of the plain version in fp32; in bf16 1e-3,
    its F rounded at the plain version's rounding points."""
    if c == 64 and dtype == BF16:
        gx, idx, f, rk, k2, _, dout = _inter_operands(cuda, 2, 64, 1, 16, c,
                                                      d, seed=3)
        f, dout, rk = f[:, :, :12].to(BF16), dout[:, :, :12].to(BF16), rk[:12]
        f, dout = f.contiguous(), dout.contiguous()
        ic = tkern.inter_conv
        before = dict(ic.routes)
        got = ic.inter_conv_dw(gx, idx, f, rk.contiguous(), k2, dout, 0.08)
        torch.cuda.synchronize()
        route = [k for k in ic.routes if ic.routes[k] > before[k]]
        want = ic.inter_conv_dw_plain(gx, idx, f, rk, k2, dout, 0.08)
    else:
        route, got, _, want = _dw_case(cuda, 2, 64, 1, 16, c, d, dtype=dtype)
    assert route == ['dw']
    assert _rel(got, want) <= (1e-4 if dtype == torch.float32 else 1e-3)


@pytest.mark.parametrize('sb', [1, 12])
def test_production_bwd_reductions_are_deterministic(cuda, sb):
    """B6's dscale / dshift and the two dW kernels (B6, B9: with B9's dbias
    and dx, in one launch and each alone) add per-block partials in a fixed
    order: two runs are bitwise equal."""
    f, ss, ti, inv, W, dout = _prenorm_operands(cuda, BF16, 12, 128, 64, 64,
                                                sb, seed=4)
    Wg = W[0].contiguous()
    ik, gc = tkern.intra_conv, tkern.grouped_conv
    runs = [(ik.intra_conv_prenorm_df(dout, f, ss, ti, inv, W),
             ik.intra_conv_prenorm_dw(f, ss, ti, dout),
             gc.grouped_conv_bwd(f, Wg, dout)
             + gc.grouped_conv_bwd(f, Wg, dout, 1)
             + gc.grouped_conv_bwd(f, Wg, dout, 2)) for _ in range(2)]
    torch.cuda.synchronize()
    (df0, dss0), dw0, g0 = runs[0]
    (df1, dss1), dw1, g1 = runs[1]
    assert torch.equal(df0, df1) and torch.equal(dss0, dss1)
    assert torch.equal(dw0, dw1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1) if a is not None)


def test_bf16_train_step_launches_the_kernels(cuda):
    """A bf16 train step of a small model on the card goes through every
    production kernel, forward and backward, and every parameter gets a
    finite gradient; the plain path (torch autograd) launches none and
    gives the same loss."""
    from epn_pointcloud_tpu_torch import losses
    from epn_pointcloud_tpu_torch.app import config
    from epn_pointcloud_tpu_torch.models import cls_so3net_pn as tcls
    opt = config.parse_args(['experiment', '-d', 'unused', '--input-num',
                             '256'])
    opt.model.flag = 'attention'
    models = [tcls.build_model(opt, mlps=((64, 64), (64,)), out_mlps=(64,),
                               seed=3).to(cuda).train() for _ in range(2)]
    x = torch.from_numpy(_ball_points(np.random.RandomState(3), 2, 256)).to(
        cuda)
    label = torch.tensor([3, 17], device=cuda)
    rlabel = torch.tensor([5, 41], device=cuda)

    def step(model):
        pred, feat = model(x)
        loss = losses.attention_cross_entropy(pred, label, feat, rlabel,
                                              'default', 1.0)[0]
        loss.backward()
        return loss.item()
    tso3.set_compute_dtype('bf16')
    try:
        tkern.reset_counts()
        loss_k = step(models[0])
        counts = {k: v for k, v in tkern.counts().items() if v}
        with tkern.plain():
            loss_p = step(models[1])
        torch.cuda.synchronize()
    finally:
        tso3.set_compute_dtype('fp32')
    assert counts == {
        'fps': 1, 'ball_query': 3, 'ones_conv': 1, 'inter_conv': 2,
        'inter_conv_dtable': 2, 'inter_conv_dw': 2, 'intra_conv_prenorm': 3,
        'intra_conv_prenorm_df': 3, 'intra_conv_prenorm_dw': 3, 'moments': 9,
        'grouped_conv': 3, 'grouped_conv_bwd': 3}
    assert {k: v for k, v in tkern.counts().items() if v} == counts
    for m in models:
        assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
                   for p in m.parameters())
    assert abs(loss_k - loss_p) <= 1e-3 * abs(loss_p)


def test_bf16_dropout_step_and_eval_take_the_plain_intra_route(cuda):
    """With --dropout-rate 0.5 a bf16 train step defers nothing, as the JAX
    package's gates have it: the plain intra conv (its forward and df on
    the tensor-core intra_conv_mma_kernel, its dW on intra_dw_mma_kernel)
    where the prenorm form ran, no prenorm launch; the plain path on the
    same masks gives the same loss. Eval launches no fused tail."""
    from epn_pointcloud_tpu_torch import losses
    from epn_pointcloud_tpu_torch.app import config
    from epn_pointcloud_tpu_torch.models import cls_so3net_pn as tcls
    from epn_pointcloud_tpu_torch.nn.layers import set_dropout_generator
    opt = config.parse_args(['experiment', '-d', 'unused', '--input-num',
                             '256', '--dropout-rate', '0.5'])
    opt.model.flag = 'attention'
    models = [tcls.build_model(opt, mlps=((64, 64), (64,)), out_mlps=(64,),
                               seed=3).to(cuda).train() for _ in range(2)]
    x = torch.from_numpy(_ball_points(np.random.RandomState(3), 2, 256)).to(
        cuda)
    label = torch.tensor([3, 17], device=cuda)
    rlabel = torch.tensor([5, 41], device=cuda)

    def step(model):
        set_dropout_generator(model, torch.Generator(cuda).manual_seed(9))
        pred, feat = model(x)
        loss = losses.attention_cross_entropy(pred, label, feat, rlabel,
                                              'default', 1.0)[0]
        loss.backward()
        return loss.item()
    tso3.set_compute_dtype('bf16')
    try:
        tkern.reset_counts()
        loss_k = step(models[0])
        counts = {k: v for k, v in tkern.counts().items() if v}
        intra = dict(tkern.intra_conv.routes)
        with tkern.plain():
            loss_p = step(models[1])
        tkern.reset_counts()
        with torch.no_grad():
            logits = models[0].eval()(x)[0]
        eval_counts = {k: v for k, v in tkern.counts().items() if v}
        torch.cuda.synchronize()
    finally:
        tso3.set_compute_dtype('fp32')
    assert counts == {
        'fps': 1, 'ball_query': 3, 'ones_conv': 1, 'inter_conv': 2,
        'inter_conv_dtable': 2, 'inter_conv_dw': 2, 'intra_conv': 6,
        'intra_conv_dw': 3, 'moments': 9, 'grouped_conv': 3,
        'grouped_conv_bwd': 3}
    assert {k: v for k, v in intra.items() if v} == {'mma': 6, 'dw_mma': 3}
    assert abs(loss_k - loss_p) <= 1e-3 * abs(loss_p)
    assert eval_counts == {'fps': 1, 'ball_query': 3, 'ones_conv': 1,
                           'inter_conv': 2, 'intra_conv': 3, 'moments': 3,
                           'grouped_conv': 3}
    assert bool(torch.isfinite(logits).all())


# ------------------------------------------------------- W-off inter conv

# (b, p1, stride, nn, c, d): the inv model's composed-route layers B0L1,
# B1L0, B2L0 and B3L0 at b=4 (the port's own layout F [b, p2, na, K, c]),
# and the pooled cls model's 256-channel layers (the unfused grouping path)
WOFF_SHAPES = [(4, 512, 1, 32, 32, 32), (4, 512, 2, 64, 32, 64),
               (4, 256, 2, 64, 64, 128), (4, 128, 2, 64, 128, 128),
               (4, 128, 1, 16, 256, 256), (4, 128, 2, 32, 256, 256)]


@pytest.mark.parametrize('b,p1,stride,nn,c,d', WOFF_SHAPES)
def test_woff_kernels_match_plain(cuda, b, p1, stride, nn, c, d):
    """inter_conv_f (F, normwise <= 1e-5 and the forward's elementwise
    bound) and inter_conv_dg (dT by atomics, normwise <= 1e-5) against
    their plain versions."""
    gx, idx, f, rk, k2, _, _ = _inter_operands(cuda, b, p1, stride, nn, c, d)
    ic = tkern.inter_conv
    rng = np.random.RandomState(nn + c)
    dF = _rand(rng, (b, idx.shape[1], 60, 24, c), cuda)
    F = ic.inter_conv_f(gx, idx, f, rk, k2, 0.08)
    dT = ic.inter_conv_dg(gx, idx, p1, rk, k2, dF, 0.08)
    torch.cuda.synchronize()
    assert F.shape == (b, idx.shape[1], 60, 24, c) and dT.shape == f.shape
    _conv_close(F, ic.inter_conv_f_plain(gx, idx, f, rk, k2, 0.08), nn)
    assert _rel(dT, ic.inter_conv_dg_plain(gx, idx, p1, rk, k2, dF,
                                           0.08)) <= 1e-5


def test_woff_kernels_handle_the_shadow_index(cuda):
    """Slots holding the shadow index q read a zero row (F) and add nothing
    (dT)."""
    rng = np.random.RandomState(9)
    b, p2, nn, q, c = 2, 30, 64, 50, 32
    gx = _rand(rng, (b, p2, nn, 3), cuda, scale=0.2)
    idx = torch.from_numpy(rng.randint(0, q + 1, (b, p2, nn)).astype(
        np.int32)).to(cuda)
    idx[:, :, ::3] = q
    f = _rand(rng, (b, q, 60, c), cuda)
    kern = torch.from_numpy(tkp.get_spherical_kernel_points(0.28, 1)).to(cuda)
    rk, k2 = tso3.rotated_kernels(torch.from_numpy(tico.get_anchors(60))
                                  .to(cuda), kern)
    dF = _rand(rng, (b, p2, 60, 24, c), cuda)
    ic = tkern.inter_conv
    F = ic.inter_conv_f(gx, idx, f, rk, k2, 0.08)
    dT = ic.inter_conv_dg(gx, idx, q, rk, k2, dF, 0.08)
    torch.cuda.synchronize()
    _conv_close(F, ic.inter_conv_f_plain(gx, idx, f, rk, k2, 0.08), nn)
    assert _rel(dT, ic.inter_conv_dg_plain(gx, idx, q, rk, k2, dF,
                                           0.08)) <= 1e-5


def test_composed_route_matches_plain_autograd(cuda):
    """InterConvFn at a composed-route layer (c = 32) launches the W-fused
    forward, inter_conv_dg and inter_conv_f, neither fused backward kernel,
    and its dTable and dW equal torch autograd through the plain forward
    (normwise <= 1e-5 and 1e-4)."""
    gx, idx, f, rk, k2, W, dout = _inter_operands(cuda, 4, 512, 2, 64, 32, 64)
    ic = tkern.inter_conv
    tk, Wk = f.clone().requires_grad_(), W.clone().requires_grad_()
    tp, Wp = f.clone().requires_grad_(), W.clone().requires_grad_()
    tkern.reset_counts()
    (ic.InterConvFn.apply(gx, idx, tk, rk, k2, Wk, 0.08) * dout).sum() \
        .backward()
    torch.cuda.synchronize()
    assert {k: v for k, v in tkern.counts().items() if v} == {
        'inter_conv': 1, 'inter_conv_f': 1, 'inter_conv_dg': 1}
    (ic.inter_conv_plain(gx, idx, tp, rk, k2, Wp, 0.08) * dout).sum() \
        .backward()
    assert _rel(tk.grad, tp.grad) <= 1e-5
    assert _rel(Wk.grad, Wp.grad) <= 1e-4


def test_woff_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    """c above 256 or not a multiple of 8, nn above 64, K other than 24, an
    fp16 operand: a ValueError, never a quiet plain version (any anchor
    count is taken: ``test_woff_kernels_at_reduced_anchors``)."""
    ic = tkern.inter_conv
    kern = torch.from_numpy(tkp.get_spherical_kernel_points(0.28, 1)).to(cuda)
    rk, k2 = tso3.rotated_kernels(torch.from_numpy(tico.get_anchors(60))
                                  .to(cuda), kern)

    def ops(nn=16, c=32, K=24, na=60, dtype=torch.float32):
        gx = torch.zeros(1, 4, nn, 3, device=cuda)
        idx = torch.zeros(1, 4, nn, dtype=torch.int32, device=cuda)
        f = torch.zeros(1, 8, na, c, device=cuda, dtype=dtype)
        dF = torch.zeros(1, 4, na, K, c, device=cuda, dtype=dtype)
        return (gx, idx, f, rk[:na, :K].contiguous(), k2[:K].contiguous(),
                dF)
    for kw in ({'c': 264}, {'c': 36}, {'nn': 65}, {'K': 18},
               {'dtype': torch.float16}):
        gx, idx, f, r, kk, dF = ops(**kw)
        with pytest.raises(ValueError):
            ic.inter_conv_f(gx, idx, f, r, kk, 0.08)
        with pytest.raises(ValueError):
            ic.inter_conv_dg(gx, idx, 8, r, kk, dF, 0.08)


@pytest.mark.parametrize('na', [1, 20, 40])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('nn,c', [(64, 32), (32, 32), (64, 128)])
def test_woff_kernels_at_reduced_anchors(cuda, na, dtype, nn, c):
    """inter_conv_f and inter_conv_dg below 60 anchors, at the composed
    layers of the inv and reg models (c = 32 with nn = 64 and 32, c = 128
    with nn = 64), every fifth neighbor slot the shadow index: the SGEMM
    template's W-off mode (routes 'f' / 'dg'; at one anchor and nn = 64 on
    64-row blocks, whose neighbors fit shared memory), F within 1e-5 (fp32)
    or 1e-3 (bf16) of its plain version, bitwise on a second call, and dT
    within 1e-5 / 1e-3."""
    ic = tkern.inter_conv
    rng = np.random.RandomState(na + nn + c)
    b, p1, p2 = 2, 256, 128
    xyz = _ball_points(rng, b, p1)
    kern = torch.from_numpy(tkp.get_spherical_kernel_points(0.2, 1))
    rk, k2 = tso3.rotated_kernels(torch.from_numpy(tico.get_anchors(na)),
                                  kern)
    idx = rng.randint(0, p1, (b, p2, nn)).astype(np.int32)
    idx[:, :, ::5] = p1
    gx = (xyz[np.arange(b)[:, None, None], np.minimum(idx, p1 - 1)]
          - xyz[:, :p2, None]).astype(np.float32)
    gx, idx = (torch.from_numpy(a).to(cuda) for a in (gx, idx))
    rk, k2 = rk.to(cuda), k2.to(cuda)
    table = torch.from_numpy((0.5 * rng.randn(b, p1, na, c)).astype(
        np.float32)).to(cuda, dtype)
    dF = torch.from_numpy((0.5 * rng.randn(b, p2, na, 24, c)).astype(
        np.float32)).to(cuda, dtype)
    tkern.reset_counts()
    F = ic.inter_conv_f(gx, idx, table, rk, k2, 0.05)
    again = ic.inter_conv_f(gx, idx, table, rk, k2, 0.05)
    dT = ic.inter_conv_dg(gx, idx, p1, rk, k2, dF, 0.05)
    torch.cuda.synchronize()
    assert ic.routes['f'] == 2 and ic.routes['dg'] == 1, ic.routes
    assert F.dtype == dtype and F.shape == (b, p2, na, 24, c)
    assert torch.equal(F, again)
    tol = 1e-5 if dtype == torch.float32 else 1e-3
    assert _rel(F.float(), ic.inter_conv_f_plain(gx, idx, table, rk, k2,
                                                 0.05).float()) <= tol
    assert _rel(dT, ic.inter_conv_dg_plain(gx, idx, p1, rk, k2, dF,
                                           0.05)) <= tol


@pytest.mark.parametrize('b,p1,stride,nn,c,d', WOFF_SHAPES)
def test_woff_kernels_bf16_match_plain(cuda, b, p1, stride, nn, c, d):
    """The bf16 builds: inter_conv_f from a bf16 table (F bf16, rounded once
    on store; the tensor-core F) to a normwise 1e-3 of its plain version,
    inter_conv_dg from a bf16 dF (each slot's sum rounded to bf16, dT fp32)
    to 1e-3."""
    gx, idx, f, rk, k2, _, _ = _inter_operands(cuda, b, p1, stride, nn, c, d)
    ic = tkern.inter_conv
    rng = np.random.RandomState(nn + c)
    f = f.to(BF16)
    dF = _rand(rng, (b, idx.shape[1], 60, 24, c), cuda, dtype=BF16)
    F = ic.inter_conv_f(gx, idx, f, rk, k2, 0.08)
    dT = ic.inter_conv_dg(gx, idx, p1, rk, k2, dF, 0.08)
    torch.cuda.synchronize()
    assert F.dtype == BF16 and dT.dtype == torch.float32
    assert _rel(F.float(), ic.inter_conv_f_plain(gx, idx, f, rk, k2,
                                                 0.08).float()) <= 1e-3
    assert _rel(dT, ic.inter_conv_dg_plain(gx, idx, p1, rk, k2, dF,
                                           0.08)) <= 1e-3


# the composed-route layers of WOFF_SHAPES, and B0L1 at the step's b = 16
F_MMA_SHAPES = WOFF_SHAPES + [(16, 512, 1, 32, 32, 32)]


def _template_f(gx, idx, f, rk, k2):
    """The SGEMM template's fp32 W-off F (``epn_inter_conv_f`` with bf16 =
    0) on the same inputs."""
    b, p2, nn = idx.shape
    q, na, c = f.shape[1:]
    K = rk.shape[1]
    F = torch.empty((b, p2, na, K, c), device=f.device)
    build = tkern.inter_conv.build
    build.launch('epn_inter_conv_f', gx.data_ptr(), idx.data_ptr(),
                 f.data_ptr(), rk.data_ptr(), k2.data_ptr(), F.data_ptr(), b,
                 p2, nn, q, na, K, c, 0.08, 0, build.stream(f))
    torch.cuda.synchronize()
    return F


def _f_case(cuda, b, p1, stride, nn, c, dtype=BF16, shadow=False, seed=0):
    """(routes taken, the kernel's F, a second call's F, the plain version's
    F, and from an fp32 table the template's F, else None) of one
    inter_conv_f call from a table in ``dtype``; shadow: every third
    neighbor slot holds the shadow index."""
    gx, idx, f, rk, k2, _, _ = _inter_operands(cuda, b, p1, stride, nn, c,
                                               32, seed=seed)
    if shadow:
        idx[:, :, ::3] = p1
    f = f.to(dtype)
    ic = tkern.inter_conv
    before = dict(ic.routes)
    got = ic.inter_conv_f(gx, idx, f, rk, k2, 0.08)
    again = ic.inter_conv_f(gx, idx, f, rk, k2, 0.08)
    torch.cuda.synchronize()
    route = [k for k in ic.routes if ic.routes[k] > before[k]]
    template = (_template_f(gx, idx, f, rk, k2) if dtype == torch.float32
                else None)
    return (route, got, again, ic.inter_conv_f_plain(gx, idx, f, rk, k2, 0.08),
            template)


@pytest.mark.parametrize('b,p1,stride,nn,c,d', F_MMA_SHAPES)
def test_inter_f_mma_kernel_matches_plain(cuda, b, p1, stride, nn, c, d):
    """The tensor-core W-off F at every composed-route layer of the inv
    model (and B0L1 at b = 16): taken by the wrapper, its bf16 F within
    1e-3 (normwise) of the plain version at the same rounding points (the
    anchor weights in bf16, fp32 sums, F rounded once), and bitwise equal
    on a second call (no atomics)."""
    route, got, again, want, _ = _f_case(cuda, b, p1, stride, nn, c,
                                         seed=nn + c)
    assert route == ['f_mma']
    assert got.dtype == BF16 and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    assert _rel(got.float(), want.float()) <= 1e-3
    assert torch.equal(got, again)


@pytest.mark.parametrize('b,p1,stride,nn,c', [
    (1, 45, 3, 20, 32), (2, 64, 2, 64, 96), (3, 40, 1, 8, 64),
    (2, 33, 1, 40, 96)])
def test_inter_f_mma_kernel_edges(cuda, b, p1, stride, nn, c):
    """The tensor-core F's edges, a third of the slots shadow: nn padded to
    whole k16 steps (20, 8, 40), rows that end inside a 64-row block (900,
    7200, 3960 rows), c = 96 (three 32-channel chunks a row) and 64: within
    1e-3 of the plain version, bitwise equal on a second call."""
    route, got, again, want, _ = _f_case(cuda, b, p1, stride, nn, c,
                                         shadow=True, seed=p1 + nn)
    assert route == ['f_mma']
    assert _rel(got.float(), want.float()) <= 1e-3
    assert torch.equal(got, again)


@pytest.mark.parametrize('b,p1,stride,nn,c,d', F_MMA_SHAPES)
def test_inter_f_f32_kernel_matches_plain(cuda, b, p1, stride, nn, c, d):
    """The CUDA-core fp32 W-off F at every composed-route layer of the inv
    model (and B0L1 at b = 16): taken by the wrapper, its F bitwise equal
    to the SGEMM template's on the same inputs (each element summed over
    the neighbors in the template's order), within 1e-5 (normwise) of the
    plain version, and bitwise equal on a second call (no atomics)."""
    route, got, again, want, template = _f_case(
        cuda, b, p1, stride, nn, c, dtype=torch.float32, seed=nn + c)
    assert route == ['f_f32']
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, template)
    assert _rel(got, want) <= 1e-5
    assert torch.equal(got, again)


@pytest.mark.parametrize('b,p1,stride,nn,c', [
    (1, 45, 3, 20, 32), (2, 64, 2, 64, 96), (3, 40, 1, 8, 48),
    (2, 33, 1, 44, 48)])
def test_inter_f_f32_kernel_edges(cuda, b, p1, stride, nn, c):
    """The CUDA-core F's edges, a third of the slots shadow: a last stage
    of fewer than 8 neighbors (20, 44), rows that end inside a 64-row block
    (900, 7200, 3960 rows), c = 96 (three 32-channel chunks a row) and
    c = 48 (three 16-channel chunks): bitwise the template's, within 1e-5
    of the plain version, bitwise equal on a second call."""
    route, got, again, want, template = _f_case(
        cuda, b, p1, stride, nn, c, dtype=torch.float32, shadow=True,
        seed=p1 + nn)
    assert route == ['f_f32']
    assert torch.equal(got, template)
    assert _rel(got, want) <= 1e-5
    assert torch.equal(got, again)


@pytest.mark.parametrize('dtype,c', [(torch.float32, 40), (BF16, 40),
                                     (BF16, 24)])
def test_inter_f_off_envelope_takes_the_template(cuda, dtype, c):
    """fp32 channels that are not a multiple of 16, and bf16 ones that are
    not a multiple of 32, run the SGEMM template's W-off mode as before
    ('f'): the forward's fp32 bound in fp32, 8e-3 in bf16
    (``test_woff_kernels_bf16_match_plain``'s)."""
    route, got, _, want, _ = _f_case(cuda, 2, 64, 1, 32, c, dtype=dtype)
    assert route == ['f']
    if dtype == torch.float32:
        _conv_close(got, want, 32)
    else:
        assert _rel(got.float(), want.float()) <= 8e-3


def test_composed_route_bf16_matches_plain(cuda):
    """InterConvFn with a bf16 table at a composed-route layer (c = 32)
    launches the W-fused forward, inter_conv_dg and inter_conv_f, neither
    fused backward kernel; its bf16 dTable and dW equal the plain
    composition on the same operands (inter_conv_dg_plain,
    inter_conv_f_plain, dw_product) to a normwise 8e-3."""
    gx, idx, f, rk, k2, W, dout = _inter_operands(cuda, 4, 512, 2, 64, 32, 64)
    ic = tkern.inter_conv
    f, W, dout = f.to(BF16), W.to(BF16), dout.to(BF16)
    tk, Wk = f.clone().requires_grad_(), W.clone().requires_grad_()
    tkern.reset_counts()
    (ic.InterConvFn.apply(gx, idx, tk, rk, k2, Wk, 0.08).float()
     * dout.float()).sum().backward()
    torch.cuda.synchronize()
    assert {k: v for k, v in tkern.counts().items() if v} == {
        'inter_conv': 1, 'inter_conv_f': 1, 'inter_conv_dg': 1}
    K, c, d = W.shape
    dF = (dout.reshape(-1, d) @ W.reshape(K * c, d).t()).reshape(
        *dout.shape[:3], K, c)
    dT = ic.inter_conv_dg_plain(gx, idx, f.shape[1], rk, k2, dF, 0.08)
    F = ic.inter_conv_f_plain(gx, idx, f, rk, k2, 0.08)
    dW = ic.dw_product(F.reshape(-1, K * c), dout.reshape(-1, d))
    assert tk.grad.dtype == Wk.grad.dtype == BF16
    assert _rel(tk.grad.float(), dT) <= 8e-3
    assert _rel(Wk.grad.float(), dW.reshape(K, c, d)) <= 8e-3


def test_dw_product_sums_in_fp32_on_the_card(cuda):
    """dw_product from bf16 operands over 491,520 rows (inv B0L1's b*p2*na
    at b = 16) into [768, 32]: fp32 out, within 1e-4 of the float64 product
    of the same values (fp32 sums give ~3e-5 here; torch.matmul's default
    bf16 output, whose split reduction may add bf16 partials, ~1.6e-3)."""
    rng = torch.Generator(device=cuda).manual_seed(0)
    F2 = torch.randn((491520, 768), generator=rng, device=cuda).to(BF16)
    d2 = torch.randn((491520, 32), generator=rng, device=cuda).to(BF16)
    got = tkern.inter_conv.dw_product(F2, d2)
    want = F2.double().t() @ d2.double()
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (768, 32)
    assert _rel(got.double(), want) <= 1e-4


def test_bf16_inv_train_step_launches_the_kernels(cuda):
    """A bf16 triplet step of a small inv model (mlps ((32, 32), (64, 64)))
    on the card goes through every kernel of the bf16 inv path, the W-off
    pair at the composed B0L1 and B1L0 included, with the InstanceNorm folds
    a patch; every parameter gets a finite fp32 gradient; the plain path
    launches none and gives the same loss to 1e-3."""
    from epn_pointcloud_tpu_torch import losses
    from epn_pointcloud_tpu_torch.app import config
    from epn_pointcloud_tpu_torch.models import inv_so3net_pn as tinv
    opt = config.parse_args(['experiment', '-d', 'unused'])
    opt.model.model, opt.model.flag = 'inv_so3net_pn', 'attention'
    opt.model.search_radius = 0.4
    models = [tinv.build_model(opt, mlps=((32, 32), (64, 64)), seed=3)
              .to(cuda).train() for _ in range(2)]
    x = 0.4 * torch.from_numpy(_ball_points(np.random.RandomState(4), 4,
                                            1024)).to(cuda)

    def step(model):
        loss = losses.triplet_batch_loss(model(x[:2])[0], model(x[2:])[0],
                                         'soft', 1.0)[0]
        loss.backward()
        return loss.item()
    tso3.set_compute_dtype('bf16')
    try:
        tkern.reset_counts()
        loss_k = step(models[0])
        counts = {k: v for k, v in tkern.counts().items() if v}
        routes = dict(tkern.inter_conv.routes)
        with tkern.plain():
            loss_p = step(models[1])
        torch.cuda.synchronize()
    finally:
        tso3.set_compute_dtype('fp32')
    assert counts == {
        'fps': 2, 'ball_query': 8, 'ones_conv': 2, 'inter_conv': 6,
        'inter_conv_dtable': 2, 'inter_conv_dw': 2, 'inter_conv_f': 4,
        'inter_conv_dg': 4, 'intra_conv_prenorm': 8,
        'intra_conv_prenorm_df': 8, 'intra_conv_prenorm_dw': 8,
        'moments': 22, 'grouped_conv': 6, 'grouped_conv_bwd': 6}
    assert (routes['f_mma'], routes['f']) == (4, 0)
    assert {k: v for k, v in tkern.counts().items() if v} == counts
    for m in models:
        assert all(p.dtype == torch.float32 and p.grad is not None
                   and bool(torch.isfinite(p.grad).all())
                   for p in m.parameters())
    assert abs(loss_k - loss_p) <= 1e-3 * abs(loss_p)


def _inter_fwd_f32_case(cuda, b, p1, stride, nn, c, d, seed, shadow=False):
    """(routes taken, the fp32 W-fused forward's output, a second call's,
    the plain version in float64, the kernel's and the SGEMM template's
    normwise errors against it) on seeded operands: p1 / stride
    neighborhoods of nn points in a ball of p1 points (shadow: every third
    slot the shadow index), the template this tree's epn_inter_conv (bf16 =
    0) on the same inputs."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(_ball_points(rng, b, p1)).to(cuda)
    f = torch.from_numpy(rng.randn(b, p1, 60, c).astype(np.float32)).to(cuda)
    kern = torch.from_numpy(tkp.get_spherical_kernel_points(0.28, 1)).to(cuda)
    anchors = torch.from_numpy(tico.get_anchors(60)).to(cuda)
    W = torch.from_numpy(
        (0.05 * rng.randn(24, c, d)).astype(np.float32)).to(cuda)
    gx, idx, _, _ = tso3.sampling.inter_grouping_ball(x, stride, 0.4, nn)
    if shadow:
        idx = idx.clone()
        idx[:, :, ::3] = p1
    rk, k2 = tso3.rotated_kernels(anchors, kern)
    args = (gx.contiguous(), idx, f, rk, k2, W, 0.08)
    ic = tkern.inter_conv
    before = dict(ic.routes)
    got, again = ic.inter_conv(*args), ic.inter_conv(*args)
    torch.cuda.synchronize()
    routes = {k: ic.routes[k] - before[k] for k in ic.routes
              if ic.routes[k] > before[k]}
    tmpl = torch.empty_like(got)
    p2 = idx.shape[1]
    err = ic.build.library().epn_inter_conv(
        *(t.data_ptr() for t in args[:6]), tmpl.data_ptr(), b, p2, nn, p1,
        60, 24, c, d, 0.08, 0, ic.build.stream(f))
    assert err == 0
    want = ic.inter_conv_plain(gx.double(), idx, f.double(), rk.double(),
                               k2.double(), W.double(), 0.08)
    torch.cuda.synchronize()
    return (routes, got, again, want, _rel(got.double(), want),
            _rel(tmpl.double(), want))


# (p1, stride, nn, c, d) of every inter layer of both models: cls L1-L6,
# inv B0L1-B3L1 (one cloud's points; the models' batches only repeat them)
MODEL_INTER_LAYERS = [
    (512, 1, 16, 64, 64), (512, 2, 32, 64, 128), (256, 1, 16, 128, 128),
    (256, 2, 32, 128, 256), (128, 1, 16, 256, 256), (128, 2, 32, 256, 256),
    (512, 1, 32, 32, 32), (512, 2, 64, 32, 64), (256, 1, 32, 64, 64),
    (256, 2, 64, 64, 128), (128, 1, 32, 128, 128), (128, 2, 64, 128, 128),
    (64, 1, 32, 128, 128)]


@pytest.mark.parametrize('p1,stride,nn,c,d', MODEL_INTER_LAYERS)
def test_inter_fwd_f32_kernel_matches_plain(cuda, p1, stride, nn, c, d):
    """The fp32 CUDA-core W-fused forward (``inter_fwd_f32_kernel``) at
    every inter layer of both models (b = 2): taken by the wrapper, finite,
    within 1e-5 (normwise) of the plain version, bitwise equal on a second
    call (each output sums its 24C terms in one order), and its error
    against the float64 plain version at most 1.5x the template's on the
    same inputs."""
    routes, got, again, want, rel, tmpl_rel = _inter_fwd_f32_case(
        cuda, 2, p1, stride, nn, c, d, seed=p1 + nn + c + d)
    assert routes == {'fwd_f32': 2}
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    _conv_close(got, want.float(), 24 * c)
    assert torch.equal(got, again)
    assert rel <= 1.5 * tmpl_rel, (rel, tmpl_rel)


@pytest.mark.parametrize('b,p1,stride,nn,c,d,shadow', [
    (1, 2, 2, 16, 64, 256, False),   # one point: 60 rows, the block short
    (3, 7, 1, 1, 32, 64, False),     # one neighbor
    (2, 70, 1, 64, 16, 128, True),   # 64 neighbors, one 16-channel chunk
    (2, 40, 1, 13, 48, 32, False),   # nn not a multiple of 8, 32 columns
    (2, 40, 2, 16, 32, 96, True),    # three 32-column blocks
    (1, 30, 1, 16, 16, 512, False),  # two 256-column blocks
    (2, 50, 1, 16, 256, 256, True)])  # shadow slots at 256 channels
def test_inter_fwd_f32_kernel_edges(cuda, b, p1, stride, nn, c, d, shadow):
    """The fp32 CUDA-core forward where the rows leave the last block
    short, at one and 64 neighbors, at nn off the gather stage, at one
    channel chunk, at several column blocks and with shadow slots: within
    1e-5 of the plain version, bitwise equal on a second call, within 1.5x
    the template's float64 error."""
    routes, got, again, want, rel, tmpl_rel = _inter_fwd_f32_case(
        cuda, b, p1, stride, nn, c, d, seed=b + p1 + nn + c, shadow=shadow)
    assert routes == {'fwd_f32': 2}
    assert _rel(got, want.float()) <= 1e-5 and torch.equal(got, again)
    assert rel <= 1.5 * tmpl_rel, (rel, tmpl_rel)


@pytest.mark.parametrize('c,d,nn', [(40, 64, 16),   # c % 16 != 0
                                    (32, 64, 80)])  # nn > 64
def test_inter_fwd_off_envelope_takes_the_template(cuda, c, d, nn):
    """fp32 forwards off the CUDA-core kernel's envelope run the SGEMM
    template ('sgemm'), within 1e-5 of the plain version."""
    routes, got, _, want, _, _ = _inter_fwd_f32_case(cuda, 2, 100, 1, nn, c,
                                                     d, seed=c + d + nn)
    assert routes == {'sgemm': 2}
    assert _rel(got, want.float()) <= 1e-5


def test_inter_fwd_f32_kernel_sass_is_ffma_only(cuda):
    """The built library's SASS of every instantiation of the fp32
    CUDA-core W-fused forward holds FFMA and no tensor-core instruction
    (HMMA, GMMA): full fp32 products, no TF32 (cuobjdump)."""
    import os
    import shutil
    import subprocess
    build = tkern.inter_conv.build
    build.library()
    cuobjdump = shutil.which('cuobjdump') or os.path.join(
        os.environ.get('CUDA_HOME', '/usr/local/cuda'), 'bin', 'cuobjdump')
    sass = subprocess.run([cuobjdump, '-sass', build.lib_path],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if 'Function :' in line:
            name = line.split('Function :', 1)[1].strip()
            fn = name if 'inter_fwd_f32_kernel' in name else None
            if fn:
                counts[fn] = dict.fromkeys(('FFMA', 'HMMA', 'GMMA'), 0)
        elif fn:
            for op in counts[fn]:
                counts[fn][op] += op in line
    assert len(counts) == 4, counts          # BN = 256, 128, 64 and 32
    for c in counts.values():
        assert c['FFMA'] > 0 and c['HMMA'] == c['GMMA'] == 0, counts


# ---------------------------------------------------- data parallelism

def test_nccl_group_of_one_matches_the_step_alone(cuda, tmp_path):
    """The full-width cls fp32 step (b=12) through the trainer's
    distributed path in a NCCL world of one rank against the step of a
    trainer with no group (``dryrun.check_group_of_one``): bitwise the
    broadcast weights, the loss, the running statistics, the all-reduced
    gradients and the parameters after Adam; the gradients as close to the
    step alone's as a repeat of it (the fused dTable's atomics)."""
    from epn_pointcloud_tpu_torch.parallel import distributed, dryrun
    alone = dryrun.build_trainer('cls_fp32', 'full', cuda, str(tmp_path))
    init = {n: p.detach().clone() for n, p in alone.model.named_parameters()}
    want = dryrun.one_step(alone, 'cls_fp32', 'full')
    distributed.init_distributed(
        backend='nccl', world_size=1, rank=0,
        init_method=f'tcp://127.0.0.1:{dryrun.free_port()}')
    try:
        trainer = dryrun.build_trainer('cls_fp32', 'full', cuda,
                                       str(tmp_path))
        got, _ = dryrun.check_group_of_one(
            trainer, 'cls_fp32', 'full', init, want,
            dryrun.f64_grads('cls', 'full', cuda, str(tmp_path)))
    finally:
        distributed.shutdown()
    assert json.loads(str(got['launches']))['collectives']['grads'] == 1


def test_two_gloo_ranks_on_one_card_match_one_process(cuda, tmp_path):
    """Two gloo ranks on this card, each on 6 of the full-width cls fp32
    step's 12 clouds (global BatchNorm statistics, the gradients
    all-reduced), against one process's step on all 12: the gates of
    chip_smoke's [dp-gloo-2] (``dryrun.compare``'s fixed fp32 gates); both
    ranks equal; every kernel route of one process launched on each
    rank."""
    from epn_pointcloud_tpu_torch.parallel import dryrun
    out = str(tmp_path)
    dryrun.launch(2, ['--out', out, '--size', 'full', '--backend', 'gloo',
                      '--device', 'cuda:0', '--steps', 'cls_fp32'],
                  timeout=300, log_dir=str(tmp_path / 'logs'))
    want = dryrun.run_step('cls_fp32', 'full', cuda, str(tmp_path / 'one'))
    got = [dict(np.load(str(tmp_path / f'cls_fp32_rank{r}.npz')))
           for r in (0, 1)]
    for k in dryrun.leaves(got[0], ('grad/', 'param/', 'buffer/')):
        np.testing.assert_array_equal(got[0][k], got[1][k], err_msg=k)
    dryrun.check_routes('cls_fp32', got, want)
    dryrun.compare('cls_fp32', got[0], want,
                   dryrun.f64_grads('cls', 'full', cuda, str(tmp_path)))
