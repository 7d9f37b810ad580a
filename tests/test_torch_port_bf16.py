"""The bf16 production mode of the torch port (epn_pointcloud_tpu_torch) against
the JAX package on the CPU.

Per kernel, the port's plain version (what its wrapper runs on a CPU tensor)
against the JAX Pallas kernel in interpret mode: the ones weight sum, the
moments sums, the grouped 1x1 conv and its fused separable-block tail, the
prenorm intra conv and the bf16 W-fused inter conv. Each runs in fp32 where
the JAX kernel takes fp32 (the algorithm) and in bf16 once. Then the norm
folds, one separable block in bf16 eval against the JAX block with its
fused tail forced, the whole small cls_so3net_pn in bf16 against the JAX
package's bf16 and fp32 logits and the port's own fp32 logits, and the
``--compute-dtype bf16`` eval entry point.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epn_pointcloud_tpu.app import config as jconfig
from epn_pointcloud_tpu.models import cls_so3net_pn as jcls
from epn_pointcloud_tpu.nn import blocks as jblocks
from epn_pointcloud_tpu.nn import layers as jlayers
from epn_pointcloud_tpu.ops import sampling as jsampling
from epn_pointcloud_tpu.ops import so3conv as jso3
from epn_pointcloud_tpu.ops.pallas import grouped_conv as jgc
from epn_pointcloud_tpu.ops.pallas import inter_conv as jic
from epn_pointcloud_tpu.ops.pallas import intra_conv as jintra
from epn_pointcloud_tpu.ops.pallas import moments as jmom
from epn_pointcloud_tpu.ops.pallas import ones_conv as joc

from epn_pointcloud_tpu_torch import compat as tcompat
from epn_pointcloud_tpu_torch import run_modelnet
from epn_pointcloud_tpu_torch.data import synthetic as tsynth
from epn_pointcloud_tpu_torch.models import cls_so3net_pn as tcls
from epn_pointcloud_tpu_torch.nn import blocks as tblocks
from epn_pointcloud_tpu_torch.nn import layers as tlayers
from epn_pointcloud_tpu_torch.ops import kernels as tkern
from epn_pointcloud_tpu_torch.ops import so3conv as tso3
from epn_pointcloud_tpu_torch.ops.so3conv import SphericalPointCloud

# the slice's widths: every layer's (c, d) tiles the JAX grouped conv
# (grouped_conv.supported), so the JAX fused tail runs where the port's does
MLPS, OUT_MLPS = ((32, 32), (64,)), (64,)


def _bf16(a):
    """numpy fp32 -> the same values rounded to bf16, as fp32."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32), np.float64)


def _normwise(got, want):
    got, want = _np(got), _np(want)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _cosines(a, b):
    a, b = _np(a), _np(b)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


@pytest.fixture
def bf16_mode():
    """The port's bf16 policy inside the test, fp32 after it."""
    tso3.set_compute_dtype('bf16')
    try:
        yield
    finally:
        tso3.set_compute_dtype('fp32')


# ---------------------------------------------------------------- kernels


@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
def test_ones_conv_plain_matches_pallas_kernel(dtype):
    """F[b, p, a, k] = sum_n relu(1 - |gx - R_a kappa_k|^2 / sigma): the
    port's F against ones_weight_sum in interpret mode (its hi/lo bf16
    coordinate split bounds that agreement: tests/test_pallas_ones_conv.py's
    tolerance) and against the fp32 oracle of that test (rtol 1e-5)."""
    B, P2, NT, NA, K, Q = 2, 32, 16, 20, 24, 33
    rng = np.random.RandomState(0)
    xyz = jnp.asarray(rng.randn(B, Q - 1, 3).astype(np.float32) * 0.3)
    sup = jsampling.add_shadow_point(xyz)
    new_xyz = jnp.asarray(rng.randn(B, P2, 3).astype(np.float32) * 0.3)
    idx = rng.randint(0, Q - 1, size=(B, P2, NT)).astype(np.int32)
    anch = rng.randn(NA, 3, 3).astype(np.float32)
    ker = (rng.randn(K, 3) * 0.3).astype(np.float32)
    rk = jnp.einsum('aij,kj->aki', jnp.asarray(anch), jnp.asarray(ker))
    k2 = jnp.sum(jnp.asarray(ker) ** 2, -1)
    sigma = 0.1
    kt = joc.pick_kt(NA, K)
    jdt = jnp.float32 if dtype == 'fp32' else jnp.bfloat16
    want = joc.ones_weight_sum(
        jnp.asarray(idx).reshape(B, 1, P2 * NT), joc.make_tab16(sup),
        joc.make_xp8(new_xyz), joc.make_rk16_ones(rk, k2, kt, NA * kt),
        joc.make_k8_ones(rk, kt, NA * kt), sigma, NT, jdt, True)
    want = _np(want).reshape(B, P2, NA, kt)[..., :K]

    g = jnp.take_along_axis(sup, jnp.asarray(idx).reshape(B, -1, 1), axis=1)
    gx = np.asarray(g.reshape(B, P2, NT, 3) - new_xyz[:, :, None, :])
    trk, tk2 = tso3.rotated_kernels(_t(anch), _t(ker))
    tdt = torch.float32 if dtype == 'fp32' else torch.bfloat16
    got = tkern.ones_conv.ones_conv(_t(gx), trk, tk2, sigma, tdt)
    assert got.dtype == tdt and got.shape == (B, P2, NA, K)
    np.testing.assert_allclose(_np(got), want, rtol=1e-2, atol=6e-3)

    gx2 = jnp.sum(jnp.asarray(gx) ** 2, -1)
    cross = jnp.einsum('bpnc,akc->bpnak', jnp.asarray(gx), rk)
    d2 = gx2[..., None, None] + k2 - 2.0 * cross
    oracle = np.asarray(jax.nn.relu(1.0 - d2 / sigma).sum(axis=2))
    if dtype == 'fp32':
        np.testing.assert_allclose(_np(got), oracle, rtol=1e-5, atol=1e-6)
    else:   # one rounding of the fp32 sum
        np.testing.assert_allclose(_np(got), _bf16(oracle), rtol=2 ** -8,
                                   atol=1e-6)


@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
def test_moments_plain_matches_pallas_kernel(dtype):
    """Per-lane fp32 (sum, sum of squares) over the rows, from fp32 or bf16
    input (only the summation order differs: rtol 1e-5)."""
    x = np.random.RandomState(4).randn(3, 40, 2 * 128).astype(np.float32)
    if dtype == 'bf16':
        x = _bf16(x)
    jdt = jnp.float32 if dtype == 'fp32' else jnp.bfloat16
    ws, wsq = jmom.moments_sums(jnp.asarray(x, jdt), True)
    gs, gsq = tkern.moments.moments(
        _t(x, torch.float32 if dtype == 'fp32' else torch.bfloat16))
    assert gs.dtype == gsq.dtype == torch.float32
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(gsq.numpy(), np.asarray(wsq), rtol=1e-5,
                               atol=1e-5)


def _gc_operands(c, d, seed=0):
    na, b, p = 12, 2, 16
    rng = np.random.RandomState(seed)
    x = rng.randn(b, p, na * c).astype(np.float32)
    w = (rng.randn(c, d) * 0.1).astype(np.float32)
    bias = rng.randn(d).astype(np.float32)
    return na, b, p, x, w, bias


# every (c, d) of the grouped conv on both models' bf16 paths: cls's skips
# (64->64 .. 256->256) and head (256->256), inv's skips (32->32 .. 128->128)
GC_PAIRS = [(64, 64), (32, 64), (32, 32), (64, 128), (128, 128), (128, 256),
            (256, 256)]


@pytest.mark.parametrize('c,d', GC_PAIRS)
def test_grouped_conv_plain_matches_pallas_kernel(c, d):
    """fp32 to the JAX test's rtol = atol = 1e-5; bf16 operands (fp32
    accumulation, rounded once) to a normwise 4e-3."""
    na, b, p, x, w, bias = _gc_operands(c, d)
    want = jgc.grouped_conv1x1(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(bias), na, True)
    got = tkern.grouped_conv.grouped_conv(
        _t(x).reshape(b, p, na, c), _t(w), _t(bias))
    np.testing.assert_allclose(got.reshape(b, p, na * d).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)

    want = jgc.grouped_conv1x1(jnp.asarray(x, jnp.bfloat16),
                               jnp.asarray(w, jnp.bfloat16),
                               jnp.asarray(bias), na, True)
    got = tkern.grouped_conv.grouped_conv(
        _t(x, torch.bfloat16).reshape(b, p, na, c), _t(w, torch.bfloat16),
        _t(bias))
    assert got.dtype == torch.bfloat16
    assert _normwise(got.reshape(b, p, na * d), want) <= 4e-3


@pytest.mark.parametrize('c,d,bs,bm', [(64, 64, 1, 2), (32, 64, 1, 1)] + [
    (c, d, 1, 2) for c, d in GC_PAIRS[2:]])
def test_grouped_conv_tail_plain_matches_pallas_kernel(c, d, bs, bm):
    """The fused separable-block tail act(y*ssm0+ssm1) +
    act((x@W+bias)*ssk0+ssk1) against grouped_conv1x1_skip_epilogue: fp32
    at rtol = atol = 1e-5, bf16 at a normwise 4e-3."""
    na, b, p, x, w, bias = _gc_operands(c, d, seed=3)
    rng = np.random.RandomState(5)
    y = rng.randn(b, p, na * d).astype(np.float32)

    def mk_ss(nb):
        ss = np.zeros((nb, 8, na * d), np.float32)
        ss[:, 0] = rng.rand(nb, na * d) + 0.5
        ss[:, 1] = rng.randn(nb, na * d)
        return ss
    ssk, ssm = mk_ss(bs), mk_ss(bm)
    for jdt, tdt, check in (
            (jnp.float32, torch.float32,
             lambda g, w_: np.testing.assert_allclose(
                 _np(g), _np(w_), rtol=1e-5, atol=1e-5)),
            (jnp.bfloat16, torch.bfloat16,
             lambda g, w_: _normwise(g, w_) <= 4e-3 or pytest.fail(
                 f'normwise {_normwise(g, w_):.3e} > 4e-3'))):
        want = jgc.grouped_conv1x1_skip_epilogue(
            jnp.asarray(x, jdt), jnp.asarray(w, jdt), jnp.asarray(bias),
            jnp.asarray(ssk), jnp.asarray(y, jdt), jnp.asarray(ssm), na,
            act='leaky_relu', interpret=True)
        got = tkern.grouped_conv.grouped_conv_tail(
            _t(x, tdt).reshape(b, p, na, c), _t(w, tdt), _t(bias),
            _t(ssk[:, :2]), _t(y, tdt).reshape(b, p, na, d),
            _t(ssm[:, :2]))
        assert got.dtype == tdt
        check(got.reshape(b, p, na * d), want)


@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
def test_intra_conv_prenorm_plain_matches_pallas_kernel(dtype):
    """out = intra(act(f * scale + shift)) with z rounded to the operand type
    after the activation, against intra_conv_prenorm in interpret mode. As
    in tests/test_pallas_intra_conv.py, a small balanced adjacency stands in
    for the 60 x 12 group (which takes minutes in interpret mode; the port's
    gather over the real group is held to the JAX layer in
    tests/test_torch_port_convs.py). fp32 at rtol 1e-5, bf16 at a normwise
    4e-3."""
    rng = np.random.RandomState(2)
    na, nk, b, p, c, d = 8, 3, 2, 8, 16, 32
    ti = np.stack([(np.arange(na) + k) % na for k in range(nk)], axis=1)
    tit = tuple(map(tuple, ti.tolist()))
    f = rng.randn(b, p, na * c).astype(np.float32)
    W = (rng.randn(nk, c, d) * 0.1).astype(np.float32)
    w2 = np.transpose(W, (1, 0, 2)).reshape(c, nk * d)
    ss = np.zeros((b, 8, na * c), np.float32)
    ss[:, 0] = rng.rand(b, na * c) + 0.5
    ss[:, 1] = rng.randn(b, na * c) * 0.3
    jdt = jnp.float32 if dtype == 'fp32' else jnp.bfloat16
    tdt = torch.float32 if dtype == 'fp32' else torch.bfloat16
    want = jintra.intra_conv_prenorm(jnp.asarray(f, jdt), jnp.asarray(ss),
                                     jnp.asarray(w2, jdt), tit, 'leaky_relu',
                                     0.01, 8, True)
    got = tkern.intra_conv.intra_conv_prenorm(
        _t(f, tdt).reshape(b, p, na, c), _t(ss[:, :2]),
        torch.from_numpy(ti.astype(np.int32)), _t(W, tdt))
    assert got.dtype == tdt
    got = got.reshape(b, p, na * d)
    if dtype == 'fp32':
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    else:
        assert _normwise(got, want) <= 4e-3


@pytest.mark.parametrize('C,D,N', [(64, 64, 16), (128, 128, 16),
                                   (32, 64, 32)])
def test_inter_conv_bf16_plain_matches_pallas_kernel(C, D, N):
    """The W-fused inter conv with a bf16 table and W (fp32 coordinates,
    bf16 output) against fused_gather_conv_w in bf16 in interpret mode, in
    its lane-packed layout (C = D = 64), its plain one (C = D = 128) and at
    an inv-like shape (C = 32, D = 64, nn = 32); some neighbor slots hold
    the shadow index. inter_conv_mma_plain, the tensor-core kernel's
    arithmetic, rounds where the TPU kernel rounds (the anchor weights and F
    to bf16 before the product each feeds, fp32 sums, the output once):
    normwise <= 1e-3. The wrapper's plain version keeps the weights and F in
    fp32: normwise <= 1e-2."""
    rng = np.random.RandomState(3)
    B, P, AC, Q, K, sigma = 2, 16, 4, 61, 24, 0.1
    gx = (0.3 * rng.randn(B, P, N, 3)).astype(np.float32)
    tab = _bf16(rng.randn(B, Q, AC * C).astype(np.float32))
    idx = rng.randint(0, Q + 1, size=(B, P, N)).astype(np.int32)
    anch = rng.randn(AC, 3, 3).astype(np.float32)
    ker = (0.3 * rng.randn(K, 3)).astype(np.float32)
    W = _bf16((0.1 * rng.randn(K, C, D)).astype(np.float32))
    rk = jnp.einsum('aij,kj->aki', jnp.asarray(anch), jnp.asarray(ker))
    k2 = jnp.sum(jnp.asarray(ker) ** 2, -1)
    nt, tp, kt, _ = jic.plan(N, K)
    qp = -(-Q // 8) * 8
    tabp = jnp.pad(jnp.asarray(tab, jnp.bfloat16), ((0, 0), (0, qp - Q),
                                                    (0, 0)))
    want = jic.fused_gather_conv_w(
        jic.make_gx8(jnp.asarray(gx), nt),
        jnp.asarray(idx).reshape(B, 1, P * nt), tabp,
        jic.make_rk8_kmajor(rk, k2, tp, kt, sigma),
        jic.make_rk8(rk, k2, tp, kt, sigma),
        jnp.asarray(W, jnp.bfloat16).reshape(K * C, D), sigma, tp, kt, nt,
        None, True)
    args = (_t(gx), torch.from_numpy(idx),
            _t(tab, torch.bfloat16).reshape(B, Q, AC, C),
            _t(np.array(rk)), _t(np.array(k2)), _t(W, torch.bfloat16), sigma)
    got = tkern.inter_conv.inter_conv_mma_plain(*args)
    assert got.dtype == torch.bfloat16
    assert _normwise(got.reshape(B, P, AC * D), want) <= 1e-3
    got = tkern.inter_conv.inter_conv(*args)
    assert got.dtype == torch.bfloat16
    assert _normwise(got.reshape(B, P, AC * D), want) <= 1e-2


# ------------------------------------------------------------------ norms


def test_instance_norm_fold_matches_jax(bf16_mode):
    """The one-pass bf16 InstanceNorm: per-lane fold and the applied norm
    against the JAX package's _packed_instance_norm (fp32 statistics to
    rtol 1e-5; the bf16 output to one bf16 ulp)."""
    b, p, na, c = 2, 16, 60, 8
    x = _bf16(np.random.RandomState(6).randn(b, p, na, c).astype(np.float32)
              * 2.0 + 0.5)
    x3 = jnp.asarray(x.reshape(b, p, na * c), jnp.bfloat16)
    jscale, jshift = jlayers._packed_instance_norm(x3, na, 1e-5,
                                                   scale_shift=True)
    norm = tlayers.InstanceNorm()
    ss = norm.scale_shift(na, _t(x, torch.bfloat16))
    assert ss.shape == (b, 2, na * c) and ss.dtype == torch.float32
    np.testing.assert_allclose(ss[:, 0].numpy(), np.asarray(jscale),
                               rtol=1e-5)
    np.testing.assert_allclose(ss[:, 1].numpy(), np.asarray(jshift),
                               rtol=1e-5, atol=1e-6)
    want = jlayers._packed_instance_norm(x3, na, 1e-5)
    got = norm(_t(x, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got).reshape(b, p, na * c), _np(want),
                               rtol=2 ** -7, atol=1e-6)


def test_batch_norm_eval_fold_matches_jax():
    """The eval BatchNorm folded to per-lane (scale, shift) [1, 2, 60c]."""
    na, c = 60, 16
    rng = np.random.RandomState(7)
    jbn = jlayers.BatchNorm(groups=na)
    x3 = jnp.zeros((1, 4, na * c), jnp.float32)
    v = jbn.init(jax.random.PRNGKey(0), x3, train=False)
    v = {'params': {'scale': (1 + 0.2 * rng.randn(c)).astype(np.float32),
                    'bias': (0.1 * rng.randn(c)).astype(np.float32)},
         'batch_stats': {'mean': (0.1 * rng.randn(c)).astype(np.float32),
                         'var': (0.5 + rng.rand(c)).astype(np.float32)}}
    jscale, jshift = jbn.apply(v, x3, train=False, scale_shift=True)
    bn = tlayers.BatchNorm(c).eval()
    bn.load_state_dict({'weight': _t(v['params']['scale']),
                        'bias': _t(v['params']['bias']),
                        'running_mean': _t(v['batch_stats']['mean']),
                        'running_var': _t(v['batch_stats']['var'])})
    with torch.no_grad():
        ss = bn.scale_shift(na)
    assert ss.shape == (1, 2, na * c)
    np.testing.assert_allclose(ss[:, 0].numpy(), np.asarray(jscale),
                               rtol=1e-6)
    np.testing.assert_allclose(ss[:, 1].numpy(), np.asarray(jshift),
                               rtol=1e-5, atol=1e-7)


# ------------------------------------------------------ block and model


def _ball_points(rng, b, n):
    v = rng.randn(b, n, 3)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return (v * rng.rand(b, n, 1) ** (1.0 / 3.0)).astype(np.float32)


def _randomize_stats(params, stats, rng):
    """Move every BatchNorm off its init (running stats and affine)."""
    for k in params:
        if k.startswith('BatchNorm_'):
            c = params[k]['scale'].shape[0]
            params[k]['scale'] = (1.0 + 0.2 * rng.randn(c)).astype(np.float32)
            params[k]['bias'] = (0.1 * rng.randn(c)).astype(np.float32)
            stats[k]['mean'] = (0.1 * rng.randn(c)).astype(np.float32)
            stats[k]['var'] = (0.5 + rng.rand(c)).astype(np.float32)
        elif isinstance(params[k], dict) and k in stats:
            _randomize_stats(params[k], stats[k], rng)


def _numpy_variables(v, seed):
    v = jax.tree_util.tree_map(np.array, jax.device_get(
        {'params': v['params'], 'batch_stats': v['batch_stats']}))
    _randomize_stats(v['params'], v['batch_stats'], np.random.RandomState(seed))
    return v


def _jax_bf16_apply(fn):
    """fn() under the JAX package's bf16 policy with its fused eval tail
    forced (interpret mode on the CPU), restored after."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('EPN_FUSE_TAIL_FORCE', '1')
        jso3.set_compute_dtype('bf16')
        try:
            return fn()
        finally:
            jso3.set_compute_dtype('fp32')


def test_separable_block_bf16_matches_jax_fused_tail():
    """One strided SeparableSO3ConvBlock (32 -> 64) in bf16 eval on the same
    bf16 input and weights: the port's path (deferred inter norm in the
    prenorm intra conv, then the fused tail) against the JAX block with its
    fused tail forced, to a normwise 1e-2. Catches wiring faults the logits
    cosine can hide: the per-lane folds, the bias, the residual."""
    rng = np.random.RandomState(9)
    b, p, na, c, d = 2, 128, 60, 32, 64
    args = dict(dim_in=c, dim_out=d, kernel_size=1, stride=2, radius=0.35,
                sigma=0.06, n_neighbor=16, lazy_sample=True, dropout_rate=0.0,
                multiplier=2, activation='leaky_relu', pooling=None,
                kanchor=na, norm='BatchNorm2d')
    xyz = _ball_points(rng, b, p)
    f = _bf16(rng.randn(b, p, na, c).astype(np.float32))
    jx = jso3.SphericalPointCloud(
        jnp.asarray(xyz), jnp.asarray(f.reshape(b, p, na * c), jnp.bfloat16),
        None)
    jblk = jblocks.SeparableSO3ConvBlock(args)
    v = _numpy_variables(jax.jit(lambda: jblk.init(
        jax.random.PRNGKey(1), jx, train=True))(), seed=10)
    want = _jax_bf16_apply(lambda: jax.jit(lambda vv, xx: jblk.apply(
        vv, xx, train=False))(v, jx))[3].feats

    tblk = tblocks.SeparableSO3ConvBlock(args).eval()
    tblk.load_state_dict(tcompat.separable_block_state(v['params'],
                                                       v['batch_stats']))
    tso3.set_compute_dtype('bf16')
    try:
        with torch.no_grad():
            got = tblk(SphericalPointCloud(_t(xyz), _t(f, torch.bfloat16),
                                           None)).feats
    finally:
        tso3.set_compute_dtype('fp32')
    assert got.dtype == torch.bfloat16 and got.shape == (b, p // 2, na, d)
    assert _normwise(got.reshape(b, p // 2, na * d), want) <= 1e-2


@pytest.fixture(scope='module')
def slice_logits():
    """Logits of the small model on shared weights: JAX fp32, JAX bf16
    (fused tail forced), port fp32, port bf16 (in that order)."""
    opt = jconfig.default_opt()
    opt.model.model, opt.model.flag = 'cls_so3net_pn', 'attention'
    opt.model.kanchor, opt.model.input_num = 60, 256
    jmodel = jcls.build_model(opt, mlps=MLPS, out_mlps=OUT_MLPS)
    x = _ball_points(np.random.RandomState(11), 2, 256)
    v = _numpy_variables(jax.jit(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 256, 3)), train=False))(),
        seed=12)

    def japply():
        return np.asarray(jax.jit(lambda vv, xx: jmodel.apply(
            vv, xx, train=False)[0])(v, jnp.asarray(x)))
    j32 = japply()
    j16 = _jax_bf16_apply(japply)

    tmodel = tcls.build_model(opt, mlps=MLPS, out_mlps=OUT_MLPS).eval()
    sd = tcompat.from_jax_variables(v)
    tmodel.load_state_dict(sd)
    with torch.no_grad():
        t32 = tmodel(torch.from_numpy(x))[0]
        tso3.set_compute_dtype('bf16')
        try:
            t16 = tmodel(torch.from_numpy(x))[0]
        finally:
            tso3.set_compute_dtype('fp32')
    return {'jax_fp32': j32, 'jax_bf16': j16, 'port_fp32': t32,
            'port_bf16': t16, 'state_dict': sd, 'model': tmodel}


@pytest.mark.parametrize('ref', ['jax_bf16', 'jax_fp32', 'port_fp32'])
def test_small_model_bf16_logits_agree(slice_logits, ref):
    """Per-sample logits cosine >= 0.999 (tests/test_dtype_agreement.py's
    cls bound) of the port's bf16 eval forward against the JAX package's
    bf16 forward (fused tail forced), its fp32 forward, and the port's own
    fp32 forward."""
    got = slice_logits['port_bf16']
    assert got.dtype == torch.float32 and got.shape == (2, 40)
    assert torch.isfinite(got).all()
    cos = _cosines(got, slice_logits[ref])
    assert cos.min() >= 0.999, (ref, cos)


def test_jax_variables_drive_both_dtypes(slice_logits):
    """from_jax_variables gives fp32 parameters, which both compute dtypes
    use unchanged (bf16 casts at use, never in the module)."""
    sd, model = slice_logits['state_dict'], slice_logits['model']
    assert all(t.dtype == torch.float32 for t in sd.values())
    state = model.state_dict()
    assert all(torch.equal(state[k], sd[k]) for k in sd)
    # the port's fp32 forward is the PR-1 parity mode
    np.testing.assert_allclose(slice_logits['port_fp32'].numpy(),
                               slice_logits['jax_fp32'], rtol=1e-3,
                               atol=2e-3)


# ------------------------------------------------------------ entry point


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('modelnet_bf16'))
    tsynth.make_modelnet_tree(root, n_cats=2, n_train=0, n_test=3,
                              n_points=64, seed=1, splits=('testR',))
    return root


def test_run_modelnet_bf16_eval_end_to_end(tree, tmp_path):
    argv = ['experiment', '-d', tree, '--run-mode', 'eval', '-b', '2',
            '--input-num', '64', '--model-dir', str(tmp_path / 'runs')]
    try:
        trainer = run_modelnet.main(argv + ['--compute-dtype', 'bf16'],
                                    device='cpu')
        assert tso3.get_compute_dtype() == torch.bfloat16
    finally:
        tso3.set_compute_dtype('fp32')
    trainer.logger.close()
    logits = torch.cat(trainer.eval_logits)
    assert logits.shape == (6, 40) and logits.dtype == torch.float32
    assert torch.isfinite(logits).all()
    assert 0.0 <= trainer.test_accs[-1] <= 100.0
    ref = run_modelnet.main(argv, device='cpu')
    ref.logger.close()
    assert tso3.get_compute_dtype() == torch.float32
    assert _cosines(logits, torch.cat(ref.eval_logits)).min() >= 0.99


def test_bf16_training_is_refused(tree, tmp_path):
    """Training (and serving) in a compute dtype the port does not have is
    refused by the parser; bf16 training itself runs (its end-to-end run is
    in tests/test_torch_port_bf16_train.py)."""
    for mode in ('train', 'eval'):
        with pytest.raises(SystemExit):   # argparse: fp32 or bf16 only
            run_modelnet.main(['experiment', '-d', tree, '--run-mode', mode,
                               '--compute-dtype', 'fp16', '--input-num', '64',
                               '--model-dir', str(tmp_path / 'runs')],
                              device='cpu')


def test_bf16_block_refuses_train_mode(bf16_mode, monkeypatch):
    """A bf16 block in train mode refuses the eval-only fused tail (its skip
    BatchNorm needs the skip conv's batch statistics): it runs the unfused
    tail, differentiable, and moves its BatchNorms' running statistics."""
    blk = tblocks.SeparableSO3ConvBlock(dict(
        dim_in=8, dim_out=8, kernel_size=1, stride=1, radius=0.4, sigma=0.1,
        n_neighbor=8, kanchor=60, activation='leaky_relu',
        norm='BatchNorm2d')).train()
    tlayers.init_parameters(blk, torch.Generator().manual_seed(0))
    monkeypatch.setattr(tso3, 'separable_tail', lambda *a: pytest.fail(
        'the fused tail ran in train mode'))
    rng = np.random.RandomState(4)
    feats = _t(rng.randn(1, 8, 60, 8)).requires_grad_()
    x = SphericalPointCloud(_t(_ball_points(rng, 1, 8)), feats, None)
    out = blk(x).feats
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    out.float().square().sum().backward()
    assert feats.grad is not None and torch.isfinite(feats.grad).all()
    assert all(p.grad is not None for p in blk.parameters())
    for bn in (blk.norm, blk.inter_conv.norm):
        assert not torch.equal(bn.running_mean, torch.zeros(8))


def test_intra_ss_layout_matches_jax_pack():
    """The port's [b, 2, L] fold is rows 0 and 1 of the JAX [b, 8, L]
    packing (blocks._pack_ss), lanes anchor-major."""
    rng = np.random.RandomState(13)
    scale, shift = rng.rand(2, 60 * 4), rng.randn(2, 60 * 4)
    packed = np.asarray(jblocks._pack_ss(jnp.asarray(scale, jnp.float32),
                                         jnp.asarray(shift, jnp.float32)))
    assert packed.shape == (2, 8, 240)
    x = _bf16(rng.randn(2, 3, 60, 4).astype(np.float32))
    ss = np.stack([scale, shift], axis=1).astype(np.float32)
    got = tkern.intra_conv.prenorm_plain(_t(x), _t(packed[:, :2]))
    u = x.reshape(2, 3, 240) * ss[:, 0:1] + ss[:, 1:2]
    np.testing.assert_allclose(got.numpy().reshape(2, 3, 240),
                               np.where(u > 0, u, 0.01 * u), rtol=1e-6)


def test_fp32_policy_keeps_a_float64_model_wide():
    """The policy casts to bf16 in the production mode only: in fp32 mode a
    float64 copy of the model (the exact-arithmetic reference of the train
    checks) stays float64 through every op, the ones conv included."""
    opt = jconfig.default_opt()
    opt.model.model, opt.model.flag = 'cls_so3net_pn', 'attention'
    opt.model.input_num = 64
    model = tcls.build_model(opt, mlps=((8,), (16,)), out_mlps=(16,),
                             seed=2).double()
    x = torch.from_numpy(_ball_points(np.random.RandomState(1), 2, 64))
    with tkern.plain():
        logits, att = model(x.double())
    assert logits.dtype == att.dtype == torch.float64
    logits.sum().backward()
    assert model.backbone[0].blocks[0].inter_conv.conv.basic_conv.W.grad \
        .dtype == torch.float64


def test_fp32_policy_keeps_float64_values_in_eval():
    """In eval mode too a float64 model computes in float64: the eval
    BatchNorm and the PointNet head's concat, against the same formulas in
    numpy float64 (an fp32 step on the way would miss by ~1e-7)."""
    rng = np.random.RandomState(21)
    c, d, b, p = 6, 5, 2, 7
    bn = tlayers.BatchNorm(c).double().eval()
    stats = rng.randn(4, c)
    with torch.no_grad():
        bn.running_mean.copy_(torch.from_numpy(stats[0]))
        bn.running_var.copy_(torch.from_numpy(np.abs(stats[1]) + 0.5))
        bn.weight.copy_(torch.from_numpy(stats[2]))
        bn.bias.copy_(torch.from_numpy(stats[3]))
    x = rng.randn(b, p, 60, c)
    got = bn(torch.from_numpy(x))
    assert got.dtype == torch.float64
    want = ((x - stats[0]) / np.sqrt(np.abs(stats[1]) + 0.5 + 1e-5)
            * stats[2] + stats[3])
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-12,
                               atol=1e-12)

    head = tlayers.PointnetSO3Conv(c, d).double()
    tlayers.init_parameters(head, torch.Generator().manual_seed(3))
    xyz, feats = rng.randn(b, p, 3), rng.randn(b, p, 60, c)
    got = head(SphericalPointCloud(torch.from_numpy(xyz),
                                   torch.from_numpy(feats), None))
    assert got.dtype == torch.float64
    anchors = head.anchors.numpy()
    xyzr = np.einsum('aji,bpj->bpai', anchors,
                     xyz - xyz.mean(axis=1, keepdims=True))
    w = head.embed.weight.detach().numpy().reshape(d, c + 3)
    want = (np.concatenate([feats, xyzr], axis=-1) @ w.T
            + head.embed.bias.detach().numpy()).max(axis=1)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-12,
                               atol=1e-12)
