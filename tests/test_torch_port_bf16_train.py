"""The bf16 production-mode training step of the torch port against the JAX
package on the CPU.

Per kernel, the port's autograd Function, whose backward runs the kernels'
plain versions on a CPU tensor, against ``jax.vjp`` of the Pallas kernel in
interpret mode: the prenorm intra conv (df, dscale, dshift, dW; a fold of
batch 1 and of batch b), the grouped 1x1 conv (dx, dW, dbias), the bf16
W-fused inter conv (dTable, dW) and the moments sums. Then the packed
train-mode BatchNorm against the JAX ``BatchNorm(groups=60)``, one whole bf16
train step of a small model against the JAX package's eager bf16 step and a
float64 step on shared weights, how far bf16 rounding alone moves such a
step's gradients, and the ``--compute-dtype bf16`` train entry point.

``python tests/test_torch_port_bf16_train.py`` prints the values the
whole-step bounds were set from.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from epn_pointcloud_tpu import compat as jcompat
from epn_pointcloud_tpu import losses as jlosses
from epn_pointcloud_tpu.models import cls_so3net_pn as jcls
from epn_pointcloud_tpu.nn import layers as jlayers
from epn_pointcloud_tpu.ops import so3conv as jso3
from epn_pointcloud_tpu.ops.pallas import grouped_conv as jgc
from epn_pointcloud_tpu.ops.pallas import inter_conv as jic
from epn_pointcloud_tpu.ops.pallas import intra_conv as jintra
from epn_pointcloud_tpu.ops.pallas import moments as jmom

from epn_pointcloud_tpu_torch import compat as tcompat
from epn_pointcloud_tpu_torch import losses as tlosses
from epn_pointcloud_tpu_torch import run_modelnet
from epn_pointcloud_tpu_torch import train as ttrain
from epn_pointcloud_tpu_torch.data import synthetic as tsynth
from epn_pointcloud_tpu_torch.models import cls_so3net_pn as tcls
from epn_pointcloud_tpu_torch.nn import layers as tlayers
from epn_pointcloud_tpu_torch.ops import kernels as tkern
from epn_pointcloud_tpu_torch.ops import so3conv as tso3

from test_torch_port_train import (SMALL_MLPS, _ball_points, _opt,
                                   _perturb_norm_biases, _tree_leaves)

DTYPES = {'fp32': (jnp.float32, torch.float32),
          'bf16': (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32), np.float64)


def _normwise(got, want):
    got, want = _np(got), _np(want)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _cos(a, b):
    a, b = _np(a).ravel(), _np(b).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _t(a, dtype=torch.float32, grad=False):
    t = torch.from_numpy(np.array(a, np.float32)).to(dtype)
    return t.requires_grad_() if grad else t


@pytest.fixture
def bf16_mode():
    tso3.set_compute_dtype('bf16')
    try:
        yield
    finally:
        tso3.set_compute_dtype('fp32')


# ---------------------------------------------------------------- kernels


@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
@pytest.mark.parametrize('sb', [1, 2])
def test_intra_conv_prenorm_backward_matches_pallas_vjp(dtype, sb):
    """df, dss and dW of IntraConvPrenormFn (B6's plain versions, written
    from the formula) against jax.vjp of intra_conv_prenorm in interpret
    mode (_bwd_kernel_prenorm), on the small balanced adjacency of
    tests/test_pallas_intra_conv.py. A fold of batch 1 is broadcast to the
    JAX kernel's [b, 8, L], so its gradient sums over the clouds. fp32:
    normwise 1e-5 (summation order only); bf16: normwise 1e-4 (df and dW
    equal bit for bit, dss 6.6e-8 measured): the JAX kernel sums dW in
    fp32 and rounds it once to the weight's bf16, and autograd's cast of
    the port's fp32 dW to the bf16 W it was given rounds it at the same
    point."""
    rng = np.random.RandomState(20 + sb)
    na, nk, b, p, c, d = 8, 3, 2, 8, 16, 32
    ti = np.stack([(np.arange(na) + k) % na for k in range(nk)], axis=1)
    inv = np.stack([(np.arange(na) - k) % na for k in range(nk)], axis=1)
    tit = tuple(map(tuple, ti.tolist()))
    f = rng.randn(b, p, na * c).astype(np.float32)
    W = (rng.randn(nk, c, d) * 0.1).astype(np.float32)
    ss = np.zeros((sb, 8, na * c), np.float32)
    ss[:, 0] = rng.rand(sb, na * c) + 0.5
    ss[:, 1] = rng.randn(sb, na * c) * 0.3
    dout = rng.randn(b, p, na * d).astype(np.float32)
    jdt, tdt = DTYPES[dtype]

    def fwd(f_, s_, w_):
        s_ = jnp.broadcast_to(s_, (b, 8, na * c))
        return jintra.intra_conv_prenorm(f_, s_, w_, tit, 'leaky_relu', 0.01,
                                         8, True)
    w2 = jnp.asarray(np.transpose(W, (1, 0, 2)).reshape(c, nk * d), jdt)
    _, vjp = jax.vjp(fwd, jnp.asarray(f, jdt), jnp.asarray(ss), w2)
    jdf, jdss, jdw2 = vjp(jnp.asarray(dout, jdt))
    jdw = np.asarray(jdw2, np.float32).reshape(c, nk, d).transpose(1, 0, 2)

    tf = _t(f, tdt, True)
    tss = _t(ss[:, :2], grad=True)
    tW = _t(W, tdt, True)
    out = tkern.intra_conv.IntraConvPrenormFn.apply(
        tf.reshape(b, p, na, c), tss, torch.from_numpy(ti.astype(np.int32)),
        torch.from_numpy(inv.astype(np.int32)), tW)
    out.backward(_t(dout, tdt).reshape(b, p, na, d))
    assert tf.grad.dtype == tdt and tss.grad.dtype == torch.float32
    assert tss.grad.shape == (sb, 2, na * c)
    tol = 1e-5 if dtype == 'fp32' else 1e-4
    assert _normwise(tf.grad, jdf) <= tol
    assert _normwise(tss.grad, np.asarray(jdss)[:, :2]) <= tol
    assert _normwise(tW.grad, jdw) <= tol


@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
@pytest.mark.parametrize('c,d', [(64, 64), (32, 64), (32, 32), (64, 128),
                                 (128, 128), (128, 256), (256, 256)])
def test_grouped_conv_backward_matches_pallas_vjp(dtype, c, d):
    """dx, dW and dbias of GroupedConvFn (B9's plain version) against
    jax.vjp of grouped_conv1x1 in interpret mode (_gc_bwd -> _bwd_kernel,
    its block-diagonal cross terms discarded) at every (c, d) of both
    models' bf16 paths: fp32 normwise 1e-5, bf16 4e-3 (both round dx once;
    dW and dbias are fp32 sums there and here)."""
    rng = np.random.RandomState(c)
    na, b, p = 12, 2, 16
    x = rng.randn(b, p, na * c).astype(np.float32)
    w = (rng.randn(c, d) * 0.1).astype(np.float32)
    bias = rng.randn(d).astype(np.float32)
    dout = rng.randn(b, p, na * d).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    _, vjp = jax.vjp(lambda x_, w_, b_: jgc.grouped_conv1x1(x_, w_, b_, na,
                                                            True),
                     jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                     jnp.asarray(bias))
    jdx, jdw, jdb = vjp(jnp.asarray(dout, jdt))

    tx, tw, tb = _t(x, tdt, True), _t(w, tdt, True), _t(bias, grad=True)
    out = tkern.grouped_conv.GroupedConvFn.apply(tx.reshape(b, p, na, c), tw,
                                                 tb)
    out.backward(_t(dout, tdt).reshape(b, p, na, d))
    tol = 1e-5 if dtype == 'fp32' else 4e-3
    assert tx.grad.dtype == tdt
    assert _normwise(tx.grad, jdx) <= tol
    assert _normwise(tw.grad, jdw) <= tol
    assert _normwise(tb.grad, jdb) <= 1e-5


def test_inter_conv_bf16_backward_matches_pallas_vjp():
    """dTable and dW of InterConvFn in bf16 (dT rounded to the table's bf16
    after its fp32 fold) against jax.vjp of fused_gather_conv_w in bf16 in
    interpret mode, on the tp=8 one-kernel route of
    tests/test_torch_port_train.py, a third of the neighbor slots shadow.
    dT: normwise 5e-4 (8.3e-5 measured): the plain dTable rounds dF, the
    anchor weights and each slot's sum to bf16 where _bwd_gather_w_kernel
    does, so only fp32 summation order flips a rounding (3.6e-3 while it
    rounded none). dW: normwise 6e-4 (1.2e-4 measured): the plain dW
    rounds the anchor weights and F to bf16 before its fp32 product where
    _bwd_gather_w_kernel does (:1133, :1140); 3.2e-3 while it kept F in
    fp32, under a bound of 1e-2."""
    _fused_bf16_backward_case(16, 64, 32, seed=16, tp_want=8, dw_tol=6e-4)


def test_inter_conv_bf16_split_backward_matches_pallas_vjp():
    """The same on the split route (_call_gather_w_bwd_split ->
    _bwd_kernel_dtab / _bwd_kernel_dw2: nn = 32, tp = 4), whose dF, anchor
    weights and slot sums round where the one-kernel route's do: dT
    normwise 5e-4 (5.6e-6 measured); dW 2.5e-5 (4.7e-6 measured; the
    weights and F rounded where _bwd_kernel_dw2 rounds them, :1309,
    :1315; 3.1e-3 in fp32, under 1e-2)."""
    _fused_bf16_backward_case(32, 64, 64, seed=32, tp_want=4, dw_tol=2.5e-5)


def _fused_bf16_backward_case(N, C, D, seed, tp_want, dw_tol):
    rng = np.random.RandomState(seed)
    B, P, AC, Q, K, sigma = 2, 16, 4, 61, 24, 0.1
    gx = (0.3 * rng.randn(B, P, N, 3)).astype(np.float32)
    tab = rng.randn(B, Q, AC * C).astype(np.float32)
    idx = rng.randint(0, Q, size=(B, P, N)).astype(np.int32)
    idx[:, :, ::3] = Q
    anch = rng.randn(AC, 3, 3).astype(np.float32)
    ker = (0.3 * rng.randn(K, 3)).astype(np.float32)
    W = (0.1 * rng.randn(K, C, D)).astype(np.float32)
    dout = rng.randn(B, P, AC * D).astype(np.float32)
    rk = jnp.einsum('aij,kj->aki', jnp.asarray(anch), jnp.asarray(ker))
    k2 = jnp.sum(jnp.asarray(ker) ** 2, -1)
    nt, tp, kt, _ = jic.plan(N, K)
    assert tp == tp_want and not tkern.inter_conv.composed_backward(C, N)
    qp = -(-Q // 8) * 8
    tabp = jnp.pad(jnp.asarray(tab, jnp.bfloat16), ((0, 0), (0, qp - Q),
                                                    (0, 0)))
    gx8 = jic.make_gx8(jnp.asarray(gx), nt)
    rk8t, rk8k = (jic.make_rk8(rk, k2, tp, kt, sigma),
                  jic.make_rk8_kmajor(rk, k2, tp, kt, sigma))
    idx3 = jnp.asarray(idx).reshape(B, 1, P * nt)
    _, vjp = jax.vjp(lambda t, w2: jic.fused_gather_conv_w(
        gx8, idx3, t, rk8k, rk8t, w2, sigma, tp, kt, nt, None, True),
        tabp, jnp.asarray(W, jnp.bfloat16).reshape(K * C, D))
    jdt, jdw = vjp(jnp.asarray(dout, jnp.bfloat16))

    t_tab = _t(tab, torch.bfloat16).reshape(B, Q, AC, C).requires_grad_()
    t_W = _t(W, torch.bfloat16, True)
    out = tkern.inter_conv.InterConvFn.apply(
        _t(gx), torch.from_numpy(idx), t_tab, _t(np.array(rk)),
        _t(np.array(k2)), t_W, sigma)
    out.backward(_t(dout, torch.bfloat16).reshape(B, P, AC, D))
    assert t_tab.grad.dtype == t_W.grad.dtype == torch.bfloat16
    assert _normwise(t_tab.grad.reshape(B, Q, AC * C),
                     np.asarray(jdt, np.float32)[:, :Q]) <= 5e-4
    assert _normwise(t_W.grad.reshape(K * C, D), jdw) <= dw_tol


@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
def test_moments_backward_matches_jax_vjp(dtype):
    """MomentsFn's dx = dsum + 2 x dsq (fp32, rounded to x's type) against
    jax.vjp of moments_sums in interpret mode (_moments_bwd): fp32 rtol
    1e-6, bf16 to one bf16 rounding."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 24, 256).astype(np.float32)
    ds, dq = rng.randn(2, 2, 256).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    _, vjp = jax.vjp(lambda x_: jmom.moments_sums(x_, True),
                     jnp.asarray(x, jdt))
    jdx, = vjp((jnp.asarray(ds), jnp.asarray(dq)))
    tx = _t(x, tdt, True)
    s, sq = tkern.moments.MomentsFn.apply(tx)
    torch.autograd.backward((s, sq), (_t(ds), _t(dq)))
    assert tx.grad.dtype == tdt
    np.testing.assert_allclose(_np(tx.grad), _np(jdx),
                               rtol=1e-6 if dtype == 'fp32' else 2 ** -8,
                               atol=1e-6)


# ------------------------------------------------------------------ norms


def test_packed_train_batch_norm_matches_jax(bf16_mode):
    """The bf16 train-mode BatchNorm (one-pass statistics from the moments
    sums) against the JAX BatchNorm(groups=60) with train=True on the same
    bf16 input: the output to one bf16 rounding, the running statistics to
    rtol 1e-5, and the gradients of x, weight and bias (normwise 1e-2: bf16
    cotangents); its train-mode fold against the JAX fold (rtol 1e-5) and
    against the applied norm."""
    na, c, b, p = 60, 16, 2, 12
    rng = np.random.RandomState(8)
    x = rng.randn(b, p, na * c).astype(np.float32) * 1.5 + 0.3
    x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    scale = (1 + 0.2 * rng.randn(c)).astype(np.float32)
    bias = (0.1 * rng.randn(c)).astype(np.float32)
    g = rng.randn(b, p, na * c).astype(np.float32)
    stats = {'mean': (0.1 * rng.randn(c)).astype(np.float32),
             'var': (0.5 + rng.rand(c)).astype(np.float32)}
    jbn = jlayers.BatchNorm(groups=na)

    def japply(x_, sc, bi, scale_shift=False):
        return jbn.apply({'params': {'scale': sc, 'bias': bi},
                          'batch_stats': stats}, x_, train=True,
                         scale_shift=scale_shift, mutable=['batch_stats'])
    jy, jmut = japply(jnp.asarray(x, jnp.bfloat16), scale, bias)
    _, vjp = jax.vjp(lambda x_, sc, bi: japply(x_, sc, bi)[0],
                     jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale),
                     jnp.asarray(bias))
    jdx, jdsc, jdb = vjp(jnp.asarray(g, jnp.bfloat16))
    (jscale, jshift), _ = japply(jnp.asarray(x, jnp.bfloat16), scale, bias,
                                 scale_shift=True)

    bn = tlayers.BatchNorm(c).train()
    bn.load_state_dict({'weight': _t(scale), 'bias': _t(bias),
                        'running_mean': _t(stats['mean']),
                        'running_var': _t(stats['var'])})
    tx = _t(x, torch.bfloat16, True)
    y = bn(tx.reshape(b, p, na, c))
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(y).reshape(b, p, na * c), _np(jy),
                               rtol=2 ** -7, atol=1e-6)
    for k, buf in (('mean', bn.running_mean), ('var', bn.running_var)):
        np.testing.assert_allclose(buf.numpy(),
                                   np.asarray(jmut['batch_stats'][k]),
                                   rtol=1e-5, atol=1e-7)
    y.backward(_t(g, torch.bfloat16).reshape(b, p, na, c))
    assert _normwise(tx.grad, jdx) <= 1e-2
    assert _normwise(bn.weight.grad, jdsc) <= 1e-2
    assert _normwise(bn.bias.grad, jdb) <= 1e-2
    ss = bn.scale_shift(na, tx.detach().reshape(b, p, na, c))
    assert ss.shape == (1, 2, na * c) and ss.dtype == torch.float32
    np.testing.assert_allclose(ss[0, 0].detach().numpy(),
                               np.asarray(jscale)[0], rtol=1e-5)
    np.testing.assert_allclose(ss[0, 1].detach().numpy(),
                               np.asarray(jshift)[0], rtol=1e-5, atol=1e-6)
    applied = (tx.detach().float().reshape(b, p, na * c) * ss[:, 0]
               + ss[:, 1]).to(torch.bfloat16)
    np.testing.assert_allclose(_np(applied), _np(y).reshape(b, p, na * c),
                               rtol=2 ** -7, atol=1e-2)


def test_train_fold_needs_the_batch():
    with pytest.raises(ValueError, match='train mode'):
        tlayers.BatchNorm(4).train().scale_shift(60)


# ------------------------------------------------------------ whole step


def _port_step(model, x, label, rlabel, dtype='fp32'):
    """One train-mode forward and backward of the port in ``dtype``; the
    loss."""
    tso3.set_compute_dtype(dtype)
    try:
        model.train()
        pred, feat = model(torch.from_numpy(x).to(
            next(model.parameters()).dtype))
        loss, _ = tlosses.attention_cross_entropy(
            pred, torch.from_numpy(label), feat, torch.from_numpy(rlabel),
            'default', 1.0)
        loss.backward()
    finally:
        tso3.set_compute_dtype('fp32')
    return loss.item()


def _bf16_step(x_scale=0.0):
    """One bf16 train step of both packages on shared weights and one
    batch (its clouds scaled by 1 + x_scale), the JAX step eager (jit's
    reduction order puts rounding noise into block 0's constant-field
    BatchNorm), and the float64 gradients of the port's plain path (the
    exact-arithmetic stand-in, which also marks the degenerate leaves)."""
    opt = _opt()
    jmodel = jcls.build_model(opt, mlps=SMALL_MLPS)
    x0 = jnp.zeros((2, 256, 3), jnp.float32)
    init = jax.jit(lambda: jmodel.init(jax.random.PRNGKey(0), x0,
                                       train=False))()
    init = jax.tree_util.tree_map(np.asarray, {
        'params': init['params'], 'batch_stats': init['batch_stats']})
    tmodel = tcls.build_model(opt, mlps=SMALL_MLPS)
    tmodel.load_state_dict(tcompat.from_jax_variables(init))
    sd0 = _perturb_norm_biases(tmodel.state_dict())
    tmodel.load_state_dict(sd0)
    variables = jcompat.import_state_dict(init, sd0)

    rng = np.random.RandomState(31)
    x = (_ball_points(rng, 2, 256) * (1 + x_scale)).astype(np.float32)
    label = rng.randint(0, 40, 2)
    rlabel = rng.randint(0, 60, 2)

    def loss_fn(params):
        (pred, feat), mut = jmodel.apply(
            {'params': params, 'batch_stats': variables['batch_stats']},
            jnp.asarray(x), train=True, mutable=['batch_stats'])
        loss, _ = jlosses.attention_cross_entropy(
            pred, jnp.asarray(label), feat, jnp.asarray(rlabel), 'default',
            1.0)
        return loss, mut
    jso3.set_compute_dtype('bf16')
    try:
        (jloss, jmut), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
            variables['params'])
    finally:
        jso3.set_compute_dtype('fp32')

    m64 = copy.deepcopy(tmodel).double()
    with tkern.plain():
        _port_step(m64, x, label, rlabel)
    g64 = {n: p.grad.detach().float() for n, p in m64.named_parameters()}
    tloss = _port_step(tmodel, x, label, rlabel, 'bf16')
    grad_sd = {n: p.grad.detach().clone() for n, p in
               tmodel.named_parameters()}
    grad_sd.update({n: b.detach().clone() for n, b in tmodel.named_buffers()
                    if n in sd0})
    return dict(init=init, variables=variables, jloss=float(jloss),
                jmut=jmut, jgrads=jgrads, tmodel=tmodel, tloss=tloss,
                tgrads=jcompat.import_state_dict(init, grad_sd)['params'],
                f64=jcompat.import_state_dict(init, {**grad_sd, **g64})[
                    'params'],
                sd0=sd0)


@pytest.fixture(scope='module')
def bf16_step():
    return _bf16_step()


# a leaf whose float64 gradient is below this is mathematically zero (a
# bias feeding a BatchNorm; block 0's constant-field skip branch)
DEGENERATE_F64 = 1e-5
# what such a leaf may hold in the port: bf16 rounding noise, amplified by
# the 1/sqrt(eps) of a BatchNorm over a constant field (O(1) in both
# packages on block 0's skip conv), at most twice the JAX package's plus
# this floor
DEGENERATE_ABS = 1e-2
# per-leaf cosine bounds of a real gradient (the values this test measures
# are printed by running this file): the port's bf16 gradient to the
# float64 one, no farther from it than the JAX package's bf16 gradient less
# COS_MARGIN, and to the JAX bf16 step's. Two bf16 steps that round in
# different places (the JAX CPU path rounds the intra conv's Y where the
# kernel does not) differ by far more than their kernels do: bf16 gradients
# move with a few flipped roundings (test_bf16_gradients_move_with_rounding)
COS_F64 = 0.93
COS_MARGIN = 0.03
COS_JAX = 0.88


def _leaf_report(s):
    """(path, degenerate, cos port-f64, cos JAX-f64, cos port-JAX, max|port|,
    max|JAX|) for every gradient leaf of the step."""
    got, want = _tree_leaves(s['tgrads']), _tree_leaves(s['jgrads'])
    exact = dict(_tree_leaves(s['f64']))
    assert [p for p, _ in got] == [p for p, _ in want] == list(exact)
    rows = []
    for (path, g), (_, w) in zip(got, want):
        deg = bool(np.abs(_np(exact[path])).max() <= DEGENERATE_F64)
        cos = (None, None, None) if deg else (
            _cos(g, exact[path]), _cos(w, exact[path]), _cos(g, w))
        rows.append((path, deg) + cos + (np.abs(_np(g)).max(),
                                         np.abs(_np(w)).max()))
    return rows


def test_bf16_train_step_loss_and_gradients_match_jax(bf16_step):
    """Loss within rtol 5e-3 of the JAX bf16 step; every leaf with a real
    gradient at a cosine >= COS_F64 with the float64 gradient, no farther
    from it than the JAX package's bf16 gradient (less COS_MARGIN), and >=
    COS_JAX with the JAX package's; the degenerate leaves (from the float64
    pass, not listed by hand) no noisier than the JAX package's."""
    s = bf16_step
    np.testing.assert_allclose(s['tloss'], s['jloss'], rtol=5e-3)
    rows = _leaf_report(s)
    assert any(r[1] for r in rows), 'expected BN-invariant biases'
    for path, deg, c_t, c_j, c_tj, m_t, m_j in rows:
        if deg:
            assert m_t <= 2 * m_j + DEGENERATE_ABS, (path, m_t, m_j)
            continue
        assert c_t >= COS_F64 and c_t >= c_j - COS_MARGIN, (path, c_t, c_j)
        assert c_tj >= COS_JAX, (path, c_tj)


def _stats_errors(s):
    """Per leaf, the running statistics' max error after the step, relative
    to the leaf's magnitude."""
    tstats = jcompat.import_state_dict(
        s['init'], s['tmodel'].state_dict())['batch_stats']
    return {path: np.abs(_np(g) - _np(w)).max() / max(np.abs(_np(w)).max(),
                                                      1e-6)
            for (path, g), (_, w) in zip(
                _tree_leaves(tstats), _tree_leaves(s['jmut']['batch_stats']))}


def test_bf16_train_step_batchnorm_stats_match_jax(bf16_step):
    """Running mean and unbiased running var after the step, rtol 5e-3 of
    each leaf's magnitude."""
    for path, err in _stats_errors(bf16_step).items():
        assert err <= 5e-3, (path, err)


def test_bf16_train_step_adam_keeps_fp32_parameters(bf16_step):
    """Parameters and their gradients stay fp32 through the bf16 step (the
    bf16 casts are at use), and one torch Adam step equals optax.adam on the
    same gradients (rtol 1e-5 of each leaf's magnitude)."""
    s = bf16_step
    tmodel = s['tmodel']
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in tmodel.parameters())
    opt_t = ttrain.make_optimizer(tmodel.parameters(), 1e-3)
    opt_t.step()
    got = jcompat.import_state_dict(s['init'], tmodel.state_dict())['params']
    params = s['variables']['params']
    tx = optax.adam(1e-3, b1=0.9, b2=0.999, eps=1e-8)
    updates, _ = tx.update(s['tgrads'], tx.init(params), params)
    want = optax.apply_updates(params, updates)
    for (path, g), (_, w) in zip(_tree_leaves(got), _tree_leaves(want)):
        err = np.abs(_np(g) - _np(w)).max()
        assert err <= 1e-5 * max(np.abs(_np(w)).max(), 1e-6), path
    tmodel.load_state_dict(s['sd0'])


def _rounding_sensitivity():
    """Per real leaf (float64 gradient not ~0), the cosine between the
    port's gradients on a batch and on the same clouds scaled by 1 + 1e-6,
    in fp32 and in bf16 (a seeded small model, norm biases off zero)."""
    model = tcls.build_model(_opt(), mlps=SMALL_MLPS, seed=0)
    model.load_state_dict(_perturb_norm_biases(model.state_dict()))
    rng = np.random.RandomState(31)
    x = _ball_points(rng, 2, 256)
    label, rlabel = rng.randint(0, 40, 2), rng.randint(0, 60, 2)
    m64 = copy.deepcopy(model).double()
    with tkern.plain():
        _port_step(m64, x, label, rlabel)
    real = {n for n, p in m64.named_parameters()
            if p.grad.abs().max() > DEGENERATE_F64}
    out = {}
    for dtype in ('fp32', 'bf16'):
        grads = []
        for xx in (x, (x * (1 + 1e-6)).astype(np.float32)):
            m = copy.deepcopy(model)
            _port_step(m, xx, label, rlabel, dtype)
            grads.append({n: p.grad for n, p in m.named_parameters()})
        out[dtype] = {n: _cos(grads[0][n], grads[1][n]) for n in real}
    return out


def test_bf16_gradients_move_with_rounding():
    """Why two bf16 steps agree only to cosines ~0.9 per leaf: scaling the
    clouds by 1 + 1e-6 leaves the fp32 gradients in place (cosine >=
    0.9999 on every real leaf) but flips bf16 roundings enough to move the
    bf16 gradients by far more (a cosine floor of 0.95 here)."""
    sens = _rounding_sensitivity()
    assert min(sens['fp32'].values()) >= 0.9999, sens['fp32']
    assert min(sens['bf16'].values()) >= 0.95, sens['bf16']


# ------------------------------------------------------------ entry point


def test_run_modelnet_bf16_train_end_to_end(tmp_path):
    """Two bf16 train steps (b=12 forced) on a synthetic tree, a checkpoint
    at step 2 and its eval; the checkpoint serves through --run-mode eval
    --compute-dtype bf16 -r with the trained model's logits."""
    import math
    root = str(tmp_path / 'mn')
    tsynth.make_modelnet_tree(root, n_cats=4, n_train=3, n_test=1,
                              n_points=64, seed=3, splits=('train', 'testR'))
    runs = str(tmp_path / 'runs')
    common = ['--input-num', '64', '--compute-dtype', 'bf16', '--model-dir',
              runs]
    try:
        trainer = run_modelnet.main(['experiment', '-d', root, '--run-mode',
                                     'train', '-i', '2', '--save-freq', '2',
                                     '-lf', '1'] + common, device='cpu')
        trainer.logger.close()
        assert tso3.get_compute_dtype() == torch.bfloat16
        assert trainer.iter_counter == 2
        for k in ('Loss', 'R_Loss'):
            assert math.isfinite(trainer.summary.get_item(k)), k
        assert all(p.dtype == torch.float32
                   for p in trainer.model.parameters())
        trained = torch.cat(trainer.eval_logits)
        assert trained.shape == (4, 40) and torch.isfinite(trained).all()
        other = run_modelnet.main(['experiment', '-d', root, '--run-mode',
                                   'eval', '-b', '12', '-r',
                                   trainer.last_ckpt] + common, device='cpu')
        other.logger.close()
    finally:
        tso3.set_compute_dtype('fp32')
    torch.testing.assert_close(torch.cat(other.eval_logits), trained,
                               rtol=0, atol=0)


# the leaf whose cosine to float64 sits closest to COS_F64: block 0's
# constant-field skip BatchNorm bias, the channel sums of the gradient at
# block 0's output
SKIP_BIAS = ("['BasicSO3ConvBlock_0']['SeparableSO3ConvBlock_0']"
             "['BatchNorm_0']['bias']")


def _rounded_inter(*args):
    """The bf16 plain inter forward at the TPU kernel's rounding points
    (``inter_conv_mma_plain``), fp32 as the plain version."""
    fn = (tkern.inter_conv.inter_conv_mma_plain
          if args[2].dtype == torch.bfloat16 else _PLAIN_INTER)
    return fn(*args)


_PLAIN_INTER = tkern.inter_conv.inter_conv_plain


def _leaf_spread(scales=(0.0, 1e-6, -1e-6, 2e-6, -2e-6, 3e-6)):
    """SKIP_BIAS's cosine to float64 for the port with the plain inter
    forward as it is and at the TPU kernel's rounding points, and for the
    JAX package, on the clouds scaled by 1 + s for each s."""
    for s in scales:
        row = []
        for fn in (_PLAIN_INTER, _rounded_inter):
            tkern.inter_conv.inter_conv_plain = fn
            try:
                step = _bf16_step(s)
            finally:
                tkern.inter_conv.inter_conv_plain = _PLAIN_INTER
            rep = {r[0]: r for r in _leaf_report(step)}[SKIP_BIAS]
            row += [rep[2], rep[3]]
        print(f'clouds x (1 {s:+.0e}): port {row[0]:.4f}, port with the '
              f'rounded inter forward {row[2]:.4f}, JAX {row[1]:.4f}')


def _op_by_op():
    """The port's bf16 step against its float64 step (the plain path),
    module by module on the batch of ``_bf16_step``: each module output's
    forward error, and its gradient's cosine to float64, whole and summed
    over every axis but the channels (SKIP_BIAS is such a sum at
    ``backbone.0.blocks.0.norm``); with the plain inter forward as it is
    and at the TPU kernel's rounding points."""
    import contextlib
    from epn_pointcloud_tpu_torch.nn import blocks as tblocks
    kinds = (tblocks.SeparableSO3ConvBlock, tlayers.InterSO3Conv,
             tlayers.IntraSO3Conv, tlayers.Dense1x1, tlayers.BatchNorm,
             tlayers.InstanceNorm)
    s = _bf16_step()
    rng = np.random.RandomState(31)
    x = _ball_points(rng, 2, 256)
    label, rlabel = rng.randint(0, 40, 2), rng.randint(0, 60, 2)

    def feats(o):
        if isinstance(o, torch.Tensor):
            return o if o.dtype.is_floating_point else None
        for e in (o if isinstance(o, tuple) else (getattr(o, 'feats',
                                                          None),)):
            f = feats(e) if e is not None else None
            if f is not None:
                return f
        return None

    def run(model, dtype, plain=False):
        caps, hooks = {}, []
        for name, m in model.named_modules():
            if isinstance(m, kinds):
                def hook(mod, inp, out, name=name):
                    f = feats(out)
                    if f is not None and f.requires_grad:
                        f.retain_grad()
                        caps[name] = f
                hooks.append(m.register_forward_hook(hook))
        with tkern.plain() if plain else contextlib.nullcontext():
            _port_step(model, x, label, rlabel, dtype)
        for h in hooks:
            h.remove()
        return caps
    def fresh():
        model = copy.deepcopy(s['tmodel'])
        model.load_state_dict(s['sd0'])
        model.zero_grad(set_to_none=True)
        return model
    ref = run(fresh().double(), 'fp32', plain=True)
    for fn, tag in ((_PLAIN_INTER, 'as it is'),
                    (_rounded_inter, 'at the TPU kernel\'s rounding points')):
        print(f'the plain inter forward {tag}: module, forward error, '
              f'gradient cosine to float64, whole and over channel sums')
        tkern.inter_conv.inter_conv_plain = fn
        try:
            caps = run(fresh(), 'bf16')
        finally:
            tkern.inter_conv.inter_conv_plain = _PLAIN_INTER
        for name, f in caps.items():
            r = ref.get(name)
            if r is None or f.grad is None or r.grad is None:
                continue
            fe = _normwise(f.detach(), r.detach())
            g, w = _np(f.grad), _np(r.grad)
            gs, ws = (a.reshape(-1, a.shape[-1]).sum(0) for a in (g, w))
            print(f'  {name}: {fe:.2e} {_cos(g, w):.4f} {_cos(gs, ws):.4f}')


if __name__ == '__main__':
    # the values the whole-step bounds above were set from; with
    # --mma-plain, the port's bf16 inter forward rounds where the
    # tensor-core kernel (and the TPU kernel) rounds (inter_conv_mma_plain);
    # --leaf-spread: SKIP_BIAS on clouds scaled by 1 + s (_leaf_spread);
    # --op-by-op: module by module against float64 (_op_by_op)
    import sys
    if '--leaf-spread' in sys.argv[1:]:
        _leaf_spread()
        sys.exit()
    if '--op-by-op' in sys.argv[1:]:
        _op_by_op()
        sys.exit()
    if '--mma-plain' in sys.argv[1:]:
        tkern.inter_conv.inter_conv_plain = _rounded_inter
    step = _bf16_step()
    print(f'loss: port {step["tloss"]:.6f}, JAX {step["jloss"]:.6f}, '
          f'relative {abs(step["tloss"] - step["jloss"]) / step["jloss"]:.2e}')
    print(f'running statistics: max relative error '
          f'{max(_stats_errors(step).values()):.2e}')
    print('leaf, cos port-f64, cos JAX-f64, cos port-JAX (degenerate: '
          'max|port|, max|JAX|)')
    for path, deg, c_t, c_j, c_tj, m_t, m_j in _leaf_report(step):
        print(f'  {path}: ' + (f'degenerate {m_t:.2e} {m_j:.2e}' if deg else
                              f'{c_t:.4f} {c_j:.4f} {c_tj:.4f}'))
    for dtype, cos in _rounding_sensitivity().items():
        print(f'{dtype} gradients, clouds x (1 + 1e-6): per-leaf cosine min '
              f'{min(cos.values()):.6f}, median {np.median(list(cos.values())):.6f}')
