"""The torch port's bf16 production-mode inv_so3net_pn path (3DMatch
descriptors and the triplet training step) against the JAX package on the
CPU.

Kernels: the bf16 W-off inter conv's plain versions (``inter_conv_f_plain``,
``inter_conv_dg_plain``) against the Pallas forms they replace in bf16 in
interpret mode, and ``InterConvFn``'s composed bf16 backward against
``jax.vjp`` of ``fused_gather_conv_w`` in bf16, whose ``_fgcw_bwd`` composes
at the same shapes. Blocks: one packed InstanceNorm separable block (strided,
stride 1, and layer 0's rank-1 skip), forward and gradients, and the
``InvOutBlockMVD`` head, against the JAX modules under the bf16 policy.
Model: the small inv model's bf16 descriptors against the jitted JAX bf16
forward, and one bf16 triplet step against the JAX package's bf16 step and a
float64 step by the noise-floor rule of ``tests/test_torch_port_bf16_train.py``.
App: ``Trainer3DMatch`` in bf16 (two steps, the checkpoint reloaded), the
trainers' params.json against the JAX builders', the JAX gates that send
every inv layer through the W-fused kernel in bf16 as in fp32, and the JAX
bf16 model's parameter tree through ``from_jax_variables``.

``python tests/test_torch_port_inv_bf16.py`` prints the values the bounds
were set from.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epn_pointcloud_tpu import compat as jcompat
from epn_pointcloud_tpu import losses as jlosses
from epn_pointcloud_tpu.app import config as jconfig
from epn_pointcloud_tpu.models import cls_so3net_pn as jcls
from epn_pointcloud_tpu.models import inv_so3net_pn as jinv
from epn_pointcloud_tpu.nn import blocks as jblocks
from epn_pointcloud_tpu.nn import heads as jheads
from epn_pointcloud_tpu.ops import so3conv as jso3
from epn_pointcloud_tpu.ops.pallas import inter_conv as jic

from epn_pointcloud_tpu_torch import compat as tcompat
from epn_pointcloud_tpu_torch import losses as tlosses
from epn_pointcloud_tpu_torch import models as tmodels
from epn_pointcloud_tpu_torch import run_3dmatch as trun
from epn_pointcloud_tpu_torch.app import config as tconfig
from epn_pointcloud_tpu_torch.app.trainer_3dmatch import Trainer3DMatch
from epn_pointcloud_tpu_torch.app.trainer_modelnet import TrainerModelNet
from epn_pointcloud_tpu_torch.data import synthetic as tsynth
from epn_pointcloud_tpu_torch.models import inv_so3net_pn as tinv
from epn_pointcloud_tpu_torch.nn import blocks as tblocks
from epn_pointcloud_tpu_torch.nn import heads as theads
from epn_pointcloud_tpu_torch.ops import kernels as tkern
from epn_pointcloud_tpu_torch.ops import so3conv as tso3
from epn_pointcloud_tpu_torch.ops.kernels import inter_conv as tic
from epn_pointcloud_tpu_torch.ops.so3conv import SphericalPointCloud

from test_torch_port_inv import (K_POINTS, SMALL_MLPS, _gate_opt, _jax_init,
                                 _patches, _tree_leaves, _woff_operands)

BF16 = torch.bfloat16


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32), np.float64)


def _normwise(got, want):
    got, want = _np(got), _np(want)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _cos(a, b):
    a, b = _np(a).ravel(), _np(b).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _row_cos(a, b):
    a, b = _np(a), _np(b)
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1)
                             * np.linalg.norm(b, axis=1))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


class _jax_bf16:
    """The JAX package's bf16 policy inside the block, fp32 after it."""

    def __enter__(self):
        jso3.set_compute_dtype('bf16')

    def __exit__(self, *exc):
        jso3.set_compute_dtype('fp32')


@pytest.fixture
def bf16_mode():
    tso3.set_compute_dtype('bf16')
    try:
        yield
    finally:
        tso3.set_compute_dtype('fp32')


# ---------------------------------------------------------- W-off kernels

# (N, C, Q) of tests/test_torch_port_inv.py: c = 32 at nn = 64 (tp = 2) and
# c = 64 at nn = 32 (tp = 4)
WOFF_SHAPES = [(64, 32, 45), (32, 64, 61)]


@pytest.mark.parametrize('N,C,Q', WOFF_SHAPES)
def test_inter_conv_f_plain_bf16_matches_pallas_forms(N, C, Q):
    """F of inter_conv_f_plain from a bf16 table (fp32 sums, rounded once to
    bf16) against both TPU forms in bf16 in interpret mode: the table form
    fused_gather_neighbor_conv -> _fwd_gather_kernel and the pre-gathered
    form fused_neighbor_conv -> _fwd_kernel (run by the port as a table of
    the gathered rows). Both round the anchor weights to bf16 before the
    product (``_conv_body:516``) and F once after it: normwise <= 1e-4 (0.0
    measured, bit for bit, at these shapes)."""
    B, P, AC = 2, 4, 3
    j, t, sigma, _ = _woff_operands(B, P, N, AC, C, Q, seed=N + C)
    jF = jic.fused_gather_neighbor_conv(
        j['gx8'], j['idx3'], j['tabp'].astype(jnp.bfloat16), j['rk8'], sigma,
        j['tp'], j['kt'], j['nt'], None, True)
    jF2 = jic.fused_neighbor_conv(
        j['gx8'], j['G'].astype(jnp.bfloat16), j['rk8'], sigma, j['tp'],
        j['kt'], j['nt'], None, 0, True)
    assert jF.dtype == jF2.dtype == jnp.bfloat16
    tF = tic.inter_conv_f_plain(t['gx'], t['idx'], t['tab'].to(BF16),
                                t['rk'], t['k2'], sigma)
    tF2 = tic.inter_conv_f_plain(t['gx'], t['ridx'], t['rows'].to(BF16),
                                 t['rk'], t['k2'], sigma)
    assert tF.dtype == tF2.dtype == BF16
    for want in (jF, jF2):
        want = np.transpose(_np(want), (0, 2, 1, 3, 4))
        for got in (tF, tF2):
            assert _normwise(got, want) <= 1e-4


@pytest.mark.parametrize('N,C,Q', WOFF_SHAPES)
def test_inter_conv_dg_plain_bf16_matches_pallas_vjp(N, C, Q):
    """dT of inter_conv_dg_plain from a bf16 dF (the anchor weights and
    each slot's sum rounded to bf16, the fold in fp32) against the VJP of
    both TPU forms in bf16 in interpret mode: _bwd_kernel's bf16 dG, and
    for the table form its fp32 one-hot fold rounded to bf16, against dT
    rounded to bf16 as InterConvFn rounds it: normwise <= 1e-4 (0.0
    measured, bit for bit, at these shapes; ~3e-3 while the weights were
    not rounded and dT was compared before its rounding)."""
    B, P, AC = 2, 4, 3
    j, t, sigma, _ = _woff_operands(B, P, N, AC, C, Q, seed=N + C + 1)
    ct = np.random.RandomState(C).randn(B, AC, P, K_POINTS, C).astype(
        np.float32)
    ctb = jnp.asarray(ct, jnp.bfloat16)
    _, vjp = jax.vjp(lambda tb: jic.fused_gather_neighbor_conv(
        j['gx8'], j['idx3'], tb, j['rk8'], sigma, j['tp'], j['kt'], j['nt'],
        None, True), j['tabp'].astype(jnp.bfloat16))
    jdT = _np(vjp(ctb)[0])[:, :Q]
    _, vjp2 = jax.vjp(lambda G: jic.fused_neighbor_conv(
        j['gx8'], G, j['rk8'], sigma, j['tp'], j['kt'], j['nt'], None, 0,
        True), j['G'].astype(jnp.bfloat16))
    jdG = _np(vjp2(ctb)[0]).reshape(B, P, j['nt'], AC * C)[:, :, :N]

    dF = _t(np.transpose(ct, (0, 2, 1, 3, 4)), BF16).contiguous()
    tdT = tic.inter_conv_dg_plain(t['gx'], t['idx'], Q, t['rk'], t['k2'], dF,
                                  sigma)
    tdG = tic.inter_conv_dg_plain(t['gx'], t['ridx'], P * N, t['rk'],
                                  t['k2'], dF, sigma)
    assert tdT.dtype == tdG.dtype == torch.float32
    # each pre-gathered row takes one slot: its dT is that slot's bf16 sum
    assert torch.equal(tdG, tdG.to(BF16).float())
    assert _normwise(tdT.to(BF16).reshape(jdT.shape), jdT) <= 1e-4
    assert _normwise(tdG.reshape(jdG.shape), jdG) <= 1e-4


@pytest.mark.parametrize('N,C,D', [(16, 32, 32), (64, 64, 64)])
def test_inter_conv_fn_bf16_composed_matches_pallas_grad(monkeypatch, N, C,
                                                         D):
    """dTable and dW of InterConvFn in bf16 at composed-route shapes (c <=
    32 at tp = 8; c = 64 at nn = 64, tp = 2) against jax.vjp of
    fused_gather_conv_w in bf16 in interpret mode, whose _fgcw_bwd composes
    there with bf16 F, dF and dG: normwise <= 8e-3 for both. The port's
    route is observed: inter_conv_dg and inter_conv_f, not the fused pair."""
    rng = np.random.RandomState(N + C)
    B, P, AC, Q, sigma = 2, 8, 3, 45, 0.1
    gx = (0.3 * rng.randn(B, P, N, 3)).astype(np.float32)
    tab = rng.randn(B, Q, AC * C).astype(np.float32)
    idx = rng.randint(0, Q, size=(B, P, N)).astype(np.int32)
    idx[:, :, ::3] = Q
    anch = rng.randn(AC, 3, 3).astype(np.float32)
    ker = (0.3 * rng.randn(K_POINTS, 3)).astype(np.float32)
    W = (0.1 * rng.randn(K_POINTS, C, D)).astype(np.float32)
    dout = rng.randn(B, P, AC * D).astype(np.float32)
    rk = jnp.einsum('aij,kj->aki', jnp.asarray(anch), jnp.asarray(ker))
    k2 = jnp.sum(jnp.asarray(ker) ** 2, -1)
    nt, tp, kt, _ = jic.plan(N, K_POINTS)
    assert tic.composed_backward(C, N) and (C <= 32 or tp <= 2)
    qp = -(-Q // 8) * 8
    tabp = jnp.pad(jnp.asarray(tab, jnp.bfloat16), ((0, 0), (0, qp - Q),
                                                    (0, 0)))
    _, vjp = jax.vjp(lambda tb, w2: jic.fused_gather_conv_w(
        jic.make_gx8(jnp.asarray(gx), nt), jnp.asarray(idx).reshape(
            B, 1, P * nt), tb, jic.make_rk8_kmajor(rk, k2, tp, kt, sigma),
        jic.make_rk8(rk, k2, tp, kt, sigma), w2, sigma, tp, kt, nt, None,
        True), tabp, jnp.asarray(W, jnp.bfloat16).reshape(K_POINTS * C, D))
    jdt, jdw = vjp(jnp.asarray(dout, jnp.bfloat16))

    seen = []
    for name in ('inter_conv_dg', 'inter_conv_f', 'inter_conv_dtable',
                 'inter_conv_dw'):
        def rec(*a, _f=getattr(tic, name), _n=name):
            seen.append(_n)
            return _f(*a)
        monkeypatch.setattr(tic, name, rec)
    t_tab = _t(tab, BF16).reshape(B, Q, AC, C).requires_grad_()
    t_W = _t(W, BF16).requires_grad_()
    out = tic.InterConvFn.apply(_t(gx), torch.from_numpy(idx), t_tab,
                                _t(np.array(rk)), _t(np.array(k2)), t_W,
                                sigma)
    out.backward(_t(dout, BF16).reshape(B, P, AC, D))
    assert sorted(seen) == ['inter_conv_dg', 'inter_conv_f']
    assert t_tab.grad.dtype == t_W.grad.dtype == BF16
    assert _normwise(t_tab.grad.reshape(B, Q, AC * C), _np(jdt)[:, :Q]) \
        <= 8e-3
    assert _normwise(t_W.grad.reshape(K_POINTS * C, D), jdw) <= 8e-3


def test_dw_product_sums_in_fp32():
    """The composed route's dW product from bf16 operands equals the
    float64 product of the same bf16 values to fp32 rounding (normwise <=
    1e-6): no bf16 partial sum anywhere, over 20000 rows."""
    rng = np.random.RandomState(4)
    F2 = _t(rng.randn(20000, 48), BF16)
    d2 = _t(rng.randn(20000, 32), BF16)
    got = tic.dw_product(F2, d2)
    assert got.dtype == torch.float32 and got.shape == (48, 32)
    want = F2.double().t() @ d2.double()
    assert _normwise(got, want) <= 1e-6


# ----------------------------------------------------------------- blocks

BLOCKS = {
    # (args, ones input): a strided layer whose inter conv composes (c =
    # 32, nn = 48), a stride-1 one on the fused route (c = 64, nn = 16), and
    # block 0 layer 0 (occupancy ones, rank-1 skip)
    'strided': (dict(dim_in=32, dim_out=64, stride=2, n_neighbor=48), False),
    'stride1': (dict(dim_in=64, dim_out=64, stride=1, n_neighbor=16), False),
    'rank1': (dict(dim_in=1, dim_out=32, stride=2, n_neighbor=16), True),
}
# the bounds of the block comparison (running this file prints the values):
# the bf16 outputs to a normwise 1e-2 (the bound of
# tests/test_torch_port_bf16.py's BatchNorm block), and every parameter's
# and the input's gradient to a cosine of BLOCK_COS with the JAX block's
BLOCK_COS = 0.99


def _block_args(spec):
    return dict(kernel_size=1, radius=0.35, sigma=0.06, lazy_sample=True,
                dropout_rate=0.0, multiplier=2, activation='leaky_relu',
                pooling=None, kanchor=60, **spec)


def _block_run(name):
    """One InstanceNorm SeparableSO3ConvBlock in bf16 on shared bf16 input
    and weights in both packages, the forward and the gradients of a seeded
    cotangent: (port output, JAX output, port and JAX gradients by the
    port's parameter names, port and JAX input gradients)."""
    spec, ones = BLOCKS[name]
    args = _block_args(spec)
    rng = np.random.RandomState(len(name))
    b, p, na, c = 2, 96, 60, args['dim_in']
    xyz = _patches(rng, b, p, radius=1.0)
    f = np.ones((b, p, na, 1), np.float32) if ones else _np(
        jnp.asarray(rng.randn(b, p, na, c), jnp.bfloat16)).astype(np.float32)
    p2 = p // args['stride']
    cot = rng.randn(b, p2, na, args['dim_out']).astype(np.float32)

    jblk = jblocks.SeparableSO3ConvBlock(args)
    jf = jnp.asarray(f, jnp.bfloat16)
    jf = jf if ones else jf.reshape(b, p, na * c)
    with _jax_bf16():
        params = jax.tree_util.tree_map(np.asarray, jblk.init(
            jax.random.PRNGKey(2), jso3.SphericalPointCloud(
                jnp.asarray(xyz), jf, None), train=True,
            ones_input=ones)['params'])

        def fwd(prm, feats):
            return jblk.apply({'params': prm}, jso3.SphericalPointCloud(
                jnp.asarray(xyz), feats, None), train=True,
                ones_input=ones)[3].feats
        jout, vjp = jax.vjp(fwd, params, jf)
        jdp, jdx = vjp(jnp.asarray(cot, jnp.bfloat16).reshape(jout.shape))

    tblk = tblocks.SeparableSO3ConvBlock(args).train()
    tblk.load_state_dict(tcompat.separable_block_state(params, {}))
    tx = _t(f, BF16).requires_grad_(not ones)
    tso3.set_compute_dtype('bf16')
    try:
        tout = tblk(SphericalPointCloud(_t(xyz), tx, None),
                    ones_input=ones).feats
        tout.backward(_t(cot, BF16))
    finally:
        tso3.set_compute_dtype('fp32')
    return dict(tout=tout, jout=jout.reshape(tout.shape),
                tgrads={n: q.grad for n, q in tblk.named_parameters()},
                jgrads=tcompat.separable_block_state(
                    jax.tree_util.tree_map(np.asarray, jdp), {}),
                tdx=tx.grad, jdx=jdx)


def _block_cosines(r):
    """Per gradient (every parameter, and the input where it has one), the
    cosine of the port's with the JAX block's and the two magnitudes."""
    out = {n: (_cos(g, r['jgrads'][n]), float(g.abs().max()),
               float(np.abs(_np(r['jgrads'][n])).max()))
           for n, g in r['tgrads'].items()}
    if r['tdx'] is not None:
        out['input'] = (_cos(r['tdx'], r['jdx']), float(r['tdx'].abs().max()),
                        float(np.abs(_np(r['jdx'])).max()))
    return out


@pytest.mark.parametrize('name', list(BLOCKS))
def test_instance_norm_block_bf16_matches_jax(name):
    """The packed InstanceNorm block (the inter norm deferred into the
    prenorm intra conv as a per-sample fold, the intra InstanceNorm, the
    skip through the grouped conv and the packed InstanceNorm, or layer 0's
    unpacked rank-1 skip; no fused tail) against the JAX block in bf16:
    output normwise <= 1e-2, every gradient at a cosine >= BLOCK_COS. The
    skip conv's bias feeds an InstanceNorm, which removes it, and layer 0's
    skip conv normalizes a constant field: those gradients are zero but for
    rounding noise in both packages, and the port's is held to the JAX
    block's magnitude (at most twice it, plus 1e-2)."""
    r = _block_run(name)
    assert r['tout'].dtype == BF16 and torch.isfinite(r['tout']).all()
    assert _normwise(r['tout'], r['jout']) <= 1e-2
    for n, (cos, mt, mj) in _block_cosines(r).items():
        if n == 'skip_conv.bias' or (name == 'rank1'
                                     and n.startswith('skip_conv')):
            assert mt <= 2 * mj + 1e-2, (n, mt, mj)
        else:
            assert cos >= BLOCK_COS, (n, cos)
    assert (r['tdx'] is None) == BLOCKS[name][1]


def test_instance_norm_fold_is_per_sample(bf16_mode):
    """InstanceNorm.scale_shift takes BatchNorm's call (groups, x) and folds
    each sample on its own: [b, 2, 60 c] fp32, row b from sample b alone."""
    rng = np.random.RandomState(6)
    x = _t(rng.randn(3, 20, 60, 8), BF16)
    norm = tblocks.InstanceNorm()
    ss = norm.scale_shift(60, x)
    assert ss.shape == (3, 2, 480) and ss.dtype == torch.float32
    torch.testing.assert_close(ss[1:2], norm.scale_shift(60, x[1:2]))


# ------------------------------------------------------------------ head

def test_inv_out_block_bf16_matches_jax(bf16_mode):
    """InvOutBlockMVD on bf16 features against the JAX head under the bf16
    policy: the attention bf16 (1x1 convs with fp32 accumulation, softmax
    and the weighted sum in bf16) to a normwise 8e-3; the PointNet and the
    L2 normalization in fp32 (the concat with the fp32 coordinates
    promotes, in both packages), the descriptors to a per-row cosine >=
    0.9999 and the input gradient of a seeded cotangent to a cosine >=
    0.999."""
    rng = np.random.RandomState(8)
    b, p, na, c, out = 2, 64, 60, 32, 16
    prm = {'dim_in': c, 'mlp': [64, out], 'pooling': 'attention',
           'temperature': 3.0, 'kanchor': na}
    xyz = _patches(rng, b, p)
    f = _np(jnp.asarray(rng.randn(b, p, na * c), jnp.bfloat16))
    cot = rng.randn(b, out).astype(np.float32)
    jhead = jheads.InvOutBlockMVD(prm)
    with _jax_bf16():
        params = jax.tree_util.tree_map(np.asarray, jhead.init(
            jax.random.PRNGKey(1), jso3.SphericalPointCloud(
                jnp.asarray(xyz), jnp.asarray(f, jnp.bfloat16), None))[
                    'params'])
        (jy, ja), vjp = jax.vjp(lambda x: jhead.apply(
            {'params': params}, jso3.SphericalPointCloud(
                jnp.asarray(xyz), x, None)), jnp.asarray(f, jnp.bfloat16))
        jdx = vjp((jnp.asarray(cot), jnp.zeros(ja.shape, ja.dtype)))[0]
    assert jy.dtype == jnp.float32 and ja.dtype == jnp.bfloat16

    sd = {}
    tcompat._dense(sd, 'attention_layer.0', params['Dense1x1_0'])
    tcompat._dense(sd, 'attention_layer.2', params['Dense1x1_1'])
    tcompat._dense(sd, 'pointnet.embed',
                   params['PointnetSO3Conv_0']['Dense1x1_0'])
    thead = theads.InvOutBlockMVD(prm)
    thead.load_state_dict(sd)
    tx = _t(f, BF16).reshape(b, p, na, c).requires_grad_()
    ty, ta = thead(SphericalPointCloud(_t(xyz), tx, None))
    (ty * _t(cot)).sum().backward()
    assert ty.dtype == torch.float32 and ta.dtype == BF16
    assert _normwise(ta, _np(ja)) <= 8e-3
    assert _row_cos(ty, jy).min() >= 0.9999
    np.testing.assert_allclose(ty.detach().norm(dim=1).numpy(), 1.0,
                               rtol=1e-5)
    assert tx.grad.dtype == BF16
    assert _cos(tx.grad.reshape(b, p, -1), jdx) >= 0.999


# ----------------------------------------------------------------- model

def _inv_bf16_step():
    """The small inv model (mlps ((32, 32), (64, 64)): the composed route at
    B0L1 and B1L0, the fused one at B1L1) in both packages on shared
    weights, and one bf16 triplet step of each on two legs of b = 2
    patches: the JAX step jitted (eager JAX puts rounding noise of the
    constant-field skip into the gradients: tests/test_torch_port_inv.py),
    its descriptors as the step's aux; the port's step and its descriptors
    (train and eval forward are one for this model: no BatchNorm, no
    dropout); and the float64 gradients of the port's plain path (the
    exact-arithmetic stand-in, which also marks the degenerate leaves)."""
    opt = _gate_opt('inv_so3net_pn')
    jmodel = jinv.build_model(opt, mlps=SMALL_MLPS)
    init = _jax_init(jmodel)
    tmodel = tinv.build_model(opt, mlps=SMALL_MLPS, seed=None)
    tmodel.load_state_dict(tcompat.from_jax_variables(init))
    rng = np.random.RandomState(17)
    src, tgt = _patches(rng, 2), _patches(rng, 2)

    def loss_fn(params):
        v = {'params': params}
        ys, _ = jmodel.apply(v, jnp.asarray(src), train=True)
        yt, _ = jmodel.apply(v, jnp.asarray(tgt), train=True)
        return (jlosses.triplet_batch_loss(ys, yt, 'soft', 1.0)[0],
                jnp.concatenate([ys, yt]))
    with _jax_bf16():
        (jloss, jy), jgrads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(init['params'])

    def port_step(model, dtype, plain=False):
        model.train()
        model.zero_grad()
        tso3.set_compute_dtype(dtype)
        try:
            with tkern.plain() if plain else torch.enable_grad():
                ys, ya = model(_t(src, next(model.parameters()).dtype))
                yt, _ = model(_t(tgt, ys.dtype))
                loss = tlosses.triplet_batch_loss(ys, yt, 'soft', 1.0)[0]
                loss.backward()
        finally:
            tso3.set_compute_dtype('fp32')
        grads = {n: q.grad.detach().float() for n, q in
                 model.named_parameters()}
        return (loss.item(), torch.cat([ys, yt]).detach(), ya.detach(),
                jcompat.import_state_dict(init, grads)['params'])
    tloss, ty, ta, tgrads = port_step(tmodel, 'bf16')
    m64 = copy.deepcopy(tmodel).double()
    _, y64, _, g64 = port_step(m64, 'fp32', plain=True)
    return dict(init=init, tmodel=tmodel, jloss=float(jloss), jy=jy,
                jgrads=jgrads, tloss=tloss, ty=ty, ta=ta, tgrads=tgrads,
                y64=y64, g64=g64)


@pytest.fixture(scope='module')
def inv_bf16_step():
    return _inv_bf16_step()


def test_inv_bf16_descriptors_match_jax(inv_bf16_step):
    """bf16 descriptors [4, 64] against the jitted JAX bf16 forward on the
    same weights: fp32 of unit length, per-patch cosine >= 0.9999 with the
    JAX package's and >= 0.999 with the float64 forward's; the attention
    in bf16."""
    s = inv_bf16_step
    assert s['ty'].shape == (4, 64) and s['ty'].dtype == torch.float32
    assert s['ta'].dtype == BF16
    np.testing.assert_allclose(s['ty'].norm(dim=1).numpy(), 1.0, rtol=1e-5)
    assert _row_cos(s['ty'], s['jy']).min() >= 0.9999
    assert _row_cos(s['ty'], s['y64']).min() >= 0.999


# a leaf whose float64 gradient is below this is mathematically zero (block
# 0's skip conv: an InstanceNorm over a constant field)
DEGENERATE_F64 = 1e-5
# what such a leaf may hold in the port: rounding noise amplified by the
# norm's 1/sqrt(eps), at most twice the JAX package's plus this floor
DEGENERATE_ABS = 1e-2
# per-leaf cosine bounds of a real gradient, the rule of
# tests/test_torch_port_bf16_train.py with this model's bounds (running
# this file prints the values: >= 0.989 to float64, >= 0.987 to JAX): the
# port's bf16 gradient to the float64 one >= COS_F64 and no farther from it
# than the JAX package's bf16 gradient less COS_MARGIN; to the JAX bf16
# step's >= COS_JAX
COS_F64 = 0.97
COS_MARGIN = 0.02
COS_JAX = 0.97


def _leaf_report(s):
    """(path, degenerate, cos port-f64, cos JAX-f64, cos port-JAX, max|port|,
    max|JAX|) for every gradient leaf of the step."""
    got, want = _tree_leaves(s['tgrads']), _tree_leaves(s['jgrads'])
    exact = dict(_tree_leaves(s['g64']))
    assert [p for p, _ in got] == [p for p, _ in want] == list(exact)
    rows = []
    for (path, g), (_, w) in zip(got, want):
        deg = bool(np.abs(_np(exact[path])).max() <= DEGENERATE_F64)
        cos = (None, None, None) if deg else (
            _cos(g, exact[path]), _cos(w, exact[path]), _cos(g, w))
        rows.append((path, deg) + cos + (np.abs(_np(g)).max(),
                                         np.abs(_np(w)).max()))
    return rows


def test_inv_bf16_triplet_step_matches_jax(inv_bf16_step):
    """The loss within rtol 5e-3 of the JAX bf16 step's; every leaf with a
    real gradient by the rule above; the degenerate leaves (from the
    float64 pass, not listed by hand) no noisier than the JAX package's;
    parameters and gradients fp32."""
    s = inv_bf16_step
    np.testing.assert_allclose(s['tloss'], s['jloss'], rtol=5e-3)
    rows = _leaf_report(s)
    assert any(r[1] for r in rows), 'expected the block-0 skip conv'
    for path, deg, c_t, c_j, c_tj, m_t, m_j in rows:
        if deg:
            assert m_t <= 2 * m_j + DEGENERATE_ABS, (path, m_t, m_j)
            continue
        assert c_t >= COS_F64 and c_t >= c_j - COS_MARGIN, (path, c_t, c_j)
        assert c_tj >= COS_JAX, (path, c_tj)
    assert all(q.dtype == torch.float32 and q.grad.dtype == torch.float32
               for q in s['tmodel'].parameters())


def test_from_jax_variables_takes_the_bf16_inv_tree():
    """The JAX inv model initialized under the bf16 policy has the fp32
    model's tree, leaf for leaf in shape and dtype (parameters stay fp32),
    so the port loads it unchanged (strict)."""
    opt = _gate_opt('inv_so3net_pn')
    jmodel = jinv.build_model(opt, mlps=SMALL_MLPS)
    x0 = jnp.zeros((2, 1024, 3), jnp.float32)
    shapes = {}
    for dtype in ('fp32', 'bf16'):
        jso3.set_compute_dtype(dtype)
        try:
            shapes[dtype] = jax.eval_shape(lambda: jmodel.init(
                jax.random.PRNGKey(0), x0, train=False))
        finally:
            jso3.set_compute_dtype('fp32')
    leaves = {k: [(p, v.shape, v.dtype) for p, v in
                  jax.tree_util.tree_flatten_with_path(t)[0]]
              for k, t in shapes.items()}
    assert leaves['bf16'] == leaves['fp32']
    assert all(dt == jnp.float32 for _, _, dt in leaves['bf16'])
    zeros = jax.tree_util.tree_map(
        lambda v: np.zeros(v.shape, np.float32), dict(shapes['bf16']))
    tinv.build_model(opt, mlps=SMALL_MLPS, seed=None).load_state_dict(
        tcompat.from_jax_variables(zeros), strict=True)


def test_jax_gates_fuse_every_inv_layer_in_bf16():
    """At every inv layer with a feature table, the JAX package's gates of
    the W-fused forward (plic.gather_fusable, plic.gather_w_fusable,
    ops/so3conv.py:487-525) hold at itemsize 2 as at 4: its bf16 forward
    runs fused_gather_conv_w at all seven, as the port's InterConvFn does,
    and no layer falls back to the gathered F and an XLA product."""
    params = jinv.build_model(_gate_opt('inv_so3net_pn')).params
    p1, na = 1024, 60
    seen = []
    for bi, block in enumerate(params['backbone']):
        for li, layer in enumerate(block):
            a = layer['args']
            c, d, nn = a['dim_in'], a['dim_out'], a['n_neighbor']
            p2 = -(-p1 // a['stride'])
            if c > 1:
                chunk = jso3.auto_anchor_chunk(na, c, nn)
                nt, tp, kt, _ = jic.plan(nn, K_POINTS)
                qp = -(-p1 // 8) * 8
                for itemsize in (4, 2):
                    assert jic.gather_fusable(p1 + 1, chunk, c, itemsize)
                    assert jic.gather_w_fusable(p2, qp, chunk, c, d, kt, nt,
                                                tp, itemsize)
                seen.append(f'B{bi}L{li}')
            p1 = p2
    assert seen == ['B0L1', 'B1L0', 'B1L1', 'B2L0', 'B2L1', 'B3L0', 'B3L1']


# ------------------------------------------------------------------- app

def _small_inv_builder(monkeypatch):
    monkeypatch.setattr(tmodels, 'build_model_from',
                        lambda opt, seed, outfile_path=None: (
                            tinv.build_model(opt, mlps=SMALL_MLPS, seed=seed,
                                             to_file=outfile_path)))


def test_trainer_3dmatch_bf16_trains_and_reloads(tmp_path, monkeypatch):
    """Trainer3DMatch with --compute-dtype bf16 on the CPU at npt 2, the
    small inv model in place of the full-width one (the card runs that:
    chip_smoke.py's [inv-bf16-train-entry]): two steps with finite logged
    losses, fp32 parameters with finite gradients, params.json written;
    the checkpoint reloads through -r in bf16 to the same weights and the
    same bf16 descriptors."""
    _small_inv_builder(monkeypatch)
    root = str(tmp_path / 'data')
    tsynth.make_3dmatch_tree(root, n_frags=2, n_points=2000, n_kpts=8,
                             seed=1)

    def opt_for(extra=()):
        opt = trun.config_opt_3dmatch(tconfig.parse_args(
            ['experiment', '-d', root, '--model-dir', str(tmp_path / 'runs'),
             '-lf', '1', '--compute-dtype', 'bf16'] + list(extra)))
        opt.npt, opt.num_iterations, opt.save_freq = 2, 2, 2
        return opt
    try:
        trainer = Trainer3DMatch(opt_for(), device='cpu')
        assert tso3.packed_enabled()
        trainer.train()
        trainer.logger.close()
        other = Trainer3DMatch(opt_for(['-r', trainer.last_ckpt]),
                               device='cpu')
        other.logger.close()
        x = torch.from_numpy(_patches(np.random.RandomState(2), 2))
        with torch.no_grad():
            ya, yb = trainer.model(x)[0], other.model(x)[0]
    finally:
        tso3.set_compute_dtype('fp32')
    stats = trainer.summary.running_stats
    assert trainer.summary.counters['Loss'] == 2
    assert all(np.isfinite(stats[k]) for k in ('Loss', 'Pos', 'Neg', 'Acc'))
    assert all(q.dtype == torch.float32 and q.grad is not None
               and torch.isfinite(q.grad).all()
               for q in trainer.model.parameters())
    assert os.path.exists(os.path.join(trainer.root_dir, 'params.json'))
    for (k, a), (_, b) in zip(trainer.model.state_dict().items(),
                              other.model.state_dict().items()):
        assert torch.equal(a, b), k
    assert ya.dtype == torch.float32 and torch.equal(ya, yb)


class _Stub:
    """What a trainer's ``_setup_model`` reads of the trainer."""

    def __init__(self, opt, root_dir):
        self.opt, self.root_dir, self.device = opt, root_dir, 'cpu'


@pytest.mark.parametrize('model', ['cls_so3net_pn', 'inv_so3net_pn'])
def test_trainers_write_the_jax_params_json(tmp_path, model):
    """params.json of the port's trainers (Trainer3DMatch always,
    TrainerModelNet in train mode only, as the JAX trainers) parses equal
    to what the JAX builder writes for the same options."""
    argv = ['experiment', '-d', str(tmp_path), '--model-dir',
            str(tmp_path / 'runs')]
    if model == 'inv_so3net_pn':
        opts = [trun.config_opt_3dmatch(tconfig.parse_args(argv))]
        jopt = trun.config_opt_3dmatch(jconfig.parse_args(argv))
        setups = [Trainer3DMatch._setup_model]
        jbuild = jinv.build_model_from
    else:
        opts = [tconfig.parse_args(argv) for _ in range(2)]
        opts[1].mode = 'eval'
        jopt = jconfig.parse_args(argv)
        setups = [TrainerModelNet._setup_model] * 2
        jbuild = jcls.build_model_from
    for o in opts + [jopt]:
        o.model.model, o.model.flag = model, 'attention'
    written = []
    for i, (opt, setup) in enumerate(zip(opts, setups)):
        run = tmp_path / f'port{i}'
        run.mkdir()
        setup(_Stub(opt, str(run)))
        written.append((run / 'params.json').exists())
    jbuild(jopt, str(tmp_path / 'jax.json'))
    want = json.loads((tmp_path / 'jax.json').read_text())
    assert written == [True] + [False] * (len(opts) - 1)
    assert json.loads((tmp_path / 'port0' / 'params.json').read_text()) \
        == want


# ------------------------------------------- measured values, as a script

def _print_measured():
    """The values the bounds above were set from."""
    for name in BLOCKS:
        r = _block_run(name)
        cos = _block_cosines(r)
        print(f'block {name}: output normwise '
              f'{_normwise(r["tout"], r["jout"]):.2e}; gradient cosines '
              + ', '.join(f'{n} {c:.5f} (|port| {mt:.1e}, |jax| {mj:.1e})'
                          for n, (c, mt, mj) in cos.items()))
    s = _inv_bf16_step()
    print(f'step: loss port {s["tloss"]:.6f} jax {s["jloss"]:.6f}; '
          f'descriptor cosine port-jax min '
          f'{_row_cos(s["ty"], s["jy"]).min():.7f}, port-f64 min '
          f'{_row_cos(s["ty"], s["y64"]).min():.7f}')
    print('leaf, cos port-f64, cos JAX-f64, cos port-JAX (degenerate: '
          'max|port|, max|JAX|)')
    for path, deg, c_t, c_j, c_tj, m_t, m_j in _leaf_report(s):
        print(f'  {path}: ' + (f'degenerate {m_t:.2e} {m_j:.2e}' if deg else
                               f'{c_t:.5f} {c_j:.5f} {c_tj:.5f}'))


if __name__ == '__main__':
    _print_measured()
