"""The model surface no builder of the torch port (epn_pointcloud_tpu_torch)
reached before, against the JAX package on the CPU: every elementwise
activation of jax.nn, the ReLU in the kernels that apply an activation
(the prenorm intra conv, its backward and the fused separable tail, whose
plain versions take the slope 0 where the JAX Pallas kernels take
act='relu', run in interpret mode), the separable block at one anchor,
``intra_block`` layers, and a guard that every builder names its
activation (the blocks now default to JAX's ReLU). The heads, the
propagation modules and the host data: tests/test_torch_port_heads.py.

Weights cross by ``from_jax_variables``; fp32 outputs are held at the
port's fp32 module tolerance (rtol 1e-5, atol 1e-5, as
tests/test_torch_port_convs.py), the kernels' plain versions at the bounds
of tests/test_torch_port_bf16.py and tests/test_torch_port_bf16_train.py.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epn_pointcloud_tpu.app import config as jconfig
from epn_pointcloud_tpu.nn import blocks as jblocks
from epn_pointcloud_tpu.nn import layers as jlayers
from epn_pointcloud_tpu.ops import so3conv as jso3
from epn_pointcloud_tpu.ops.pallas import grouped_conv as jgc
from epn_pointcloud_tpu.ops.pallas import intra_conv as jintra

from epn_pointcloud_tpu_torch import compat as tcompat
from epn_pointcloud_tpu_torch.models import cls_so3net_pn as tcls
from epn_pointcloud_tpu_torch.models import inv_so3net_pn as tinv
from epn_pointcloud_tpu_torch.models import reg_so3net as treg
from epn_pointcloud_tpu_torch.nn import blocks as tblocks
from epn_pointcloud_tpu_torch.nn import layers as tlayers
from epn_pointcloud_tpu_torch.ops import kernels as tkern
from epn_pointcloud_tpu_torch.ops import so3conv as tso3
from epn_pointcloud_tpu_torch.ops.so3conv import SphericalPointCloud

B, P, A, C = 2, 16, 60, 8
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32), np.float64)


def _normwise(got, want):
    got, want = _np(got), _np(want)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _t(a, dtype=torch.float32, grad=False):
    t = torch.from_numpy(np.array(a, np.float32)).to(dtype)
    return t.requires_grad_() if grad else t


def _spc(a=A, c=C, p=P, seed=0):
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(-1, 1, (B, p, 3)).astype(np.float32)
    feats = rng.randn(B, p, a, c).astype(np.float32)
    return xyz, feats


# ------------------------------------------------------------ activations

EDGES = np.array([-7, -6, -3.5, -3, -2, -1, -0.5, 0, 0, 0.5, 1, 2, 3, 3.5,
                  6, 7, 25], np.float32)


@pytest.mark.parametrize('name', sorted(tlayers.ACTIVATIONS))
def test_activation_matches_jax_values_and_gradients(name):
    """Each elementwise jax.nn activation by name (``get_activation``), at
    its kinks and at exact zeros, values and gradients to 1e-5 (log1mexp
    on positive values, where it is defined)."""
    rng = np.random.RandomState(1)
    x = np.concatenate([EDGES, rng.randn(32).astype(np.float32) * 3])
    if name == 'log1mexp':
        x = np.abs(x) + 0.1
    jf = jlayers.get_activation(name)
    want = np.asarray(jf(jnp.asarray(x)))
    wgrad = np.asarray(jax.vmap(jax.grad(jf))(jnp.asarray(x)))
    t = _t(x, grad=True)
    got = tlayers.get_activation(name)(t)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    np.testing.assert_allclose(t.grad.numpy(), wgrad, **TOL)


def test_activation_names_that_are_no_activation():
    """None and 'none' give no activation, as in JAX; the names of jax.nn
    that are no elementwise activation are refused on purpose; any other
    name raises, as JAX's getattr(jax.nn, name) does; leaky_relu keeps the
    torch subgradient (the slope at 0)."""
    assert tlayers.get_activation(None) is None
    assert tlayers.get_activation('none') is None
    for name in ('softmax', 'log_softmax', 'glu', 'standardize', 'one_hot',
                 'logsumexp'):
        assert hasattr(jax.nn, name)
        with pytest.raises(NotImplementedError, match='elementwise'):
            tlayers.get_activation(name)
    with pytest.raises(AttributeError):
        jlayers.get_activation('swoosh')
    with pytest.raises(AttributeError):
        tlayers.get_activation('swoosh')
    t = torch.zeros(3, requires_grad=True)
    tlayers.get_activation('leaky_relu')(t).sum().backward()
    assert torch.equal(t.grad, torch.full((3,), 0.01))
    assert set(tlayers.ACTIVATIONS) | set(tlayers.REFUSED_ACTIVATIONS) \
        | {'leaky_relu'} >= {n for n in dir(jax.nn) if not n.startswith('_')}


# ------------------------------------------------ the slope in the kernels

def _adjacency(na=8, nk=3):
    """The small balanced adjacency of tests/test_pallas_intra_conv.py (the
    60 x 12 group takes minutes in interpret mode)."""
    ti = np.stack([(np.arange(na) + k) % na for k in range(nk)], axis=1)
    inv = np.stack([(np.arange(na) - k) % na for k in range(nk)], axis=1)
    return ti, inv, tuple(map(tuple, ti.tolist()))


def _prenorm_operands(sb=2, seed=2):
    rng = np.random.RandomState(seed)
    na, nk, b, p, c, d = 8, 3, 2, 8, 16, 32
    f = rng.randn(b, p, na * c).astype(np.float32)
    W = (rng.randn(nk, c, d) * 0.1).astype(np.float32)
    ss = np.zeros((sb, 8, na * c), np.float32)
    ss[:, 0] = rng.rand(sb, na * c) + 0.5
    ss[:, 1] = rng.randn(sb, na * c) * 0.3
    dout = rng.randn(b, p, na * d).astype(np.float32)
    return na, nk, b, p, c, d, f, W, ss, dout


@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
def test_relu_prenorm_forward_matches_pallas_kernel(dtype):
    """intra(relu(f * scale + shift)): the plain prenorm intra conv at slope
    0 against intra_conv_prenorm(act='relu') in interpret mode, fp32 at
    rtol = atol = 1e-5, bf16 at a normwise 4e-3 (the bounds of
    tests/test_torch_port_bf16.py); at the leaky slope it differs."""
    na, nk, b, p, c, d, f, W, ss, _ = _prenorm_operands()
    ti, _, tit = _adjacency(na, nk)
    jdt = jnp.float32 if dtype == 'fp32' else jnp.bfloat16
    tdt = torch.float32 if dtype == 'fp32' else torch.bfloat16
    w2 = np.transpose(W, (1, 0, 2)).reshape(c, nk * d)
    want = jintra.intra_conv_prenorm(jnp.asarray(f, jdt), jnp.asarray(ss),
                                     jnp.asarray(w2, jdt), tit, 'relu', 0.01,
                                     8, True)
    args = (_t(f, tdt).reshape(b, p, na, c), _t(ss[:, :2]),
            torch.from_numpy(ti.astype(np.int32)), _t(W, tdt))
    got = tkern.intra_conv.intra_conv_prenorm(*args, 0.0)
    leaky = tkern.intra_conv.intra_conv_prenorm(*args)
    assert got.dtype == tdt
    got = got.reshape(b, p, na * d)
    if dtype == 'fp32':
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
    else:
        assert _normwise(got, want) <= 4e-3
    assert _normwise(leaky.reshape(b, p, na * d), want) > 1e-3


@pytest.mark.parametrize('sb', [1, 2])
def test_relu_prenorm_backward_matches_pallas_vjp(sb):
    """df, dss and dW of IntraConvPrenormFn at slope 0 (B6's plain
    versions) against jax.vjp of intra_conv_prenorm(act='relu') in
    interpret mode, normwise 1e-5 (the fp32 bound of
    tests/test_torch_port_bf16_train.py); exact zeros of u take the
    ReLU's zero gradient."""
    na, nk, b, p, c, d, f, W, ss, dout = _prenorm_operands(sb, seed=20 + sb)
    f[0, 0, :4] = 0.0
    ss[:, 1, :4] = 0.0                                  # u == 0 exactly
    ti, inv, tit = _adjacency(na, nk)

    def fwd(f_, s_, w_):
        s_ = jnp.broadcast_to(s_, (b, 8, na * c))
        return jintra.intra_conv_prenorm(f_, s_, w_, tit, 'relu', 0.01, 8,
                                         True)
    w2 = jnp.asarray(np.transpose(W, (1, 0, 2)).reshape(c, nk * d))
    _, vjp = jax.vjp(fwd, jnp.asarray(f), jnp.asarray(ss), w2)
    jdf, jdss, jdw2 = vjp(jnp.asarray(dout))
    jdw = np.asarray(jdw2).reshape(c, nk, d).transpose(1, 0, 2)
    tf, tss, tW = _t(f, grad=True), _t(ss[:, :2], grad=True), _t(W, grad=True)
    out = tkern.intra_conv.IntraConvPrenormFn.apply(
        tf.reshape(b, p, na, c), tss, torch.from_numpy(ti.astype(np.int32)),
        torch.from_numpy(inv.astype(np.int32)), tW, 0.0)
    out.backward(_t(dout).reshape(b, p, na, d))
    assert _normwise(tf.grad, jdf) <= 1e-5
    assert _normwise(tss.grad, np.asarray(jdss)[:, :2]) <= 1e-5
    assert _normwise(tW.grad, jdw) <= 1e-5


@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
def test_relu_tail_matches_pallas_kernel(dtype):
    """The fused separable tail at slope 0 against
    grouped_conv1x1_skip_epilogue(act='relu') in interpret mode: fp32 at
    rtol = atol = 1e-5, bf16 at a normwise 4e-3."""
    rng = np.random.RandomState(3)
    na, b, p, c, d = 8, 2, 4, 16, 16
    x = rng.randn(b, p, na * c).astype(np.float32)
    w = (rng.randn(c, d) * 0.2).astype(np.float32)
    bias = rng.randn(d).astype(np.float32)
    y = rng.randn(b, p, na * d).astype(np.float32)

    def mk_ss(nb):
        ss = np.zeros((nb, 8, na * d), np.float32)
        ss[:, 0] = rng.rand(nb, na * d) + 0.5
        ss[:, 1] = rng.randn(nb, na * d)
        return ss
    ssk, ssm = mk_ss(1), mk_ss(b)
    jdt = jnp.float32 if dtype == 'fp32' else jnp.bfloat16
    tdt = torch.float32 if dtype == 'fp32' else torch.bfloat16
    want = jgc.grouped_conv1x1_skip_epilogue(
        jnp.asarray(x, jdt), jnp.asarray(w, jdt), jnp.asarray(bias),
        jnp.asarray(ssk), jnp.asarray(y, jdt), jnp.asarray(ssm), na,
        act='relu', interpret=True)
    got = tkern.grouped_conv.grouped_conv_tail(
        _t(x, tdt).reshape(b, p, na, c), _t(w, tdt), _t(bias),
        _t(ssk[:, :2]), _t(y, tdt).reshape(b, p, na, d), _t(ssm[:, :2]), 0.0)
    got = got.reshape(b, p, na * d)
    if dtype == 'fp32':
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
    else:
        assert _normwise(got, want) <= 4e-3


def test_relu_separable_block_defers_into_the_kernels(monkeypatch):
    """A ReLU separable block in bf16: its inter norm goes into the prenorm
    intra conv (and its backward), its eval tail into the fused kernel,
    each called with the slope 0 as its last argument, on the plain path
    (the plain versions) and on the kernel path (the wrappers, through
    IntraConvPrenormFn); the leaky block's calls carry its slope 0.01 the
    same way; an elu block defers nothing."""
    seen = []
    for name in ('intra_conv_prenorm_plain', 'grouped_conv_tail_plain',
                 'intra_conv_prenorm', 'intra_conv_prenorm_df',
                 'intra_conv_prenorm_dw', 'grouped_conv_tail'):
        mod = tkern.intra_conv if 'intra' in name else tkern.grouped_conv
        orig = getattr(mod, name)

        def rec(*args, _orig=orig, _name=name):
            seen.append((_name, args[-1] if isinstance(args[-1], float)
                         else None))
            return _orig(*args)
        monkeypatch.setattr(mod, name, rec)
    xyz, feats = _spc(c=16, p=32)
    args = dict(dim_in=16, dim_out=16, kernel_size=1, stride=1, radius=0.6,
                sigma=0.1, n_neighbor=8, kanchor=60, norm='BatchNorm2d',
                dropout_rate=0.0, lazy_sample=True)
    x = SphericalPointCloud(_t(xyz), _t(feats, torch.bfloat16), None)
    tso3.set_compute_dtype('bf16')
    try:
        for act, want in (('relu', 0.0), ('leaky_relu', 0.01), ('elu', 'x')):
            blk = tblocks.SeparableSO3ConvBlock(dict(args, activation=act))
            tlayers.init_parameters(blk, torch.Generator().manual_seed(0))
            runs = []
            seen.clear()
            with torch.no_grad(), tkern.plain():
                runs.append(blk.eval()(x).feats)
            runs.append(list(seen))
            seen.clear()
            with torch.no_grad():
                blk.eval()(x)
            runs.append(list(seen))
            seen.clear()
            blk.train()(x).feats.float().sum().backward()
            runs.append(list(seen))
            assert torch.isfinite(runs[0].float()).all()
            if want == 'x':
                assert runs[1:] == [[], [], []], act
                continue
            assert runs[1] == [('intra_conv_prenorm_plain', want),
                               ('grouped_conv_tail_plain', want)], act
            assert runs[2][0] == ('intra_conv_prenorm', want), act
            assert ('grouped_conv_tail', want) in runs[2], act
            assert [c for c in runs[3] if not c[0].endswith('_plain')] == [
                ('intra_conv_prenorm', want), ('intra_conv_prenorm_df', want),
                ('intra_conv_prenorm_dw', want)], act
    finally:
        tso3.set_compute_dtype('fp32')


def test_relu_cls_model_matches_jax():
    """cls_so3net_pn with every block's activation set to 'relu' (the tree
    from build_model, the JAX model built from the same tree): fp32 logits
    at the cls parity tolerance (tests/test_torch_port_model.py)."""
    from epn_pointcloud_tpu.models import cls_so3net_pn as jcls
    opt = jconfig.default_opt()
    opt.model.model, opt.model.flag = 'cls_so3net_pn', 'attention'
    opt.model.input_num = 64
    tm = tcls.build_model(opt, mlps=((8,), (8,)), out_mlps=(8,))
    params = json.loads(json.dumps(tm.params))
    for block in params['backbone']:
        for layer in block:
            layer['args']['activation'] = 'relu'
    tm = tcls.ClsSO3ConvModel(params, seed=3).eval()
    jm = jcls.ClsSO3ConvModel(params)
    x = np.random.RandomState(4).uniform(-1, 1, (2, 64, 3)).astype(np.float32)
    v = jax.jit(lambda xx: jm.init(jax.random.PRNGKey(1), xx,
                                   train=False))(jnp.asarray(x))
    v = jax.tree_util.tree_map(np.asarray, v)
    tm.load_state_dict(tcompat.from_jax_variables(v))
    jl, _ = jm.apply(v, jnp.asarray(x), train=False)
    with torch.no_grad():
        tl, _ = tm(torch.from_numpy(x))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-3,
                               atol=2e-3)


def test_builders_name_their_activation():
    """Regression guard for the blocks' JAX defaults (ReLU): every layer of
    every builder's tree names its activation, the leaky ReLU, so no model
    changes with the defaults; the defaults are JAX's."""
    opt = jconfig.default_opt()
    opt.model.input_num = 64
    trees = [tcls.build_model(opt).params, tinv.build_model(opt).params,
             treg.build_model(opt).params]
    opt.model.kanchor = 20
    trees += [tcls.build_model(opt).params, tinv.build_model(opt).params]
    for tree in trees:
        for block in tree['backbone']:
            for layer in block:
                assert layer['args']['activation'] == 'leaky_relu', layer
    blk = tblocks.InterSO3ConvBlock(4, 8, 1, 1, 0.4, 0.1, 8)
    assert blk.act is torch.relu and blk.conv.pooling is None
    assert tblocks.IntraSO3ConvBlock(8, 8).act is torch.relu


# ------------------------------------------------ one anchor, intra_block

def _block_pair(jmod, tmod, x, state):
    """(JAX output, port output) of a block on ``x`` (xyz, feats), the port
    holding the JAX init through ``state``."""
    xyz, feats = x
    jx = jso3.SphericalPointCloud(jnp.asarray(xyz), jnp.asarray(feats), None)
    v = jmod.init(jax.random.PRNGKey(2), jx, train=False)
    v = jax.tree_util.tree_map(np.asarray, v)
    out = jmod.apply(v, jx, train=False)
    tmod.load_state_dict(state(v))
    with torch.no_grad():
        got = tmod.eval()(SphericalPointCloud(_t(xyz), _t(feats), None))
    return out, got


def test_kanchor1_separable_block_matches_jax():
    """The separable block at one anchor (no intra conv, the skip 4D), fp32
    eval against JAX's, strided; its weights by ``separable_block_state``
    (no intra conv in either tree)."""
    args = dict(dim_in=C, dim_out=16, kernel_size=1, stride=2, radius=0.6,
                sigma=0.1, n_neighbor=8, kanchor=1, norm='BatchNorm2d',
                activation='leaky_relu', dropout_rate=0.0, lazy_sample=True)
    blk = tblocks.SeparableSO3ConvBlock(args)
    assert not hasattr(blk, 'intra_conv')
    out, got = _block_pair(
        jblocks.SeparableSO3ConvBlock(args), blk, _spc(a=1, seed=5),
        lambda v: tcompat.separable_block_state(v['params'],
                                                v['batch_stats']))
    assert got.feats.shape == (B, P // 2, 1, 16)
    np.testing.assert_allclose(got.feats.numpy(), np.asarray(out[3].feats),
                               **TOL)


def test_intra_block_layers_of_a_basic_block_match_jax():
    """A BasicSO3ConvBlock of [separable, intra_block, separable] layers at
    60 anchors (the types numbered apart in the JAX tree, in order in the
    port's: ``from_jax_variables`` with the block parameters), fp32 eval."""
    sep = dict(dim_in=C, dim_out=C, kernel_size=1, stride=1, radius=0.8,
               sigma=0.1, n_neighbor=8, kanchor=60, norm='BatchNorm2d',
               activation='leaky_relu', dropout_rate=0.0, lazy_sample=True)
    params = [{'type': 'separable_block', 'args': sep},
              {'type': 'intra_block', 'args': {'dim_in': C, 'dim_out': C}},
              {'type': 'separable_block', 'args': sep}]
    out, got = _block_pair(
        jblocks.BasicSO3ConvBlock(params), tblocks.BasicSO3ConvBlock(params),
        _spc(seed=6), lambda v: {k.split('.', 2)[2]: t for k, t in
                                 tcompat.from_jax_variables(
                                     {'params': {'BasicSO3ConvBlock_0':
                                                 v['params']},
                                      'batch_stats': {'BasicSO3ConvBlock_0':
                                                      v['batch_stats']}},
                                     {'backbone': [params]}).items()})
    np.testing.assert_allclose(got.feats.numpy(), np.asarray(out.feats),
                               **TOL)
