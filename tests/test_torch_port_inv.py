"""The torch port's fp32 inv_so3net_pn 3DMatch triplet training step against
the JAX package on the CPU.

Kernels: the W-off inter conv's plain versions (``inter_conv_f_plain``,
``inter_conv_dg_plain``) against the Pallas forms they replace
(``fused_gather_neighbor_conv``, ``fused_neighbor_conv`` and their VJPs) in
interpret mode; ``InterConvFn`` on both backward routes against
``jax.grad`` of ``fused_gather_conv_w``, whose ``_fgcw_bwd`` picks the same
route; the route predicate on every layer of both builders. Model: the inv
builder's parameter tree, the weight import, eval descriptors and one
triplet step (loss, per-leaf gradients, Adam) of a small inv model against
the JAX package. Host side: the triplet loss, the synthetic 3DMatch tree,
the fragment loader (on the JAX package's numpy / scipy path), the trainer
and the entry point.
"""

import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epn_pointcloud_tpu import compat as jcompat
from epn_pointcloud_tpu import losses as jlosses
from epn_pointcloud_tpu import native as jnative
from epn_pointcloud_tpu.app import config as jconfig
from epn_pointcloud_tpu.data import match_3dmatch as jmatch
from epn_pointcloud_tpu.data import synthetic as jsynth
from epn_pointcloud_tpu.models import cls_so3net_pn as jcls
from epn_pointcloud_tpu.models import inv_so3net_pn as jinv
from epn_pointcloud_tpu.ops.pallas import inter_conv as jic

from epn_pointcloud_tpu_torch import compat as tcompat
from epn_pointcloud_tpu_torch import losses as tlosses
from epn_pointcloud_tpu_torch import run_3dmatch as trun
from epn_pointcloud_tpu_torch import train as ttrain
from epn_pointcloud_tpu_torch.app import config as tconfig
from epn_pointcloud_tpu_torch.app.trainer_3dmatch import Trainer3DMatch
from epn_pointcloud_tpu_torch.data import match_3dmatch as tmatch
from epn_pointcloud_tpu_torch.data import synthetic as tsynth
from epn_pointcloud_tpu_torch.models import inv_so3net_pn as tinv
from epn_pointcloud_tpu_torch.ops import kernels as tkernels
from epn_pointcloud_tpu_torch.ops.kernels import inter_conv as tic

K_POINTS = 24
SMALL_MLPS = ((32, 32), (64, 64))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


# ---------------------------------------------------------- W-off kernels

def _woff_operands(B, P, N, AC, C, Q, seed):
    """Operands of both packages' W-off forms, as tests/test_pallas_inter_conv.py
    builds them; a third of the neighbor slots hold the shadow index (the
    port's q, JAX's first zero pad row: qp = ceil8(Q) > Q); neighbor counts
    below a power of two are padded to nt by the JAX package."""
    rng = np.random.RandomState(seed)
    sigma = 0.1
    gx = (0.3 * rng.randn(B, P, N, 3)).astype(np.float32)
    tab = rng.randn(B, Q, AC * C).astype(np.float32)
    idx = rng.randint(0, Q, size=(B, P, N)).astype(np.int32)
    idx[:, :, ::3] = Q
    anch = rng.randn(AC, 3, 3).astype(np.float32)
    ker = (0.3 * rng.randn(K_POINTS, 3)).astype(np.float32)
    rk = np.einsum('aij,kj->aki', anch, ker).astype(np.float32)
    k2 = (ker ** 2).sum(-1).astype(np.float32)
    nt, tp, kt, _ = jic.plan(N, K_POINTS)
    assert kt == K_POINTS and P % tp == 0
    qp = -(-Q // 8) * 8
    assert qp > Q
    tabp = jnp.pad(jnp.asarray(tab), ((0, 0), (0, qp - Q), (0, 0)))
    idx_pad = jnp.pad(jnp.asarray(idx), ((0, 0), (0, 0), (0, nt - N)),
                      constant_values=Q - 1)
    # the pre-gathered rows (neighbor-major, shadow rows zero)
    G = jnp.take_along_axis(tabp, idx_pad.reshape(B, -1, 1), axis=1)
    j = dict(gx8=jic.make_gx8(jnp.asarray(gx), nt),
             rk8=jic.make_rk8(jnp.asarray(rk), jnp.asarray(k2), tp, kt, sigma),
             tabp=tabp, idx3=idx_pad.reshape(B, 1, P * nt), G=G, nt=nt,
             tp=tp, kt=kt)
    # the port: the table form, and the pre-gathered rows as a table indexed
    # by their own positions
    rows = np.array(G).reshape(B, P, nt, AC, C)[:, :, :N]
    t = dict(gx=torch.from_numpy(gx), idx=torch.from_numpy(idx),
             tab=torch.from_numpy(tab).reshape(B, Q, AC, C),
             rk=torch.from_numpy(rk), k2=torch.from_numpy(k2),
             rows=torch.from_numpy(np.ascontiguousarray(rows)).reshape(
                 B, P * N, AC, C),
             ridx=torch.arange(P * N, dtype=torch.int32).reshape(
                 1, P, N).repeat(B, 1, 1))
    return j, t, sigma, (gx, tab, idx, rk, k2)


# (N, C, Q): c = 32 at nn = 64 (tp = 2), c = 64 at nn = 32 (tp = 4), and a
# neighbor count the JAX package pads (24 -> nt = 32)
WOFF_SHAPES = [(64, 32, 45), (32, 64, 61), (24, 32, 37)]


@pytest.mark.parametrize('N,C,Q', WOFF_SHAPES)
def test_inter_conv_f_plain_matches_pallas_forms(N, C, Q):
    """F [b, p, a, k, c] of inter_conv_f_plain against both TPU forms in
    interpret mode (the table form fused_gather_neighbor_conv ->
    _fwd_gather_kernel; the pre-gathered form fused_neighbor_conv ->
    _fwd_kernel, which the port runs as a table of the gathered rows) and
    the oracle reference_F; rtol 2e-4, atol 2e-4 as
    tests/test_pallas_inter_conv.py:42."""
    B, P, AC = 2, 4, 3
    j, t, sigma, (gx, tab, idx, rk, k2) = _woff_operands(B, P, N, AC, C, Q,
                                                         seed=N + C)
    jF = jic.fused_gather_neighbor_conv(j['gx8'], j['idx3'], j['tabp'],
                                        j['rk8'], sigma, j['tp'], j['kt'],
                                        j['nt'], None, True)
    jF2 = jic.fused_neighbor_conv(j['gx8'], j['G'], j['rk8'], sigma, j['tp'],
                                  j['kt'], j['nt'], None, 0, True)
    g = np.concatenate([tab, np.zeros((B, 1, AC * C), np.float32)], 1)
    g = np.take_along_axis(g, idx.reshape(B, -1, 1), axis=1)
    ref = jic.reference_F(jnp.asarray(gx), jnp.asarray(np.transpose(
        g.reshape(B, P, N, AC, C), (0, 3, 1, 2, 4))), jnp.asarray(rk),
        jnp.asarray(k2), sigma, K_POINTS)
    tF = tic.inter_conv_f_plain(t['gx'], t['idx'], t['tab'], t['rk'],
                                t['k2'], sigma)
    tF2 = tic.inter_conv_f_plain(t['gx'], t['ridx'], t['rows'], t['rk'],
                                 t['k2'], sigma)
    assert tF.shape == (B, P, AC, K_POINTS, C) and tF.dtype == torch.float32
    for want in (jF, jF2, ref):
        want = np.transpose(np.asarray(want), (0, 2, 1, 3, 4))
        for got in (tF, tF2):
            np.testing.assert_allclose(got.numpy(), want, rtol=2e-4,
                                       atol=2e-4)


@pytest.mark.parametrize('N,C,Q', WOFF_SHAPES)
def test_inter_conv_dg_plain_matches_pallas_vjp(N, C, Q):
    """dT of inter_conv_dg_plain against the VJP of both TPU forms in
    interpret mode (_bwd_kernel, and for the table form the one-hot fold of
    dG onto the table rows) for one random cotangent dF: normwise relative
    <= 1e-4; elementwise rtol 2e-4 with atol 2e-3 for the isolated
    w-boundary flips, as tests/test_pallas_inter_conv.py:57-61."""
    B, P, AC = 2, 4, 3
    j, t, sigma, _ = _woff_operands(B, P, N, AC, C, Q, seed=N + C + 1)
    ct = np.random.RandomState(C).randn(B, AC, P, K_POINTS, C).astype(
        np.float32)
    _, vjp = jax.vjp(lambda tb: jic.fused_gather_neighbor_conv(
        j['gx8'], j['idx3'], tb, j['rk8'], sigma, j['tp'], j['kt'], j['nt'],
        None, True), j['tabp'])
    jdT = np.asarray(vjp(jnp.asarray(ct))[0])[:, :Q]
    _, vjp2 = jax.vjp(lambda G: jic.fused_neighbor_conv(
        j['gx8'], G, j['rk8'], sigma, j['tp'], j['kt'], j['nt'], None, 0,
        True), j['G'])
    jdG = np.asarray(vjp2(jnp.asarray(ct))[0]).reshape(
        B, P, j['nt'], AC * C)[:, :, :N].reshape(B, P * N, AC * C)

    dF = torch.from_numpy(np.ascontiguousarray(np.transpose(ct,
                                                            (0, 2, 1, 3, 4))))
    tdT = tic.inter_conv_dg_plain(t['gx'], t['idx'], Q, t['rk'], t['k2'], dF,
                                  sigma)
    tdG = tic.inter_conv_dg_plain(t['gx'], t['ridx'], P * N, t['rk'],
                                  t['k2'], dF, sigma)
    assert tdT.shape == (B, Q, AC, C) and tdT.dtype == torch.float32
    for got, want in ((tdT, jdT), (tdG, jdG)):
        got = got.reshape(want.shape).numpy()
        assert _rel(got, want) <= 1e-4
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize('N,C,D,composed', [
    (16, 32, 32, True),     # c <= 32 (tp = 8): the composed route
    (64, 64, 64, True),     # tp = 2: the composed route
    (32, 64, 64, False),    # c > 32, tp = 4: the fused route
])
def test_inter_conv_fn_routes_match_pallas_grad(monkeypatch, N, C, D,
                                                composed):
    """dTable and dW of InterConvFn against jax.grad through
    fused_gather_conv_w in interpret mode, whose _fgcw_bwd takes the matching
    route by itself; normwise <= 1e-3, as tests/test_pallas_inter_conv.py:
    310-319. The port's route is observed: the composed one calls
    inter_conv_dg and inter_conv_f once each, the fused one neither."""
    rng = np.random.RandomState(N + C)
    B, P, AC, Q, sigma = 2, 8, 3, 45, 0.1
    gx = (0.3 * rng.randn(B, P, N, 3)).astype(np.float32)
    tab = rng.randn(B, Q, AC * C).astype(np.float32)
    idx = rng.randint(0, Q, size=(B, P, N)).astype(np.int32)
    idx[:, :, ::3] = Q
    anch = rng.randn(AC, 3, 3).astype(np.float32)
    ker = (0.3 * rng.randn(K_POINTS, 3)).astype(np.float32)
    W = (0.1 * rng.randn(K_POINTS, C, D)).astype(np.float32)
    rk = jnp.einsum('aij,kj->aki', jnp.asarray(anch), jnp.asarray(ker))
    k2 = jnp.sum(jnp.asarray(ker) ** 2, -1)
    nt, tp, kt, _ = jic.plan(N, K_POINTS)
    assert tic.composed_backward(C, N) == composed == (C <= 32 or tp <= 2)
    gx8 = jic.make_gx8(jnp.asarray(gx), nt)
    rk8t = jic.make_rk8(rk, k2, tp, kt, sigma)
    rk8k = jic.make_rk8_kmajor(rk, k2, tp, kt, sigma)
    qp = -(-Q // 8) * 8
    tabp = jnp.pad(jnp.asarray(tab), ((0, 0), (0, qp - Q), (0, 0)))
    idx3 = jnp.asarray(idx).reshape(B, 1, P * nt)

    def loss(tb, w2):
        out = jic.fused_gather_conv_w(gx8, idx3, tb, rk8k, rk8t, w2, sigma,
                                      tp, kt, nt, None, True)
        return jnp.sum(jnp.sin(out))
    jdt, jdw = jax.grad(loss, argnums=(0, 1))(
        tabp, jnp.asarray(W).reshape(K_POINTS * C, D))

    seen = []
    for name in ('inter_conv_dg', 'inter_conv_f', 'inter_conv_dtable',
                 'inter_conv_dw'):
        def rec(*a, _f=getattr(tic, name), _n=name):
            seen.append(_n)
            return _f(*a)
        monkeypatch.setattr(tic, name, rec)
    t_tab = torch.from_numpy(tab).reshape(B, Q, AC, C).requires_grad_()
    t_W = torch.from_numpy(W).requires_grad_()
    out = tic.InterConvFn.apply(
        torch.from_numpy(gx), torch.from_numpy(idx), t_tab,
        torch.from_numpy(np.array(rk)), torch.from_numpy(np.array(k2)), t_W,
        sigma)
    torch.sin(out).sum().backward()
    assert sorted(seen) == (['inter_conv_dg', 'inter_conv_f'] if composed
                            else ['inter_conv_dtable', 'inter_conv_dw'])
    assert _rel(t_tab.grad.reshape(B, Q, AC * C).numpy(),
                np.asarray(jdt)[:, :Q]) < 1e-3
    assert _rel(t_W.grad.reshape(K_POINTS * C, D).numpy(), jdw) < 1e-3


def _gate_opt(model, input_num=1024):
    return jconfig.default_opt(**{'model.model': model,
                                  'model.flag': 'attention',
                                  'model.input_num': input_num,
                                  'model.search_radius': 0.4})


def _layers(params, input_num):
    """(name, c_in, n_neighbor) of every layer with a feature table (block
    0 layer 0 runs the ones conv)."""
    out = []
    for bi, block in enumerate(params['backbone']):
        for li, layer in enumerate(block):
            a = layer['args']
            if a['dim_in'] > 1:
                out.append((f'B{bi}L{li}', a['dim_in'], a['n_neighbor']))
    return out


@pytest.mark.parametrize('c,nn', [(8, 8), (40, 8), (40, 40)])
def test_bf16_table_takes_the_jax_route(monkeypatch, c, nn):
    """The backward route depends on the shape alone, as _fgcw_bwd:1675's
    gate does: a bf16 table takes the same route as an fp32 one, the
    composition (inter_conv_dg, inter_conv_f) where composed_backward(c, nn)
    holds (c <= 32; nn > 32) and the fused dTable / dW elsewhere, with
    gradients in the operands' types."""
    rng = np.random.RandomState(3)
    b, p2, q, na, d = 1, 4, 6, 2, 32
    gx = torch.from_numpy((0.3 * rng.randn(b, p2, nn, 3)).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, q + 1, (b, p2, nn)).astype(
        np.int32))
    rk = torch.from_numpy((0.3 * rng.randn(na, K_POINTS, 3)).astype(
        np.float32))
    k2 = (rk[0] ** 2).sum(-1)
    seen = []
    for name in ('inter_conv_dg', 'inter_conv_f', 'inter_conv_dtable',
                 'inter_conv_dw'):
        def rec(*a, _f=getattr(tic, name), _n=name):
            seen.append(_n)
            return _f(*a)
        monkeypatch.setattr(tic, name, rec)
    routes = {}
    for dtype in (torch.float32, torch.bfloat16):
        seen.clear()
        tab = torch.from_numpy(rng.randn(b, q, na, c).astype(
            np.float32)).to(dtype).requires_grad_()
        W = torch.from_numpy((0.1 * rng.randn(K_POINTS, c, d)).astype(
            np.float32)).to(dtype).requires_grad_()
        tic.InterConvFn.apply(gx, idx, tab, rk, k2, W, 0.1).float().sum() \
            .backward()
        assert tab.grad.dtype == W.grad.dtype == dtype
        assert torch.isfinite(tab.grad).all() and torch.isfinite(W.grad).all()
        routes[dtype] = sorted(seen)
    want = (['inter_conv_dg', 'inter_conv_f'] if tic.composed_backward(c, nn)
            else ['inter_conv_dtable', 'inter_conv_dw'])
    assert tic.composed_backward(c, nn) == (c <= 32 or nn > 32)
    assert routes == {torch.float32: want, torch.bfloat16: want}


def test_route_predicate_matches_fgcw_gate():
    """composed_backward(c, nn) == (c <= 32 or tp <= 2), the negation of
    _fgcw_bwd:1675's fused gate, at every layer of the cls and inv builders;
    it picks inv B0L1, B1L0, B2L0 and B3L0 and no cls layer."""
    picked = {}
    for name, build in (('cls', jcls.build_model), ('inv', jinv.build_model)):
        params = build(_gate_opt(f'{name}_so3net_pn')).params
        picked[name] = []
        for layer, c, nn in _layers(params, 1024):
            tp = jic.plan(nn, K_POINTS)[1]
            assert tic.composed_backward(c, nn) == (c <= 32 or tp <= 2)
            if tic.composed_backward(c, nn):
                picked[name].append(layer)
    assert picked == {'cls': [], 'inv': ['B0L1', 'B1L0', 'B2L0', 'B3L0']}


# ----------------------------------------------------------- model, weights

@pytest.mark.parametrize('input_num', [1024, 2048])
def test_inv_builder_params_match_jax(input_num):
    """The block-parameter tree (sigma x stride, the neighbor multiplier,
    the input_num > 1024 stride rule) equals JAX build_model's."""
    opt = _gate_opt('inv_so3net_pn', input_num)
    assert tinv.build_model(opt, seed=None).params == \
        jinv.build_model(opt).params


def _jax_init(jmodel, input_num=1024):
    x0 = jnp.zeros((2, input_num, 3), jnp.float32)
    init = jax.jit(lambda: jmodel.init(jax.random.PRNGKey(0), x0,
                                       train=False))()
    return jax.tree_util.tree_map(np.asarray, dict(init))


def test_from_jax_variables_loads_every_inv_leaf():
    """Every leaf of a JAX-initialized full-width inv model lands in the
    port's state_dict (strict load; no BatchNorm anywhere), and the JAX
    importer takes the port's state_dict back unchanged."""
    opt = _gate_opt('inv_so3net_pn')
    init = _jax_init(jinv.build_model(opt))
    assert 'batch_stats' not in init
    model = tinv.build_model(opt, seed=None)
    sd = tcompat.from_jax_variables(init)
    model.load_state_dict(sd, strict=True)
    assert not any('norm' in k for k in sd)
    back = jcompat.import_state_dict(init, model.state_dict())
    for (p, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(back['params'])[0],
            jax.tree_util.tree_flatten_with_path(init['params'])[0]):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(p))


def _patches(rng, b, n=1024, radius=0.4):
    """Well-spread patches: n distinct points uniform in a ball of the
    search radius."""
    v = rng.randn(b, n, 3)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return (radius * v * rng.rand(b, n, 1) ** (1.0 / 3.0)).astype(np.float32)


def _tree_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), np.asarray(v)) for p, v in flat]


@pytest.fixture(scope='module')
def inv_pair():
    """A small inv model (mlps ((32, 32), (64, 64)): the composed route at
    B0L1 and B1L0, the fused one at B1L1) in both packages on shared
    weights, and two legs of b = 2 well-spread patches."""
    opt = _gate_opt('inv_so3net_pn')
    jmodel = jinv.build_model(opt, mlps=SMALL_MLPS)
    init = _jax_init(jmodel)
    tmodel = tinv.build_model(opt, mlps=SMALL_MLPS, seed=None)
    tmodel.load_state_dict(tcompat.from_jax_variables(init))
    rng = np.random.RandomState(17)
    return dict(jmodel=jmodel, init=init, tmodel=tmodel,
                src=_patches(rng, 2), tgt=_patches(rng, 2))


def test_inv_descriptors_match_jax(inv_pair):
    """Eval-mode descriptors [b, 64] and anchor attention against the JAX
    InvSO3ConvModel on the same weights: rtol 1e-3, atol 2e-3."""
    s = inv_pair
    x = np.concatenate([s['src'], s['tgt']])
    jy, ja = jax.jit(lambda v: s['jmodel'].apply(s['init'], v, train=False))(
        jnp.asarray(x))
    s['tmodel'].eval()
    with torch.no_grad():
        ty, ta = s['tmodel'](torch.from_numpy(x))
    assert ty.shape == (4, 64)
    np.testing.assert_allclose(ty.norm(dim=1).numpy(), 1.0, rtol=1e-5)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-3,
                               atol=2e-3)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-3,
                               atol=2e-3)


def _assert_grads_close(got, want, degenerate, f64_scales, max_rel=5e-2,
                        l2_rel=1e-2, noise_abs=1e-3):
    """The rule of tests/test_reference_train_parity.py:143-209 (as
    tests/test_torch_port_train.py applies it): per leaf, relative L2 <=
    1e-2 and max error <= 5e-2 * max|grad|; leaves the float64 pass proved
    zero must be <= noise_abs in both; leaves below noise_abs in both must
    have a float64 gradient below it too, and agree within 2 * noise_abs."""
    a, b = _tree_leaves(got), _tree_leaves(want)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, g), (_, w) in zip(a, b):
        g, w = g.astype(np.float64), w.astype(np.float64)
        both_tiny = max(np.abs(g).max(), np.abs(w).max()) <= noise_abs
        if path in degenerate:
            assert both_tiny, (path, np.abs(g).max(), np.abs(w).max())
            continue
        if both_tiny:
            assert f64_scales[path] <= noise_abs, (path, f64_scales[path])
            assert np.abs(g - w).max() <= 2 * noise_abs, path
            continue
        err = np.abs(g - w).max()
        assert err <= max_rel * np.abs(w).max(), (path, err)
        assert _rel(g, w) <= l2_rel, (path, _rel(g, w))


@pytest.fixture(scope='module')
def triplet_step_pair(inv_pair):
    """One triplet step of both packages (two legs, the soft loss, margin
    1) on the shared weights."""
    s = inv_pair
    src, tgt = jnp.asarray(s['src']), jnp.asarray(s['tgt'])

    def loss_fn(params):
        v = {'params': params}
        ys, _ = s['jmodel'].apply(v, src, train=True)
        yt, _ = s['jmodel'].apply(v, tgt, train=True)
        return jlosses.triplet_batch_loss(ys, yt, 'soft', 1.0)[0]
    # jitted, not eager (unlike tests/test_torch_port_train.py's cls step):
    # block 0's skip InstanceNorm normalizes a constant field (the occupancy
    # ones through a 1x1 conv), so its output is the rounding error of the
    # field's mean amplified by 1/sqrt(eps). Against a float64 step of the
    # same weights, jitted JAX and the port's fp32 step put ~1e-7 of error
    # in the descriptors and <= 6.3e-4 (port <= 2.7e-4) relative L2 in
    # every real leaf's gradient; eager JAX puts 1.1e-4 in the descriptors
    # and up to 5.3e-2 in the gradients, past the per-leaf rule (running
    # this file as a script prints the values).
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(s['init']['params'])

    tmodel = s['tmodel']
    tmodel.train()
    tmodel.zero_grad()
    ys, _ = tmodel(torch.from_numpy(s['src']))
    yt, _ = tmodel(torch.from_numpy(s['tgt']))
    tloss, _ = tlosses.triplet_batch_loss(ys, yt, 'soft', 1.0)
    tloss.backward()
    grad_sd = {n: p.grad.detach().clone()
               for n, p in tmodel.named_parameters()}
    tgrads = jcompat.import_state_dict(s['init'], grad_sd)['params']
    return dict(loss_fn=loss_fn, jloss=float(jloss), jgrads=jgrads,
                tloss=tloss.item(), tgrads=tgrads)


def test_triplet_step_loss_and_gradients_match_jax(inv_pair,
                                                   triplet_step_pair):
    s = triplet_step_pair
    np.testing.assert_allclose(s['tloss'], s['jloss'], rtol=1e-4)
    # the degenerate leaves are derived, as the JAX package's own test
    # does: float64 gradients ~0 (<= 1e-5) are the mathematically-zero ones
    # (here from a float64 copy of the port's model: its plain forward
    # under torch autograd, which shares no backward formula with the
    # port's Functions)
    m64 = tinv.build_model(_gate_opt('inv_so3net_pn'), mlps=SMALL_MLPS,
                           seed=None).double()
    m64.load_state_dict(tcompat.from_jax_variables(inv_pair['init']))
    with tkernels.plain():
        ys, _ = m64(torch.from_numpy(inv_pair['src']).double())
        yt, _ = m64(torch.from_numpy(inv_pair['tgt']).double())
        tlosses.triplet_batch_loss(ys, yt, 'soft', 1.0)[0].backward()
    g64 = jcompat.import_state_dict(inv_pair['init'], {
        n: p.grad.float() for n, p in m64.named_parameters()})['params']
    scales = {p: float(np.max(np.abs(v))) for p, v in _tree_leaves(g64)}
    degenerate = {p for p, m in scales.items() if m <= 1e-5}
    assert degenerate, 'expected the block-0 skip conv among the leaves'
    _assert_grads_close(s['tgrads'], s['jgrads'], degenerate, scales)


def test_adam_step_on_triplet_gradients_matches_optax(inv_pair,
                                                      triplet_step_pair):
    """One torch Adam step (make_optimizer) on the triplet gradients against
    optax.adam on the same gradients, rtol 1e-5 of each leaf's magnitude."""
    import optax
    s, tmodel = triplet_step_pair, inv_pair['tmodel']
    sd0 = {k: v.clone() for k, v in tmodel.state_dict().items()}
    opt_t = ttrain.make_optimizer(tmodel.parameters(), 1e-3)
    opt_t.step()
    got = jcompat.import_state_dict(inv_pair['init'],
                                    tmodel.state_dict())['params']
    params = inv_pair['init']['params']
    tx = optax.adam(1e-3, b1=0.9, b2=0.999, eps=1e-8)
    updates, _ = tx.update(s['tgrads'], tx.init(params), params)
    want = optax.apply_updates(params, updates)
    for (path, g), (_, w) in zip(_tree_leaves(got), _tree_leaves(want)):
        scale = max(float(np.max(np.abs(w))), 1e-6)
        assert float(np.max(np.abs(g - w))) <= 1e-5 * scale, path
    tmodel.load_state_dict(sd0)


# -------------------------------------------------------------------- loss

@pytest.mark.parametrize('mode', ['hard', 'soft', 'contrastive', 'plain'])
def test_triplet_batch_loss_matches_jax(mode):
    """Loss, accuracy, fpos, cneg and the distance matrix, fp32 to rtol
    1e-6 (atol 1e-6), on unit descriptors with a near-duplicate pair."""
    rng = np.random.RandomState(5)
    src = rng.randn(8, 64).astype(np.float32)
    tgt = (src + 0.3 * rng.randn(8, 64)).astype(np.float32)
    tgt[3] = src[3]
    src /= np.linalg.norm(src, axis=1, keepdims=True)
    tgt /= np.linalg.norm(tgt, axis=1, keepdims=True)
    jl, ja = jlosses.triplet_batch_loss(jnp.asarray(src), jnp.asarray(tgt),
                                        mode, 0.7)
    tl, ta = tlosses.triplet_batch_loss(torch.from_numpy(src),
                                        torch.from_numpy(tgt), mode, 0.7)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6, atol=1e-6)
    for k in ('accuracy', 'fpos', 'cneg', 'all_dist'):
        np.testing.assert_allclose(ta[k].numpy(), np.asarray(ja[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


# --------------------------------------------------------------- host data

def _dense_tree(make, root):
    """The dense room of tests/test_reference_entrypoint_parity.py:273-275:
    every keypoint's 0.4 ball holds >= 1024 distinct points."""
    return make(root, scene='synth-scene', n_frags=3, n_points=32000,
                n_kpts=8, seed=11, extent=(2.0, 2.0, 1.6), kpt_margin=0.45)


@pytest.fixture(scope='module')
def dense_trees(tmp_path_factory):
    base = tmp_path_factory.mktemp('3dm')
    jroot, troot = str(base / 'jax'), str(base / 'torch')
    _dense_tree(jsynth.make_3dmatch_tree, jroot)
    _dense_tree(tsynth.make_3dmatch_tree, troot)
    return jroot, troot


def test_make_3dmatch_tree_writes_the_jax_files(dense_trees):
    """Same file list, byte for byte."""
    jroot, troot = dense_trees
    listing = []
    for root in dense_trees:
        listing.append(sorted(os.path.relpath(os.path.join(d, f), root)
                              for d, _, fs in os.walk(root) for f in fs))
    assert listing[0] == listing[1] and len(listing[0]) == 15
    for rel in listing[0]:
        assert filecmp.cmp(os.path.join(jroot, rel), os.path.join(troot, rel),
                           shallow=False), rel


def _loader_opt(module, root, input_num=1024):
    opt = module.parse_args(['experiment', '-d', root, '--input-num',
                             str(input_num)])
    opt.no_augmentation = True
    return opt


def test_fragment_loader_items_equal_jax_loader(dense_trees, monkeypatch):
    """Two epochs of items (patches, fragments, T, id) equal the JAX
    loader's bit for bit, with the JAX package on its numpy / scipy path
    (its compiled host ops voxelize and search otherwise)."""
    monkeypatch.setattr(jnative, 'available', lambda: False)
    jroot, troot = dense_trees
    jl = jmatch.FragmentLoader(_loader_opt(jconfig, jroot), 0.4, npt=4)
    tl = tmatch.FragmentLoader(_loader_opt(tconfig, troot), 0.4, npt=4)
    assert len(jl) == len(tl) == 2
    for i in (0, 1, 1, 0):
        x, y = jl[i], tl[i]
        assert x['fn'] == y['fn'] and y['src'].shape == (4, 1024, 3)
        for k in ('src', 'tgt', 'frag_src', 'frag_tgt', 'T'):
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    sj = jmatch.PointCloudPairSampler(7, seed=3)
    st = tmatch.PointCloudPairSampler(7, seed=3)
    assert [list(sj) for _ in range(3)] == [list(st) for _ in range(3)]


# ------------------------------------------------------------ entry point

def test_config_opt_3dmatch_matches_jax():
    """The entry point's training overrides equal the JAX one's."""
    import run_3dmatch as jrun
    argv = ['experiment', '-d', '/nonexistent', '--run-mode', 'train']
    j = jconfig.dump_args(jrun.config_opt_3dmatch(jconfig.parse_args(argv)))
    t = tconfig.dump_args(trun.config_opt_3dmatch(tconfig.parse_args(argv)))
    for k in ('model', 'train_lr'):
        for kk, v in t[k].items():
            assert j[k][kk] == v, (k, kk)
    for kk in ('no_augmentation', 'npt', 'batch_size', 'num_iterations',
               'save_freq'):
        assert j[kk] == t[kk], kk


def test_trainer_3dmatch_trains_on_the_cpu_and_reloads(tmp_path,
                                                      monkeypatch):
    """Trainer3DMatch(opt, device='cpu') at npt 2, with the small inv model
    in place of the full-width one (the card runs that: chip_smoke.py's
    [inv-train-entry]): two steps with finite logged losses and gradients
    on every parameter; the checkpoint reloads through -r to the same
    weights."""
    from epn_pointcloud_tpu_torch import models
    monkeypatch.setattr(models, 'build_model_from',
                        lambda opt, seed, outfile_path=None: (
                            tinv.build_model(opt, mlps=SMALL_MLPS, seed=seed,
                                             to_file=outfile_path)))
    root = str(tmp_path / 'data')
    tsynth.make_3dmatch_tree(root, n_frags=2, n_points=2000, n_kpts=8,
                             seed=1)

    def opt_for(extra=()):
        opt = trun.config_opt_3dmatch(tconfig.parse_args(
            ['experiment', '-d', root, '--model-dir', str(tmp_path / 'runs'),
             '-lf', '1'] + list(extra)))
        opt.npt, opt.num_iterations, opt.save_freq = 2, 2, 2
        return opt
    trainer = Trainer3DMatch(opt_for(), device='cpu')
    trainer.train()
    trainer.logger.close()
    stats = trainer.summary.running_stats
    assert trainer.summary.counters['Loss'] == 2
    assert all(np.isfinite(stats[k]) for k in ('Loss', 'Pos', 'Neg', 'Acc'))
    assert np.isfinite(float(trainer.last_loss))
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in trainer.model.parameters())
    ckpt = trainer.last_ckpt
    assert os.path.basename(ckpt) == 'playground_net_Iter2.pth'
    other = Trainer3DMatch(opt_for(['-r', ckpt]), device='cpu')
    other.logger.close()
    for (k, a), (_, b) in zip(trainer.model.state_dict().items(),
                              other.model.state_dict().items()):
        assert torch.equal(a, b), k


@pytest.mark.parametrize('argv,exc,what', [
    (['--run-mode', 'eval'], AssertionError, 'checkpoint'),
    (['--equi-alpha', '0.5'], NotImplementedError, 'equivariance'),
])
def test_unported_modes_are_refused(tmp_path, argv, exc, what):
    """The evaluation without a checkpoint (-r), as the JAX entry point
    asserts, and the equivariance loss, whose JAX reference fails on its
    own model."""
    with pytest.raises(exc, match=what):
        trun.main(['experiment', '-d', str(tmp_path), '--model-dir',
                   str(tmp_path / 'runs')] + argv, device='cpu')
    assert not (tmp_path / 'runs').exists()


def test_entry_refuses_to_start_without_cuda(tmp_path, monkeypatch):
    """No CUDA device and none named: the entry raises before any setup;
    -i and --save-freq on the command line win over the overrides."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        trun.main(['experiment', '-d', str(tmp_path), '--model-dir',
                   str(tmp_path / 'runs'), '-i', '4', '--save-freq', '4'])
    assert not (tmp_path / 'runs').exists()
    seen = []

    class Recorder:
        def __init__(self, opt, device):
            seen.append(opt)

        def train(self):
            pass
    monkeypatch.setattr(trun, 'Trainer3DMatch', Recorder)
    base = ['experiment', '-d', str(tmp_path)]
    trun.main(base + ['-i', '4', '--save-freq=3'])
    trun.main(base)
    assert [(o.num_iterations, o.save_freq, o.npt) for o in seen] == \
        [(4, 3, 16), (150000, 4000, 16)]


# ------------------------------------------- measured values, as a script

def _print_reference_accuracy():
    """The small inv model's triplet step (the fixtures' weights and
    patches) in the port's fp32 and in jitted and eager JAX, each against a
    float64 step of the port's plain forward under autograd: max descriptor
    error and per-leaf relative L2 of the gradients."""
    opt = _gate_opt('inv_so3net_pn')
    jmodel = jinv.build_model(opt, mlps=SMALL_MLPS)
    init = _jax_init(jmodel)
    rng = np.random.RandomState(17)
    src, tgt = _patches(rng, 2), _patches(rng, 2)

    def loss_fn(params):
        v = {'params': params}
        ys, _ = jmodel.apply(v, jnp.asarray(src), train=True)
        yt, _ = jmodel.apply(v, jnp.asarray(tgt), train=True)
        return (jlosses.triplet_batch_loss(ys, yt, 'soft', 1.0)[0],
                jnp.concatenate([ys, yt]))
    runs = {}
    for name, f in (('jax jit', jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))), ('jax eager', jax.value_and_grad(
                loss_fn, has_aux=True))):
        (_, y), g = f(init['params'])
        runs[name] = (np.asarray(y), g)
    for name, dtype in (('port fp32', torch.float32),
                        ('float64', torch.float64)):
        m = tinv.build_model(opt, mlps=SMALL_MLPS, seed=None).to(dtype)
        m.load_state_dict(tcompat.from_jax_variables(init))
        with tkernels.plain() if dtype == torch.float64 else \
                torch.enable_grad():
            ys, _ = m(torch.from_numpy(src).to(dtype))
            yt, _ = m(torch.from_numpy(tgt).to(dtype))
            tlosses.triplet_batch_loss(ys, yt, 'soft', 1.0)[0].backward()
        runs[name] = (torch.cat([ys, yt]).detach().double().numpy(),
                      jcompat.import_state_dict(init, {
                          n: p.grad.float()
                          for n, p in m.named_parameters()})['params'])
    y64, g64 = runs.pop('float64')
    real = [p for p, v in _tree_leaves(g64) if np.abs(v).max() > 1e-5]
    for name, (y, g) in runs.items():
        rels = {p: _rel(a, b) for (p, a), (_, b) in zip(_tree_leaves(g),
                                                        _tree_leaves(g64))
                if p in real}
        print(f'{name}: descriptors max |y - y64| '
              f'{np.abs(y - y64).max():.2e}; gradient relative L2 over '
              f'{len(rels)} real leaves {min(rels.values()):.2e}..'
              f'{max(rels.values()):.2e}')


def _print_native_divergence():
    """The JAX package's compiled host ops against its numpy / scipy path
    on 8000 seeded points: voxel grid (0.015) and radius lists (0.1 around
    16 keypoints)."""
    from epn_pointcloud_tpu.data import pc as jpc
    from scipy.spatial import KDTree
    if not jnative.available():
        print('native host ops: not built here')
        return
    x = np.random.RandomState(0).rand(8000, 3).astype(np.float32)
    a, b = jnative.voxel_downsample(x, 0.015), jpc.voxel_downsample_np(
        x, 0.015)
    same_set = a.shape == b.shape and np.array_equal(
        a[np.lexsort(a.T)], b[np.lexsort(b.T)])
    print(f'voxel grid: native {len(a)} points, numpy {len(b)}; arrays '
          f'equal {a.shape == b.shape and np.array_equal(a, b)}, equal as '
          f'sets {same_set}')
    kp = x[:16]
    la = jnative.radius_search_lists(a, kp, 0.1)
    lb = KDTree(b).query_ball_point(kp, 0.1)
    sets = [{tuple(r) for r in a[i]} == {tuple(r) for r in b[j]}
            for i, j in zip(la, lb)]
    print(f'radius lists: {sum(sets)} of {len(sets)} equal as point sets')


if __name__ == '__main__':
    _print_native_divergence()
    _print_reference_accuracy()
