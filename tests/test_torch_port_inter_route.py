"""Which kernel the bf16 inter backward scatter wrappers (the fused dTable
and the W-off dG), the fused dW and the W-off F launch on the card, decided
on the CPU: every such layer of both models' full-width builds goes to the
tensor-core kernel (``bwd_mma_route``, ``dw_mma_route``, ``f_mma_route``),
fp32 and the shapes off its envelope to the template; a bf16
``InterConvFn`` backward reaching the wrappers' card branch (tensors on the
meta device, the launches recorded) counts the tensor-core dW at every
fused-route layer and the tensor-core F at every composed-route layer.
The text each ``inter_conv_variants`` and ``inter_bwd_variants`` build
substitutes is in the source. The fp32 fused dW goes to its CUDA-core
kernel (``dw_f32_route``) at every fused-route layer, and the fp32
backward scatter (the fused dTable and the W-off dG) to its CUDA-core
kernel (``bwd_f32_route``) at every layer of both models, and the fp32
W-off F to its CUDA-core kernel (``f_f32_route``) at every composed-route
layer, and the fp32 W-fused forward to its CUDA-core kernel
(``fwd_f32_route``) at every layer of both models, each wrapper giving its
C entry as many arguments as the entry's signature holds.
The kernels themselves are held against their plain versions on the card
(tests/test_torch_port_gpu.py); the plain versions against the JAX package
in tests/test_torch_port_bf16_train.py and tests/test_torch_port_inv_bf16.py.
"""

import pytest
import torch

from epn_pointcloud_tpu_torch import models
from epn_pointcloud_tpu_torch.nn.layers import InterSO3Conv
from epn_pointcloud_tpu_torch.ops import kernels as tkern

from test_torch_port_intra_route import _opt

BF16 = torch.bfloat16


def _scatter_layers(name):
    """(entry, K, c, d, nn, na) of every inter conv of the full-width model
    with a feature table (layer 0's ones input has no table gradient): the
    W-off dG where the backward composes, else the fused dTable."""
    model = models.build_model_from(_opt(name), seed=0)
    ic = tkern.inter_conv
    out = []
    for m in model.modules():
        if isinstance(m, InterSO3Conv) and m.basic_conv.dim_in > 1:
            c, nn = m.basic_conv.dim_in, m.n_neighbor
            entry = 'dg' if ic.composed_backward(c, nn) else 'dtable'
            out.append((entry, m.basic_conv.n_kernel, c,
                        m.basic_conv.dim_out, nn, m.anchors.shape[0]))
    return out


@pytest.mark.parametrize('name,n_dtable,n_dg', [('cls_so3net_pn', 6, 0),
                                                ('inv_so3net_pn', 3, 4)])
def test_every_model_scatter_layer_takes_the_tensor_core_kernel(name,
                                                                n_dtable,
                                                                n_dg):
    layers = _scatter_layers(name)
    entries = [e for e, *_ in layers]
    assert (entries.count('dtable'), entries.count('dg')) == (n_dtable, n_dg)
    ic = tkern.inter_conv
    for entry, K, c, d, nn, na in layers:
        dd = d if entry == 'dtable' else None
        assert ic.bwd_mma_route(BF16, K, c, nn, na, dd), (entry, c, d, nn)
        assert not ic.bwd_mma_route(torch.float32, K, c, nn, na, dd)


@pytest.mark.parametrize('K,c,nn,na,d', [(24, 40, 16, 60, 64),
                                         (24, 8, 32, 60, None),
                                         (24, 64, 65, 60, 64),
                                         (24, 64, 16, 12, 64),
                                         (18, 64, 16, 60, None),
                                         (24, 64, 16, 60, 48)])
def test_shapes_off_the_envelope_take_the_template(K, c, nn, na, d):
    """Channels not a multiple of 16, more than 64 neighbors, another
    group, another kernel size, a fused d not a multiple of 32."""
    assert not tkern.inter_conv.bwd_mma_route(BF16, K, c, nn, na, d)


def test_reset_counts_clears_the_scatter_routes():
    ic = tkern.inter_conv
    ic.routes['dtable_mma'] += 2
    ic.routes['dg'] += 1
    tkern.reset_counts()
    assert set(ic.routes.values()) == {0}
    assert {'dtable_mma', 'dtable', 'dg_mma', 'dg'} <= set(ic.routes)


def _fused_layers(name):
    """(K, c, d, nn, na) of every inter conv of the full-width model whose
    backward takes the fused route (dTable and dW kernels)."""
    return [(K, c, d, nn, na) for entry, K, c, d, nn, na
            in _scatter_layers(name) if entry == 'dtable']


@pytest.mark.parametrize('name,n_fused', [('cls_so3net_pn', 6),
                                          ('inv_so3net_pn', 3)])
def test_every_fused_dw_layer_takes_the_tensor_core_kernel(name, n_fused):
    layers = _fused_layers(name)
    assert len(layers) == n_fused
    ic = tkern.inter_conv
    for K, c, d, nn, na in layers:
        assert ic.dw_mma_route(BF16, K, c, d, nn, na), (c, d, nn)
        assert not ic.dw_mma_route(torch.float32, K, c, d, nn, na)


@pytest.mark.parametrize('K,c,d,nn,na', [(24, 40, 64, 16, 60),
                                         (24, 64, 96, 16, 60),
                                         (24, 64, 32, 16, 60),
                                         (24, 64, 64, 65, 60),
                                         (24, 64, 64, 16, 12),
                                         (18, 64, 64, 16, 60)])
def test_dw_shapes_off_the_envelope_take_the_template(K, c, d, nn, na):
    """Channels not a multiple of 16, d not a multiple of 64, more than 64
    neighbors, another group, another kernel size."""
    assert not tkern.inter_conv.dw_mma_route(BF16, K, c, d, nn, na)


def _card_shapes(monkeypatch):
    """Let the inter wrappers take their card branch on meta tensors: the
    device check skipped, each launch recorded by its C entry's name."""
    ic = tkern.inter_conv
    launched = []

    def dims(kernel, gx, idx, table_shape, rk, k2, W_shape, **_):
        b, q, na, c = table_shape
        return b, idx.shape[1], idx.shape[2], q, na, W_shape[0], c, W_shape[2]
    def woff_dims(kernel, gx, idx, table_shape, rk, k2, dtype, **_):
        b, q, na, c = table_shape
        return b, idx.shape[1], idx.shape[2], q, na, rk.shape[1], c
    monkeypatch.setattr(ic, '_check', dims)
    monkeypatch.setattr(ic, '_check_woff', woff_dims)
    monkeypatch.setattr(ic.build, 'launch', lambda name, *a: launched.append(
        name))
    monkeypatch.setattr(ic.build, 'stream', lambda t: 0)
    return launched


@pytest.mark.parametrize('name', ['cls_so3net_pn', 'inv_so3net_pn'])
def test_bf16_backward_counts_the_tensor_core_dw(name, monkeypatch):
    """A bf16 InterConvFn forward and backward at every fused-route layer
    of the model (b = 1, 64 points) on the card branch: one 'dw_mma' and no
    'dw' a layer, launched through epn_inter_conv_bwd_w_mma, and the dW
    gradient in W's bf16."""
    launched = _card_shapes(monkeypatch)
    ic = tkern.inter_conv
    meta = torch.device('meta')
    layers = _fused_layers(name)
    tkern.reset_counts()
    for K, c, d, nn, na in layers:
        p = 64
        table = torch.empty((1, p, na, c), dtype=BF16, device=meta,
                            requires_grad=True)
        W = torch.empty((K, c, d), dtype=BF16, device=meta,
                        requires_grad=True)
        out = ic.InterConvFn.apply(
            torch.empty((1, p, nn, 3), device=meta),
            torch.empty((1, p, nn), dtype=torch.int32, device=meta), table,
            torch.empty((na, K, 3), device=meta),
            torch.empty((K,), device=meta), W, 0.1)
        out.backward(torch.empty_like(out))
        assert W.grad.dtype == BF16 and W.grad.shape == (K, c, d)
    n = len(layers)
    assert ic.routes['dw_mma'] == n and ic.routes['dw'] == 0
    assert ic.launches['inter_conv_dw'] == n
    assert launched.count('epn_inter_conv_bwd_w_mma') == n
    assert 'epn_inter_conv_bwd_w' not in launched
    tkern.reset_counts()


@pytest.mark.parametrize('name,n_fused', [('cls_so3net_pn', 6),
                                          ('inv_so3net_pn', 3)])
def test_every_fused_dw_layer_takes_the_fp32_kernel(name, n_fused):
    """cls L1-L6 and inv B1L1, B2L1, B3L1: the fp32 dW on the CUDA-core
    kernel (``dw_f32_route``), bf16 on the tensor-core one."""
    layers = _fused_layers(name)
    assert len(layers) == n_fused
    ic = tkern.inter_conv
    for K, c, d, nn, na in layers:
        assert ic.dw_f32_route(torch.float32, K, c, d, nn, na), (c, d, nn)
        assert not ic.dw_f32_route(BF16, K, c, d, nn, na)


@pytest.mark.parametrize('K,c,d,nn,na', [(24, 40, 64, 16, 60),
                                         (24, 64, 96, 16, 60),
                                         (24, 64, 64, 65, 60),
                                         (24, 64, 64, 16, 12),
                                         (18, 64, 64, 16, 60)])
def test_dw_f32_shapes_off_the_envelope_take_the_template(K, c, d, nn, na):
    """Channels not a multiple of 16, d not a multiple of 64, more than 64
    neighbors, another group, another kernel size."""
    assert not tkern.inter_conv.dw_f32_route(torch.float32, K, c, d, nn, na)


@pytest.mark.parametrize('name', ['cls_so3net_pn', 'inv_so3net_pn'])
def test_fp32_backward_counts_the_fp32_dw(name, monkeypatch):
    """The fp32 (parity) InterConvFn forward and backward at every
    fused-route layer of the model (b = 1, 64 points) on the card branch:
    one 'dw_f32' and no 'dw' or 'dw_mma' a layer, launched through
    epn_inter_conv_bwd_w_f32, and the dW gradient in fp32."""
    launched = _card_shapes(monkeypatch)
    ic = tkern.inter_conv
    meta = torch.device('meta')
    layers = _fused_layers(name)
    tkern.reset_counts()
    for K, c, d, nn, na in layers:
        W = torch.empty((K, c, d), device=meta, requires_grad=True)
        out = ic.InterConvFn.apply(
            torch.empty((1, 64, nn, 3), device=meta),
            torch.empty((1, 64, nn), dtype=torch.int32, device=meta),
            torch.empty((1, 64, na, c), device=meta, requires_grad=True),
            torch.empty((na, K, 3), device=meta),
            torch.empty((K,), device=meta), W, 0.1)
        out.backward(torch.empty_like(out))
        assert W.grad.dtype == torch.float32 and W.grad.shape == (K, c, d)
    n = len(layers)
    assert (ic.routes['dw_f32'], ic.routes['dw'], ic.routes['dw_mma']) == \
        (n, 0, 0)
    assert ic.launches['inter_conv_dw'] == n
    assert launched.count('epn_inter_conv_bwd_w_f32') == n
    assert 'epn_inter_conv_bwd_w' not in launched
    tkern.reset_counts()


def test_reset_counts_clears_the_dw_routes():
    ic = tkern.inter_conv
    ic.routes['dw_mma'] += 3
    ic.routes['dw_f32'] += 2
    ic.routes['dw'] += 1
    tkern.reset_counts()
    assert ic.routes['dw_mma'] == ic.routes['dw_f32'] == ic.routes['dw'] == 0


def _composed_layers(name):
    """(K, c, d, nn, na) of every inter conv of the full-width model whose
    backward takes the composed route (the W-off F and dG)."""
    return [(K, c, d, nn, na) for entry, K, c, d, nn, na
            in _scatter_layers(name) if entry == 'dg']


@pytest.mark.parametrize('name,n_composed', [('cls_so3net_pn', 0),
                                             ('inv_so3net_pn', 4)])
def test_every_composed_layer_takes_the_tensor_core_f(name, n_composed):
    """inv B0L1, B1L0, B2L0 and B3L0 (the cls model composes none): the
    bf16 W-off F on tensor cores, fp32 on the template."""
    layers = _composed_layers(name)
    assert len(layers) == n_composed
    ic = tkern.inter_conv
    for K, c, d, nn, na in layers:
        assert ic.f_mma_route(BF16, K, c, nn, na), (c, nn)
        assert not ic.f_mma_route(torch.float32, K, c, nn, na)


@pytest.mark.parametrize('K,c,nn,na', [(24, 40, 32, 60), (24, 48, 64, 60),
                                       (24, 32, 65, 60), (24, 32, 32, 12),
                                       (18, 32, 32, 60), (24, 32, 0, 60)])
def test_f_shapes_off_the_envelope_take_the_template(K, c, nn, na):
    """Channels not a multiple of 32, more than 64 neighbors (or none),
    another group, another kernel size."""
    assert not tkern.inter_conv.f_mma_route(BF16, K, c, nn, na)


@pytest.mark.parametrize('name,n_composed', [('cls_so3net_pn', 0),
                                             ('inv_so3net_pn', 4)])
def test_every_composed_layer_takes_the_fp32_f(name, n_composed):
    """inv B0L1, B1L0, B2L0 and B3L0: the fp32 W-off F on its CUDA-core
    kernel, bf16 not."""
    layers = _composed_layers(name)
    assert len(layers) == n_composed
    ic = tkern.inter_conv
    for K, c, d, nn, na in layers:
        assert ic.f_f32_route(torch.float32, K, c, nn, na), (c, nn)
        assert not ic.f_f32_route(BF16, K, c, nn, na)


@pytest.mark.parametrize('K,c,nn,na', [(24, 24, 32, 60), (24, 40, 64, 60),
                                       (24, 32, 65, 60), (24, 32, 32, 12),
                                       (18, 32, 32, 60), (24, 32, 0, 60)])
def test_f_f32_shapes_off_the_envelope_take_the_template(K, c, nn, na):
    """fp32 channels not a multiple of 16, more than 64 neighbors (or
    none), another group, another kernel size."""
    assert not tkern.inter_conv.f_f32_route(torch.float32, K, c, nn, na)


def test_reset_counts_clears_the_f_routes():
    ic = tkern.inter_conv
    ic.routes['f_mma'] += 2
    ic.routes['f_f32'] += 3
    ic.routes['f'] += 1
    tkern.reset_counts()
    assert ic.routes['f_mma'] == ic.routes['f_f32'] == ic.routes['f'] == 0


@pytest.mark.parametrize('dtype,route,entry', [
    (BF16, 'f_mma', 'epn_inter_conv_f_mma'),
    (torch.float32, 'f_f32', 'epn_inter_conv_f_f32')])
def test_composed_backward_counts_the_f_kernel(dtype, route, entry,
                                               monkeypatch):
    """An InterConvFn forward and backward at every composed-route layer of
    the inv model (b = 1, 64 points) on the card branch: one W-off F a
    layer, on the tensor-core kernel in bf16 ('f_mma') and on the CUDA-core
    kernel in fp32 ('f_f32'), beside one W-off dG and no fused dTable or
    dW; the gradients in the table's and W's type."""
    launched = _card_shapes(monkeypatch)
    ic = tkern.inter_conv
    meta = torch.device('meta')
    layers = _composed_layers('inv_so3net_pn')
    tkern.reset_counts()
    for K, c, d, nn, na in layers:
        table = torch.empty((1, 64, na, c), dtype=dtype, device=meta,
                            requires_grad=True)
        W = torch.empty((K, c, d), dtype=dtype, device=meta,
                        requires_grad=True)
        out = ic.InterConvFn.apply(
            torch.empty((1, 64, nn, 3), device=meta),
            torch.empty((1, 64, nn), dtype=torch.int32, device=meta), table,
            torch.empty((na, K, 3), device=meta),
            torch.empty((K,), device=meta), W, 0.1)
        out.backward(torch.empty_like(out))
        assert table.grad.dtype == W.grad.dtype == dtype
        assert W.grad.shape == (K, c, d)
    n = len(layers)
    assert {k: ic.routes[k] for k in ('f_mma', 'f_f32', 'f')} == {
        k: n if k == route else 0 for k in ('f_mma', 'f_f32', 'f')}
    assert ic.launches['inter_conv_f'] == ic.launches['inter_conv_dg'] == n
    assert ic.launches['inter_conv_dtable'] == ic.launches['inter_conv_dw'] \
        == 0
    assert launched.count(entry) == n
    tkern.reset_counts()


@pytest.mark.parametrize('dtype,c,d,route', [(BF16, 64, 256, 'dw_mma'),
                                             (torch.float32, 64, 256,
                                              'dw_f32'),
                                             (torch.float32, 64, 128,
                                              'dw_f32'),
                                             (torch.float32, 40, 128, 'dw')])
def test_dw_launch_matches_its_entry_signature(dtype, c, d, route,
                                               monkeypatch):
    """The dW wrapper's card branch gives its C entry as many arguments as
    the entry's ctypes signature holds, and the fp32 kernel the d columns a
    block (``dw_f32_cols``) that its splits were sized for."""
    _card_shapes(monkeypatch)
    ic = tkern.inter_conv
    calls = []
    monkeypatch.setattr(ic.build, 'launch',
                        lambda name, *a: calls.append((name, a)))
    meta = torch.device('meta')
    b, p2, nn, q, na, K = 2, 64, 16, 128, 60, 24
    tkern.reset_counts()
    ic.inter_conv_dw(torch.empty((b, p2, nn, 3), device=meta),
                     torch.empty((b, p2, nn), dtype=torch.int32, device=meta),
                     torch.empty((b, q, na, c), dtype=dtype, device=meta),
                     torch.empty((na, K, 3), device=meta),
                     torch.empty((K,), device=meta),
                     torch.empty((b, p2, na, d), dtype=dtype, device=meta),
                     0.1)
    (name, args), = calls
    assert len(args) == len(ic.build.SIGNATURES[name])
    assert ic.routes[route] == 1
    if route == 'dw_f32':
        splits, bn = args[-3], args[-2]
        assert bn == ic.dw_f32_cols(d) == d
        assert splits == ic.dw_splits(b * p2 * na, c, d, 'dw_f32', bn)
    tkern.reset_counts()


@pytest.mark.parametrize('dtype,c,route', [(BF16, 32, 'f_mma'),
                                           (torch.float32, 32, 'f_f32'),
                                           (torch.float32, 48, 'f_f32'),
                                           (torch.float32, 40, 'f')])
def test_f_launch_matches_its_entry_signature(dtype, c, route, monkeypatch):
    """The W-off F wrapper's card branch gives its C entry as many
    arguments as the entry's ctypes signature holds, on each route."""
    _card_shapes(monkeypatch)
    ic = tkern.inter_conv
    calls = []
    monkeypatch.setattr(ic.build, 'launch',
                        lambda name, *a: calls.append((name, a)))
    meta = torch.device('meta')
    b, p2, nn, q, na, K = 2, 64, 32, 128, 60, 24
    tkern.reset_counts()
    F = ic.inter_conv_f(torch.empty((b, p2, nn, 3), device=meta),
                        torch.empty((b, p2, nn), dtype=torch.int32,
                                    device=meta),
                        torch.empty((b, q, na, c), dtype=dtype, device=meta),
                        torch.empty((na, K, 3), device=meta),
                        torch.empty((K,), device=meta), 0.1)
    (name, args), = calls
    assert len(args) == len(ic.build.SIGNATURES[name])
    assert ic.routes[route] == 1
    assert F.shape == (b, p2, na, K, c) and F.dtype == dtype
    tkern.reset_counts()


def test_variant_builds_substitute_text_in_the_source():
    """Each build of ``inter_conv_variants`` replaces text that
    csrc/inter_conv.cu holds (on the card a missing text fails the whole
    run); the fp32 W-off F's and the fp32 W-fused forward's builds text
    that it holds exactly once."""
    from epn_pointcloud_tpu_torch import inter_conv_variants as icv
    with open(icv.SOURCE_PATH) as f:
        src = f.read()
    for sub in (*icv.F32_VARIANTS.values(), *icv.FWD_F32_VARIANTS.values()):
        for old, _ in ([] if sub is None else
                       [sub] if isinstance(sub[0], str) else sub):
            assert src.count(old) == 1, old
    subs = [sub for table in (icv.VARIANTS, icv.F_VARIANTS, icv.F32_VARIANTS,
                              icv.FWD_F32_VARIANTS)
            for sub in table.values() if sub is not None]
    assert subs
    for sub in subs:
        for old, _ in ([sub] if isinstance(sub[0], str) else sub):
            assert old in src, old


def test_bwd_variant_builds_substitute_text_in_the_source():
    """Each build of ``inter_bwd_variants`` (the scatter's, the bf16 dW's,
    the fp32 dW template's and kernel's, the fp32 scatter template's and
    kernel's) replaces text that csrc/inter_conv_bwd.cu holds exactly
    once."""
    from epn_pointcloud_tpu_torch import inter_bwd_variants as ibv
    with open(ibv.SOURCE_PATH) as f:
        src = f.read()
    subs = [sub for table in (ibv.VARIANTS, ibv.DW_VARIANTS,
                              ibv.DW_F32_VARIANTS,
                              ibv.SCATTER_F32_VARIANTS)
            for sub in table.values() if sub is not None]
    assert len(subs) >= 20
    for sub in subs:
        for old, _ in ([sub] if isinstance(sub[0], str) else sub):
            assert src.count(old) == 1, old


@pytest.mark.parametrize('name,n_dtable,n_dg', [('cls_so3net_pn', 6, 0),
                                                ('inv_so3net_pn', 3, 4)])
def test_every_model_scatter_layer_takes_the_fp32_kernel(name, n_dtable,
                                                         n_dg):
    """cls L1-L6 (the fused dTable) and inv B1L1, B2L1, B3L1 (the fused
    dTable) and B0L1, B1L0, B2L0, B3L0 (the W-off dG): the fp32 scatter on
    the CUDA-core kernel (``bwd_f32_route``), bf16 on the tensor-core one."""
    layers = _scatter_layers(name)
    entries = [e for e, *_ in layers]
    assert (entries.count('dtable'), entries.count('dg')) == (n_dtable, n_dg)
    ic = tkern.inter_conv
    for entry, K, c, d, nn, na in layers:
        dd = d if entry == 'dtable' else None
        assert ic.bwd_f32_route(torch.float32, K, c, nn, na, dd), (entry, c,
                                                                    d, nn)
        assert not ic.bwd_f32_route(BF16, K, c, nn, na, dd)


@pytest.mark.parametrize('K,c,nn,na,d', [(24, 40, 16, 60, 64),
                                         (24, 40, 32, 60, None),
                                         (24, 64, 65, 60, 64),
                                         (24, 64, 16, 12, 64),
                                         (18, 64, 16, 60, None),
                                         (24, 64, 0, 60, None),
                                         (24, 64, 16, 60, 40)])
def test_scatter_f32_shapes_off_the_envelope_take_the_template(K, c, nn, na,
                                                              d):
    """Channels not a multiple of 16, more than 64 neighbors (or none),
    another group, another kernel size, a fused d not a multiple of 16."""
    assert not tkern.inter_conv.bwd_f32_route(torch.float32, K, c, nn, na, d)


def test_reset_counts_clears_the_scatter_f32_routes():
    ic = tkern.inter_conv
    ic.routes['dtable_f32'] += 2
    ic.routes['dg_f32'] += 1
    tkern.reset_counts()
    assert ic.routes['dtable_f32'] == ic.routes['dg_f32'] == 0


@pytest.mark.parametrize('name', ['cls_so3net_pn', 'inv_so3net_pn'])
def test_fp32_backward_counts_the_fp32_scatter(name, monkeypatch):
    """The fp32 (parity) InterConvFn forward and backward at every layer
    with a table gradient (b = 1, 64 points) on the card branch: one
    'dtable_f32' (fused route) or 'dg_f32' (composed route) a layer and no
    template or tensor-core scatter, launched through
    epn_inter_conv_bwd_table_f32 / epn_inter_conv_dg_f32, and the table
    gradient in fp32."""
    launched = _card_shapes(monkeypatch)
    ic = tkern.inter_conv
    meta = torch.device('meta')
    layers = _scatter_layers(name)
    tkern.reset_counts()
    for entry, K, c, d, nn, na in layers:
        table = torch.empty((1, 64, na, c), device=meta, requires_grad=True)
        out = ic.InterConvFn.apply(
            torch.empty((1, 64, nn, 3), device=meta),
            torch.empty((1, 64, nn), dtype=torch.int32, device=meta), table,
            torch.empty((na, K, 3), device=meta),
            torch.empty((K,), device=meta),
            torch.empty((K, c, d), device=meta, requires_grad=True), 0.1)
        out.backward(torch.empty_like(out))
        assert table.grad.dtype == torch.float32
        assert table.grad.shape == (1, 64, na, c)
    n_dtable = sum(e == 'dtable' for e, *_ in layers)
    n_dg = len(layers) - n_dtable
    assert (ic.routes['dtable_f32'], ic.routes['dg_f32']) == (n_dtable, n_dg)
    assert ic.routes['dtable'] == ic.routes['dg'] == 0
    assert ic.routes['dtable_mma'] == ic.routes['dg_mma'] == 0
    assert ic.launches['inter_conv_dtable'] == n_dtable
    assert ic.launches['inter_conv_dg'] == n_dg
    assert launched.count('epn_inter_conv_bwd_table_f32') == n_dtable
    assert launched.count('epn_inter_conv_dg_f32') == n_dg
    assert 'epn_inter_conv_bwd_table' not in launched
    assert 'epn_inter_conv_dg' not in launched
    tkern.reset_counts()


@pytest.mark.parametrize('entry,dtype,c,route', [
    ('dtable', torch.float32, 64, 'dtable_f32'),
    ('dtable', torch.float32, 40, 'dtable'),
    ('dtable', BF16, 64, 'dtable_mma'),
    ('dg', torch.float32, 32, 'dg_f32'),
    ('dg', torch.float32, 40, 'dg'),
    ('dg', BF16, 32, 'dg_mma')])
def test_scatter_launch_matches_its_entry_signature(entry, dtype, c, route,
                                                    monkeypatch):
    """The scatter wrappers' card branch gives each C entry as many
    arguments as the entry's ctypes signature holds (the fp32 fused entry
    a W^T workspace of W's size, last before the stream)."""
    _card_shapes(monkeypatch)
    ic = tkern.inter_conv
    calls = []
    monkeypatch.setattr(ic.build, 'launch',
                        lambda name, *a: calls.append((name, a)))
    meta = torch.device('meta')
    b, p2, nn, q, na, K, d = 2, 64, 16, 128, 60, 24, 64
    ops = (torch.empty((b, p2, nn, 3), device=meta),
           torch.empty((b, p2, nn), dtype=torch.int32, device=meta), q,
           torch.empty((na, K, 3), device=meta),
           torch.empty((K,), device=meta))
    tkern.reset_counts()
    if entry == 'dtable':
        ic.inter_conv_dtable(*ops, torch.empty((K, c, d), dtype=dtype,
                                               device=meta),
                             torch.empty((b, p2, na, d), dtype=dtype,
                                         device=meta), 0.1)
    else:
        ic.inter_conv_dg(*ops, torch.empty((b, p2, na, K, c), dtype=dtype,
                                           device=meta), 0.1)
    (name, args), = calls
    assert len(args) == len(ic.build.SIGNATURES[name])
    assert ic.routes[route] == 1
    tkern.reset_counts()


def _forward_layers(name):
    """(K, c, d, nn, na) of every W-fused inter forward of the full-width
    model with a feature table (layer 0's ones input runs the ones conv)."""
    return [(K, c, d, nn, na) for _, K, c, d, nn, na in _scatter_layers(name)]


@pytest.mark.parametrize('name,n_layers', [('cls_so3net_pn', 6),
                                           ('inv_so3net_pn', 7)])
def test_every_forward_layer_takes_the_fp32_kernel(name, n_layers):
    """cls L1-L6 (c 64-256, d 64-256, nn 16 / 32) and inv B0L1-B3L1 (c
    32-128, d 32-128, nn 32 / 64, B0L1's c = d = 32): the fp32 forward on
    its CUDA-core kernel (``fwd_f32_route``), never the tensor-core one;
    bf16 on the tensor-core kernel, never the fp32 one."""
    layers = _forward_layers(name)
    assert len(layers) == n_layers
    ic = tkern.inter_conv
    for K, c, d, nn, na in layers:
        assert ic.fwd_f32_route(torch.float32, K, c, d, nn, na), (c, d, nn)
        assert not ic.mma_route(torch.float32, K, c, d, nn, na)
        assert not ic.fwd_f32_route(BF16, K, c, d, nn, na)
        assert ic.mma_route(BF16, K, c, d, nn, na)


@pytest.mark.parametrize('K,c,d,nn,na', [(24, 40, 64, 16, 60),
                                         (24, 24, 32, 16, 60),
                                         (24, 64, 48, 16, 60),
                                         (24, 64, 64, 16, 12),
                                         (24, 64, 64, 65, 60),
                                         (24, 64, 64, 0, 60),
                                         (18, 64, 64, 16, 60)])
def test_fwd_f32_shapes_off_the_envelope_take_the_template(K, c, d, nn, na):
    """Channels not a multiple of 16, d not a multiple of 32, another group,
    more than 64 neighbors (or none), another kernel size."""
    assert not tkern.inter_conv.fwd_f32_route(torch.float32, K, c, d, nn, na)


def test_reset_counts_clears_the_forward_routes():
    ic = tkern.inter_conv
    ic.routes['fwd_f32'] += 2
    ic.routes['sgemm'] += 1
    ic.routes['mma'] += 3
    tkern.reset_counts()
    assert ic.routes['fwd_f32'] == ic.routes['sgemm'] == ic.routes['mma'] == 0


@pytest.mark.parametrize('name', ['cls_so3net_pn', 'inv_so3net_pn'])
@pytest.mark.parametrize('dtype,route,entry', [
    (torch.float32, 'fwd_f32', 'epn_inter_conv_fwd_f32'),
    (BF16, 'mma', 'epn_inter_conv_mma')])
def test_forward_counts_the_kernel_of_its_dtype(name, dtype, route, entry,
                                                monkeypatch):
    """An InterConvFn forward at every layer of the model (b = 1, 64
    points) on the card branch: one launch a layer on the CUDA-core kernel
    in fp32 ('fwd_f32') and the tensor-core kernel in bf16 ('mma'), none on
    the SGEMM template ('sgemm'), through the route's C entry; the output
    in the table's type."""
    launched = _card_shapes(monkeypatch)
    ic = tkern.inter_conv
    meta = torch.device('meta')
    layers = _forward_layers(name)
    tkern.reset_counts()
    for K, c, d, nn, na in layers:
        out = ic.InterConvFn.apply(
            torch.empty((1, 64, nn, 3), device=meta),
            torch.empty((1, 64, nn), dtype=torch.int32, device=meta),
            torch.empty((1, 64, na, c), dtype=dtype, device=meta),
            torch.empty((na, K, 3), device=meta),
            torch.empty((K,), device=meta),
            torch.empty((K, c, d), dtype=dtype, device=meta), 0.1)
        assert out.dtype == dtype and out.shape == (1, 64, na, d)
    n = len(layers)
    assert {k: ic.routes[k] for k in ('mma', 'fwd_f32', 'sgemm')} == {
        k: n if k == route else 0 for k in ('mma', 'fwd_f32', 'sgemm')}
    assert ic.launches['inter_conv'] == n
    assert launched == [entry] * n
    tkern.reset_counts()


@pytest.mark.parametrize('dtype,c,d,route', [
    (torch.float32, 64, 256, 'fwd_f32'),
    (torch.float32, 32, 96, 'fwd_f32'),
    (torch.float32, 40, 64, 'sgemm'),
    (BF16, 64, 64, 'mma')])
def test_forward_launch_matches_its_entry_signature(dtype, c, d, route,
                                                    monkeypatch):
    """The forward wrapper's card branch gives its C entry as many
    arguments as the entry's ctypes signature holds, on each route."""
    _card_shapes(monkeypatch)
    ic = tkern.inter_conv
    calls = []
    monkeypatch.setattr(ic.build, 'launch',
                        lambda name, *a: calls.append((name, a)))
    meta = torch.device('meta')
    b, p2, nn, q, na, K = 2, 64, 16, 128, 60, 24
    tkern.reset_counts()
    out = ic.inter_conv(torch.empty((b, p2, nn, 3), device=meta),
                        torch.empty((b, p2, nn), dtype=torch.int32,
                                    device=meta),
                        torch.empty((b, q, na, c), dtype=dtype, device=meta),
                        torch.empty((na, K, 3), device=meta),
                        torch.empty((K,), device=meta),
                        torch.empty((K, c, d), dtype=dtype, device=meta), 0.1)
    (name, args), = calls
    assert len(args) == len(ic.build.SIGNATURES[name])
    assert ic.routes[route] == 1
    assert out.shape == (b, p2, na, d) and out.dtype == dtype
    tkern.reset_counts()
