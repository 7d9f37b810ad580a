"""Which kernel the bf16 intra conv wrappers launch on the card, decided on
the CPU: every intra layer of both models' full-width builds (the bf16
forward and B6 df) goes to the tensor-core kernel (``mma_route``), fp32
and the shapes off its envelope to the SGEMM, and B6 df's workspace
follows the tensor-core kernel's blocks; the bf16 dW (plain and prenorm)
goes to its tensor-core kernel (``dw_mma_route``) at every model layer,
its row splits are whole point groups, and a bf16 backward reaching the
wrappers' card branch (tensors on the meta device, the launches recorded)
counts it; the fp32 dW of the plain form goes to its CUDA-core kernel
(``dw_f32_route``) at every model layer, its splits are whole points
filling one or two waves, and its launch carries its C entry's arguments;
so do the fp32 forward and df (``fwd_f32_route``). The builds of
``intra_conv_variants`` replace text that the source holds.
The kernels themselves are held against their plain versions
on the card (tests/test_torch_port_gpu.py); the plain versions against
the JAX package in tests/test_torch_port_bf16*.py.
"""

import pytest
import torch

from epn_pointcloud_tpu_torch import models, run_3dmatch
from epn_pointcloud_tpu_torch.app import config
from epn_pointcloud_tpu_torch.nn.layers import IntraSO3Conv
from epn_pointcloud_tpu_torch.ops import kernels as tkern

BF16 = torch.bfloat16


def _opt(name):
    opt = config.parse_args(['experiment', '-d', 'unused'])
    if name == 'inv_so3net_pn':
        return run_3dmatch.config_opt_3dmatch(opt)
    opt.model.model = name
    opt.model.flag = 'attention'
    return opt


def _intra_layers(name):
    """(na, K, c, d) of every intra conv of the full-width model."""
    model = models.build_model_from(_opt(name), seed=0)
    return [(m.trace_idx.shape[0], m.basic_conv.n_kernel,
             m.basic_conv.dim_in, m.basic_conv.dim_out)
            for m in model.modules() if isinstance(m, IntraSO3Conv)]


@pytest.mark.parametrize('name,n_layers', [('cls_so3net_pn', 7),
                                           ('inv_so3net_pn', 8)])
def test_every_model_intra_layer_takes_the_tensor_core_kernel(name,
                                                              n_layers):
    layers = _intra_layers(name)
    assert len(layers) == n_layers
    ik = tkern.intra_conv
    for na, K, c, d in layers:
        assert ik.mma_route(BF16, na, K, c, d), (na, K, c, d)
        assert not ik.mma_route(torch.float32, na, K, c, d)


@pytest.mark.parametrize('na,K,c,d', [(60, 12, 64, 96), (60, 12, 96, 96),
                                      (60, 12, 512, 512), (12, 12, 64, 64),
                                      (60, 6, 64, 64)])
def test_shapes_off_the_envelope_take_the_sgemm(na, K, c, d):
    """c != d, a width no model layer has, another group or kernel size."""
    assert not tkern.intra_conv.mma_route(BF16, na, K, c, d)


@pytest.mark.parametrize('d,points', [(32, 16), (64, 8), (96, 16),
                                      (128, 4), (256, 4)])
def test_block_points_follow_the_column_tile(d, points):
    """A tensor-core block owns 512 / BN whole points, BN the widest of
    128, 64, 32 that divides d: 30720 accumulators a block at every BN."""
    assert tkern.intra_conv.mma_block_points(d) == points
    bn = 128 if d % 128 == 0 else 64 if d % 64 == 0 else 32
    assert points * 60 * bn == 30720


def test_reset_counts_clears_the_routes():
    tkern.intra_conv.routes['mma'] += 3
    tkern.inter_conv.routes['sgemm'] += 2
    tkern.reset_counts()
    assert set(tkern.intra_conv.routes.values()) == {0}
    assert set(tkern.inter_conv.routes.values()) == {0}


@pytest.mark.parametrize('name', ['cls_so3net_pn', 'inv_so3net_pn'])
def test_every_model_intra_layer_takes_the_tensor_core_dw(name):
    ik = tkern.intra_conv
    for na, K, c, d in _intra_layers(name):
        assert ik.dw_mma_route(BF16, na, K, c, d), (na, K, c, d)
        assert not ik.dw_mma_route(torch.float32, na, K, c, d)


@pytest.mark.parametrize('na,K,c,d', [(60, 12, 64, 96), (60, 12, 96, 96),
                                      (60, 12, 512, 512), (12, 12, 64, 64),
                                      (60, 6, 64, 64), (60, 12, 16, 16)])
def test_dw_shapes_off_the_envelope_take_the_sgemm(na, K, c, d):
    """c != d, widths no model layer has, another group or kernel size."""
    assert not tkern.intra_conv.dw_mma_route(BF16, na, K, c, d)


# (points b * p, c = d): cls b=12 L0 / L2 / L4 / L6, inv b=16 B0-B3, and
# point counts that leave the last group short or make fewer groups than
# the blocks would take
DW_SPLIT_CASES = [(6144, 64), (3072, 128), (1536, 256), (768, 256),
                  (8192, 32), (4096, 64), (2048, 128), (1024, 128),
                  (1024, 256), (14, 64), (39, 128), (1, 256), (42, 32)]


@pytest.mark.parametrize('n_points,c', DW_SPLIT_CASES)
def test_dw_splits_cut_whole_point_groups(n_points, c):
    """The tensor-core dW's splits: whole groups of DW_MMA_NP points (a
    multiple of 480 rows), every split holding at least one live row, the
    splits covering every row, and at most DW_MMA_BLOCKS blocks but no
    fewer than half of them (never more than one split a group); the
    workspace [splits, K, c, d] then holds one partial a split. The SGEMM's: whole 16-row slices, covering every
    row (a trailing split may hold none: it writes a zero partial)."""
    ik = tkern.intra_conv
    na, K, rows = 60, 12, n_points * 60
    splits, per = ik.dw_splits(n_points, na, K, c, c, True)
    assert per % (ik.DW_MMA_NP * na) == 0 and per > 0
    assert (splits - 1) * per < rows <= splits * per
    groups = -(-n_points // ik.DW_MMA_NP)
    tiles = (c // ik.DW_MMA_CB) * (c // (64 if c % 64 == 0 else 32))
    assert 1 <= splits <= groups
    assert splits * tiles >= min(ik.DW_MMA_BLOCKS, groups * tiles) // 2
    assert splits * tiles <= max(ik.DW_MMA_BLOCKS, tiles)
    s_sgemm, per_sgemm = ik.dw_splits(n_points, na, K, c, c, False)
    assert per_sgemm % 16 == 0
    assert rows <= s_sgemm * per_sgemm


def _card_branch(monkeypatch):
    """Let the intra wrappers take their card branch on meta tensors: the
    device and operand checks skipped, each launch recorded by its C
    entry's name."""
    ik = tkern.intra_conv
    launched = []
    monkeypatch.setattr(ik, '_check_operands', lambda *a: None)
    monkeypatch.setattr(ik.build, 'launch', lambda name, *a: launched.append(
        name))
    monkeypatch.setattr(ik.build, 'stream', lambda t: 0)
    return launched


def _meta_backward(na, K, c, d, dtype, prenorm, b=2, p=16):
    """One IntraConvPrenormFn (or IntraConvFn) forward and backward on meta
    tensors; returns W's gradient."""
    ik = tkern.intra_conv
    meta = torch.device('meta')
    f = torch.empty((b, p, na, c), dtype=dtype, device=meta,
                    requires_grad=True)
    W = torch.empty((K, c, d), dtype=dtype, device=meta, requires_grad=True)
    ti = torch.empty((na, K), dtype=torch.int32, device=meta)
    if prenorm:
        ss = torch.empty((1, 2, na * c), device=meta)
        out = ik.IntraConvPrenormFn.apply(f, ss, ti, ti, W)
    else:
        out = ik.IntraConvFn.apply(f, ti, ti, W)
    out.backward(torch.empty_like(out))
    return W.grad


@pytest.mark.parametrize('name', ['cls_so3net_pn', 'inv_so3net_pn'])
def test_bf16_backward_counts_the_tensor_core_dw(name, monkeypatch):
    """A bf16 prenorm backward at every intra layer of the model (b = 2, 16
    points) on the card branch: one 'dw_mma' and no 'dw' a layer, launched
    through epn_intra_conv_bwd_w_mma, and the dW gradient in W's bf16; the
    plain form's bf16 backward too."""
    launched = _card_branch(monkeypatch)
    ik = tkern.intra_conv
    layers = _intra_layers(name)
    tkern.reset_counts()
    for na, K, c, d in layers:
        g = _meta_backward(na, K, c, d, BF16, True)
        assert g.dtype == BF16 and g.shape == (K, c, d)
    n = len(layers)
    assert ik.routes['dw_mma'] == n and ik.routes['dw'] == 0
    assert ik.launches['intra_conv_prenorm_dw'] == n
    assert launched.count('epn_intra_conv_bwd_w_mma') == n
    assert 'epn_intra_conv_bwd_w' not in launched
    _meta_backward(*layers[0], BF16, False)
    assert ik.routes['dw_mma'] == n + 1 and ik.launches['intra_conv_dw'] == 1
    tkern.reset_counts()


@pytest.mark.parametrize('prenorm', [True, False])
def test_fp32_backward_counts_the_sgemm_dw(prenorm, monkeypatch):
    """The fp32 (parity) backward at cls L0: the prenorm form keeps the
    SGEMM ('dw', epn_intra_conv_bwd_w); the plain form's dW runs its
    CUDA-core kernel ('dw_f32', epn_intra_conv_bwd_w_f32)."""
    launched = _card_branch(monkeypatch)
    ik = tkern.intra_conv
    tkern.reset_counts()
    _meta_backward(*_intra_layers('cls_so3net_pn')[0], torch.float32,
                   prenorm)
    want = (1, 0) if prenorm else (0, 1)
    assert (ik.routes['dw'], ik.routes['dw_f32']) == want
    assert ik.routes['dw_mma'] == 0
    assert launched.count('epn_intra_conv_bwd_w') == want[0]
    assert launched.count('epn_intra_conv_bwd_w_f32') == want[1]
    assert 'epn_intra_conv_bwd_w_mma' not in launched
    tkern.reset_counts()


def test_reset_counts_clears_the_dw_routes():
    ik = tkern.intra_conv
    ik.routes['dw_mma'] += 3
    ik.routes['dw_f32'] += 2
    ik.routes['dw'] += 1
    tkern.reset_counts()
    assert ik.routes['dw_mma'] == ik.routes['dw_f32'] == ik.routes['dw'] == 0


@pytest.mark.parametrize('name', ['cls_so3net_pn', 'inv_so3net_pn'])
def test_every_model_intra_layer_takes_the_fp32_dw(name):
    """Every intra layer of both full-width models runs its fp32 dW on the
    CUDA-core kernel in the plain form; not in bf16 (the tensor-core dW)
    and not in the prenorm form (the SGEMM)."""
    ik = tkern.intra_conv
    for na, K, c, d in _intra_layers(name):
        assert ik.dw_f32_route(torch.float32, na, K, c, d), (na, K, c, d)
        assert not ik.dw_f32_route(BF16, na, K, c, d)
        assert not ik.dw_f32_route(torch.float32, na, K, c, d, prenorm=True)


@pytest.mark.parametrize('na,K,c,d,holds', [
    (60, 12, 36, 64, False), (60, 12, 64, 80, False), (12, 12, 64, 64, False),
    (60, 6, 64, 64, False), (60, 12, 64, 128, True), (60, 12, 64, 96, True),
    (60, 12, 512, 512, True)])
def test_dw_f32_route_envelope(na, K, c, d, holds):
    """The fp32 CUDA-core dW's envelope: na 60, K 12, c and d multiples of
    32 (c != d and widths no model layer has included); channels or columns
    off the 32 grid, another group or kernel size take the SGEMM."""
    assert tkern.intra_conv.dw_f32_route(torch.float32, na, K, c, d) == holds


@pytest.mark.parametrize('n_points,c', DW_SPLIT_CASES)
def test_dw_f32_splits_cut_whole_points(n_points, c):
    """The fp32 CUDA-core dW's splits: whole points (a multiple of 60 rows),
    every split holding at least one point, the splits covering every
    row, at most two waves of DW_F32_WAVE blocks (one a split, if a tile
    alone fills them), and at every model layer (768 points or more) the
    blocks fill their waves to at least 95%."""
    ik = tkern.intra_conv
    na, rows = 60, n_points * 60
    splits, per = ik.dw_f32_splits(n_points, na, c, c)
    assert per % na == 0 and per > 0
    assert (splits - 1) * per < rows <= splits * per
    tiles = (c // ik.DW_F32_CB) * (c // ik.DW_F32_BN)
    blocks = splits * tiles
    assert splits == 1 or blocks <= 2 * ik.DW_F32_WAVE
    waves = -(-blocks // ik.DW_F32_WAVE)
    if n_points >= 768:
        assert blocks >= 0.95 * waves * ik.DW_F32_WAVE, (splits, blocks)


def test_dw_f32_splits_bound_the_chain():
    """No split of the fp32 CUDA-core dW adds more than DW_F32_MAX_PTS
    points in one chain at any model layer (cls b=12, inv b=16 a leg, reg
    b=8 pairs); reg's 256-wide layer at 64 points takes two waves (one would
    give 171 points a split), the cls and inv layers keep their splits."""
    ik = tkern.intra_conv
    for n_points, c in DW_SPLIT_CASES[:9]:
        splits, rows = ik.dw_f32_splits(n_points, 60, c, c)
        assert rows <= ik.DW_F32_MAX_PTS * 60, (n_points, c, rows)
    assert ik.dw_f32_splits(1024, 60, 256, 256) == (12, 86 * 60)
    assert ik.dw_f32_splits(1536, 60, 256, 256) == (12, 128 * 60)


@pytest.mark.parametrize('dtype,c,d,prenorm,route', [
    (torch.float32, 64, 64, False, 'dw_f32'),
    (torch.float32, 64, 128, False, 'dw_f32'),
    (torch.float32, 32, 32, False, 'dw_f32'),
    (torch.float32, 64, 64, True, 'dw'), (torch.float32, 36, 64, False, 'dw'),
    (BF16, 64, 64, False, 'dw_mma')])
def test_dw_launch_matches_its_entry_signature(dtype, c, d, prenorm, route,
                                               monkeypatch):
    """The intra dW wrapper's card branch gives its C entry as many
    arguments as the entry's ctypes signature holds, on each route, and
    the fp32 CUDA-core kernel the splits and rows ``dw_f32_splits`` gives
    (no fold: a null ss)."""
    ik = tkern.intra_conv
    monkeypatch.setattr(ik, '_check_operands', lambda *a: None)
    monkeypatch.setattr(ik.build, 'stream', lambda t: 0)
    calls = []
    monkeypatch.setattr(ik.build, 'launch',
                        lambda name, *a: calls.append((name, a)))
    meta = torch.device('meta')
    b, p, na, K = 2, 16, 60, 12
    f = torch.empty((b, p, na, c), dtype=dtype, device=meta)
    ti = torch.empty((na, K), dtype=torch.int32, device=meta)
    dout = torch.empty((b, p, na, d), dtype=dtype, device=meta)
    tkern.reset_counts()
    if prenorm:
        ik.intra_conv_prenorm_dw(f, torch.empty((1, 2, na * c), device=meta),
                                 ti, dout)
    else:
        ik.intra_conv_dw(f, ti, dout)
    (name, args), = calls
    assert len(args) == len(ik.build.SIGNATURES[name])
    assert ik.routes[route] == 1 and sum(ik.routes.values()) == 1
    if route == 'dw_f32':
        assert name == 'epn_intra_conv_bwd_w_f32' and args[2] == 0
        assert (args[-3], args[-2]) == ik.dw_f32_splits(b * p, na, c, d)
    tkern.reset_counts()


@pytest.mark.parametrize('name', ['cls_so3net_pn', 'inv_so3net_pn'])
def test_every_model_intra_layer_takes_the_fp32_forward(name, monkeypatch):
    """Every intra layer of both full-width models runs its fp32 forward
    and its df (the forward on the inverse adjacency, c and d swapped) on
    the CUDA-core kernel in the plain form; an fp32 backward on the card
    branch (meta tensors) at every layer counts two 'fwd_f32' launches and
    no 'sgemm', through epn_intra_conv_f32."""
    ik = tkern.intra_conv
    layers = _intra_layers(name)
    for na, K, c, d in layers:
        assert ik.fwd_f32_route(torch.float32, na, K, c, d), (na, K, c, d)
        assert ik.fwd_f32_route(torch.float32, na, K, d, c), (na, K, d, c)
    launched = _card_branch(monkeypatch)
    tkern.reset_counts()
    for layer in layers:
        _meta_backward(*layer, torch.float32, False)
    n = len(layers)
    assert (ik.routes['fwd_f32'], ik.routes['sgemm'], ik.routes['mma']) == \
        (2 * n, 0, 0)
    assert launched.count('epn_intra_conv_f32') == 2 * n
    assert 'epn_intra_conv' not in launched
    tkern.reset_counts()


@pytest.mark.parametrize('dtype,na,K,c,d,prenorm,holds', [
    (torch.float32, 60, 12, 64, 64, False, True),
    (torch.float32, 60, 12, 64, 96, False, True),     # c != d
    (torch.float32, 60, 12, 512, 512, False, True),   # no model width
    (torch.float32, 60, 12, 64, 64, True, False),     # the prenorm form
    (BF16, 60, 12, 64, 64, False, False),             # bf16: mma_route
    (torch.float32, 12, 12, 64, 64, False, False),    # another group
    (torch.float32, 60, 6, 64, 64, False, False),     # another kernel size
    (torch.float32, 60, 12, 36, 64, False, False),    # c off the 32 grid
    (torch.float32, 60, 12, 64, 80, False, False)])   # d off the 32 grid
def test_fwd_f32_route_envelope(dtype, na, K, c, d, prenorm, holds):
    """The fp32 CUDA-core forward's envelope: fp32, the plain form, na 60,
    K 12, c and d multiples of 32; the prenorm form and the shapes off it
    take the SGEMM, bf16 the tensor-core kernel or the SGEMM."""
    assert tkern.intra_conv.fwd_f32_route(dtype, na, K, c, d,
                                          prenorm) == holds


@pytest.mark.parametrize('dtype,c,d,prenorm,route', [
    (torch.float32, 64, 64, False, 'fwd_f32'),
    (torch.float32, 32, 96, False, 'fwd_f32'),
    (torch.float32, 64, 64, True, 'sgemm'),
    (torch.float32, 36, 64, False, 'sgemm'),
    (BF16, 64, 64, False, 'mma')])
def test_fwd_launch_matches_its_entry_signature(dtype, c, d, prenorm, route,
                                                monkeypatch):
    """The intra forward wrapper's card branch gives its C entry as many
    arguments as the entry's ctypes signature holds, on each route; the
    fp32 CUDA-core kernel gets no fold (a null ss) and the shapes."""
    ik = tkern.intra_conv
    monkeypatch.setattr(ik, '_check_operands', lambda *a: None)
    monkeypatch.setattr(ik.build, 'stream', lambda t: 0)
    calls = []
    monkeypatch.setattr(ik.build, 'launch',
                        lambda name, *a: calls.append((name, a)))
    meta = torch.device('meta')
    b, p, na, K = 2, 16, 60, 12
    f = torch.empty((b, p, na, c), dtype=dtype, device=meta)
    ti = torch.empty((na, K), dtype=torch.int32, device=meta)
    W = torch.empty((K, c, d), dtype=dtype, device=meta)
    tkern.reset_counts()
    if prenorm:
        ik.intra_conv_prenorm(f, torch.empty((1, 2, na * c), device=meta), ti,
                              W)
    else:
        ik.intra_conv(f, ti, W)
    (name, args), = calls
    assert len(args) == len(ik.build.SIGNATURES[name])
    assert ik.routes[route] == 1 and sum(ik.routes.values()) == 1
    if route == 'fwd_f32':
        assert name == 'epn_intra_conv_f32' and args[3] == 0
        assert args[5:11] == (b, p, na, K, c, d)
    tkern.reset_counts()


def test_reset_counts_clears_the_fwd_f32_route():
    ik = tkern.intra_conv
    ik.routes['fwd_f32'] += 4
    tkern.reset_counts()
    assert ik.routes['fwd_f32'] == 0


@pytest.mark.parametrize('table', ['VARIANTS', 'DW_VARIANTS', 'F32_VARIANTS',
                                   'FWD_F32_VARIANTS'])
def test_variant_builds_substitute_text_in_the_source(table):
    """Each build of ``intra_conv_variants`` replaces text that
    csrc/intra_conv.cu holds exactly once (on the card a missing text fails
    the whole run), but the SGEMM's FMA line, which intra_dw_kernel holds
    too: twice."""
    import os
    from epn_pointcloud_tpu_torch import intra_conv_variants as icv
    with open(os.path.join(icv.build.CSRC_DIR, 'intra_conv.cu')) as f:
        src = f.read()
    subs = [sub for sub in getattr(icv, table).values() if sub is not None]
    assert subs
    for sub in subs:
        for old, _ in ([sub] if isinstance(sub[0], str) else sub):
            assert src.count(old) == (2 if old == icv._SGEMM_FMA else 1), old
