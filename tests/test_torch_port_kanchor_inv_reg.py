"""inv_so3net_pn and reg_so3net below 60 anchors (kanchor 20 and 40, and the
KPConv baseline ``kpconv``: one anchor), and the bf16 train step below 60
anchors, in the torch port against the JAX package on the CPU.

Small models (two blocks of narrow layers; the inv model's composed
backward at its 32-wide layers and its fused one at the 64-wide, reg's
composed at its 32-wide) on clouds of 256 points; the port takes the JAX
package's weights through ``from_jax_variables`` (key for key on the inv
and reg trees of ``inter_block`` layers). Held to the JAX package: the
builders' parameter trees, the fp32 forward (rtol 1e-3, atol 2e-3), the
fp32 step's loss (rtol 1e-5) and per-leaf gradients (the rule of
tests/test_reference_train_parity.py:143-209), the bf16 forward (cosine
>= 0.999 to the JAX bf16 forward; inv at kanchor 20 also bf16 vs fp32 >=
0.95, the bound of tests/test_dtype_agreement.py), the bf16 step of cls and
inv at kanchor 20 by the noise-floor rule, the InstanceNorm over na groups
(packed at na > 1, unpacked at one anchor), the three heads, the alignment
loss and the alignment loader's labels at kanchor 20 / 40 under both anchor
conventions.
"""

import copy
import statistics

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epn_pointcloud_tpu import compat as jcompat
from epn_pointcloud_tpu import losses as jlosses
from epn_pointcloud_tpu.app import config as jconfig
from epn_pointcloud_tpu.data import modelnet40 as jmn
from epn_pointcloud_tpu.models import cls_so3net_pn as jcls
from epn_pointcloud_tpu.models import inv_so3net_pn as jinv
from epn_pointcloud_tpu.models import reg_so3net as jreg
from epn_pointcloud_tpu.nn import heads as jheads
from epn_pointcloud_tpu.nn import layers as jlayers
from epn_pointcloud_tpu.ops import icosahedron as jico
from epn_pointcloud_tpu.ops import rotation as jrot
from epn_pointcloud_tpu.ops import so3conv as jso3

from epn_pointcloud_tpu_torch import compat as tcompat
from epn_pointcloud_tpu_torch import losses as tlosses
from epn_pointcloud_tpu_torch.app import config as tconfig
from epn_pointcloud_tpu_torch.data import modelnet40 as tmn
from epn_pointcloud_tpu_torch.data import synthetic as tsynth
from epn_pointcloud_tpu_torch.models import cls_so3net_pn as tcls
from epn_pointcloud_tpu_torch.models import inv_so3net_pn as tinv
from epn_pointcloud_tpu_torch.models import reg_so3net as treg
from epn_pointcloud_tpu_torch.nn import heads as theads
from epn_pointcloud_tpu_torch.nn import layers as tlayers
from epn_pointcloud_tpu_torch.ops import icosahedron as tico
from epn_pointcloud_tpu_torch.ops import kernels as tkern
from epn_pointcloud_tpu_torch.ops import so3conv as tso3

N_POINTS = 256
# (kanchor, kpconv)
ANCHORS = {'ka20': (20, False), 'ka40': (40, False), 'kpconv': (60, True)}
SMALL = {'inv': dict(mlps=((32, 32), (64, 64)), out_mlps=(64, 32)),
         'reg': dict(mlps=((32, 32), (64,)), out_mlps=(64, 32)),
         'cls': dict(mlps=((32, 32), (64,)), out_mlps=(64,))}
JBUILD = {'inv': jinv.build_model, 'reg': jreg.build_model,
          'cls': jcls.build_model}
TBUILD = {'inv': tinv.build_model, 'reg': treg.build_model,
          'cls': tcls.build_model}
MODEL = {'inv': 'inv_so3net_pn', 'reg': 'reg_so3net', 'cls': 'cls_so3net_pn'}


def _opt(kind, anchors):
    # the inv builder scales block 0 layer 0's neighbors by
    # int(input_num / 1024), so it keeps the 1024 of its configuration (the
    # clouds stay N_POINTS)
    opt = jconfig.default_opt(**{
        'model.model': MODEL[kind],
        'model.flag': 'rotation' if kind == 'reg' else 'attention',
        'model.input_num': 1024 if kind == 'inv' else N_POINTS,
        'model.search_radius': 0.4})
    opt.model.kanchor, opt.model.kpconv = ANCHORS[anchors]
    return opt


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _cos_rows(a, b):
    a = np.asarray(a, np.float64).reshape(len(a), -1)
    b = np.asarray(b, np.float64).reshape(len(b), -1)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


def _leaf_cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-300))


def _leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), np.asarray(v)) for p, v in flat]


def _ball(rng, b, n, radius=1.0):
    v = rng.randn(b, n, 3)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return (radius * v * rng.rand(b, n, 1) ** (1.0 / 3.0)).astype(np.float32)


def _rotations(rng, n):
    q = rng.randn(n, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return np.asarray(jrot.rotation_from_quaternion(jnp.asarray(q)),
                      np.float64)


def _x0(kind):
    shape = (1, 2, N_POINTS, 3) if kind == 'reg' else (2, N_POINTS, 3)
    return jnp.zeros(shape, jnp.float32)


def _jax_variables(jmodel, kind, sd):
    """The JAX model's variables holding the port's state_dict ``sd``
    (epn_pointcloud_tpu.compat), the tree's shapes from ``jax.eval_shape``
    (no init compiled)."""
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), _x0(kind), train=False))
    zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                                   dict(shapes))
    return jcompat.import_state_dict(zeros, sd)


def _models(kind, anchors, seed=0):
    """(JAX model, its numpy variables, port model) on the port's seeded
    weights, carried to the JAX tree and back through
    ``from_jax_variables``."""
    opt = _opt(kind, anchors)
    jmodel = JBUILD[kind](opt, **SMALL[kind])
    tmodel = TBUILD[kind](opt, seed=seed, **SMALL[kind])
    v = _jax_variables(jmodel, kind, tmodel.state_dict())
    tmodel.load_state_dict(tcompat.from_jax_variables(v))
    return jmodel, v, tmodel


@pytest.mark.parametrize('anchors', list(ANCHORS))
@pytest.mark.parametrize('kind', ['inv', 'reg'])
def test_builder_params_match_jax(kind, anchors):
    """The full-width block-parameter tree (params.json) equals the JAX
    builder's: inter_block layers over kanchor (or one) anchors."""
    opt = _opt(kind, anchors)
    opt.model.input_num = 1024
    want = JBUILD[kind](opt).params
    got = TBUILD[kind](opt, seed=None).params
    assert got == want
    assert {layer['type'] for block in got['backbone'] for layer in block} \
        == {'inter_block'}


@pytest.mark.parametrize('anchors', ['ka20', 'kpconv'])
@pytest.mark.parametrize('kind', ['inv', 'reg'])
def test_from_jax_variables_is_key_for_key(kind, anchors):
    """Every leaf of the JAX tree (``InterSO3ConvBlock_{j}`` of each block
    and the head) lands in the port's state_dict with its shape, and the
    port's state_dict maps back onto the same tree unchanged."""
    opt = _opt(kind, anchors)
    jmodel = JBUILD[kind](opt, **SMALL[kind])
    tmodel = TBUILD[kind](opt, seed=3, **SMALL[kind])
    v = _jax_variables(jmodel, kind, tmodel.state_dict())
    sd = tcompat.from_jax_variables(v)
    want = tmodel.state_dict()
    assert list(sd) == list(want)
    for k in sd:
        assert torch.equal(sd[k], want[k]), k
    assert 'backbone.1.blocks.0.conv.basic_conv.W' in sd
    back = jcompat.import_state_dict(v, tmodel.state_dict())
    for (p, a), (_, b) in zip(_leaves(back), _leaves(v)):
        np.testing.assert_array_equal(a, b, err_msg=p)


# --------------------------------------------------------- inputs, losses

def _inputs(kind, anchors, seed, n=N_POINTS):
    """(clouds, loss arguments) of one step: inv two legs of 2 patches of n
    points,
    reg 2 pairs of a cloud and its rotated copy with the alignment targets
    over the model's anchors (one anchor: the full group's, as the
    rotation trainer passes them)."""
    rng = np.random.RandomState(seed)
    if kind == 'inv':
        return _ball(rng, 4, n, 0.4), ()
    pcs, Ts = [], _rotations(rng, 2)
    for T in Ts:
        pc = tsynth.make_asym_shape(rng, N_POINTS)
        pc = pc - pc.mean(0)
        pc = pc / np.linalg.norm(pc, axis=1).max()
        pcs.append(np.stack([pc @ T.T, pc]))
    ka, kp = ANCHORS[anchors]
    anch = tico.get_anchors(60 if kp else ka)
    R, lab = zip(*(jrot.label_relative_rotation_np(anch, T) for T in Ts))
    return (np.asarray(pcs, np.float32),
            (anch.astype(np.float32), np.stack(lab),
             np.stack(R).astype(np.float32), Ts.astype(np.float32)))


def _jloss(kind, out, extra):
    if kind == 'inv':
        y = out[0]
        return jlosses.triplet_batch_loss(y[:2], y[2:], 'soft', 1.0)[0]
    anch, lab, R, T = (jnp.asarray(a) for a in extra)
    return jlosses.multi_task_detection_loss(anch, out[0], lab, out[1], R, T,
                                             nr=4)[0]


def _tloss(kind, out, extra):
    if kind == 'inv':
        y = out[0]
        return tlosses.triplet_batch_loss(y[:2], y[2:], 'soft', 1.0)[0]
    anch, lab, R, T = (torch.from_numpy(np.asarray(a)) for a in extra)
    dt = out[1].dtype
    return tlosses.multi_task_detection_loss(anch.to(dt), out[0], lab,
                                             out[1], R.to(dt), T.to(dt),
                                             nr=4)[0]


def _jax_step(jmodel, kind, v, x, extra):
    """(loss, (outputs), grads) of one jitted JAX train step in the
    compute dtype in force."""
    def loss_fn(params):
        out = jmodel.apply({**v, 'params': params}, jnp.asarray(x),
                           train=True)
        return _jloss(kind, out, extra), out
    (loss, out), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v['params'])
    return float(loss), jax.tree_util.tree_map(np.asarray, out), g


def _port_step(tmodel, kind, x, extra, init, dtype='fp32', f64=False):
    """(loss, outputs, JAX-tree gradients) of one port train step."""
    model = copy.deepcopy(tmodel)
    if f64:
        model = model.double()
    model.train()
    tso3.set_compute_dtype(dtype)
    try:
        xt = torch.from_numpy(x).to(torch.float64 if f64 else torch.float32)
        if f64:
            with tkern.plain():
                out = model(xt)
                loss = _tloss(kind, out, extra)
        else:
            out = model(xt)
            loss = _tloss(kind, out, extra)
        loss.backward()
    finally:
        tso3.set_compute_dtype('fp32')
    # one anchor leaves the confidence out of reg's loss: no gradient, the
    # JAX package's zeros
    grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad).detach()
             .float() for n, p in model.named_parameters()}
    return (loss.item(), tuple(o.detach().float().numpy() for o in out),
            jcompat.import_state_dict(init, grads)['params'])


def _assert_grads_close(got, want, f64, noise=1e-3):
    """The rule of tests/test_reference_train_parity.py:143-209: per leaf,
    relative L2 <= 1e-2 and max error <= 5e-2 of the leaf's largest; a leaf
    whose float64 gradient is ~0 (<= 1e-5), or below ``noise`` in both
    packages, within 2 * noise and below it in float64."""
    a, b, c = _leaves(got), _leaves(want), dict(_leaves(f64))
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, g), (_, w) in zip(a, b):
        g, w = g.astype(np.float64), w.astype(np.float64)
        scale = np.abs(c[path]).max()
        both_tiny = max(np.abs(g).max(), np.abs(w).max()) <= noise
        if scale <= 1e-5:
            assert both_tiny, (path, np.abs(g).max(), np.abs(w).max())
            continue
        if both_tiny:
            assert scale <= noise and np.abs(g - w).max() <= 2 * noise, path
            continue
        assert np.abs(g - w).max() <= 5e-2 * np.abs(w).max(), path
        assert _rel(g, w) <= 1e-2, (path, _rel(g, w))


STEP_CASES = [('inv', 'ka20'), ('inv', 'kpconv'), ('reg', 'ka20'),
              ('reg', 'kpconv')]


@pytest.fixture(scope='module', params=STEP_CASES,
                ids=[f'{k}-{a}' for k, a in STEP_CASES])
def fp32_step(request):
    kind, anchors = request.param
    jmodel, v, tmodel = _models(kind, anchors)
    x, extra = _inputs(kind, anchors, 21)
    jl, jout, jg = _jax_step(jmodel, kind, v, x, extra)
    tl, tout, tg = _port_step(tmodel, kind, x, extra, v)
    _, _, g64 = _port_step(tmodel, kind, x, extra, v, f64=True)
    return dict(kind=kind, anchors=anchors, jl=jl, jout=jout, jg=jg, tl=tl,
                tout=tout, tg=tg, g64=g64, na=tmodel.params['na'])


def test_fp32_forward_matches_jax(fp32_step):
    """The train-mode outputs (no BatchNorm, no dropout: the eval forward's
    too): inv descriptors and anchor attention, reg confidence and
    regression, at the parity tolerance."""
    s = fp32_step
    na = s['na']
    assert na == (1 if s['anchors'] == 'kpconv' else 20)
    shapes = {'inv': ((4, 32), None), 'reg': ((2, na, na), (2, na, na, 4))}
    for i, (t, j) in enumerate(zip(s['tout'], s['jout'])):
        want = shapes[s['kind']][i]
        if want is not None:
            assert t.shape == want
        np.testing.assert_allclose(t, j, rtol=1e-3, atol=2e-3)


def test_fp32_step_loss_and_gradients_match_jax(fp32_step):
    s = fp32_step
    np.testing.assert_allclose(s['tl'], s['jl'], rtol=1e-5)
    _assert_grads_close(s['tg'], s['jg'], s['g64'])


# ------------------------------------------------------------------- bf16

def _bf16_forward(jmodel, tmodel, v, x):
    """(JAX bf16, port bf16, port fp32) first outputs of the eval forward."""
    jso3.set_compute_dtype('bf16')
    try:
        j16 = np.asarray(jax.jit(lambda vv, xx: jmodel.apply(
            vv, xx, train=False)[0])(v, jnp.asarray(x)), np.float32)
    finally:
        jso3.set_compute_dtype('fp32')
    tmodel.eval()
    outs = []
    for dtype in ('bf16', 'fp32'):
        tso3.set_compute_dtype(dtype)
        try:
            with torch.no_grad():
                outs.append(tmodel(torch.from_numpy(x))[0].float().numpy())
        finally:
            tso3.set_compute_dtype('fp32')
    return j16, outs[0], outs[1]


@pytest.mark.parametrize('kind,anchors', [('inv', 'ka20'), ('reg', 'ka20'),
                                          ('inv', 'kpconv')])
def test_bf16_forward_matches_jax(kind, anchors):
    """The bf16 eval forward (InstanceNorm packed over the kanchor lanes,
    unpacked at one anchor) against the JAX package's bf16 forward: per
    sample cosine >= 0.999; inv at kanchor 20 also against the port's fp32
    forward at the JAX package's own bf16-vs-fp32 bound (0.95,
    tests/test_dtype_agreement.py)."""
    jmodel, v, tmodel = _models(kind, anchors, seed=1)
    x, _ = _inputs(kind, anchors, 23)
    j16, t16, t32 = _bf16_forward(jmodel, tmodel, v, x)
    assert np.isfinite(t16).all() and t16.shape == j16.shape
    cos = _cos_rows(t16, j16)
    assert cos.min() >= 0.999, cos
    if kind == 'inv' and anchors == 'ka20':
        assert _cos_rows(t16, t32).min() >= 0.95


# the noise-floor rule (PERF.md section 2): a per-leaf cosine floor, and a
# median no lower than the step under test against itself on the clouds
# scaled by 1 +- 1e-6 (a few flipped roundings; the lowest of three draws)
# less 0.02
BF16_LEAF_COS = 0.9
NOISE_SCALES = (1 + 1e-6, 1 - 1e-6, 1 + 2e-6)


def _cls_batch(rng):
    return (_ball(rng, 2, 64), (rng.randint(0, 40, 2), rng.randint(0, 60, 2)))


@pytest.mark.parametrize('kind', ['cls', 'inv'])
def test_bf16_step_below_60_anchors_by_the_noise_floor(kind):
    """One bf16 train step at kanchor 20 (cls: the attention CE with the
    rotation label relabelled into the subset, its BatchNorms off their
    init; inv: the triplet loss) of the port against the JAX package's
    jitted bf16 step on the same weights: the loss within rtol 5e-3, every
    leaf whose float64 gradient (the port's plain path in float64) is real
    at a cosine >= 0.9, and the median cosine no lower than the noise floor
    less 0.02: the lower of the port's own (three draws) and the JAX step's
    median cosine to float64."""
    if kind == 'cls':
        opt = jconfig.default_opt(**{'model.model': MODEL['cls'],
                                     'model.flag': 'attention',
                                     'model.input_num': 64,
                                     'model.kanchor': 20})
        jmodel = jcls.build_model(opt, **SMALL['cls'])
        tmodel = tcls.build_model(opt, seed=2, **SMALL['cls'])
        rng = np.random.RandomState(5)
        sd = {k: (t + torch.from_numpy(0.3 * rng.randn(*t.shape).astype(
            np.float32)) if '.norm.' in k and k.endswith('.bias') else t)
            for k, t in tmodel.state_dict().items()}
        tmodel.load_state_dict(sd)
        shapes = jax.eval_shape(lambda: jmodel.init(
            jax.random.PRNGKey(0), jnp.zeros((2, 64, 3)), train=False))
        v = jcompat.import_state_dict(jax.tree_util.tree_map(
            lambda a: np.zeros(a.shape, a.dtype), dict(shapes)), sd)
        x, (label, rlabel) = _cls_batch(np.random.RandomState(7))

        def jloss(params, xx):
            (pred, feat), _ = jmodel.apply(
                {'params': params, 'batch_stats': v['batch_stats']}, xx,
                train=True, mutable=['batch_stats'])
            return jlosses.attention_cross_entropy(
                pred, jnp.asarray(label), feat, jnp.asarray(rlabel),
                'default', 1.0)[0]

        def tloss(model, xx):
            pred, feat = model(xx)
            return tlosses.attention_cross_entropy(
                pred, torch.from_numpy(label), feat,
                torch.from_numpy(rlabel), 'default', 1.0)[0]
    else:
        jmodel, v, tmodel = _models('inv', 'ka20', seed=2)
        x, _ = _inputs('inv', 'ka20', 29, n=128)

        def jloss(params, xx):
            y = jmodel.apply({'params': params}, xx, train=True)[0]
            return jlosses.triplet_batch_loss(y[:2], y[2:], 'soft', 1.0)[0]

        def tloss(model, xx):
            y = model(xx)[0]
            return tlosses.triplet_batch_loss(y[:2], y[2:], 'soft', 1.0)[0]
    jso3.set_compute_dtype('bf16')
    try:
        jl, jg = jax.jit(jax.value_and_grad(jloss))(v['params'],
                                                    jnp.asarray(x))
    finally:
        jso3.set_compute_dtype('fp32')

    def port(dtype, xx, f64=False):
        model = copy.deepcopy(tmodel)
        if f64:
            model = model.double()
        model.train()
        tso3.set_compute_dtype(dtype)
        try:
            xt = torch.from_numpy(xx).to(torch.float64 if f64 else
                                         torch.float32)
            with tkern.plain() if f64 else torch.enable_grad():
                loss = tloss(model, xt)
                loss.backward()
        finally:
            tso3.set_compute_dtype('fp32')
        grads = {n: p.grad.detach().float()
                 for n, p in model.named_parameters()}
        grads.update({n: b for n, b in tmodel.named_buffers()})
        return loss.item(), dict(_leaves(jcompat.import_state_dict(
            v, grads)['params']))
    tl, tg = port('bf16', x)
    _, g64 = port('fp32', x, f64=True)
    noise = [port('bf16', (x * sc).astype(np.float32))[1]
             for sc in NOISE_SCALES]
    np.testing.assert_allclose(tl, float(jl), rtol=5e-3)
    jleaves = dict(_leaves(jg))
    real = [p for p, g in g64.items() if np.abs(g).max() > 1e-5]
    assert len(real) > 5
    cos = {p: _leaf_cos(tg[p], jleaves[p]) for p in real}
    own = min(statistics.median(_leaf_cos(n[p], tg[p]) for p in real)
              for n in noise)
    jax_f64, port_f64 = (statistics.median(_leaf_cos(g[p], g64[p])
                                           for p in real)
                         for g in (jleaves, tg))
    # two bf16 steps that round in different places sit no closer than the
    # reference sits to exact arithmetic: the JAX CPU path sums F in bf16
    # (epn_pointcloud_tpu/ops/so3conv.py:618-627), a median of 0.969 to
    # float64 at cls kanchor 20 (the port 0.990); so the floor is the lower
    # of the port's own and the reference's, and the port may sit no
    # farther from float64 than the reference (less 0.02)
    floor = min(own, jax_f64)
    assert min(cos.values()) >= BF16_LEAF_COS, cos
    assert statistics.median(cos.values()) >= floor - 0.02, (cos, own,
                                                              jax_f64)
    assert port_f64 >= jax_f64 - 0.02, (port_f64, jax_f64)


# ------------------------------------------------ norms, heads, loss, data

@pytest.mark.parametrize('na', [1, 20, 40])
def test_instance_norm_over_the_anchors_matches_jax(na):
    """The bf16 InstanceNorm of an inter block over na anchors: packed
    statistics on the moments kernel's na * c lanes at na > 1 (JAX
    ``InstanceNorm(groups=na)`` on the packed [b, p, na * c]), plain sums
    at one anchor (JAX's unpacked layout), to the bf16 rounding of its
    output."""
    rng = np.random.RandomState(na)
    x = (1.5 * rng.randn(2, 48, na, 16) + 0.5).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    jx = jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)
    if na > 1:
        jx = jx.reshape(2, 48, na * 16)
    jso3.set_compute_dtype('bf16')
    try:
        mod = jlayers.InstanceNorm(groups=na)
        want = np.asarray(mod.apply({}, jx, train=True), np.float32)
    finally:
        jso3.set_compute_dtype('fp32')
    tso3.set_compute_dtype('bf16')
    try:
        got = tlayers.InstanceNorm()(xb, kernel_stats=na > 1)
    finally:
        tso3.set_compute_dtype('fp32')
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy().reshape(want.shape), want,
                               rtol=1e-2, atol=1e-2)
    assert _rel(got.float().numpy().reshape(want.shape), want) <= 4e-3


def _init_head(jhead, *args):
    """(the head's variables, its jitted eval apply)."""
    v = jax.jit(lambda *a: jhead.init(jax.random.PRNGKey(1), *a,
                                      train=False))(*args)
    return (jax.tree_util.tree_map(np.asarray, dict(v)),
            jax.jit(lambda vv, *a: jhead.apply(vv, *a, train=False)))


@pytest.mark.parametrize('na', [1, 20, 40])
@pytest.mark.parametrize('head', ['InvOutBlockMVD', 'RelSO3OutBlockR',
                                  'SO3OutBlockR'])
def test_heads_at_reduced_anchors_match_jax(head, na):
    """The three heads over na anchors on the JAX module's weights (one
    anchor: ``PointnetSO3Conv`` takes the centered coordinates unrotated),
    within 1e-5."""
    rng = np.random.RandomState(na + len(head))
    f = rng.randn(2, 2, 16, na, 24).astype(np.float32)
    xyz = rng.randn(2, 2, 16, 3).astype(np.float32)
    params = {'dim_in': 24, 'mlp': [32, 16], 'kanchor': na,
              'representation': 'quat', 'temperature': 3.0}
    thead = getattr(theads, head)(params)
    if head == 'InvOutBlockMVD':
        jhead = jheads.InvOutBlockMVD(params)
        sc = jso3.SphericalPointCloud(jnp.asarray(xyz[0]), jnp.asarray(f[0]),
                                      None)
        v, apply = _init_head(jhead, sc)
        jout = apply(v, sc)
        targs = (tso3.SphericalPointCloud(torch.from_numpy(xyz[0]),
                                          torch.from_numpy(f[0]), None),)
    elif head == 'RelSO3OutBlockR':
        jhead = jheads.RelSO3OutBlockR(params)
        args = tuple(jnp.asarray(a) for a in (f[0], f[1], xyz[0], xyz[1]))
        v, apply = _init_head(jhead, *args)
        jout = apply(v, *args)
        targs = tuple(torch.from_numpy(a) for a in (f[0], f[1], xyz[0],
                                                    xyz[1]))
    else:
        jhead = jheads.SO3OutBlockR(params)
        v, apply = _init_head(jhead, jnp.asarray(f[0]))
        jout = apply(v, jnp.asarray(f[0]))
        targs = (torch.from_numpy(f[0]),)
    if head == 'SO3OutBlockR':
        hp = v['params']
        sd = {}
        for i, n in enumerate(['linear.0', 'linear.1', 'attention_layer',
                               'regressor_layer']):
            k = np.asarray(hp[f'Dense1x1_{i}']['kernel']).T
            sd[f'{n}.weight'] = torch.from_numpy(k.copy()).reshape(
                k.shape + (1, 1))
            sd[f'{n}.bias'] = torch.from_numpy(
                np.asarray(hp[f'Dense1x1_{i}']['bias']).copy())
    else:
        sd = {k[len('outblock.'):]: t for k, t in tcompat.from_jax_variables(
            {'params': {f'{head}_0': v['params']}}).items()}
    thead.load_state_dict(sd)
    with torch.no_grad():
        tout = thead(*targs)
    for t, j in zip(tout, jout):
        assert t.shape == np.asarray(j).shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize('na', [20, 40])
def test_alignment_loss_at_reduced_anchors_matches_jax(na):
    """multi_task_detection_loss in its alignment setting over the kanchor
    subset (labels of the subset's anchors): loss, aux values and the
    gradients with respect to the confidence and the regression within
    1e-5 of the JAX package's."""
    rng = np.random.RandomState(na)
    anchors = tico.get_anchors(na).astype(np.float32)
    Ts = _rotations(rng, 3)
    R, lab = zip(*(jrot.label_relative_rotation_np(anchors, T) for T in Ts))
    wts = rng.randn(3, na, na).astype(np.float32)
    y = rng.randn(3, na, na, 4).astype(np.float32)
    R, lab, Ts = (np.stack(R).astype(np.float32), np.stack(lab),
                  Ts.astype(np.float32))

    def jloss(w_, y_):
        return jlosses.multi_task_detection_loss(
            jnp.asarray(anchors), w_, jnp.asarray(lab), y_, jnp.asarray(R),
            jnp.asarray(Ts), nr=4)
    (jl, jaux), (jgw, jgy) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(wts),
                                              jnp.asarray(y))
    tw = torch.from_numpy(wts).requires_grad_()
    ty = torch.from_numpy(y).requires_grad_()
    tl, taux = tlosses.multi_task_detection_loss(
        torch.from_numpy(anchors), tw, torch.from_numpy(lab), ty,
        torch.from_numpy(R), torch.from_numpy(Ts), nr=4)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for k in ('cls_loss', 'l2_loss', 'r_acc', 'angular_error', 'pred_R'):
        want = np.asarray(jaux[k])
        np.testing.assert_allclose(taux[k].detach().numpy(), want, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(want).max()))
    for t, want in ((tw, jgw), (ty, jgy)):
        want = np.asarray(want)
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize('convention', ['native', 'reference'])
@pytest.mark.parametrize('kanchor', [20, 40])
def test_alignment_loader_labels_at_kanchor(tmp_path, convention, kanchor):
    """Dataloader_ModelNet40Alignment at --kanchor: items (clouds, T, the
    subset's labels and residual rotations) equal the JAX loader's under
    each anchor convention."""
    root = str(tmp_path / 'mn')
    tsynth.make_modelnet_tree(root, n_cats=1, n_train=2, n_test=0,
                              n_points=300, seed=4, airplane_asym=True,
                              splits=('train',))
    base = ['experiment', '-d', root, '--input-num', '128', '--kanchor',
            str(kanchor)]
    jico.set_convention(convention)
    tico.set_convention(convention)
    try:
        j = jmn.Dataloader_ModelNet40Alignment(jconfig.parse_args(base))
        t = tmn.Dataloader_ModelNet40Alignment(tconfig.parse_args(base))
        for i in range(len(j)):
            a, b = t[i], j[i]
            assert a['R_label'].shape == (kanchor,)
            for k in ('pc', 'T', 'R', 'R_label'):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    finally:
        jico.set_convention('native')
        tico.set_convention('native')
