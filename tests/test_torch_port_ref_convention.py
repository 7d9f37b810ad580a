"""The reference anchor convention of the torch port (epn_pointcloud_tpu_torch)
against the JAX package on the CPU.

The geometry gate: anchors, the intra adjacency and its inverse, the
identity index, the kernel points, the anchor subsets and their relabel map
equal (``np.array_equal``) the JAX package's under both conventions, and
the port's copy of the vendored geometry is byte for byte the JAX one. The
ball query's reference fill (exactly n_sample - 1 hits leave the last slot
0) index for index against JAX ``ops.sampling.ball_query``. The small
cls_so3net_pn under the reference convention on JAX weights
(``from_jax_variables``) and on an original-EPN state_dict
(``load_reference_state_dict`` against JAX ``compat.import_state_dict``),
a model built under one convention run under the other, and a train step
after an eval under inference mode.

Both packages' conventions are process-wide: every test that switches them
restores 'native' in both, in a fixture's ``finally``.
"""

import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epn_pointcloud_tpu import compat as jcompat
from epn_pointcloud_tpu.app import config as jconfig
from epn_pointcloud_tpu.models import cls_so3net_pn as jcls
from epn_pointcloud_tpu.ops import icosahedron as jico
from epn_pointcloud_tpu.ops import kernel_points as jkp
from epn_pointcloud_tpu.ops import sampling as jsamp

from epn_pointcloud_tpu_torch import compat as tcompat
from epn_pointcloud_tpu_torch import losses as tlosses
from epn_pointcloud_tpu_torch.models import cls_so3net_pn as tcls
from epn_pointcloud_tpu_torch.nn import layers as tlayers
from epn_pointcloud_tpu_torch.ops import icosahedron as tico
from epn_pointcloud_tpu_torch.ops import kernel_points as tkp
from epn_pointcloud_tpu_torch.ops import sampling as tsamp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MLPS, OUT_MLPS = ((8, 8), (16,)), (16,)
N_POINTS = 64
CONVENTIONS = ('native', 'reference')


def _set_both(name):
    jico.set_convention(name)
    tico.set_convention(name)


@pytest.fixture(params=CONVENTIONS)
def convention(request):
    """Each convention in both packages, 'native' restored after."""
    _set_both(request.param)
    try:
        yield request.param
    finally:
        _set_both('native')


@pytest.fixture
def reference():
    _set_both('reference')
    try:
        yield
    finally:
        _set_both('native')


# ------------------------------------------------------------ geometry gate

def _inverse(ti):
    inv = np.full(ti.shape, -1, np.int64)
    for k in range(ti.shape[1]):
        inv[ti[:, k], k] = np.arange(ti.shape[0])
    return inv


@pytest.mark.parametrize('item', ['anchors', 'trace_idx', 'inv_idx',
                                  'identity'])
def test_geometry_equals_jax(convention, item):
    if item == 'anchors':
        got, want = tico.get_anchors_full(), jico.get_anchors_full()
    elif item == 'trace_idx':
        got, want = tico.get_intra_idx(), jico.get_intra_idx()
    elif item == 'inv_idx':
        got, want = tico.get_intra_inv_idx(), _inverse(jico.get_intra_idx())
    else:
        got, want = tico.get_identity_index(), jico.get_identity_index()
        assert got == (29 if convention == 'reference' else 0)
    assert np.array_equal(got, want)


@pytest.mark.parametrize('kernel_size', [1, 2, 3])
def test_kernel_points_equal_jax(convention, kernel_size):
    radius = 0.7 * 0.4
    got = tkp.get_spherical_kernel_points(radius, kernel_size)
    want = jkp.get_spherical_kernel_points(radius, kernel_size)
    assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize('k', [1, 20, 40, 60])
def test_select_anchors_equal_jax(convention, k):
    got = tico.select_anchors(tico.get_anchors_full(), k)
    assert np.array_equal(got, jico.select_anchors(jico.get_anchors_full(),
                                                   k))
    assert np.array_equal(tico.get_anchors(k), jico.get_anchors(k))
    if k == 1:
        # the identity anchor of the convention in force
        np.testing.assert_allclose(got[0], np.eye(3), atol=1e-6)


@pytest.mark.parametrize('k', [1, 20, 40, 60])
def test_anchor_subset_relabel_map_equals_jax(convention, k):
    got = tico.anchor_subset_relabel_map(k)
    assert got.dtype == np.int32
    assert np.array_equal(got, jico.anchor_subset_relabel_map(k))


def test_reference_geometry_asset_is_the_jax_one():
    assert filecmp.cmp(
        os.path.join(REPO, 'epn_pointcloud_tpu_torch', 'data_assets',
                     'ref_geometry.npz'),
        os.path.join(REPO, 'epn_pointcloud_tpu', 'data_assets',
                     'ref_geometry.npz'), shallow=False)


def test_unknown_convention_is_refused():
    with pytest.raises(ValueError):
        tico.set_convention('closure')
    assert tico.get_convention() == 'native'


# ---------------------------------------------------- ball query's fill

NS = 8
# hits of each query: none, exactly NS - 1 (the reference fill's case), one,
# NS, more than NS, NS - 1 again
HITS = (0, NS - 1, 1, NS, NS + 5, NS - 1)


def _hit_cloud(rng, b=2, n=80, radius=0.2):
    """Queries far apart, each with HITS[j] support points inside radius
    (scattered through the support's index order); the rest far away."""
    m = len(HITS)
    q = np.zeros((b, m, 3), np.float32)
    q[:, :, 0] = 10.0 * np.arange(m)
    s = np.full((b, n, 3), 1000.0, np.float32)
    s += rng.rand(b, n, 3).astype(np.float32)
    for bi in range(b):
        slots = rng.permutation(n)
        used = 0
        for j, h in enumerate(HITS):
            off = rng.randn(h, 3)
            off *= (0.5 * radius * rng.rand(h, 1)
                    / np.linalg.norm(off, axis=1, keepdims=True))
            s[bi, slots[used:used + h]] = q[bi, j] + off
            used += h
    return q, s, radius


def test_ball_query_fill_equals_jax(convention):
    """The op layer (the plain version on the CPU) against JAX
    ``sampling.ball_query`` under both conventions, index for index; the
    reference fill differs from the native one exactly at the queries with
    NS - 1 hits, whose last slot it keeps 0."""
    q, s, r = _hit_cloud(np.random.RandomState(3))
    want = np.asarray(jsamp.ball_query(jnp.asarray(q), jnp.asarray(s), r,
                                       NS))
    got = tsamp.ball_query(torch.from_numpy(q), torch.from_numpy(s), r, NS)
    assert got.dtype == torch.int32 and got.shape == (2, len(HITS), NS)
    np.testing.assert_array_equal(got.numpy(), want)
    last = got.numpy()[:, :, -1]
    short = np.asarray(HITS) == NS - 1
    if convention == 'reference':
        assert (last[:, short] == 0).all()
    else:
        assert (last[:, short] == got.numpy()[:, short, 0]).all()
        assert (last[:, short] != 0).all()


# --------------------------------------------------------- the cls model

def _opt():
    opt = jconfig.default_opt()
    opt.model.model, opt.model.flag = 'cls_so3net_pn', 'attention'
    opt.model.kanchor, opt.model.input_num = 60, N_POINTS
    return opt


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


def _jax_logits(jmodel, v, x):
    return np.asarray(jax.jit(lambda vv, xx: jmodel.apply(
        vv, xx, train=False)[0])(v, jnp.asarray(x)))


def _port_logits(tmodel, x):
    with torch.no_grad():
        return tmodel(torch.from_numpy(x))[0].numpy()


@pytest.fixture(scope='module')
def reference_models():
    """The JAX cls model and its numpy variables, built and initialized
    under the reference convention; 'native' restored after."""
    _set_both('reference')
    try:
        jmodel = jcls.build_model(_opt(), mlps=MLPS, out_mlps=OUT_MLPS)
        v = jax.jit(lambda: jmodel.init(
            jax.random.PRNGKey(0), jnp.zeros((2, N_POINTS, 3)),
            train=False))()
        v = jax.tree_util.tree_map(np.array, jax.device_get(
            {'params': v['params'], 'batch_stats': v['batch_stats']}))
        _randomize_stats(v['params'], v['batch_stats'],
                         np.random.RandomState(12))
        yield jmodel, v, _ball_points(np.random.RandomState(11), 2, N_POINTS)
    finally:
        _set_both('native')


def test_cls_reference_forward_on_jax_weights(reference_models, reference):
    """The port's cls forward under the reference convention on JAX weights
    (from_jax_variables), at the cls parity tolerance; the same weights
    under the native convention compute another function."""
    jmodel, v, x = reference_models
    tmodel = tcls.build_model(_opt(), mlps=MLPS, out_mlps=OUT_MLPS).eval()
    tmodel.load_state_dict(tcompat.from_jax_variables(v))
    want = _jax_logits(jmodel, v, x)
    got = _port_logits(tmodel, x)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-3)
    tico.set_convention('native')
    assert not np.allclose(_port_logits(tmodel, x), want, rtol=1e-3,
                           atol=2e-3)


def test_cls_reference_forward_on_an_original_state_dict(reference_models,
                                                         reference):
    """An original-EPN-layout state_dict (the port's own state_dict, which
    has that layout, moved off init) through load_reference_state_dict and
    through JAX compat.import_state_dict: the two forwards agree at the cls
    parity tolerance, and the loaded weights are the dict's."""
    jmodel, v, x = reference_models
    src = tcls.build_model(_opt(), mlps=MLPS, out_mlps=OUT_MLPS, seed=7)
    rng = np.random.RandomState(8)
    sd = {k: (t + torch.from_numpy(0.1 * rng.randn(*t.shape).astype(
        np.float32)) if 'running_var' not in k else t + 0.5)
        for k, t in src.state_dict().items()}
    # the original's constant buffers ride along and are skipped
    sd['backbone.0.blocks.0.inter_conv.conv.anchors'] = torch.zeros(60, 3, 3)
    sd['outblock.norm.0.num_batches_tracked'] = torch.tensor(3)
    tmodel = tcls.build_model(_opt(), mlps=MLPS, out_mlps=OUT_MLPS,
                              seed=None).eval()
    tcompat.load_reference_state_dict(tmodel, sd)
    state = tmodel.state_dict()
    assert all(torch.equal(state[k], sd[k]) for k in state)
    jv = jcompat.import_state_dict(v, jcompat.state_dict_to_numpy(sd))
    np.testing.assert_allclose(_port_logits(tmodel, x),
                               _jax_logits(jmodel, jv, x), rtol=1e-3,
                               atol=2e-3)


def test_load_reference_state_dict_is_strict():
    model = tcls.build_model(_opt(), mlps=MLPS, out_mlps=OUT_MLPS)
    sd = dict(model.state_dict())
    bad = dict(sd)
    del bad['outblock.fc2.bias']
    with pytest.raises(ValueError, match='missing.*outblock.fc2.bias'):
        tcompat.load_reference_state_dict(model, bad)
    bad = dict(sd, **{'outblock.extra.weight': torch.zeros(1)})
    with pytest.raises(ValueError, match='unexpected.*outblock.extra.weight'):
        tcompat.load_reference_state_dict(model, bad)
    key = 'backbone.0.blocks.0.inter_conv.conv.basic_conv.W'
    bad = dict(sd, **{key: sd[key][:, :-1]})
    with pytest.raises(ValueError, match='shapes.*' + key):
        tcompat.load_reference_state_dict(model, bad)


def test_model_follows_the_convention_in_force(reference_models):
    """A model built under one convention and run under the other computes
    what a model built under that other one does: its anchors, kernel
    points and adjacency are looked up when it runs, never mixed."""
    _, _, x = reference_models
    models = {}
    for built in CONVENTIONS:
        _set_both(built)
        try:
            models[built] = tcls.build_model(_opt(), mlps=MLPS,
                                             out_mlps=OUT_MLPS, seed=3).eval()
        finally:
            _set_both('native')
    for run in CONVENTIONS:
        _set_both(run)
        try:
            a, b = (_port_logits(models[c], x) for c in CONVENTIONS)
            conv = models['native'].backbone[0].blocks[0].intra_conv.conv
            assert np.array_equal(conv.trace_idx.numpy(),
                                  jico.get_intra_idx())
        finally:
            _set_both('native')
        np.testing.assert_array_equal(a, b)


def test_constants_first_read_under_inference_mode_serve_a_train_step():
    """An eval under ``torch.inference_mode()`` first in the process (as the
    3DMatch descriptor and rotation evals run), then a train step: the
    constants the eval cached are normal tensors, so the step's intra conv
    saves its adjacency for backward and the relabel map indexes the
    rotation labels."""
    tlayers._constant.cache_clear()
    model = tcls.build_model(_opt(), mlps=MLPS, out_mlps=OUT_MLPS, seed=3)
    x = torch.from_numpy(_ball_points(np.random.RandomState(11), 2,
                                      N_POINTS))
    with torch.inference_mode():
        model.eval()(x)
        cached = [tlayers.convention_constant(kind, arg, x.device)
                  for kind, arg in (('anchors', 60), ('trace_idx', None),
                                    ('inv_idx', None), ('relabel', 20))]
    assert not any(t.is_inference() for t in cached)
    pred, feat = model.train()(x)
    loss, _ = tlosses.attention_cross_entropy(
        pred, torch.tensor([1, 2]), feat, torch.tensor([0, 59]))
    loss.backward()
    W = model.backbone[0].blocks[0].intra_conv.conv.basic_conv.W
    assert torch.isfinite(loss) and W.grad is not None
    assert torch.isfinite(W.grad).all() and W.grad.abs().max() > 0
