"""The heads and modules no builder of the torch port
(epn_pointcloud_tpu_torch) uses, and the host data of this slice, against
the JAX package on the CPU: ``ClsOutBlockR``, ``InvOutBlockR`` and
``InvOutBlockPointnet`` in every pooling mode JAX takes (and its raise for
the others), ``initial_anchor_query``, ``KernelPropagation`` and
``PropagationBlock``, ``rotate_point_cloud`` with JAX's signature, the
3DMatch training augmentation (bit for bit), and the .mat header time
that the clock-dependent comparison of tests/test_torch_port_reg.py pins.

Weights cross by ``compat.head_state`` and ``compat.propagation_state``;
fp32 outputs are held at the port's fp32 module tolerance (rtol 1e-5, atol
1e-5, as tests/test_torch_port_convs.py).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epn_pointcloud_tpu import native as jnative
from epn_pointcloud_tpu.app import config as jconfig
from epn_pointcloud_tpu.data import match_3dmatch as jmatch
from epn_pointcloud_tpu.data import pc as jpc
from epn_pointcloud_tpu.data import synthetic as jsynth
from epn_pointcloud_tpu.nn import blocks as jblocks
from epn_pointcloud_tpu.nn import heads as jheads
from epn_pointcloud_tpu.nn import layers as jlayers
from epn_pointcloud_tpu.ops import so3conv as jso3

from epn_pointcloud_tpu_torch import compat as tcompat
from epn_pointcloud_tpu_torch.app import config as tconfig
from epn_pointcloud_tpu_torch.data import match_3dmatch as tmatch
from epn_pointcloud_tpu_torch.data import pc as tpc
from epn_pointcloud_tpu_torch.data import synthetic as tsynth
from epn_pointcloud_tpu_torch.nn import blocks as tblocks
from epn_pointcloud_tpu_torch.nn import heads as theads
from epn_pointcloud_tpu_torch.nn import layers as tlayers
from epn_pointcloud_tpu_torch.ops import so3conv as tso3
from epn_pointcloud_tpu_torch.ops.so3conv import SphericalPointCloud

B, P, A, C = 2, 16, 60, 8
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _spc(a=A, c=C, p=P, seed=0):
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(-1, 1, (B, p, 3)).astype(np.float32)
    feats = rng.randn(B, p, a, c).astype(np.float32)
    return xyz, feats


# ------------------------------------------------------------------ heads

CLS_R = [('mean', {}), ('debug', {}), ('max', {}), ('label', {}),
         ('attention', {}), ('attention_c', {})]


@pytest.mark.parametrize('pooling,_', CLS_R)
def test_cls_out_block_r_matches_jax(pooling, _):
    """ClsOutBlockR (an intra conv block at 60 anchors on the one-point
    field, ReLU by default) in each pooling mode JAX takes, the label
    branch with a rotation label, eval against JAX's (shapes of JAX
    tests/test_heads.py:25-77): logits and the second output at 1e-5."""
    xyz, feats = _spc()
    params = {'dim_in': C, 'mlp': [16], 'fc': [16], 'k': 40,
              'pooling': pooling, 'temperature': 3, 'kanchor': A,
              'intra': [{'args': {'dim_in': 16, 'dim_out': 16}}]}
    label = np.random.RandomState(0).randint(0, A, (B,))
    jargs = (jnp.asarray(feats),) + ((jnp.asarray(label),)
                                     if pooling == 'label' else ())
    jh = jheads.ClsOutBlockR(params)
    v = jax.tree_util.tree_map(np.asarray, jh.init(
        jax.random.PRNGKey(0), *jargs, train=False))
    jl, jf = jh.apply(v, *jargs, train=False)
    th = theads.ClsOutBlockR(params)
    th.load_state_dict(tcompat.head_state('ClsOutBlockR', v['params'],
                                          v['batch_stats'], params, ''))
    with torch.no_grad():
        tl, tf = th.eval()(_t(feats), *((torch.from_numpy(label),)
                                        if pooling == 'label' else ()))
    assert tl.shape == (B, 40)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), **TOL)


@pytest.mark.parametrize('kind,pooling', [
    ('InvOutBlockR', p) for p in ('mean', 'debug', 'max', 'attention')] + [
    ('InvOutBlockPointnet', p) for p in ('mean', 'max', 'attention')])
def test_inv_out_blocks_match_jax(kind, pooling):
    """InvOutBlockR and InvOutBlockPointnet in each pooling mode JAX takes:
    the unit descriptor [b, 8] and the second output at 1e-5."""
    xyz, feats = _spc(seed=1)
    params = {'dim_in': C, 'mlp': [16, 8], 'pooling': pooling,
              'temperature': 3, 'kanchor': A}
    jh, th = getattr(jheads, kind)(params), getattr(theads, kind)(params)
    if kind == 'InvOutBlockR':
        jx, tx = jnp.asarray(feats), _t(feats)
    else:
        jx = jso3.SphericalPointCloud(jnp.asarray(xyz), jnp.asarray(feats),
                                      None)
        tx = SphericalPointCloud(_t(xyz), _t(feats), None)
    v = jax.tree_util.tree_map(np.asarray, jh.init(
        jax.random.PRNGKey(0), jx, train=False))
    jd, jf = jh.apply(v, jx, train=False)
    th.load_state_dict(tcompat.head_state(kind, v['params'], None, params,
                                          ''))
    with torch.no_grad():
        td, tf = th.eval()(tx)
    assert td.shape == (B, 8)
    np.testing.assert_allclose(td.norm(dim=1).numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), **TOL)


def test_heads_refuse_the_pooling_modes_jax_refuses():
    """'label' without a label, or any unknown mode, raises at the call as
    the JAX heads do."""
    xyz, feats = _spc(c=4, p=4)
    for head, params, x in (
            (theads.ClsOutBlockR, {'dim_in': 4, 'mlp': [4], 'fc': [],
                                   'k': 3, 'pooling': 'label'}, _t(feats)),
            (theads.InvOutBlockR, {'dim_in': 4, 'mlp': [4],
                                   'pooling': 'debugger'}, _t(feats)),
            (theads.InvOutBlockPointnet,
             {'dim_in': 4, 'mlp': [4], 'pooling': 'debug', 'kanchor': A},
             SphericalPointCloud(_t(xyz), _t(feats), None))):
        with pytest.raises(NotImplementedError, match='Pooling mode'):
            head(params).eval()(x)


# ------------------------------------------------------------ propagation

def test_initial_anchor_query_matches_jax():
    """Weights and counts against JAX's on a fragment of 300 points, with
    the port's chunks of (center, point) pairs forced small (7 pairs), and
    the two-point case of JAX tests/test_heads.py:155."""
    rng = np.random.RandomState(7)
    frag = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    centers = rng.uniform(-0.5, 0.5, (2, 5, 3)).astype(np.float32)
    kernels = (rng.randn(24, 20, 3) * 0.3).astype(np.float32)
    jw, jc = jso3.initial_anchor_query(jnp.asarray(frag),
                                       jnp.asarray(centers),
                                       jnp.asarray(kernels), 0.7, 0.3)
    old = tso3._QUERY_CHUNK
    tso3._QUERY_CHUNK = 7 * 24 * 20
    try:
        tw, tc = tso3.initial_anchor_query(_t(frag), _t(centers),
                                           _t(kernels), 0.7, 0.3)
    finally:
        tso3._QUERY_CHUNK = old
    assert tw.shape == (2, 5, 20, 24) and tc.shape == tw.shape
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    w, cnt = tso3.initial_anchor_query(
        _t([[0.1, 0, 0], [5, 5, 5]]), torch.zeros(1, 1, 3),
        torch.zeros(2, 3, 3), 1.0, 1.0)
    np.testing.assert_allclose(cnt.numpy(), 1.0)
    np.testing.assert_allclose(w.numpy(), 0.99, atol=1e-6)


@pytest.mark.parametrize('n_center,block', [(8, False), (6, False),
                                            (6, True)])
def test_kernel_propagation_matches_jax(n_center, block):
    """KernelPropagation (JAX tests/test_heads.py:100-109: the clouds as
    the centers; and 6 centers by fps, not lazy) and PropagationBlock
    (InstanceNorm + ReLU after it) at kanchor 20, fp32 at 1e-5."""
    rng = np.random.RandomState(8)
    frag = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    clouds = rng.uniform(-1, 1, (2, 8, 3)).astype(np.float32)
    kp = dict(dim_in=1, dim_out=4, n_center=n_center, kernel_size=1,
              radius=0.8, sigma=0.3, kanchor=20)
    if block:
        jm, tm = jblocks.PropagationBlock(kp), tblocks.PropagationBlock(kp)
    else:
        jm, tm = jlayers.KernelPropagation(**kp), \
            tlayers.KernelPropagation(**kp)
    v = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.asarray(frag), jnp.asarray(clouds)))
    out = jm.apply(v, jnp.asarray(frag), jnp.asarray(clouds))
    tm.load_state_dict(tcompat.propagation_state(v['params']))
    with torch.no_grad():
        got = tm.eval()(_t(frag), _t(clouds))
    assert got.feats.shape == (2, n_center, 20, 4)
    np.testing.assert_array_equal(got.xyz.numpy(), np.asarray(out.xyz))
    np.testing.assert_allclose(got.feats.numpy(), np.asarray(out.feats),
                               **TOL)


# --------------------------------------------------------- host data, clock

@pytest.mark.parametrize('kw', [dict(max_degree=30), dict(), dict(R=[0.1,
                                0.2, 0.3]), dict(R=np.eye(4))])
def test_rotate_point_cloud_matches_jax(kw):
    """rotate_point_cloud with JAX's signature and draw order: a data-less
    call, Euler angles of whole degrees, a uniform rotation, a given one."""
    data = np.random.RandomState(1).randn(10, 3)
    for d in (None, data):
        jr, jR = jpc.rotate_point_cloud(d, rng=np.random.RandomState(9), **kw)
        tr, tR = tpc.rotate_point_cloud(d, rng=np.random.RandomState(9), **kw)
        np.testing.assert_array_equal(tR, jR)
        if d is None:
            assert tr is None and jr is None
        else:
            np.testing.assert_array_equal(tr, jr)


def test_fragment_loader_augmentation_equals_jax(tmp_path, monkeypatch):
    """FragmentLoader with augmentation on (two rotations of up to 30
    degrees a leg from the loader's rng): two passes of items equal the JAX
    loader's bit for bit at one seed (the JAX package on its numpy path),
    and the patches differ from the unaugmented loader's."""
    monkeypatch.setattr(jnative, 'available', lambda: False)
    roots = str(tmp_path / 'j'), str(tmp_path / 't')
    for make, root in zip((jsynth.make_3dmatch_tree,
                           tsynth.make_3dmatch_tree), roots):
        make(root, n_frags=2, n_points=3000, n_kpts=8, seed=11,
             extent=(2.0, 2.0, 1.6), kpt_margin=0.45)

    def loader(module, cls, root, aug=True):
        opt = module.parse_args(['experiment', '-d', root, '--input-num',
                                 '64'])
        opt.no_augmentation = not aug
        return cls(opt, 0.4, npt=3)
    jl = loader(jconfig, jmatch.FragmentLoader, roots[0])
    tl = loader(tconfig, tmatch.FragmentLoader, roots[1])
    assert len(jl) == len(tl) == 1
    for _ in range(2):
        x, y = jl[0], tl[0]
        assert x['fn'] == y['fn'] and y['src'].shape == (3, 64, 3)
        for k in ('src', 'tgt', 'frag_src', 'frag_tgt', 'T'):
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    aug = loader(tconfig, tmatch.FragmentLoader, roots[1])[0]
    plain = loader(tconfig, tmatch.FragmentLoader, roots[1], aug=False)[0]
    assert not np.array_equal(plain['src'], aug['src'])
    np.testing.assert_array_equal(plain['T'], aug['T'])


def test_mat_header_time_is_pinned_whatever_the_clock(tmp_path, monkeypatch):
    """The repair of tests/test_torch_port_reg.py's whole-file comparison:
    scipy writes time.asctime() into each .mat header, so two trees written
    in different seconds differ there only; with the time pinned (that
    test's MAT_TIME) a later second writes the same bytes. The clock is
    simulated: no sleep."""
    import time

    from test_torch_port_reg import MAT_TIME
    kw = dict(n_cats=1, n_train=1, n_test=1, n_points=16, seed=4,
              airplane_asym=True, splits=('train',))
    trees = [str(tmp_path / n) for n in 'abcd']
    for root, second in zip(trees[:2], ('00', '01')):
        monkeypatch.setattr(time, 'asctime',
                            lambda *a, s=second: f'Sun Oct 18 21:00:{s} 2026')
        tsynth.make_modelnet_tree(root, **kw)
    monkeypatch.setattr(time, 'asctime', lambda *a: MAT_TIME)
    for root in trees[2:]:
        tsynth.make_modelnet_tree(root, **kw)

    def mats(root):
        return sorted(os.path.join(d, f) for d, _, fs in os.walk(root)
                      for f in fs if f.endswith('.mat'))

    def read(path):
        with open(path, 'rb') as f:
            return f.read()
    a, b, c, d = (list(map(read, mats(r))) for r in trees)
    assert a and len(a) == len(b) == len(c) == len(d)
    for u, w in zip(a, b):
        diff = [i for i, (x, y) in enumerate(zip(u, w)) if x != y]
        assert diff and max(diff) < 116              # the header text only
    assert c == d and all(MAT_TIME.encode() in f[:116] for f in c)
