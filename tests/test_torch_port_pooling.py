"""xyz pooling in the torch port (epn_pointcloud_tpu_torch) against the JAX
package on the CPU, its operations: the blur and the strided pool, the
unfused grouping path of the inter conv (``pooling`` 'stride' and
'no-stride' at kanchor 20 and 60; any other mode raises, as in JAX), and
the grouping shared by a block's consecutive stride-1 layers (the models
and the train step: tests/test_torch_port_pooling_models.py).

On the CPU the port's W-off F (``InterFFn``) runs its plain version, and
its backward the W-off dG's plain version; fp32 modules are held at rtol
1e-5, atol 1e-5 (tests/test_torch_port_convs.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epn_pointcloud_tpu.nn import blocks as jblocks
from epn_pointcloud_tpu.nn import layers as jlayers
from epn_pointcloud_tpu.ops import icosahedron as jico
from epn_pointcloud_tpu.ops import kernel_points as jkp
from epn_pointcloud_tpu.ops import sampling as jsampling
from epn_pointcloud_tpu.ops import so3conv as jso3

from epn_pointcloud_tpu_torch import compat as tcompat
from epn_pointcloud_tpu_torch.nn import blocks as tblocks
from epn_pointcloud_tpu_torch.nn import layers as tlayers
from epn_pointcloud_tpu_torch.ops import sampling as tsampling
from epn_pointcloud_tpu_torch.ops import so3conv as tso3
from epn_pointcloud_tpu_torch.ops.so3conv import SphericalPointCloud

B, P, C = 2, 16, 8
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _cloud(a, c=C, p=P, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-1, 1, (B, p, 3)).astype(np.float32),
            rng.randn(B, p, a, c).astype(np.float32))


# ------------------------------------------------------------------- ops

@pytest.mark.parametrize('stride', [1, 2])
def test_blurring_and_pooling_match_jax(stride):
    """inter_so3conv_blurring (the blur in place at stride 1, the strided
    pool onto the samples at 2), its inter_blurring / inter_pooling, and
    the grouping helpers (unpack_feats, inter_conv_anchor_weights,
    inter_feat_grouping) against JAX's, with the shapes of JAX
    tests/test_heads.py:112-122."""
    xyz, feats = _cloud(4)
    jf, jx = jso3.inter_so3conv_blurring(jnp.asarray(xyz), jnp.asarray(feats),
                                         n_neighbor=4, radius=0.6,
                                         stride=stride, lazy_sample=True)
    tf, tx = tso3.inter_so3conv_blurring(_t(xyz), _t(feats), 4, 0.6, stride)
    assert tf.shape == (B, P // stride, 4, C)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), **TOL)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    packed = _t(feats).reshape(B, P, -1)
    assert torch.equal(tso3.unpack_feats(packed, 4), _t(feats))
    anchors = jico.get_anchors(20)[:4]
    kern = jkp.get_spherical_kernel_points(0.7 * 0.6, 1)
    gx, idx, _, _ = jsampling.inter_grouping_ball(jnp.asarray(xyz), stride,
                                                  0.6, 4, True)
    jw = jso3.inter_conv_anchor_weights(gx, jnp.asarray(anchors),
                                        jnp.asarray(kern), 0.3)
    tw = tso3.inter_conv_anchor_weights(_t(gx), _t(anchors), _t(kern), 0.3)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TOL)
    grouped = jsampling.gather_points(jsampling.add_shadow_feature(
        jnp.asarray(feats)), idx)
    np.testing.assert_allclose(
        tso3.inter_feat_grouping(_t(grouped), tw).numpy(),
        np.asarray(jso3.inter_feat_grouping(grouped, jw)), **TOL)


@pytest.mark.parametrize('kanchor', [20, 60])
@pytest.mark.parametrize('pooling', ['stride', 'no-stride'])
def test_inter_conv_pooling_matches_jax(kanchor, pooling):
    """An InterSO3Conv of stride 2 with pooling (JAX
    tests/test_heads.py:125-133): the unfused path, its output and
    samples at 1e-5, and the gradient of the features through the W-off
    F's backward (the plain dG) against jax.grad."""
    xyz, feats = _cloud(kanchor, seed=1)
    kw = dict(dim_in=C, dim_out=4, kernel_size=1, stride=2, radius=0.6,
              sigma=0.18, n_neighbor=4, lazy_sample=True, pooling=pooling,
              kanchor=kanchor)
    jconv = jlayers.InterSO3Conv(**kw)
    jx = jso3.SphericalPointCloud(jnp.asarray(xyz), jnp.asarray(feats), None)
    v = jax.tree_util.tree_map(np.asarray,
                               jconv.init(jax.random.PRNGKey(0), jx))
    _, _, _, jout = jconv.apply(v, jx)
    tconv = tlayers.InterSO3Conv(**kw)
    tconv.basic_conv.W.data = tcompat._so3_w(v['params']['W'])
    tf = _t(feats).requires_grad_()
    idx, tout = tconv(SphericalPointCloud(_t(xyz), tf, None))
    assert tout.feats.shape == (B, P // 2, kanchor, 4)
    np.testing.assert_allclose(tout.feats.detach().numpy(),
                               np.asarray(jout.feats), **TOL)
    np.testing.assert_array_equal(tout.xyz.numpy(), np.asarray(jout.xyz))
    dout = np.random.RandomState(2).randn(*tout.feats.shape)
    tout.feats.backward(_t(dout))
    jg = jax.grad(lambda f: jnp.sum(jconv.apply(v, jso3.SphericalPointCloud(
        jnp.asarray(xyz), f, None))[3].feats * jnp.asarray(dout)))(
            jnp.asarray(feats))
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(jg), **TOL)


def test_pooling_mode_max_raises_as_in_jax():
    """JAX's ops/so3conv.py:116-123 takes 'stride' and 'no-stride' and
    raises NotImplementedError('pooling mode max') for 'max'; so does the
    port, at its first call, and a 1-channel input is never pooled."""
    xyz, feats = _cloud(20)
    kw = dict(dim_in=C, dim_out=4, kernel_size=1, stride=2, radius=0.6,
              sigma=0.18, n_neighbor=4, pooling='max', kanchor=20)
    jx = jso3.SphericalPointCloud(jnp.asarray(xyz), jnp.asarray(feats), None)
    with pytest.raises(NotImplementedError, match='pooling mode max'):
        jlayers.InterSO3Conv(**kw).init(jax.random.PRNGKey(0), jx)
    conv = tlayers.InterSO3Conv(**kw)
    with pytest.raises(NotImplementedError, match='pooling mode max'):
        conv(SphericalPointCloud(_t(xyz), _t(feats), None))
    ones = SphericalPointCloud(_t(xyz), torch.ones(B, P, 20, 1), None)
    out = tlayers.InterSO3Conv(**dict(kw, dim_in=1))(ones)[1]
    assert out.feats.shape == (B, P // 2, 20, 4)


def _sep(stride=1, pooling='stride'):
    return {'type': 'separable_block', 'args': dict(
        dim_in=C, dim_out=C, kernel_size=1, stride=stride, radius=0.8,
        sigma=0.1, n_neighbor=6, kanchor=60, norm='BatchNorm2d',
        activation='leaky_relu', dropout_rate=0.0, lazy_sample=True,
        pooling=pooling)}


def test_consecutive_stride1_layers_share_one_grouping(monkeypatch):
    """A BasicSO3ConvBlock of three stride-1 separable layers on the pooled
    path: the first groups (one ball query), the next two reuse its
    grouping as it stands (JAX nn/blocks.py:249-279); output against JAX's
    at 1e-5. Without pooling each layer groups its own (three queries)."""
    calls = []
    orig = tsampling.ball_query

    def counted(*a):
        calls.append(a[3])
        return orig(*a)
    monkeypatch.setattr(tsampling, 'ball_query', counted)
    params = [_sep(), _sep(), _sep()]
    xyz, feats = _cloud(60, seed=3)
    jblk = jblocks.BasicSO3ConvBlock(params)
    jx = jso3.SphericalPointCloud(jnp.asarray(xyz), jnp.asarray(feats), None)
    v = jax.tree_util.tree_map(np.asarray, jblk.init(
        jax.random.PRNGKey(2), jx, train=False))
    jout = jblk.apply(v, jx, train=False)
    sd = tcompat.from_jax_variables(
        {'params': {'BasicSO3ConvBlock_0': v['params']},
         'batch_stats': {'BasicSO3ConvBlock_0': v['batch_stats']}})
    tblk = tblocks.BasicSO3ConvBlock(params)
    tblk.load_state_dict({k.split('.', 2)[2]: t for k, t in sd.items()})
    with torch.no_grad():
        tout = tblk.eval()(SphericalPointCloud(_t(xyz), _t(feats), None))
    assert len(calls) == 1
    np.testing.assert_allclose(tout.feats.numpy(), np.asarray(jout.feats),
                               **TOL)
    calls.clear()
    with torch.no_grad():
        tblocks.BasicSO3ConvBlock([_sep(pooling=None)] * 3).eval()(
            SphericalPointCloud(_t(xyz), _t(feats), None))
    assert len(calls) == 3


def test_strided_pool_after_a_shared_grouping_raises_as_in_jax():
    """A strided 'stride'-pooled layer after a stride-1 one in the same
    block would pool over the cached grouping, which has no samples: the
    JAX package raises (UnboundLocalError), and so does the port."""
    params = [_sep(), _sep(stride=2)]
    xyz, feats = _cloud(60, seed=4)
    jx = jso3.SphericalPointCloud(jnp.asarray(xyz), jnp.asarray(feats), None)
    with pytest.raises(UnboundLocalError):
        jblocks.BasicSO3ConvBlock(params).init(jax.random.PRNGKey(0), jx,
                                               train=False)
    with pytest.raises(UnboundLocalError):
        tblocks.BasicSO3ConvBlock(params).eval()(
            SphericalPointCloud(_t(xyz), _t(feats), None))
