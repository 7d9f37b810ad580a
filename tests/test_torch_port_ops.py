"""Torch port geometry statics and sampling ops against the JAX package on
the CPU: anchors, the intra adjacency, kernel points (atol 1e-6), and the
plain versions of furthest point sampling and the ball query (exactly equal
indices).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epn_pointcloud_tpu.ops import icosahedron as jico
from epn_pointcloud_tpu.ops import kernel_points as jkp
from epn_pointcloud_tpu.ops import sampling as jsamp

from epn_pointcloud_tpu_torch.ops import icosahedron as tico
from epn_pointcloud_tpu_torch.ops import kernel_points as tkp
from epn_pointcloud_tpu_torch.ops import kernels as tkern
from epn_pointcloud_tpu_torch.ops import sampling as tsamp


def _ball_points(rng, b, n):
    v = rng.randn(b, n, 3)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return (v * rng.rand(b, n, 1) ** (1.0 / 3.0)).astype(np.float32)


@pytest.mark.parametrize('k', [1, 20, 40, 60])
def test_anchors_match_jax(k):
    np.testing.assert_allclose(tico.get_anchors(k), jico.get_anchors(k),
                               rtol=0, atol=1e-6)


def test_intra_idx_and_identity_match_jax():
    np.testing.assert_array_equal(tico.get_intra_idx(), jico.get_intra_idx())
    assert tico.get_intra_idx().dtype == np.int32
    assert tico.get_identity_index() == jico.get_identity_index() == 0


def test_reference_convention_is_refused():
    with pytest.raises(NotImplementedError):
        tico.set_convention('reference')


@pytest.mark.parametrize('kernel_size', [1, 2, 3])
def test_kernel_points_match_jax(kernel_size):
    t = tkp.get_spherical_kernel_points(0.7 * 0.4, kernel_size)
    j = jkp.get_spherical_kernel_points(0.7 * 0.4, kernel_size)
    assert t.shape == j.shape == (tkp.KERNEL_SIZE_TO_NPOINTS[kernel_size], 3)
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)


@pytest.mark.parametrize('b,n,m', [(3, 256, 128), (2, 100, 37)])
def test_fps_plain_equals_jax(b, n, m):
    rng = np.random.RandomState(n)
    x = _ball_points(rng, b, n)
    x[:, 5] = 0.0          # shadow-guarded points are never picked
    x[:, 17] = 0.01
    want = np.asarray(jsamp.furthest_point_sampling(jnp.asarray(x), m))
    got = tkern.fps.fps(torch.from_numpy(x), m)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.isin([5, 17], got.numpy()).any()


@pytest.mark.parametrize('m,n,ns,radius', [
    (64, 128, 16, 0.3),    # flagship-like: plenty of hits
    (32, 64, 32, 0.15),    # sparse: short neighborhoods, periodic fill
    (16, 12, 32, 0.6),     # n_sample > n (k_eff pad)
    (16, 64, 8, 0.02),     # mostly empty neighborhoods (all-zero rows)
])
def test_ball_query_plain_equals_jax(m, n, ns, radius):
    rng = np.random.RandomState(m + n)
    q = _ball_points(rng, 2, m)
    s = _ball_points(rng, 2, n)
    want = np.asarray(jsamp.ball_query(jnp.asarray(q), jnp.asarray(s),
                                       radius, ns))
    got = tkern.ball_query.ball_query(torch.from_numpy(q),
                                      torch.from_numpy(s), radius, ns)
    assert got.dtype == torch.int32 and got.shape == (2, m, ns)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('stride,lazy', [(2, False), (1, True), (2, True)])
def test_inter_grouping_ball_matches_jax(stride, lazy):
    x = _ball_points(np.random.RandomState(4), 2, 96)
    j = jsamp.inter_grouping_ball(jnp.asarray(x), stride, 0.35, 16, lazy)
    t = tsamp.inter_grouping_ball(torch.from_numpy(x), stride, 0.35, 16, lazy)
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), rtol=0,
                               atol=1e-6)
    for a, b in zip(t[1:3], j[1:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(t[3].numpy(), np.asarray(j[3]))


def test_shadow_padding_matches_jax():
    rng = np.random.RandomState(6)
    x = _ball_points(rng, 2, 10)
    f = rng.randn(2, 10, 60, 4).astype(np.float32)
    np.testing.assert_array_equal(
        tsamp.add_shadow_point(torch.from_numpy(x)).numpy(),
        np.asarray(jsamp.add_shadow_point(jnp.asarray(x))))
    np.testing.assert_array_equal(
        tsamp.add_shadow_feature(torch.from_numpy(f)).numpy(),
        np.asarray(jsamp.add_shadow_feature(jnp.asarray(f))))


def test_plain_switch_routes_to_plain_versions():
    x = torch.from_numpy(_ball_points(np.random.RandomState(9), 2, 64))
    tkern.reset_counts()
    a = tsamp.furthest_point_sampling(x, 16)
    with tkern.plain():
        assert tkern.plain_forced()
        b = tsamp.furthest_point_sampling(x, 16)
    assert not tkern.plain_forced()
    assert torch.equal(a, b)
    # CPU tensors never launch a kernel
    assert tkern.counts() == {'fps': 0, 'ball_query': 0, 'inter_conv': 0,
                              'inter_conv_dtable': 0, 'inter_conv_dw': 0,
                              'intra_conv': 0, 'intra_conv_dw': 0}
