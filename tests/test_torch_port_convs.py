"""Torch port SO(3) convolutions against the JAX package on the CPU.

Inter conv: the port's plain W-fused inter conv against the JAX fp32 XLA
path (``inter_so3conv_fused(..., use_pallas=False)``) and against the Pallas
kernel itself (``fused_gather_conv_w`` in interpret mode, operands built as
tests/test_pallas_inter_conv.py builds them). Intra conv: the port's plain
version and layer against the JAX ``IntraSO3Conv`` layer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epn_pointcloud_tpu.nn import layers as jlayers
from epn_pointcloud_tpu.ops import icosahedron as jico
from epn_pointcloud_tpu.ops import so3conv as jso3
from epn_pointcloud_tpu.ops.pallas import inter_conv as jic

from epn_pointcloud_tpu_torch import compat as tcompat
from epn_pointcloud_tpu_torch.nn import layers as tlayers
from epn_pointcloud_tpu_torch.ops import kernel_points as tkp
from epn_pointcloud_tpu_torch.ops import kernels as tkern
from epn_pointcloud_tpu_torch.ops import so3conv as tso3
from epn_pointcloud_tpu_torch.ops.so3conv import SphericalPointCloud

# fp32 reassociation between two formulations of the same sums (einsum
# orders, anchor weights via the |gx|^2 + |k|^2 - 2 gx.rk expansion)
RTOL, ATOL = 2e-4, 2e-4


def _ball_points(rng, b, n):
    v = rng.randn(b, n, 3)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return (v * rng.rand(b, n, 1) ** (1.0 / 3.0)).astype(np.float32)


@pytest.mark.parametrize('nn,stride,lazy', [(16, 1, True), (32, 2, False)])
def test_inter_conv_matches_jax_xla_path(nn, stride, lazy):
    rng = np.random.RandomState(nn)
    b, p1, c, d, radius, sigma = 2, 64, 64, 32, 0.4, 0.08
    x = _ball_points(rng, b, p1)
    f = rng.randn(b, p1, 60, c).astype(np.float32)
    kern = tkp.get_spherical_kernel_points(0.7 * radius, 1)
    W = (0.05 * rng.randn(kern.shape[0], c, d)).astype(np.float32)
    anchors = jico.get_anchors(60)
    j_idx, j_xyz, j_out, j_sidx = jso3.inter_so3conv_fused(
        jnp.asarray(x), jnp.asarray(f), stride, nn, jnp.asarray(anchors),
        jnp.asarray(kern), radius, sigma, jnp.asarray(W), lazy_sample=lazy,
        anchor_chunk=20, use_pallas=False)
    t_idx, t_xyz, t_out, t_sidx = tso3.inter_so3conv_fused(
        torch.from_numpy(x), torch.from_numpy(f), stride, nn,
        torch.from_numpy(anchors), torch.from_numpy(kern), radius, sigma,
        torch.from_numpy(W), lazy_sample=lazy)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_sidx.numpy(), np.asarray(j_sidx))
    np.testing.assert_array_equal(t_xyz.numpy(), np.asarray(j_xyz))
    assert t_out.shape == (b, -(-p1 // stride), 60, d)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out),
                               rtol=RTOL, atol=ATOL)


def test_ones_input_layer_matches_jax_xla_path():
    """Block-0 layer 0: occupancy-ones input (c_in = 1), FPS, stride 2."""
    rng = np.random.RandomState(1)
    b, p1, d, radius, sigma = 2, 64, 32, 0.2, 0.02
    x = _ball_points(rng, b, p1)
    f = np.ones((b, p1, 60, 1), np.float32)
    kern = tkp.get_spherical_kernel_points(0.7 * radius, 1)
    W = (0.1 * rng.randn(kern.shape[0], 1, d)).astype(np.float32)
    anchors = jico.get_anchors(60)
    j = jso3.inter_so3conv_fused(
        jnp.asarray(x), jnp.asarray(f), 2, 16, jnp.asarray(anchors),
        jnp.asarray(kern), radius, sigma, jnp.asarray(W), lazy_sample=False,
        anchor_chunk=60, use_pallas=False, ones_input=True)
    t = tso3.inter_so3conv_fused(
        torch.from_numpy(x), torch.from_numpy(f), 2, 16,
        torch.from_numpy(anchors), torch.from_numpy(kern), radius, sigma,
        torch.from_numpy(W), lazy_sample=False, ones_input=True)
    np.testing.assert_allclose(t[2].numpy(), np.asarray(j[2]),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('N,P,AC,C,D,Q', [
    (16, 16, 4, 64, 32, 61),
    (32, 16, 4, 64, 64, 61),
])
def test_inter_conv_plain_matches_pallas_kernel(N, P, AC, C, D, Q):
    """The W-fused kernel contract, against the TPU kernel in interpret
    mode; some neighbor slots hold the shadow index (a zero row)."""
    rng = np.random.RandomState(3)
    B, K, sigma = 2, 24, 0.1
    gx = (0.3 * rng.randn(B, P, N, 3)).astype(np.float32)
    tab = rng.randn(B, Q, AC * C).astype(np.float32)
    idx = rng.randint(0, Q + 1, size=(B, P, N)).astype(np.int32)  # Q = shadow
    anch = rng.randn(AC, 3, 3).astype(np.float32)
    ker = (0.3 * rng.randn(K, 3)).astype(np.float32)
    W = (0.1 * rng.randn(K, C, D)).astype(np.float32)

    rk = jnp.einsum('aij,kj->aki', jnp.asarray(anch), jnp.asarray(ker))
    k2 = jnp.sum(jnp.asarray(ker) ** 2, -1)
    nt, tp, kt, _ = jic.plan(N, K)
    assert kt == K and nt == N
    gx8 = jic.make_gx8(jnp.asarray(gx), nt)
    rk8t = jic.make_rk8(rk, k2, tp, kt, sigma)
    rk8k = jic.make_rk8_kmajor(rk, k2, tp, kt, sigma)
    qp = -(-Q // 8) * 8
    tabp = jnp.pad(jnp.asarray(tab), ((0, 0), (0, qp - Q), (0, 0)))
    idx3 = jnp.asarray(idx).reshape(B, 1, P * nt)
    want = jic.fused_gather_conv_w(gx8, idx3, tabp, rk8k, rk8t,
                                   jnp.asarray(W).reshape(K * C, D), sigma,
                                   tp, kt, nt, None, True)
    got = tkern.inter_conv.inter_conv(
        torch.from_numpy(gx), torch.from_numpy(idx),
        torch.from_numpy(tab).reshape(B, Q, AC, C),
        torch.from_numpy(np.array(rk)), torch.from_numpy(np.array(k2)),
        torch.from_numpy(W), sigma)
    np.testing.assert_allclose(got.reshape(B, P, AC * D).numpy(),
                               np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('c,d', [(16, 32), (32, 64)])
def test_intra_conv_matches_jax_layer(c, d):
    rng = np.random.RandomState(c)
    f = rng.randn(2, 5, 60, c).astype(np.float32)
    jmod = jlayers.IntraSO3Conv(c, d)
    x = jso3.SphericalPointCloud(jnp.zeros((2, 5, 3)), jnp.asarray(f), None)
    variables = jax.jit(lambda: jmod.init(jax.random.PRNGKey(c), x))()
    want = np.asarray(jax.jit(jmod.apply)(variables, x).feats)
    W = np.array(variables['params']['W'])                   # [12, c, d]

    plain = tkern.intra_conv.intra_conv(
        torch.from_numpy(f), torch.from_numpy(jico.get_intra_idx()),
        torch.from_numpy(W))
    np.testing.assert_allclose(plain.numpy(), want, rtol=RTOL, atol=1e-5)

    layer = tlayers.IntraSO3Conv(c, d)
    layer.basic_conv.W.data = tcompat._so3_w(W)
    with torch.no_grad():
        out = layer(SphericalPointCloud(torch.zeros(2, 5, 3),
                                        torch.from_numpy(f), None))
    np.testing.assert_allclose(out.feats.numpy(), want, rtol=RTOL, atol=1e-5)
