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


@pytest.mark.parametrize('kernel_size', [1, 2, 3])
def test_kernel_points_match_jax(kernel_size):
    t = tkp.get_spherical_kernel_points(0.7 * 0.4, kernel_size)
    j = jkp.get_spherical_kernel_points(0.7 * 0.4, kernel_size)
    assert t.shape == j.shape == (tkp.KERNEL_SIZE_TO_NPOINTS[kernel_size], 3)
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)


@pytest.mark.parametrize('b,n,m', [(3, 256, 128), (2, 100, 37),
                                   # clouds that leave the register
                                   # kernel's last points a thread part
                                   # full, and one point past 1024
                                   (2, 300, 150), (2, 1000, 250),
                                   (1, 1025, 300),
                                   # every point picked
                                   (2, 64, 64)])
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
    (48, 256, 64, 0.5),    # 64 slots: hits and fill past one warp's 32
    (40, 256, 64, 0.3),    # 64 slots, most rows filled periodically
    (24, 20, 16, 0.8),     # n < 32: one partial scan step
    (24, 33, 32, 0.9),     # n = 33: one point past a whole scan step
    (20, 33, 48, 1.5),     # n_sample > n, every point a hit
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


def _fps_cloud(kind, rng):
    """[2, 96, 3] clouds that the sampling kernels find hard: 'dup' every
    point four times (ties at every pick), 'shadow' every point
    shadow-guarded (the picks are all 0), 'mixed' a half of each."""
    x = _ball_points(rng, 2, 96)
    if kind == 'dup':
        x = np.repeat(x[:, :24], 4, axis=1)
    elif kind == 'shadow':
        x *= 0.01
    else:
        x[:, 1::2] *= 0.01
    return x


@pytest.mark.parametrize('kind', ['dup', 'shadow', 'mixed'])
@pytest.mark.parametrize('m', [40, 96])
def test_fps_plain_equals_jax_on_hard_clouds(kind, m):
    x = _fps_cloud(kind, np.random.RandomState(3))
    want = np.asarray(jsamp.furthest_point_sampling(jnp.asarray(x), m))
    got = tkern.fps.fps(torch.from_numpy(x), m)
    np.testing.assert_array_equal(got.numpy(), want)
    if kind == 'shadow':
        assert not want.any()


def _last_point_hits(ns, n=70, m=6):
    """Queries whose ns-th hit is the support's last point: the support
    sits on a line, the query at its far end sees the last ns points."""
    s = np.zeros((1, n, 3), np.float32)
    s[0, :, 0] = np.arange(n, dtype=np.float32) / n
    q = np.zeros((1, m, 3), np.float32)
    q[0, :, 0] = 1.0 + np.arange(m, dtype=np.float32) / (8 * n)
    return q, s, (ns + 0.5) / n


@pytest.mark.parametrize('ns', [1, 16, 33, 64])
def test_ball_query_plain_equals_jax_with_a_hit_at_the_last_point(ns):
    q, s, radius = _last_point_hits(ns)
    want = np.asarray(jsamp.ball_query(jnp.asarray(q), jnp.asarray(s),
                                       radius, ns))
    got = tkern.ball_query.ball_query(torch.from_numpy(q),
                                      torch.from_numpy(s), radius, ns)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == s.shape[1] - 1).any()


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
    assert tkern.counts() == {'fps': 0, 'ball_query': 0, 'ones_conv': 0,
                              'inter_conv': 0, 'inter_conv_dtable': 0,
                              'inter_conv_dw': 0, 'inter_conv_f': 0,
                              'inter_conv_dg': 0, 'intra_conv': 0,
                              'intra_conv_dw': 0, 'intra_conv_prenorm': 0,
                              'intra_conv_prenorm_df': 0,
                              'intra_conv_prenorm_dw': 0,
                              'moments': 0, 'grouped_conv': 0,
                              'grouped_conv_tail': 0, 'grouped_conv_bwd': 0}


def _fma32(a, b, c):
    """a * b + c in float32 rounded once (the product of two float32 values
    is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def _ones_conv_folded(gx, rk, k2, sigma):
    """The ones conv kernel's arithmetic (csrc/ones_conv.cu) in torch
    float32: a = R_a kappa_k * (2 / sigma) and c = 1 - |kappa_k|^2 / sigma a
    lane, h = |gx|^2 / sigma a neighbor, the weight (c - h) + gx . a by
    three fused multiply-adds, the last clamped to [0, 1], summed over the
    neighbors n = q (mod 4) in order for each q, the four partial sums
    added in order of q."""
    inv = 1.0 / torch.tensor(sigma, dtype=torch.float32)
    a = rk * (2.0 * inv)
    c = _fma32(-k2, inv, torch.ones(()))
    x, y, z = gx.unbind(-1)
    h = _fma32(z, z, _fma32(y, y, x * x)) * inv
    b, p2, nn, _ = gx.shape
    acc = torch.zeros(b, p2, *rk.shape[:2])
    for q in range(4):
        part = torch.zeros_like(acc)
        for n in range(q, nn, 4):
            at = [v[:, :, n, None, None] for v in (x, y, z)]
            s = _fma32(at[0], a[..., 0], c - h[:, :, n, None, None])
            s = _fma32(at[1], a[..., 1], s)
            part = part + _fma32(at[2], a[..., 2], s).clamp(0.0, 1.0)
        acc = acc + part
    return acc


@pytest.mark.parametrize('model', ['cls_so3net_pn', 'inv_so3net_pn',
                                   'reg_so3net'])
def test_ones_conv_folded_weight_matches_plain(model):
    """The kernel's folded weight on the model's layer-0 geometry (radius,
    sigma and neighbors from its block parameters, 60 anchors, 24 kernel
    points, stride 2 from 1024 points; inv: patches of radius 0.4; reg: a
    normalized asymmetric airplane, whose clusters give 64 near neighbors,
    where one chain of 64 adds was 1.6x the plain version's error): within
    a normwise 1e-5 of ones_conv_plain, and its error against a float64
    evaluation at most 1.5x the plain version's."""
    from epn_pointcloud_tpu_torch import models, run_3dmatch
    from epn_pointcloud_tpu_torch.app import config
    from epn_pointcloud_tpu_torch.data import pc as tpc
    from epn_pointcloud_tpu_torch.data import synthetic
    from epn_pointcloud_tpu_torch.ops import so3conv as tso3
    opt = config.parse_args(['experiment', '-d', 'unused'])
    if model == 'inv_so3net_pn':
        opt = run_3dmatch.config_opt_3dmatch(opt)
    opt.model.model, opt.model.flag = model, 'attention'
    layer0 = models.build_model_from(opt, seed=None).params['backbone'][0][0]
    radius, sigma = layer0['args']['radius'], layer0['args']['sigma']
    rng = np.random.RandomState(11)
    if model == 'reg_so3net':
        x = tpc.normalize_np(synthetic.make_asym_shape(rng, 1024).T).T
        x = torch.from_numpy(np.ascontiguousarray(x[None], np.float32))
    else:
        scale = 1.0 if model == 'cls_so3net_pn' else \
            opt.model.search_radius
        x = torch.from_numpy(scale * _ball_points(rng, 1, 1024))
    kern = torch.from_numpy(tkp.get_spherical_kernel_points(
        tkp.KERNEL_CONDENSE_RATIO * radius, 1))
    rk, k2 = tso3.rotated_kernels(torch.from_numpy(tico.get_anchors(60)),
                                  kern)
    gx = tsamp.inter_grouping_ball(x, 2, radius,
                                   layer0['args']['n_neighbor'])[0]
    gx = gx.contiguous()
    got = _ones_conv_folded(gx, rk, k2, sigma)
    want = tkern.ones_conv.ones_conv_plain(gx, rk, k2, sigma)
    w64 = tkern.ones_conv.ones_conv_plain(gx.double(), rk.double(),
                                          k2.double(), sigma, torch.float64)

    def rel(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm())
    assert got.shape == (1, 512, 60, 24)
    assert rel(got, want) <= 1e-5
    assert rel(got, w64) <= 1.5 * rel(want, w64)


def test_ones_conv_variant_builds_substitute_text_in_the_source():
    """Each build of ``ones_conv_variants`` replaces text that
    csrc/ones_conv.cu holds exactly once (on the card a missing text fails
    the whole run)."""
    import os
    from epn_pointcloud_tpu_torch import ones_conv_variants as ocv
    with open(os.path.join(ocv.build.CSRC_DIR, 'ones_conv.cu')) as f:
        src = f.read()
    subs = [sub for sub in ocv.VARIANTS.values() if sub is not None]
    assert subs
    for sub in subs:
        for old, _ in ocv._pairs(sub):
            assert src.count(old) == 1, old
