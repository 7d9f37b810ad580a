"""The torch port's fp32 training step against the JAX package on the CPU.

Per module: ``InterConvFn`` / ``IntraConvFn`` backward (the plain backward
functions, which the CPU runs) against ``jax.grad`` of the Pallas kernels
in interpret mode, float64 gradcheck of both Functions, and the inverse
adjacency the card's intra df rides on. Whole slice: train-mode loss,
per-leaf gradients, BatchNorm running statistics, one Adam step and the
learning-rate schedule against the JAX package on shared weights; and the
train loader against the JAX loader.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epn_pointcloud_tpu import compat as jcompat
from epn_pointcloud_tpu import losses as jlosses
from epn_pointcloud_tpu.app import config as jconfig
from epn_pointcloud_tpu.data import modelnet40 as jdata
from epn_pointcloud_tpu.models import cls_so3net_pn as jcls
from epn_pointcloud_tpu.ops import icosahedron as jico
from epn_pointcloud_tpu.ops.pallas import inter_conv as jic
from epn_pointcloud_tpu.ops.pallas.intra_conv import intra_conv as jintra
from epn_pointcloud_tpu.parallel import train as jtrain

from epn_pointcloud_tpu_torch import compat as tcompat
from epn_pointcloud_tpu_torch import losses as tlosses
from epn_pointcloud_tpu_torch import train as ttrain
from epn_pointcloud_tpu_torch.app import config as tconfig
from epn_pointcloud_tpu_torch.data import modelnet40 as tdata
from epn_pointcloud_tpu_torch.data import synthetic as tsynth
from epn_pointcloud_tpu_torch.models import cls_so3net_pn as tcls
from epn_pointcloud_tpu_torch.ops import icosahedron as tico
from epn_pointcloud_tpu_torch.ops.kernels import inter_conv as tic
from epn_pointcloud_tpu_torch.ops.kernels import intra_conv as tik

SMALL_MLPS = ((8, 8), (16,))


def _ball_points(rng, b, n):
    v = rng.randn(b, n, 3)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return (v * rng.rand(b, n, 1) ** (1.0 / 3.0)).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


# ------------------------------------------------------------ conv kernels

@pytest.mark.parametrize('N,P,AC,C,D,Q', [
    (16, 16, 4, 64, 32, 61),    # tp=8: one-kernel _bwd_gather_w_kernel
    (32, 16, 4, 64, 64, 61),    # tp=4: split, c=64 -> _bwd_kernel_dw2_packed
])
def test_inter_conv_fn_backward_matches_pallas_vjp(N, P, AC, C, D, Q):
    """dTable and dW of InterConvFn against jax.grad through the TPU
    kernel's custom VJP (fused route: c > 32, tp > 2) in interpret mode,
    operands as tests/test_pallas_inter_conv.py builds them. A third of the
    neighbor slots hold the shadow index: the port's q, JAX's first zero pad
    row (qp = 64 > Q). Tolerance: normwise 1e-3, as that test's VJP check
    (fp32 sums in other orders, carried through cos)."""
    rng = np.random.RandomState(N)
    B, K, sigma = 2, 24, 0.1
    gx = (0.3 * rng.randn(B, P, N, 3)).astype(np.float32)
    tab = rng.randn(B, Q, AC * C).astype(np.float32)
    idx = rng.randint(0, Q, size=(B, P, N)).astype(np.int32)
    idx[:, :, ::3] = Q
    anch = rng.randn(AC, 3, 3).astype(np.float32)
    ker = (0.3 * rng.randn(K, 3)).astype(np.float32)
    W = (0.1 * rng.randn(K, C, D)).astype(np.float32)

    rk = jnp.einsum('aij,kj->aki', jnp.asarray(anch), jnp.asarray(ker))
    k2 = jnp.sum(jnp.asarray(ker) ** 2, -1)
    nt, tp, kt, _ = jic.plan(N, K)
    assert (nt, kt) == (N, K) and tp == 128 // N
    gx8 = jic.make_gx8(jnp.asarray(gx), nt)
    rk8t = jic.make_rk8(rk, k2, tp, kt, sigma)
    rk8k = jic.make_rk8_kmajor(rk, k2, tp, kt, sigma)
    qp = -(-Q // 8) * 8
    assert qp > Q
    tabp = jnp.pad(jnp.asarray(tab), ((0, 0), (0, qp - Q), (0, 0)))
    idx3 = jnp.asarray(idx).reshape(B, 1, P * nt)

    def loss(t, w2):
        out = jic.fused_gather_conv_w(gx8, idx3, t, rk8k, rk8t, w2, sigma,
                                      tp, kt, nt, None, True)
        return jnp.sum(jnp.sin(out))
    jdt, jdw = jax.grad(loss, argnums=(0, 1))(
        tabp, jnp.asarray(W).reshape(K * C, D))

    t_tab = torch.from_numpy(tab).reshape(B, Q, AC, C).requires_grad_()
    t_W = torch.from_numpy(W).requires_grad_()
    out = tic.InterConvFn.apply(
        torch.from_numpy(gx), torch.from_numpy(idx), t_tab,
        torch.from_numpy(np.array(rk)), torch.from_numpy(np.array(k2)), t_W,
        sigma)
    torch.sin(out).sum().backward()
    assert _rel(t_tab.grad.reshape(B, Q, AC * C).numpy(),
                np.asarray(jdt)[:, :Q]) < 1e-3
    assert _rel(t_W.grad.reshape(K * C, D).numpy(), jdw) < 1e-3


def test_intra_conv_fn_backward_matches_pallas_vjp():
    """df and dW of IntraConvFn against jax.grad through the TPU kernel's
    custom VJP in interpret mode (as tests/test_pallas_intra_conv.py:30-45,
    with its tolerances), w2 laid out per nn/layers.py:496-497."""
    rng = np.random.RandomState(0)
    ti = jico.get_intra_idx()
    na, nk = ti.shape
    b, p, c, d = 1, 8, 32, 48
    f = rng.randn(b, p, na, c).astype(np.float32)
    W = (0.1 * rng.randn(nk, c, d)).astype(np.float32)
    w2 = jnp.transpose(jnp.asarray(W), (1, 0, 2)).reshape(c, nk * d)
    tit = tuple(map(tuple, ti.tolist()))
    jdf, jdw2 = jax.grad(lambda f, w: jnp.sum(jnp.sin(jintra(
        f.reshape(b, p, na * c), w, tit, 8, True))), argnums=(0, 1))(
        jnp.asarray(f), w2)
    jdw = np.asarray(jdw2).reshape(c, nk, d).transpose(1, 0, 2)

    tf = torch.from_numpy(f).requires_grad_()
    tW = torch.from_numpy(W).requires_grad_()
    out = tik.IntraConvFn.apply(tf, torch.from_numpy(tico.get_intra_idx()),
                                torch.from_numpy(tico.get_intra_inv_idx()), tW)
    torch.sin(out).sum().backward()
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(jdf), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tW.grad.numpy(), jdw, rtol=1e-4, atol=1e-3)


def test_inverse_adjacency_turns_intra_df_into_the_forward():
    """Each column of trace_idx is a permutation, inv is its inverse, and
    the forward on (dout, inv, W^T) equals the scatter df (float64, exact up
    to summation order: atol 1e-12)."""
    ti, inv = tico.get_intra_idx(), tico.get_intra_inv_idx()
    np.testing.assert_array_equal(ti, jico.get_intra_idx())
    for k in range(ti.shape[1]):
        np.testing.assert_array_equal(ti[inv[:, k], k], np.arange(60))
    rng = np.random.RandomState(2)
    dout = torch.from_numpy(rng.randn(2, 3, 60, 8))
    W = torch.from_numpy(rng.randn(12, 5, 8))
    torch.testing.assert_close(
        tik.intra_conv_plain(dout, torch.from_numpy(inv), W.transpose(1, 2)),
        tik.intra_conv_df_plain(dout, torch.from_numpy(ti), W),
        rtol=0, atol=1e-12)


def test_conv_functions_pass_float64_gradcheck():
    """torch.autograd.gradcheck of both Functions (plain backward formulas)
    at tiny float64 shapes, shadow indices included."""
    rng = np.random.RandomState(4)
    b, p2, nn, q, na, c, d = 2, 3, 5, 6, 4, 3, 2
    gx = torch.from_numpy(0.3 * rng.randn(b, p2, nn, 3))
    idx = torch.from_numpy(rng.randint(0, q + 1, (b, p2, nn)).astype(np.int32))
    idx[:, :, 0] = q
    rk = torch.from_numpy(0.3 * rng.randn(na, 24, 3))
    k2 = torch.from_numpy(0.1 * rng.rand(24))
    tab = torch.from_numpy(rng.randn(b, q, na, c)).requires_grad_()
    W = torch.from_numpy(0.3 * rng.randn(24, c, d)).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda t, w: tic.InterConvFn.apply(gx, idx, t, rk, k2, w, 0.1),
        (tab, W))
    ti = torch.from_numpy(tico.get_intra_idx())
    inv = torch.from_numpy(tico.get_intra_inv_idx())
    f = torch.from_numpy(rng.randn(2, 2, 60, 3)).requires_grad_()
    W2 = torch.from_numpy(0.3 * rng.randn(12, 3, 2)).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda f, w: tik.IntraConvFn.apply(f, ti, inv, w), (f, W2))


# ------------------------------------------------------------- whole slice

def _opt(input_num=256):
    opt = jconfig.default_opt()
    opt.model.model = 'cls_so3net_pn'
    opt.model.flag = 'attention'
    opt.model.kanchor = 60
    opt.model.input_num = input_num
    return opt


def _tree_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), np.asarray(v)) for p, v in flat]


def _assert_tree_close(got, want, rtol, floor=1e-6, what=''):
    """Per-leaf max error relative to the leaf's max magnitude."""
    a, b = _tree_leaves(got), _tree_leaves(want)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, g), (_, w) in zip(a, b):
        scale = max(float(np.max(np.abs(w))), floor)
        err = float(np.max(np.abs(g - w)))
        assert err <= rtol * scale, f'{what} {path}: {err:.3e} vs {scale:.3e}'


def _assert_grads_close(got, want, degenerate, f64_scales, max_rel=5e-2,
                        l2_rel=1e-2, noise_abs=1e-3):
    """The rule of tests/test_reference_train_parity.py:143-209: per leaf,
    relative L2 <= 1e-2 and max error <= 5e-2 * max|grad|; leaves the
    float64 pass proved zero must be <= noise_abs in both; leaves below
    noise_abs in both must have a float64 gradient below it too, and agree
    within 2 * noise_abs."""
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


def _perturb_norm_biases(sd, seed=5):
    """Norm biases off zero (tests/test_reference_train_parity.py:99-117):
    at init the block-0 skip branch is a BatchNorm over a constant field,
    and its gradients are rounding noise, not a defined quantity."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in sd.items():
        if '.norm.' in k and k.endswith('.bias'):
            v = v + torch.from_numpy(
                0.3 * rng.randn(*v.shape).astype(np.float32))
        out[k] = v.clone()
    return out


@pytest.fixture(scope='module')
def train_step_pair():
    """One train step of both packages on shared weights and one batch."""
    opt = _opt()
    jmodel = jcls.build_model(opt, mlps=SMALL_MLPS)
    x0 = jnp.zeros((2, 256, 3), jnp.float32)
    init = jax.jit(lambda: jmodel.init(jax.random.PRNGKey(0), x0,
                                       train=False))()
    init = jax.tree_util.tree_map(np.asarray, {
        'params': init['params'], 'batch_stats': init['batch_stats']})
    tmodel = tcls.build_model(opt, mlps=SMALL_MLPS)
    tmodel.load_state_dict(tcompat.from_jax_variables(init))
    sd0 = _perturb_norm_biases(tmodel.state_dict())
    tmodel.load_state_dict(sd0)
    variables = jcompat.import_state_dict(init, sd0)

    rng = np.random.RandomState(17)
    x = _ball_points(rng, 2, 256)
    label = rng.randint(0, 40, 2)
    rlabel = rng.randint(0, 60, 2)

    def loss_fn(params):
        (pred, feat), mut = jmodel.apply(
            {'params': params, 'batch_stats': variables['batch_stats']},
            jnp.asarray(x), train=True, mutable=['batch_stats'])
        loss, aux = jlosses.attention_cross_entropy(
            pred, jnp.asarray(label), feat, jnp.asarray(rlabel), 'default',
            1.0)
        return loss, mut
    # eager, not jitted: under jit XLA's reduction order leaves ~1e-2 of
    # rounding noise in the BatchNorm over block 0's constant skip field
    # (var ~ 0, amplified by 1/sqrt(eps)), which the residual carries
    # through the whole model; eager JAX, like torch, leaves ~1e-5
    (jloss, jmut), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables['params'])

    tmodel.train()
    pred, feat = tmodel(torch.from_numpy(x))
    tloss, _ = tlosses.attention_cross_entropy(
        pred, torch.from_numpy(label), feat, torch.from_numpy(rlabel),
        'default', 1.0)
    tloss.backward()
    grad_sd = {n: p.grad.detach().clone() for n, p in
               tmodel.named_parameters()}
    grad_sd.update({n: b.detach().clone() for n, b in tmodel.named_buffers()
                    if n in sd0})
    tgrads = jcompat.import_state_dict(init, grad_sd)['params']
    return dict(opt=opt, jmodel=jmodel, init=init, variables=variables,
                loss_fn=loss_fn, jloss=float(jloss), jmut=jmut,
                jgrads=jgrads, tmodel=tmodel, tloss=tloss.item(),
                tgrads=tgrads, sd0=sd0)


def test_train_step_loss_and_gradients_match_jax(train_step_pair):
    s = train_step_pair
    np.testing.assert_allclose(s['tloss'], s['jloss'], rtol=1e-4)
    # the skippable leaves are derived, as the JAX package's own test does:
    # float64 gradients ~0 (<= 1e-5) are the mathematically-zero ones
    with jax.enable_x64():
        p64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, np.float64)),
            s['variables']['params'])
        g64 = jax.jit(jax.grad(lambda p: s['loss_fn'](p)[0]))(p64)
        scales = {p: float(np.max(np.abs(v))) for p, v in _tree_leaves(g64)}
    degenerate = {p for p, m in scales.items() if m <= 1e-5}
    assert degenerate, 'expected BN-invariant biases among the leaves'
    _assert_grads_close(s['tgrads'], s['jgrads'], degenerate, scales)


def test_train_step_batchnorm_stats_match_jax(train_step_pair):
    """Running mean and (unbiased) running var after one train forward."""
    s = train_step_pair
    tstats = jcompat.import_state_dict(
        s['init'], s['tmodel'].state_dict())['batch_stats']
    _assert_tree_close(tstats, s['jmut']['batch_stats'], rtol=1e-4,
                       what='batch_stats')


def test_adam_step_matches_optax(train_step_pair):
    """One torch Adam step (make_optimizer) against optax.adam on identical
    gradients, rtol 1e-5 of each leaf's magnitude."""
    import optax
    s = train_step_pair
    tmodel = s['tmodel']
    opt_t = ttrain.make_optimizer(tmodel.parameters(), 1e-3)
    opt_t.step()
    got = jcompat.import_state_dict(s['init'], tmodel.state_dict())['params']
    params = s['variables']['params']
    tx = optax.adam(1e-3, b1=0.9, b2=0.999, eps=1e-8)
    updates, _ = tx.update(s['tgrads'], tx.init(params), params)
    _assert_tree_close(got, optax.apply_updates(params, updates), rtol=1e-5,
                       what='adam')
    tmodel.load_state_dict(s['sd0'])


def test_lr_schedule_matches_optax():
    """Staircase decay at 0, decay_step - 1, decay_step, 2 * decay_step."""
    for kw in ({'init_lr': 1e-3, 'lr_type': 'exp_decay', 'decay_rate': 0.5,
                'decay_step': 20000},
               {'init_lr': 3e-4, 'lr_type': 'constant'}):
        js, ts = jtrain.make_lr_schedule(**kw), ttrain.make_lr_schedule(**kw)
        for step in (0, 19999, 20000, 40000):
            assert np.float32(ts(step)) == np.float32(js(step)), (kw, step)


# ------------------------------------------------------------- train loader

@pytest.mark.parametrize('input_num', [32, 48])
def test_train_loader_matches_jax_loader(tmp_path, input_num):
    """pc (resampled down from 40 points, or up), label, R, R_label and the
    shuffle order over two epochs equal the JAX loader's exactly."""
    root = str(tmp_path / 'mn')
    tsynth.make_modelnet_tree(root, n_cats=3, n_train=3, n_test=1,
                              n_points=40, seed=2, splits=('train',))
    argv = ['experiment', '-d', root, '--input-num', str(input_num)]
    jopt, topt = jconfig.parse_args(argv), tconfig.parse_args(argv)
    for o in (jopt, topt):
        o.model.flag = 'attention'
    jl = jdata.DataLoader(jdata.Dataloader_ModelNet40(jopt), 2, shuffle=True,
                          seed=jopt.seed, process_shard=False)
    tl = tdata.DataLoader(tdata.Dataloader_ModelNet40(topt, 'train'), 2,
                          shuffle=True, seed=topt.seed)
    jb, tb = list(jl) + list(jl), list(tl) + list(tl)
    assert len(jb) == len(tb) == 8          # 9 clouds, drop_last, 2 epochs
    for x, y in zip(jb, tb):
        assert x['fn'] == y['fn']
        assert y['pc'].shape == (2, input_num, 3)
        for k in ('pc', 'label', 'R', 'R_label'):
            np.testing.assert_array_equal(x[k], y[k])
