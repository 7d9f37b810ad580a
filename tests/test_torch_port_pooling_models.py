"""xyz pooling in the torch port's models (epn_pointcloud_tpu_torch)
against the JAX package on the CPU: the three builders' ``xyz_pooling``
keyword ('stride' and 'no-stride'; the trees' neighbor counts and the eval
outputs), and one fp32 train step of the 'stride'-pooled cls model (loss,
and per-leaf gradients by the rule of
tests/test_reference_train_parity.py:143-209). Whole models are held at
the cls parity tolerance (rtol 1e-3, atol 2e-3,
tests/test_torch_port_model.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epn_pointcloud_tpu import compat as jcompat
from epn_pointcloud_tpu import losses as jlosses
from epn_pointcloud_tpu.app import config as jconfig
from epn_pointcloud_tpu.models import cls_so3net_pn as jcls
from epn_pointcloud_tpu.models import inv_so3net_pn as jinv
from epn_pointcloud_tpu.models import reg_so3net as jreg

from epn_pointcloud_tpu_torch import losses as tlosses
from epn_pointcloud_tpu_torch.models import cls_so3net_pn as tcls
from epn_pointcloud_tpu_torch.models import inv_so3net_pn as tinv
from epn_pointcloud_tpu_torch.models import reg_so3net as treg

from test_torch_port_train import _assert_grads_close, _perturb_norm_biases

N_POINTS = 64
MLPS, OUT_MLPS = ((8,), (8,)), (8,)


def _opt(kind, kanchor=60):
    opt = jconfig.default_opt(**{
        'model.model': {'cls': 'cls_so3net_pn', 'inv': 'inv_so3net_pn',
                        'reg': 'reg_so3net'}[kind],
        'model.flag': 'rotation' if kind == 'reg' else 'attention',
        # the inv builder scales block 0's neighbors by int(input_num /
        # 1024): it keeps the 1024 of its configuration (the clouds stay
        # N_POINTS), as tests/test_torch_port_kanchor_inv_reg.py
        'model.input_num': 1024 if kind == 'inv' else N_POINTS,
        'model.search_radius': 0.4})
    opt.model.kanchor = kanchor
    return opt


BUILD = {'cls': (jcls, tcls), 'inv': (jinv, tinv), 'reg': (jreg, treg)}


def _pair(kind, pooling, kanchor=60, seed=0):
    """(JAX model, variables, port model) of ``kind`` built with
    ``xyz_pooling``, on the port's seeded weights (BatchNorms moved off
    their init) carried to the JAX tree."""
    opt = _opt(kind, kanchor)
    jmod, tmod = BUILD[kind]
    kw = dict(mlps=MLPS, out_mlps=OUT_MLPS, xyz_pooling=pooling)
    jm = jmod.build_model(opt, **kw)
    tm = tmod.build_model(opt, seed=seed, **kw)
    sd = _perturb_norm_biases(tm.state_dict())
    tm.load_state_dict(sd)
    x0 = jnp.zeros((1, 2, N_POINTS, 3) if kind == 'reg' else
                   (2, N_POINTS, 3))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x0,
                                            train=False))
    zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                                   dict(shapes))
    return jm, jcompat.import_state_dict(zeros, sd), tm


def _points(shape, seed):
    v = np.random.RandomState(seed).randn(*shape)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    r = np.random.RandomState(seed + 1).rand(*shape[:-1], 1) ** (1 / 3)
    return (v * r).astype(np.float32)


@pytest.mark.parametrize('kind,pooling', [('cls', 'stride'),
                                          ('cls', 'no-stride'),
                                          ('inv', 'stride'),
                                          ('reg', 'no-stride')])
def test_pooled_models_match_jax(kind, pooling):
    """Each builder with ``xyz_pooling``: the tree doubles block j's first
    neighbor count only where its conv is strided (JAX
    models/cls_so3net_pn.py:93-100) and names the pooling in every layer;
    the eval outputs against JAX's at the cls parity tolerance."""
    jm, v, tm = _pair(kind, pooling)
    for i, block in enumerate(tm.params['backbone']):
        for layer in block:
            assert layer['args']['pooling'] == pooling
    x = _points((1, 2, N_POINTS, 3) if kind == 'reg' else (2, N_POINTS, 3),
                seed=5)
    jout = jm.apply(v, jnp.asarray(x), train=False)
    with torch.no_grad():
        tout = tm.eval()(torch.from_numpy(x))
    for t, j in zip(tout, jout):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-3,
                                   atol=2e-3)


def test_stride_pooling_neighbors_follow_jax():
    """'stride' keeps block 0's doubled neighbors (its conv strides: the
    occupancy input is never pooled) and drops the doubling elsewhere;
    'no-stride' doubles every block's first layer, as JAX's trees."""
    for pooling in ('stride', 'no-stride', None):
        opt = _opt('cls')
        kw = dict(mlps=((8, 8), (8, 8)), out_mlps=OUT_MLPS,
                  xyz_pooling=pooling)
        jtree = jcls.build_model(opt, **kw).params
        ttree = tcls.build_model(opt, seed=None, **kw).params
        assert [[layer['args']['n_neighbor'] for layer in block]
                for block in ttree['backbone']] == [
            [layer['args']['n_neighbor'] for layer in block]
            for block in jtree['backbone']]


@pytest.fixture(scope='module')
def pooled_step():
    """One fp32 train step of the 'stride'-pooled cls model at kanchor 20
    in both packages on shared weights (norm biases moved off zero) and one
    batch: the attention CE, and the JAX float64 gradient for the leaves'
    scales. Its inter_block layers all take the unfused path. (At 60
    anchors block 0's skip conv feeds a BatchNorm over a constant field,
    whose gradient is an exact zero that each package materializes as
    rounding noise of 1e-4..3e-3 on this small model, pooled or not:
    tests/test_reference_train_parity.py:99-117; the card holds the pooled
    60-anchor step to its plain path, chip_smoke.py's [pooling].)"""
    jm, v, tm = _pair('cls', 'stride', kanchor=20)
    rng = np.random.RandomState(17)
    x = _points((2, N_POINTS, 3), seed=17)
    label, rlabel = rng.randint(0, 40, 2), rng.randint(0, 60, 2)

    def loss_fn(params):
        (pred, feat), _ = jm.apply(
            {'params': params, 'batch_stats': v['batch_stats']},
            jnp.asarray(x), train=True, mutable=['batch_stats'])
        return jlosses.attention_cross_entropy(
            pred, jnp.asarray(label), feat, jnp.asarray(rlabel), 'default',
            1.0)[0]
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(v['params'])
    with jax.enable_x64():
        p64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, np.float64)), v['params'])
        g64 = jax.jit(jax.grad(loss_fn))(p64)
    flat, _ = jax.tree_util.tree_flatten_with_path(g64)
    scales = {jax.tree_util.keystr(p): float(np.max(np.abs(g)))
              for p, g in flat}
    tm.train()
    pred, feat = tm(torch.from_numpy(x))
    tloss, _ = tlosses.attention_cross_entropy(
        pred, torch.from_numpy(label), feat, torch.from_numpy(rlabel),
        'default', 1.0)
    tloss.backward()
    grads = {n: p.grad.detach().clone() for n, p in tm.named_parameters()}
    grads.update({n: b.clone() for n, b in tm.named_buffers()})
    tgrads = jcompat.import_state_dict(v, grads)['params']
    return dict(jloss=float(jloss), jgrads=jgrads, tloss=tloss.item(),
                tgrads=tgrads, scales=scales)


def test_pooled_train_step_loss_matches_jax(pooled_step):
    np.testing.assert_allclose(pooled_step['tloss'], pooled_step['jloss'],
                               rtol=1e-5)


def test_pooled_train_step_gradients_match_jax(pooled_step):
    """Per leaf, the rule of tests/test_reference_train_parity.py:143-209
    (``_assert_grads_close`` of tests/test_torch_port_train.py): the W-off
    F's backward carries the pooled layers' feature gradients."""
    s = pooled_step
    degenerate = {p for p, m in s['scales'].items() if m <= 1e-5}
    _assert_grads_close(s['tgrads'], s['jgrads'], degenerate, s['scales'])
