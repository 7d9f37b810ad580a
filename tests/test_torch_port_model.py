"""Whole-slice parity of the torch port (epn_pointcloud_tpu_torch) against the
JAX package on the CPU: the fp32 cls_so3net_pn eval forward on shared
weights (moved by epn_pointcloud_tpu_torch.compat.from_jax_variables), the
weight round trip through epn_pointcloud_tpu.compat, the eval losses, and
the import boundary (the port never imports jax).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epn_pointcloud_tpu import compat as jcompat
from epn_pointcloud_tpu import losses as jlosses
from epn_pointcloud_tpu.app import config as jconfig
from epn_pointcloud_tpu.models import cls_so3net_pn as jcls

from epn_pointcloud_tpu_torch import compat as tcompat
from epn_pointcloud_tpu_torch import losses as tlosses
from epn_pointcloud_tpu_torch.models import cls_so3net_pn as tcls

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_MLPS = ((8, 8), (16,))


def _opt(input_num=256):
    opt = jconfig.default_opt()
    opt.model.model = 'cls_so3net_pn'
    opt.model.flag = 'attention'
    opt.model.kanchor = 60
    opt.model.input_num = input_num
    return opt


def _ball_points(rng, b, n):
    v = rng.randn(b, n, 3)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return (v * rng.rand(b, n, 1) ** (1.0 / 3.0)).astype(np.float32)


def _randomize_stats(variables, rng):
    """Move every BatchNorm off its init (running stats and affine), so the
    eval-mode parity is not a check of identity normalizations."""
    def walk(p, s):
        for k in p:
            if k.startswith('BatchNorm_'):
                c = p[k]['scale'].shape[0]
                p[k]['scale'] = (1.0 + 0.2 * rng.randn(c)).astype(np.float32)
                p[k]['bias'] = (0.1 * rng.randn(c)).astype(np.float32)
                s[k]['mean'] = (0.1 * rng.randn(c)).astype(np.float32)
                s[k]['var'] = (0.5 + rng.rand(c)).astype(np.float32)
            elif isinstance(p[k], dict) and k in s:
                walk(p[k], s[k])
    walk(variables['params'], variables['batch_stats'])
    return variables


def _to_numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope='module')
def small_pair():
    """(jax model, numpy variables, port model) on shared weights."""
    opt = _opt()
    jmodel = jcls.build_model(opt, mlps=SMALL_MLPS)
    x0 = jnp.zeros((2, 256, 3), jnp.float32)
    variables = jax.jit(lambda: jmodel.init(jax.random.PRNGKey(0), x0,
                                            train=False))()
    variables = _to_numpy_tree({'params': variables['params'],
                                'batch_stats': variables['batch_stats']})
    variables = _randomize_stats(variables, np.random.RandomState(5))
    tmodel = tcls.build_model(opt, mlps=SMALL_MLPS).eval()
    tmodel.load_state_dict(tcompat.from_jax_variables(variables))
    return jmodel, variables, tmodel


def test_small_model_logits_match_jax(small_pair):
    jmodel, variables, tmodel = small_pair
    x = _ball_points(np.random.RandomState(7), 2, 256)
    jl, jf = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        tl, tf = tmodel(torch.from_numpy(x))
    assert tl.shape == (2, 40) and tf.shape == (2, 60)
    # model-level tolerance of tests/test_reference_parity.py
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-3, atol=2e-3)


def test_state_dict_round_trip_through_jax_compat(small_pair):
    """epn_pointcloud_tpu.compat.import_state_dict maps the port's
    state_dict (original EPN names and shapes) back onto the JAX tree."""
    _, variables, tmodel = small_pair
    tree = jcompat.import_state_dict(variables, tmodel.state_dict())
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(tree))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf)


def test_state_dict_keys_are_the_original_epn_names(small_pair):
    keys = set(small_pair[2].state_dict())
    assert 'backbone.0.blocks.0.inter_conv.conv.basic_conv.W' in keys
    assert 'backbone.1.blocks.0.intra_conv.conv.basic_conv.W' in keys
    assert 'backbone.0.blocks.1.skip_conv.weight' in keys
    assert 'outblock.fc2.weight' in keys
    assert 'outblock.attention_layer.weight' in keys
    assert small_pair[2].state_dict()[
        'backbone.0.blocks.0.inter_conv.conv.basic_conv.W'].shape == (8, 24)


def test_seeded_init_is_deterministic():
    opt = _opt()
    a = tcls.build_model(opt, mlps=SMALL_MLPS, seed=3).state_dict()
    b = tcls.build_model(opt, mlps=SMALL_MLPS, seed=3).state_dict()
    c = tcls.build_model(opt, mlps=SMALL_MLPS, seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a['outblock.fc2.weight'], c['outblock.fc2.weight'])


@pytest.mark.parametrize('loss_type', ['default', 'no_reg', 'schedule'])
def test_attention_cross_entropy_matches_jax(loss_type):
    rng = np.random.RandomState(11)
    pred = rng.randn(6, 40).astype(np.float32)
    wts = rng.randn(6, 60).astype(np.float32)
    label = rng.randint(0, 40, 6)
    rlabel = rng.randint(0, 60, 6)
    jl, jaux = jlosses.attention_cross_entropy(
        jnp.asarray(pred), jnp.asarray(label), jnp.asarray(wts),
        jnp.asarray(rlabel), loss_type, 1.0, iter_counter=500)
    tl, taux = tlosses.attention_cross_entropy(
        torch.from_numpy(pred), torch.from_numpy(label), torch.from_numpy(wts),
        torch.from_numpy(rlabel), loss_type, 1.0, iter_counter=500)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6, atol=1e-6)
    for k in ('cls_loss', 'r_loss', 'acc', 'racc'):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=1e-6, atol=1e-6)


def test_builder_matches_jax_block_parameters():
    """The builder arithmetic (int() truncations included) is a verbatim
    copy: the full-width flagship parameter trees agree."""
    opt = _opt(1024)
    j = jcls.build_model(opt).params
    t = tcls.build_model(opt, seed=None).params
    assert t == j


def test_import_does_not_pull_in_jax():
    code = ('import sys, epn_pointcloud_tpu_torch\n'
            'import epn_pointcloud_tpu_torch.app.trainer_modelnet\n'
            'import epn_pointcloud_tpu_torch.run_modelnet\n'
            'import epn_pointcloud_tpu_torch.train\n'
            'import epn_pointcloud_tpu_torch.data.modelnet40\n'
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "flax", "epn_pointcloud_tpu")]\n'
            'print(bad)\n'
            'assert not bad, bad\n')
    env = dict(os.environ)
    env['PYTHONPATH'] = REPO
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         env=env, capture_output=True, text=True)
    assert res.returncode == 0, res.stdout + res.stderr
