"""The torch port's rotation regression (reg_so3net, ModelNet rotation
alignment) against the JAX package on the CPU.

Rotation maps: the relative-rotation labels, the quaternion / ortho6d /
Euler sin-cos maps, the weighted chordal mean, the angles. Loss:
``multi_task_detection_loss`` in its three settings (na = 1, alignment,
canonical), values and gradients with respect to the attention and the
regression. Heads: ``RelSO3OutBlockR`` and ``SO3OutBlockR`` on the JAX
package's weights. Model: the builder's parameter tree, the weight import,
the full-width eval pair forward in fp32 and in bf16, and one train step of
a small reg model (loss and per-leaf gradients). Host side: the alignment
loader bit for bit, the synthetic asymmetric airplanes, and the entry point
(train, then eval through -r) on the CPU.
"""

import copy
import filecmp
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epn_pointcloud_tpu import compat as jcompat
from epn_pointcloud_tpu import losses as jlosses
from epn_pointcloud_tpu.app import config as jconfig
from epn_pointcloud_tpu.data import modelnet40 as jmn
from epn_pointcloud_tpu.data import synthetic as jsynth
from epn_pointcloud_tpu.models import reg_so3net as jreg
from epn_pointcloud_tpu.nn import heads as jheads
from epn_pointcloud_tpu.ops import rotation as jrot
from epn_pointcloud_tpu.ops import so3conv as jso3

from epn_pointcloud_tpu_torch import compat as tcompat
from epn_pointcloud_tpu_torch import losses as tlosses
from epn_pointcloud_tpu_torch import run_modelnet_rotation as trun
from epn_pointcloud_tpu_torch.app import config as tconfig
from epn_pointcloud_tpu_torch.app.trainer_modelnet_rotation import \
    TrainerModelNetRotation
from epn_pointcloud_tpu_torch.data import modelnet40 as tmn
from epn_pointcloud_tpu_torch.data import synthetic as tsynth
from epn_pointcloud_tpu_torch.models import reg_so3net as treg
from epn_pointcloud_tpu_torch.nn import heads as theads
from epn_pointcloud_tpu_torch.ops import icosahedron as tico
from epn_pointcloud_tpu_torch.ops import kernels as tkernels
from epn_pointcloud_tpu_torch.ops import rotation as trot
from epn_pointcloud_tpu_torch.ops import so3conv as tso3

SMALL_MLPS = ((32, 32), (64,))
SMALL_OUT = (64, 32)


def _opt(input_num=1024, representation='quat'):
    return jconfig.default_opt(**{'model.model': 'reg_so3net',
                                  'model.flag': 'rotation',
                                  'model.input_num': input_num,
                                  'model.representation': representation})


def _tree_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), np.asarray(v)) for p, v in flat]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _rotations(rng, n):
    q = rng.randn(n, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return np.asarray(jrot.rotation_from_quaternion(jnp.asarray(q)),
                      np.float64)


# ----------------------------------------------------------- rotation maps

def _rotation_case(name, rng):
    """(port output, JAX output) of one rotation function on seeded
    inputs."""
    anchors = tico.get_anchors(60)
    if name == 'label_relative_rotation_np':
        T = _rotations(rng, 1)[0]
        t = trot.label_relative_rotation_np(anchors, T)
        j = jrot.label_relative_rotation_np(anchors, T)
        return t, j
    if name == 'acos_safe':
        x = np.concatenate([rng.uniform(-1.2, 1.2, 64),
                            [1.0, -1.0, 1 - 1e-5, -1 + 2e-5]]).astype(
                                np.float32)
        return (trot.acos_safe(torch.from_numpy(x)),
                jrot.acos_safe(jnp.asarray(x)))
    if name in ('rotation_from_quaternion', 'rotation_from_ortho6d',
                'rotation_from_euler_sin_cos'):
        v = rng.randn(32, 4 if name.endswith('quaternion') else 6).astype(
            np.float32)
        return (getattr(trot, name)(torch.from_numpy(v)),
                getattr(jrot, name)(jnp.asarray(v)))
    Rs = _rotations(rng, 4 * 60).reshape(4, 60, 3, 3)
    Rs = (Rs + 0.05 * rng.randn(*Rs.shape)).astype(np.float32)
    if name == 'so3_mean':
        w = rng.rand(4, 60).astype(np.float32)
        return (trot.so3_mean(torch.from_numpy(Rs), torch.from_numpy(w)),
                jrot.so3_mean(jnp.asarray(Rs), jnp.asarray(w)))
    if name == 'so3_mean_unweighted':
        return (trot.so3_mean(torch.from_numpy(Rs)),
                jrot.so3_mean(jnp.asarray(Rs)))
    if name == 'angle_from_R':
        return (trot.angle_from_R(torch.from_numpy(Rs)),
                jrot.angle_from_R(jnp.asarray(Rs)))
    a, b = Rs[0], Rs[1]
    return (trot.mean_angular_error(torch.from_numpy(a), torch.from_numpy(b)),
            jrot.mean_angular_error(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize('name', [
    'label_relative_rotation_np', 'acos_safe', 'rotation_from_quaternion',
    'rotation_from_ortho6d', 'rotation_from_euler_sin_cos', 'so3_mean',
    'so3_mean_unweighted', 'angle_from_R', 'mean_angular_error'])
def test_rotation_functions_match_jax(name):
    """Each within 1e-5 of the JAX package's (the labels equal); the chordal
    mean a rotation."""
    t, j = _rotation_case(name, np.random.RandomState(3))
    if name == 'label_relative_rotation_np':
        np.testing.assert_array_equal(t[1], j[1])
        np.testing.assert_allclose(t[0], j[0], rtol=1e-5, atol=1e-5)
        return
    t = t.numpy()
    np.testing.assert_allclose(t, np.asarray(j), rtol=1e-5, atol=1e-5)
    if name.startswith('so3_mean'):
        np.testing.assert_allclose(np.linalg.det(t), 1.0, atol=1e-5)


# -------------------------------------------------------------------- loss

def _loss_inputs(setting, nr, seed=7):
    rng = np.random.RandomState(seed)
    anchors = tico.get_anchors(60).astype(np.float32)
    b = 3
    if setting == 'na1':
        R = _rotations(rng, b).astype(np.float32)[:, None]
        return dict(anchors=anchors, wts=rng.randn(b, 1), y=rng.randn(b, nr),
                    label=np.zeros(b, np.int64), gt_R=R, gt_T=R[:, 0])
    if setting == 'alignment':
        Ts = _rotations(rng, b)
        R, lab = zip(*(jrot.label_relative_rotation_np(anchors, T)
                       for T in Ts))
        return dict(anchors=anchors, wts=rng.randn(b, 60, 60),
                    y=rng.randn(b, 60, 60, nr), label=np.stack(lab),
                    gt_R=np.stack(R).astype(np.float32),
                    gt_T=Ts.astype(np.float32))
    # canonical: rotations near a third of the anchors, so the mask keeps
    # some and drops others
    gt_R = np.einsum('aij,bajk->baik', anchors, _rotations(
        rng, b * 60).reshape(b, 60, 3, 3) ** 3).astype(np.float32)
    gt_R[:, ::3] = np.eye(3, dtype=np.float32)
    return dict(anchors=anchors, wts=rng.randn(b, 60), y=rng.randn(b, 60, nr),
                label=rng.randint(0, 60, b), gt_R=gt_R, gt_T=None)


@pytest.mark.parametrize('nr', [4, 6])
@pytest.mark.parametrize('setting', ['na1', 'alignment', 'canonical'])
def test_multi_task_detection_loss_matches_jax(setting, nr):
    """Loss, every aux value and the gradient of the loss with respect to
    wts and y within 1e-5 (relative to each one's magnitude) of the JAX
    package's."""
    d = _loss_inputs(setting, nr)
    f32 = {k: (None if v is None else np.asarray(v, np.float32)
               if k not in ('label',) else v) for k, v in d.items()}

    def jloss(wts, y):
        return jlosses.multi_task_detection_loss(
            jnp.asarray(f32['anchors']), wts, jnp.asarray(f32['label']), y,
            jnp.asarray(f32['gt_R']),
            None if f32['gt_T'] is None else jnp.asarray(f32['gt_T']), nr=nr)
    (jl, jaux), (jgw, jgy) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(f32['wts']),
                                            jnp.asarray(f32['y']))
    wts = torch.from_numpy(f32['wts']).requires_grad_()
    y = torch.from_numpy(f32['y']).requires_grad_()
    tl, taux = tlosses.multi_task_detection_loss(
        torch.from_numpy(f32['anchors']), wts,
        torch.from_numpy(np.asarray(f32['label'])), y,
        torch.from_numpy(f32['gt_R']),
        None if f32['gt_T'] is None else torch.from_numpy(f32['gt_T']),
        nr=nr)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for k in ('cls_loss', 'l2_loss', 'r_acc', 'angular_error', 'pred_R'):
        want = np.asarray(jaux[k])
        np.testing.assert_allclose(taux[k].detach().numpy(), want, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(want).max()),
                                   err_msg=k)
    for t, want in ((wts, jgw), (y, jgy)):
        # na = 1 leaves wts out of the loss: no gradient, JAX's zeros
        got = torch.zeros_like(t) if t.grad is None else t.grad
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    # the alignment setting's chordal mean is built without a graph
    assert taux['pred_R'].requires_grad != (setting == 'alignment')


# ------------------------------------------------------------------- heads

def _jax_init(jmodel, x0):
    init = jax.jit(lambda: jmodel.init(jax.random.PRNGKey(0), x0,
                                       train=False))()
    return jax.tree_util.tree_map(np.asarray, dict(init))


def _head_inputs(rng, b=2, p=16, c=24):
    f = rng.randn(2, b, p, 60, c).astype(np.float32)
    x = rng.randn(2, b, p, 3).astype(np.float32)
    return f, x


def test_rel_so3_out_block_matches_jax():
    """RelSO3OutBlockR on the JAX module's weights (through
    from_jax_variables' reg head): confidence and y within 1e-5."""
    rng = np.random.RandomState(11)
    f, x = _head_inputs(rng)
    params = {'dim_in': 24, 'mlp': [32, 16], 'kanchor': 60,
              'representation': 'quat', 'temperature': 3.0}
    jhead = jheads.RelSO3OutBlockR(params)
    args = tuple(jnp.asarray(a) for a in (f[0], f[1], x[0], x[1]))
    v = jax.tree_util.tree_map(np.asarray, dict(
        jhead.init(jax.random.PRNGKey(1), *args, train=False)))
    jc, jy = jhead.apply(v, *args, train=False)
    thead = theads.RelSO3OutBlockR(params)
    sd = tcompat.from_jax_variables(
        {'params': {'RelSO3OutBlockR_0': v['params']}})
    thead.load_state_dict({k[len('outblock.'):]: t for k, t in sd.items()})
    with torch.no_grad():
        tc, ty = thead(*(torch.from_numpy(a) for a in (f[0], f[1], x[0],
                                                       x[1])))
    assert tc.shape == (2, 60, 60) and ty.shape == (2, 60, 60, 4)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)


def test_so3_out_block_matches_jax():
    """SO3OutBlockR (ortho6d) on the JAX module's weights: within 1e-5."""
    rng = np.random.RandomState(12)
    f, _ = _head_inputs(rng)
    params = {'dim_in': 24, 'mlp': [32, 16], 'kanchor': 60,
              'representation': 'ortho6d', 'temperature': 3.0}
    jhead = jheads.SO3OutBlockR(params)
    v = jax.tree_util.tree_map(np.asarray, dict(jhead.init(
        jax.random.PRNGKey(2), jnp.asarray(f[0]), train=False)))
    jc, jy = jhead.apply(v, jnp.asarray(f[0]), train=False)
    thead = theads.SO3OutBlockR(params)
    hp = v['params']
    names = ['linear.0', 'linear.1', 'attention_layer', 'regressor_layer']
    sd = {}
    for i, n in enumerate(names):
        k = np.asarray(hp[f'Dense1x1_{i}']['kernel']).T
        sd[f'{n}.weight'] = torch.from_numpy(k.copy()).reshape(
            k.shape + (1, 1))
        sd[f'{n}.bias'] = torch.from_numpy(
            np.asarray(hp[f'Dense1x1_{i}']['bias']).copy())
    thead.load_state_dict(sd)
    with torch.no_grad():
        tc, ty = thead(torch.from_numpy(f[0]))
    assert tc.shape == (2, 60) and ty.shape == (2, 60, 6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------------------------- model

@pytest.mark.parametrize('input_num', [1024, 2048])
def test_reg_builder_params_match_jax(tmp_path, input_num):
    """The block-parameter tree (params.json) equals the JAX builder's."""
    opt = _opt(input_num)
    jreg.build_model(opt, to_file=str(tmp_path / 'j.json'))
    treg.build_model(opt, seed=None, to_file=str(tmp_path / 't.json'))
    assert json.loads((tmp_path / 't.json').read_text()) == \
        json.loads((tmp_path / 'j.json').read_text())


def _pairs(rng, nb, n=1024):
    """nb pairs of a normalized asymmetric cloud and a rotated copy."""
    out = []
    for _ in range(nb):
        pc = tsynth.make_asym_shape(rng, n)
        pc = pc - pc.mean(0)
        pc = pc / np.linalg.norm(pc, axis=1).max()
        R = _rotations(rng, 1)[0]
        out.append(np.stack([pc @ R.T, pc]))
    return np.asarray(out, np.float32)


@pytest.fixture(scope='module')
def full_pair():
    """The full-width reg model in both packages on the JAX package's
    weights, and one well-spread pair of 1024 points."""
    opt = _opt()
    jmodel = jreg.build_model(opt)
    x = _pairs(np.random.RandomState(5), 1)
    init = _jax_init(jmodel, jnp.zeros((1, 2, 1024, 3), jnp.float32))
    tmodel = treg.build_model(opt, seed=None)
    tmodel.load_state_dict(tcompat.from_jax_variables(init))
    return dict(jmodel=jmodel, init=init, tmodel=tmodel.eval(), x=x)


def test_from_jax_variables_loads_every_reg_leaf(full_pair):
    """Every leaf of the full-width JAX reg model lands in the port's
    state_dict (strict load, no BatchNorm), and the JAX importer takes the
    port's state_dict back unchanged."""
    init = full_pair['init']
    assert 'batch_stats' not in init
    sd = full_pair['tmodel'].state_dict()
    assert not any('norm' in k for k in sd)
    back = jcompat.import_state_dict(init, sd)
    for (p, a), (_, b) in zip(_tree_leaves(back['params']),
                              _tree_leaves(init['params'])):
        np.testing.assert_array_equal(a, b, err_msg=p)


def test_reg_pair_forward_matches_jax(full_pair):
    """The eval-mode pair forward at full width (nb = 1 pair, 1024 points,
    60 anchors): confidence [1, 60, 60] and y [1, 60, 60, 4] within rtol
    1e-3, atol 2e-3 of the jitted JAX forward's."""
    s = full_pair
    jc, jy = jax.jit(lambda v: s['jmodel'].apply(s['init'], v, train=False))(
        jnp.asarray(s['x']))
    with torch.no_grad():
        tc, ty = s['tmodel'](torch.from_numpy(s['x']))
    assert tc.shape == (1, 60, 60) and ty.shape == (1, 60, 60, 4)
    np.testing.assert_allclose(tc.sum(1).numpy(), 1.0, rtol=1e-5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-3,
                               atol=2e-3)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-3,
                               atol=2e-3)


def _pair_cos(a, b):
    a = np.asarray(a, np.float64).reshape(a.shape[0], -1)
    b = np.asarray(b, np.float64).reshape(b.shape[0], -1)
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1)
                             * np.linalg.norm(b, axis=1))


def test_reg_bf16_forward_matches_jax(full_pair):
    """The bf16 production-mode pair forward at full width against the
    jitted JAX bf16 forward on the same weights: per-pair cosine of the
    attention logits' softmax (confidence) and of y >= 0.999, both fp32."""
    s = full_pair
    jso3.set_compute_dtype('bf16')
    try:
        jc, jy = jax.jit(lambda v: s['jmodel'].apply(s['init'], v,
                                                     train=False))(
            jnp.asarray(s['x']))
    finally:
        jso3.set_compute_dtype('fp32')
    tso3.set_compute_dtype('bf16')
    try:
        with torch.no_grad():
            tc, ty = s['tmodel'](torch.from_numpy(s['x']))
    finally:
        tso3.set_compute_dtype('fp32')
    assert tc.dtype == ty.dtype == torch.float32
    assert _pair_cos(tc.numpy(), jc).min() >= 0.999
    assert _pair_cos(ty.numpy(), jy).min() >= 0.999


def _assert_grads_close(got, want, degenerate, f64_scales, max_rel=5e-2,
                        l2_rel=1e-2, noise_abs=1e-3):
    """The per-leaf rule of tests/test_torch_port_inv.py (from
    tests/test_reference_train_parity.py:143-209): relative L2 <= 1e-2 and
    max error <= 5e-2 * max|grad|; leaves the float64 pass proved zero <=
    noise_abs in both; leaves below noise_abs in both need a float64
    gradient below it too and agree within 2 * noise_abs."""
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


def _step_inputs(x):
    """The alignment targets of pairs x [nb, 2, n, 3] whose source is the
    target under T (recovered from the points)."""
    anchors = tico.get_anchors(60)
    Ts = [np.linalg.lstsq(p[1], p[0], rcond=None)[0].T for p in x]
    R, lab = zip(*(trot.label_relative_rotation_np(anchors, T) for T in Ts))
    return (anchors.astype(np.float32), np.stack(lab),
            np.stack(R).astype(np.float32), np.stack(Ts).astype(np.float32))


def test_reg_train_step_matches_jax():
    """One train step of a small reg model (mlps ((32, 32), (64,)), head
    mlp (64, 32), 512 points) on two pairs: the multi-task loss within rtol
    1e-5 of the jitted JAX step's, and every gradient leaf by the per-leaf
    rule, the degenerate leaves from a float64 step of the port's plain
    path."""
    opt = _opt(512)
    kw = dict(mlps=SMALL_MLPS, out_mlps=SMALL_OUT)
    jmodel = jreg.build_model(opt, **kw)
    x = _pairs(np.random.RandomState(8), 2, 512)
    anchors, lab, R, T = _step_inputs(x)
    init = _jax_init(jmodel, jnp.zeros((1, 2, 512, 3), jnp.float32))

    def loss_fn(params):
        wts, y = jmodel.apply({'params': params}, jnp.asarray(x), train=True)
        return jlosses.multi_task_detection_loss(
            jnp.asarray(anchors), wts, jnp.asarray(lab), y, jnp.asarray(R),
            jnp.asarray(T), nr=4)[0]
    jl, jgrads = jax.jit(jax.value_and_grad(loss_fn))(init['params'])

    def port_step(model, dtype):
        model.train()
        model.zero_grad()
        with tkernels.plain():
            wts, y = model(torch.from_numpy(x).to(dtype))
            loss = tlosses.multi_task_detection_loss(
                torch.from_numpy(anchors).to(dtype), wts,
                torch.from_numpy(lab), y, torch.from_numpy(R).to(dtype),
                torch.from_numpy(T).to(dtype), nr=4)[0]
            loss.backward()
        return loss.item(), jcompat.import_state_dict(init, {
            n: p.grad.float() for n, p in model.named_parameters()})['params']
    tmodel = treg.build_model(opt, seed=None, **kw)
    tmodel.load_state_dict(tcompat.from_jax_variables(init))
    tl, tgrads = port_step(tmodel, torch.float32)
    _, g64 = port_step(copy.deepcopy(tmodel).double(), torch.float64)
    np.testing.assert_allclose(tl, float(jl), rtol=1e-5)
    scales = {p: float(np.max(np.abs(v))) for p, v in _tree_leaves(g64)}
    degenerate = {p for p, m in scales.items() if m <= 1e-5}
    assert degenerate, 'expected the block-0 skip conv among the leaves'
    _assert_grads_close(tgrads, jgrads, degenerate, scales)


# --------------------------------------------------------------- host data

# the header time scipy's MatFile5Writer writes into every .mat file
# ('Created on: ' + time.asctime()), pinned so the two trees compare whole
# whichever seconds they are written in
MAT_TIME = 'Thu Jan  1 00:00:00 1970'


def test_make_modelnet_tree_writes_the_jax_asym_files(tmp_path, monkeypatch):
    """airplane_asym=True: the same files as the JAX generator, byte for
    byte (the .mat headers' creation time pinned: ``MAT_TIME``)."""
    import time
    monkeypatch.setattr(time, 'asctime', lambda *a: MAT_TIME)
    a, b = str(tmp_path / 't'), str(tmp_path / 'j')
    kw = dict(n_cats=2, n_train=2, n_test=1, n_points=64, seed=4,
              airplane_asym=True)
    tsynth.make_modelnet_tree(a, **kw)
    jsynth.make_modelnet_tree(b, **kw)
    files = sorted(os.path.relpath(os.path.join(d, f), a)
                   for d, _, fs in os.walk(a) for f in fs)
    assert len(files) == 8
    for rel in files:
        assert filecmp.cmp(os.path.join(a, rel), os.path.join(b, rel),
                           shallow=False), rel


@pytest.mark.parametrize('mode', ['train', 'testR'])
def test_alignment_loader_items_equal_jax(tmp_path, mode):
    """Two passes over the items (pc, T, R, R_label, fn) of
    Dataloader_ModelNet40Alignment equal the JAX loader's bit for bit at
    the same seed, and so do the batches of the shuffling DataLoader."""
    root = str(tmp_path / 'mn')
    tsynth.make_modelnet_tree(root, n_cats=2, n_train=3, n_test=3,
                              n_points=1500, seed=6, airplane_asym=True)
    argv = ['experiment', '-d', root, '--run-mode', mode, '-s', '31']
    jo, to = jconfig.parse_args(argv), tconfig.parse_args(argv)
    jl = jmn.Dataloader_ModelNet40Alignment(jo, mode)
    tl = tmn.Dataloader_ModelNet40Alignment(to, mode)
    assert len(jl) == len(tl) == 3
    for i in (0, 2, 1, 0):
        x, y = jl[i], tl[i]
        assert x['fn'] == y['fn'] and y['pc'].shape == (2, 1024, 3)
        for k in ('pc', 'T', 'R', 'R_label'):
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    jb = jmn.DataLoader(jmn.Dataloader_ModelNet40Alignment(jo, mode), 2,
                        shuffle=True, seed=31, process_shard=False)
    tb = tmn.DataLoader(tmn.Dataloader_ModelNet40Alignment(to, mode), 2,
                        shuffle=True, seed=31)
    for _ in range(2):
        for x, y in zip(jb, tb):
            for k in ('pc', 'T', 'R', 'R_label'):
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)


# ------------------------------------------------------------ entry point

def test_run_modelnet_rotation_trains_and_evaluates_on_the_cpu(
        tmp_path, monkeypatch):
    """run_modelnet_rotation train -i 2 on the CPU (with a small reg model
    on 512 points in place of the full-width one, which the card runs:
    chip_smoke.py's [reg-entry]): finite logged Loss, Reg_Loss, Mean_Err and R_Acc, b = 8
    pairs, gradients on every parameter, params.json equal to the JAX
    builder's; then eval through -r: the weights reload, the median angular
    error (b = 4 pairs) is finite and the per-pair errors land in
    data/alignment_errors/ of the working directory."""
    from epn_pointcloud_tpu_torch import models
    monkeypatch.setattr(models, 'build_model_from',
                        lambda opt, seed, outfile_path=None: (
                            treg.build_model(opt, mlps=SMALL_MLPS,
                                             out_mlps=SMALL_OUT, seed=seed,
                                             to_file=outfile_path)))
    root = str(tmp_path / 'mn')
    tsynth.make_modelnet_tree(root, n_cats=1, n_train=8, n_test=4,
                              n_points=600, seed=2, airplane_asym=True,
                              splits=('train', 'testR'))
    monkeypatch.chdir(tmp_path)
    base = ['experiment', '-d', root, '--model-dir', 'runs', '-lf', '1',
            '--input-num', '512', '-b', '4']
    trainer = trun.main(base + ['-i', '2', '--save-freq', '2'],
                        device='cpu')
    trainer.logger.close()
    o = trainer.opt
    assert (o.batch_size, o.train_lr.decay_rate, o.train_lr.decay_step,
            o.model.dropout_rate, o.train_loss.attention_loss_type,
            o.model.model, o.model.flag) == (8, 0.97, 3000, 0.0, 'default',
                                             'reg_so3net', 'rotation')
    stats = trainer.summary.running_stats
    assert trainer.summary.counters['Loss'] == 2
    assert all(np.isfinite(stats[k]) for k in ('Loss', 'Reg_Loss',
                                               'Mean_Err', 'R_Acc'))
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in trainer.model.parameters())
    jreg.build_model(jconfig.parse_args(base), mlps=SMALL_MLPS,
                     out_mlps=SMALL_OUT, to_file=str(tmp_path / 'j.json'))
    with open(os.path.join(trainer.root_dir, 'params.json')) as f:
        assert json.load(f) == json.loads((tmp_path / 'j.json').read_text())
    ckpt = trainer.last_ckpt
    assert os.path.basename(ckpt) == 'playground_net_Iter2.pth'
    assert not os.path.exists('data/alignment_errors')
    other = trun.main(base + ['--run-mode', 'eval', '-r', ckpt], device='cpu')
    other.logger.close()
    assert isinstance(other, TrainerModelNetRotation)
    for (k, a), (_, b) in zip(trainer.model.state_dict().items(),
                              other.model.state_dict().items()):
        assert torch.equal(a, b), k
    errs = np.loadtxt('data/alignment_errors/playgroundIter2_error.txt')
    assert errs.shape == (4,) and np.all(np.isfinite(errs))


def test_rotation_trainer_rejects_other_representations(tmp_path):
    """Only quat and ortho6d regress a rotation (the JAX trainer's
    KeyError), before any setup."""
    with pytest.raises(KeyError, match='representation'):
        trun.main(['experiment', '-d', str(tmp_path), '--model-dir',
                   str(tmp_path / 'runs'), '--representation', 'euler'],
                  device='cpu')
    assert not (tmp_path / 'runs').exists()
