"""The reduced-anchor cls models of the torch port (epn_pointcloud_tpu_torch)
against the JAX package on the CPU: cls_so3net_pn at kanchor 20 and 40 and
the KPConv baseline (``kpconv``: one anchor), whose builders sequence
``inter_block`` layers.

On shared weights (``from_jax_variables``, the ``InterSO3ConvBlock_{j}``
subtree): the eval forward at each anchor count with attention and max
pooling, the kanchor 20 bf16 forward, the attention cross entropy with the
full-group rotation label relabelled into the subset, and the fp32 train
step at kanchor 20 and at one anchor (loss and per-leaf gradients, the
rule of tests/test_torch_port_train.py); then the train and eval entry
at kanchor 20 on the CPU.
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
from epn_pointcloud_tpu.ops import so3conv as jso3

from epn_pointcloud_tpu_torch import compat as tcompat
from epn_pointcloud_tpu_torch import losses as tlosses
from epn_pointcloud_tpu_torch import run_modelnet
from epn_pointcloud_tpu_torch.app.trainer_modelnet import TrainerModelNet
from epn_pointcloud_tpu_torch.app import config as tconfig
from epn_pointcloud_tpu_torch.data import synthetic as tsynth
from epn_pointcloud_tpu_torch.models import cls_so3net_pn as tcls
from epn_pointcloud_tpu_torch.nn import blocks as tblocks
from epn_pointcloud_tpu_torch.ops import so3conv as tso3

MLPS, OUT_MLPS = ((32, 32), (64,)), (64,)
N_POINTS = 64
# (kanchor, kpconv): the model's anchors are 1 with kpconv
MODELS = {'ka20': (20, False), 'ka40': (40, False), 'kpconv': (60, True)}


def _opt(name, flag='attention'):
    opt = jconfig.default_opt()
    opt.model.model, opt.model.flag = 'cls_so3net_pn', flag
    opt.model.kanchor, opt.model.kpconv = MODELS[name]
    opt.model.input_num = N_POINTS
    return opt


def _ball_points(rng, b, n):
    v = rng.randn(b, n, 3)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return (v * rng.rand(b, n, 1) ** (1.0 / 3.0)).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _jax_variables(jmodel, sd):
    """The JAX model's variables holding the port's state_dict ``sd`` (the
    original EPN layout) through epn_pointcloud_tpu.compat; the tree's
    shapes from ``jax.eval_shape`` (no init compiled)."""
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((2, N_POINTS, 3)), train=False))
    zeros = jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, a.dtype),
        {'params': shapes['params'], 'batch_stats': shapes['batch_stats']})
    return jcompat.import_state_dict(zeros, sd)


def _moved_norms(sd, rng):
    """Every BatchNorm off its init (affine and running statistics)."""
    out = {}
    for k, v in sd.items():
        if '.norm.' in k:
            c = v.shape[0]
            move = {'weight': 1.0 + 0.2 * rng.randn(c),
                    'bias': 0.1 * rng.randn(c),
                    'running_mean': 0.1 * rng.randn(c),
                    'running_var': 0.5 + rng.rand(c)}[k.rsplit('.', 1)[1]]
            v = torch.from_numpy(move.astype(np.float32))
        out[k] = v.clone()
    return out


def _pair(name, flag, seed=0):
    """(JAX model, its numpy variables, port eval model) on shared weights:
    the port's seeded init with its BatchNorms moved off their init."""
    opt = _opt(name, flag)
    jmodel = jcls.build_model(opt, mlps=MLPS, out_mlps=OUT_MLPS)
    tmodel = tcls.build_model(opt, mlps=MLPS, out_mlps=OUT_MLPS,
                              seed=seed).eval()
    sd = _moved_norms(tmodel.state_dict(), np.random.RandomState(seed + 12))
    tmodel.load_state_dict(sd)
    return jmodel, _jax_variables(jmodel, sd), tmodel


def _x(b=2, seed=11):
    return _ball_points(np.random.RandomState(seed), b, N_POINTS)


@pytest.mark.parametrize('flag', ['attention', 'max'])
@pytest.mark.parametrize('name', list(MODELS))
def test_forward_matches_jax(name, flag):
    """Logits (and the attention logits) on JAX weights at the cls parity
    tolerance (tests/test_torch_port_model.py)."""
    jmodel, v, tmodel = _pair(name, flag)
    blocks = tmodel.backbone[0].blocks
    assert all(isinstance(b, tblocks.InterSO3ConvBlock) for b in blocks)
    x = _x()
    jl, jf = jax.jit(lambda vv, xx: jmodel.apply(vv, xx, train=False))(
        v, jnp.asarray(x))
    with torch.no_grad():
        tl, tf = tmodel(torch.from_numpy(x))
    na = tmodel.params['na']
    assert na == (1 if name == 'kpconv' else MODELS[name][0])
    assert tl.shape == (2, 40)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-3,
                               atol=2e-3)
    if flag == 'attention':
        assert tf.shape == (2, na)
        np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-3,
                                   atol=2e-3)


def test_kanchor20_bf16_forward_agrees_with_jax():
    """The bf16 eval forward at kanchor 20 against the JAX package's bf16
    forward, the port's existing bf16 bound (tests/test_torch_port_bf16.py:
    per-sample logits cosine >= 0.999), and against the fp32 forwards."""
    jmodel, v, tmodel = _pair('ka20', 'attention', seed=1)
    x = _x(seed=13)
    japply = jax.jit(lambda vv, xx: jmodel.apply(vv, xx, train=False)[0])
    j32 = np.asarray(japply(v, jnp.asarray(x)))
    jso3.set_compute_dtype('bf16')
    try:
        j16 = np.asarray(jax.jit(lambda vv, xx: jmodel.apply(
            vv, xx, train=False)[0])(v, jnp.asarray(x)))
    finally:
        jso3.set_compute_dtype('fp32')
    tso3.set_compute_dtype('bf16')
    try:
        with torch.no_grad():
            t16 = tmodel(torch.from_numpy(x))[0].numpy()
    finally:
        tso3.set_compute_dtype('fp32')
    with torch.no_grad():
        t32 = tmodel(torch.from_numpy(x))[0].numpy()
    for ref in (j16, j32, t32):
        cos = (t16 * ref).sum(-1) / (np.linalg.norm(t16, axis=-1)
                                     * np.linalg.norm(ref, axis=-1))
        assert cos.min() >= 0.999, cos


@pytest.mark.parametrize('a', [1, 20, 40])
def test_attention_loss_relabels_into_the_subset(a):
    """The rotation CE at a < 60 anchors: labels over the full group mapped
    to the nearest subset anchor, loss and accuracies equal to JAX's."""
    rng = np.random.RandomState(a)
    pred = rng.randn(6, 40).astype(np.float32)
    wts = rng.randn(6, a).astype(np.float32)
    label = rng.randint(0, 40, 6)
    rlabel = rng.randint(0, 60, 6)
    jl, jaux = jlosses.attention_cross_entropy(
        jnp.asarray(pred), jnp.asarray(label), jnp.asarray(wts),
        jnp.asarray(rlabel), 'default', 1.0)
    tl, taux = tlosses.attention_cross_entropy(
        torch.from_numpy(pred), torch.from_numpy(label),
        torch.from_numpy(wts), torch.from_numpy(rlabel), 'default', 1.0)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
    for k in ('r_loss', 'racc'):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-6)


def test_inter_block_weights_cross_from_jax():
    """from_jax_variables maps every InterSO3ConvBlock_{j} leaf, and the
    port's state_dict maps back onto the same JAX tree
    (epn_pointcloud_tpu.compat)."""
    _, v, tmodel = _pair('ka40', 'max')
    sd = tcompat.from_jax_variables(v)
    assert set(sd) == set(tmodel.state_dict())
    assert 'backbone.1.blocks.0.conv.basic_conv.W' in sd
    tree = jcompat.import_state_dict(v, tmodel.state_dict())
    flat = dict(jax.tree_util.tree_leaves_with_path(tree))
    for path, leaf in jax.tree_util.tree_leaves_with_path(v):
        np.testing.assert_array_equal(np.asarray(flat[path]), leaf)


# ------------------------------------------------------------ train step

def _leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), np.asarray(v)) for p, v in flat]


def _perturb_norm_biases(sd, seed=5):
    """Norm biases off zero (tests/test_torch_port_train.py): at init the
    BatchNorm over block 0's constant-weight field is rounding noise."""
    rng = np.random.RandomState(seed)
    return {k: (v + torch.from_numpy(0.3 * rng.randn(*v.shape).astype(
        np.float32)) if '.norm.' in k and k.endswith('.bias') else v.clone())
        for k, v in sd.items()}


@pytest.fixture(scope='module', params=['ka20', 'kpconv'])
def train_step_pair(request):
    """One fp32 train step of both packages on shared weights and one
    batch: the attention CE with rotation labels over the full group."""
    name = request.param
    opt = _opt(name)
    jmodel = jcls.build_model(opt, mlps=MLPS, out_mlps=OUT_MLPS)
    tmodel = tcls.build_model(opt, mlps=MLPS, out_mlps=OUT_MLPS)
    sd0 = _perturb_norm_biases(tmodel.state_dict())
    tmodel.load_state_dict(sd0)
    variables = _jax_variables(jmodel, sd0)
    rng = np.random.RandomState(17)
    x = _ball_points(rng, 2, N_POINTS)
    label, rlabel = rng.randint(0, 40, 2), rng.randint(0, 60, 2)

    def loss_fn(params):
        (pred, feat), _ = jmodel.apply(
            {'params': params, 'batch_stats': variables['batch_stats']},
            jnp.asarray(x), train=True, mutable=['batch_stats'])
        return jlosses.attention_cross_entropy(
            pred, jnp.asarray(label), feat, jnp.asarray(rlabel), 'default',
            1.0)[0]
    # jitted: the rounding noise that makes tests/test_torch_port_train.py
    # take the eager step comes from the BatchNorm of a separable block's
    # skip over block 0's constant field, and inter blocks have no skip
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(variables['params'])
    with jax.enable_x64():
        p64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, np.float64)),
            variables['params'])
        g64 = jax.jit(jax.grad(loss_fn))(p64)
        scales = {p: float(np.max(np.abs(g))) for p, g in _leaves(g64)}

    tmodel.train()
    pred, feat = tmodel(torch.from_numpy(x))
    tloss, _ = tlosses.attention_cross_entropy(
        pred, torch.from_numpy(label), feat, torch.from_numpy(rlabel),
        'default', 1.0)
    tloss.backward()
    grads = {n: p.grad.detach().clone() for n, p in tmodel.named_parameters()}
    grads.update({n: b.clone() for n, b in tmodel.named_buffers()})
    tgrads = jcompat.import_state_dict(variables, grads)['params']
    return dict(jloss=float(jloss), jgrads=jgrads, tloss=tloss.item(),
                tgrads=tgrads, scales=scales, feat=feat)


def test_train_step_loss_matches_jax(train_step_pair):
    s = train_step_pair
    assert s['feat'].shape[1] in (1, 20)
    np.testing.assert_allclose(s['tloss'], s['jloss'], rtol=1e-4)


def test_train_step_gradients_match_jax(train_step_pair):
    """Per leaf, the rule of tests/test_reference_train_parity.py:143-209
    (tests/test_torch_port_train.py): relative L2 <= 1e-2 and max error <=
    5e-2 of the leaf's largest; leaves whose float64 gradient is ~0 (<=
    1e-5) or that are below 1e-3 in both packages within 2e-3 and below it
    in float64."""
    s = train_step_pair
    noise = 1e-3
    a, b = _leaves(s['tgrads']), _leaves(s['jgrads'])
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, g), (_, w) in zip(a, b):
        g, w = g.astype(np.float64), w.astype(np.float64)
        both_tiny = max(np.abs(g).max(), np.abs(w).max()) <= noise
        if s['scales'][path] <= 1e-5:
            assert both_tiny, (path, np.abs(g).max(), np.abs(w).max())
            continue
        if both_tiny:
            assert s['scales'][path] <= noise, (path, s['scales'][path])
            assert np.abs(g - w).max() <= 2 * noise, path
            continue
        assert np.abs(g - w).max() <= 5e-2 * np.abs(w).max(), path
        assert _rel(g, w) <= 1e-2, (path, _rel(g, w))


# ------------------------------------------------------------- entry point

def test_kanchor20_train_and_eval_entry(tmp_path):
    """run_modelnet at --kanchor 20 on the CPU: two train steps (b=12
    forced) with the attention loss and its relabelled rotation CE, a
    checkpoint, then --run-mode eval -r on it, the trained logits again;
    and TrainerModelNet with max pooling (the plain cross entropy: no
    rotation terms logged; the entry point forces attention, as JAX's)."""
    import math
    root = str(tmp_path / 'mn')
    tsynth.make_modelnet_tree(root, n_cats=4, n_train=3, n_test=1,
                              n_points=N_POINTS, seed=1,
                              splits=('train', 'testR'))
    base = ['experiment', '-d', root, '--input-num', str(N_POINTS),
            '--kanchor', '20', '--model-dir', str(tmp_path / 'runs')]
    trainer = run_modelnet.main(base + ['--run-mode', 'train', '-i', '2',
                                        '--save-freq', '2'], device='cpu')
    trainer.logger.close()
    assert trainer.model.params['na'] == 20 and trainer.iter_counter == 2
    for k in ('Loss', 'R_Loss', 'Acc', 'R_Acc'):
        assert math.isfinite(trainer.summary.get_item(k)), k
    other = run_modelnet.main(base + ['--run-mode', 'eval', '-b', '12', '-r',
                                      trainer.last_ckpt], device='cpu')
    other.logger.close()
    torch.testing.assert_close(torch.cat(other.eval_logits),
                               torch.cat(trainer.eval_logits), rtol=0, atol=0)

    opt = tconfig.parse_args(base + ['--run-mode', 'eval', '-b', '4', '-u',
                                     'max'])
    opt.model.model = 'cls_so3net_pn'
    maxpool = TrainerModelNet(opt, device='cpu')
    assert not maxpool.attention_model
    assert math.isfinite(maxpool.eval())
    maxpool.logger.close()
