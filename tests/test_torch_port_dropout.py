"""The entry points' last options in the torch port against the JAX package on
the CPU: ``--dropout-rate`` (the keep rate and scale, the eval forward,
the train forward with the masks of both packages drawn from one numpy
stream in call order, the order of the dropout sites, the kernel-path
gates it turns off, the trainer's generator), ``--debug-mode knownatt``
(the loss, the Summary's keys, the rotation label handed to the model) and
``--normals`` (the 6-channel occupancy features, the 3DMatch loaders'
flag, and the refusal of 4-channel block-0 features, whose JAX result is a
broadcast of one weight over the channel sum).
"""

import math

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epn_pointcloud_tpu import compat as jcompat
from epn_pointcloud_tpu import losses as jlosses
from epn_pointcloud_tpu.app import config as jconfig
from epn_pointcloud_tpu.models import cls_so3net_pn as jcls
from epn_pointcloud_tpu.ops import icosahedron as jico
from epn_pointcloud_tpu.ops import kernel_points as jkp
from epn_pointcloud_tpu.ops import so3conv as jso3

from epn_pointcloud_tpu_torch import compat as tcompat
from epn_pointcloud_tpu_torch import losses as tlosses
from epn_pointcloud_tpu_torch import models as tmodels
from epn_pointcloud_tpu_torch import run_modelnet
from epn_pointcloud_tpu_torch.app import config as tconfig
from epn_pointcloud_tpu_torch.data import match_3dmatch as tmatch
from epn_pointcloud_tpu_torch.data import synthetic as tsynth
from epn_pointcloud_tpu_torch.models import cls_so3net_pn as tcls
from epn_pointcloud_tpu_torch.nn import layers as tlayers
from epn_pointcloud_tpu_torch.ops import so3conv as tso3

N_POINTS = 64
SMALL = dict(mlps=((16, 16), (32,)), out_mlps=(32,))
RATE = 0.5


def _opt(rate=RATE, kanchor=60):
    opt = jconfig.default_opt(**{'model.model': 'cls_so3net_pn',
                                 'model.flag': 'attention',
                                 'model.input_num': N_POINTS,
                                 'model.kanchor': kanchor,
                                 'model.dropout_rate': rate})
    return opt


def _ball(rng, b, n):
    v = rng.randn(b, n, 3)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return (v * rng.rand(b, n, 1) ** (1.0 / 3.0)).astype(np.float32)


def _cos_rows(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


def _pair(rate=RATE, seed=0):
    """(JAX model, its numpy variables, port model) on the port's seeded
    weights, its BatchNorms off their init."""
    opt = _opt(rate)
    jmodel = jcls.build_model(opt, **SMALL)
    tmodel = tcls.build_model(opt, seed=seed, **SMALL)
    rng = np.random.RandomState(seed + 3)
    sd = {}
    for k, v in tmodel.state_dict().items():
        if '.norm.' in k:
            c = v.shape[0]
            v = torch.from_numpy({
                'weight': 1.0 + 0.2 * rng.randn(c),
                'bias': 0.3 * rng.randn(c),
                'running_mean': 0.1 * rng.randn(c),
                'running_var': 0.5 + rng.rand(c)}[k.rsplit('.', 1)[1]]
                .astype(np.float32))
        sd[k] = v
    tmodel.load_state_dict(sd)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((2, N_POINTS, 3)), train=False))
    v = jcompat.import_state_dict(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, a.dtype), dict(shapes)), sd)
    tmodel.load_state_dict(tcompat.from_jax_variables(v))
    return jmodel, v, tmodel


# --------------------------------------------------------------- the module

def test_dropout_keeps_at_its_rate_and_scales():
    """Train mode: about 1 - rate of the elements kept, each as x / (1 -
    rate) in x's type, the rest 0; a generator seeded alike gives the same
    mask; eval mode and rate 0 are the identity."""
    x = torch.randn(200_000)
    drop = tlayers.Dropout(0.3)
    drop.generator = torch.Generator().manual_seed(4)
    y = drop(x)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.005
    torch.testing.assert_close(y[kept], x[kept] / 0.7, rtol=0, atol=0)
    drop.generator = torch.Generator().manual_seed(4)
    assert torch.equal(drop(x), y)
    xb = x.to(torch.bfloat16)
    yb = drop(xb)
    assert yb.dtype == torch.bfloat16
    keep = yb != 0
    assert torch.equal(yb[keep], xb[keep] / 0.7)
    drop.eval()
    assert drop(x) is x
    assert tlayers.Dropout(0.0).train()(x) is x


# ------------------------------------------------- shared masks, call order

class _Stream:
    """One numpy stream of keep masks, drawn in call order by whichever
    package asks; each draw's size is recorded."""

    def __init__(self, seed):
        self.rng = np.random.RandomState(seed)
        self.sizes = []

    def keep(self, shape, rate):
        n = int(np.prod(shape))
        self.sizes.append(n)
        return (self.rng.random_sample(n) < 1.0 - rate).reshape(shape)


def _patch_masks(monkeypatch, stream):
    """flax.linen.Dropout (as the JAX blocks call it) and the port's
    Dropout.keep_mask both draw from ``stream``."""
    class StreamDropout(fnn.Module):
        rate: float
        deterministic: bool = False

        @fnn.compact
        def __call__(self, x):
            if self.deterministic or self.rate == 0:
                return x
            keep = jnp.asarray(stream['jax'].keep(x.shape, self.rate))
            return jnp.where(keep, x / (1.0 - self.rate), jnp.zeros_like(x))
    monkeypatch.setattr(fnn, 'Dropout', StreamDropout)
    monkeypatch.setattr(tlayers.Dropout, 'keep_mask', lambda self, x: (
        torch.from_numpy(stream['port'].keep(tuple(x.shape), self.rate))))


@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
def test_train_forward_with_shared_masks_matches_jax(monkeypatch, dtype):
    """The train-mode forward at 60 anchors with dropout 0.5 (after the
    inter and the intra block of every separable layer), the masks of both
    packages from one numpy stream: the sites are called in the same order
    with the same sizes, and the logits agree (fp32 rtol 1e-3, atol 2e-3;
    bf16 per-sample cosine >= 0.999)."""
    stream = {}
    _patch_masks(monkeypatch, stream)
    jmodel, v, tmodel = _pair()
    x = _ball(np.random.RandomState(9), 2, N_POINTS)
    stream['jax'] = _Stream(17)
    jso3.set_compute_dtype(dtype)
    try:
        (jl, _), _ = jax.jit(lambda vv, xx: jmodel.apply(
            vv, xx, train=True, mutable=['batch_stats']))(v, jnp.asarray(x))
    finally:
        jso3.set_compute_dtype('fp32')
    stream['port'] = _Stream(17)
    tso3.set_compute_dtype(dtype)
    try:
        with torch.no_grad():
            tl = tmodel.train()(torch.from_numpy(x))[0]
    finally:
        tso3.set_compute_dtype('fp32')
    sizes = stream['port'].sizes
    # 3 separable layers, an inter and an intra site each
    assert len(sizes) == 6 and sizes == stream['jax'].sizes
    jl, tl = np.asarray(jl, np.float32), tl.float().numpy()
    if dtype == 'fp32':
        np.testing.assert_allclose(tl, jl, rtol=1e-3, atol=2e-3)
    else:
        assert _cos_rows(tl, jl).min() >= 0.999


@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
def test_eval_forward_matches_jax(dtype):
    """The eval forward of a model built with dropout 0.5 (no masks; in bf16
    the unfused tail, as the JAX gates have it) equals the JAX package's:
    fp32 rtol 1e-3, atol 2e-3; bf16 per-sample cosine >= 0.999; and equals
    the port's model built without dropout on the same weights (fp32
    exactly; in bf16, where that model runs the fused tail, to cosine
    0.999)."""
    jmodel, v, tmodel = _pair()
    x = _ball(np.random.RandomState(10), 2, N_POINTS)
    jso3.set_compute_dtype(dtype)
    try:
        jl = np.asarray(jax.jit(lambda vv, xx: jmodel.apply(
            vv, xx, train=False)[0])(v, jnp.asarray(x)), np.float32)
    finally:
        jso3.set_compute_dtype('fp32')
    plain = tcls.build_model(_opt(0.0), seed=None, **SMALL)
    plain.load_state_dict(tmodel.state_dict())
    tso3.set_compute_dtype(dtype)
    try:
        with torch.no_grad():
            tl = tmodel.eval()(torch.from_numpy(x))[0].float().numpy()
            t0 = plain.eval()(torch.from_numpy(x))[0].float().numpy()
    finally:
        tso3.set_compute_dtype('fp32')
    if dtype == 'fp32':
        np.testing.assert_allclose(tl, jl, rtol=1e-3, atol=2e-3)
        np.testing.assert_array_equal(tl, t0)
    else:
        assert _cos_rows(tl, jl).min() >= 0.999
        assert _cos_rows(tl, t0).min() >= 0.999


@pytest.mark.parametrize('train', [True, False])
def test_dropout_turns_the_deferrals_off(monkeypatch, train):
    """In the bf16 production mode a separable block with dropout defers
    nothing (the JAX ``fuse`` gate): the intra conv gets no prenorm fold
    (the plain intra conv, not the PRENORM kernel) and eval runs no fused
    tail; without dropout the same model defers the inter norm and, in
    eval, fuses the tail."""
    seen = {'prenorm': 0, 'plain': 0, 'tail': 0}
    intra, tail = tso3.intra_so3conv, tso3.separable_tail

    def spy_intra(*a, prenorm=None, **k):
        seen['prenorm' if prenorm is not None else 'plain'] += 1
        return intra(*a, prenorm=prenorm, **k)

    def spy_tail(*a, **k):
        seen['tail'] += 1
        return tail(*a, **k)
    monkeypatch.setattr(tso3, 'intra_so3conv', spy_intra)
    monkeypatch.setattr(tso3, 'separable_tail', spy_tail)
    x = torch.from_numpy(_ball(np.random.RandomState(2), 2, N_POINTS))
    tso3.set_compute_dtype('bf16')
    try:
        for rate in (RATE, 0.0):
            model = tcls.build_model(_opt(rate), seed=1, **SMALL)
            model.train(train)
            assert [b.defer for blk in model.backbone for b in blk.blocks] \
                == [rate == 0] * 3
            seen.update(prenorm=0, plain=0, tail=0)
            with torch.no_grad():
                model(x)
            if rate:
                assert seen == {'prenorm': 0, 'plain': 3, 'tail': 0}
            else:
                # block 0 layer 0 (the ones input) keeps the unfused tail
                assert seen == {'prenorm': 3, 'plain': 0,
                                'tail': 0 if train else 2}
    finally:
        tso3.set_compute_dtype('fp32')


# ---------------------------------------------------- trainer, knownatt

@pytest.fixture()
def small_builder(monkeypatch):
    """The trainers build the SMALL cls model (models.build_model_from)."""
    build = tmodels.build_model_from

    def small(opt, seed=0, outfile_path=None):
        assert opt.model.model == 'cls_so3net_pn'
        return tcls.build_model(opt, seed=seed, to_file=outfile_path,
                                **SMALL)
    monkeypatch.setattr(tmodels, 'build_model_from', small)
    yield build


def test_knownatt_dropout_entry_trains_as_a_classifier(tmp_path,
                                                       small_builder,
                                                       monkeypatch):
    """run_modelnet --dropout-rate 0.5 --debug-mode knownatt -u attention on
    the CPU (as JAX ``TrainerModelNet``): the attention model trains as a
    plain classifier (the cross entropy alone, equal to the JAX package's
    on the same logits; Summary 'Loss' and 'Acc' only), the rotation label
    goes to the model, which ignores it; the masks come from the trainer's
    generator, seeded from --seed, and save_full_state keeps no rng, as the
    JAX trainer's keeps none."""
    root = str(tmp_path / 'mn')
    tsynth.make_modelnet_tree(root, n_cats=4, n_train=3, n_test=1,
                              n_points=N_POINTS, seed=1,
                              splits=('train', 'testR'))
    given, losses_seen = [], []
    forward = tcls.ClsSO3ConvModel.forward

    def spy(self, x, rlabel=None):
        given.append(rlabel)
        return forward(self, x, rlabel)
    monkeypatch.setattr(tcls.ClsSO3ConvModel, 'forward', spy)
    ce = tlosses.cross_entropy

    def spy_ce(pred, label):
        losses_seen.append((pred.detach().numpy().copy(), label.numpy()))
        return ce(pred, label)
    monkeypatch.setattr(tlosses, 'cross_entropy', spy_ce)
    trainer = run_modelnet.main(
        ['experiment', '-d', root, '--input-num', str(N_POINTS),
         '--model-dir', str(tmp_path / 'runs'), '--run-mode', 'train', '-i',
         '1', '--save-freq', '1', '--dropout-rate', '0.5', '--debug-mode',
         'knownatt', '-u', 'attention'], device='cpu')
    trainer.logger.close()
    assert trainer.knownatt and not trainer.attention_model
    assert set(trainer.summary.items) == {'Time', 'Loss', 'Acc'}
    for k in ('Loss', 'Acc'):
        assert math.isfinite(trainer.summary.get_item(k)), k
    # the train batches of 12 and the eval's
    assert given and all(r is not None and r.dim() == 1 for r in given)
    drops = [m for m in trainer.model.modules()
             if isinstance(m, tlayers.Dropout)]
    # an inter and an intra block in each of the 3 separable layers
    assert len(drops) == 6 and all(m.rate == 0.5 for m in drops)
    assert all(m.generator is trainer.dropout_generator for m in drops)
    first = torch.Generator().manual_seed(trainer.opt.seed)
    assert not torch.equal(trainer.dropout_generator.get_state(),
                           first.get_state())
    trainer.save_full_state(str(tmp_path / 'full.pth'))
    assert set(torch.load(str(tmp_path / 'full.pth'), weights_only=True)) \
        == {'model', 'optimizer', 'iter'}
    pred, label = losses_seen[0]
    want = jlosses.cross_entropy(jnp.asarray(pred), jnp.asarray(label))
    got = ce(torch.from_numpy(pred), torch.from_numpy(label))
    np.testing.assert_allclose(got[0].item(), float(want[0]), rtol=1e-6)
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-6)


# ------------------------------------------------------------------ normals

@pytest.mark.parametrize('na', [1, 20, 60])
def test_occupancy_features_of_a_six_channel_cloud_match_jax(na):
    """get_occupancy_features / preprocess_input on [b, p, 6]: the ones and
    the normals rotated by each anchor (one anchor: as they are) equal the
    JAX package's (use_center False, as the models call it), xyz the first
    three channels; a 3-channel cloud keeps the ones alone."""
    rng = np.random.RandomState(na)
    pc = rng.randn(2, 16, 6).astype(np.float32)
    want = np.asarray(jso3.get_occupancy_features(jnp.asarray(pc), na))
    got = tso3.get_occupancy_features(torch.from_numpy(pc), na)
    assert got.shape == (2, 16, na, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    sp = tso3.preprocess_input(torch.from_numpy(pc), na)
    assert torch.equal(sp.xyz, torch.from_numpy(pc[..., :3]))
    three = tso3.preprocess_input(torch.from_numpy(pc[..., :3].copy()), na)
    assert torch.equal(three.feats, torch.ones(2, 16, na, 1))


def test_four_channel_block0_features_are_the_jax_packages_broadcast():
    """What the JAX model computes from a 6-channel cloud: its block-0 inter
    conv on the 4 occupancy channels against the builder's [24, 1, d] W
    equals the same conv on their sum (a broadcast of one weight over the
    channels), not a function the original EPN defines, so the port's
    model refuses such features."""
    rng = np.random.RandomState(6)
    pc = _ball(rng, 2, N_POINTS)
    normals = rng.randn(2, N_POINTS, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    x6 = np.concatenate([pc, normals], -1)
    feats = jso3.get_occupancy_features(jnp.asarray(x6), 20)
    anchors = jnp.asarray(jico.get_anchors(20))
    kernels = jnp.asarray(jkp.get_spherical_kernel_points(0.14, 1))
    W = jnp.asarray(rng.randn(24, 1, 8).astype(np.float32))
    args = (jnp.asarray(pc), 1, 16, anchors, kernels, 0.2, 0.02)
    out4 = jso3.inter_so3conv_fused(args[0], feats, *args[1:], W)[2]
    out1 = jso3.inter_so3conv_fused(args[0], feats.sum(-1, keepdims=True),
                                    *args[1:], W)[2]
    np.testing.assert_allclose(np.asarray(out4), np.asarray(out1),
                               rtol=1e-5, atol=1e-5)
    opt = _opt(0.0, kanchor=20)
    model = tcls.build_model(opt, seed=0, **SMALL).eval()
    with pytest.raises(NotImplementedError, match='normals'):
        with torch.no_grad():
            model(torch.from_numpy(x6))


def test_3dmatch_loaders_store_use_normals(tmp_path):
    """FragmentLoader, FragmentTestLoader and SceneEvalLoader take the flag
    and store it, as the JAX loaders do; the training patches stay
    3-channel and equal those drawn without it."""
    root = str(tmp_path / '3dm')
    tsynth.make_3dmatch_tree(root, n_frags=2, n_points=3000, n_kpts=8,
                             seed=2)
    opt = tconfig.parse_args(['experiment', '-d', root, '--input-num', '64',
                              '--normals'])
    opt.no_augmentation = True
    with_n = tmatch.FragmentLoader(opt, 0.4, npt=2, use_normals=True)
    without = tmatch.FragmentLoader(opt, 0.4, npt=2)
    assert with_n.use_normals and not without.use_normals
    a, b = with_n[0], without[0]
    assert a['src'].shape == (2, 64, 3)
    for k in ('src', 'tgt'):
        np.testing.assert_array_equal(a[k], b[k])
    assert tmatch.FragmentTestLoader(opt, root, 0.4,
                                     use_normals=True).use_normals
    assert tmatch.SceneEvalLoader(opt, 'synth-scene').use_normals
