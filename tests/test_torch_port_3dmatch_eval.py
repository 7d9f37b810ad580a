"""The torch port's 3DMatch descriptor evaluation (run_3dmatch --run-mode
eval) against the JAX package on the CPU.

Loaders: ``radius_ball_search`` with its resampling, ``SceneEvalLoader``
(its patches and npz cache), ``SceneTestLoader`` (the cache it precomputes
and its batches from keypoints and from the cache) and
``FragmentTestLoader``, each bit for bit with the JAX package's on its
numpy / scipy path (its compiled host ops are patched off, as in
tests/test_torch_port_inv.py). Recall: ``evaluate_scene`` on the same
feature files (the recall list and recall.txt). End to end:
``Trainer3DMatch.eval`` against the JAX package's on shared weights
(descriptors, recall.csv) and the entry point's eval options.
"""

import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epn_pointcloud_tpu import native as jnative
from epn_pointcloud_tpu.app import config as jconfig
from epn_pointcloud_tpu.data import match_3dmatch as jmatch
from epn_pointcloud_tpu.data import synthetic as jsynth
from epn_pointcloud_tpu.eval import evaluation_3dmatch as jeval
from epn_pointcloud_tpu.models import inv_so3net_pn as jinv

from epn_pointcloud_tpu_torch import compat as tcompat
from epn_pointcloud_tpu_torch import run_3dmatch as trun
from epn_pointcloud_tpu_torch.app import config as tconfig
from epn_pointcloud_tpu_torch.app.trainer_3dmatch import Trainer3DMatch
from epn_pointcloud_tpu_torch.data import match_3dmatch as tmatch
from epn_pointcloud_tpu_torch.data import synthetic as tsynth
from epn_pointcloud_tpu_torch.eval import evaluation_3dmatch as teval

SCENE = 'synth-scene'
N_KPTS = 6


def _dense_tree(make, root):
    """The dense room of tests/test_reference_entrypoint_parity.py:273-275
    (every keypoint's 0.4 ball holds >= 1024 distinct points), with 6
    keypoints a fragment: chunks of 4 leave a short last one."""
    return make(root, scene=SCENE, n_frags=3, n_points=32000, n_kpts=N_KPTS,
                seed=11, extent=(2.0, 2.0, 1.6), kpt_margin=0.45)


@pytest.fixture(scope='module')
def trees(tmp_path_factory):
    """The dense tree written once by each package's generator (the same
    files: tests/test_torch_port_inv.py holds them equal)."""
    base = tmp_path_factory.mktemp('3dm_eval')
    jroot, troot = str(base / 'jax'), str(base / 'torch')
    _dense_tree(jsynth.make_3dmatch_tree, jroot)
    _dense_tree(tsynth.make_3dmatch_tree, troot)
    return jroot, troot


@pytest.fixture
def numpy_path(monkeypatch):
    """The JAX package on its numpy / scipy host path."""
    monkeypatch.setattr(jnative, 'available', lambda: False)


def _eval_opt(module, root, input_num=1024, seed=2913):
    opt = module.parse_args(['experiment', '-d', root, '--run-mode', 'eval',
                             '--input-num', str(input_num), '-s', str(seed)])
    opt.model.search_radius = 0.4
    return opt


def _copy_tree(src, dst):
    import shutil
    shutil.copytree(src, dst)
    return dst


# ----------------------------------------------------------------- loaders

@pytest.mark.parametrize('input_num', [None, 256])
def test_radius_ball_search_matches_jax(trees, numpy_path, input_num):
    """Patches (resampled from the rng when input_num is given) and the
    downsampled cloud equal the JAX package's bit for bit."""
    from epn_pointcloud_tpu_torch.ops.ply import load_ply
    troot = trees[1]
    pts = load_ply(os.path.join(troot, SCENE, 'cloud_bin_0.ply'))
    kpts = np.loadtxt(os.path.join(troot, SCENE, '01_Keypoints',
                                   'cloud_bin_0Keypoints.txt')).astype(int)
    jp, jd = jmatch.radius_ball_search(pts, kpts, 0.4, 0.015, input_num,
                                       np.random.RandomState(4))
    tp, td = tmatch.radius_ball_search(pts, kpts, 0.4, 0.015, input_num,
                                       np.random.RandomState(4))
    np.testing.assert_array_equal(td, jd)
    assert len(tp) == len(jp) == N_KPTS
    for a, b in zip(tp, jp):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_scene_eval_loader_and_cache_match_jax(trees, numpy_path, tmp_path):
    """Each fragment's patches, fragment and id equal the JAX loader's, the
    npz caches each writes are the same bytes, and a second loader reads
    the cache back to the same patches (also at another input_num, which
    resamples them)."""
    jroot = _copy_tree(trees[0], str(tmp_path / 'j'))
    troot = _copy_tree(trees[1], str(tmp_path / 't'))
    jl = jmatch.SceneEvalLoader(_eval_opt(jconfig, jroot), SCENE)
    tl = tmatch.SceneEvalLoader(_eval_opt(tconfig, troot), SCENE)
    assert len(jl) == len(tl) == 3
    for i in range(3):
        x, y = jl[i], tl[i]
        assert x['sid'] == y['sid'] == i
        assert y['clouds'].shape == (N_KPTS, 1024, 3)
        assert y['clouds'].dtype == np.float32
        for k in ('clouds', 'frag'):
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
        assert filecmp.cmp(jl.grouped_path(i), tl.grouped_path(i),
                           shallow=False)
        np.testing.assert_array_equal(
            tmatch.SceneEvalLoader(_eval_opt(tconfig, troot), SCENE)[i][
                'clouds'], y['clouds'])
    for i in (0, 2):
        np.testing.assert_array_equal(
            jmatch.SceneEvalLoader(_eval_opt(jconfig, jroot, 512, 5),
                                   SCENE)[i]['clouds'],
            tmatch.SceneEvalLoader(_eval_opt(tconfig, troot, 512, 5),
                                   SCENE)[i]['clouds'])


@pytest.mark.parametrize('grouped', [False, True])
def test_scene_test_loader_matches_jax(trees, numpy_path, tmp_path, grouped):
    """precompute_patches (serial) writes the same caches as the JAX
    loader's, and next_batch walks the scene in the same batches, from the
    keypoints or (grouped) from the caches."""
    jroot = _copy_tree(trees[0], str(tmp_path / 'j'))
    troot = _copy_tree(trees[1], str(tmp_path / 't'))
    jopt, topt = (_eval_opt(m, r, 512) for m, r in ((jconfig, jroot),
                                                     (tconfig, troot)))
    jopt.batch_size = topt.batch_size = 4
    if grouped:
        for opt, mod in ((jopt, jmatch), (topt, tmatch)):
            pre = mod.SceneTestLoader(opt)
            pre.prepare(SCENE)
            # its resampling draws from the global numpy stream
            np.random.seed(13)
            pre.precompute_patches(input_num=300, num_worker=1)
        for i in range(3):
            name = os.path.join(SCENE, 'grouped_data_r0.40',
                                f'grouped_cloud_bin_{i}.npz')
            assert filecmp.cmp(os.path.join(jroot, name),
                               os.path.join(troot, name), shallow=False)
    jl, tl = jmatch.SceneTestLoader(jopt, grouped), \
        tmatch.SceneTestLoader(topt, grouped)
    jl.prepare(SCENE)
    tl.prepare(SCENE)
    n = 0
    while True:
        more = jl.next_batch()
        assert tl.next_batch() == more
        if not more:
            break
        assert (tl.current_sid, tl.batch_pt, tl.is_new_scene) == \
            (jl.current_sid, jl.batch_pt, jl.is_new_scene)
        assert tl.batch_data.shape[1:] == (512, 3)
        np.testing.assert_array_equal(tl.batch_data, jl.batch_data)
        n += 1
    assert n == 3 * -(-N_KPTS // 4)


def test_fragment_test_loader_matches_jax(trees, numpy_path, tmp_path):
    """On lmvd_test_kpts pair files (one long enough to split, one not),
    the kept splits and their items equal the JAX loader's."""
    troot = _copy_tree(trees[1], str(tmp_path / 't'))
    rng = np.random.RandomState(9)
    kdir = os.path.join(troot, SCENE, 'lmvd_test_kpts')
    os.makedirs(kdir)
    np.save(os.path.join(kdir, 'cloud_bin_0-cloud_bin_1.keypts.npy'),
            rng.randint(0, 32000, (9, 2)))
    np.save(os.path.join(kdir, 'cloud_bin_1-cloud_bin_2.keypts.npy'),
            rng.randint(0, 32000, (5, 2)))
    jl = jmatch.FragmentTestLoader(_eval_opt(jconfig, troot), troot, 0.4,
                                   npt=4)
    tl = tmatch.FragmentTestLoader(_eval_opt(tconfig, troot), troot, 0.4,
                                   npt=4)
    assert len(jl) == len(tl) == 1
    x, y = jl[0], tl[0]
    assert x['id'] == y['id'] == f'{SCENE}AT0_1'
    assert y['src'].shape == (4, 1024, 3)
    for k in ('src', 'tgt', 'frag_src', 'frag_tgt'):
        np.testing.assert_array_equal(x[k], y[k], err_msg=k)


# ------------------------------------------------------------------ recall

@pytest.mark.parametrize('num_thread', [1, 2])
def test_evaluate_scene_matches_jax(trees, tmp_path, num_thread):
    """On the same feature files (each fragment's descriptors: a shared
    code for the keypoint's world point plus noise, and two shuffled
    rows), the recall list and recall.txt equal the JAX package's; the
    port with a pool of two spawned workers or serially."""
    troot = trees[1]
    rng = np.random.RandomState(21)
    code = rng.randn(N_KPTS, 32)
    feat_dir = tmp_path / 'feat'
    feat_dir.mkdir()
    for i in range(3):
        f = code + 0.3 * rng.randn(N_KPTS, 32)
        f[[2 * i, 2 * i + 1]] = f[[2 * i + 1, 2 * i]]
        np.save(str(feat_dir / f'feature{i}.npy'), f.astype(np.float32))
    want = jeval.evaluate_scene(troot, str(feat_dir), SCENE, num_thread=1)
    jtxt = (feat_dir / 'recall.txt').read_text()
    (feat_dir / 'recall.txt').unlink()
    got = teval.evaluate_scene(troot, str(feat_dir), SCENE,
                               num_thread=num_thread)
    assert got == want and len(got) == 3
    assert (feat_dir / 'recall.txt').read_text() == jtxt


# ------------------------------------------------------------- end to end

def test_trainer_3dmatch_eval_matches_jax(trees, numpy_path, tmp_path,
                                          monkeypatch):
    """Trainer3DMatch.eval of both packages on the JAX package's seeded
    full-width inv weights, batch_size 4 and npt 1 (chunks of 4 patches;
    the JAX package pads the last chunk of each fragment, the port runs it
    at its size), serial matching: every fragment's descriptors within
    rtol 1e-3, atol 2e-3, recall.txt and recall.csv equal, the files where
    the JAX package writes them under the working directory."""
    from flax import serialization
    from epn_pointcloud_tpu.app.trainer_3dmatch import \
        Trainer3DMatch as JTrainer
    monkeypatch.setattr(os, 'cpu_count', lambda: 1)
    jroot = _copy_tree(trees[0], str(tmp_path / 'jdata'))
    troot = _copy_tree(trees[1], str(tmp_path / 'tdata'))
    jopt = _eval_opt(jconfig, jroot)
    jopt.model.flag = 'attention'
    jmodel = jinv.build_model(jopt)
    init = jax.jit(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 1024, 3), jnp.float32),
        train=False))()
    init = jax.tree_util.tree_map(np.asarray, dict(init))
    jckpt, tckpt = str(tmp_path / 'j_net_0.ckpt'), str(tmp_path / 't.pth')
    with open(jckpt, 'wb') as f:
        f.write(serialization.to_bytes({'params': init['params'],
                                        'batch_stats': {}}))
    torch.save(tcompat.from_jax_variables(init), tckpt)

    import run_3dmatch as jrun

    def run(mod, cfg, trainer_cls, root, ckpt, cwd, **kw):
        opt = cfg(mod.parse_args(['experiment', '-d', root, '--run-mode',
                                  'eval', '-r', ckpt, '--model-dir',
                                  str(cwd / 'runs')]))
        opt.batch_size, opt.npt, opt.experiment_id = 4, 1, 'e2e'
        cwd.mkdir()
        monkeypatch.chdir(cwd)
        trainer = trainer_cls(opt, **kw)
        results = trainer.eval([SCENE])
        getattr(trainer.logger, 'close', lambda: None)()
        feat = cwd / 'data/evaluate/3DMatch/e2e' / SCENE / '32_dim'
        return (results, [np.load(str(feat / f'feature{i}.npy'))
                          for i in range(3)],
                (feat / 'recall.txt').read_text(),
                (cwd / 'trained_models/evaluate/3DMatch/e2e/recall.csv')
                .read_text(), trainer)
    jres, jfeat, jtxt, jcsv, _ = run(jconfig, jrun.config_opt_3dmatch,
                                     JTrainer, jroot, jckpt,
                                     tmp_path / 'jcwd')
    tres, tfeat, ttxt, tcsv, tt = run(tconfig, trun.config_opt_3dmatch,
                                      Trainer3DMatch, troot, tckpt,
                                      tmp_path / 'tcwd', device='cpu')
    for i, (a, b) in enumerate(zip(tfeat, jfeat)):
        assert a.shape == b.shape == (N_KPTS, 64), i
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=2e-3,
                                   err_msg=f'fragment {i}')
    assert ttxt == jtxt and tcsv == jcsv
    assert tres == jres and list(tres) == [SCENE]
    assert tt.dataset is None
    s = tt.eval_seconds
    assert s['patches'] == 3 * N_KPTS and s['forward_s'] > 0


def test_eval_options_match_jax():
    """The eval branch of config_opt_3dmatch (npt 24, batch_size 8: 192
    patches a forward) and the scene list equal the JAX entry point's."""
    import run_3dmatch as jrun
    argv = ['experiment', '-d', '/nonexistent', '--run-mode', 'eval']
    j = jconfig.dump_args(jrun.config_opt_3dmatch(jconfig.parse_args(argv)))
    t = tconfig.dump_args(trun.config_opt_3dmatch(tconfig.parse_args(argv)))
    for kk in ('no_augmentation', 'npt', 'batch_size'):
        assert j[kk] == t[kk], kk
    for kk, v in t['model'].items():
        assert j['model'][kk] == v, kk
    assert (t['npt'], t['batch_size']) == (24, 8)
    assert trun.SCENE_TO_TEST == jrun.SCENE_TO_TEST


def test_eval_entry_takes_the_experiment_from_the_checkpoint(tmp_path,
                                                             monkeypatch):
    """run_3dmatch --run-mode eval -r a/b/<exp>/...: the trainer gets the
    experiment id <exp> (the third part of the path, as the JAX entry
    point takes it) and eval(scenes) the scenes given."""
    seen = []

    class Recorder:
        def __init__(self, opt, device):
            seen.append(opt)

        def eval(self, scenes):
            seen.append(scenes)
    monkeypatch.setattr(trun, 'Trainer3DMatch', Recorder)
    trun.main(['experiment', '-d', str(tmp_path), '--run-mode', 'eval', '-r',
               'trained_models/models/exp7/model_x/ckpt/n.pth'],
              scenes=['s1'])
    assert seen[0].experiment_id == 'exp7' and seen[1] == ['s1']
    assert (seen[0].npt, seen[0].batch_size) == (24, 8)
