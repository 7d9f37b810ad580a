"""Data parallelism of the torch port (epn_pointcloud_tpu_torch.parallel) on
the CPU under gloo: two ranks, each a ``sys.executable`` subprocess with the
rendezvous environment set (``parallel.dryrun.launch``), hold one train
step of each trainer on its half of a seeded global batch to the port's
single-process step on the whole batch, and the cls step to the JAX
package's step on the same batch.

The steps (``parallel.dryrun``, size 'small': 128 points, 20 anchors,
narrow widths, global batches of 4): cls in fp32, float64 (the fp32 mode's
plain path on a float64 model and batch), bf16 and with dropout 0.5
(float64); inv (the triplet loss: negatives mined over the global batch)
and reg in fp32 and float64. Float64 holds the distributed semantics to
rtol 1e-5 / atol 1e-6 element by element (a gradient W times or 1/W of
the single-process one, statistics or negatives taken over the local batch
alone, or a dropout mask drawn a rank, miss it by far); fp32 differs from
one process in its reduction orders, and a leaky ReLU input that close to
zero then flips: at this batch one flip moves block 0's gradients by a
relative L2 of 1e-4, as a 1e-7 scaling of the clouds does to the one
process, so fp32 is held per leaf to a relative L2 of 1e-3 (float64
gradient not ~0). Then the entry point under torchrun, the loaders'
sharding and the refusals.
"""

import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epn_pointcloud_tpu import compat as jcompat
from epn_pointcloud_tpu import losses as jlosses
from epn_pointcloud_tpu.models import cls_so3net_pn as jcls

from epn_pointcloud_tpu_torch import compat as tcompat
from epn_pointcloud_tpu_torch import run_3dmatch, run_modelnet
from epn_pointcloud_tpu_torch.data import modelnet40 as tdata
from epn_pointcloud_tpu_torch.data import synthetic as tsynth
from epn_pointcloud_tpu_torch.parallel import distributed, dryrun, mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 'small'
TAGS = ('cls_fp32', 'cls_fp64', 'cls_bf16', 'cls_dropout', 'inv_fp32',
        'inv_fp64', 'reg_fp32', 'reg_fp64')
# a leaf whose float64 gradient is at most this is mathematically ~0
DEGENERATE = 1e-5


def _env(threads=2):
    """The ranks' environment: few threads each (the suite runs workers in
    parallel)."""
    return dict(os.environ, OMP_NUM_THREADS=str(threads))


# ------------------------------------------------------------- (a) loaders

class _Toy:
    def __len__(self):
        return 20

    def __getitem__(self, i):
        return {'x': np.full((2,), float(i), np.float32),
                'label': np.int64(i)}


def test_process_slice(monkeypatch):
    monkeypatch.setattr(distributed, 'process_env', lambda: (2, 1))
    assert distributed.process_slice(8) == slice(4, 8)
    with pytest.raises(AssertionError):
        distributed.process_slice(5)
    monkeypatch.setattr(distributed, 'process_env', lambda: (1, 0))
    assert distributed.process_slice(5) == slice(0, 5)


def test_loader_process_sharding_unit(monkeypatch):
    """Each process draws the same global order and loads only its slice
    (tests/test_multihost.py:37-53)."""
    streams = {}
    for pid in (0, 1):
        monkeypatch.setattr(distributed, 'process_env', lambda p=pid: (2, p))
        dl = tdata.DataLoader(_Toy(), batch_size=4, shuffle=True, seed=3)
        assert len(dl) == 5
        streams[pid] = list(iter(dl))
    monkeypatch.setattr(distributed, 'process_env', lambda: (1, 0))
    full = list(iter(tdata.DataLoader(_Toy(), batch_size=4, shuffle=True,
                                      seed=3)))
    assert len(streams[0]) == len(full)
    for b0, b1, fb in zip(streams[0], streams[1], full):
        assert b0['x'].shape[0] == 2 and b1['x'].shape[0] == 2
        np.testing.assert_array_equal(
            np.concatenate([b0['label'], b1['label']]), fb['label'])


def test_loader_short_batches_dropped_multihost(monkeypatch):
    """Short final batches are dropped under two processes whatever
    drop_last says; one process keeps the tail; ``process_shard=False``
    (the 3DMatch trainer's fragment pairs) hands every process the whole
    batch (tests/test_multihost.py:56-66)."""
    monkeypatch.setattr(distributed, 'process_env', lambda: (2, 0))
    dl = tdata.DataLoader(_Toy(), batch_size=8, shuffle=False,
                          drop_last=False)
    assert len(dl) == 2 and len(list(iter(dl))) == 2
    whole = tdata.DataLoader(_Toy(), batch_size=8, shuffle=False,
                             drop_last=False, process_shard=False)
    assert [len(b['label']) for b in whole] == [8, 8, 4]
    monkeypatch.setattr(distributed, 'process_env', lambda: (1, 0))
    dl1 = tdata.DataLoader(_Toy(), batch_size=8, shuffle=False,
                           drop_last=False)
    assert len(list(iter(dl1))) == 3


# ------------------------------------------------------- the world-2 steps

def _perturbed(sd, seed=5):
    rng = np.random.RandomState(seed)
    return {k: (v + torch.from_numpy(0.3 * rng.randn(*v.shape).astype(
        np.float32)) if '.norm.' in k and k.endswith('.bias') else v.clone())
        for k, v in sd.items()}


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """Every step of TAGS at world 2 (one launch, two gloo ranks) and in
    this process alone; the cls fp32 step's weights from the JAX model's
    init (``compat.from_jax_variables``, norm biases off zero)."""
    out = str(tmp_path_factory.mktemp('dp'))
    opt = dryrun.make_opt('cls', SIZE, 'fp32', 0.0, out)
    jmodel = jcls.build_model(opt, **dryrun.SIZES[SIZE]['widths']['cls'])
    init = jax.jit(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 128, 3)), train=False))()
    init = jax.tree_util.tree_map(np.asarray, {
        'params': init['params'], 'batch_stats': init['batch_stats']})
    sd0 = _perturbed(tcompat.from_jax_variables(init))
    weights = os.path.join(out, 'cls_fp32.pth')
    torch.save(sd0, weights)
    dryrun.launch(2, ['--out', out, '--device', 'cpu', '--steps',
                      ','.join(TAGS), '--weights', f'cls_fp32={weights}'],
                  timeout=300, log_dir=os.path.join(out, 'logs'), env=_env())
    local = {t: dryrun.run_step(t, SIZE, 'cpu', os.path.join(out, 'local'),
                                weights if t == 'cls_fp32' else None)
             for t in TAGS}
    ranks = {t: [dict(np.load(os.path.join(out, f'{t}_rank{r}.npz')))
                 for r in (0, 1)] for t in TAGS}
    return dict(out=out, local=local, ranks=ranks, init=init, sd0=sd0,
                jmodel=jmodel)


def _check_ranks_agree(runs, tag):
    """Both ranks hold the same all-reduced gradients, parameters after
    Adam and running statistics."""
    r0, r1 = runs['ranks'][tag]
    for k in dryrun.leaves(r0, ('grad/', 'param/', 'buffer/')):
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    assert float(r0['loss']) == float(r1['loss'])


def _check_exact(runs, tag):
    """World 2 against one process in float64: loss, every gradient and
    running statistic to rtol 1e-5 / atol 1e-6 element by element."""
    _check_ranks_agree(runs, tag)
    got, want = runs['ranks'][tag][0], runs['local'][tag]
    np.testing.assert_allclose(float(got['loss']), float(want['loss']),
                               rtol=1e-6)
    for k, v in dryrun.leaves(want, ('grad/', 'buffer/')).items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def _check_fp32(runs, tag, f64_tag):
    """World 2 against one process in fp32: loss to rtol 1e-5; per leaf
    with a real (float64) gradient a relative L2 <= 1e-3; the ~0 leaves
    within 1e-6; running statistics to rtol 1e-4 of the leaf's
    magnitude."""
    _check_ranks_agree(runs, tag)
    got, want = runs['ranks'][tag][0], runs['local'][tag]
    f64 = runs['local'][f64_tag]
    np.testing.assert_allclose(float(got['loss']), float(want['loss']),
                               rtol=1e-5)
    for k, v in dryrun.leaves(want, ('grad/', 'buffer/')).items():
        g, v = got[k].astype(np.float64), v.astype(np.float64)
        if k.startswith('buffer/'):
            assert np.abs(g - v).max() <= 1e-4 * max(np.abs(v).max(),
                                                     1e-6), k
        elif np.abs(f64[k]).max() <= DEGENERATE:
            assert np.abs(g - v).max() <= 1e-6, k
        else:
            assert np.linalg.norm(g - v) <= 1e-3 * np.linalg.norm(v), k


def test_cls_step_world2_matches_one_process(runs):
    """(b) the cls step: float64 exact, fp32 by the per-leaf rule; the
    BatchNorm statistics global (in fp32 one all-gather of each rank's
    moments a norm, its backward one all-reduce)."""
    _check_exact(runs, 'cls_fp64')
    _check_fp32(runs, 'cls_fp32', 'cls_fp64')
    coll = json.loads(str(runs['ranks']['cls_fp32'][0]['launches']))[
        'collectives']
    assert coll['grads'] == 1 and coll['log'] == 1
    assert coll['all_gather'] == coll['all_gather_backward'] > 0


def _leaf_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), np.asarray(v)) for p, v in flat]


def test_cls_step_world2_matches_jax(runs):
    """(b) the world-2 fp32 cls step against the JAX package's step on the
    same global batch and weights (jitted, as tests/test_torch_port_kanchor
    takes the kanchor-20 step): loss to rtol 1e-4, per-leaf gradients by
    the rule of tests/test_torch_port_train.py (relative L2 <= 1e-2, max
    error <= 5e-2 of the leaf's; leaves ~0 in float64 or below 1e-3 in
    both within 2e-3), the running statistics to rtol 1e-4 of each leaf's
    magnitude."""
    jmodel, init = runs['jmodel'], runs['init']
    variables = jcompat.import_state_dict(init, runs['sd0'])
    data = dryrun.global_batch('cls', SIZE)
    x, label, rlabel = (jnp.asarray(data[k]) for k in ('pc', 'label',
                                                        'R_label'))

    def loss_fn(params):
        (pred, feat), mut = jmodel.apply(
            {'params': params, 'batch_stats': variables['batch_stats']},
            x, train=True, mutable=['batch_stats'])
        return jlosses.attention_cross_entropy(
            pred, label, feat, rlabel, 'default', 1.0)[0], mut
    (jloss, jmut), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables['params'])
    with jax.enable_x64():
        p64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, np.float64)),
            variables['params'])
        g64 = jax.jit(jax.grad(lambda p: loss_fn(p)[0]))(p64)
        scales = {p: float(np.max(np.abs(g))) for p, g in _leaf_paths(g64)}

    got = runs['ranks']['cls_fp32'][0]
    np.testing.assert_allclose(float(got['loss']), float(jloss), rtol=1e-4)
    sd = {k[len('grad/'):]: torch.from_numpy(v) for k, v in got.items()
          if k.startswith('grad/')}
    sd.update({k[len('buffer/'):]: torch.from_numpy(v)
               for k, v in got.items() if k.startswith('buffer/')})
    tree = jcompat.import_state_dict(variables, sd)
    a, b = _leaf_paths(tree['params']), _leaf_paths(jgrads)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, g), (_, w) in zip(a, b):
        g, w = g.astype(np.float64), w.astype(np.float64)
        tiny = max(np.abs(g).max(), np.abs(w).max()) <= 1e-3
        if scales[path] <= DEGENERATE or tiny:
            assert scales[path] <= 1e-3 and np.abs(g - w).max() <= 2e-3, \
                path
            continue
        assert np.abs(g - w).max() <= 5e-2 * np.abs(w).max(), path
        assert np.linalg.norm(g - w) <= 1e-2 * np.linalg.norm(w), path
    for (path, g), (_, w) in zip(_leaf_paths(tree['batch_stats']),
                                 _leaf_paths(jmut['batch_stats'])):
        assert np.abs(g - w).max() <= 1e-4 * max(np.abs(w).max(), 1e-6), \
            path


def test_inv_triplet_step_world2_matches_one_process(runs):
    """(c) the inv step: both legs' descriptors all-gathered, the triplet
    loss on the global batch on every rank, its gradient summed back by
    the gather and divided by the world size once (a gradient W times or
    1/W of one process's, or negatives mined over the local half, would
    miss the float64 check by far)."""
    _check_exact(runs, 'inv_fp64')
    _check_fp32(runs, 'inv_fp32', 'inv_fp64')
    coll = json.loads(str(runs['ranks']['inv_fp32'][0]['launches']))[
        'collectives']
    assert coll['all_gather'] == coll['all_gather_backward'] == 2


def test_reg_step_world2_matches_one_process(runs):
    """(d) the rotation step (each rank on two of the four pairs)."""
    _check_exact(runs, 'reg_fp64')
    _check_fp32(runs, 'reg_fp32', 'reg_fp64')


def test_cls_bf16_step_world2_matches_one_process(runs, tmp_path):
    """(e) the bf16 cls step (the packed statistics: the moments' plain
    version's sums all-reduced, one collective a norm) at the bf16 step's
    gates: loss to rtol 1e-3; per leaf with a real float64 gradient a
    cosine >= 0.9 (``dryrun.BF16_LEAF_COS``), the median no lower than
    one process's own median cosine on the clouds scaled by 1 + 1e-6 less
    0.02; a ~0 leaf at most 4 times one process's plus 1e-2."""
    _check_ranks_agree(runs, 'cls_bf16')
    got, want = runs['ranks']['cls_bf16'][0], runs['local']['cls_bf16']
    f64 = runs['local']['cls_fp64']
    np.testing.assert_allclose(float(got['loss']), float(want['loss']),
                               rtol=1e-3)
    noise = dryrun.run_step(
        'cls_bf16', SIZE, 'cpu', str(tmp_path),
        batch=dryrun.scale_clouds(dryrun.global_batch('cls', SIZE)))

    def cos(a, b):
        a, b = a.astype(np.float64).ravel(), b.astype(np.float64).ravel()
        return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    coss, floor = [], []
    for k, v in dryrun.leaves(want, ('grad/',)).items():
        if np.abs(f64[k]).max() <= DEGENERATE:
            assert np.abs(got[k]).max() <= 4 * np.abs(v).max() + 1e-2, k
            continue
        coss.append(cos(got[k], v))
        floor.append(cos(noise[k], v))
        assert coss[-1] >= dryrun.BF16_LEAF_COS, (k, coss[-1])
    assert np.median(coss) >= np.median(floor) - 0.02, (coss, floor)
    coll = json.loads(str(got['launches']))['collectives']
    assert coll['all_reduce'] == coll['all_reduce_backward'] > 0


def test_dropout_step_world2_equals_one_process(runs):
    """(f) dropout 0.5: each rank draws the global batch's mask and keeps
    its rows, so world 2 equals one process (float64, exact rule)."""
    _check_exact(runs, 'cls_dropout')
    assert not np.allclose(runs['local']['cls_dropout']['loss'],
                           runs['local']['cls_fp64']['loss'])


def test_group_of_one_is_the_step_alone(monkeypatch, tmp_path):
    """A gloo group of one rank in this process: the cls step through the
    trainer's distributed path (the weights broadcast, the gradients
    all-reduced) against a trainer's with no group
    (``dryrun.check_group_of_one``: weights, loss, statistics, all-reduced
    gradients and parameters after Adam bitwise); on the CPU, whose plain
    path has no atomics, every gradient bit for bit too."""
    for k in distributed.ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    out = str(tmp_path)
    alone = dryrun.build_trainer('cls_fp32', SIZE, 'cpu', out)
    init = {n: p.detach().clone() for n, p in alone.model.named_parameters()}
    want = dryrun.one_step(alone, 'cls_fp32', SIZE)
    distributed.init_distributed(
        backend='gloo', world_size=1, rank=0,
        init_method=f'tcp://127.0.0.1:{dryrun.free_port()}')
    try:
        trainer = dryrun.build_trainer('cls_fp32', SIZE, 'cpu', out)
        assert trainer.group is not None
        _, gaps = dryrun.check_group_of_one(
            trainer, 'cls_fp32', SIZE, init, want,
            dryrun.f64_grads('cls', SIZE, 'cpu', out))
    finally:
        distributed.shutdown()
    assert gaps['max_err'] == gaps['degenerate_err'] == 0.0
    assert mesh.data_group() is None


# -------------------------------------------------------- (g) entry point

def test_run_modelnet_under_torchrun(tmp_path):
    """(g) ``python -m torch.distributed.run --nproc-per-node 2`` of
    run_modelnet on the CPU (gloo), two steps of 12 (6 a rank) and the
    eval at the second: one run directory with one log.txt (rank 0's), a
    checkpoint that loads, and the eval's accuracy and loss equal to one
    process's eval of that checkpoint."""
    root = str(tmp_path / 'mn')
    tsynth.make_modelnet_tree(root, n_cats=4, n_train=3, n_test=3,
                              n_points=128, seed=1, splits=('train', 'testR'))
    runs_dir = tmp_path / 'runs'
    base = ['experiment', '-d', root, '--input-num', '128', '--kanchor',
            '20', '--no-augmentation', '--device', 'cpu']
    cmd = [sys.executable, '-m', 'torch.distributed.run', '--nproc-per-node',
           '2', '--master-addr', '127.0.0.1', '--master-port',
           str(dryrun.free_port()), '-m',
           'epn_pointcloud_tpu_torch.run_modelnet'] + base + ['--model-dir', str(runs_dir), '--run-mode', 'train',
                       '-i', '2', '--save-freq', '2']
    env = dict(_env(), PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get('PYTHONPATH')] if p]))
    proc = subprocess.run(cmd, env=env, cwd=str(tmp_path), timeout=300,
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    run_dirs = [d for d in runs_dir.glob('*/*') if d.is_dir()]
    assert len(run_dirs) == 1, run_dirs
    logs = list(runs_dir.rglob('log.txt'))
    assert logs == [run_dirs[0] / 'log.txt']
    log = logs[0].read_text()
    assert 'Data parallel over 2 ranks (gloo)' in log
    ckpts = list(run_dirs[0].glob('ckpt/*.pth'))
    assert len(ckpts) == 1
    sd = torch.load(ckpts[0], weights_only=True)

    one = run_modelnet.main(base + ['--model-dir', str(tmp_path / 'one'),
                                    '--run-mode', 'eval', '-b', '12', '-r',
                                    str(ckpts[0])], device='cpu')
    one.logger.close()
    assert set(sd) == set(one.model.state_dict())
    dp_lines = re.findall(r'\[Testing\] (Accuracy: .*|Average accuracy .*)',
                          log)
    one_log = next((tmp_path / 'one').rglob('log.txt')).read_text()
    one_lines = re.findall(r'\[Testing\] (Accuracy: .*|Average accuracy .*)',
                           one_log)
    assert len(dp_lines) == 2 and dp_lines == one_lines, (dp_lines,
                                                          one_lines)


# ----------------------------------------------------------- (h) refusals

def test_refusals(monkeypatch, tmp_path):
    """(h) init_distributed() with no rendezvous environment is a no-op
    returning 0; a partial one raises (no fallback to one process);
    --mesh-anchor 2 (anchor-axis tensor parallelism) is refused before a
    run directory is made; the 3DMatch evaluation refuses WORLD_SIZE > 1."""
    for k in distributed.ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    assert distributed.init_distributed() == 0
    assert not torch.distributed.is_initialized()
    assert distributed.process_env() == (1, 0) and mesh.make_mesh() is None
    with pytest.raises(ValueError):
        mesh.make_mesh(n_anchor=0)
    monkeypatch.setenv('WORLD_SIZE', '2')
    with pytest.raises(KeyError):
        distributed.init_distributed()
    monkeypatch.delenv('WORLD_SIZE')
    root = str(tmp_path / 'mn')
    tsynth.make_modelnet_tree(root, n_cats=1, n_train=1, n_test=1,
                              n_points=64, seed=1, splits=('testR',))
    with pytest.raises(NotImplementedError, match='anchor-parallel'):
        run_modelnet.main(['experiment', '-d', root, '--run-mode', 'eval',
                           '--mesh-anchor', '2', '--model-dir',
                           str(tmp_path / 'runs')], device='cpu')
    assert not (tmp_path / 'runs').exists()
    monkeypatch.setenv('WORLD_SIZE', '2')
    with pytest.raises(SystemExit, match='one process'):
        run_3dmatch.main(['experiment', '-d', root, '--run-mode', 'eval',
                          '-r', 'trained_models/models/x/ckpt.pth'],
                         scenes=[], device='cpu')
