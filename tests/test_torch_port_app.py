"""App layer of the torch port on the CPU: the ModelNet40 test loader against
the JAX package's loader on one synthetic tree (exact), the
``run_modelnet --run-mode eval`` entry point end to end, seeded init and
``-r`` checkpoint resume, and ``run_modelnet --run-mode train`` end to end
with its checkpoint evaluated through ``-r``.
"""

import numpy as np
import pytest
import torch

from epn_pointcloud_tpu.app import config as jconfig
from epn_pointcloud_tpu.data import modelnet40 as jdata
from epn_pointcloud_tpu.data import synthetic as jsynth

from epn_pointcloud_tpu_torch import models, run_modelnet
from epn_pointcloud_tpu_torch.app import config as tconfig
from epn_pointcloud_tpu_torch.data import modelnet40 as tdata
from epn_pointcloud_tpu_torch.data import synthetic as tsynth


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('modelnet'))
    tsynth.make_modelnet_tree(root, n_cats=2, n_train=0, n_test=3,
                              n_points=64, seed=1, splits=('testR',))
    return root


def test_synthetic_tree_matches_jax_generator(tmp_path):
    import scipy.io as sio
    a, b = str(tmp_path / 'a'), str(tmp_path / 'b')
    tsynth.make_modelnet_tree(a, n_cats=6, n_train=1, n_test=1, n_points=32,
                              seed=3, splits=('testR',))
    jsynth.make_modelnet_tree(b, n_cats=6, n_train=1, n_test=1, n_points=32,
                              seed=3, splits=('testR',))
    for cat in ['airplane'] + [f'cat{i:02d}' for i in range(1, 6)]:
        fa = sio.loadmat(f'{a}/{cat}/testR/{cat}_0000.mat')
        fb = sio.loadmat(f'{b}/{cat}/testR/{cat}_0000.mat')
        np.testing.assert_array_equal(fa['pc'], fb['pc'])


def test_test_loader_matches_jax_loader(tree):
    argv = ['experiment', '-d', tree, '--run-mode', 'eval', '-b', '2']
    jopt = jconfig.parse_args(argv)
    topt = tconfig.parse_args(argv)
    for o in (jopt, topt):
        o.model.flag = 'attention'
    jl = jdata.DataLoader(jdata.Dataloader_ModelNet40(jopt, 'testR'), 2,
                          shuffle=False, seed=jopt.seed, drop_last=False,
                          process_shard=False)
    tl = tdata.DataLoader(tdata.Dataloader_ModelNet40(topt, 'testR'), 2)
    jb, tb = list(jl), list(tl)
    assert len(jb) == len(tb) == 3
    for x, y in zip(jb, tb):
        for k in ('pc', 'label', 'R', 'R_label'):
            np.testing.assert_array_equal(x[k], y[k])


def test_run_modelnet_eval_end_to_end(tree, tmp_path):
    argv = ['experiment', '-d', tree, '--run-mode', 'eval', '-b', '2',
            '--model-dir', str(tmp_path / 'runs'), '--input-num', '64']
    trainer = run_modelnet.main(argv)
    assert trainer.device.type == 'cpu'
    logits = torch.cat(trainer.eval_logits)
    assert logits.shape == (6, 40)
    assert torch.isfinite(logits).all()
    assert 0.0 <= trainer.test_accs[-1] <= 100.0

    # -r: eval runs on the weights of a saved port state_dict
    model99 = models.build_model_from(trainer.opt, seed=99).eval()
    ckpt = str(tmp_path / 'seed99.pth')
    torch.save(model99.state_dict(), ckpt)
    trainer.logger.close()
    other = run_modelnet.main(argv + ['-r', ckpt])
    # a fresh loader replays the same seeded test rotations
    loader = tdata.DataLoader(tdata.Dataloader_ModelNet40(other.opt, 'testR'),
                              2)
    with torch.no_grad():
        want = torch.cat([model99(torch.from_numpy(d['pc']))[0]
                          for d in loader])
    got = torch.cat(other.eval_logits)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not torch.equal(got, logits)
    other.logger.close()


def test_run_modelnet_train_end_to_end(tmp_path):
    """Two train steps (b=12 forced, as the reference entry point does) on a
    12-cloud train split, a checkpoint and an eval at step 2; the saved
    state_dict reloads through -r and gives the trained model's logits."""
    import math
    import os
    root = str(tmp_path / 'mn')
    tsynth.make_modelnet_tree(root, n_cats=4, n_train=3, n_test=1,
                              n_points=64, seed=1, splits=('train', 'testR'))
    runs = str(tmp_path / 'runs')
    trainer = run_modelnet.main(['experiment', '-d', root, '--run-mode',
                                 'train', '--input-num', '64', '-i', '2',
                                 '--save-freq', '2', '-lf', '1',
                                 '--model-dir', runs])
    trainer.logger.close()
    assert trainer.opt.batch_size == 12 and trainer.iter_counter == 2
    assert trainer.epoch_counter == 1          # one batch an epoch: wrapped
    for k in ('Loss', 'R_Loss', 'Acc', 'R_Acc'):
        assert math.isfinite(trainer.summary.get_item(k)), k
    assert os.path.basename(trainer.last_ckpt) == 'playground_net_Iter2.pth'
    assert os.path.exists(trainer.last_ckpt)
    trained = torch.cat(trainer.eval_logits)
    assert trained.shape == (4, 40) and torch.isfinite(trained).all()

    other = run_modelnet.main(['experiment', '-d', root, '--run-mode', 'eval',
                               '-b', '12', '--input-num', '64', '-r',
                               trainer.last_ckpt, '--model-dir', runs])
    other.logger.close()
    torch.testing.assert_close(torch.cat(other.eval_logits), trained,
                               rtol=0, atol=0)

    # save_full_state: model, Adam state and iteration come back with -r
    full = str(tmp_path / 'full.pth')
    trainer.save_full_state(full)
    resumed = run_modelnet.main(['experiment', '-d', root, '--input-num',
                                 '64', '-i', '0', '-r', full,
                                 '--model-dir', runs])
    resumed.logger.close()
    assert resumed.iter_counter == 2
    want = trainer.optimizer.state_dict()['state']
    got = resumed.optimizer.state_dict()['state']
    assert want.keys() == got.keys()
    for k in want:
        for name in ('exp_avg', 'exp_avg_sq'):
            assert torch.equal(want[k][name], got[k][name])
    with pytest.raises(NotImplementedError):
        run_modelnet.main(['experiment', '-d', root, '--input-num', '64',
                           '--steps-per-dispatch', '2', '--model-dir', runs])
