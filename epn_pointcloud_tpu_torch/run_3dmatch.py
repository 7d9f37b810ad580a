"""3DMatch descriptor-training entry point of the torch port (same CLI as the
repo's run_3dmatch.py):

  python -m epn_pointcloud_tpu_torch.run_3dmatch experiment -d DATASET \\
      --run-mode train [-i ITERS] [--save-freq N] [-lf N] [-r CKPT.pth] \\
      [--compute-dtype bf16]

DATASET holds fused_fragments/<scene>/<seq>/cloud_bin_N.ply (+ pose) and
kpts/<scene>/<seq>/cloud_bin_A-cloud_bin_B.npy keypoint pairs
(``data.synthetic.make_3dmatch_tree`` writes such a tree). It applies the
reference's overrides (``config_opt_3dmatch``: search radius 0.4, the
'attention' head, inv_so3net_pn, no augmentation, 16 patch pairs of one
fragment pair a step, lr decay every 20000 steps); ``-i`` and
``--save-freq`` given on the command line win over its 150000 / 4000. The
full-width model (1024-point patches, 60 anchors) trains on the CUDA
device, through the CUDA kernels, forward and backward, in fp32 or, with
``--compute-dtype bf16``, in the bf16 production mode (its checkpoint
reloads through ``-r`` in the same mode); ``main(argv, device='cpu')`` runs
it on the CPU through their plain versions. ``--run-mode eval`` and
``--equi-alpha > 0`` raise ``NotImplementedError``: later slices.
"""

import sys

from epn_pointcloud_tpu_torch.app import config as config_lib
from epn_pointcloud_tpu_torch.app.trainer_3dmatch import Trainer3DMatch


def config_opt_3dmatch(opt):
    """The reference entry point's overrides (run_3dmatch.py:19-34 of the
    repo; its evaluation branch waits for the evaluation pipeline)."""
    opt.model.search_radius = 0.4
    opt.model.flag = 'attention'
    opt.model.model = 'inv_so3net_pn'
    opt.no_augmentation = True
    if opt.mode == 'train':
        opt.npt = 16
        opt.batch_size = 1
        opt.num_iterations = 150000
        opt.save_freq = 4000
        opt.train_lr.decay_step = 20000
    return opt


def _given(argv, *flags) -> bool:
    return any(a in flags or a.split('=', 1)[0] in flags for a in argv)


def main(argv=None, device=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    opt = config_lib.parse_args(argv)
    kept = {k: getattr(opt, k) for k, flags in (
        ('num_iterations', ('-i', '--num-iterations')),
        ('save_freq', ('--save-freq',))) if _given(argv, *flags)}
    opt = config_opt_3dmatch(opt)
    for k, v in kept.items():
        setattr(opt, k, v)
    trainer = Trainer3DMatch(opt, device)
    trainer.train()
    return trainer


if __name__ == '__main__':
    main()
