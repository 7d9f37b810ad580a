"""3DMatch entry point of the torch port (same CLI as the repo's
run_3dmatch.py): descriptor training and the descriptor evaluation.

  python -m epn_pointcloud_tpu_torch.run_3dmatch experiment -d DATASET \\
      --run-mode train [-i ITERS] [--save-freq N] [-lf N] [-r CKPT.pth] \\
      [--compute-dtype bf16]
  python -m epn_pointcloud_tpu_torch.run_3dmatch experiment -d DATASET \\
      --run-mode eval -r trained_models/<experiment>/.../CKPT.pth \\
      [--compute-dtype bf16]

For training, DATASET holds fused_fragments/<scene>/<seq>/cloud_bin_N.ply
(+ pose) and kpts/<scene>/<seq>/cloud_bin_A-cloud_bin_B.npy keypoint pairs;
for the evaluation, <scene>/cloud_bin_N.ply,
01_Keypoints/cloud_bin_NKeypoints.txt and gt.log for each scene of
SCENE_TO_TEST (``data.synthetic.make_3dmatch_tree`` writes both). It
applies the reference's overrides (``config_opt_3dmatch``: search radius
0.4, the 'attention' head, inv_so3net_pn, no augmentation; in training 16
patch pairs of one fragment pair a step and lr decay every 20000 steps, in
evaluation 8 x 24 = 192 patches a forward); ``-i`` and ``--save-freq``
given on the command line win over its 150000 / 4000. The evaluation needs
``-r``, and its experiment id is the third part of that path (as the JAX
entry point takes it); it writes the descriptors and recall.txt under
data/evaluate/3DMatch/ and recall.csv under trained_models/evaluate/3DMatch/
of the working directory. The full-width model (1024-point patches, 60
anchors) runs on the CUDA device, through the CUDA kernels, forward and
backward, in fp32 or, with ``--compute-dtype bf16``, in the bf16 production
mode (a bf16 checkpoint reloads through ``-r`` in the same mode);
``main(argv, device='cpu')`` runs it on the CPU through their plain
versions. ``--equi-alpha > 0`` raises ``NotImplementedError``: the JAX
package's equivariance loss fails on its own model.

Training runs data-parallel under torchrun, one process a GPU (each rank
on its slice of every leg's patches; the triplet loss on the global
batch):

  python -m torch.distributed.run --nproc-per-node N \
      -m epn_pointcloud_tpu_torch.run_3dmatch experiment -d DATASET \
      --run-mode train ...

The evaluation runs in one process and refuses a WORLD_SIZE above 1.
"""

import os
import sys

from epn_pointcloud_tpu_torch.app import config as config_lib
from epn_pointcloud_tpu_torch.app.trainer_3dmatch import Trainer3DMatch

SCENE_TO_TEST = [
    '7-scenes-redkitchen',
    'sun3d-home_at-home_at_scan1_2013_jan_1',
    'sun3d-home_md-home_md_scan9_2012_sep_30',
    'sun3d-hotel_uc-scan3',
    'sun3d-hotel_umd-maryland_hotel1',
    'sun3d-hotel_umd-maryland_hotel3',
    'sun3d-mit_76_studyroom-76-1studyroom2',
    'sun3d-mit_lab_hj-lab_hj_tea_nov_2_2012_scan1_erika',
]


def config_opt_3dmatch(opt):
    """The reference entry point's overrides (run_3dmatch.py:19-34 of the
    repo)."""
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
    elif opt.mode == 'eval':
        opt.npt = 24
        opt.batch_size = 8
    return opt


def _given(argv, *flags) -> bool:
    return any(a in flags or a.split('=', 1)[0] in flags for a in argv)


def main(argv=None, scenes=None, device=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    opt = config_lib.parse_args(argv)
    kept = {k: getattr(opt, k) for k, flags in (
        ('num_iterations', ('-i', '--num-iterations')),
        ('save_freq', ('--save-freq',))) if _given(argv, *flags)}
    opt = config_opt_3dmatch(opt)
    for k, v in kept.items():
        setattr(opt, k, v)
    scenes = scenes if scenes is not None else SCENE_TO_TEST
    if opt.mode == 'eval':
        if int(os.environ.get('WORLD_SIZE', 1)) > 1:
            raise SystemExit('run_3dmatch --run-mode eval runs in one '
                             'process; start it without torchrun (WORLD_SIZE '
                             f'is {os.environ["WORLD_SIZE"]})')
        assert opt.resume_path is not None, \
            'the evaluation needs a checkpoint (-r)'
        opt.experiment_id = opt.resume_path.split('/')[2]
    trainer = Trainer3DMatch(opt, device)
    if opt.mode == 'train':
        trainer.train()
    elif opt.mode == 'eval':
        trainer.eval(scenes)
    return trainer


if __name__ == '__main__':
    main()
