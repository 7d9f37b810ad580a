"""ModelNet rotation-alignment entry point of the torch port (same CLI as
the repo's run_modelnet_rotation.py):

  python -m epn_pointcloud_tpu_torch.run_modelnet_rotation experiment \\
      -d DATASET [--run-mode train] [-i ITERS] [--save-freq N] [-lf N] \\
      [--representation quat|ortho6d] [--compute-dtype bf16]
  python -m epn_pointcloud_tpu_torch.run_modelnet_rotation experiment \\
      -d DATASET --run-mode eval -r CHECKPOINT.pth [--compute-dtype bf16]

DATASET holds airplane/train and airplane/testR .mat clouds
(``data.synthetic.make_modelnet_tree(..., airplane_asym=True)`` writes
such a tree). It applies the reference's overrides: the 'rotation' flag
and reg_so3net; in training b = 8 pairs, lr decay 0.97 every 3000 steps
(on the schedule, where the reference set them on a namespace its
scheduler never reads), dropout 0 and the 'default' attention loss. A
train run saves a state_dict checkpoint and evaluates every --save-freq
steps; eval (or test) returns the median angular error in degrees on testR
and, with ``-r``, writes the per-pair errors under data/alignment_errors/
of the working directory. The full-width model (1024-point clouds, 60
anchors) runs on the CUDA device, through the CUDA kernels, forward and
backward, in fp32 or, with ``--compute-dtype bf16``, in the bf16
production mode; ``main(argv, device='cpu')`` runs it on the CPU through
their plain versions.

Data-parallel training and evaluation run under torchrun, one process a
GPU (NCCL; on the CPU, ``--device cpu`` or ``main(argv, device='cpu')``,
gloo); each rank loads its slice of every global batch, and rank 0 writes
the run directory:

  python -m torch.distributed.run --nproc-per-node N \\
      -m epn_pointcloud_tpu_torch.run_modelnet_rotation experiment \\
      -d DATASET ...
"""

from epn_pointcloud_tpu_torch.app import config as config_lib
from epn_pointcloud_tpu_torch.app.trainer_modelnet_rotation import \
    TrainerModelNetRotation


def main(argv=None, device=None):
    opt = config_lib.parse_args(argv)
    opt.model.flag = 'rotation'
    opt.model.model = 'reg_so3net'
    if opt.mode == 'train':
        opt.batch_size = 8
        opt.train_lr.decay_rate = 0.97
        opt.train_lr.decay_step = 3000
        opt.model.dropout_rate = 0.0
        opt.train_loss.attention_loss_type = 'default'
    elif opt.mode not in ('eval', 'test'):
        raise ValueError(f'--run-mode {opt.mode!r}: train, eval or test')
    trainer = TrainerModelNetRotation(opt, device)
    if opt.mode == 'train':
        trainer.train()
    else:
        trainer.eval()
    return trainer


if __name__ == '__main__':
    main()
