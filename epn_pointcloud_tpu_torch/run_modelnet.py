"""ModelNet40 classification entry point of the torch port (same CLI as the
repo's run_modelnet.py):

  python -m epn_pointcloud_tpu_torch.run_modelnet experiment -d DATASET \\
      [--run-mode train] [-i ITERS] [--save-freq N] [-lf N]
  python -m epn_pointcloud_tpu_torch.run_modelnet experiment -d DATASET \\
      --run-mode eval -b 32 [-r CHECKPOINT.pth]

Training forces the reference's overrides (b=12, lr decay 0.5 every 20000
steps, the 'default' attention loss), saves a state_dict checkpoint and
evaluates every --save-freq steps. Without ``-r`` the weights come from a
seeded init (``-s``). On a machine with a CUDA device the model runs there,
through the CUDA kernels, forward and backward.
"""

from epn_pointcloud_tpu_torch.app import config as config_lib
from epn_pointcloud_tpu_torch.app.trainer_modelnet import TrainerModelNet


def main(argv=None):
    opt = config_lib.parse_args(argv)
    # per-task overrides of the reference entry point
    opt.model.flag = 'attention'
    opt.model.model = 'cls_so3net_pn'
    if opt.mode == 'train':
        opt.batch_size = 12
        opt.train_lr.decay_rate = 0.5
        opt.train_lr.decay_step = 20000
        opt.train_loss.attention_loss_type = 'default'
    elif opt.mode not in ('eval', 'test'):
        raise ValueError(f'--run-mode {opt.mode!r}: train, eval or test')
    trainer = TrainerModelNet(opt)
    if opt.mode == 'train':
        trainer.train()
    else:
        trainer.eval()
    return trainer


if __name__ == '__main__':
    main()
