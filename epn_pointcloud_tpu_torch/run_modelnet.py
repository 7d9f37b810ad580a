"""ModelNet40 classification entry point of the torch port (same CLI as the
repo's run_modelnet.py). Only evaluation is ported so far:

  python -m epn_pointcloud_tpu_torch.run_modelnet experiment -d DATASET \\
      --run-mode eval -b 32 [-r CHECKPOINT.pth]

Without ``-r`` the weights come from a seeded init (``-s``). On a machine
with a CUDA device the model runs there, through the CUDA kernels.
"""

from epn_pointcloud_tpu_torch.app import config as config_lib
from epn_pointcloud_tpu_torch.app.trainer_modelnet import TrainerModelNet


def main(argv=None):
    opt = config_lib.parse_args(argv)
    # per-task overrides of the reference entry point
    opt.model.flag = 'attention'
    opt.model.model = 'cls_so3net_pn'
    if opt.mode not in ('eval', 'test'):
        raise NotImplementedError('the torch port runs --run-mode eval only')
    trainer = TrainerModelNet(opt)
    trainer.eval()
    return trainer


if __name__ == '__main__':
    main()
