"""Trainer base: the experiment lifecycle up to evaluation (counterpart of
``epn_pointcloud_tpu/app/trainer.py``).

Order: seed -> run dir -> opt dump -> logger -> datasets -> model ->
resume. Checkpoints are the port's own ``state_dict`` files
(``torch.save``); ``-r PATH`` loads one, and without it the weights come
from a seeded init. Training is not ported yet.
"""

from __future__ import annotations

import json
import os
import random
import time
from typing import Optional

import numpy as np
import torch

from . import config as config_lib
from .logger import Logger


def pick_device() -> torch.device:
    return torch.device('cuda' if torch.cuda.is_available() else 'cpu')


def set_fp32_parity() -> None:
    """fp32 parity mode: no TF32 in cuBLAS matmuls or cuDNN convolutions,
    so the plain PyTorch path computes in full fp32 like the kernels."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Trainer:
    def __init__(self, opt, device: Optional[torch.device] = None):
        opt_dict = config_lib.dump_args(opt)
        self.opt = opt
        self.device = device or pick_device()
        set_fp32_parity()

        random.seed(opt.seed)
        np.random.seed(opt.seed)
        torch.manual_seed(opt.seed)

        experiment_id = (opt.experiment_id if opt.mode == 'train'
                         else f'{opt.experiment_id}_{opt.mode}')
        model_id = f'model_{time.strftime("%Y%m%d_%H%M%S")}'
        self.root_dir = os.path.join(opt.model_dir, experiment_id, model_id)
        os.makedirs(self.root_dir, exist_ok=True)
        with open(os.path.join(self.root_dir, 'opt.txt'), 'w') as fout:
            json.dump(opt_dict, fout, indent=2, default=str)

        self.logger = Logger(log_file=os.path.join(self.root_dir, 'log.txt'))
        self.logger.log('Setup', 'Logger created! Hello World!')
        self.logger.log('Setup', f'Random seed has been set to {opt.seed}')
        self.logger.log('Setup', f'Experiment id: {experiment_id}')
        self.logger.log('Setup', f'Model id: {model_id}')
        self.logger.log('Setup', f'Device: {self._device_name()}')

        self._setup_datasets()
        self._setup_model()
        self._resume_from_ckpt(getattr(opt, 'resume_path', None))
        self.logger.log('Setup', 'Setup finished!')

    def _device_name(self) -> str:
        if self.device.type == 'cuda':
            return f'{torch.cuda.get_device_name(self.device)} (cuda)'
        return 'cpu'

    def _setup_datasets(self):
        raise NotImplementedError

    def _setup_model(self):
        raise NotImplementedError

    def _resume_from_ckpt(self, resume_path: Optional[str]):
        if resume_path is None:
            self.logger.log('Setup', 'No checkpoint given: seeded init.')
            return
        self.logger.log('Setup', f'Resume from checkpoint: {resume_path}')
        sd = torch.load(resume_path, map_location=self.device,
                        weights_only=True)
        self.model.load_state_dict(sd)
        self.logger.log('Setup', 'Resume finished! Great!')
