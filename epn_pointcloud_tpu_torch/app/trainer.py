"""Trainer base: the experiment lifecycle (counterpart of
``epn_pointcloud_tpu/app/trainer.py``).

Order: seed -> run dir -> opt dump -> logger -> ckpt dir -> datasets ->
model -> optimizer -> resume. Checkpoints are the port's own ``state_dict``
files (``torch.save``, ``<ckpt>/<experiment>_net_<step>.pth``); ``-r PATH``
loads one, and without it the weights come from a seeded init.
``save_full_state`` adds the optimizer state and the iteration for an exact
resume. The run goes on the CUDA device unless the caller names another
(``device='cpu'``, as the CPU tests do); without a CUDA device and with none
named it refuses to start. ``--compute-dtype`` sets the conv path's
precision policy (``ops.so3conv.set_compute_dtype``) for the process, in
every mode: a bf16-served model is trained in bf16 (parameters and Adam
stay fp32; weights are cast to bf16 at use).
"""

from __future__ import annotations

import json
import os
import random
import time
from typing import Optional

import numpy as np
import torch

from .. import train as train_lib
from ..ops import so3conv
from . import config as config_lib
from .logger import Logger, Summary, Timer


def pick_device(device=None) -> torch.device:
    """The device a run uses: the one named, else CUDA, which must exist."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: the port runs on the card; pass '
                           "device='cpu' to run on the CPU on purpose")
    return torch.device('cuda')


def set_fp32_parity() -> None:
    """fp32 parity mode: no TF32 in cuBLAS matmuls or cuDNN convolutions,
    so the plain PyTorch path computes in full fp32 like the kernels."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Trainer:
    def __init__(self, opt, device: Optional[torch.device] = None):
        opt_dict = config_lib.dump_args(opt)
        self.opt = opt
        dtype = getattr(opt, 'compute_dtype', 'fp32')
        self.device = pick_device(device)
        set_fp32_parity()
        so3conv.set_compute_dtype(dtype)

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

        self.ckpt_dir = os.path.join(self.root_dir, 'ckpt')
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.logger.log('Setup', 'Checkpoint dir created!')

        self._setup_datasets()
        self._setup_model()
        self._setup_optim()
        self.iter_counter = 0
        self._resume_from_ckpt(getattr(opt, 'resume_path', None))

        self.summary = Summary()
        self.timer = Timer()
        self.summary.register(['Time'])
        self.logger.log('Setup', 'Setup finished!')

    def _device_name(self) -> str:
        if self.device.type == 'cuda':
            return f'{torch.cuda.get_device_name(self.device)} (cuda)'
        return 'cpu'

    # ------------------------------------------------------------------ api

    def train(self):
        self.opt.mode = 'train'
        if self.opt.num_epochs is not None:
            self.train_epoch()
        else:
            self.train_iter()

    def test(self):
        self.opt.mode = 'test'

    def train_iter(self):
        """The loop: one optimizer step a call of ``step``; log every
        log_freq steps, checkpoint and test every save_freq steps."""
        i, next_log = 0, 0
        while i < self.opt.num_iterations:
            self.timer.set_point('train_iter')
            self.step()
            self.summary.update({'Time': self.timer.reset_point('train_iter')})
            if i >= next_log:
                self._print_running_stats(
                    f'Epoch {self.epoch_counter}, Iter {i}'
                    if hasattr(self, 'epoch_counter') else f'Iter {i}')
                next_log += self.opt.log_freq
            i += 1
            if i % self.opt.save_freq == 0:
                self._save_network(f'Iter{i}')
                self.test()

    def train_epoch(self):
        raise NotImplementedError('epoch-based training (-e) has no epoch '
                                  'step in this trainer; use -i')

    # ------------------------------------------------------------ overrides

    def _print_running_stats(self, step):
        self.logger.log('Training', f'{step}: {self.summary.get()}')

    def step(self):
        raise NotImplementedError

    def _setup_datasets(self):
        raise NotImplementedError

    def _setup_model(self):
        raise NotImplementedError

    def _setup_optim(self):
        self.logger.log('Setup', 'Setup optimizer!')
        self.lr_schedule = train_lib.make_lr_schedule(
            **vars(self.opt.train_lr))
        self.optimizer = train_lib.make_optimizer(self.model.parameters(),
                                                  self.opt.train_lr.init_lr)
        self.logger.log('Setup', 'Optimizer all-set!')

    # -------------------------------------------------------- checkpointing

    def _save_network(self, step, label=None, path=None):
        label = self.opt.experiment_id if label is None else label
        save_path = (os.path.join(self.ckpt_dir, f'{label}_net_{step}.pth')
                     if path is None else f'{path}.pth')
        torch.save(self.model.state_dict(), save_path)
        self.logger.log('Training', f'Checkpoint saved to: {save_path}!')
        self.last_ckpt = save_path

    def save_full_state(self, path: str):
        """Model, optimizer state and iteration, for an exact resume."""
        torch.save({'model': self.model.state_dict(),
                    'optimizer': self.optimizer.state_dict(),
                    'iter': self.iter_counter}, path)

    def _resume_from_ckpt(self, resume_path: Optional[str]):
        if resume_path is None:
            self.logger.log('Setup', 'No checkpoint given: seeded init.')
            return
        self.logger.log('Setup', f'Resume from checkpoint: {resume_path}')
        sd = torch.load(resume_path, map_location=self.device,
                        weights_only=True)
        if 'optimizer' in sd:           # a save_full_state file
            self.optimizer.load_state_dict(sd['optimizer'])
            self.iter_counter = int(sd['iter'])
            sd = sd['model']
        self.model.load_state_dict(sd)
        self.logger.log('Setup', 'Resume finished! Great!')
