"""3DMatch descriptor training (counterpart of
``epn_pointcloud_tpu/app/trainer_3dmatch.py`` ``Trainer3DMatch``, its
training part).

A step is two model calls, one a leg (the src and the tgt patches of npt
keypoint pairs), the in-batch hard-negative triplet loss on the two
descriptor sets, a backward through the conv kernels' autograd Functions
and an Adam step at the scheduled learning rate, in fp32 or, with
``--compute-dtype bf16``, in the production mode (bf16 activations and
weights at use; fp32 parameters, Adam, statistics and descriptors). Its log
scalars (Loss = Pos - Neg, Pos, Neg, Acc) stay on the device until the
Summary reads them at log time. The block-parameter tree goes to
``<run dir>/params.json``, as the JAX trainer writes it. Not ported yet, and
refused: the descriptor evaluation (``--run-mode eval``) and the
equivariance loss (``--equi-alpha > 0``).
"""

from __future__ import annotations

import os

import torch

from .. import losses, models
from .. import train as train_lib
from .trainer import Trainer


class Trainer3DMatch(Trainer):
    def __init__(self, opt, device=None):
        if opt.mode != 'train':
            raise NotImplementedError(
                f'3DMatch --run-mode {opt.mode!r} is not ported: the '
                f'descriptor evaluation pipeline (SceneEvalLoader, '
                f'evaluation_3dmatch) is a later slice; train only')
        if opt.train_loss.equi_alpha > 0:
            raise NotImplementedError('the equivariance loss (--equi-alpha > '
                                      '0) is not ported: a later slice')
        if getattr(opt, 'steps_per_dispatch', 1) > 1:
            raise NotImplementedError('--steps-per-dispatch > 1 is TPU '
                                      'dispatch machinery; the port takes one '
                                      'step a call')
        self.epoch_counter = 0
        super().__init__(opt, device)
        self.summary.register(['Loss', 'Pos', 'Neg', 'Acc'])

    def _setup_datasets(self):
        from ..data.match_3dmatch import FragmentLoader
        from ..data.modelnet40 import DataLoader
        opt = self.opt
        dataset = FragmentLoader(opt, opt.model.search_radius,
                                 kptname=opt.dataset,
                                 use_normals=opt.model.normals, npt=opt.npt)
        self.dataset = DataLoader(dataset, opt.batch_size, shuffle=True,
                                  seed=opt.seed)
        self.dataset_iter = iter(self.dataset)

    def _setup_model(self):
        self.model = models.build_model_from(
            self.opt, seed=self.opt.seed,
            outfile_path=os.path.join(self.root_dir, 'params.json'))
        self.model.to(self.device)

    def _prepare_input(self, data):
        """[b, npt, n, c] legs -> [b * npt, n, c] tensors on the device."""
        n = self.opt.model.input_num
        return tuple(torch.from_numpy(
            data[k].reshape(-1, n, data[k].shape[-1])).to(self.device)
            for k in ('src', 'tgt'))

    def step(self):
        try:
            data = next(self.dataset_iter)
        except StopIteration:
            self.epoch_counter += 1
            self.logger.log('DataLoader', f'At Epoch {self.epoch_counter}!')
            self.dataset_iter = iter(self.dataset)
            data = next(self.dataset_iter)
        self._optimize(data)
        self.iter_counter += 1

    def _optimize(self, data):
        src, tgt = self._prepare_input(data)
        self.model.train()
        y_src, _ = self.model(src)
        y_tgt, _ = self.model(tgt)
        loss, aux = losses.triplet_batch_loss(
            y_src, y_tgt, self.opt.train_loss.loss_type,
            self.opt.train_loss.margin)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        train_lib.set_lr(self.optimizer, self.lr_schedule(self.iter_counter))
        self.optimizer.step()
        fpos, cneg = aux['fpos'].detach(), aux['cneg'].detach()
        self.summary.update_async({'Loss': fpos - cneg, 'Pos': fpos,
                                   'Neg': cneg,
                                   'Acc': 100.0 * aux['accuracy']})
        self.last_loss = loss.detach()
