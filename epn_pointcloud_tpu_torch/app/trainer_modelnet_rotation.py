"""ModelNet rotation alignment: the train and eval lifecycle (counterpart of
``epn_pointcloud_tpu/app/trainer_modelnet_rotation.py``
``TrainerModelNetRotation``).

A train step is a train-mode forward of the pair model on a batch of
alignment pairs, the multi-task detection loss (the anchor-pair cross
entropy and the weighted L2 of the regressed rotations), a backward
through the conv kernels' autograd Functions and an Adam step at the
scheduled learning rate. Its log scalars (Loss, Reg_Loss, Mean_Err, R_Acc)
stay on the device until the Summary reads them at log time. ``eval()``
returns the median angular error in degrees over the rotated test split
(testR); resumed from a checkpoint, it writes the per-pair errors to
``data/alignment_errors/<experiment><step>_error.txt`` under the working
directory. The rotation is regressed as a quaternion or an ortho6d.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import losses, models
from .. import train as train_lib
from ..nn.layers import convention_constant
from .trainer import Trainer


class TrainerModelNetRotation(Trainer):
    def __init__(self, opt, device=None):
        rp = opt.model.representation
        if rp not in ('quat', 'ortho6d'):
            raise KeyError(f'Unrecognized representation of rotation: {rp}')
        if getattr(opt, 'steps_per_dispatch', 1) > 1:
            raise NotImplementedError('--steps-per-dispatch > 1 is TPU '
                                      'dispatch machinery; the port takes one '
                                      'step a call')
        self.nr = 4 if rp == 'quat' else 6
        self.epoch_counter = 0
        self.test_accs = []
        super().__init__(opt, device)
        self.summary.register(['Loss', 'Reg_Loss', 'Mean_Err', 'R_Acc'])

    @property
    def anchors(self) -> torch.Tensor:
        """The anchors of the anchor convention in force, on the device
        (copied there once a convention)."""
        return convention_constant('anchors', self.opt.model.kanchor,
                                   self.device)

    def _setup_datasets(self):
        from ..data.modelnet40 import DataLoader, Dataloader_ModelNet40Alignment
        self.opt.model.flag = 'rotation'
        opt = self.opt
        if opt.mode == 'train':
            self.dataset = DataLoader(Dataloader_ModelNet40Alignment(opt),
                                      opt.batch_size, shuffle=True,
                                      seed=opt.seed)
            self.dataset_iter = iter(self.dataset)
        self.dataset_test = DataLoader(
            Dataloader_ModelNet40Alignment(opt, 'testR'), opt.batch_size,
            shuffle=True, seed=opt.seed, drop_last=True)

    def _setup_model(self):
        if self.opt.resume_path is not None:
            splits = os.path.basename(self.opt.resume_path).split('_net_')
            self.exp_name = splits[0] + os.path.splitext(splits[1])[0]
        else:
            self.exp_name = None
        # the block-parameter tree to <run dir>/params.json in train mode
        self.model = models.build_model_from(
            self.opt, seed=self.opt.seed,
            outfile_path=(os.path.join(self.root_dir, 'params.json')
                          if self.opt.mode == 'train' else None))
        self.model.to(self.device)

    def _batch(self, data):
        nb = data['pc'].shape[0]
        dev = self.device
        return (torch.from_numpy(data['pc']).to(dev),
                torch.from_numpy(data['R_label'].reshape(nb, -1)).to(dev),
                torch.from_numpy(data['T']).to(dev),
                torch.from_numpy(data['R']).to(dev))

    def _loss(self, pc, rlabel, T, R):
        wts, y = self.model(pc)
        return losses.multi_task_detection_loss(self.anchors, wts, rlabel, y,
                                                R, T, nr=self.nr)

    def _next_batch(self):
        try:
            return next(self.dataset_iter)
        except StopIteration:
            self.epoch_counter += 1
            self.logger.log('DataLoader', f'At Epoch {self.epoch_counter}!')
            self.dataset_iter = iter(self.dataset)
            return next(self.dataset_iter)

    def step(self):
        self._optimize(self._next_batch())
        self.iter_counter += 1

    def _optimize(self, data):
        self.model.train()
        loss, aux = self._loss(*self._batch(data))
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        train_lib.set_lr(self.optimizer, self.lr_schedule(self.iter_counter))
        self.optimizer.step()
        l2 = aux['l2_loss'].detach()
        self.summary.update_async({
            'Loss': aux['cls_loss'].detach() + l2, 'Reg_Loss': l2,
            'Mean_Err': aux['angular_error'].mean(),
            'R_Acc': 100.0 * aux['r_acc']})
        self.last_loss = loss.detach()

    def test(self):
        self.eval()

    @torch.inference_mode()
    def eval(self):
        """Median angular error in degrees over testR (and the anchor
        classifier's accuracy, logged)."""
        self.logger.log('Testing', 'Evaluating test set!')
        self.model.eval()
        dev_acc, all_error = [], []
        for data in self.dataset_test:
            _, aux = self._loss(*self._batch(data))
            # device values; one transfer after the loop
            dev_acc.append(aux['r_acc'])
            all_error.append(aux['angular_error'].reshape(-1))
        if not dev_acc:
            self.logger.log('Testing', 'Test set is empty!')
            return float('nan')
        all_acc = torch.stack(dev_acc).float().cpu().numpy()
        all_error = [e.float().cpu().numpy() for e in all_error]
        for acc, err in zip(all_acc, all_error):
            self.logger.log('Testing', 'Accuracy: %.1f, error: %.2f!' % (
                100 * acc, float(np.mean(err))))
        all_error = np.concatenate(all_error, 0)
        self.logger.log('Testing', 'Average classifier acc is %.2f!!!!'
                        % (100 * all_acc.mean()))
        median_deg = float(np.median(all_error) * 180 / np.pi)
        self.logger.log('Testing', 'Median angular error is %.2f degree!!!!'
                        % median_deg)
        self.test_accs.append(100 * all_acc.mean())
        if self.exp_name is not None:
            save_dir = os.path.join('data', 'alignment_errors')
            os.makedirs(save_dir, exist_ok=True)
            np.savetxt(os.path.join(save_dir, f'{self.exp_name}_error.txt'),
                       all_error)
        return median_deg
