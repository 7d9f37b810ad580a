"""ModelNet40 classification: the train and eval lifecycle (counterpart of
``epn_pointcloud_tpu/app/trainer_modelnet.py`` ``TrainerModelNet``).

A train step is a train-mode forward, the loss (the attention cross
entropy with an 'attention*' pooling flag, else the cross entropy alone), a
backward through the conv kernels' autograd Functions, and an Adam step at
the scheduled learning rate. Its log scalars stay on the device until the
Summary reads them at log time. The model is the one ``opt.model`` names:
kanchor 60, 40 or 20, or one anchor with ``kpconv``. ``--debug-mode
knownatt`` trains an attention model as a plain classifier (the cross
entropy alone, Summary 'Loss' and 'Acc') and hands the model the rotation
label, which its head ignores, as the JAX trainer does; the JAX trainer
reads no other debug mode, and neither does this one.

Under data parallelism (``app.trainer``) a step runs on the rank's slice
of the global batch and all-reduces the gradients before Adam; ``eval``
runs each rank's slice of every test batch and all-reduces each batch's
correct and total counts and loss sums, so rank 0 logs the accuracy over
every batch the ranks saw (a short final batch is dropped there).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import losses, models
from .. import train as train_lib
from ..parallel import is_main, mesh, shard_batch
from .trainer import Trainer, global_batch_means

# iterations of the 'schedule' attention loss's classification ramp (the
# JAX trainer's compute_loss)
PRETRAIN_STEP = 2000


class TrainerModelNet(Trainer):
    def __init__(self, opt, device=None):
        if getattr(opt, 'steps_per_dispatch', 1) > 1:
            raise NotImplementedError('--steps-per-dispatch > 1 is TPU '
                                      'dispatch machinery; the port takes one '
                                      'step a call')
        self.knownatt = opt.debug_mode == 'knownatt'
        self.attention_model = (opt.model.flag.startswith('attention')
                                and not self.knownatt)
        self.test_accs = []
        self.eval_logits = []
        self.epoch_counter = 0
        super().__init__(opt, device)
        self.summary.register(['Loss', 'Acc', 'R_Loss', 'R_Acc']
                              if self.attention_model else ['Loss', 'Acc'])

    # ------------------------------------------------------------- lifecycle

    def _setup_datasets(self):
        from ..data.modelnet40 import DataLoader, Dataloader_ModelNet40
        opt = self.opt
        if opt.mode == 'train':
            self.dataset = DataLoader(Dataloader_ModelNet40(opt, 'train'),
                                      opt.batch_size, shuffle=True,
                                      seed=opt.seed)
            self.dataset_iter = iter(self.dataset)
        self.dataset_test = DataLoader(Dataloader_ModelNet40(opt, 'testR'),
                                       opt.batch_size, shuffle=False,
                                       seed=opt.seed, drop_last=False)

    def _setup_model(self):
        # the block-parameter tree to <run dir>/params.json in train mode,
        # as the JAX trainer writes it
        self.model = models.build_model_from(
            self.opt, seed=self.opt.seed,
            outfile_path=(os.path.join(self.root_dir, 'params.json')
                          if self.opt.mode == 'train' and is_main()
                          else None))
        self.model.to(self.device)

    # ----------------------------------------------------------------- steps

    def _batch(self, data):
        return shard_batch((data['pc'], data['label'].reshape(-1),
                            data['R_label'].reshape(-1)), self.device)

    def _loss(self, pred, feat, label, rlabel, iter_counter=0):
        if not self.attention_model:
            loss, acc = losses.cross_entropy(pred, label)
            return loss, {'cls_loss': loss, 'acc': acc}
        return losses.attention_cross_entropy(
            pred, label, feat, rlabel,
            self.opt.train_loss.attention_loss_type,
            self.opt.train_loss.attention_margin,
            iter_counter=iter_counter, pretrain_step=PRETRAIN_STEP)

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
        pc, label, rlabel = self._batch(data)
        self.model.train()
        pred, feat = self.model(pc, rlabel if self.knownatt else None)
        loss, aux = self._loss(pred, feat, label, rlabel, self.iter_counter)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        mesh.all_reduce_grads(self.model, self.group)
        train_lib.set_lr(self.optimizer, self.lr_schedule(self.iter_counter))
        self.optimizer.step()
        log = {'Loss': aux['cls_loss'].detach(), 'Acc': 100.0 * aux['acc']}
        if self.attention_model:
            log.update(R_Loss=aux['r_loss'].detach(),
                       R_Acc=100.0 * aux['racc'])
        self._log_step(loss, log)

    def test(self):
        self.eval()

    @torch.no_grad()
    def eval(self):
        """Average accuracy over the rotated test split (testR)."""
        self.logger.log('Testing', 'Evaluating test set!')
        self.model.eval()
        accs, cls_losses = [], []
        self.eval_logits = []
        for data in self.dataset_test:
            pc, label, rlabel = self._batch(data)
            pred, feat = self.model(pc, rlabel if self.knownatt else None)
            _, aux = self._loss(pred, feat, label, rlabel)
            # device scalars; one transfer after the loop
            accs.append(aux['acc'])
            cls_losses.append(aux['cls_loss'])
            self.eval_logits.append(pred)
        if not accs:
            self.logger.log('Testing', 'Test set is empty!')
            return float('nan')
        accs, cls_losses = torch.stack(accs), torch.stack(cls_losses)
        if mesh.data_world() > 1:
            accs, cls_losses = global_batch_means(
                accs, cls_losses, pc.shape[0], self.group)
        accs = accs.float().cpu().numpy()
        losses_np = cls_losses.float().cpu().numpy()
        for acc, lv in zip(accs, losses_np):
            self.logger.log('Testing', 'Accuracy: %.1f, Loss: %.2f!' % (
                100 * acc, lv))
        self.logger.log('Testing',
                        'Average accuracy is %.2f!!!!' % (100 * accs.mean()))
        self.test_accs.append(100 * accs.mean())
        self.logger.log('Testing', 'Best accuracy so far is %.2f!!!!' % (
            np.max(self.test_accs)))
        return float(accs.mean())

