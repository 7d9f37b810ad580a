"""ModelNet40 classification: the eval lifecycle (counterpart of
``epn_pointcloud_tpu/app/trainer_modelnet.py`` ``TrainerModelNet.eval``)."""

from __future__ import annotations

import numpy as np
import torch

from .. import losses, models
from .trainer import Trainer


class TrainerModelNet(Trainer):
    def __init__(self, opt, device=None):
        if opt.debug_mode is not None:
            raise NotImplementedError(f'debug mode {opt.debug_mode!r} is not '
                                      f'ported')
        self.test_accs = []
        self.eval_logits = []
        super().__init__(opt, device)

    def _setup_datasets(self):
        from ..data.modelnet40 import DataLoader, Dataloader_ModelNet40
        self.dataset_test = DataLoader(Dataloader_ModelNet40(self.opt, 'testR'),
                                       self.opt.batch_size)

    def _setup_model(self):
        self.model = models.build_model_from(self.opt, seed=self.opt.seed)
        self.model.to(self.device).eval()

    @torch.no_grad()
    def eval(self):
        """Average accuracy over the rotated test split (testR)."""
        self.logger.log('Testing', 'Evaluating test set!')
        self.model.eval()
        accs, cls_losses = [], []
        self.eval_logits = []
        for data in self.dataset_test:
            pc = torch.from_numpy(data['pc']).to(self.device)
            label = torch.from_numpy(data['label'].reshape(-1)).to(self.device)
            rlabel = torch.from_numpy(
                data['R_label'].reshape(-1)).to(self.device)
            pred, feat = self.model(pc)
            _, aux = losses.attention_cross_entropy(
                pred, label, feat, rlabel,
                self.opt.train_loss.attention_loss_type,
                self.opt.train_loss.attention_margin)
            # device scalars; one transfer after the loop
            accs.append(aux['acc'])
            cls_losses.append(aux['cls_loss'])
            self.eval_logits.append(pred)
        if not accs:
            self.logger.log('Testing', 'Test set is empty!')
            return float('nan')
        accs = torch.stack(accs).float().cpu().numpy()
        losses_np = torch.stack(cls_losses).float().cpu().numpy()
        for acc, lv in zip(accs, losses_np):
            self.logger.log('Testing', 'Accuracy: %.1f, Loss: %.2f!' % (
                100 * acc, lv))
        self.logger.log('Testing',
                        'Average accuracy is %.2f!!!!' % (100 * accs.mean()))
        self.test_accs.append(100 * accs.mean())
        self.logger.log('Testing', 'Best accuracy so far is %.2f!!!!' % (
            np.max(self.test_accs)))
        return float(accs.mean())
