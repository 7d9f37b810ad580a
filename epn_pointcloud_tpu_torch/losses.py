"""Classification losses (counterpart of ``epn_pointcloud_tpu/losses.py``
``cross_entropy`` / ``attention_cross_entropy``); torch autograd
differentiates them."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy(pred: torch.Tensor, label: torch.Tensor):
    """pred [b, k] (class dim 1), integer labels -> (loss, accuracy)."""
    logp = F.log_softmax(pred, dim=1)
    loss = -logp.gather(1, label.long().reshape(-1, 1)).mean()
    acc = (pred.argmax(dim=1) == label).float().mean()
    return loss, acc


def attention_cross_entropy(pred, label, wts, rlabel,
                            loss_type: str = 'default',
                            loss_margin: float = 1.0, iter_counter: int = 0,
                            pretrain_step: int = 2000):
    """Classification CE + margin-weighted anchor-attention CE.

    wts [b, 60] anchor logits; rlabel [b] anchor labels. Returns
    (loss, dict(cls_loss, r_loss, acc, racc)).
    """
    cls_loss, acc = cross_entropy(pred, label.reshape(-1))
    r_loss, racc = cross_entropy(wts, rlabel.reshape(-1))
    m = loss_margin
    if loss_type == 'schedule':
        w = min(iter_counter / pretrain_step, 1.0)
        loss = w * cls_loss + (m + 1.0 - w) * r_loss
    elif loss_type == 'default':
        loss = cls_loss + m * r_loss
    elif loss_type == 'no_reg':
        loss = cls_loss
    else:
        raise NotImplementedError(f'{loss_type} is not implemented')
    return loss, {'cls_loss': cls_loss, 'r_loss': r_loss, 'acc': acc,
                  'racc': racc}
