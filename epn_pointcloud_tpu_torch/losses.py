"""Losses (counterpart of ``epn_pointcloud_tpu/losses.py``): the
classification ``cross_entropy`` / ``attention_cross_entropy`` and the
3DMatch descriptors' in-batch hard-negative ``triplet_batch_loss``; torch
autograd differentiates them."""

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


def pairwise_distance_matrix(x: torch.Tensor, y: torch.Tensor,
                             eps: float = 1e-6) -> torch.Tensor:
    """[n, c] x [m, c] -> L2 distances [n, m], sqrt(max(d^2, eps))."""
    x2 = (x * x).sum(dim=1, keepdim=True)
    y2 = (y * y).sum(dim=1, keepdim=True)
    dist2 = x2 + y2.t() - 2.0 * x @ y.t()
    return torch.sqrt(torch.clamp(dist2, min=eps))


def batch_hard_negative_mining(dist_mat: torch.Tensor) -> torch.Tensor:
    """Each row's minimum over its off-diagonal entries."""
    n = dist_mat.shape[0]
    eye = torch.eye(n, dtype=dist_mat.dtype, device=dist_mat.device)
    return (dist_mat + eye * 1e10).min(dim=1).values


def _triplet_diff(furthest_positive, closest_negative, loss_mode, margin):
    diff = furthest_positive - closest_negative
    if loss_mode == 'hard':
        return torch.relu(diff + margin)
    if loss_mode == 'soft':
        return F.softplus(diff, beta=margin)
    if loss_mode == 'contrastive':
        return furthest_positive + torch.relu(margin - closest_negative)
    return diff


def triplet_batch_loss(src: torch.Tensor, tgt: torch.Tensor,
                       loss_mode: str = 'soft', margin: float = 1.0):
    """In-batch hard-negative triplet loss on L2 distances: src, tgt [b, c]
    descriptors, the positives on the diagonal; loss_mode 'hard', 'soft',
    'contrastive' or any other name for the plain difference. Returns
    (loss, dict(accuracy, fpos, cneg, all_dist))."""
    all_dist = pairwise_distance_matrix(src, tgt)
    furthest_positive = torch.diagonal(all_dist)
    closest_negative = batch_hard_negative_mining(all_dist)
    diff = _triplet_diff(furthest_positive, closest_negative, loss_mode,
                         margin)
    match = all_dist.argmin(dim=1) == torch.arange(all_dist.shape[0],
                                                   device=all_dist.device)
    return diff.mean(), {'accuracy': match.float().mean(),
                         'fpos': furthest_positive.mean(),
                         'cneg': closest_negative.mean(),
                         'all_dist': all_dist}
