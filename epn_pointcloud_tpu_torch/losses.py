"""Losses (counterpart of ``epn_pointcloud_tpu/losses.py``): the
classification ``cross_entropy`` / ``attention_cross_entropy``, the
rotation regression's ``multi_task_detection_loss`` and the 3DMatch
descriptors' in-batch hard-negative ``triplet_batch_loss``; torch autograd
differentiates them."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .nn.layers import convention_constant
from .ops.rotation import (angle_from_R, mean_angular_error,
                           rotation_from_ortho6d, rotation_from_quaternion,
                           so3_mean)


def cross_entropy(pred: torch.Tensor, label: torch.Tensor):
    """pred [b, k, ...] (class dim 1), integer labels [b, ...] ->
    (loss, accuracy), both means over every label."""
    logp = F.log_softmax(pred, dim=1)
    loss = -logp.gather(1, label.long().unsqueeze(1)).mean()
    acc = (pred.argmax(dim=1) == label).float().mean()
    return loss, acc


def attention_cross_entropy(pred, label, wts, rlabel,
                            loss_type: str = 'default',
                            loss_margin: float = 1.0, iter_counter: int = 0,
                            pretrain_step: int = 2000):
    """Classification CE + margin-weighted anchor-attention CE.

    wts [b, a] anchor logits; rlabel [b] anchor labels over the full
    60-element group, relabelled at a < 60 to the nearest anchor of the
    subset (``icosahedron.anchor_subset_relabel_map``, JAX
    ``losses.py:55-61``). Returns (loss, dict(cls_loss, r_loss, acc,
    racc)).
    """
    cls_loss, acc = cross_entropy(pred, label.reshape(-1))
    rl = rlabel.reshape(-1)
    a = wts.shape[1]
    if a < 60:
        rl = convention_constant('relabel', a, rl.device)[rl.long()]
    r_loss, racc = cross_entropy(wts, rl)
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


def batched_select_anchor(labels: torch.Tensor, y: torch.Tensor,
                          rotation_mapping) -> torch.Tensor:
    """labels [b, na] (a target anchor per source anchor), y [b, na_tgt,
    na_src, nr] -> the selected regressions as rotations [b, na, 3, 3]."""
    b, na = labels.shape
    nr = y.shape[-1]
    idx = labels.long()[:, None, :, None].expand(b, 1, na, nr)
    return rotation_mapping(y.gather(1, idx)[:, 0].reshape(b * na, nr)) \
        .reshape(b, na, 3, 3)


def multi_task_detection_loss(anchors, wts, label, y, gt_R, gt_T=None,
                              nr: int = 4, w: float = 10.0,
                              threshold: float = 1.0):
    """Anchor classification cross entropy + w-weighted L2 rotation
    regression, in three settings:

      * na == 1: direct regression; wts [b, 1], y [b, nr].
      * alignment (gt_T given, label [b, na]): wts [b, na_tgt, na_src],
        y [b, na_tgt, na_src, nr], gt_R [b, na, 3, 3].
      * canonical: label [b], wts [b, na], y [b, na, nr], gt_R [b, na, 3, 3].

    Returns (loss, dict(cls_loss, l2_loss (w-scaled), r_acc, angular_error
    [b], pred_R [b, 3, 3])). The alignment setting's pred_R, the
    confidence-weighted chordal mean, feeds only the angular error and is
    computed without a graph (no SVD backward)."""
    assert nr in (4, 6)
    b, na = wts.shape[0], wts.shape[1]
    rotation_mapping = (rotation_from_quaternion if nr == 4
                        else rotation_from_ortho6d)
    if gt_T is not None:
        true_R = gt_T
    else:
        # the identity anchor: the largest trace
        id_idx = torch.argmax(anchors.diagonal(dim1=-2, dim2=-1).sum(-1))
        true_R = gt_R[:, min(int(id_idx), gt_R.shape[1] - 1)]

    if na == 1:
        cls_loss = wts.new_zeros(())
        r_acc = wts.new_ones(())
        pred_R = rotation_mapping(y.reshape(b, nr))
        l2_loss = ((pred_R - true_R) ** 2).mean()
        loss = w * l2_loss
    elif gt_T is not None and label.dim() == 2:
        wts = wts.reshape(b, na, na)
        cls_loss, r_acc = cross_entropy(wts, label)
        select_RAnchor = batched_select_anchor(label, y, rotation_mapping)
        l2_loss = ((gt_R - select_RAnchor) ** 2).mean()
        loss = cls_loss + w * l2_loss
        with torch.no_grad():
            confidence, preds = wts.max(dim=1)               # [b, na_src]
            pred_RAnchor = batched_select_anchor(preds, y, rotation_mapping)
            confidence = confidence / (
                1e-6 + confidence.sum(dim=1, keepdim=True))
            pred_Rs = torch.einsum('aij,bajk,balk->bail', anchors,
                                   pred_RAnchor, anchors[preds])
            pred_R = so3_mean(pred_Rs, confidence)
    else:
        wts = wts.reshape(b, -1)
        cls_loss, r_acc = cross_entropy(wts, label.reshape(-1))
        pred_RAnchor = rotation_mapping(y.reshape(-1, nr)).reshape(
            b, -1, 3, 3)
        mask = (angle_from_R(gt_R) < threshold).to(y.dtype)[:, :, None, None]
        l2_loss = ((gt_R * mask - pred_RAnchor * mask) ** 2).sum()
        loss = cls_loss + w * l2_loss
        preds = wts.argmax(dim=1)
        pred_R = anchors[preds] @ pred_RAnchor[torch.arange(b), preds]
    return loss, {'cls_loss': cls_loss, 'l2_loss': w * l2_loss,
                  'r_acc': r_acc,
                  'angular_error': mean_angular_error(pred_R, true_R),
                  'pred_R': pred_R}


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
