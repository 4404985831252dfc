"""Detection losses, elementwise.

Counterpart of the JAX package's ``models/losses.py`` (mmdet's FocalLoss,
GaussianFocalLoss, L1Loss, SmoothL1Loss and CrossEntropyLoss, mmdet3d's
``clip_sigmoid``). The callers
reduce and average, as the reference's ``avg_factor``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def clip_sigmoid(x, eps: float = 1e-4):
    return torch.clamp(torch.sigmoid(x), eps, 1 - eps)


def sigmoid_focal_loss(logits, labels, num_classes: int, gamma: float = 2.0,
                       alpha: float = 0.25):
    """logits [N, C], labels [N] in [0, C] (C = background) -> [N] focal
    loss summed over the classes."""
    prob = torch.sigmoid(logits)
    one_hot = F.one_hot(labels.to(torch.int64), num_classes + 1)[:, :num_classes]
    pos = one_hot > 0
    pt = torch.where(pos, 1 - prob, prob)
    focal_weight = torch.where(pos, alpha, 1 - alpha) * pt ** gamma
    ce = torch.clamp(logits, min=0) - logits * one_hot + \
        torch.log1p(torch.exp(-logits.abs()))
    return (ce * focal_weight).sum(-1)


def gaussian_focal_loss(pred, gaussian_target, alpha: float = 2.0,
                        gamma: float = 4.0):
    """CornerNet focal loss on a gaussian heatmap; ``pred`` is a clipped
    sigmoid."""
    eps = 1e-12
    pos_weights = (gaussian_target == 1).to(pred.dtype)
    neg_weights = (1 - gaussian_target) ** gamma
    pos_loss = -torch.log(pred + eps) * (1 - pred) ** alpha * pos_weights
    neg_loss = -torch.log(1 - pred + eps) * pred ** alpha * neg_weights * \
        (1 - pos_weights)
    return pos_loss + neg_loss


def l1_loss(pred, target):
    return (pred - target).abs()


def smooth_l1_loss(pred, target, beta: float = 1.0):
    diff = (pred - target).abs()
    return torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)


def binary_cross_entropy(logits, labels):
    """Sigmoid cross entropy of ``logits`` against 0/1 ``labels``."""
    return torch.clamp(logits, min=0) - logits * labels + \
        torch.log1p(torch.exp(-logits.abs()))


def cross_entropy(logits, labels, num_classes: int):
    """logits [N, C], int labels [N] -> [N] softmax cross entropy."""
    logp = F.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels.to(torch.int64)[:, None])[:, 0]
