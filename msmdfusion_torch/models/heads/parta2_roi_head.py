"""Part-A2 RoI head: part-aware pooling and refinement in each RoI's
canonical frame.

Counterpart of the JAX package's ``models/heads/parta2_roi_head.py``
(reference mmdet3d/models/roi_heads/part_aggregation_roi_head.py:12-316
and bbox_heads/parta2_bbox_head.py:17-622):

- the part features (intra-object part coordinates and the segmentation
  score) are mean-pooled and the U-Net's features max-pooled onto each
  RoI's grid (``ops/sampling.roiaware_pool3d``);
- each branch runs its own dense 3-D conv stack (on cuDNN), the two are
  concatenated, merged, max-pooled 2x and down-convolved; the JAX head
  makes the reference's sparse convs on the pooled grids dense convs,
  and so does the port;
- shared fully connected layers (dropout after the last in training,
  drawn from the step's generator) feed a class-agnostic score and box
  residuals in the RoI's canonical frame (centre at the RoI's, rotated by
  -(ry + pi/2), the yaw folded into (-pi/2, pi/2));
- the loss is a soft-IoU binary cross entropy, smooth L1 on the canonical
  residuals and the flip-invariant corner loss.

Module names are the JAX package's (``part_conv_{i}``, ``seg_conv_bn_{i}``,
``shared_fc_{i}``, ``cls_out`` ...): the reference's sparse-conv head has
no counterpart of them. The norms take training moments over every RoI's
grid, the invalid RoIs' included, as the JAX ``MaskedBatchNorm`` without
a mask does.
"""
from __future__ import annotations

import math
from typing import Any, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...core.boxes import corners_3d
from ...core.coders import DeltaXYZWLHRBBoxCoder
from ...core.iou3d import boxes_iou_3d
from ...ops.sampling import roiaware_pool3d
from ...registry import HEADS
from ...utils.timing import section
from ..layers import BatchNorm3d, Linear
from ..losses import binary_cross_entropy, smooth_l1_loss
from .transfusion_head import dropout

TWO_PI = 2 * math.pi


def canonical_transform(boxes, roi):
    """World-frame boxes -> the RoI's canonical frame (reference
    :416-436)."""
    roi_ry = torch.remainder(roi[..., 6], TWO_PI)
    ct = boxes[..., 0:3] - roi[..., 0:3]
    ang = -(roi_ry + math.pi / 2)
    c, s = torch.cos(ang), torch.sin(ang)
    x = ct[..., 0] * c - ct[..., 1] * s
    y = ct[..., 0] * s + ct[..., 1] * c
    ry = torch.remainder(boxes[..., 6] - roi_ry, TWO_PI)
    opposite = (ry > math.pi * 0.5) & (ry < math.pi * 1.5)
    ry = torch.where(opposite, torch.remainder(ry + math.pi, TWO_PI), ry)
    ry = torch.where(ry > math.pi, ry - TWO_PI, ry)
    ry = torch.clamp(ry, -math.pi / 2, math.pi / 2)
    return torch.cat([x[..., None], y[..., None], ct[..., 2:3],
                      boxes[..., 3:6], ry[..., None], boxes[..., 7:]], -1)


def decanonicalize(boxes_ct, roi):
    """Inverse of ``canonical_transform`` for decoded predictions
    (:337-355)."""
    roi_ry = torch.remainder(roi[..., 6], TWO_PI)
    ang = roi_ry + math.pi / 2
    c, s = torch.cos(ang), torch.sin(ang)
    x = boxes_ct[..., 0] * c - boxes_ct[..., 1] * s
    y = boxes_ct[..., 0] * s + boxes_ct[..., 1] * c
    return torch.cat([(x + roi[..., 0])[..., None],
                      (y + roi[..., 1])[..., None],
                      (boxes_ct[..., 2] + roi[..., 2])[..., None],
                      boxes_ct[..., 3:6],
                      (boxes_ct[..., 6] + roi_ry)[..., None],
                      boxes_ct[..., 7:]], -1)


def corner_loss_lidar(pred, gt, delta: float = 1.0):
    """Flip-invariant Huber corner loss (reference :482-530): [N]."""
    pred_c = corners_3d(pred)
    gt_c = corners_3d(gt)
    gt_flip = torch.cat([gt[..., :6], gt[..., 6:7] + math.pi, gt[..., 7:]],
                        -1)
    gt_cf = corners_3d(gt_flip)
    d = torch.minimum(torch.linalg.norm(pred_c - gt_c, dim=-1),
                      torch.linalg.norm(pred_c - gt_cf, dim=-1))   # [N, 8]
    abs_e = d.abs()
    huber = torch.where(abs_e < delta, 0.5 * abs_e ** 2 / delta,
                        abs_e - 0.5 * delta)
    return huber.mean(-1)


def roi_anchors(rois):
    """The RoIs as the coder's anchors in their own canonical frame: the
    sizes kept, centre and yaw zero."""
    zeros = torch.zeros_like(rois[..., :3])
    return torch.cat([zeros, rois[..., 3:6], zeros[..., :1]], -1)


@HEADS.register('PartAggregationROIHead')
class PartAggregationROIHead(nn.Module):

    def __init__(self, num_classes: int = 3,
                 roi_grid: Tuple[int, int, int] = (14, 14, 14),
                 in_channels: int = 16, part_in_channels: int = 4,
                 seg_conv_channels: Sequence[int] = (64, 64),
                 part_conv_channels: Sequence[int] = (64, 64),
                 merge_conv_channels: Sequence[int] = (128, 128),
                 down_conv_channels: Sequence[int] = (128, 256),
                 shared_fc_channels: Sequence[int] = (256, 512),
                 cls_channels: Sequence[int] = (256, 256),
                 reg_channels: Sequence[int] = (256, 256),
                 dropout_ratio: float = 0.1, with_corner_loss: bool = True,
                 train_cfg: Any = None, test_cfg: Any = None):
        super().__init__()
        self.num_classes = num_classes
        self.roi_grid = tuple(roi_grid)
        self.part_in_channels = part_in_channels
        self.dropout_ratio = dropout_ratio
        self.with_corner_loss = with_corner_loss
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg
        self.stacks = {}

        def stack(prefix, cin, channels):
            for i, c in enumerate(channels):
                self.add_module(f'{prefix}_{i}', nn.Conv3d(
                    cin, c, 3, padding=1, bias=False))
                self.add_module(f'{prefix}_bn_{i}', BatchNorm3d(c))
                cin = c
            self.stacks[prefix] = len(channels)
            return cin

        cp = stack('part_conv', part_in_channels, part_conv_channels)
        cs = stack('seg_conv', in_channels, seg_conv_channels)
        c = stack('merge_conv', cp + cs, merge_conv_channels)
        c = stack('down_conv', c, down_conv_channels)
        cells = math.prod(g // 2 for g in self.roi_grid)
        c *= cells

        def fcs(prefix, cin, channels):
            for i, width in enumerate(channels):
                self.add_module(f'{prefix}_{i}', Linear(cin, width))
                cin = width
            return cin

        c = fcs('shared_fc', c, shared_fc_channels)
        self.cls_out = Linear(fcs('cls_fc', c, cls_channels), 1)
        self.reg_out = Linear(fcs('reg_fc', c, reg_channels), 7)
        self.num_fc = {'shared_fc': len(shared_fc_channels),
                       'cls_fc': len(cls_channels),
                       'reg_fc': len(reg_channels)}

    def conv_stack(self, x, prefix):
        for i in range(self.stacks[prefix]):
            x = getattr(self, f'{prefix}_{i}')(x)
            x = torch.relu(getattr(self, f'{prefix}_bn_{i}')(x))
        return x

    def fc_stack(self, x, prefix, generator=None, last_dropout=False):
        n = self.num_fc[prefix]
        for i in range(n):
            x = torch.relu(getattr(self, f'{prefix}_{i}')(x))
            if last_dropout and i == n - 1:
                x = dropout(x, self.dropout_ratio, self.training, generator)
        return x

    def forward(self, seg_points, seg_feats, seg_valid, rois, roi_valid,
                part_feats=None, generator=None):
        """seg_points [P, 3] voxel centres, seg_feats [P, C] the U-Net's
        features, seg_valid [P], rois [R, 7], roi_valid [R], part_feats
        [P, Cp] (zeros without a semantic branch) -> dict cls_score [R, 1],
        bbox_pred [R, 7], rois, roi_valid."""
        with section('roi_pool'):
            seg_feats = torch.where(seg_valid[:, None], seg_feats, 0.0)
            if part_feats is None:
                part_feats = seg_feats.new_zeros(
                    seg_feats.shape[0], self.part_in_channels)
            part_feats = torch.where(seg_valid[:, None], part_feats, 0.0)
            pooled_part = roiaware_pool3d(seg_points, part_feats, rois,
                                          self.roi_grid, mode='avg')
            pooled_seg = roiaware_pool3d(seg_points, seg_feats, rois,
                                         self.roi_grid, mode='max')
        with section('roi_head'):
            xp = self.conv_stack(pooled_part.permute(0, 4, 1, 2, 3),
                                 'part_conv')
            xs = self.conv_stack(pooled_seg.permute(0, 4, 1, 2, 3),
                                 'seg_conv')
            x = self.conv_stack(torch.cat([xp, xs], 1), 'merge_conv')
            x = F.max_pool3d(x, 2, 2)
            x = self.conv_stack(x, 'down_conv')
            # flattened channels-last, the JAX head's Dense input order
            x = x.permute(0, 2, 3, 4, 1).reshape(x.shape[0], -1)
            x = self.fc_stack(x, 'shared_fc', generator, last_dropout=True)
            cls_score = self.cls_out(self.fc_stack(x, 'cls_fc'))
            bbox_pred = self.reg_out(self.fc_stack(x, 'reg_fc'))
        return {'cls_score': cls_score, 'bbox_pred': bbox_pred,
                'rois': rois, 'roi_valid': roi_valid}

    def loss(self, preds, gt_bboxes, gt_labels, gt_valid):
        """Soft-IoU confidence + canonical-frame regression + corner loss
        of one sample (reference parta2_bbox_head.py:283-355,
        :388-480)."""
        tc = dict(self.train_cfg or {})
        cls_pos = tc.get('cls_pos_thr', 0.75)
        cls_neg = tc.get('cls_neg_thr', 0.25)
        reg_pos = tc.get('pos_iou_thr', 0.55)
        rois, roi_valid = preds['rois'], preds['roi_valid']
        iou = boxes_iou_3d(rois, gt_bboxes[..., :7])
        iou = torch.where(gt_valid[None, :], iou, 0.0)
        max_iou, best_gt = iou.amax(1), iou.argmax(1)    # the first best
        label = torch.where(max_iou > cls_pos, 1.0,
                            torch.where(max_iou < cls_neg, 0.0,
                                        max_iou * 2 - 0.5))
        cls_loss = binary_cross_entropy(preds['cls_score'][:, 0],
                                        torch.clamp(label, 0, 1))
        cls_loss = torch.where(roi_valid, cls_loss, 0.0).sum() / \
            torch.clamp(roi_valid.sum(), min=1)

        gt_for = gt_bboxes[..., :7][best_gt]
        anchor = roi_anchors(rois)
        coder = DeltaXYZWLHRBBoxCoder()
        tgt = coder.encode(anchor, canonical_transform(gt_for, rois))
        pos = (max_iou > reg_pos) & roi_valid
        num_pos = torch.clamp(pos.sum(), min=1)
        reg = smooth_l1_loss(preds['bbox_pred'], tgt, beta=1.0 / 9.0).sum(-1)
        losses = {'loss_roi_cls': cls_loss,
                  'loss_roi_bbox': torch.where(pos, reg, 0.0).sum()
                  / num_pos * 2.0}
        if self.with_corner_loss:
            pred_world = decanonicalize(
                coder.decode(anchor, preds['bbox_pred']), rois)
            corner = corner_loss_lidar(pred_world, gt_for)
            losses['loss_roi_corner'] = \
                torch.where(pos, corner, 0.0).sum() / num_pos
        return losses

    def get_bboxes(self, preds):
        """One sample's canonical residuals decoded back to the world frame
        (:337-355) -> dict bboxes [R, 7], scores [R], valid [R] (no labels:
        the JAX head's contract)."""
        rois = preds['rois']
        boxes = decanonicalize(DeltaXYZWLHRBBoxCoder().decode(
            roi_anchors(rois), preds['bbox_pred']), rois)
        return {'bboxes': boxes,
                'scores': torch.sigmoid(preds['cls_score'][:, 0]),
                'valid': preds['roi_valid']}
