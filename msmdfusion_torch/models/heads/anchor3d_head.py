"""Anchor-based 3D head of SECOND and PointPillars.

Counterpart of the JAX package's ``models/heads/anchor3d_head.py``
(reference mmdet3d/models/dense_heads/anchor3d_head.py and
train_mixins.py): 1x1 conv branches for the class scores, the box
residuals and the direction over dense anchors ([H, W, A] with the
rotation fastest), the max-IoU assignment over the whole anchor grid,
focal + smooth-L1 + direction losses, and a multi-class rotated-NMS
decode. Channels-first; module names are the reference's (``conv_cls``,
``conv_reg``, ``conv_dir_cls``).

The assignment's BEV IoU of every anchor with every ground-truth box runs
over chunks of anchors (``ASSIGN_PAIRS`` pairs at a time; each pair's IoU
is its own computation, so the chunks change no number): PointPillars'
200 x 200 x 14 anchors against the boxes at once would hold tens of GB.
Each ground-truth box is forced onto its best anchor; where two boxes
share one, the later box (the higher index) takes it, the write that the
JAX package's scatter keeps on the CPU, chosen here by a maximum over the
indices (no scatter with repeated indices).
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
from torch import nn

from ...core.boxes import limit_period
from ...core.coders import topk_lower_index
from ...core.iou3d import boxes_iou_bev
from ...core.nms import box3d_multiclass_nms
from ...registry import ANCHOR_GENERATORS, BBOX_CODERS, HEADS
from ..layers import Conv2d
from ..losses import cross_entropy, sigmoid_focal_loss, smooth_l1_loss

ASSIGN_PAIRS = 2 ** 21      # anchor-box pairs a chunk of the assignment


def bev_of(boxes):
    """[..., 7+] -> [..., 5] (x, y, w, l, yaw)."""
    return torch.cat([boxes[..., 0:2], boxes[..., 3:5], boxes[..., 6:7]], -1)


def assign(anc_bev, gt_bev, valid, pos_thr, neg_thr, min_pos_iou):
    """Max-IoU assignment of anchors [M, 5] to boxes [G, 5] (``valid``
    [G]) -> (assigned box [M], positive [M], negative [M]), the JAX
    ``assign_one``'s."""
    m, g = anc_bev.shape[0], gt_bev.shape[0]
    dev = anc_bev.device
    chunk = max(1, ASSIGN_PAIRS // max(g, 1))
    max_iou, argmax = [], []
    best = torch.full((g,), float('-inf'), device=dev)
    best_anchor = torch.zeros(g, dtype=torch.int64, device=dev)
    for start in range(0, m, chunk):
        iou = boxes_iou_bev(anc_bev[start:start + chunk], gt_bev)
        iou = torch.where(valid[None, :], iou, -1.0)
        v, i = iou.max(1)                       # the first maximum
        max_iou.append(v)
        argmax.append(i)
        cv, ci = iou.max(0)
        better = cv > best                      # earlier chunks keep ties
        best = torch.where(better, cv, best)
        best_anchor = torch.where(better, ci + start, best_anchor)
    max_iou, argmax = torch.cat(max_iou), torch.cat(argmax)
    pos = max_iou >= pos_thr
    neg = (max_iou < neg_thr) & (max_iou >= 0)
    # each box onto its best anchor; on a shared anchor the later box wins
    last = torch.full((m,), -1, dtype=torch.int64, device=dev)
    last.scatter_reduce_(0, best_anchor, torch.arange(g, device=dev), 'amax')
    forced_ok = valid & (best > min_pos_iou)
    force = (last >= 0) & forced_ok[last.clamp(min=0)]
    assigned = torch.where(force, last, argmax)
    pos = pos | force
    return assigned, pos, neg & ~pos


class AnchorHeadMixin:
    """The assignment, losses and decode over a flat anchor set, shared by
    ``Anchor3DHead`` and ``ShapeAwareHead`` (reference
    AnchorTrainMixin). Reads ``num_classes``, ``coder``, ``loss_cls``,
    ``loss_bbox``, ``loss_dir``, ``diff_rad_by_sin``, ``dir_offset``,
    ``dir_limit_offset``, ``train_cfg`` and ``test_cfg``."""

    def _sin_diff(self, pred, tgt):
        """The yaw column of both made sin(a - b)'s two terms."""
        ra, rt = pred[..., 6:7], tgt[..., 6:7]
        return (torch.cat([pred[..., :6], torch.sin(ra) * torch.cos(rt),
                           pred[..., 7:]], -1),
                torch.cat([tgt[..., :6], torch.cos(ra) * torch.sin(rt),
                           tgt[..., 7:]], -1))

    def dir_target(self, rot_gt):
        return (limit_period(rot_gt - self.dir_offset, 0, 2 * math.pi)
                >= math.pi).to(torch.int64)

    def anchor_losses(self, anchors, cls, reg, dir_cls, gt_bboxes,
                      gt_labels, gt_valid):
        """Max-IoU assignment + focal, smooth-L1 and direction losses over
        flat anchors [M, 7+], cls [B, M, K], reg [B, M, code], dir_cls
        [B, M, 2] or None."""
        tc = self.train_cfg
        b, m, _ = cls.shape
        d = anchors.shape[-1]
        anc_bev = bev_of(anchors)
        assigned, pos, neg = (torch.stack(x) for x in zip(*[
            assign(anc_bev, bev_of(gt_bboxes[i]), gt_valid[i],
                   tc['pos_iou_thr'], tc['neg_iou_thr'],
                   tc.get('min_pos_iou', 0.0)) for i in range(b)]))
        gt_for = torch.gather(gt_bboxes, 1, assigned[..., None].expand(
            -1, -1, gt_bboxes.shape[-1]))
        labels = torch.gather(gt_labels.to(torch.int64), 1, assigned)
        labels = torch.where(pos, labels, self.num_classes)
        weights = (pos | neg).to(cls.dtype)
        num_pos = torch.clamp(pos.sum(), min=1)

        loss_cls = sigmoid_focal_loss(
            cls.reshape(-1, self.num_classes), labels.reshape(-1),
            self.num_classes, gamma=self.loss_cls.get('gamma', 2.0),
            alpha=self.loss_cls.get('alpha', 0.25))
        loss_cls = (loss_cls * weights.reshape(-1)).sum() / num_pos

        anc_b = anchors[None].expand(b, m, d)
        tgt = self.coder.encode(anc_b, gt_for[..., :d])
        pred_box = reg
        if self.diff_rad_by_sin:
            pred_box, tgt = self._sin_diff(pred_box, tgt)
        l1 = smooth_l1_loss(pred_box, tgt,
                            beta=self.loss_bbox.get('beta', 1.0 / 9.0))
        l1 = torch.where(pos[..., None], l1, 0.0)
        losses = {
            'loss_cls': loss_cls * self.loss_cls.get('loss_weight', 1.0),
            'loss_bbox': l1.sum() / num_pos *
            self.loss_bbox.get('loss_weight', 1.0)}
        if dir_cls is not None:
            dir_tgt = self.dir_target(gt_for[..., 6] - anc_b[..., 6])
            dce = cross_entropy(dir_cls.reshape(-1, 2), dir_tgt.reshape(-1), 2)
            dce = torch.where(pos.reshape(-1), dce, 0.0)
            losses['loss_dir'] = dce.sum() / num_pos * \
                self.loss_dir.get('loss_weight', 1.0)
        return losses

    def anchor_decode(self, anchors, cls, reg, dir_cls):
        """Per sample: the ``nms_pre`` anchors of highest class score
        (ties by the lower index), decoded, the direction applied, then
        multi-class rotated NMS -> dict 'boxes' [B, max_num, 7+],
        'scores', 'labels', 'valid' [B, max_num]."""
        tcfg = self.test_cfg
        m = anchors.shape[0]
        scores = torch.sigmoid(cls)
        outs = []
        for i in range(scores.shape[0]):
            k = min(tcfg.get('nms_pre', 1000), m)
            _, idx = topk_lower_index(scores[i].amax(-1), k)
            boxes = self.coder.decode(anchors[idx], reg[i][idx])
            if dir_cls is not None:
                dir_label = dir_cls[i][idx].argmax(-1)
                yaw = limit_period(boxes[..., 6] - self.dir_offset,
                                   self.dir_limit_offset, math.pi)
                boxes = torch.cat([boxes[..., :6], (
                    yaw + self.dir_offset + math.pi * dir_label)[..., None],
                    boxes[..., 7:]], -1)
            outs.append(box3d_multiclass_nms(
                boxes, bev_of(boxes), scores[i][idx], tcfg['score_thr'],
                tcfg['nms_thr'], tcfg['max_num']))
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


@HEADS.register('Anchor3DHead')
class Anchor3DHead(AnchorHeadMixin, nn.Module):

    def __init__(self, num_classes: int = 3, in_channels: int = 384,
                 feat_channels: int = 384,
                 use_direction_classifier: bool = True,
                 anchor_generator: Any = None,
                 assigner_per_size: bool = False,
                 assign_per_class: bool = False,
                 diff_rad_by_sin: bool = True, dir_offset: float = 0.0,
                 dir_limit_offset: float = 1.0, bbox_coder: Any = None,
                 loss_cls: Any = None, loss_bbox: Any = None,
                 loss_dir: Any = None, train_cfg: Any = None,
                 test_cfg: Any = None):
        super().__init__()
        self.num_classes = num_classes
        self.use_direction_classifier = use_direction_classifier
        self.diff_rad_by_sin = diff_rad_by_sin
        self.dir_offset = dir_offset
        self.dir_limit_offset = dir_limit_offset
        self.loss_cls = dict(loss_cls or {})
        self.loss_bbox = dict(loss_bbox or {})
        self.loss_dir = dict(loss_dir or {})
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg
        self.coder = BBOX_CODERS.build(dict(
            bbox_coder or {'type': 'DeltaXYZWLHRBBoxCoder'}))
        self.anchor_gen = ANCHOR_GENERATORS.build(dict(anchor_generator))
        self.num_anchors = self.anchor_gen.num_base_anchors
        a = self.num_anchors
        self.conv_cls = Conv2d(in_channels, a * num_classes, 1)
        self.conv_reg = Conv2d(in_channels, a * self.coder.code_size, 1)
        nn.init.constant_(self.conv_cls.bias, -4.59512)
        if use_direction_classifier:
            self.conv_dir_cls = Conv2d(in_channels, a * 2, 1)
        self._anchors: Dict[Any, torch.Tensor] = {}

    def forward(self, x, generator=None):
        """x [B, C, H, W] -> dict cls_score [B, A*K, H, W], bbox_pred [B,
        A*code, H, W] and dir_cls [B, A*2, H, W]."""
        out = {'cls_score': self.conv_cls(x), 'bbox_pred': self.conv_reg(x)}
        if self.use_direction_classifier:
            out['dir_cls'] = self.conv_dir_cls(x)
        return out

    def flat_anchors(self, feature_size, device):
        """[H*W*A, 7+] anchors of the feature map (made once a size)."""
        key = (tuple(feature_size), str(device))
        if key not in self._anchors:
            a = self.anchor_gen.grid_anchors(feature_size)
            self._anchors[key] = torch.from_numpy(
                a.reshape(-1, a.shape[-1])).to(device)
        return self._anchors[key]

    def _flat_preds(self, preds):
        """(anchors [M, 7+], cls [B, M, K], reg [B, M, code], dir [B, M, 2]
        or None), M = H*W*A in the anchors' order."""
        cls = preds['cls_score']
        b, _, h, w = cls.shape
        anchors = self.flat_anchors((h, w), cls.device)
        m = anchors.shape[0]

        def flat(x, c):
            return x.permute(0, 2, 3, 1).reshape(b, m, c)
        dir_cls = preds.get('dir_cls')
        return (anchors, flat(cls, self.num_classes),
                flat(preds['bbox_pred'], self.coder.code_size),
                None if dir_cls is None else flat(dir_cls, 2))

    def loss(self, preds, gt_bboxes, gt_labels, gt_valid):
        return self.anchor_losses(*self._flat_preds(preds), gt_bboxes,
                                  gt_labels, gt_valid)

    def get_bboxes(self, preds):
        return self.anchor_decode(*self._flat_preds(preds))
