"""FreeAnchor 3D head: Anchor3DHead's branches and decode with the
learning-to-match bag losses in place of the IoU assignment.

Counterpart of the JAX package's ``models/heads/free_anchor3d_head.py``
(reference mmdet3d/models/dense_heads/free_anchor3d_head.py): per sample,
each ground-truth box's bag is its ``pre_anchor_topk`` anchors of highest
nearest-BEV IoU (ties by the lower index), scored by the class probability
times the localisation likelihood; anchors away from every box feed the
negative bag loss. The padded boxes are masked by ``gt_valid``. The
per-class image box probability is a maximum over the boxes of that class
(a scatter by maximum: exact in any order).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ...core.boxes import limit_period
from ...core.coders import topk_lower_index
from ...registry import HEADS
from ..losses import smooth_l1_loss
from .anchor3d_head import Anchor3DHead


def nearest_bev(boxes):
    """[..., 7+] -> the nearest axis-aligned BEV box [..., 4] (x1, y1, x2,
    y2): w and l swapped where |yaw| (in [-pi/2, pi/2)) exceeds pi/4."""
    rots = limit_period(boxes[..., 6], 0.5, math.pi).abs()
    cond = (rots > math.pi / 4)[..., None]
    dims = torch.where(cond, boxes[..., [4, 3]], boxes[..., [3, 4]])
    ctr = boxes[..., :2]
    return torch.cat([ctr - dims / 2, ctr + dims / 2], -1)


def iou_nearest(a, b):
    """[N, 4] x [M, 4] axis-aligned IoU [N, M]."""
    iw = torch.clamp(torch.minimum(a[:, None, 2], b[None, :, 2])
                     - torch.maximum(a[:, None, 0], b[None, :, 0]), min=0)
    ih = torch.clamp(torch.minimum(a[:, None, 3], b[None, :, 3])
                     - torch.maximum(a[:, None, 1], b[None, :, 1]), min=0)
    inter = iw * ih
    area_a = ((a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1]))[:, None]
    area_b = ((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]))[None, :]
    return inter / torch.clamp(area_a + area_b - inter, min=1e-9)


@HEADS.register('FreeAnchor3DHead')
class FreeAnchor3DHead(Anchor3DHead):

    def __init__(self, pre_anchor_topk: int = 50, bbox_thr: float = 0.6,
                 gamma: float = 2.0, alpha: float = 0.5, **kwargs):
        super().__init__(**kwargs)
        self.pre_anchor_topk = pre_anchor_topk
        self.bbox_thr = bbox_thr
        self.gamma = gamma
        self.alpha = alpha

    def _bags(self, anchors, anc_near, cls_p, reg_p, dir_p, gts, labels,
              valid, code_weight):
        """One sample's (positive bag loss sum, negative bag loss sum)."""
        with torch.no_grad():
            pred_boxes = self.coder.decode(anchors, reg_p)
            gt_near = nearest_bev(gts)
            iou = iou_nearest(gt_near, nearest_bev(pred_boxes))  # [G, M]
            iou = torch.where(valid[:, None], iou, 0.0)
            t1 = self.bbox_thr
            t2 = torch.clamp(iou.amax(1, keepdim=True), min=t1 + 1e-12)
            obj_box_prob = torch.clamp((iou - t1) / (t2 - t1), 0, 1)
            image_box_prob = torch.zeros(
                self.num_classes, iou.shape[1], device=iou.device
            ).scatter_reduce_(
                0, labels[:, None].expand_as(iou),
                obj_box_prob * valid[:, None].to(iou.dtype), 'amax').t()
            quality = iou_nearest(gt_near, anc_near)             # [G, M]
            _, matched = topk_lower_index(quality, self.pre_anchor_topk)

        matched_cls = torch.gather(cls_p[matched], 2,
                                   labels[:, None, None].expand(
                                       -1, matched.shape[1], 1))[..., 0]
        matched_anchors = anchors[matched]                     # [G, K, 7+]
        d = matched_anchors.shape[-1]
        tgt = self.coder.encode(matched_anchors, gts[:, None, :d].expand(
            -1, matched.shape[1], -1))
        pred_m = reg_p[matched]
        dir_tgt = self.dir_target(gts[:, None, 6] - matched_anchors[..., 6])
        logp = F.log_softmax(dir_p[matched], dim=-1)
        loss_dir = -torch.gather(logp, -1, dir_tgt[..., None])[..., 0]
        if self.diff_rad_by_sin:
            pred_m, tgt = self._sin_diff(pred_m, tgt)
        l1 = smooth_l1_loss(pred_m, tgt,
                            beta=self.loss_bbox.get('beta', 1.0 / 9.0))
        if code_weight is not None:
            l1 = l1 * code_weight
        matched_box_prob = torch.exp(-(l1.sum(-1) + loss_dir))

        matched_prob = matched_cls * matched_box_prob
        weight = 1.0 / torch.clamp(1 - matched_prob, min=1e-12)
        weight = weight / weight.sum(1, keepdim=True)
        bag_prob = torch.clamp((weight * matched_prob).sum(1), 1e-12, 1.0)
        pos_loss = torch.where(valid, -self.alpha * torch.log(bag_prob), 0.0)

        prob = torch.clamp(cls_p * (1 - image_box_prob), 0, 1)
        neg_loss = (1 - self.alpha) * prob ** self.gamma * \
            (-torch.log(torch.clamp(1 - prob, min=1e-12)))
        return pos_loss.sum(), neg_loss.sum()

    def loss(self, preds, gt_bboxes, gt_labels, gt_valid):
        """'positive_bag_loss' over the valid boxes, 'negative_bag_loss'
        over their bags' anchors."""
        anchors, cls, reg, dir_cls = self._flat_preds(preds)
        b = cls.shape[0]
        cls_prob = torch.sigmoid(cls)
        if dir_cls is None:         # the JAX head's zeros
            dir_cls = cls.new_zeros(b, cls.shape[1], 2)
        tc = self.train_cfg or {}
        code_weight = (cls.new_tensor(tc['code_weight'])
                       if tc.get('code_weight') else None)
        anc_near = nearest_bev(anchors)
        pos, neg = zip(*[self._bags(
            anchors, anc_near, cls_prob[i], reg[i], dir_cls[i], gt_bboxes[i],
            # a padded box's label may lie outside the classes: it only
            # ever meets a weight of 0
            gt_labels[i].to(torch.int64).clamp(0, self.num_classes - 1),
            gt_valid[i], code_weight)
            for i in range(b)])
        num_pos = torch.clamp(gt_valid.sum(), min=1).to(torch.float32)
        return {
            'positive_bag_loss': torch.stack(pos).sum() / num_pos,
            'negative_bag_loss': torch.stack(neg).sum() / torch.clamp(
                num_pos * self.pre_anchor_topk, min=1.0)}
