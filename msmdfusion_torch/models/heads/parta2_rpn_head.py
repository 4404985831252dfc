"""Part-A2 RPN head: ``Anchor3DHead`` with RPN-prefixed losses and
class-agnostic proposals.

Counterpart of the JAX package's ``models/heads/parta2_rpn_head.py``
(reference mmdet3d/models/dense_heads/parta2_rpn_head.py:14-311): the
anchor head's branches, assignment and decode, the loss keys prefixed
``loss_rpn_``, and ``get_proposals``: per sample the ``nms_pre`` anchors
of highest best-class score (ties by the lower index), decoded, the
direction applied, one rotated NMS over every class together, and the
``nms_post`` kept proposals of highest score (fixed capacity, masked).
"""
from __future__ import annotations

import math

import torch

from ...core.boxes import limit_period
from ...core.coders import topk_lower_index
from ...core.nms import nms_bev
from ...registry import HEADS
from .anchor3d_head import Anchor3DHead, bev_of


@HEADS.register('PartA2RPNHead')
class PartA2RPNHead(Anchor3DHead):

    def loss(self, preds, gt_bboxes, gt_labels, gt_valid):
        """The anchor head's losses under RPN keys (reference :86-125)."""
        losses = super().loss(preds, gt_bboxes, gt_labels, gt_valid)
        out = {'loss_rpn_cls': losses['loss_cls'],
               'loss_rpn_bbox': losses['loss_bbox']}
        if 'loss_dir' in losses:
            out['loss_rpn_dir'] = losses['loss_dir']
        return out

    def get_proposals(self, preds):
        """-> dict 'boxes' [B, P, code], 'scores', 'labels' (the anchor's
        best class), 'valid' [B, P]; P = ``test_cfg['nms_post']``."""
        tcfg = self.test_cfg
        anchors, cls, reg, dir_cls = self._flat_preds(preds)
        m = anchors.shape[0]
        scores = torch.sigmoid(cls)
        nms_pre = min(tcfg.get('nms_pre', 1024), m)
        nms_post = tcfg.get('nms_post', 128)
        outs = []
        for i in range(scores.shape[0]):
            top_score = scores[i].amax(-1)
            top_label = scores[i].argmax(-1)    # the first best class
            _, idx = topk_lower_index(top_score, nms_pre)
            boxes = self.coder.decode(anchors[idx], reg[i][idx])
            dir_label = (dir_cls[i][idx].argmax(-1) if dir_cls is not None
                         else torch.zeros_like(idx))
            yaw = limit_period(boxes[..., 6] - self.dir_offset,
                               self.dir_limit_offset, math.pi)
            boxes = torch.cat([boxes[..., :6], (
                yaw + self.dir_offset + math.pi * dir_label)[..., None],
                boxes[..., 7:]], -1)
            sc, lb = top_score[idx], top_label[idx]
            valid = sc > tcfg.get('score_thr', 0.0)
            keep, order = nms_bev(bev_of(boxes), sc,
                                  tcfg.get('nms_thr', 0.8), valid=valid)
            keep_in = torch.zeros(nms_pre, dtype=torch.bool,
                                  device=sc.device).scatter(0, order, keep)
            keep_in = keep_in & valid
            _, sel = topk_lower_index(torch.where(keep_in, sc, -1.0),
                                      nms_post)
            outs.append({'boxes': boxes[sel], 'scores': sc[sel],
                         'labels': lb[sel],
                         'valid': keep_in[sel] & (sc[sel] > 0)})
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
