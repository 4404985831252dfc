"""3DSSD head: F-FPS and D-FPS candidates, spatial-shift votes,
anchor-free boxes.

Counterpart of the JAX package's ``models/heads/ssd3d_head.py`` (reference
mmdet3d/models/dense_heads/ssd3d_head.py:572): half the candidates by
feature-distance FPS (``combined_fps``), half by plain D-FPS; a vote MLP
shifts each candidate toward its box centre, a set-abstraction module
pools the points around the shifted candidates, and one linear layer
predicts the class, centre, log size and direction bin and residual.
Losses: the assigned box's centerness as a soft classification target,
centre, size, direction, corner and shift losses over the candidates
whose shifted point lies in their nearest box.

The JAX head takes its width from its input (``in_channels``: the
backbone's output width, set by the detector). Module names: mmdet3d's
``vote_aggregation``; the JAX head's ``vote_mlp``, ``vote_out``,
``pred_mlp``, ``pred_out``.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
from torch import nn

from ...core.boxes import corners_3d
from ...ops import sampling
from ...registry import HEADS
from ...utils.timing import section
from ..backbones.pointnet2 import PointSAModule
from ..layers import MLP, Linear
from ..losses import cross_entropy, smooth_l1_loss
from .vote_head import (decode_boxes, dir_targets, gravity_centers,
                        masked_mean, take_last, take_rows)


@HEADS.register('SSD3DHead')
class SSD3DHead(nn.Module):

    def __init__(self, num_classes: int = 1, in_channels: int = 256,
                 num_candidates: int = 256, num_dir_bins: int = 12,
                 aggregation_radius: float = 4.8,
                 aggregation_samples: int = 16, train_cfg: Any = None,
                 test_cfg: Any = None, **unused):
        super().__init__()
        del unused
        c = in_channels
        self.num_classes, self.num_candidates = num_classes, num_candidates
        self.num_dir_bins = num_dir_bins
        self.train_cfg, self.test_cfg = train_cfg or {}, test_cfg or {}
        self.vote_aggregation = PointSAModule(
            num_candidates, aggregation_radius, aggregation_samples,
            (c, c, c), in_channels=c)
        self.vote_mlp = MLP(c, (c // 2,), final_act=True)
        self.vote_out = Linear(c // 2, 3)
        self.pred_mlp = MLP(c, (c, c), final_act=True)
        self.pred_out = Linear(c, num_classes + 3 + 3 + num_dir_bins * 2)

    def forward(self, feat_dict: Dict[str, torch.Tensor]):
        xyz, feats = feat_dict['fp_xyz'], feat_dict['fp_features']
        valid = feat_dict['fp_valid']
        half = self.num_candidates // 2
        with section('vote'):
            with section('fps'):
                idx = torch.cat([
                    sampling.combined_fps(xyz, feats, half, valid,
                                          feature_weight=1.0),
                    sampling.combined_fps(xyz, None,
                                          self.num_candidates - half,
                                          valid)], -1)
            cand_xyz = sampling.gather_points(xyz, idx)
            cand_valid = torch.gather(valid, 1, idx)
            off = self.vote_out(self.vote_mlp(sampling.gather_points(feats,
                                                                     idx)))
            shifted = cand_xyz + torch.where(cand_valid[..., None], off, 0.0)
        with section('aggregation'):
            _, cand_feats, _ = self.vote_aggregation(
                xyz, feats, valid, new_xyz=shifted, new_valid=cand_valid)
        with section('head'):
            raw = self.pred_out(self.pred_mlp(cand_feats))
        nc, nb = self.num_classes, self.num_dir_bins
        res = {'candidate_xyz': cand_xyz, 'shifted_xyz': shifted,
               'candidate_valid': cand_valid}
        res['cls_scores'], raw = raw[..., :nc], raw[..., nc:]
        res['center'], raw = shifted + raw[..., :3], raw[..., 3:]
        res['log_size'], raw = raw[..., :3], raw[..., 3:]
        res['dir_class'] = raw[..., :nb]
        res['dir_res_norm'] = raw[..., nb:2 * nb]
        return res

    def _decode_boxes(self, preds):
        sizes = torch.exp(torch.clamp(preds['log_size'], -4.0, 4.0))
        return decode_boxes(preds['center'], sizes, preds['dir_class'],
                            preds['dir_res_norm'], self.num_dir_bins)

    def loss(self, preds, gt_bboxes, gt_labels, gt_valid):
        centers, cand_valid = preds['center'], preds['candidate_valid']
        nb = self.num_dir_bins
        gt_centers = gravity_centers(gt_bboxes)
        d = ((centers[:, :, None, :] - gt_centers[:, None]) ** 2).sum(-1)
        d = torch.where(gt_valid[:, None, :], d, 1e10)
        nearest = torch.argmin(d, -1)
        gt_for = take_rows(gt_bboxes, nearest)
        lab = torch.clamp(take_rows(gt_labels, nearest).to(torch.int64),
                          min=0)
        gt_ctr = take_rows(gt_centers, nearest)

        # positives: the shifted point inside the assigned box
        rel = preds['shifted_xyz'] - gt_ctr
        cs, sn = torch.cos(-gt_for[..., 6]), torch.sin(-gt_for[..., 6])
        local = torch.stack([rel[..., 0] * cs - rel[..., 1] * sn,
                             rel[..., 0] * sn + rel[..., 1] * cs,
                             rel[..., 2]], -1)
        half_wlh = gt_for[..., 3:6] / 2
        inside = torch.all(local.abs() < half_wlh + 1e-4, -1)
        pos = inside & cand_valid
        num_pos = torch.clamp(pos.sum(), min=1)

        # centerness (3DSSD): the geometric mean over the axes of
        # 1 - |offset| / half extent
        ratio = torch.clamp(1.0 - local.abs() / torch.clamp(half_wlh,
                                                            min=1e-4),
                            1e-4, 1.0)
        centerness = torch.pow(torch.prod(ratio, -1), 1.0 / 3.0)
        onehot = (lab[..., None] == torch.arange(
            self.num_classes, device=lab.device)).to(centers.dtype)
        cls_tgt = onehot * torch.where(pos, centerness, 0.0)[..., None]
        p = torch.sigmoid(preds['cls_scores'])
        cls_loss = -(cls_tgt * torch.log(p + 1e-8) +
                     (1 - cls_tgt) * torch.log(1 - p + 1e-8))
        cls_loss = torch.where(cand_valid[..., None], cls_loss, 0.0).sum() \
            / torch.clamp(cand_valid.sum(), min=1)

        center_loss = masked_mean(smooth_l1_loss(centers, gt_ctr).sum(-1),
                                  pos, num_pos)
        size_loss = masked_mean(smooth_l1_loss(
            preds['log_size'], torch.log(torch.clamp(gt_for[..., 3:6],
                                                     min=1e-4))).sum(-1),
            pos, num_pos)
        dir_bin, dir_res = dir_targets(gt_for[..., 6], nb)
        dir_cls = masked_mean(cross_entropy(
            preds['dir_class'].reshape(-1, nb), dir_bin.reshape(-1), nb),
            pos.reshape(-1), num_pos)
        width = 2 * math.pi / nb
        dir_res_loss = masked_mean(smooth_l1_loss(
            take_last(preds['dir_res_norm'], dir_bin) * width, dir_res),
            pos, num_pos)

        corner_loss = masked_mean(smooth_l1_loss(
            corners_3d(self._decode_boxes(preds)),
            corners_3d(gt_for[..., :7])).sum((-1, -2)), pos, num_pos)
        vote_loss = masked_mean(smooth_l1_loss(
            preds['shifted_xyz'], gt_ctr).sum(-1), pos, num_pos)
        return {'centerness_loss': cls_loss, 'center_loss': center_loss,
                'size_res_loss': size_loss, 'dir_class_loss': dir_cls,
                'dir_res_loss': dir_res_loss, 'corner_loss': corner_loss,
                'vote_loss': vote_loss}

    def get_bboxes(self, preds):
        """Every candidate decoded; no NMS (the JAX head's)."""
        with section('decode'):
            boxes = self._decode_boxes(preds)
            scores = torch.sigmoid(preds['cls_scores'])
            return {'bboxes': boxes, 'scores': torch.amax(scores, -1),
                    'labels': torch.argmax(scores, -1),
                    'valid': preds['candidate_valid']}
