"""Part-A2 two-stage detector.

Counterpart of the JAX package's ``models/detectors/parta2.py`` (reference
mmdet3d/models/detectors/parta2.py): hard voxelization and the voxel
encoder, the ``SparseUNet`` (the BEV map and full-resolution per-voxel
features), SECOND and SECONDFPN, the anchor RPN, then RoI refinement with
part-aware pooling. The proposals are a fixed top-K of the RPN's decoded
boxes (``num_proposals``, at most the RPN's ``max_num``; ties by the lower
index, ``topk_lower_index``) instead of the reference's dynamic NMS
output. A pointwise semantic branch (``semantic_fc`` 64 wide, then
``semantic_seg`` and ``semantic_part``, the JAX package's names: the
reference ``PointwiseSemanticHead`` has no hidden layer) predicts each
voxel's foreground score and intra-object part coordinates, which the RoI
head mean-pools. The RoI head runs once per sample (its norms take each
sample's moments in training mode, as the JAX loop's calls do).

Module names are mmdet3d's two-stage ones (``voxel_encoder``,
``middle_encoder``, ``backbone``, ``neck``, ``rpn_head``, ``roi_head``).
``get_bboxes`` returns the RoI head's ``bboxes``, ``scores`` and ``valid``
and no ``labels``, as the JAX detector's does.
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn

from ...core.boxes import points_in_rbbox
from ...core.coders import topk_lower_index
from ...ops.voxelize import voxelize_batch
from ...registry import (BACKBONES, DETECTORS, HEADS, MIDDLE_ENCODERS, NECKS,
                         VOXEL_ENCODERS)
from ...utils.profiling import named_scope
from ...utils.timing import section
from ..layers import Linear
from ..losses import binary_cross_entropy, smooth_l1_loss


def _sub_cfg(cfg, key):
    return dict(cfg.get(key, {})) if cfg else None


@DETECTORS.register('PartA2')
class PartA2(nn.Module):

    def __init__(self, pts_voxel_layer: Any, pts_voxel_encoder: Any,
                 pts_middle_encoder: Any, pts_backbone: Any,
                 pts_neck: Any = None, rpn_head: Any = None,
                 roi_head: Any = None, num_proposals: int = 128,
                 train_cfg: Any = None, test_cfg: Any = None, **unused):
        super().__init__()
        del unused
        self.pts_voxel_layer = dict(pts_voxel_layer)
        self.num_proposals = num_proposals
        self.voxel_encoder = VOXEL_ENCODERS.build(dict(pts_voxel_encoder))
        self.middle_encoder = MIDDLE_ENCODERS.build(dict(pts_middle_encoder))
        self.backbone = BACKBONES.build(dict(pts_backbone))
        self.neck = NECKS.build(dict(pts_neck)) if pts_neck else None
        rpn_cfg = dict(rpn_head)
        rpn_cfg['train_cfg'] = _sub_cfg(train_cfg, 'rpn')
        rpn_cfg['test_cfg'] = dict((test_cfg or {}).get('rpn', {}))
        self.rpn_head = HEADS.build(rpn_cfg)
        roi_cfg = dict(roi_head)
        roi_cfg['train_cfg'] = _sub_cfg(train_cfg, 'rcnn')
        roi_cfg['test_cfg'] = dict((test_cfg or {}).get('rcnn', {}))
        self.roi_head = HEADS.build(roi_cfg)
        self.semantic_fc = Linear(self.middle_encoder.seg_channels, 64)
        self.semantic_seg = Linear(64, 1)
        self.semantic_part = Linear(64, 3)

    def max_voxels(self) -> int:
        mv = self.pts_voxel_layer['max_voxels']
        if isinstance(mv, (tuple, list)):
            mv = mv[0 if self.training else 1]
        return mv

    def extract_feat(self, points, points_mask):
        """-> (the neck's BEV maps, the U-Net's full-resolution
        ``SparseTensor``)."""
        vl = self.pts_voxel_layer
        with section('voxelize'):
            voxels, num_points, coors, valid = voxelize_batch(
                points, points_mask, vl['voxel_size'],
                vl['point_cloud_range'], vl['max_num_points'],
                self.max_voxels())
            feats = self.voxel_encoder(voxels, num_points, coors)
        bev, seg = self.middle_encoder(feats, coors, valid, points.shape[0])
        with section('bev'):
            maps = self.backbone(bev)
            if self.neck is not None:
                maps = self.neck(maps)
        return maps, seg

    def forward(self, points, points_mask, generator=None):
        """points [B, N, F], points_mask [B, N] -> dict 'rpn' (the RPN's
        maps, channels-first), 'roi' (cls_score [B, R, 1], bbox_pred [B, R,
        7], rois [B, R, 7], roi_valid [B, R]) and 'semantic' (seg_logit [P,
        1], part_reg [P, 3], centers [P, 3], coords_b [P], valid [P])."""
        with named_scope('extract_pts_feat'):
            maps, seg = self.extract_feat(points, points_mask)
        with section('rpn'):
            rpn_out = self.rpn_head(maps[0])
            res = self.rpn_head.get_bboxes(rpn_out)
            scores = torch.where(res['valid'], res['scores'], -1e9)
            k = min(self.num_proposals, scores.shape[1])
            top = torch.stack([topk_lower_index(s, k)[1] for s in scores])
            rois = torch.gather(res['boxes'], 1, top[..., None].expand(
                -1, -1, res['boxes'].shape[-1]))
            roi_valid = torch.gather(res['valid'], 1, top)
        vl = self.pts_voxel_layer
        with section('roi_pool'):
            sem = torch.relu(self.semantic_fc(seg.features))
            seg_logit = self.semantic_seg(sem)
            part_reg = torch.sigmoid(self.semantic_part(sem))
            part_feats = torch.cat([part_reg, torch.sigmoid(seg_logit)], -1)
            size = seg.features.new_tensor(vl['voxel_size'])
            origin = seg.features.new_tensor(vl['point_cloud_range'][:3])
            centers = (seg.coords[:, 1:].flip(-1).float() + 0.5) * size \
                + origin
        outs = [self.roi_head(centers, seg.features,
                              seg.valid & (seg.coords[:, 0] == b), rois[b],
                              roi_valid[b], part_feats=part_feats,
                              generator=generator)
                for b in range(points.shape[0])]
        roi_out = {key: torch.stack([o[key] for o in outs]) for key in outs[0]}
        return {'rpn': rpn_out, 'roi': roi_out,
                'semantic': {'seg_logit': seg_logit, 'part_reg': part_reg,
                             'centers': centers, 'coords_b': seg.coords[:, 0],
                             'valid': seg.valid}}

    def loss(self, preds, gt_bboxes, gt_labels, gt_valid):
        """The RPN's, the semantic branch's and the RoI head's losses (the
        last averaged over the samples)."""
        with section('loss'):
            losses = self.rpn_head.loss(preds['rpn'], gt_bboxes, gt_labels,
                                        gt_valid)
            losses.update(self._semantic_loss(preds['semantic'], gt_bboxes,
                                              gt_valid))
            b = gt_bboxes.shape[0]
            roi = [self.roi_head.loss({k: v[i] for k, v in
                                       preds['roi'].items()},
                                      gt_bboxes[i], gt_labels[i], gt_valid[i])
                   for i in range(b)]
            for key in roi[0]:
                losses[key] = sum(r[key] for r in roi) / b
        return losses

    def _semantic_loss(self, sem, gt_bboxes, gt_valid):
        """Voxel centres inside a ground-truth box are foreground; their
        part target is the normalised intra-box coordinate (the first box
        holding the centre)."""
        centers = sem['centers']
        b = gt_bboxes.shape[0]
        seg_losses, part_losses = [], []
        for i in range(b):
            valid = sem['valid'] & (sem['coords_b'] == i)
            boxes = gt_bboxes[i][..., :7]
            inside = points_in_rbbox(centers, boxes) & gt_valid[i][None, :] \
                & valid[:, None]
            fg = inside.any(1)
            box = boxes[inside.to(torch.uint8).argmax(1)]           # [P, 7]
            local = centers - box[:, :3]
            c, s = torch.cos(-box[:, 6]), torch.sin(-box[:, 6])
            lx = local[:, 0] * c - local[:, 1] * s
            ly = local[:, 0] * s + local[:, 1] * c
            lz = local[:, 2]
            part_tgt = torch.stack(
                [lx / torch.clamp(box[:, 3], min=1e-3) + 0.5,
                 ly / torch.clamp(box[:, 4], min=1e-3) + 0.5,
                 lz / torch.clamp(box[:, 5], min=1e-3)], -1).clamp(0, 1)
            seg_l = binary_cross_entropy(sem['seg_logit'][:, 0],
                                         fg.to(centers.dtype))
            seg_losses.append(torch.where(valid, seg_l, 0.0).sum()
                              / torch.clamp(valid.sum(), min=1))
            part_l = smooth_l1_loss(sem['part_reg'], part_tgt).sum(-1)
            part_losses.append(torch.where(fg, part_l, 0.0).sum()
                               / torch.clamp(fg.sum(), min=1))
        return {'loss_semantic_seg': sum(seg_losses) / b,
                'loss_semantic_part': sum(part_losses) / b}

    def forward_train(self, points, points_mask, gt_bboxes, gt_labels,
                      gt_valid, generator=None):
        self.train()
        return self.loss(self(points, points_mask, generator=generator),
                         gt_bboxes, gt_labels, gt_valid)

    def get_bboxes(self, preds):
        """-> dict bboxes [B, R, 7], scores [B, R], valid [B, R]."""
        with section('decode'):
            b = preds['roi']['rois'].shape[0]
            outs = [self.roi_head.get_bboxes({k: v[i] for k, v in
                                              preds['roi'].items()})
                    for i in range(b)]
            return {key: torch.stack([o[key] for o in outs])
                    for key in outs[0]}

    def simple_test(self, points, points_mask):
        return self.get_bboxes(self(points, points_mask))
