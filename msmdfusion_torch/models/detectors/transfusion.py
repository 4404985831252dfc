"""TransFusion-L detector (LiDAR-only voxel variant), inference and
training.

Counterpart of the JAX package's ``models/detectors/transfusion.py``
(reference mmdet3d/models/detectors/transfusion.py): fused voxelize +
mean (the ``HardSimpleVFE`` path) -> SparseEncoder -> SECOND -> SECONDFPN
-> TransFusionHead, over fixed-capacity batch tensors. Submodule names are
the reference's (``pts_middle_encoder``, ``pts_backbone``, ``pts_neck``,
``pts_bbox_head``), so ``state_dict()`` keys are the reference
checkpoint's. In training mode (``model.train()``: the JAX ``train=True``
of every layer) the voxelizer takes the train-time capacity
``max_voxels[0]`` (past it the highest keys are dropped and counted at
``voxelize.mean_batch.voxel_cap``), every norm the batch's moments, the
strided sparse convs build their transpose plans for the backward, the
head's dropout draws from the step's ``generator``, and ``loss`` gives the
head's losses: the reference's stage-1 step (``apis/train.py``'s
``make_train_step`` takes the model as it is, ``batch['inputs']`` being
``(points, points_mask)``).
"""
from __future__ import annotations

from typing import Any

from torch import nn

from ...ops.voxelize import voxelize_mean_batch
from ...registry import (BACKBONES, DETECTORS, HEADS, MIDDLE_ENCODERS,
                         NECKS)
from ...utils.timing import section


@DETECTORS.register('TransFusionDetector')
class TransFusionDetector(nn.Module):

    def __init__(self, pts_voxel_layer: Any, pts_voxel_encoder: Any,
                 pts_middle_encoder: Any, pts_backbone: Any,
                 pts_neck: Any = None, pts_bbox_head: Any = None,
                 train_cfg: Any = None, test_cfg: Any = None, **unused):
        super().__init__()
        if unused.get('img_backbone') or unused.get('img_neck'):
            raise NotImplementedError('the camera branch is not ported yet')
        if pts_voxel_encoder['type'] != 'HardSimpleVFE':
            raise NotImplementedError(
                f"voxel encoder {pts_voxel_encoder['type']}: only the fused "
                'HardSimpleVFE path is ported')
        self.pts_voxel_layer = dict(pts_voxel_layer)
        self.pts_middle_encoder = MIDDLE_ENCODERS.build(
            dict(pts_middle_encoder))
        self.pts_backbone = BACKBONES.build(dict(pts_backbone))
        self.pts_neck = NECKS.build(dict(pts_neck)) if pts_neck else None
        head_cfg = dict(pts_bbox_head)
        head_cfg['test_cfg'] = dict(test_cfg['pts'])
        head_cfg['train_cfg'] = dict(train_cfg['pts']) if train_cfg else None
        self.pts_bbox_head = HEADS.build(head_cfg)

    def extract_pts_feat(self, points, points_mask):
        """points [B, N, F], points_mask [B, N] -> (BEV features list,
        per-stage sparse tensors)."""
        vl = self.pts_voxel_layer
        max_voxels = vl['max_voxels']
        if isinstance(max_voxels, (tuple, list)):
            # the train-time capacity, else the test-time one
            max_voxels = max_voxels[0 if self.training else 1]
        batch_size = points.shape[0]
        with section('voxelize'):
            voxel_features, coors, valid = voxelize_mean_batch(
                points, points_mask, vl['voxel_size'],
                vl['point_cloud_range'], max_voxels * batch_size)
        x, encode_features = self.pts_middle_encoder(
            voxel_features, coors, valid, batch_size, assume_sorted=True)
        with section('bev'):
            feats = self.pts_backbone(x)
            if self.pts_neck is not None:
                feats = self.pts_neck(feats)
        return feats, encode_features

    def forward(self, points, points_mask, generator=None):
        """points [B, N, F], points_mask [B, N] -> head predictions.
        ``generator``: the ``torch.Generator`` the head's dropout draws
        from in training mode."""
        feats, _ = self.extract_pts_feat(points, points_mask)
        with section('head'):
            return self.pts_bbox_head(feats[0], generator=generator)

    def loss(self, preds, gt_bboxes, gt_labels, gt_valid, targets=None):
        """The head's losses (``TransFusionHead.loss``)."""
        with section('loss'):
            return self.pts_bbox_head.loss(preds, gt_bboxes, gt_labels,
                                           gt_valid, targets=targets)

    def forward_train(self, points, points_mask, gt_bboxes, gt_labels,
                      gt_valid, generator=None):
        """The losses of one training-mode forward (JAX ``:116-119``)."""
        self.train()
        preds = self(points, points_mask, generator=generator)
        return self.loss(preds, gt_bboxes, gt_labels, gt_valid)

    def get_bboxes(self, preds):
        with section('decode'):
            return self.pts_bbox_head.get_bboxes(preds)

    def simple_test(self, points, points_mask):
        return self.get_bboxes(self(points, points_mask))
