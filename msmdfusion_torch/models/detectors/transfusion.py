"""TransFusion detector: TransFusion-L (LiDAR-only voxel variant) and
TransFusion-LC (its camera branch), inference and training.

Counterpart of the JAX package's ``models/detectors/transfusion.py``
(reference mmdet3d/models/detectors/transfusion.py): fused voxelize +
mean (the ``HardSimpleVFE`` path) -> SparseEncoder -> SECOND -> SECONDFPN
-> TransFusionHead, over fixed-capacity batch tensors. Submodule names are
the reference's (``pts_middle_encoder``, ``pts_backbone``, ``pts_neck``,
``pts_bbox_head``, ``img_backbone``, ``img_neck``), so ``state_dict()``
keys are the reference checkpoint's.

With ``img_backbone`` and ``img_neck`` configured (TransFusion-LC) and
images given, the views are flattened into the batch, run through the
ResNet and the FPN, and the FPN's first level goes, as [B, V, C, h, w],
to the head's image fusion with the ``metas`` (JAX ``:96-108``). Called
without images the model is TransFusion-L, whatever the config says, as
the JAX package's inference and train entry points call it.

In training mode (``model.train()``: the JAX ``train=True`` of every
layer) the voxelizer takes the train-time capacity ``max_voxels[0]``
(past it the highest keys are dropped and counted at
``voxelize.mean_batch.voxel_cap``), every norm the batch's moments, the
strided sparse convs build their transpose plans for the backward, the
head's dropout draws from the step's ``generator``, and ``loss`` gives the
head's losses: the reference's stage-1 step (``apis/train.py``'s
``make_train_step`` takes the model as it is, ``batch['inputs']`` being
``(points, points_mask)``, or ``(points, points_mask, img, metas)`` for
TransFusion-LC). With ``freeze_img`` the image branch stays in eval mode
(JAX ``img_train = train and not freeze_img``) but, unlike the
flagship's, still takes gradients: the JAX detector stops none, so its
step's ``grad_norm`` counts them; the optimizer leaves those parameters
out (``apis/train.py::frozen_prefixes``).
"""
from __future__ import annotations

from typing import Any

from torch import nn

from ...ops.voxelize import voxelize_mean_batch
from ...registry import (BACKBONES, DETECTORS, HEADS, MIDDLE_ENCODERS,
                         NECKS)
from ...utils.profiling import named_scope
from ...utils.timing import section


@DETECTORS.register('TransFusionDetector')
class TransFusionDetector(nn.Module):

    def __init__(self, pts_voxel_layer: Any, pts_voxel_encoder: Any,
                 pts_middle_encoder: Any, pts_backbone: Any,
                 pts_neck: Any = None, pts_bbox_head: Any = None,
                 img_backbone: Any = None, img_neck: Any = None,
                 freeze_img: bool = True, train_cfg: Any = None,
                 test_cfg: Any = None, **unused):
        super().__init__()
        del unused
        if pts_voxel_encoder['type'] != 'HardSimpleVFE':
            raise NotImplementedError(
                f"voxel encoder {pts_voxel_encoder['type']}: only the fused "
                'HardSimpleVFE path is ported')
        self.pts_voxel_layer = dict(pts_voxel_layer)
        self.freeze_img = freeze_img
        self.img_backbone = (BACKBONES.build(dict(img_backbone))
                             if img_backbone else None)
        self.img_neck = NECKS.build(dict(img_neck)) if img_neck else None
        self.pts_middle_encoder = MIDDLE_ENCODERS.build(
            dict(pts_middle_encoder))
        self.pts_backbone = BACKBONES.build(dict(pts_backbone))
        self.pts_neck = NECKS.build(dict(pts_neck)) if pts_neck else None
        head_cfg = dict(pts_bbox_head)
        head_cfg['test_cfg'] = dict(test_cfg['pts'])
        head_cfg['train_cfg'] = dict(train_cfg['pts']) if train_cfg else None
        self.pts_bbox_head = HEADS.build(head_cfg)

    def train(self, mode: bool = True):
        """Set the training mode; under ``freeze_img`` the image branch
        stays in eval."""
        super().train(mode)
        if mode and self.freeze_img:
            for m in (self.img_backbone, self.img_neck):
                if m is not None:
                    m.eval()
        return self

    def extract_img_feat(self, img):
        """img [B, V, H, W, 3] -> the FPN's first level [B, V, C, h, w]
        (the ResNet's alone without a neck)."""
        b, v, h, w, c = img.shape
        x = img.reshape(b * v, h, w, c).permute(0, 3, 1, 2).contiguous()
        feats = self.img_backbone(x)
        if self.img_neck is not None:
            feats = self.img_neck(feats)
        lvl0 = feats[0]
        return lvl0.reshape(b, v, *lvl0.shape[1:])

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

    def forward(self, points, points_mask, img=None, metas=None,
                generator=None):
        """points [B, N, F], points_mask [B, N] (and for the camera branch
        img [B, V, H, W, 3] with metas dict(lidar2img [B, V, 4, 4])) ->
        head predictions. ``generator``: the ``torch.Generator`` the
        head's dropout draws from in training mode."""
        with named_scope('extract_pts_feat'):
            feats, _ = self.extract_pts_feat(points, points_mask)
        img_inputs = None
        if img is not None and self.img_backbone is not None:
            with section('img'):
                img_inputs = self.extract_img_feat(img)
        with section('head'):
            return self.pts_bbox_head(feats[0], img_inputs=img_inputs,
                                      metas=metas, generator=generator)

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
