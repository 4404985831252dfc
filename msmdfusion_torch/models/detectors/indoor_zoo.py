"""MVXFasterRCNN: the voxel detector whose voxels are decorated with image
features (PointFusion) before the middle encoder.

Counterpart of ``MVXFasterRCNN`` in the JAX package's
``models/detectors/indoor_zoo.py`` (reference mvx_faster_rcnn.py and
mvx_two_stage.py:18-541); the module's indoor detectors (VoteNet's family)
come with the indoor models. Hard voxelization and the voxel encoder give
each voxel its features; with images the views run through the ResNet and
the FPN (in eval mode, as the JAX detector calls them), each sample's
voxel centres are fused once with that sample's views and projections,
and each voxel row takes its own sample's fusion by its batch id; then
the middle encoder, SECOND, SECONDFPN and the head.

With a fusion layer configured the voxel features reaching the middle
encoder are ``PointFusion``'s (``mid_channels``, or ``out_channels`` with
``fuse_out``), whatever the config's ``in_channels`` says: the JAX
detector's flax layers take their widths from their inputs when
initialised with images. So the middle encoder's ``in_channels`` is set
to that width (and, for ``PointPillarsScatter``, whose output width is
its input's, the backbone's too), and the model must be called with
images: called without them it raises, where the JAX detector would need
a second set of parameters (initialised without images). The image
layout is TransFusion-LC's: img [B, V, H, W, 3], metas
dict(lidar2img [B, V, 4, 4]).

Module names are mmdet3d's (``pts_voxel_encoder``, ``pts_middle_encoder``,
``pts_fusion_layer``, ``pts_backbone``, ``pts_neck``, ``pts_bbox_head``,
``img_backbone``, ``img_neck``).
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn

from ...ops.voxelize import voxelize_batch
from ...registry import (BACKBONES, DETECTORS, FUSION_LAYERS, HEADS,
                         MIDDLE_ENCODERS, NECKS, VOXEL_ENCODERS)
from ...utils.profiling import named_scope
from ...utils.timing import section


@DETECTORS.register('MVXFasterRCNN')
class MVXFasterRCNN(nn.Module):

    def __init__(self, pts_voxel_layer: Any, pts_voxel_encoder: Any,
                 pts_middle_encoder: Any, pts_backbone: Any,
                 pts_neck: Any = None, pts_bbox_head: Any = None,
                 img_backbone: Any = None, img_neck: Any = None,
                 fusion_layer: Any = None, train_cfg: Any = None,
                 test_cfg: Any = None, **unused):
        super().__init__()
        del unused
        self.pts_voxel_layer = dict(pts_voxel_layer)
        self.pts_voxel_encoder = VOXEL_ENCODERS.build(dict(pts_voxel_encoder))
        self.pts_fusion_layer = (FUSION_LAYERS.build(dict(fusion_layer))
                                 if fusion_layer else None)
        middle, backbone = dict(pts_middle_encoder), dict(pts_backbone)
        if self.pts_fusion_layer is not None:
            width = self.pts_fusion_layer.out_width
            middle['in_channels'] = width
            if middle['type'] == 'PointPillarsScatter':
                backbone['in_channels'] = width
        self.pts_middle_encoder = MIDDLE_ENCODERS.build(middle)
        self.pts_backbone = BACKBONES.build(backbone)
        self.pts_neck = NECKS.build(dict(pts_neck)) if pts_neck else None
        self.img_backbone = (BACKBONES.build(dict(img_backbone))
                             if img_backbone else None)
        self.img_neck = NECKS.build(dict(img_neck)) if img_neck else None
        head_cfg = dict(pts_bbox_head)
        head_cfg['train_cfg'] = dict(train_cfg['pts']) if train_cfg else None
        head_cfg['test_cfg'] = dict(test_cfg['pts'])
        self.pts_bbox_head = HEADS.build(head_cfg)

    def train(self, mode: bool = True):
        """The image branch stays in eval mode (the JAX detector calls it
        with ``train=False``); its parameters still take gradients."""
        super().train(mode)
        for m in (self.img_backbone, self.img_neck):
            if m is not None:
                m.eval()
        return self

    def max_voxels(self) -> int:
        mv = self.pts_voxel_layer['max_voxels']
        if isinstance(mv, (tuple, list)):
            mv = mv[0 if self.training else 1]
        return mv

    def fuse(self, img, metas, coors, valid, voxel_features):
        """Each voxel's features fused with its own sample's views."""
        b, v, h, w, c = img.shape
        with section('img'):
            x = img.reshape(b * v, h, w, c).permute(0, 3, 1, 2).contiguous()
            feats = self.img_backbone(x)
            if self.img_neck is not None:
                feats = self.img_neck(feats)
            per_view = [f.reshape(b, v, *f.shape[1:]) for f in feats]
        with section('fusion'):
            vl = self.pts_voxel_layer
            size = voxel_features.new_tensor(vl['voxel_size'])
            origin = voxel_features.new_tensor(vl['point_cloud_range'][:3])
            centers = (coors[:, 1:].flip(-1).float() + 0.5) * size + origin
            fused = torch.stack([
                self.pts_fusion_layer([pv[i] for pv in per_view], centers,
                                      voxel_features,
                                      metas['lidar2img'][i], (h, w))
                for i in range(b)])                             # [B, K, C]
            row = torch.clamp(coors[:, 0].to(torch.int64), 0, b - 1)
            out = fused[row, torch.arange(row.shape[0], device=row.device)]
            return torch.where(valid[:, None], out, 0.0)

    def extract_pts_feat(self, points, points_mask, img=None, metas=None):
        vl = self.pts_voxel_layer
        with section('voxelize'):
            voxels, num_points, coors, valid = voxelize_batch(
                points, points_mask, vl['voxel_size'],
                vl['point_cloud_range'], vl['max_num_points'],
                self.max_voxels())
            feats = self.pts_voxel_encoder(voxels, num_points, coors)
        if self.pts_fusion_layer is not None:
            if img is None or self.img_backbone is None:
                raise ValueError(
                    'MVXFasterRCNN with a fusion layer takes images: its '
                    'middle encoder reads the fusion\'s '
                    f'{self.pts_fusion_layer.out_width} channels')
            feats = self.fuse(img, metas, coors, valid, feats)
        x = self.pts_middle_encoder(feats, coors, valid, points.shape[0])
        x = x[0] if isinstance(x, tuple) else x
        with section('bev'):
            maps = self.pts_backbone(x)
            if self.pts_neck is not None:
                maps = self.pts_neck(maps)
        return maps

    def forward(self, points, points_mask, img=None, metas=None,
                generator=None):
        """points [B, N, F], points_mask [B, N], img [B, V, H, W, 3], metas
        dict(lidar2img [B, V, 4, 4]) -> the head's predictions."""
        with named_scope('extract_pts_feat'):
            maps = self.extract_pts_feat(points, points_mask, img, metas)
        with section('head'):
            return self.pts_bbox_head(maps[0])

    def loss(self, preds, gt_bboxes, gt_labels, gt_valid):
        with section('loss'):
            return self.pts_bbox_head.loss(preds, gt_bboxes, gt_labels,
                                           gt_valid)

    def get_bboxes(self, preds):
        with section('decode'):
            return self.pts_bbox_head.get_bboxes(preds)

    def simple_test(self, points, points_mask, img=None, metas=None):
        return self.get_bboxes(self(points, points_mask, img, metas))
