"""Single-stage LiDAR voxel detectors: VoxelNet (SECOND, PointPillars),
CenterPoint and DynamicVoxelNet.

Counterpart of the JAX package's ``models/detectors/voxelnet.py``
(reference mmdet3d/models/detectors/voxelnet.py, centerpoint.py,
dynamic_voxelnet.py): voxelize -> voxel encoder -> middle encoder -> BEV
backbone -> neck -> head, over fixed-capacity batch tensors. Submodule
names are mmdet3d's multi-modality ones (``pts_voxel_encoder``,
``pts_middle_encoder``, ``pts_backbone``, ``pts_neck``, ``pts_bbox_head``).

With ``HardSimpleVFE`` the voxelizer is the fused batched mean
(``voxelize_mean_batch``, rows in key order, so the sparse encoder skips
its sort); any other encoder takes per-sample hard voxels
(``voxelize_batch``, slots in first-come order). ``DynamicVoxelNet``
voxelizes each point and mean-reduces the points of each voxel with the
batch folded into z (``dynamic_scatter``; rows in first-come order, so
the sparse tensor sorts them), as the JAX detector does whatever its
``pts_voxel_encoder`` says.

In training mode the voxelizers take the train-time capacity
``max_voxels[0]``, every norm the batch's moments, and ``loss`` gives the
head's losses; ``forward`` takes (points, points_mask) and the train
step's ``generator`` (unused: these heads have no dropout).
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn

from ...ops.voxelize import (dynamic_scatter, dynamic_voxelize, grid_shape,
                             voxelize_batch, voxelize_mean_batch)
from ...registry import (BACKBONES, DETECTORS, HEADS, MIDDLE_ENCODERS, NECKS,
                         VOXEL_ENCODERS)
from ...utils.profiling import named_scope
from ...utils.timing import section


class _VoxelDetectorBase(nn.Module):

    def __init__(self, pts_voxel_layer: Any, pts_voxel_encoder: Any,
                 pts_middle_encoder: Any, pts_backbone: Any,
                 pts_neck: Any = None, pts_bbox_head: Any = None,
                 train_cfg: Any = None, test_cfg: Any = None, **unused):
        super().__init__()
        del unused
        self.pts_voxel_layer = dict(pts_voxel_layer)
        self.encoder_type = pts_voxel_encoder['type']
        self.pts_voxel_encoder = VOXEL_ENCODERS.build(dict(pts_voxel_encoder))
        self.pts_middle_encoder = MIDDLE_ENCODERS.build(
            dict(pts_middle_encoder))
        self.pts_backbone = BACKBONES.build(dict(pts_backbone))
        self.pts_neck = NECKS.build(dict(pts_neck)) if pts_neck else None
        head_cfg = dict(pts_bbox_head)
        train = dict(train_cfg) if train_cfg else None
        head_cfg['train_cfg'] = (dict(train['pts']) if train and 'pts' in
                                 train else train)
        test = dict(test_cfg)
        head_cfg['test_cfg'] = dict(test.get('pts', test))
        self.pts_bbox_head = HEADS.build(head_cfg)

    def max_voxels(self) -> int:
        mv = self.pts_voxel_layer['max_voxels']
        if isinstance(mv, (tuple, list)):
            mv = mv[0 if self.training else 1]
        return mv

    def encode(self, points, points_mask):
        """points [B, N, F], points_mask [B, N] -> the middle encoder's BEV
        map [B, C, H, W]."""
        vl = self.pts_voxel_layer
        b = points.shape[0]
        if self.encoder_type == 'HardSimpleVFE':
            with section('voxelize'):
                feats, coors, valid = voxelize_mean_batch(
                    points, points_mask, vl['voxel_size'],
                    vl['point_cloud_range'], self.max_voxels() * b)
            x = self.pts_middle_encoder(feats, coors, valid, b,
                                        assume_sorted=True)
        else:
            with section('voxelize'):
                voxels, num_points, coors, valid = voxelize_batch(
                    points, points_mask, vl['voxel_size'],
                    vl['point_cloud_range'], vl['max_num_points'],
                    self.max_voxels())
                feats = self.pts_voxel_encoder(voxels, num_points, coors)
            x = self.pts_middle_encoder(feats, coors, valid, b)
        return x[0] if isinstance(x, tuple) else x

    def extract_pts_feat(self, points, points_mask):
        """-> the neck's (or the backbone's) list of BEV maps."""
        x = self.encode(points, points_mask)
        with section('bev'):
            feats = self.pts_backbone(x)
            if self.pts_neck is not None:
                feats = self.pts_neck(feats)
        return feats

    def forward(self, points, points_mask, generator=None):
        """points [B, N, F], points_mask [B, N] -> the head's
        predictions."""
        with named_scope('extract_pts_feat'):
            feats = self.extract_pts_feat(points, points_mask)
        with section('head'):
            return self.pts_bbox_head(feats[0])

    def loss(self, preds, gt_bboxes, gt_labels, gt_valid):
        with section('loss'):
            return self.pts_bbox_head.loss(preds, gt_bboxes, gt_labels,
                                           gt_valid)

    def forward_train(self, points, points_mask, gt_bboxes, gt_labels,
                      gt_valid, generator=None):
        self.train()
        return self.loss(self(points, points_mask), gt_bboxes, gt_labels,
                         gt_valid)

    def get_bboxes(self, preds):
        with section('decode'):
            return self.pts_bbox_head.get_bboxes(preds)

    def simple_test(self, points, points_mask):
        return self.get_bboxes(self(points, points_mask))


@DETECTORS.register('VoxelNet')
class VoxelNet(_VoxelDetectorBase):
    """SECOND and PointPillars (reference voxelnet.py)."""


@DETECTORS.register('CenterPoint')
class CenterPoint(_VoxelDetectorBase):
    """CenterPoint (reference centerpoint.py)."""


@DETECTORS.register('DynamicVoxelNet')
class DynamicVoxelNet(_VoxelDetectorBase):
    """Dynamic voxelization (reference dynamic_voxelnet.py): each voxel
    the mean of all its points, no per-voxel cap."""

    def encode(self, points, points_mask):
        vl = self.pts_voxel_layer
        b, n = points.shape[:2]
        with section('voxelize'):
            flat = points.reshape(b * n, -1)
            coords, valid = dynamic_voxelize(
                flat, points_mask.reshape(-1), vl['voxel_size'],
                vl['point_cloud_range'])
            grid = grid_shape(vl['voxel_size'], vl['point_cloud_range'])
            batch_ids = torch.arange(b, device=points.device
                                     ).repeat_interleave(n).to(torch.int32)
            # the batch folded into z for one segment reduce, then unfolded
            folded = torch.cat([coords[:, :1] + batch_ids[:, None] * grid[0],
                                coords[:, 1:]], -1)
            feats, vcoors, vvalid, _ = dynamic_scatter(
                flat, folded, valid, (b * grid[0], grid[1], grid[2]),
                self.max_voxels(), mode='mean')
            coors = torch.stack([
                torch.div(vcoors[:, 0], grid[0], rounding_mode='floor'),
                vcoors[:, 0] % grid[0], vcoors[:, 1], vcoors[:, 2]], -1)
            coors = torch.where(vvalid[:, None], coors, -1)
        x = self.pts_middle_encoder(feats, coors, vvalid, b)
        return x[0] if isinstance(x, tuple) else x
