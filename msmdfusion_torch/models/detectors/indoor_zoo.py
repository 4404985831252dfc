"""The indoor and fusion detector zoo: SSD3DNet, H3DNet, ImVoteNet and
MVXFasterRCNN.

Counterpart of the JAX package's ``models/detectors/indoor_zoo.py``
(reference mmdet3d/models/detectors/{ssd3dnet,h3dnet,imvotenet,
mvx_faster_rcnn,mvx_two_stage}.py).

``SSD3DNet`` is VoteNet's assembly with the multi-scale PointNet++ and
``SSD3DHead``. ``H3DNet``: one backbone (the JAX package's
simplification of the reference's four towers) feeds a ``VoteHead``
(``rpn_head``, the initial proposals), three ``PrimitiveHead``s
(``roi_head.primitive_{z,xy,line}``) and an ``H3DBboxHead``
(``roi_head.bbox_head``) that refines the decoded proposals against the
predicted primitives; its decode scores them by the VoteHead's score
times the refined objectness.

``ImVoteNet``: VoteNet with image features at the seeds, by either of
the JAX detector's paths. With 2-D detections (``metas['bboxes_2d']``,
``bbox_valid``, ``depth2img``: [B, 4, 4], or dict(K=[B, 4, 4], Rt=[B, 3,
3])) each sample's ``VoteFusion`` cues (img [B, H, W, 3] or its first
view of [B, V, H, W, 3]) are averaged over each seed's valid votes and
projected (``cue_proj``); without them the images run through the
ResNet and FPN (in eval mode, as the JAX detector calls them), each seed
takes the finest map's feature at its projection (nearest, summed over
the views that see it; ``metas['lidar2img']`` [B, V, 4, 4]) and
``img_proj`` maps it. Either way 128 channels join the seed features, so
the head is built 128 wider than the backbone's output (flax infers the
width: the JAX head is then 384 wide at the configs' widths). Called
without images, or without 2-D detections and an image backbone, it
raises: its head reads the image channels.

``MVXFasterRCNN``: the voxel detector whose voxels are decorated with
image features (PointFusion) before the middle encoder (reference
mvx_two_stage.py:18-541). Hard voxelization and the voxel encoder give
each voxel its features; with images the views run through the ResNet
and the FPN (in eval mode), each sample's voxel centres are fused once
with that sample's views and projections, and each voxel row takes its
own sample's fusion by its batch id; then the middle encoder, SECOND,
SECONDFPN and the head. With a fusion layer configured the voxel
features reaching the middle encoder are ``PointFusion``'s
(``mid_channels``, or ``out_channels`` with ``fuse_out``), whatever the
config's ``in_channels`` says: the JAX detector's flax layers take their
widths from their inputs when initialised with images. So the middle
encoder's ``in_channels`` is set to that width (and, for
``PointPillarsScatter``, whose output width is its input's, the
backbone's too), and the model must be called with images: called
without them it raises, where the JAX detector would need a second set
of parameters (initialised without images). The image layout is
TransFusion-LC's: img [B, V, H, W, 3], metas dict(lidar2img [B, V, 4,
4]). Module names are mmdet3d's (``pts_voxel_encoder``,
``pts_middle_encoder``, ``pts_fusion_layer``, ``pts_backbone``,
``pts_neck``, ``pts_bbox_head``, ``img_backbone``, ``img_neck``).
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
from ..fusion_layers import VoteFusion, project_points_to_image
from ..layers import MLP
from .votenet import VoteNet, head_config

CUE_WIDTH = 128     # the image channels ImVoteNet adds to each seed


class FrozenImageBranch(nn.Module):
    """A detector whose ``img_backbone``/``img_neck`` stay in eval mode
    (the JAX detectors call them with ``train=False``); their parameters
    still take gradients."""

    def train(self, mode: bool = True):
        super().train(mode)
        for m in (self.img_backbone, self.img_neck):
            if m is not None:
                m.eval()
        return self


@DETECTORS.register('SSD3DNet')
class SSD3DNet(VoteNet):
    """3DSSD: ``PointNet2SAMSG`` and ``SSD3DHead`` in VoteNet's assembly."""


@DETECTORS.register('H3DNet')
class H3DNet(nn.Module):

    def __init__(self, backbone: Any, bbox_head: Any,
                 primitive_list: Any = None, refine_head: Any = None,
                 train_cfg: Any = None, test_cfg: Any = None, **unused):
        super().__init__()
        del unused
        self.backbone = BACKBONES.build(dict(backbone))
        width = self.backbone.out_channels
        self.rpn_head = HEADS.build(head_config(bbox_head, train_cfg,
                                                test_cfg, width))
        prims = primitive_list or [dict(type='PrimitiveHead',
                                        primitive_mode=m)
                                   for m in ('z', 'xy', 'line')]
        roi = nn.ModuleDict()
        for cfg in prims:
            head = HEADS.build(dict(cfg, feat_channels=width))
            roi[f'primitive_{head.primitive_mode}'] = head
        roi['bbox_head'] = HEADS.build(dict(
            refine_head or dict(type='H3DBboxHead'), feat_channels=width))
        self.roi_head = roi

    def primitive_heads(self):
        return [m for k, m in self.roi_head.items() if k != 'bbox_head']

    def forward(self, points, points_mask, generator=None):
        with named_scope('extract_pts_feat'):
            feat_dict = self.backbone(points, points_mask)
        vote_preds = self.rpn_head(feat_dict)
        with section('primitives'):
            primitives = {}
            for head in self.primitive_heads():
                primitives.update(head(feat_dict))
        proposals = self.rpn_head.get_bboxes(vote_preds)
        with section('refine'):
            refine = self.roi_head['bbox_head'](proposals, primitives)
        return dict(vote=vote_preds, primitives=primitives, refine=refine)

    def loss(self, preds, gt_bboxes, gt_labels, gt_valid):
        losses = self.rpn_head.loss(preds['vote'], gt_bboxes, gt_labels,
                                    gt_valid)
        for head in self.primitive_heads():
            losses.update(head.loss(preds['primitives'], gt_bboxes,
                                    gt_valid))
        losses.update(self.roi_head['bbox_head'].loss(
            preds['refine'], gt_bboxes, gt_labels, gt_valid))
        return losses

    def get_bboxes(self, preds):
        out = self.rpn_head.get_bboxes(preds['vote'])
        refine = preds['refine']
        with section('decode'):
            obj = torch.softmax(refine['refine_obj'], -1)[..., 1]
            return dict(bboxes=refine['refined_bboxes'],
                        scores=out['scores'] * obj, labels=out['labels'],
                        valid=refine['refine_valid'])

    def simple_test(self, points, points_mask):
        return self.get_bboxes(self(points, points_mask))


def image_width(img_backbone, img_neck) -> int:
    """The width of the finest image map ImVoteNet reads."""
    if img_neck:
        return dict(img_neck).get('out_channels', 256)
    cfg = dict(img_backbone)
    first = tuple(cfg.get('out_indices', (0, 1, 2, 3)))[0]
    return 64 * 2 ** first * (4 if cfg.get('depth', 50) >= 50 else 1)


@DETECTORS.register('ImVoteNet')
class ImVoteNet(FrozenImageBranch):

    def __init__(self, backbone: Any, bbox_head: Any,
                 img_backbone: Any = None, img_neck: Any = None,
                 train_cfg: Any = None, test_cfg: Any = None, **unused):
        super().__init__()
        del unused
        self.backbone = BACKBONES.build(dict(backbone))
        num_classes = int(dict(bbox_head).get('num_classes', 10))
        self.img_backbone = (BACKBONES.build(dict(img_backbone))
                             if img_backbone else None)
        self.img_neck = NECKS.build(dict(img_neck)) if img_neck else None
        if self.img_backbone is not None:
            self.img_proj = MLP(image_width(img_backbone, img_neck),
                                (CUE_WIDTH,), final_act=True)
        self.vote_fusion = VoteFusion(num_classes=num_classes,
                                      max_imvote_per_pixel=3)
        self.cue_proj = MLP(5 + num_classes + 3, (CUE_WIDTH,),
                            final_act=True)
        self.bbox_head = HEADS.build(head_config(
            bbox_head, train_cfg, test_cfg,
            self.backbone.out_channels + CUE_WIDTH))

    def vote_cues(self, img, metas, seeds):
        """[B, S, 128]: each seed's VoteFusion cues averaged over its
        valid votes, projected."""
        b, s = seeds.shape[:2]
        k = self.vote_fusion.max_imvote_per_pixel
        d2i = metas['depth2img']
        pooled = []
        for i in range(b):
            image = img[i, 0] if img.dim() == 5 else img[i]
            cam = ({key: v[i] for key, v in d2i.items()}
                   if isinstance(d2i, dict) else d2i[i])
            cues, mask = self.vote_fusion(
                image, metas['bboxes_2d'][i], metas['bbox_valid'][i],
                seeds[i], cam, (img.shape[-3], img.shape[-2]))
            per_seed = cues.t().reshape(k, s, -1)
            m = mask.reshape(k, s, 1).to(per_seed.dtype)
            pooled.append((per_seed * m).sum(0) /
                          torch.clamp(m.sum(0), min=1))
        return self.cue_proj(torch.stack(pooled))

    def image_features(self, img, metas, seeds):
        """[B, S, 128]: the finest image map's feature at each seed's
        projection (nearest; summed over the views that see it),
        projected."""
        b, v, h, w, c = img.shape
        x = img.reshape(b * v, h, w, c).permute(0, 3, 1, 2).contiguous()
        feats = self.img_backbone(x)
        if self.img_neck is not None:
            feats = self.img_neck(feats)
        lvl = feats[0].reshape(b, v, *feats[0].shape[1:])   # [B, V, C, h, w]
        fh, fw = lvl.shape[-2:]
        scale = fw / w
        out = []
        for i in range(b):
            acc = 0.0
            for j in range(v):
                uv, ok = project_points_to_image(
                    seeds[i], metas['lidar2img'][i, j], (h, w))
                ui = torch.clamp((uv[:, 0] * scale).to(torch.int64), 0,
                                 fw - 1)
                vi = torch.clamp((uv[:, 1] * scale).to(torch.int64), 0,
                                 fh - 1)
                acc = acc + torch.where(ok[:, None],
                                        lvl[i, j][:, vi, ui].t(), 0.0)
            out.append(acc)
        return self.img_proj(torch.stack(out))

    def forward(self, points, points_mask, img=None, metas=None,
                generator=None):
        """points [B, N, 3+F], points_mask [B, N], img and metas as the
        module's doc says -> the VoteHead's predictions."""
        with named_scope('extract_pts_feat'):
            feat_dict = self.backbone(points, points_mask)
        metas = metas or {}
        seeds = feat_dict['fp_xyz']
        with section('img'):
            if img is not None and 'bboxes_2d' in metas:
                extra = self.vote_cues(img, metas, seeds)
            elif img is not None and self.img_backbone is not None:
                extra = self.image_features(img, metas, seeds)
            else:
                raise ValueError(
                    'ImVoteNet takes images with 2-D detections (metas '
                    'bboxes_2d, bbox_valid, depth2img) or, with an image '
                    'backbone, with lidar2img: its head reads '
                    f'{self.backbone.out_channels} + {CUE_WIDTH} channels')
        feat_dict = dict(feat_dict, fp_features=torch.cat(
            [feat_dict['fp_features'], extra], -1))
        return self.bbox_head(feat_dict)

    def loss(self, preds, gt_bboxes, gt_labels, gt_valid):
        return self.bbox_head.loss(preds, gt_bboxes, gt_labels, gt_valid)

    def get_bboxes(self, preds):
        return self.bbox_head.get_bboxes(preds)


@DETECTORS.register('MVXFasterRCNN')
class MVXFasterRCNN(FrozenImageBranch):

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
