"""Shape-aware grouping head (SSN).

Counterpart of the JAX package's ``models/heads/shape_aware_head.py``
(reference mmdet3d/models/dense_heads/shape_aware_head.py:11-482): one
sub-head per shape group (``heads.{i}``: a shared 3 x 3 conv stack,
possibly strided, then 1 x 1 class, box and direction branches), each
group's anchors built at its own map's resolution; the flattened
per-anchor predictions of the groups are concatenated, and the
assignment, the losses and the decode run over the concatenated anchor
set (``AnchorHeadMixin``, as ``Anchor3DHead``'s). Channels-first; module
names are the reference's (``heads.{i}.shared_conv.{j}.conv/bn``,
``conv_cls``, ``conv_reg``, ``conv_dir_cls``). The shared convs' norms are
flax ``BatchNorm``s in the JAX head (eps 1e-5, momentum 0.99, i.e. the
torch momentum 0.01); their running variance keeps the torch convention
(unbiased).
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch
from torch import nn

from ...core.anchors import Anchor3DRangeGenerator
from ...registry import ANCHOR_GENERATORS, BBOX_CODERS, HEADS
from ..layers import Conv2d, ConvModule
from .anchor3d_head import AnchorHeadMixin


class BaseShapeHead(nn.Module):
    """One shape group's branch (reference :11-137)."""

    def __init__(self, num_cls: int, num_base_anchors: int,
                 box_code_size: int, in_channels: int,
                 shared_conv_channels: Sequence[int] = (64, 64),
                 shared_conv_strides: Sequence[int] = (1, 1),
                 use_direction_classifier: bool = True):
        super().__init__()
        self.num_cls = num_cls
        self.num_base_anchors = num_base_anchors
        self.box_code_size = box_code_size
        convs = []
        c = in_channels
        for ch, st in zip(shared_conv_channels, shared_conv_strides):
            convs.append(ConvModule(c, ch, 3, stride=st, padding=1,
                                    norm_eps=1e-5, norm_momentum=0.01))
            c = ch
        self.shared_conv = nn.Sequential(*convs)
        a = num_base_anchors
        self.conv_cls = Conv2d(c, a * num_cls, 1)
        nn.init.constant_(self.conv_cls.bias, -4.59512)
        self.conv_reg = Conv2d(c, a * box_code_size, 1)
        self.conv_dir_cls = (Conv2d(c, a * 2, 1) if use_direction_classifier
                             else None)

    def forward(self, x):
        """x [B, C, H, W] -> dict cls_score [B, H*W*A, K], bbox_pred [B,
        H*W*A, code], featmap_size (h, w), dir_cls [B, H*W*A, 2]."""
        x = self.shared_conv(x)
        b, _, h, w = x.shape

        def flat(y, c):
            return y.permute(0, 2, 3, 1).reshape(b, -1, c)
        out = dict(cls_score=flat(self.conv_cls(x), self.num_cls),
                   bbox_pred=flat(self.conv_reg(x), self.box_code_size),
                   featmap_size=(h, w))
        if self.conv_dir_cls is not None:
            out['dir_cls'] = flat(self.conv_dir_cls(x), 2)
        return out


@HEADS.register('ShapeAwareHead')
class ShapeAwareHead(AnchorHeadMixin, nn.Module):
    """Multi-group shape-aware head (reference :139-482)."""

    def __init__(self, tasks: Sequence[Dict] = (), num_classes: int = 3,
                 in_channels: int = 384,
                 use_direction_classifier: bool = True,
                 diff_rad_by_sin: bool = True, dir_offset: float = 0.0,
                 dir_limit_offset: float = 1.0, anchor_generator: Any = None,
                 bbox_coder: Any = None, loss_cls: Any = None,
                 loss_bbox: Any = None, loss_dir: Any = None,
                 train_cfg: Any = None, test_cfg: Any = None):
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
        heads, slices, ptr = [], [], 0
        for task in tasks:
            n_cls = task['num_class']
            num_size = len(self.anchor_gen.sizes[ptr:ptr + n_cls])
            heads.append(BaseShapeHead(
                num_classes, len(self.anchor_gen.rotations) * num_size,
                self.coder.code_size, in_channels,
                tuple(task['shared_conv_channels']),
                tuple(task['shared_conv_strides']),
                use_direction_classifier))
            slices.append((ptr, ptr + n_cls))
            ptr += n_cls
        self.heads = nn.ModuleList(heads)
        self.task_slices = tuple(slices)
        self._anchors: Dict[Any, torch.Tensor] = {}

    def forward(self, x, generator=None):
        results = [head(x) for head in self.heads]
        out = dict(
            cls_score=torch.cat([r['cls_score'] for r in results], 1),
            bbox_pred=torch.cat([r['bbox_pred'] for r in results], 1),
            featmap_sizes=tuple(r['featmap_size'] for r in results))
        if self.use_direction_classifier:
            out['dir_cls'] = torch.cat([r['dir_cls'] for r in results], 1)
        return out

    def task_anchors(self, featmap_sizes, device):
        """The concatenated [M, 7+] anchors, one grid per shape group at
        its map's size (made once a set of sizes)."""
        key = (tuple(featmap_sizes), str(device))
        if key not in self._anchors:
            gen = self.anchor_gen
            anchors = []
            for (lo, hi), fs in zip(self.task_slices, featmap_sizes):
                a = Anchor3DRangeGenerator(
                    ranges=gen.ranges[lo:hi], sizes=gen.sizes[lo:hi],
                    rotations=gen.rotations,
                    custom_values=gen.custom_values).grid_anchors(fs)
                anchors.append(a.reshape(-1, a.shape[-1]))
            self._anchors[key] = torch.from_numpy(
                np.concatenate(anchors)).to(device)
        return self._anchors[key]

    def _flat_preds(self, preds):
        cls = preds['cls_score']
        return (self.task_anchors(preds['featmap_sizes'], cls.device), cls,
                preds['bbox_pred'], preds.get('dir_cls'))

    def loss(self, preds, gt_bboxes, gt_labels, gt_valid):
        """Max-IoU assignment over the concatenated anchors (reference
        :300-406)."""
        return self.anchor_losses(*self._flat_preds(preds), gt_bboxes,
                                  gt_labels, gt_valid)

    def get_bboxes(self, preds):
        return self.anchor_decode(*self._flat_preds(preds))
