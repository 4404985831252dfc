"""VoteNet: the indoor point detector.

Counterpart of the JAX package's ``models/detectors/votenet.py``
(reference mmdet3d/models/detectors/votenet.py): a PointNet++ backbone
and a ``VoteHead`` over masked fixed-capacity point clouds. ``forward``
takes (points [B, N, 3+F], points_mask [B, N]) and the train step's
``generator`` (unused: no dropout). Module names are mmdet3d's
(``backbone``, ``bbox_head``). The head is built at the backbone's output
width, which flax infers where the config's ``in_channels`` says it.
"""
from __future__ import annotations

from typing import Any, Optional

from torch import nn

from ...registry import BACKBONES, DETECTORS, HEADS
from ...utils.profiling import named_scope


def head_config(cfg, train_cfg, test_cfg, in_channels: Optional[int]):
    """A head's config with the detector's train/test configs and, where
    given, its input width."""
    cfg = dict(cfg)
    cfg['train_cfg'] = dict(train_cfg) if train_cfg else None
    cfg['test_cfg'] = dict(test_cfg) if test_cfg else None
    if in_channels is not None:
        cfg['in_channels'] = in_channels
    return cfg


@DETECTORS.register('VoteNet')
class VoteNet(nn.Module):

    def __init__(self, backbone: Any, bbox_head: Any, train_cfg: Any = None,
                 test_cfg: Any = None, **unused):
        super().__init__()
        del unused
        self.backbone = BACKBONES.build(dict(backbone))
        self.bbox_head = HEADS.build(head_config(
            bbox_head, train_cfg, test_cfg, self.backbone.out_channels))

    def forward(self, points, points_mask, generator=None):
        with named_scope('extract_pts_feat'):
            feat_dict = self.backbone(points, points_mask)
        return self.bbox_head(feat_dict)

    def loss(self, preds, gt_bboxes, gt_labels, gt_valid):
        return self.bbox_head.loss(preds, gt_bboxes, gt_labels, gt_valid)

    def get_bboxes(self, preds):
        return self.bbox_head.get_bboxes(preds)

    def simple_test(self, points, points_mask):
        return self.get_bboxes(self(points, points_mask))
