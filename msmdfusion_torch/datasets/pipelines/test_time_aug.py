"""Test-time augmentation: the augmented views of a sample and the merge
of their detections.

Counterpart of the JAX package's ``datasets/pipelines/test_time_aug.py``
(reference mmdet3d/datasets/pipelines/test_time_aug.py:10-122 and
core/post_processing/merge_augs.py:91): ``MultiScaleFlipAug3D`` makes one
sample per (scale, horizontal flip, vertical flip), each through the
inner transforms (one view returns that sample, several
``{'aug_samples': [...]}``); ``merge_aug_bboxes_3d`` undoes each view's
flips and scale on its boxes, concatenates them and keeps the union's
boxes by circle NMS (radius 0.3 m, at most ``max_num``), with the port's
``core/nms.circle_nms``. Each view's record is dict(scale, flip_h,
flip_v).
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ...registry import PIPELINES
from .loading import Compose


@PIPELINES.register('MultiScaleFlipAug3D')
class MultiScaleFlipAug3D:

    def __init__(self, transforms, img_scale=None, pts_scale_ratio=1,
                 flip=False, flip_direction='horizontal',
                 pcd_horizontal_flip=False, pcd_vertical_flip=False):
        self.transforms = Compose(transforms)
        self.img_scale = img_scale
        self.pts_scale_ratio = (pts_scale_ratio if isinstance(
            pts_scale_ratio, (list, tuple)) else [pts_scale_ratio])
        self.flip = flip
        self.pcd_horizontal_flip = pcd_horizontal_flip
        self.pcd_vertical_flip = pcd_vertical_flip

    def __call__(self, results):
        aug_samples = []
        flip_h_opts = [False, True] if (self.flip and
                                        self.pcd_horizontal_flip) else [False]
        flip_v_opts = [False, True] if (self.flip and
                                        self.pcd_vertical_flip) else [False]
        for scale in self.pts_scale_ratio:
            for fh in flip_h_opts:
                for fv in flip_v_opts:
                    sample = {k: (v.copy() if isinstance(v, np.ndarray)
                                  else v) for k, v in results.items()}
                    pts = sample['points'].copy()
                    pts[:, :3] *= scale
                    if fh:
                        pts[:, 1] = -pts[:, 1]
                    if fv:
                        pts[:, 0] = -pts[:, 0]
                    sample['points'] = pts
                    sample['aug_state'] = dict(scale=scale, flip_h=fh,
                                               flip_v=fv)
                    out = self.transforms(sample)
                    if out is not None:
                        aug_samples.append(out)
        if len(aug_samples) == 1:
            return aug_samples[0]
        return {'aug_samples': aug_samples}


def merge_aug_bboxes_3d(aug_results: List[Dict[str, np.ndarray]],
                        aug_states: List[Dict[str, Any]],
                        max_num: int = 500, nms_radius: float = 0.3):
    """Per-view dicts of 'bboxes' [N, D], 'scores', 'labels' (numpy) and
    their records -> the merged dict: each view's flips and scale undone
    (the yaw and the velocity flipped with their axis), concatenated, the
    circle-NMS keep set in score order."""
    from ...core.nms import circle_nms

    boxes_all, scores_all, labels_all = [], [], []
    for res, state in zip(aug_results, aug_states):
        boxes = np.asarray(res['bboxes']).copy()
        if state.get('flip_h'):
            boxes[:, 1] = -boxes[:, 1]
            boxes[:, 6] = -boxes[:, 6]
            if boxes.shape[1] > 8:
                boxes[:, 8] = -boxes[:, 8]
        if state.get('flip_v'):
            boxes[:, 0] = -boxes[:, 0]
            boxes[:, 6] = -boxes[:, 6] + np.pi
            if boxes.shape[1] > 7:
                boxes[:, 7] = -boxes[:, 7]
        boxes[:, :6] /= state.get('scale', 1.0)
        boxes_all.append(boxes)
        scores_all.append(np.asarray(res['scores']))
        labels_all.append(np.asarray(res['labels']))
    boxes = np.concatenate(boxes_all)
    scores = np.concatenate(scores_all)
    labels = np.concatenate(labels_all)
    keep, order = circle_nms(torch.from_numpy(np.ascontiguousarray(
        boxes[:, :2])), torch.from_numpy(scores), nms_radius,
        post_max_size=max_num)
    sel = order.numpy()[keep.numpy()]
    return dict(bboxes=boxes[sel], scores=scores[sel], labels=labels[sel])
