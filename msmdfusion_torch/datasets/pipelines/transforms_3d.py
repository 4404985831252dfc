"""3D augmentation transforms (numpy, CPU side).

Counterpart of the flagship's transforms in the JAX package's
``datasets/pipelines/transforms_3d.py`` (reference
mmdet3d/datasets/pipelines/transforms_3d.py): ``GlobalRotScaleTrans``
(:291), ``RandomFlip3D`` (:14), ``PointsRangeFilter``,
``ObjectRangeFilter``, ``ObjectNameFilter`` and ``PointShuffle`` (:440).
The applied-augmentation record (``transformation_3d_flow``) is kept so
the foreground pipeline can replay it (reference
my_loading_multi_proj.py:350-411). The random ones draw from the ``rng``
``Compose`` hands them, in the JAX package's order of draws.

Boxes are plain [N, 9] arrays (x, y, z, w, l, h, yaw, vx, vy) bottom-center
LiDAR convention.
"""
from __future__ import annotations

import numpy as np

from ...registry import PIPELINES
from .loading import require_rng


def _rot_z(points, angle):
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], points.dtype)
    return points @ rot


@PIPELINES.register('GlobalRotScaleTrans')
class GlobalRotScaleTrans:
    draws = True

    def __init__(self, rot_range=(-0.78539816, 0.78539816),
                 scale_ratio_range=(0.95, 1.05),
                 translation_std=(0, 0, 0)):
        self.rot_range = rot_range
        self.scale_ratio_range = scale_ratio_range
        self.translation_std = translation_std

    def __call__(self, results, rng=None):
        rng = require_rng(rng, type(self).__name__)
        angle = rng.uniform(*self.rot_range)
        scale = rng.uniform(*self.scale_ratio_range)
        trans = rng.normal(scale=self.translation_std, size=3).astype(
            np.float32)

        points = results['points']
        points[:, :3] = _rot_z(points[:, :3], angle) * scale + trans
        results['points'] = points

        if 'gt_bboxes_3d' in results and len(results['gt_bboxes_3d']):
            boxes = results['gt_bboxes_3d']
            boxes[:, :3] = _rot_z(boxes[:, :3], angle) * scale + trans
            boxes[:, 3:6] *= scale
            boxes[:, 6] += angle
            if boxes.shape[1] > 7:
                boxes[:, 7:9] = _rot_z(
                    np.concatenate([boxes[:, 7:9],
                                    np.zeros((len(boxes), 1),
                                             boxes.dtype)], 1), angle)[:, :2]
                boxes[:, 7:9] *= scale
            results['gt_bboxes_3d'] = boxes

        results.setdefault('transformation_3d_flow', []).append(
            ('GRT', dict(angle=angle, scale=scale, trans=trans)))
        results['pcd_rotation'] = angle
        results['pcd_scale_factor'] = scale
        results['pcd_trans'] = trans
        return results


@PIPELINES.register('RandomFlip3D')
class RandomFlip3D:
    draws = True

    def __init__(self, sync_2d=True, flip_ratio_bev_horizontal=0.0,
                 flip_ratio_bev_vertical=0.0, **kwargs):
        self.flip_ratio_bev_horizontal = flip_ratio_bev_horizontal
        self.flip_ratio_bev_vertical = flip_ratio_bev_vertical
        self.sync_2d = sync_2d

    def _flip(self, results, direction):
        points = results['points']
        boxes = results.get('gt_bboxes_3d')
        if direction == 'horizontal':     # flip y
            points[:, 1] = -points[:, 1]
            if boxes is not None and len(boxes):
                boxes[:, 1] = -boxes[:, 1]
                boxes[:, 6] = -boxes[:, 6]
                if boxes.shape[1] > 8:
                    boxes[:, 8] = -boxes[:, 8]
        else:                             # vertical: flip x
            points[:, 0] = -points[:, 0]
            if boxes is not None and len(boxes):
                boxes[:, 0] = -boxes[:, 0]
                boxes[:, 6] = -boxes[:, 6] + np.pi
                if boxes.shape[1] > 7:
                    boxes[:, 7] = -boxes[:, 7]
        results['points'] = points
        if boxes is not None:
            results['gt_bboxes_3d'] = boxes

    def __call__(self, results, rng=None):
        rng = require_rng(rng, type(self).__name__)
        flip_h = rng.rand() < self.flip_ratio_bev_horizontal
        flip_v = rng.rand() < self.flip_ratio_bev_vertical
        if flip_h:
            self._flip(results, 'horizontal')
        if flip_v:
            self._flip(results, 'vertical')
        results['pcd_horizontal_flip'] = flip_h
        results['pcd_vertical_flip'] = flip_v
        results.setdefault('transformation_3d_flow', []).append(
            ('flip', dict(horizontal=flip_h, vertical=flip_v)))
        return results


@PIPELINES.register('PointsRangeFilter')
class PointsRangeFilter:
    def __init__(self, point_cloud_range):
        self.pcr = np.asarray(point_cloud_range, np.float32)

    def __call__(self, results):
        p = results['points']
        m = np.all((p[:, :3] >= self.pcr[:3]) & (p[:, :3] <= self.pcr[3:]),
                   axis=1)
        results['points'] = p[m]
        return results


@PIPELINES.register('ObjectRangeFilter')
class ObjectRangeFilter:
    def __init__(self, point_cloud_range):
        self.bev_range = np.asarray(point_cloud_range, np.float32)[
            [0, 1, 3, 4]]

    def __call__(self, results):
        boxes = results.get('gt_bboxes_3d')
        if boxes is None or not len(boxes):
            return results
        m = ((boxes[:, 0] > self.bev_range[0]) &
             (boxes[:, 1] > self.bev_range[1]) &
             (boxes[:, 0] < self.bev_range[2]) &
             (boxes[:, 1] < self.bev_range[3]))
        results['gt_bboxes_3d'] = boxes[m]
        results['gt_labels_3d'] = results['gt_labels_3d'][m]
        return results


@PIPELINES.register('ObjectNameFilter')
class ObjectNameFilter:
    def __init__(self, classes):
        self.classes = classes

    def __call__(self, results):
        labels = results.get('gt_labels_3d')
        if labels is None:
            return results
        m = (labels >= 0) & (labels < len(self.classes))
        results['gt_bboxes_3d'] = results['gt_bboxes_3d'][m]
        results['gt_labels_3d'] = labels[m]
        return results


@PIPELINES.register('PointShuffle')
class PointShuffle:
    draws = True

    def __call__(self, results, rng=None):
        idx = require_rng(rng, type(self).__name__).permutation(
            len(results['points']))
        results['points'] = results['points'][idx]
        return results
