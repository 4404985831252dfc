"""3D augmentation transforms (numpy, CPU side).

Counterpart of the flagship's transforms in the JAX package's
``datasets/pipelines/transforms_3d.py`` (reference
mmdet3d/datasets/pipelines/transforms_3d.py): ``GlobalRotScaleTrans``
(:291), ``RandomFlip3D`` (:14), ``PointsRangeFilter``,
``ObjectRangeFilter``, ``ObjectNameFilter`` and ``PointShuffle`` (:440);
the GT paste of TransFusion-L's stage-1 recipe, ``ObjectSample`` (:122,
with its ``stop_epoch`` fade), and the per-object jitter ``ObjectNoise``.
The applied-augmentation record (``transformation_3d_flow``) is kept so
the foreground pipeline can replay it (reference
my_loading_multi_proj.py:350-411). The random ones draw from the ``rng``
``Compose`` hands them, in the JAX package's order of draws.

Boxes are plain [N, 9] arrays (x, y, z, w, l, h, yaw, vx, vy) bottom-center
LiDAR convention.
"""
from __future__ import annotations

import numpy as np

from ...core.box_np_ops import points_in_rbbox_np
from ...registry import PIPELINES
from .aug_utils import noise_per_object_v3
from .dbsampler import DataBaseSampler
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
                 translation_std=(0, 0, 0), shift_height=False):
        self.rot_range = rot_range
        self.scale_ratio_range = scale_ratio_range
        self.translation_std = translation_std
        self.shift_height = shift_height

    def __call__(self, results, rng=None):
        rng = require_rng(rng, type(self).__name__)
        angle = rng.uniform(*self.rot_range)
        scale = rng.uniform(*self.scale_ratio_range)
        trans = rng.normal(scale=self.translation_std, size=3).astype(
            np.float32)

        points = results['points']
        points[:, :3] = _rot_z(points[:, :3], angle) * scale + trans
        if self.shift_height and points.shape[1] > 3:
            # the indoor height channel is a z offset: it scales, and
            # neither turns nor moves
            points[:, 3] *= scale
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


@PIPELINES.register('ObjectSample')
class ObjectSample:
    """GT-paste augmentation from a pre-built GT database (``dbsampler``),
    the pasted boxes' points put in place of the frame's points inside
    them. Reference transforms_3d.py:122 + dbsampler.py:12-316.

    ``stop_epoch``: the "fade", no paste from that epoch on (reference
    configs/nuscenes.md:7: stage 1 trains its last epochs on the true data
    distribution); the dataset's ``set_epoch`` sets the epoch, which the
    loader does in each worker for every sample. ``results['gt_paste']``
    records the pasted (objects, points), zeros where nothing was pasted
    (``FormatBundle3D`` keeps it in the metas)."""
    draws = True

    def __init__(self, db_sampler, sample_2d=False, stop_epoch=None):
        if isinstance(db_sampler, dict):
            db_sampler = DataBaseSampler(**{k: v for k, v in
                                            db_sampler.items()
                                            if k != 'type'})
        self.db_sampler = db_sampler
        self.stop_epoch = stop_epoch
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __call__(self, results, rng=None):
        results['gt_paste'] = np.zeros(2, np.int64)
        if self.stop_epoch is not None and self.epoch >= self.stop_epoch:
            return results
        sampled = self.db_sampler.sample_all(
            results['gt_bboxes_3d'], results['gt_labels_3d'],
            require_rng(rng, type(self).__name__))
        if sampled is None:
            return results
        results['gt_bboxes_3d'] = np.concatenate(
            [results['gt_bboxes_3d'], sampled['gt_bboxes_3d']])
        results['gt_labels_3d'] = np.concatenate(
            [results['gt_labels_3d'], sampled['gt_labels_3d']])
        # remove original points inside sampled boxes, then paste
        pts = results['points']
        inside = points_in_rbbox_np(pts[:, :3], sampled['gt_bboxes_3d'])
        pts = pts[~inside.any(axis=1)]
        sp = sampled['points']
        if sp.shape[1] < pts.shape[1]:
            sp = np.concatenate(
                [sp, np.zeros((len(sp), pts.shape[1] - sp.shape[1]),
                              sp.dtype)], axis=1)
        results['points'] = np.concatenate([sp[:, :pts.shape[1]], pts])
        results['gt_paste'] = np.array(
            [len(sampled['gt_bboxes_3d']), len(sp)], np.int64)
        return results


@PIPELINES.register('ObjectNoise')
class ObjectNoise:
    """Collision-gated per-object jitter (reference ObjectNoise,
    transforms_3d.py + noise_per_object_v3_ in data_augment_utils.py:328):
    each box tries up to ``num_try`` (translation, rotation) noises and
    keeps the first one whose jittered footprint collides with no other
    current box footprint; points inside the box move with it."""
    draws = True

    def __init__(self, translation_std=(0.25, 0.25, 0.25),
                 global_rot_range=(0.0, 0.0), rot_range=(-0.15707, 0.15707),
                 num_try=100):
        self.translation_std = translation_std
        self.global_rot_range = global_rot_range
        self.rot_range = rot_range
        self.num_try = num_try

    def __call__(self, results, rng=None):
        rng = require_rng(rng, type(self).__name__)
        boxes = results.get('gt_bboxes_3d')
        if boxes is None or not len(boxes):
            return results
        pts = results['points']
        noise_per_object_v3(
            boxes, pts, rotation_perturb=list(self.rot_range),
            center_noise_std=list(self.translation_std),
            global_random_rot_range=list(self.global_rot_range),
            num_try=self.num_try, rng=rng)
        results['points'] = pts
        results['gt_bboxes_3d'] = boxes
        return results
