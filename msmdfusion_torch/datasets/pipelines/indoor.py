"""Indoor and segmentation pipeline transforms (numpy, CPU side).

Counterpart of the JAX package's ``datasets/pipelines/indoor.py``
(reference mmdet3d/datasets/pipelines/transforms_3d.py:
``IndoorPointSample`` :578, ``BackgroundPointsFilter`` :656,
``VoxelBasedPointSampler`` :720; loading.py: ``PointSegClassMapping``
:644, ``NormalizePointsColor`` :691). Points are [N, F] arrays; the
per-point instance and semantic masks ride along under
``pts_instance_mask`` / ``pts_semantic_mask``. The random transforms draw
from the ``rng`` ``Compose`` hands them, in the JAX transforms' order:
a seeded ``RandomState`` gives what ``np.random.seed`` gives the JAX
ones.
"""
from __future__ import annotations

import numpy as np

from ...core.box_np_ops import points_in_rbbox_np
from ...core.voxel_generator import VoxelGenerator
from ...registry import PIPELINES
from .loading import require_rng

MASK_KEYS = ('pts_instance_mask', 'pts_semantic_mask')


@PIPELINES.register('IndoorPointSample')
class IndoorPointSample:
    """A fixed count of points drawn at random (with replacement where the
    cloud has fewer), the masks kept aligned; every point valid."""
    draws = True

    def __init__(self, num_points: int):
        self.num_points = num_points

    def __call__(self, results, rng=None):
        points = results['points']
        n = points.shape[0]
        choices = require_rng(rng, type(self).__name__).choice(
            n, self.num_points, replace=n < self.num_points)
        results['points'] = points[choices]
        results['points_mask'] = np.ones(self.num_points, bool)
        for key in MASK_KEYS:
            if results.get(key) is not None:
                results[key] = results[key][choices]
        return results


@PIPELINES.register('PointSegClassMapping')
class PointSegClassMapping:
    """Raw semantic ids to [0, n_valid), everything else n_valid (a
    lookup table)."""

    def __init__(self, valid_cat_ids):
        self.valid_cat_ids = tuple(int(v) for v in valid_cat_ids)
        self.lut = np.full(max(self.valid_cat_ids) + 2,
                           len(self.valid_cat_ids), np.int64)
        for i, cid in enumerate(self.valid_cat_ids):
            self.lut[cid] = i

    def __call__(self, results):
        mask = np.asarray(results['pts_semantic_mask'], np.int64)
        mapped = self.lut[np.clip(mask, 0, len(self.lut) - 1)]
        results['pts_semantic_mask'] = np.where(
            mask >= len(self.lut), len(self.valid_cat_ids), mapped)
        return results


@PIPELINES.register('NormalizePointsColor')
class NormalizePointsColor:
    """The mean colour / 256 taken from channels 3:6."""

    def __init__(self, color_mean):
        self.color_mean = np.asarray(color_mean, np.float32)

    def __call__(self, results):
        points = results['points']
        if points.shape[1] < 6:
            raise ValueError('NormalizePointsColor needs 6 channels or '
                             f'more, got {points.shape[1]}')
        points[:, 3:6] = points[:, 3:6] - self.color_mean / 256.0
        results['points'] = points
        return results


@PIPELINES.register('BackgroundPointsFilter')
class BackgroundPointsFilter:
    """Drop the points inside an enlarged GT box but outside the box
    itself (boxes [N, 7+] bottom-centre, enlarged about their gravity
    centres)."""

    def __init__(self, bbox_enlarge_range):
        if isinstance(bbox_enlarge_range, (int, float)):
            bbox_enlarge_range = [float(bbox_enlarge_range)] * 3
        self.bbox_enlarge_range = np.asarray(
            bbox_enlarge_range, np.float32)[None, :]

    def __call__(self, results):
        points = results['points']
        boxes = np.asarray(results['gt_bboxes_3d'], np.float32)
        if len(boxes) == 0:
            return results
        boxes = boxes[:, :7].copy()
        boxes[:, 2] += boxes[:, 5] / 2              # gravity centres
        enlarged = boxes.copy()
        enlarged[:, 3:6] += self.bbox_enlarge_range

        def bottom(b):
            b = b.copy()
            b[:, 2] -= b[:, 5] / 2
            return b
        fg = points_in_rbbox_np(points[:, :3], bottom(boxes)).max(1)
        fg_enl = points_in_rbbox_np(points[:, :3], bottom(enlarged)).max(1)
        keep = ~(~fg & fg_enl)
        results['points'] = points[keep]
        for key in MASK_KEYS:
            if results.get(key) is not None:
                results[key] = results[key][keep]
        return results


@PIPELINES.register('VoxelBasedPointSampler')
class VoxelBasedPointSampler:
    """The current and previous sweeps' points each voxel-sampled to a
    fixed count (``VoxelGenerator``, first come first served, after a
    shuffle); the masks ride along as extra channels."""
    draws = True

    def __init__(self, cur_sweep_cfg, prev_sweep_cfg=None, time_dim=3):
        self.cur = VoxelGenerator(**cur_sweep_cfg)
        self.time_dim = time_dim
        if prev_sweep_cfg is not None:
            if prev_sweep_cfg['max_num_points'] != \
                    cur_sweep_cfg['max_num_points']:
                raise ValueError('the sweeps\' max_num_points differ')
            self.prev = VoxelGenerator(**prev_sweep_cfg)
        else:
            self.prev = None

    def _sample(self, points, sampler, dim):
        voxels = sampler.generate(points)[0]
        if voxels.shape[0] < sampler.max_voxels:
            pad = np.zeros((sampler.max_voxels - voxels.shape[0],
                            sampler.max_num_points, dim), points.dtype)
            pad[:] = voxels[0] if len(voxels) else 0
            voxels = np.concatenate([voxels, pad], axis=0)
        return voxels

    def __call__(self, results, rng=None):
        rng = require_rng(rng, type(self).__name__)
        points = results['points']
        original_dim = points.shape[1]
        extra, fields = [points], []
        for key in MASK_KEYS:
            if results.get(key) is not None:
                fields.append((key, original_dim + len(fields)))
                extra.append(np.asarray(results[key], np.float32)[:, None])
        pts = np.concatenate(extra, axis=-1).astype(np.float32)

        cur_flag = pts[:, self.time_dim] == 0
        cur_pts, prev_pts = pts[cur_flag], pts[~cur_flag]
        if prev_pts.shape[0] == 0:
            prev_pts = cur_pts
        rng.shuffle(cur_pts)
        rng.shuffle(prev_pts)

        pts = self._sample(cur_pts, self.cur, pts.shape[1])
        if self.prev is not None:
            pts = np.concatenate(
                [pts, self._sample(prev_pts, self.prev, pts.shape[-1])], 0)
        if self.cur.max_num_points == 1:
            pts = pts.squeeze(1)
        results['points'] = pts[..., :original_dim]
        for key, dim in fields:
            results[key] = pts[..., dim]
        return results
