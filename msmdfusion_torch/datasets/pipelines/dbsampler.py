"""GT-database copy-paste sampler.

Counterpart of the JAX package's ``datasets/pipelines/dbsampler.py``
(reference mmdet3d/datasets/pipelines/dbsampler.py:12-316,
``BatchSampler`` + ``DataBaseSampler``): class-balanced sampling of
pre-cropped GT point clusters with BEV-collision rejection.

Each call draws from the generator it is given (the loader seeds one per
sample) and keeps no state between calls, so a sample's pastes do not
depend on which worker process runs it or on the samples before it. A
call does what a freshly built JAX sampler does on its first call: each
class's list shuffled in ``sample_groups`` order, then ``sample``. The
JAX sampler instead walks each class's shuffled list across calls, so it
samples without replacement over an epoch; here every sample starts from
a fresh shuffle.
"""
from __future__ import annotations

import os
import pickle

import numpy as np

from ...core.box_np_ops import corners_bev_np


class BatchSampler:
    """One class's db infos in a shuffled order, drawn from ``rng``; the
    JAX sampler's first ``sample`` call (a reshuffle, drawn, when the list
    runs out)."""

    def __init__(self, sampled_list, rng, name=None, shuffle=True):
        self._sampled_list = sampled_list
        self._indices = np.arange(len(sampled_list))
        self._rng = rng
        if shuffle:
            rng.shuffle(self._indices)
        self._idx = 0
        self._name = name
        self._shuffle = shuffle

    def sample(self, num):
        if self._idx + num >= len(self._sampled_list):
            ret = self._indices[self._idx:].copy()
            self._reset()
        else:
            ret = self._indices[self._idx:self._idx + num]
            self._idx += num
        return [self._sampled_list[i] for i in ret]

    def _reset(self):
        if self._shuffle:
            self._rng.shuffle(self._indices)
        self._idx = 0


def _bev_overlap_any(boxes_a, boxes_b):
    """Conservative rotated-BEV collision test via corner AABBs + SAT."""
    if len(boxes_a) == 0 or len(boxes_b) == 0:
        return np.zeros((len(boxes_a),), bool)
    ca = corners_bev_np(np.concatenate(
        [boxes_a[:, 0:2], boxes_a[:, 3:5], boxes_a[:, 6:7]], 1))
    cb = corners_bev_np(np.concatenate(
        [boxes_b[:, 0:2], boxes_b[:, 3:5], boxes_b[:, 6:7]], 1))
    hit = np.zeros((len(boxes_a),), bool)
    for j in range(len(boxes_b)):
        # separating-axis test over both rectangles' edge normals
        edges = np.concatenate([np.roll(ca, -1, 1) - ca,
                                np.broadcast_to(
                                    np.roll(cb[j:j + 1], -1, 1) - cb[j:j + 1],
                                    ca.shape)], axis=1)  # [N, 8, 2]
        normals = np.stack([-edges[..., 1], edges[..., 0]], axis=-1)
        norm = np.linalg.norm(normals, axis=-1, keepdims=True)
        normals = normals / np.maximum(norm, 1e-9)
        pa = np.einsum('nij,nmj->nim', ca, normals)       # [N, 4, 8]
        pb = np.einsum('ij,nmj->nim', cb[j], normals)     # [N, 4, 8]
        sep = (pa.max(1) < pb.min(1)) | (pb.max(1) < pa.min(1))  # [N, 8]
        hit |= ~sep.any(axis=1)
    return hit


class DataBaseSampler:
    """The GT database (``create_data``'s ``*_dbinfos_train.pkl``) with the
    ``prepare`` filters applied, sampled per call by ``sample_all``."""

    def __init__(self, info_path, data_root, rate, prepare, sample_groups,
                 classes=None, points_loader=None, load_dim=5):
        self.data_root = data_root
        self.rate = rate
        self.load_dim = (points_loader or {}).get('load_dim', load_dim) \
            if isinstance(points_loader, dict) else load_dim
        self.classes = classes
        self.cat2label = {c: i for i, c in enumerate(classes or [])}
        with open(info_path, 'rb') as f:
            db_infos = pickle.load(f)
        for prep_key, prep_val in (prepare or {}).items():
            if prep_key == 'filter_by_difficulty':
                db_infos = {
                    k: [x for x in v if x.get('difficulty', 0) not in
                        prep_val] for k, v in db_infos.items()}
            elif prep_key == 'filter_by_min_points':
                db_infos = {
                    k: [x for x in v if x.get('num_points_in_gt', 1e9) >=
                        int(prep_val.get(k, 0))] if k in prep_val else v
                    for k, v in db_infos.items()}
        self.db_infos = db_infos
        self.sample_groups = {}
        for group in sample_groups if isinstance(sample_groups, list) \
                else [sample_groups]:
            for name, num in group.items():
                self.sample_groups[name] = int(num)

    def sample_all(self, gt_bboxes, gt_labels, rng):
        """Pasted boxes, labels and points for a sample with GT
        ``gt_bboxes``/``gt_labels`` (None if nothing is pasted), drawn
        from ``rng``: candidates that collide in BEV with a GT box or an
        earlier paste are left out."""
        samplers = {name: BatchSampler(self.db_infos.get(name, []), rng,
                                       name)
                    for name in self.sample_groups}
        sampled_boxes, sampled_labels, sampled_points = [], [], []
        avoid = gt_bboxes.copy() if len(gt_bboxes) else \
            np.zeros((0, 9), np.float32)
        for name, max_num in self.sample_groups.items():
            label = self.cat2label.get(name, -1)
            num_existing = int((gt_labels == label).sum()) \
                if len(gt_labels) else 0
            num = max(0, max_num - num_existing)
            if num <= 0 or not len(samplers[name]._sampled_list):
                continue
            candidates = samplers[name].sample(num)
            for info in candidates:
                box = np.asarray(info['box3d_lidar'], np.float32)[None]
                if box.shape[1] < avoid.shape[1]:
                    box = np.concatenate(
                        [box, np.zeros((1, avoid.shape[1] - box.shape[1]),
                                       np.float32)], axis=1)
                if _bev_overlap_any(box, avoid).any():
                    continue
                path = os.path.join(self.data_root, info['path'])
                try:
                    pts = np.fromfile(path, dtype=np.float32).reshape(
                        -1, self.load_dim)
                except (FileNotFoundError, ValueError):
                    continue
                pts = pts.copy()
                pts[:, :3] += box[0, :3]
                sampled_boxes.append(box[0])
                sampled_labels.append(label)
                sampled_points.append(pts)
                avoid = np.concatenate([avoid, box])
        if not sampled_boxes:
            return None
        return dict(
            gt_bboxes_3d=np.stack(sampled_boxes),
            gt_labels_3d=np.asarray(sampled_labels, np.int64),
            points=np.concatenate(sampled_points)
            if sampled_points else np.zeros((0, 5), np.float32))
