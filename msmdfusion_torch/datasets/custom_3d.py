"""Base dataset: info-pkl backed, pipeline-composed.

Counterpart of the JAX package's ``datasets/custom_3d.py`` (reference
mmdet3d/datasets/custom_3d.py:1-308 and dataset_wrappers.py:7-75):
``Custom3DDataset`` loads an info pickle and runs the numpy pipeline per
index; ``CBGSDataset`` duplicates indices so every class is about equally
represented. ``sample(index, rng)`` takes the generator the pipeline's
random transforms draw from (the loader seeds one per sample); numpy's
global generator is never read.
"""
from __future__ import annotations

import pickle
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..registry import DATASETS
from .pipelines.loading import Compose, require_rng


@DATASETS.register('Custom3DDataset')
class Custom3DDataset:
    CLASSES: Sequence[str] = ()

    def __init__(self, data_root, ann_file, pipeline=None, classes=None,
                 modality=None, box_type_3d='LiDAR', filter_empty_gt=True,
                 test_mode=False, **kwargs):
        self.data_root = data_root
        self.ann_file = ann_file
        self.test_mode = test_mode
        self.modality = modality or {}
        self.filter_empty_gt = filter_empty_gt
        self.CLASSES = classes or self.CLASSES
        self.cat2id = {name: i for i, name in enumerate(self.CLASSES)}
        self.data_infos = self.load_annotations(ann_file)
        self.pipeline = Compose(pipeline) if pipeline else None

    def load_annotations(self, ann_file):
        # the info file is the dataset's own (create_data's output)
        with open(ann_file, 'rb') as f:
            data = pickle.load(f)
        if isinstance(data, dict) and 'infos' in data:
            infos = data['infos']
            self.metadata = data.get('metadata', {})
        else:
            infos = data
            self.metadata = {}
        return list(sorted(infos, key=lambda e: e.get('timestamp', 0)))

    def get_data_info(self, index) -> Dict[str, Any]:
        raise NotImplementedError

    def get_ann_info(self, index) -> Dict[str, Any]:
        raise NotImplementedError

    def get_cat_ids(self, index) -> List[int]:
        """Category ids present in a sample (CBGS hook)."""
        ann = self.get_ann_info(index)
        return list(np.unique(ann['gt_labels_3d'][
            ann['gt_labels_3d'] >= 0]).astype(int))

    def show(self, results, out_dir, show=True, load_dim=4):
        """Per-sample visualization artifacts: BEV PNG + OBJ wireframes +
        the interactive WebGL viewer (``core.visualizer.show_result``; in
        place of the reference's open3d windows, kitti_dataset.py:673 /
        nuscenes_dataset.py:479 / lyft_dataset.py:401 ``show``).
        ``results[i]`` holds 'bboxes' (or reference-style 'boxes_3d')."""
        import os

        from ..core.visualizer import show_result
        outputs = []
        for i, result in enumerate(results):
            info = self.get_data_info(i)
            pts_file = info.get('pts_filename', '')
            name = os.path.split(pts_file)[-1].split('.')[0] or f'sample{i}'
            points = None
            if pts_file and os.path.exists(pts_file):
                points = np.fromfile(pts_file,
                                     np.float32).reshape(-1, load_dim)
            try:
                gt = self.get_ann_info(i)['gt_bboxes_3d']
            except (KeyError, NotImplementedError, IndexError):
                gt = None
            pred = np.asarray(result.get('bboxes',
                                         result.get('boxes_3d', [])))
            outputs += show_result(points, gt, pred, out_dir, name)
        return outputs

    def set_epoch(self, epoch: int):
        """Forward the epoch to the pipeline's transforms that fade with
        it (``ObjectSample``'s ``stop_epoch``)."""
        if self.pipeline is not None:
            for t in self.pipeline.transforms:
                if hasattr(t, 'set_epoch'):
                    t.set_epoch(epoch)

    def __len__(self):
        return len(self.data_infos)

    def prepare_data(self, index, rng=None):
        results = self.get_data_info(index)
        if results is None:
            return None
        if not self.test_mode:
            results['ann_info'] = self.get_ann_info(index)
        if self.pipeline is None:
            return results
        return self.pipeline(results, rng)

    def sample(self, index: int,
               rng: Optional[np.random.RandomState] = None):
        """The pipeline's output for ``index``; in training a sample the
        pipeline drops is replaced by a random one, drawn from ``rng``."""
        if self.test_mode:
            return self.prepare_data(index, rng)
        while True:
            data = self.prepare_data(index, rng)
            if data is not None:
                return data
            index = require_rng(rng, type(self).__name__).randint(len(self))


@DATASETS.register('CBGSDataset')
class CBGSDataset:
    """Class-balanced grouping & sampling wrapper.

    Reference: mmdet3d/datasets/dataset_wrappers.py:7-75 — duplicates sample
    indices so every class is (approximately) equally represented. The
    duplicates are drawn from ``np.random.RandomState(seed)`` (the train
    CLI passes its ``--seed``).
    """

    def __init__(self, dataset, seed: int = 0, **kwargs):
        if isinstance(dataset, dict):
            dataset = DATASETS.build(dict(dataset))
        self.dataset = dataset
        self.CLASSES = dataset.CLASSES
        self.sample_indices = self._get_sample_indices(
            np.random.RandomState(seed))

    def _get_sample_indices(self, rng):
        num_classes = len(self.CLASSES)
        class_sample_idxs = {i: [] for i in range(num_classes)}
        for idx in range(len(self.dataset)):
            for cat in self.dataset.get_cat_ids(idx):
                class_sample_idxs[cat].append(idx)
        duplicated = sum(len(v) for v in class_sample_idxs.values())
        if duplicated == 0:
            return list(range(len(self.dataset)))
        class_ratio = {k: len(v) / duplicated
                       for k, v in class_sample_idxs.items()}
        frac = 1.0 / num_classes
        indices = []
        for cls, cls_indices in class_sample_idxs.items():
            if not cls_indices:
                continue
            ratio = frac / max(class_ratio[cls], 1e-8)
            take = int(len(cls_indices) * ratio)
            indices += list(rng.choice(cls_indices, take).astype(int))
        return indices

    def set_epoch(self, epoch: int):
        if hasattr(self.dataset, 'set_epoch'):
            self.dataset.set_epoch(epoch)

    def __len__(self):
        return len(self.sample_indices)

    def sample(self, idx: int, rng: Optional[np.random.RandomState] = None):
        return self.dataset.sample(self.sample_indices[idx], rng)
