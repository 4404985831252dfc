"""Waymo dataset reader (KITTI-format infos).

Counterpart of the JAX package's ``datasets/other_datasets.py``
``WaymoDataset`` (reference waymo_dataset.py:574): the KITTI-format info
layout the reference converter emits, read by ``KittiDataset``, every
``load_interval``-th info kept, the ``Objects`` .bin submission and the
native L1/L2 metrics. The other readers of that module (Lyft and the
indoor sets) are not ported.
"""
from __future__ import annotations

import os

import numpy as np

from ..registry import DATASETS
from .kitti import KittiDataset


@DATASETS.register('WaymoDataset')
class WaymoDataset(KittiDataset):
    """Waymo in KITTI-format infos (reference waymo converter layout)."""
    CLASSES = ('Car', 'Pedestrian', 'Cyclist')

    def __init__(self, *args, load_interval=1, **kwargs):
        super().__init__(*args, **kwargs)
        if load_interval > 1:
            self.data_infos = self.data_infos[::load_interval]

    def format_results(self, results, jsonfile_prefix=None):
        """Write the combined waymo ``Objects`` .bin submission file.

        Mirrors the reference's ``waymo_results_final_path`` output
        (prediction_kitti_to_waymo.py:261 ``convert``/``combine``,
        waymo_dataset.py:279-350) so the native-proxy metrics can be
        cross-checked against the official WOD evaluator externally.
        """
        from ..core.evaluation.waymo_serialize import serialize_waymo_objects
        contexts = []
        for info in self.data_infos[:len(results)]:
            pc = info.get('point_cloud', {})
            contexts.append(dict(
                context_name=str(info.get('context_name',
                                          pc.get('lidar_idx', ''))),
                timestamp_micros=int(info.get('timestamp',
                                              info.get('timestamp_micros',
                                                       0)))))
        buf = serialize_waymo_objects(results, contexts, list(self.CLASSES))
        out = (jsonfile_prefix or os.path.join(
            self.data_root or '.', 'results_waymo')) + '.bin'
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, 'wb') as f:
            f.write(buf)
        return out

    def evaluate(self, results, metric='waymo', iou_thr=(0.7, 0.5, 0.5),
                 **kwargs):
        """metric='waymo': native L1/L2 3D mAP/mAPH protocol
        (core/evaluation/waymo_eval.py) — the reference has no in-tree
        equivalent (waymo_utils/prediction_kitti_to_waymo.py:261 converts
        to protos and shells out to the waymo-open-dataset binary).
        metric='kitti'/'bev': the KITTI-format protocols of the base class.
        """
        if metric != 'waymo':
            return super().evaluate(results, metric=metric, iou_thr=iou_thr)
        from ..core.evaluation.waymo_eval import waymo_eval
        gts = []
        for i in range(len(results)):
            ann = self.get_ann_info(i)
            gt = dict(boxes=ann['gt_bboxes_3d'], labels=ann['gt_labels_3d'])
            annos = self.data_infos[i].get('annos', {})
            if 'num_points_in_gt' in annos:
                keep = annos['name'] != 'DontCare'
                gt['num_points'] = np.asarray(
                    annos['num_points_in_gt'])[keep]
            gts.append(gt)
        dts = [dict(boxes=r['bboxes'], labels=r['labels'],
                    scores=r['scores']) for r in results]
        report, metrics = waymo_eval(gts, dts, list(self.CLASSES))
        print(report)
        return metrics
