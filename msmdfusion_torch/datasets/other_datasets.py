"""Waymo (KITTI-format infos) and the indoor sets (ScanNet, SUN RGB-D).

Counterpart of the JAX package's ``datasets/other_datasets.py``:

- ``WaymoDataset`` (reference waymo_dataset.py:574): the KITTI-format info
  layout the reference converter emits, read by ``KittiDataset``, every
  ``load_interval``-th info kept, the ``Objects`` .bin submission and the
  native L1/L2 metrics;
- ``ScanNetDataset`` and ``SUNRGBDDataset`` (reference
  scannet_dataset.py, sunrgbd_dataset.py) on ``_IndoorDataset``: the
  converters' infos (``pts_path``; ``annos.gt_boxes_upright_depth``,
  gravity-centre depth-frame boxes, [k, 6] axis-aligned for ScanNet and
  [k, 7] yawed for SUN RGB-D; ``annos.class``; the per-point mask
  paths), the boxes turned bottom-centre (x, y, z, dx, dy, dz, yaw);
  ``evaluate`` is the indoor protocol (``core/evaluation/indoor_eval.py``)
  at IoU 0.25 and 0.5.

Lyft and SemanticKITTI are not ported.
"""
from __future__ import annotations

import os

import numpy as np

from ..registry import DATASETS
from .custom_3d import Custom3DDataset
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


class _IndoorDataset(Custom3DDataset):
    """The depth-frame indoor infos shared by ScanNet and SUN RGB-D."""

    def get_data_info(self, index):
        info = self.data_infos[index]
        pts_path = info.get('pts_path', info.get('lidar_path', ''))
        results = dict(
            sample_idx=info.get('point_cloud', {}).get('lidar_idx', index),
            pts_filename=os.path.join(self.data_root, pts_path),
            sweeps=[], timestamp=0)
        if self.modality.get('use_camera') and 'image' in info:
            results['img_filename'] = [os.path.join(
                self.data_root, 'sunrgbd_trainval',
                info['image'].get('image_path', ''))]
            if 'calib' in info:
                results['calib'] = info['calib']
        return results

    def get_ann_info(self, index):
        info = self.data_infos[index]
        annos = info.get('annos', {})
        count = annos.get('gt_num', len(annos.get('class', [])))
        if count == 0:
            boxes = np.zeros((0, 7), np.float32)
            labels = np.zeros((0,), np.int64)
        else:
            boxes = np.asarray(annos['gt_boxes_upright_depth'],
                               np.float32).reshape(len(annos['class']), -1)
            if boxes.shape[1] == 6:             # axis-aligned: zero yaw
                boxes = np.concatenate(
                    [boxes, np.zeros((len(boxes), 1), np.float32)], axis=1)
            boxes = boxes.copy()
            boxes[:, 2] -= boxes[:, 5] / 2      # gravity -> bottom centre
            labels = np.asarray(annos['class'], np.int64)
        ann = dict(gt_bboxes_3d=boxes, gt_labels_3d=labels)
        for key in ('pts_instance_mask_path', 'pts_semantic_mask_path'):
            if key in info:
                ann[key] = os.path.join(self.data_root, info[key])
        if self.modality.get('use_camera') and 'bbox' in annos:
            # the image-plane boxes of the 2-D eval path
            ann['bboxes'] = (np.asarray(annos['bbox'], np.float32) if count
                             else np.zeros((0, 4), np.float32))
            ann['labels'] = labels
        return ann

    def evaluate(self, results, iou_thr=(0.25, 0.5), **kwargs):
        """mAP and mAR per IoU threshold, and per class (the reference's
        scannet/sunrgbd ``evaluate``, indoor_eval at (0.25, 0.5))."""
        from ..core.evaluation.indoor_eval import indoor_eval
        gts = [self.get_ann_info(i) for i in range(len(results))]
        return indoor_eval(gts, results, iou_thr, list(self.CLASSES))

    def show(self, results, out_dir, show=True):
        """Per-sample BEV PNG, OBJ wireframes and the WebGL viewer
        (``core.visualizer.show_result``) of the 6-float point files."""
        from ..core.visualizer import show_result
        outputs = []
        for i, result in enumerate(results):
            pts_path = self.data_infos[i].get('pts_path', '')
            name = os.path.split(pts_path)[-1].split('.')[0] or f's{i}'
            full = os.path.join(self.data_root, pts_path)
            points = (np.fromfile(full, np.float32).reshape(-1, 6)
                      if os.path.exists(full) else None)
            pred = np.asarray(result.get('bboxes',
                                         result.get('boxes_3d', [])))
            outputs += show_result(points, self.get_ann_info(i)[
                'gt_bboxes_3d'], pred, out_dir, name)
        return outputs


@DATASETS.register('ScanNetDataset')
class ScanNetDataset(_IndoorDataset):
    CLASSES = ('cabinet', 'bed', 'chair', 'sofa', 'table', 'door', 'window',
               'bookshelf', 'picture', 'counter', 'desk', 'curtain',
               'refrigerator', 'showercurtrain', 'toilet', 'sink',
               'bathtub', 'garbagebin')


@DATASETS.register('SUNRGBDDataset')
class SUNRGBDDataset(_IndoorDataset):
    CLASSES = ('bed', 'table', 'sofa', 'chair', 'toilet', 'desk', 'dresser',
               'night_stand', 'bookshelf', 'bathtub')
