"""KITTI dataset (info-pkl reader + 3D AP evaluation).

Counterpart of the JAX package's ``datasets/kitti.py`` (reference
mmdet3d/datasets/kitti_dataset.py:698): info-pkl parsing (velodyne paths,
calib, annos in the camera frame -> LiDAR boxes through ``R0_rect`` and
``Tr_velo_to_cam``), detections back to KITTI annotations
(``bbox2result_kitti``) and the full KITTI protocol or the simplified BEV
AP (``evaluate``). No images are loaded (neither are the JAX package's).
"""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from ..core import box_modes
from ..registry import DATASETS
from .custom_3d import Custom3DDataset


def _limit_period(val, offset=0.5, period=np.pi):
    """``val`` into ``[-offset * period, (1 - offset) * period)``, in its
    own dtype (reference structures/utils.py ``limit_period``)."""
    return val - np.floor(val / period + offset) * period


@DATASETS.register('KittiDataset')
class KittiDataset(Custom3DDataset):
    CLASSES = ('Pedestrian', 'Cyclist', 'Car')

    def __init__(self, *args, split='training', pts_prefix='velodyne',
                 **kwargs):
        self.split = split
        self.pts_prefix = pts_prefix
        super().__init__(*args, **kwargs)

    def get_data_info(self, index):
        info = self.data_infos[index]
        sample_idx = info['image']['image_idx'] if 'image' in info else index
        pts_path = info.get('point_cloud', {}).get(
            'velodyne_path',
            os.path.join(self.split, self.pts_prefix, f'{sample_idx:06d}.bin'))
        return dict(
            sample_idx=sample_idx,
            pts_filename=os.path.join(self.data_root, pts_path),
            sweeps=[], timestamp=0,
            calib=info.get('calib', {}))

    def get_ann_info(self, index):
        info = self.data_infos[index]
        annos = info.get('annos', {})
        if not annos:
            return dict(gt_bboxes_3d=np.zeros((0, 7), np.float32),
                        gt_labels_3d=np.zeros((0,), np.int64))
        names = annos['name']
        keep = names != 'DontCare'
        loc = annos['location'][keep]      # camera-frame bottom centers
        dims = annos['dimensions'][keep]   # camera (l, h, w)
        rots = annos['rotation_y'][keep]
        calib = info.get('calib', {})
        rect = np.eye(4)
        rect[:3, :3] = np.asarray(calib.get('R0_rect', np.eye(4)))[:3, :3]
        trv2c = np.eye(4)
        tr = np.asarray(calib.get('Tr_velo_to_cam', np.eye(4)))
        trv2c[:tr.shape[0], :tr.shape[1]] = tr
        # x_cam = rect @ trv2c @ x_velo  =>  x_velo = (rect @ trv2c)^-1 x_cam
        cam2velo = np.linalg.inv(rect @ trv2c)
        hom = np.concatenate([loc, np.ones((len(loc), 1))], axis=1)
        xyz_lidar = (hom @ cam2velo.T)[:, :3]
        # boxes: (x, y, z_bottom, w, l, h, yaw)
        boxes = np.zeros((loc.shape[0], 7), np.float32)
        boxes[:, :3] = xyz_lidar
        boxes[:, 3] = dims[:, 2]  # w
        boxes[:, 4] = dims[:, 0]  # l
        boxes[:, 5] = dims[:, 1]  # h
        boxes[:, 6] = -rots - np.pi / 2
        labels = np.asarray([
            self.cat2id.get(n, -1) for n in names[keep]], np.int64)
        valid = labels >= 0
        return dict(gt_bboxes_3d=boxes[valid], gt_labels_3d=labels[valid])

    def _calib(self, info):
        calib = info.get('calib', {})
        rect = np.eye(4, dtype=np.float32)
        r0 = np.asarray(calib.get('R0_rect', np.eye(4)), np.float32)
        rect[:r0.shape[0], :r0.shape[1]] = r0
        trv2c = np.eye(4, dtype=np.float32)
        tr = np.asarray(calib.get('Tr_velo_to_cam', np.eye(4)), np.float32)
        trv2c[:tr.shape[0], :tr.shape[1]] = tr
        p2 = np.asarray(calib.get('P2', np.eye(4)), np.float32)
        if p2.shape == (3, 4):
            p2 = np.concatenate([p2, [[0, 0, 0, 1]]], 0).astype(np.float32)
        return rect, trv2c, p2

    def bbox2result_kitti(self, results, submission_prefix=None):
        """LiDAR detections -> KITTI annotation dicts (+ optional txt files).

        Reference kitti_dataset.py:360-474 + convert_valid_bboxes:587-672:
        yaw -= pi (the reader's inverse), LiDAR -> CAM via rect @ Trv2c,
        2D bbox from P2-projected corners clipped to the image, alpha from
        the LiDAR viewing angle.
        """
        annos = []
        for i, det in enumerate(results):
            info = self.data_infos[i]
            rect, trv2c, p2 = self._calib(info)
            img_shape = np.asarray(
                info.get('image', {}).get('image_shape', (375, 1242)))
            boxes = np.asarray(det['bboxes'], np.float32).reshape(-1, 9) \
                if np.asarray(det['bboxes']).shape[-1] == 9 else \
                np.asarray(det['bboxes'], np.float32)
            scores = np.asarray(det['scores'], np.float32)
            labels = np.asarray(det['labels'], np.int64)
            anno = {k: [] for k in ('name', 'truncated', 'occluded', 'alpha',
                                    'bbox', 'dimensions', 'location',
                                    'rotation_y', 'score')}
            if len(boxes):
                cam = np.array(box_modes.convert_boxes(
                    boxes[:, :7], box_modes.LIDAR, box_modes.CAM,
                    rt_mat=(rect @ trv2c)[:3]))
                # exact inverse of get_ann_info's yaw = -ry - pi/2 (the
                # reference instead carries yaw through Box3DMode plus its
                # "hack of yaw" -pi, kitti_dataset.py:616-618 — same
                # geometry, different internal convention)
                cam[:, 6] = _limit_period(-(boxes[:, 6] + np.pi / 2), 0.5,
                                          2 * np.pi)
                corners = box_modes.cam_corners_3d(cam)      # [N, 8, 3]
                hom = np.concatenate(
                    [corners, np.ones((*corners.shape[:2], 1))], -1)
                proj = hom @ p2.T
                pix = proj[..., :2] / np.maximum(proj[..., 2:3], 1e-6)
                bbox2d = np.concatenate(
                    [pix.min(axis=1), pix.max(axis=1)], axis=1)
                valid = ((bbox2d[:, 0] < img_shape[1])
                         & (bbox2d[:, 1] < img_shape[0])
                         & (bbox2d[:, 2] > 0) & (bbox2d[:, 3] > 0)
                         & (corners[..., 2].mean(1) > 0))
                for j in np.where(valid)[0]:
                    bb = bbox2d[j].copy()
                    bb[2:] = np.minimum(bb[2:], img_shape[::-1])
                    bb[:2] = np.maximum(bb[:2], 0)
                    anno['name'].append(self.CLASSES[int(labels[j])])
                    anno['truncated'].append(0.0)
                    anno['occluded'].append(0)
                    anno['alpha'].append(float(
                        -np.arctan2(-boxes[j, 1], boxes[j, 0]) + cam[j, 6]))
                    anno['bbox'].append(bb)
                    anno['dimensions'].append(cam[j, 3:6])
                    anno['location'].append(cam[j, :3])
                    anno['rotation_y'].append(float(cam[j, 6]))
                    anno['score'].append(float(scores[j]))
            if anno['name']:
                anno = {k: np.stack(v) if k in ('bbox', 'dimensions',
                                                'location')
                        else np.asarray(v) for k, v in anno.items()}
            else:
                anno = dict(name=np.array([]), truncated=np.array([]),
                            occluded=np.array([]), alpha=np.array([]),
                            bbox=np.zeros((0, 4)),
                            dimensions=np.zeros((0, 3)),
                            location=np.zeros((0, 3)),
                            rotation_y=np.array([]), score=np.array([]))
            annos.append(anno)
            if submission_prefix is not None:
                idx = info.get('image', {}).get('image_idx', i)
                path = os.path.join(submission_prefix, f'{idx:06d}.txt')
                with open(path, 'w') as f:
                    for j in range(len(anno['name'])):
                        d, loc = anno['dimensions'][j], anno['location'][j]
                        print('{} -1 -1 {:.4f} {:.4f} {:.4f} {:.4f} {:.4f} '
                              '{:.4f} {:.4f} {:.4f} {:.4f} {:.4f} {:.4f} '
                              '{:.4f} {:.4f}'.format(
                                  anno['name'][j], anno['alpha'][j],
                                  *anno['bbox'][j], d[1], d[2], d[0],
                                  *loc, anno['rotation_y'][j],
                                  anno['score'][j]), file=f)
        return annos

    def evaluate(self, results, metric='kitti', iou_thr=(0.7, 0.5, 0.5),
                 **kwargs):
        """Full KITTI protocol when 2D annos exist, else simplified AP.

        metric='kitti': official difficulty-bucketed bbox/bev/3d/aos eval
        (core/evaluation/kitti_eval.py). metric='bev': the BEV-IoU
        simplified AP (no 2D/occlusion gating required).
        """
        have_full = (metric == 'kitti' and len(self.data_infos)
                     and 'annos' in self.data_infos[0]
                     and 'bbox' in self.data_infos[0].get('annos', {}))
        if have_full:
            from ..core.evaluation.kitti_eval import kitti_eval
            gt_annos = [self.data_infos[i]['annos']
                        for i in range(len(results))]
            dt_annos = self.bbox2result_kitti(results)
            report, metrics = kitti_eval(gt_annos, dt_annos,
                                         list(self.CLASSES))
            print(report)
            return metrics
        from ..core.evaluation.kitti_metrics import kitti_eval_simplified
        gts = [self.get_ann_info(i) for i in range(len(results))]
        return kitti_eval_simplified(results, gts, self.CLASSES, iou_thr)
