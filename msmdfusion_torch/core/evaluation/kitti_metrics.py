"""Simplified KITTI-style AP-R40 evaluation (numpy).

Counterpart of the JAX package's ``core/evaluation/kitti_metrics.py``, the
rotated BEV IoU from ``core/iou3d.py::boxes_iou_bev`` (torch, on the CPU):
a re-derived replacement for the reference's numba KITTI evaluator
(mmdet3d/core/evaluation/kitti_utils/eval.py:851 + rotate_iou.py:378):
per-class greedy matching by rotated BEV IoU, 40-point interpolated AP.
Difficulty buckets are omitted (single bucket) — the full
occlusion/truncation gating needs 2D box annotations that the pipeline
does not carry.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..iou3d import boxes_iou_bev


def rotated_iou_bev_np(boxes_a, boxes_b):
    """[N, 5] x [M, 5] (cx, cy, w, l, yaw) -> [N, M] float32 IoU."""
    if len(boxes_a) == 0 or len(boxes_b) == 0:
        return np.zeros((len(boxes_a), len(boxes_b)), np.float32)
    return boxes_iou_bev(
        torch.from_numpy(np.asarray(boxes_a, np.float32)),
        torch.from_numpy(np.asarray(boxes_b, np.float32))).numpy()


def _ap_r40(recall, precision):
    out = 0.0
    for r in np.linspace(0.025, 1.0, 40):
        p = precision[recall >= r]
        out += (p.max() if len(p) else 0.0) / 40.0
    return out


def kitti_eval_simplified(results: List[Dict], gts: List[Dict],
                          class_names: Sequence[str],
                          iou_thr: Sequence[float]) -> Dict[str, float]:
    metrics = {}
    aps = []
    for ci, name in enumerate(class_names):
        rows = []
        for si, det in enumerate(results):
            m = det['labels'] == ci
            for box, score in zip(det['bboxes'][m], det['scores'][m]):
                rows.append((float(score), si, box))
        rows.sort(key=lambda r: -r[0])
        npos = sum(int((g['gt_labels_3d'] == ci).sum()) for g in gts)
        if npos == 0:
            continue
        taken = [np.zeros(int((g['gt_labels_3d'] == ci).sum()), bool)
                 for g in gts]
        gt_boxes = [g['gt_bboxes_3d'][g['gt_labels_3d'] == ci] for g in gts]
        tp, fp = [], []
        for score, si, box in rows:
            gtb = gt_boxes[si]
            if len(gtb) == 0:
                tp.append(0)
                fp.append(1)
                continue
            bev_a = np.asarray(
                [[box[0], box[1], box[3], box[4], box[6]]], np.float32)
            bev_b = np.stack([gtb[:, 0], gtb[:, 1], gtb[:, 3], gtb[:, 4],
                              gtb[:, 6]], axis=1)
            iou = rotated_iou_bev_np(bev_a, bev_b)[0]
            iou[taken[si]] = -1
            best = int(np.argmax(iou))
            if iou[best] >= iou_thr[ci]:
                taken[si][best] = True
                tp.append(1)
                fp.append(0)
            else:
                tp.append(0)
                fp.append(1)
        tp = np.cumsum(tp)
        fp = np.cumsum(fp)
        recall = tp / npos
        precision = tp / np.maximum(tp + fp, 1)
        ap = _ap_r40(recall, precision)
        metrics[f'{name}_bev_AP'] = float(ap)
        aps.append(ap)
    metrics['mAP_bev'] = float(np.mean(aps)) if aps else 0.0
    return metrics
