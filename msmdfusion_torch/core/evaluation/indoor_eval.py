"""Indoor (ScanNet, SUN RGB-D) detection evaluation.

Counterpart of the JAX package's ``core/evaluation/indoor_eval.py``
(reference mmdet3d/core/evaluation/indoor_eval.py:7-309): per class, the
detections of every sample in descending score, each matched greedily to
its sample's best-overlapping GT box by 3-D IoU at each threshold;
VOC-style AP (the area under the precision-recall curve) and AR (the last
recall). Boxes are [N, 7] depth-frame arrays (x, y, z_bottom, dx, dy, dz,
yaw); the IoU is ``core/iou3d.py::boxes_iou_3d`` on the CPU.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..iou3d import boxes_iou_3d


def average_precision(recalls, precisions, mode='area'):
    """VOC AP from PR points (reference indoor_eval.py:7-53)."""
    if recalls.ndim == 1:
        recalls = recalls[None]
        precisions = precisions[None]
    num_scales = recalls.shape[0]
    ap = np.zeros(num_scales, np.float32)
    if mode == 'area':
        zeros = np.zeros((num_scales, 1), recalls.dtype)
        ones = np.ones((num_scales, 1), recalls.dtype)
        mrec = np.hstack((zeros, recalls, ones))
        mpre = np.hstack((zeros, precisions, zeros))
        for i in range(mpre.shape[1] - 1, 0, -1):
            mpre[:, i - 1] = np.maximum(mpre[:, i - 1], mpre[:, i])
        for i in range(num_scales):
            ind = np.where(mrec[i, 1:] != mrec[i, :-1])[0]
            ap[i] = np.sum((mrec[i, ind + 1] - mrec[i, ind])
                           * mpre[i, ind + 1])
    elif mode == '11points':
        for i in range(num_scales):
            for thr in np.arange(0, 1 + 1e-3, 0.1):
                precs = precisions[i, recalls[i] >= thr]
                ap[i] += (precs.max() if precs.size else 0.0) / 11
    else:
        raise ValueError(mode)
    return ap


def _iou_3d(pred_boxes: np.ndarray, gt_boxes: np.ndarray) -> np.ndarray:
    """[P, G] rotated 3-D IoU (z up)."""
    if len(pred_boxes) == 0 or len(gt_boxes) == 0:
        return np.zeros((len(pred_boxes), len(gt_boxes)), np.float32)
    return boxes_iou_3d(
        torch.as_tensor(np.asarray(pred_boxes, np.float32)),
        torch.as_tensor(np.asarray(gt_boxes, np.float32))).numpy()


def eval_det_cls(pred: Dict, gt: Dict, iou_thr: Sequence[float]):
    """One class's PR over every sample (reference :55-160).

    pred: {sample_id: [(box [7], score), ...]}; gt: {sample_id: [G, 7]}.
    Returns a (recall, precision, ap) per threshold.
    """
    class_recs = {}
    npos = 0
    for sid, boxes in gt.items():
        boxes = np.asarray(boxes).reshape(-1, 7)
        class_recs[sid] = dict(
            bbox=boxes, det=[np.zeros(len(boxes), bool) for _ in iou_thr])
        npos += len(boxes)
    sample_ids, confidence, ious = [], [], []
    for sid, dets in pred.items():
        if not len(dets):
            continue
        boxes = np.stack([d[0] for d in dets]).reshape(-1, 7)
        gt_cur = class_recs.get(sid, dict(bbox=np.zeros((0, 7))))['bbox']
        iou_cur = _iou_3d(boxes, gt_cur)
        for i, d in enumerate(dets):
            sample_ids.append(sid)
            confidence.append(d[1])
            ious.append(iou_cur[i] if len(gt_cur) else np.zeros(1))
    order = np.argsort(-np.asarray(confidence)) if confidence else []
    nd = len(order)
    tp_thr = [np.zeros(nd) for _ in iou_thr]
    fp_thr = [np.zeros(nd) for _ in iou_thr]
    for d, oi in enumerate(order):
        rec = class_recs.get(sample_ids[oi])
        iou_max, jmax = -np.inf, -1
        if rec is not None and len(rec['bbox']):
            jmax = int(np.argmax(ious[oi]))
            iou_max = ious[oi][jmax]
        for t, thr in enumerate(iou_thr):
            if iou_max > thr and not rec['det'][t][jmax]:
                tp_thr[t][d] = 1.0
                rec['det'][t][jmax] = True
            else:
                fp_thr[t][d] = 1.0
    out = []
    for t in range(len(iou_thr)):
        fp = np.cumsum(fp_thr[t])
        tp = np.cumsum(tp_thr[t])
        recall = tp / max(float(npos), 1e-12)
        precision = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
        out.append((recall, precision, float(average_precision(
            recall, precision)[0])))
    return out


def indoor_eval(gt_annos: List[Dict], dt_annos: List[Dict],
                iou_thr: Sequence[float],
                class_names: Sequence[str]) -> Dict[str, float]:
    """Multi-class indoor mAP and mAR (reference :203-309); the classes
    without GT are left out of the means.

    gt_annos[i]: {'gt_bboxes_3d': [G, 7], 'gt_labels_3d': [G]};
    dt_annos[i]: {'bboxes': [D, 7+], 'scores': [D], 'labels': [D]}.
    """
    pred: Dict[int, Dict] = {}
    gt: Dict[int, Dict] = {}
    for sid, (g, d) in enumerate(zip(gt_annos, dt_annos)):
        labels = np.asarray(d['labels'])
        boxes = np.asarray(d['bboxes'])[:, :7]
        scores = np.asarray(d['scores'])
        for ci in range(len(class_names)):
            m = labels == ci
            pred.setdefault(ci, {})[sid] = [
                (b, float(s)) for b, s in zip(boxes[m], scores[m])]
        g_labels = np.asarray(g['gt_labels_3d'])
        g_boxes = np.asarray(g['gt_bboxes_3d'])[:, :7] \
            if len(g['gt_bboxes_3d']) else np.zeros((0, 7))
        for ci in range(len(class_names)):
            gt.setdefault(ci, {})[sid] = g_boxes[g_labels == ci] \
                if len(g_boxes) else np.zeros((0, 7))
    metrics: Dict[str, float] = {}
    for t, thr in enumerate(iou_thr):
        aps, ars = [], []
        for ci, name in enumerate(class_names):
            if not any(len(v) for v in gt[ci].values()):
                continue
            rec, prec, ap = eval_det_cls(pred[ci], gt[ci], iou_thr)[t]
            last = float(rec[-1] if len(rec) else 0.0)
            metrics[f'{name}_AP_{thr:.2f}'] = ap
            metrics[f'{name}_rec_{thr:.2f}'] = last
            aps.append(ap)
            ars.append(last)
        metrics[f'mAP_{thr:.2f}'] = float(np.mean(aps)) if aps else 0.0
        metrics[f'mAR_{thr:.2f}'] = float(np.mean(ars)) if ars else 0.0
    return metrics
