"""Native nuScenes detection metrics (mAP / TP errors / NDS), numpy.

Private copy of the JAX package's ``core/evaluation/nuscenes_metrics.py``:
a self-contained re-implementation of the detection_cvpr_2019 protocol that
the reference delegates to the nuscenes-devkit
(mmdet3d/datasets/nuscenes_dataset.py:368-400): greedy center-distance
matching at thresholds {0.5, 1, 2, 4} m, 101-point interpolated AP clipped
at recall/precision 0.1, TP errors (ATE/ASE/AOE/AVE) at the 2 m threshold,
NDS = (4*mAP + sum(1 - min(1, err))) / 8 over the four TP errors: the
attribute error is omitted (it needs attribute predictions), and the
weights keep the devkit's half for mAP.

Works in any rigid frame (distances are frame-invariant), so detections and
GT can stay in the LiDAR frame.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

DIST_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)
TP_THRESHOLD = 2.0
MIN_RECALL = 0.1
MIN_PRECISION = 0.1

# classes with undefined yaw period pi (barrier) / no yaw (cone), devkit
PERIOD_PI = ('barrier',)
NO_ORIENTATION = ('traffic_cone',)
NO_VELOCITY = ('barrier', 'traffic_cone')


def _yaw_diff(a, b, period):
    d = np.abs(a - b) % (2 * np.pi)
    d = np.minimum(d, 2 * np.pi - d)
    if period == np.pi:
        d = np.minimum(d, np.abs(np.pi - d))
    return d


def _scale_iou(pred, gt):
    """3D IoU of center/yaw-aligned boxes (devkit scale_iou)."""
    inter = np.prod(np.minimum(pred[3:6], gt[3:6]))
    union = np.prod(pred[3:6]) + np.prod(gt[3:6]) - inter
    return inter / max(union, 1e-8)


def accumulate_class(preds_by_sample: List[Dict[str, np.ndarray]],
                     gts_by_sample: List[Dict[str, np.ndarray]],
                     class_id: int, dist_th: float,
                     yaw_period: float = 2 * np.pi):
    """Greedy match one class at one distance threshold.

    preds/gts per sample: dict with 'bboxes' [N, 7+], 'scores', 'labels'.
    yaw_period: 2*pi for most classes, pi for barriers (devkit semantics —
    a barrier flipped 180 degrees is the same barrier).
    Returns dict with ap and tp error means.
    """
    # flatten predictions with sample ids, sort by score desc
    rows = []
    for si, det in enumerate(preds_by_sample):
        mask = det['labels'] == class_id
        for box, score in zip(det['bboxes'][mask], det['scores'][mask]):
            rows.append((score, si, box))
    rows.sort(key=lambda r: -r[0])

    npos = sum(int((g['labels'] == class_id).sum()) for g in gts_by_sample)
    if npos == 0:
        return None

    gt_taken = [np.zeros(int((g['labels'] == class_id).sum()), bool)
                for g in gts_by_sample]
    gt_boxes = [g['bboxes'][g['labels'] == class_id] for g in gts_by_sample]

    tp, fp = [], []
    errs = {'trans': [], 'scale': [], 'orient': [], 'vel': []}
    for score, si, box in rows:
        gts = gt_boxes[si]
        best, best_d = -1, dist_th
        for gi in range(len(gts)):
            if gt_taken[si][gi]:
                continue
            d = np.linalg.norm(box[:2] - gts[gi][:2])
            if d < best_d:
                best, best_d = gi, d
        if best >= 0:
            gt_taken[si][best] = True
            tp.append(1)
            fp.append(0)
            g = gts[best]
            errs['trans'].append(best_d)
            errs['scale'].append(1.0 - _scale_iou(box, g))
            errs['orient'].append(_yaw_diff(box[6], g[6], yaw_period))
            if box.shape[0] > 8 and g.shape[0] > 8:
                errs['vel'].append(np.linalg.norm(box[7:9] - g[7:9]))
        else:
            tp.append(0)
            fp.append(1)

    tp = np.cumsum(tp)
    fp = np.cumsum(fp)
    recall = tp / npos
    precision = tp / np.maximum(tp + fp, 1)

    # 101-point interpolation with devkit clipping
    rec_interp = np.linspace(0, 1, 101)
    prec_at = np.interp(rec_interp, recall, precision, right=0) \
        if len(recall) else np.zeros(101)
    prec_at = prec_at[rec_interp >= MIN_RECALL]
    prec_at = np.maximum(prec_at - MIN_PRECISION, 0) / (1 - MIN_PRECISION)
    ap = float(np.mean(prec_at))
    return {'ap': ap,
            'trans_err': float(np.mean(errs['trans'])) if errs['trans']
            else 1.0,
            'scale_err': float(np.mean(errs['scale'])) if errs['scale']
            else 1.0,
            'orient_err': float(np.mean(errs['orient'])) if errs['orient']
            else 1.0,
            'vel_err': float(np.mean(errs['vel'])) if errs['vel'] else 1.0}


def evaluate_detections(preds_by_sample, gts_by_sample,
                        class_names: Sequence[str]):
    """Full protocol over all classes/thresholds.

    Returns metrics dict with per-class APs, mAP, TP errors, NDS.
    """
    metrics: Dict[str, float] = {}
    aps = []
    tp_errs = {'trans_err': [], 'scale_err': [], 'orient_err': [],
               'vel_err': []}
    for ci, name in enumerate(class_names):
        class_aps = []
        period = np.pi if name in PERIOD_PI else 2 * np.pi
        for th in DIST_THRESHOLDS:
            res = accumulate_class(preds_by_sample, gts_by_sample, ci, th,
                                   yaw_period=period)
            if res is None:
                continue
            class_aps.append(res['ap'])
            if th == TP_THRESHOLD:
                if name not in NO_ORIENTATION:
                    tp_errs['orient_err'].append(res['orient_err'])
                if name not in NO_VELOCITY:
                    tp_errs['vel_err'].append(res['vel_err'])
                tp_errs['trans_err'].append(res['trans_err'])
                tp_errs['scale_err'].append(res['scale_err'])
        if class_aps:
            metrics[f'{name}_AP'] = float(np.mean(class_aps))
            aps.append(np.mean(class_aps))
    mAP = float(np.mean(aps)) if aps else 0.0
    metrics['mAP'] = mAP
    tp_score = 0.0
    for key, vals in tp_errs.items():
        mean_err = float(np.mean(vals)) if vals else 1.0
        metrics[f'mean_{key}'] = mean_err
        tp_score += max(0.0, 1.0 - min(1.0, mean_err))
    # 4 TP metrics (no attribute error): NDS = (4*mAP + tp_score)/8 keeps
    # the devkit's 50/50 weighting between mAP and TP errors
    metrics['NDS'] = float((4 * mAP + tp_score) / 8.0)
    return metrics
