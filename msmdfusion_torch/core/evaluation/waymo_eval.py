"""Native Waymo Open Dataset detection metrics (L1/L2 3D mAP and mAPH).

Counterpart of the JAX package's ``core/evaluation/waymo_eval.py``,
copied.

The reference repo does not compute Waymo metrics in-tree: it converts KITTI
-format predictions to protos and shells out to the compiled waymo-open-
dataset evaluator (mmdet3d/core/evaluation/waymo_utils/
prediction_kitti_to_waymo.py:261, waymo_dataset.py:306-330).  That binary is
not available here, so this module implements the protocol natively in
numpy, following the published metric definition:

- per-class 3D IoU matching (vehicle 0.7, pedestrian/cyclist 0.5),
  greedy by detection score against the best-IoU unmatched ground truth;
- two difficulty levels: LEVEL_2 = all boxes, LEVEL_1 = boxes labeled
  LEVEL_1 (by the labeler, or >5 lidar points when no label is present).
  When evaluating LEVEL_1, LEVEL_2-only ground truths are *ignored*:
  detections matched to them are neither TP nor FP (same mechanics as the
  KITTI protocol's dontcare handling, kitti_eval.py:212-335);
- AP from the score-sorted precision/recall curve, integrated with the
  trapezoid-free "max precision to the right" sweep over 101 recall points;
- APH: identical, but each true positive's contribution is weighted by
  heading accuracy ``max(0, 1 - |wrap(dyaw)| / pi)``.

Boxes are LiDAR-frame ``[x, y, z, dx, dy, dz, yaw]`` with bottom-center
origin (core/boxes.py convention).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .kitti_eval import rotated_box_intersection

LEVEL_1 = 1
LEVEL_2 = 2
DEFAULT_IOU = {'Car': 0.7, 'Vehicle': 0.7, 'Pedestrian': 0.5,
               'Cyclist': 0.5, 'Sign': 0.5}


def lidar_3d_iou(boxes: np.ndarray, qboxes: np.ndarray) -> np.ndarray:
    """3D IoU [N, K] for LiDAR-frame bottom-center boxes [*, 7]."""
    n, k = len(boxes), len(qboxes)
    if n == 0 or k == 0:
        return np.zeros((n, k), np.float64)
    rinc = rotated_box_intersection(boxes[:, [0, 1, 3, 4, 6]],
                                    qboxes[:, [0, 1, 3, 4, 6]])
    b_lo, b_hi = boxes[:, 2][:, None], (boxes[:, 2] + boxes[:, 5])[:, None]
    q_lo, q_hi = qboxes[None, :, 2], (qboxes[:, 2] + qboxes[:, 5])[None, :]
    ih = np.clip(np.minimum(b_hi, q_hi) - np.maximum(b_lo, q_lo), 0, None)
    inter = rinc * ih
    vol_b = np.prod(boxes[:, 3:6], axis=1)[:, None]
    vol_q = np.prod(qboxes[:, 3:6], axis=1)[None, :]
    denom = vol_b + vol_q - inter
    return np.where(denom > 0, inter / np.maximum(denom, 1e-12), 0.0)


def _heading_accuracy(dyaw: np.ndarray) -> np.ndarray:
    d = np.abs(np.mod(dyaw + np.pi, 2 * np.pi) - np.pi)
    return np.clip(1.0 - d / np.pi, 0.0, 1.0)


def _match_frame(gt_boxes, dt_boxes, dt_scores, iou_thr):
    """Greedy score-descending matching for one frame and one class.

    Returns (gt_index per detection, -1 unmatched) in the original
    detection order.
    """
    order = np.argsort(-dt_scores, kind='stable')
    iou = lidar_3d_iou(dt_boxes, gt_boxes)
    assigned = np.zeros(len(gt_boxes), bool)
    match = np.full(len(dt_boxes), -1, np.int64)
    for d in order:
        cand = np.where(~assigned & (iou[d] >= iou_thr))[0]
        if len(cand):
            g = cand[np.argmax(iou[d, cand])]
            assigned[g] = True
            match[d] = g
    return match


def _ap_from_pr(recall: np.ndarray, precision: np.ndarray) -> float:
    """101-point interpolated AP (max precision at recall >= r)."""
    ap = 0.0
    for r in np.linspace(0, 1, 101):
        mask = recall >= r
        ap += (precision[mask].max() if mask.any() else 0.0) / 101.0
    return float(ap)


def _eval_class_level(frames: List[Dict], iou_thr: float, level: int
                      ) -> Tuple[float, float]:
    """(AP, APH) for one class at one difficulty level.

    ``frames`` entries: gt_boxes [G, 7], gt_level [G], dt_boxes [D, 7],
    dt_scores [D].
    """
    scores, tp_w, is_tp = [], [], []
    num_gt = 0
    for fr in frames:
        gt_boxes, gt_level = fr['gt_boxes'], fr['gt_level']
        dt_boxes, dt_scores = fr['dt_boxes'], fr['dt_scores']
        counted = (gt_level <= level) & (gt_level > 0)
        num_gt += int(counted.sum())
        match = _match_frame(gt_boxes, dt_boxes, dt_scores, iou_thr)
        for d in range(len(dt_boxes)):
            g = match[d]
            if g >= 0 and not counted[g]:
                continue        # matched an ignored GT: neither TP nor FP
            scores.append(dt_scores[d])
            is_tp.append(g >= 0)
            if g >= 0:
                h = _heading_accuracy(dt_boxes[d, 6] - gt_boxes[g, 6])
                tp_w.append(float(h))
            else:
                tp_w.append(0.0)
    if num_gt == 0 or not scores:
        return 0.0, 0.0
    scores = np.asarray(scores)
    is_tp = np.asarray(is_tp, np.float64)
    tp_w = np.asarray(tp_w, np.float64)
    order = np.argsort(-scores, kind='stable')
    tp = np.cumsum(is_tp[order])
    tph = np.cumsum(tp_w[order])
    fp = np.cumsum(1.0 - is_tp[order])
    recall = tp / num_gt
    precision = tp / np.maximum(tp + fp, 1e-12)
    precision_h = tph / np.maximum(tp + fp, 1e-12)
    return _ap_from_pr(recall, precision), _ap_from_pr(recall, precision_h)


def assign_levels(num_points: np.ndarray,
                  labeled: np.ndarray = None) -> np.ndarray:
    """Waymo difficulty: labeler-provided level wins; else >5 points ->
    LEVEL_1, 1..5 -> LEVEL_2, 0 points -> 0 (excluded everywhere)."""
    num_points = np.asarray(num_points)
    level = np.where(num_points > 5, LEVEL_1,
                     np.where(num_points > 0, LEVEL_2, 0)).astype(np.int64)
    if labeled is not None:
        labeled = np.asarray(labeled, np.int64)
        level = np.where(labeled > 0, labeled, level)
    return level


def waymo_eval(gts: Sequence[Dict], dts: Sequence[Dict],
               classes: Sequence[str],
               iou_thr: Dict[str, float] = None) -> Tuple[str, Dict]:
    """Run the Waymo detection protocol over per-frame LiDAR-frame annos.

    gts[i]: dict(boxes [G, 7], labels [G], num_points [G] optional,
                 level [G] optional).
    dts[i]: dict(boxes [D, 7], labels [D], scores [D]).
    Returns (printable report, flat metrics dict) with
    ``Waymo/L{1,2}/{cls}/{AP,APH}`` keys plus L1/L2 means.
    """
    iou_thr = dict(DEFAULT_IOU, **(iou_thr or {}))
    metrics: Dict[str, float] = {}
    lines = ['Waymo detection metrics (native evaluator)',
             f'{"class":<22}{"L1 AP":>9}{"L1 APH":>9}'
             f'{"L2 AP":>9}{"L2 APH":>9}']
    for ci, cls in enumerate(classes):
        frames = []
        for gt, dt in zip(gts, dts):
            g_sel = np.asarray(gt['labels']) == ci
            gt_boxes = np.asarray(gt['boxes'], np.float64)[g_sel]
            if 'level' in gt:
                lv = np.asarray(gt['level'], np.int64)[g_sel]
            else:
                npts = gt.get('num_points')
                npts = (np.full(int(g_sel.sum()), 6) if npts is None
                        else np.asarray(npts)[g_sel])
                lv = assign_levels(npts)
            d_sel = np.asarray(dt['labels']) == ci
            frames.append(dict(
                gt_boxes=gt_boxes, gt_level=lv,
                dt_boxes=np.asarray(dt['boxes'], np.float64)[d_sel],
                dt_scores=np.asarray(dt['scores'], np.float64)[d_sel]))
        thr = iou_thr.get(cls, 0.5)
        row = []
        for level in (LEVEL_1, LEVEL_2):
            ap, aph = _eval_class_level(frames, thr, level)
            metrics[f'Waymo/L{level}/{cls}/AP'] = round(ap * 100, 4)
            metrics[f'Waymo/L{level}/{cls}/APH'] = round(aph * 100, 4)
            row += [ap * 100, aph * 100]
        lines.append(f'{cls:<22}' + ''.join(f'{v:9.2f}' for v in row))
    for level in (LEVEL_1, LEVEL_2):
        for kind in ('AP', 'APH'):
            vals = [metrics[f'Waymo/L{level}/{c}/{kind}'] for c in classes]
            metrics[f'Waymo/L{level}/m{kind}'] = round(
                float(np.mean(vals)) if vals else 0.0, 4)
    lines.append(f'{"mean":<22}' + ''.join(
        f'{metrics[f"Waymo/L{lv}/m{k}"]:9.2f}'
        for lv in (1, 2) for k in ('AP', 'APH')))
    # this is a native re-derivation of the published metric definition,
    # NOT the official waymo-open-dataset binary — label the output so no
    # downstream consumer mistakes it for official numbers
    metrics['protocol'] = 'native-proxy'
    return '\n'.join(lines), metrics
