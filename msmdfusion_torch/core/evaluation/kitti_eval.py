"""Official KITTI detection evaluation protocol (numpy).

Counterpart of the JAX package's ``core/evaluation/kitti_eval.py``,
copied: a re-derivation of the reference's numba evaluator
(mmdet3d/core/evaluation/kitti_utils/eval.py:8-780, rotate_iou.py:378):
three difficulty buckets (occlusion/truncation/2D-height gating), 2D bbox /
BEV / 3D / AOS metrics, DontCare regions, neighbor-class ignores (Van for
Car, Person_sitting for Pedestrian), 41-point recall-sampled thresholds and
AP-R40 averaging. Runs on the CPU (protocol code, not a hot path) over the
standard KITTI annotation dicts::

    {'name': [N] str, 'truncated': [N], 'occluded': [N], 'alpha': [N],
     'bbox': [N, 4], 'dimensions': [N, 3] (l, h, w), 'location': [N, 3]
     (camera frame), 'rotation_y': [N], ('score': [N] for detections)}
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

CLASS_NAMES = ['car', 'pedestrian', 'cyclist', 'van', 'person_sitting']
MIN_HEIGHT = [40, 25, 25]            # px, per difficulty
MAX_OCCLUSION = [0, 1, 2]
MAX_TRUNCATION = [0.15, 0.3, 0.5]
N_SAMPLE_PTS = 41
NO_DETECTION = -10 ** 7


# ---------------------------------------------------------------------------
# overlaps
# ---------------------------------------------------------------------------

def image_box_overlap(boxes: np.ndarray, query_boxes: np.ndarray,
                      criterion: int = -1) -> np.ndarray:
    """2D box overlap [N, K]; criterion -1: IoU, 0: /box area, 1: /query.

    Reference eval.py:84-113.
    """
    n, k = len(boxes), len(query_boxes)
    if n == 0 or k == 0:
        return np.zeros((n, k), np.float64)
    b = boxes[:, None, :]
    q = query_boxes[None, :, :]
    iw = (np.minimum(b[..., 2], q[..., 2])
          - np.maximum(b[..., 0], q[..., 0]))
    ih = (np.minimum(b[..., 3], q[..., 3])
          - np.maximum(b[..., 1], q[..., 1]))
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    area_q = (q[..., 2] - q[..., 0]) * (q[..., 3] - q[..., 1])
    if criterion == -1:
        denom = area_b + area_q - inter
    elif criterion == 0:
        denom = np.broadcast_to(area_b, inter.shape)
    else:
        denom = np.broadcast_to(area_q, inter.shape)
    return np.where(denom > 0, inter / np.maximum(denom, 1e-12), 0.0)


def _rect_corners(boxes5: np.ndarray) -> np.ndarray:
    """[N, 5] (cx, cy, w, l, angle) -> [N, 4, 2] corners (camera BEV uses
    (x, z, dx, dz, ry); the math is frame-agnostic)."""
    cx, cy, w, l, ang = (boxes5[:, i] for i in range(5))
    dx = np.stack([w, w, -w, -w], 1) * 0.5
    dy = np.stack([-l, l, l, -l], 1) * 0.5
    c, s = np.cos(ang)[:, None], np.sin(ang)[:, None]
    return np.stack([dx * c - dy * s + cx[:, None],
                     dx * s + dy * c + cy[:, None]], axis=-1)


def _poly_clip(subject: np.ndarray, clip: np.ndarray) -> np.ndarray:
    """Sutherland-Hodgman convex clip (both CCW)."""
    out = list(subject)
    m = len(clip)
    for i in range(m):
        a, b = clip[i], clip[(i + 1) % m]
        edge = (b[0] - a[0], b[1] - a[1])
        inp, out = out, []
        if not inp:
            break
        prev = inp[-1]
        # interior of a CCW polygon is to the LEFT of each edge: cross >= 0
        prev_in = edge[0] * (prev[1] - a[1]) - edge[1] * (prev[0] - a[0]) >= 0
        for cur in inp:
            cur_in = edge[0] * (cur[1] - a[1]) - edge[1] * (cur[0] - a[0]) >= 0
            if cur_in != prev_in:
                dx, dy = cur[0] - prev[0], cur[1] - prev[1]
                denom = edge[0] * dy - edge[1] * dx
                if abs(denom) > 1e-12:
                    t = (edge[0] * (a[1] - prev[1])
                         - edge[1] * (a[0] - prev[0])) / denom
                    out.append((prev[0] + t * dx, prev[1] + t * dy))
            if cur_in:
                out.append(tuple(cur))
            prev, prev_in = cur, cur_in
    return np.asarray(out) if out else np.zeros((0, 2))


def _poly_area(poly: np.ndarray) -> float:
    if len(poly) < 3:
        return 0.0
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def rotated_box_intersection(boxes: np.ndarray,
                             qboxes: np.ndarray) -> np.ndarray:
    """[N, 5] x [K, 5] rotated rectangle intersection AREAS [N, K].

    Reference: rotate_iou.py inter() (vertex enumeration + triangulation);
    here a Sutherland-Hodgman clip — same value, simpler code.
    """
    n, k = len(boxes), len(qboxes)
    inter = np.zeros((n, k), np.float64)
    if n == 0 or k == 0:
        return inter
    cb = _rect_corners(boxes.astype(np.float64))
    cq = _rect_corners(qboxes.astype(np.float64))
    # cheap reject: circumscribed circle distance
    rb = 0.5 * np.hypot(boxes[:, 2], boxes[:, 3])
    rq = 0.5 * np.hypot(qboxes[:, 2], qboxes[:, 3])
    d = np.hypot(boxes[:, None, 0] - qboxes[None, :, 0],
                 boxes[:, None, 1] - qboxes[None, :, 1])
    near = d <= (rb[:, None] + rq[None, :])
    for i, j in zip(*np.nonzero(near)):
        inter[i, j] = _poly_area(_poly_clip(cb[i], cq[j]))
    return inter


def bev_box_overlap(boxes: np.ndarray, qboxes: np.ndarray,
                    criterion: int = -1) -> np.ndarray:
    """Rotated BEV IoU [N, K] (reference eval.py:115-120)."""
    inter = rotated_box_intersection(boxes, qboxes)
    area_b = (boxes[:, 2] * boxes[:, 3])[:, None]
    area_q = (qboxes[:, 2] * qboxes[:, 3])[None, :]
    if criterion == -1:
        denom = area_b + area_q - inter
    elif criterion == 0:
        denom = np.broadcast_to(area_b, inter.shape)
    else:
        denom = np.broadcast_to(area_q, inter.shape)
    return np.where(denom > 0, inter / np.maximum(denom, 1e-12), 0.0)


def d3_box_overlap(boxes: np.ndarray, qboxes: np.ndarray,
                   criterion: int = -1) -> np.ndarray:
    """Camera-frame 3D IoU [N, K]: boxes [N, 7] (x, y, z, l, h, w, ry).

    Height overlap runs along -y (camera down); BEV polygon on (x, z).
    Reference eval.py:122-160.
    """
    n, k = len(boxes), len(qboxes)
    if n == 0 or k == 0:
        return np.zeros((n, k), np.float64)
    rinc = rotated_box_intersection(boxes[:, [0, 2, 3, 5, 6]],
                                    qboxes[:, [0, 2, 3, 5, 6]])
    b_top = boxes[:, 1][:, None]
    b_bot = (boxes[:, 1] - boxes[:, 4])[:, None]
    q_top = qboxes[None, :, 1]
    q_bot = (qboxes[:, 1] - qboxes[:, 4])[None, :]
    ih = np.clip(np.minimum(b_top, q_top) - np.maximum(b_bot, q_bot), 0, None)
    inter = rinc * ih
    vol_b = np.prod(boxes[:, 3:6], axis=1)[:, None]
    vol_q = np.prod(qboxes[:, 3:6], axis=1)[None, :]
    if criterion == -1:
        denom = vol_b + vol_q - inter
    elif criterion == 0:
        denom = np.broadcast_to(vol_b, inter.shape)
    else:
        denom = np.broadcast_to(vol_q, inter.shape)
    return np.where(denom > 0, inter / np.maximum(denom, 1e-12), 0.0)


def _overlap(gt: Dict, dt: Dict, metric: int) -> np.ndarray:
    """[num_dt, num_gt] overlap for one sample at the given metric."""
    if metric == 0:
        return image_box_overlap(dt['bbox'], gt['bbox'])
    loc_g, dim_g, rot_g = gt['location'], gt['dimensions'], gt['rotation_y']
    loc_d, dim_d, rot_d = dt['location'], dt['dimensions'], dt['rotation_y']
    if metric == 1:
        g = np.concatenate([loc_g[:, [0, 2]], dim_g[:, [0, 2]],
                            rot_g[:, None]], 1)
        d = np.concatenate([loc_d[:, [0, 2]], dim_d[:, [0, 2]],
                            rot_d[:, None]], 1)
        return bev_box_overlap(d, g)
    g = np.concatenate([loc_g, dim_g, rot_g[:, None]], 1)
    d = np.concatenate([loc_d, dim_d, rot_d[:, None]], 1)
    return d3_box_overlap(d, g)


# ---------------------------------------------------------------------------
# protocol
# ---------------------------------------------------------------------------

def get_thresholds(scores: np.ndarray, num_gt: int,
                   num_sample_pts: int = N_SAMPLE_PTS) -> List[float]:
    """Recall-sampled score thresholds (reference eval.py:8-26)."""
    scores = np.sort(scores)[::-1]
    current_recall = 0.0
    thresholds = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if (r_recall - current_recall < current_recall - l_recall
                and i < len(scores) - 1):
            continue
        thresholds.append(float(score))
        current_recall += 1 / (num_sample_pts - 1.0)
    return thresholds


def clean_data(gt: Dict, dt: Dict, current_class: int, difficulty: int):
    """Difficulty gating + neighbor-class ignores (reference eval.py:28-81).

    Returns (num_valid_gt, ignored_gt, ignored_dt, dc_bboxes) with the
    reference's 0 = counted / 1 = ignored / -1 = other-class encoding.
    """
    cls_name = CLASS_NAMES[current_class]
    ignored_gt, ignored_dt, dc_bboxes = [], [], []
    num_valid_gt = 0
    for i in range(len(gt['name'])):
        name = str(gt['name'][i]).lower()
        height = gt['bbox'][i, 3] - gt['bbox'][i, 1]
        if name == cls_name:
            valid = 1
        elif cls_name == 'pedestrian' and name == 'person_sitting':
            valid = 0
        elif cls_name == 'car' and name == 'van':
            valid = 0
        else:
            valid = -1
        ignore = (gt['occluded'][i] > MAX_OCCLUSION[difficulty]
                  or gt['truncated'][i] > MAX_TRUNCATION[difficulty]
                  or height <= MIN_HEIGHT[difficulty])
        if valid == 1 and not ignore:
            ignored_gt.append(0)
            num_valid_gt += 1
        elif valid == 0 or (ignore and valid == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
        if str(gt['name'][i]) == 'DontCare':
            dc_bboxes.append(gt['bbox'][i])
    for i in range(len(dt['name'])):
        valid = 1 if str(dt['name'][i]).lower() == cls_name else -1
        height = abs(dt['bbox'][i, 3] - dt['bbox'][i, 1])
        if height < MIN_HEIGHT[difficulty]:
            ignored_dt.append(1)
        elif valid == 1:
            ignored_dt.append(0)
        else:
            ignored_dt.append(-1)
    dc = (np.stack(dc_bboxes, 0).astype(np.float64) if dc_bboxes
          else np.zeros((0, 4), np.float64))
    return num_valid_gt, np.array(ignored_gt), np.array(ignored_dt), dc


def compute_statistics(overlaps, gt_datas, dt_datas, ignored_gt, ignored_det,
                       dc_bboxes, metric, min_overlap, thresh=0.0,
                       compute_fp=False, compute_aos=False):
    """Per-sample TP/FP/FN/AOS assignment (reference eval.py:162-280).

    overlaps is [num_dt, num_gt]; gt_datas [N, 5] (bbox, alpha); dt_datas
    [M, 6] (bbox, alpha, score).
    """
    det_size, gt_size = len(dt_datas), len(gt_datas)
    dt_scores = dt_datas[:, -1]
    dt_alphas = dt_datas[:, 4]
    gt_alphas = gt_datas[:, 4]
    assigned = np.zeros(det_size, bool)
    ignored_threshold = (dt_scores < thresh) if compute_fp \
        else np.zeros(det_size, bool)
    tp = fp = fn = 0
    similarity = 0.0
    thresholds, delta = [], []
    for i in range(gt_size):
        if ignored_gt[i] == -1:
            continue
        det_idx = -1
        valid_detection = NO_DETECTION
        max_overlap = 0.0
        assigned_ignored_det = False
        for j in range(det_size):
            if ignored_det[j] == -1 or assigned[j] or ignored_threshold[j]:
                continue
            overlap = overlaps[j, i]
            if (not compute_fp and overlap > min_overlap
                    and dt_scores[j] > valid_detection):
                det_idx = j
                valid_detection = dt_scores[j]
            elif (compute_fp and overlap > min_overlap
                  and (overlap > max_overlap or assigned_ignored_det)
                  and ignored_det[j] == 0):
                max_overlap = overlap
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = False
            elif (compute_fp and overlap > min_overlap
                  and valid_detection == NO_DETECTION
                  and ignored_det[j] == 1):
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = True
        if valid_detection == NO_DETECTION and ignored_gt[i] == 0:
            fn += 1
        elif (valid_detection != NO_DETECTION
              and (ignored_gt[i] == 1 or ignored_det[det_idx] == 1)):
            assigned[det_idx] = True
        elif valid_detection != NO_DETECTION:
            tp += 1
            thresholds.append(dt_scores[det_idx])
            if compute_aos:
                delta.append(gt_alphas[i] - dt_alphas[det_idx])
            assigned[det_idx] = True
    if compute_fp:
        for j in range(det_size):
            if not (assigned[j] or ignored_det[j] in (-1, 1)
                    or ignored_threshold[j]):
                fp += 1
        nstuff = 0
        if metric == 0 and len(dc_bboxes):
            ov_dc = image_box_overlap(dt_datas[:, :4], dc_bboxes, 0)
            for i in range(len(dc_bboxes)):
                for j in range(det_size):
                    if (assigned[j] or ignored_det[j] in (-1, 1)
                            or ignored_threshold[j]):
                        continue
                    if ov_dc[j, i] > min_overlap:
                        assigned[j] = True
                        nstuff += 1
        fp -= nstuff
        if compute_aos:
            tmp = [(1.0 + np.cos(d)) / 2.0 for d in delta]
            similarity = float(np.sum(tmp)) if (tp > 0 or fp > 0) else -1.0
    return tp, fp, fn, similarity, np.array(thresholds)


def eval_class(gt_annos: List[Dict], dt_annos: List[Dict],
               current_classes: Sequence[int], difficultys: Sequence[int],
               metric: int, min_overlaps: np.ndarray,
               compute_aos: bool = False) -> Dict[str, np.ndarray]:
    """Precision/recall/AOS curves (reference eval.py:450-570).

    min_overlaps: [num_minoverlap, 3 metrics, num_class].
    """
    assert len(gt_annos) == len(dt_annos)
    overlaps = [_overlap(gt, dt, metric)
                for gt, dt in zip(gt_annos, dt_annos)]
    nc, nd, no = len(current_classes), len(difficultys), len(min_overlaps)
    precision = np.zeros((nc, nd, no, N_SAMPLE_PTS))
    recall = np.zeros((nc, nd, no, N_SAMPLE_PTS))
    aos = np.zeros((nc, nd, no, N_SAMPLE_PTS))
    for m, cls in enumerate(current_classes):
        for d_i, difficulty in enumerate(difficultys):
            prepared = [clean_data(gt, dt, cls, difficulty)
                        for gt, dt in zip(gt_annos, dt_annos)]
            total_valid_gt = sum(p[0] for p in prepared)
            gt_datas = [np.concatenate(
                [gt['bbox'], gt['alpha'][:, None]], 1)
                for gt in gt_annos]
            dt_datas = [np.concatenate(
                [dt['bbox'], dt['alpha'][:, None], dt['score'][:, None]], 1)
                for dt in dt_annos]
            for k, min_overlap in enumerate(min_overlaps[:, metric, m]):
                all_thresh = []
                for i in range(len(gt_annos)):
                    _, _, _, _, th = compute_statistics(
                        overlaps[i], gt_datas[i], dt_datas[i],
                        prepared[i][1], prepared[i][2], prepared[i][3],
                        metric, min_overlap, compute_fp=False)
                    all_thresh += th.tolist()
                if total_valid_gt == 0:
                    continue
                thresholds = np.array(
                    get_thresholds(np.array(all_thresh), total_valid_gt))
                pr = np.zeros((len(thresholds), 4))
                for i in range(len(gt_annos)):
                    for t, th in enumerate(thresholds):
                        tp, fp, fn, sim, _ = compute_statistics(
                            overlaps[i], gt_datas[i], dt_datas[i],
                            prepared[i][1], prepared[i][2], prepared[i][3],
                            metric, min_overlap, thresh=th,
                            compute_fp=True, compute_aos=compute_aos)
                        pr[t, 0] += tp
                        pr[t, 1] += fp
                        pr[t, 2] += fn
                        if sim != -1:
                            pr[t, 3] += sim
                for i in range(len(thresholds)):
                    recall[m, d_i, k, i] = pr[i, 0] / max(
                        pr[i, 0] + pr[i, 2], 1e-12)
                    precision[m, d_i, k, i] = pr[i, 0] / max(
                        pr[i, 0] + pr[i, 1], 1e-12)
                    if compute_aos:
                        aos[m, d_i, k, i] = pr[i, 3] / max(
                            pr[i, 0] + pr[i, 1], 1e-12)
                # right-cummax smoothing
                for i in range(len(thresholds)):
                    precision[m, d_i, k, i] = precision[m, d_i, k, i:].max()
                    recall[m, d_i, k, i] = recall[m, d_i, k, i:].max()
                    if compute_aos:
                        aos[m, d_i, k, i] = aos[m, d_i, k, i:].max()
    return {'recall': recall, 'precision': precision, 'orientation': aos}


def get_mAP_R40(prec: np.ndarray) -> np.ndarray:
    """AP-R40: mean of 40 of the 41 sample points (reference eval.py:577)."""
    return prec[..., 1:].sum(-1) / 40 * 100


def do_eval(gt_annos, dt_annos, current_classes, min_overlaps,
            eval_types=('bbox', 'bev', '3d')):
    difficultys = [0, 1, 2]
    mAP_bbox = mAP_aos = mAP_bev = mAP_3d = None
    if 'bbox' in eval_types:
        ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 0,
                         min_overlaps, compute_aos='aos' in eval_types)
        mAP_bbox = get_mAP_R40(ret['precision'])
        if 'aos' in eval_types:
            mAP_aos = get_mAP_R40(ret['orientation'])
    if 'bev' in eval_types:
        ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 1,
                         min_overlaps)
        mAP_bev = get_mAP_R40(ret['precision'])
    if '3d' in eval_types:
        ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 2,
                         min_overlaps)
        mAP_3d = get_mAP_R40(ret['precision'])
    return mAP_bbox, mAP_bev, mAP_3d, mAP_aos


def kitti_eval(gt_annos: List[Dict], dt_annos: List[Dict],
               current_classes, eval_types=('bbox', 'bev', '3d')
               ) -> Tuple[str, Dict[str, float]]:
    """Full KITTI eval -> (printable report, metric dict).

    Reference eval.py:649-780 (same min-overlap table and key naming).
    """
    eval_types = list(eval_types)
    overlap_0_7 = np.array([[0.7, 0.5, 0.5, 0.7, 0.5]] * 3)
    overlap_0_5 = np.array([[0.7, 0.5, 0.5, 0.7, 0.5],
                            [0.5, 0.25, 0.25, 0.5, 0.25],
                            [0.5, 0.25, 0.25, 0.5, 0.25]])
    min_overlaps = np.stack([overlap_0_7, overlap_0_5], 0)   # [2, 3, 5]
    class_to_name = {0: 'Car', 1: 'Pedestrian', 2: 'Cyclist', 3: 'Van',
                     4: 'Person_sitting'}
    name_to_class = {v: n for n, v in class_to_name.items()}
    if not isinstance(current_classes, (list, tuple)):
        current_classes = [current_classes]
    current_classes = [name_to_class[c] if isinstance(c, str) else int(c)
                       for c in current_classes]
    min_overlaps = min_overlaps[:, :, current_classes]
    # AOS only when both sides carry valid alphas (reference :694-708)
    pred_alpha = any(len(d['alpha']) for d in dt_annos)
    valid_alpha_gt = any(len(g['alpha']) and g['alpha'][0] != -10
                         for g in gt_annos)
    if pred_alpha and valid_alpha_gt and 'bbox' in eval_types \
            and 'aos' not in eval_types:
        eval_types.append('aos')
    mAPbbox, mAPbev, mAP3d, mAPaos = do_eval(
        gt_annos, dt_annos, current_classes, min_overlaps, eval_types)
    result = ''
    ret: Dict[str, float] = {}
    difficulty = ['easy', 'moderate', 'hard']
    for j, curcls in enumerate(current_classes):
        name = class_to_name[curcls]
        for i in range(min_overlaps.shape[0]):
            result += ('{} AP@{:.2f}, {:.2f}, {:.2f}:\n'.format(
                name, *min_overlaps[i, :, j]))
            for label, arr in [('bbox', mAPbbox), ('bev ', mAPbev),
                               ('3d  ', mAP3d), ('aos ', mAPaos)]:
                if arr is not None:
                    result += '{} AP:{:.4f}, {:.4f}, {:.4f}\n'.format(
                        label, *arr[j, :, i])
            for idx in range(3):
                postfix = (f'{difficulty[idx]}_strict' if i == 0
                           else f'{difficulty[idx]}_loose')
                prefix = f'KITTI/{name}'
                if mAP3d is not None:
                    ret[f'{prefix}_3D_{postfix}'] = float(mAP3d[j, idx, i])
                if mAPbev is not None:
                    ret[f'{prefix}_BEV_{postfix}'] = float(mAPbev[j, idx, i])
                if mAPbbox is not None:
                    ret[f'{prefix}_2D_{postfix}'] = float(mAPbbox[j, idx, i])
    if len(current_classes) > 1:
        result += '\nOverall AP@{}, {}, {}:\n'.format(*difficulty)
        for label, arr in [('bbox', mAPbbox), ('bev ', mAPbev),
                           ('3d  ', mAP3d), ('aos ', mAPaos)]:
            if arr is not None:
                mean = arr.mean(axis=0)
                result += '{} AP:{:.4f}, {:.4f}, {:.4f}\n'.format(
                    label, *mean[:, 0])
        for idx in range(3):
            if mAP3d is not None:
                ret[f'KITTI/Overall_3D_{difficulty[idx]}'] = float(
                    mAP3d.mean(axis=0)[idx, 0])
            if mAPbev is not None:
                ret[f'KITTI/Overall_BEV_{difficulty[idx]}'] = float(
                    mAPbev.mean(axis=0)[idx, 0])
            if mAPbbox is not None:
                ret[f'KITTI/Overall_2D_{difficulty[idx]}'] = float(
                    mAPbbox.mean(axis=0)[idx, 0])
    return result, ret
