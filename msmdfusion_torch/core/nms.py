"""Rotated, circle, multi-class and axis-aligned NMS, fixed shape.

Counterpart of the JAX package's ``core/nms.py`` (reference
mmdet3d/ops/iou3d/src/iou3d_kernel.cu ``nms_kernel``, numba ``circle_nms``
and mmdet3d/core/post_processing/box3d_nms.py). Candidates are ordered by
score (a stable sort: equal scores keep their index order, as
``jnp.argsort``), a pairwise suppression matrix is built at once, and the
greedy scan over it gives a keep mask in that order.

The greedy scan (JAX: one ``fori_loop`` step per candidate) is the unique
fixed point of ``keep = valid & ~any_i(suppress[i, j] & keep[i])`` over
earlier candidates i: after t rounds of that map the first t candidates
hold their final value, so the map reaches the scan's keep set, and stays
there, within N rounds; in practice within a few, since a round settles
every candidate whose suppressors have settled. Each round is one device
op over all of the matrix (and every class or sample at once); the
rounds run in blocks of ``ROUNDS`` between host checks of the fixed point,
instead of one launch per candidate (10,000 for PointPillars' ten classes
of 1,000).
"""
from __future__ import annotations

import torch

from .iou3d import boxes_iou_bev

NEG_INF = -1e9
ROUNDS = 8          # rounds of the fixed-point map between host checks


def greedy_suppress(suppress, valid):
    """suppress [..., N, N] bool ((i, j): candidate i, ranked higher,
    suppresses j; only i < j counts), valid [..., N] -> keep [..., N]: the
    greedy scan's."""
    n = suppress.shape[-1]
    later = torch.ones(n, n, dtype=torch.bool,
                       device=suppress.device).triu(1)
    s = suppress & later
    keep = valid
    for _ in range(0, n + 1, ROUNDS):
        prev = keep
        for _round in range(ROUNDS):
            keep = valid & ~(s & keep[..., :, None]).any(-2)
        if torch.equal(keep, prev):
            break
    return keep


def score_order(scores, valid):
    """Candidates by descending score, the masked ones (score ``NEG_INF``)
    last; ties by the lower index."""
    return torch.argsort(-torch.where(valid, scores, NEG_INF), dim=-1,
                         stable=True)


def _post_max(keep, post_max_size):
    if post_max_size is None:
        return keep
    rank = torch.cumsum(keep.to(torch.int64), -1) - 1
    return keep & (rank < post_max_size)


def nms_bev(boxes_bev, scores, thresh: float, valid=None,
            pre_max_size=None, post_max_size=None):
    """Rotated BEV NMS of boxes [N, 5] (cx, cy, w, l, yaw) -> (keep [N'],
    order [N']): keep over the score order, ``order`` indexing the input;
    N' = ``pre_max_size`` where it is below N."""
    n = boxes_bev.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=boxes_bev.device)
    order = score_order(scores, valid)
    if pre_max_size is not None and pre_max_size < n:
        order = order[:pre_max_size]
    b = boxes_bev[order]
    keep = greedy_suppress(boxes_iou_bev(b, b) > thresh, valid[order])
    return _post_max(keep, post_max_size), order


def circle_nms(centers_xy, scores, radius: float, valid=None,
               post_max_size=None):
    """Distance NMS (reference numba ``circle_nms``): a candidate whose
    centre lies within ``radius`` of a kept higher-scored one's goes.
    centers_xy [..., N, 2], scores [..., N] -> (keep, order), batched over
    the leading axes."""
    if valid is None:
        valid = torch.ones_like(scores, dtype=torch.bool)
    order = score_order(scores, valid)
    pts = torch.gather(centers_xy, -2, order[..., None].expand(
        *order.shape, 2))
    diff = pts[..., :, None, :] - pts[..., None, :, :]
    dist2 = (diff * diff).sum(-1)
    keep = greedy_suppress(dist2 < radius * radius,
                           torch.gather(valid, -1, order))
    return _post_max(keep, post_max_size), order


def box3d_multiclass_nms(boxes_3d, boxes_bev, scores, score_thr: float,
                         nms_thr: float, max_num: int, valid=None):
    """Per-class rotated NMS over score columns, fixed-capacity out.

    boxes_3d [N, 7+], boxes_bev [N, 5], scores [N, C] -> dict 'boxes'
    [max_num, 7+], 'scores', 'labels', 'valid' [max_num]: the kept
    (box, class) pairs by descending score. The BEV IoU is computed once
    for all pairs and read in each class's score order (each pair's IoU is
    its own computation, wherever it sits)."""
    n, num_classes = scores.shape
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=scores.device)
    cls_scores = scores.t()                                   # [C, N]
    cls_valid = valid[None] & (cls_scores > score_thr)
    order = score_order(cls_scores, cls_valid)
    iou = boxes_iou_bev(boxes_bev, boxes_bev)
    sorted_iou = iou[order[:, :, None], order[:, None, :]]    # [C, N, N]
    keep = greedy_suppress(sorted_iou > nms_thr,
                           torch.gather(cls_valid, 1, order))
    keep_in = torch.zeros_like(keep).scatter_(1, order, keep) & cls_valid
    cat_scores = cls_scores.reshape(-1)
    cat_keep = keep_in.reshape(-1)
    cat_labels = torch.arange(num_classes, device=scores.device
                              ).repeat_interleave(n)
    top = torch.argsort(-torch.where(cat_keep, cat_scores, NEG_INF),
                        stable=True)[:max_num]
    return {'boxes': boxes_3d[top % n], 'scores': cat_scores[top],
            'labels': cat_labels[top], 'valid': cat_keep[top]}


def aligned_3d_nms(boxes_xyzxyz, scores, classes, thresh: float,
                   valid=None):
    """Axis-aligned 3D NMS within each class (reference box3d_nms.py
    ``aligned_3d_nms``): boxes [N, 6] (x1, y1, z1, x2, y2, z2) -> (keep
    [N] over the score order, order [N])."""
    n = boxes_xyzxyz.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=scores.device)
    order = score_order(scores, valid)
    b = boxes_xyzxyz[order]
    cls = classes[order]
    lo = torch.maximum(b[:, None, :3], b[None, :, :3])
    hi = torch.minimum(b[:, None, 3:], b[None, :, 3:])
    inter = torch.clamp(hi - lo, min=0.0).prod(-1)
    vol = (b[:, 3:] - b[:, :3]).prod(-1)
    union = vol[:, None] + vol[None, :] - inter
    iou = inter / torch.clamp(union, min=1e-8)
    same_class = cls[:, None] == cls[None, :]
    keep = greedy_suppress((iou > thresh) & same_class, valid[order])
    return keep, order
