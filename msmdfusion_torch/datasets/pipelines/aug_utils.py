"""Vectorized box-collision utilities for per-object augmentation.

Counterpart of the JAX package's ``datasets/pipelines/aug_utils.py``
(reference mmdet3d/datasets/pipelines/data_augment_utils.py):
``box_collision_test`` (:30-127, segment-intersection and full-containment
test between corner sets), ``noise_per_box`` (:129-165, greedy
first-passing try) and ``noise_per_object_v3`` (:328-408, the transform
applied to boxes and points). Semantics match the reference:

- collision = any strict segment crossing between the two rectangles OR
  either rectangle completely containing the other (touching edges do
  not collide);
- boxes are processed in order and a successful noise updates the corner
  set later boxes collide against (greedy sequential dependency);
- a point inside several boxes takes the FIRST valid box's transform.

The noise is drawn from the generator the caller passes (the loader seeds
one per sample); numpy's global generator is never read.
"""
from __future__ import annotations

import numpy as np

from ...core.box_np_ops import (center_to_corner_box2d,
                                corner_to_standup_nd, points_in_rbbox_np,
                                rotation_points_single_angle)
from .loading import require_rng


def _segments_cross(a, b, c, d):
    """Strict proper-crossing test for segment batches.

    a, b: [..., 2] endpoints of the first segments; c, d of the second.
    Matches the reference's orientation predicate pairs (acd != bcd and
    abc != abd), data_augment_utils.py:70-85.
    """
    def orient(p, q, r):
        return ((r[..., 1] - p[..., 1]) * (q[..., 0] - p[..., 0]) >
                (q[..., 1] - p[..., 1]) * (r[..., 0] - p[..., 0]))

    acd = orient(a, c, d)
    bcd = orient(b, c, d)
    abc = orient(a, b, c)
    abd = orient(a, b, d)
    return (acd != bcd) & (abc != abd)


def _contains_all(corners, points):
    """Whether each convex quad (consistently-ordered corners [..., 4, 2])
    contains ALL query points [..., K, 2] (strict, reference :88-118).
    Orientation-agnostic: inside = all edge crosses share one sign."""
    nxt = np.roll(corners, -1, axis=-2)
    edge = nxt - corners                                 # [..., 4, 2]
    rel = points[..., None, :, :] - corners[..., :, None, :]  # [...,4,K,2]
    cross = (edge[..., :, None, 0] * rel[..., 1] -
             edge[..., :, None, 1] * rel[..., 0])        # [..., 4, K]
    return (np.all(cross > 0, axis=(-2, -1)) |
            np.all(cross < 0, axis=(-2, -1)))


def box_collision_test(boxes, qboxes):
    """[N, 4, 2] corners vs [K, 4, 2] corners -> [N, K] bool collision.

    Corner order must be consistent rotational order (the corner sets
    produced by ``center_to_corner_box2d`` are counter-clockwise in
    standard axes). Reference: data_augment_utils.py:30-127.
    """
    boxes = np.asarray(boxes, np.float64)
    qboxes = np.asarray(qboxes, np.float64)
    n, k = boxes.shape[0], qboxes.shape[0]
    if n == 0 or k == 0:
        return np.zeros((n, k), bool)

    # standup-bbox prefilter (reference :49-59)
    bs = corner_to_standup_nd(boxes)
    qs = corner_to_standup_nd(qboxes)
    iw = (np.minimum(bs[:, None, 2], qs[None, :, 2]) -
          np.maximum(bs[:, None, 0], qs[None, :, 0]))
    ih = (np.minimum(bs[:, None, 3], qs[None, :, 3]) -
          np.maximum(bs[:, None, 1], qs[None, :, 1]))
    overlap = (iw > 0) & (ih > 0)

    # all 4x4 segment pairs, broadcast to [N, K, 4, 4]
    b0 = boxes                                            # [N, 4, 2]
    b1 = np.roll(boxes, -1, axis=1)
    q0 = qboxes
    q1 = np.roll(qboxes, -1, axis=1)
    cross = _segments_cross(
        b0[:, None, :, None, :], b1[:, None, :, None, :],
        q0[None, :, None, :, :], q1[None, :, None, :, :]).any(axis=(2, 3))

    # complete containment either way (reference :88-118)
    contains = (_contains_all(boxes[:, None], qboxes[None, :]) |
                _contains_all(qboxes[None, :], boxes[:, None]))
    return overlap & (cross | contains)


def noise_per_box(boxes_bev, valid_mask, loc_noises, rot_noises):
    """Greedy per-box noise selection (reference noise_per_box :129-165).

    boxes_bev: [N, 5] (cx, cy, dx, dy, yaw); loc_noises [N, T, 3];
    rot_noises [N, T]. Returns success index per box (-1 = no try passed).
    The corner set is updated in order, so earlier boxes' accepted noise
    constrains later boxes exactly as in the reference.
    """
    boxes_bev = np.asarray(boxes_bev, np.float64)
    n, t = rot_noises.shape
    box_corners = center_to_corner_box2d(
        boxes_bev[:, :2], boxes_bev[:, 2:4], boxes_bev[:, 4])  # [N, 4, 2]
    success = -np.ones(n, np.int64)
    for i in range(n):
        if not valid_mask[i]:
            continue
        # all T candidate corner sets at once: rotate around the CURRENT
        # center, then translate (reference :151-155)
        local = box_corners[i] - boxes_bev[i, :2]         # [4, 2]
        sin = np.sin(rot_noises[i])
        cos = np.cos(rot_noises[i])
        # same R^T as rotation_2d / the reference's _rotation_box2d_jit_,
        # so corner rotation composes with the yaw update below
        rot = np.stack([np.stack([cos, -sin], -1),
                        np.stack([sin, cos], -1)], -2)    # [T, 2, 2]
        cand = local[None] @ rot + (boxes_bev[i, :2] +
                                    loc_noises[i, :, :2])[:, None]  # [T,4,2]
        coll = box_collision_test(cand, box_corners)       # [T, N]
        coll[:, i] = False
        ok = ~coll.any(axis=1)
        j = int(np.argmax(ok))
        if ok[j]:
            success[i] = j
            box_corners[i] = cand[j]
    return success


def noise_per_object_v3(gt_boxes, points=None, valid_mask=None,
                        rotation_perturb=np.pi / 4, center_noise_std=1.0,
                        global_random_rot_range=np.pi / 4, num_try=100,
                        rng=None):
    """Random per-object rotate/translate with collision rejection.

    In-place on ``gt_boxes`` [N, >=7] and ``points`` [M, >=3] (reference
    noise_per_object_v3_ :328-408). The global-rotation variant
    (enable_grot, noise_per_box_v2_) is only reachable from configs with
    a non-degenerate ``global_rot_range`` — none of the reference's
    shipped configs use it — and is intentionally not implemented.
    ``rng``: the np.random.RandomState the noise is drawn from.
    """
    rng = require_rng(rng, 'noise_per_object_v3')
    num_boxes = gt_boxes.shape[0]
    if num_boxes == 0:
        return
    if not isinstance(rotation_perturb, (list, tuple, np.ndarray)):
        rotation_perturb = [-rotation_perturb, rotation_perturb]
    if not isinstance(global_random_rot_range, (list, tuple, np.ndarray)):
        global_random_rot_range = [-global_random_rot_range,
                                   global_random_rot_range]
    if abs(global_random_rot_range[0] - global_random_rot_range[1]) >= 1e-3:
        raise NotImplementedError(
            'global_rot_range is unused by every shipped reference config; '
            'the v2 noise path is not implemented')
    if not isinstance(center_noise_std, (list, tuple, np.ndarray)):
        center_noise_std = [center_noise_std] * 3
    if valid_mask is None:
        valid_mask = np.ones(num_boxes, bool)

    loc_noises = rng.normal(
        scale=center_noise_std, size=[num_boxes, num_try, 3])
    rot_noises = rng.uniform(
        rotation_perturb[0], rotation_perturb[1], size=[num_boxes, num_try])

    selected = noise_per_box(gt_boxes[:, [0, 1, 3, 4, 6]], valid_mask,
                             loc_noises, rot_noises)
    sel = np.maximum(selected, 0)
    loc_t = np.where((selected >= 0)[:, None],
                     loc_noises[np.arange(num_boxes), sel], 0.0)
    rot_t = np.where(selected >= 0,
                     rot_noises[np.arange(num_boxes), sel], 0.0)

    if points is not None and len(points):
        point_masks = points_in_rbbox_np(points[:, :3], gt_boxes)
        # first valid box claims the point (reference points_transform_
        # breaks at the first match, :300-308)
        claim = np.where(point_masks & valid_mask[None, :],
                         np.arange(num_boxes)[None, :], num_boxes)
        first = claim.min(axis=1)
        for j in range(num_boxes):
            if not valid_mask[j]:
                continue
            m = first == j
            if not m.any():
                continue
            local = points[m, :3] - gt_boxes[j, :3]
            rotated, _ = rotation_points_single_angle(local, rot_t[j],
                                                      axis=2)
            points[m, :3] = rotated + gt_boxes[j, :3] + loc_t[j]

    apply = valid_mask & (selected >= 0)
    gt_boxes[apply, :3] += loc_t[apply]
    gt_boxes[apply, 6] += rot_t[apply]
