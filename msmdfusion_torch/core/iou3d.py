"""Rotated BEV and 3D IoU of box sets, batched.

Counterpart of the JAX package's ``core/iou3d.py`` (reference
mmdet3d/ops/iou3d, ``BboxOverlaps3D`` with ``coordinate='lidar'``). The
intersection polygon of two rotated rectangles is built from a fixed set
of 24 candidate vertices (the 4 + 4 corners inside the other box and the
16 edge-pair intersections), sorted by angle around their centroid and
reduced with the shoelace formula: the same steps, in the same order, as
the JAX package's.
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def corners_bev(boxes_bev):
    """[..., 5] (cx, cy, w, l, yaw) -> [..., 4, 2] corners,
    counter-clockwise."""
    cx, cy, w, l, yaw = boxes_bev.unbind(-1)
    dx = torch.stack([w, w, -w, -w], -1) * 0.5
    dy = torch.stack([-l, l, l, -l], -1) * 0.5
    cos, sin = torch.cos(yaw)[..., None], torch.sin(yaw)[..., None]
    rx = dx * cos - dy * sin + cx[..., None]
    ry = dx * sin + dy * cos + cy[..., None]
    return torch.stack([rx, ry], -1)


def _point_in_quad(points, quad):
    """points [..., K, 2] inside the convex quad [..., 4, 2] (ccw)."""
    a = quad
    edge = torch.roll(quad, -1, dims=-2) - a                  # [..., 4, 2]
    rel = points[..., :, None, :] - a[..., None, :, :]        # [..., K, 4, 2]
    cross = edge[..., None, :, 0] * rel[..., 1] - \
        edge[..., None, :, 1] * rel[..., 0]
    return (cross >= -1e-6).all(-1)


def _segment_intersections(quad_a, quad_b):
    """The 16 edge-pair intersection points [..., 16, 2] and their mask."""
    a0 = quad_a
    a1 = torch.roll(quad_a, -1, dims=-2)
    b0 = quad_b
    b1 = torch.roll(quad_b, -1, dims=-2)
    p, r = a0[..., :, None, :], (a1 - a0)[..., :, None, :]
    q, s = b0[..., None, :, :], (b1 - b0)[..., None, :, :]
    denom = r[..., 0] * s[..., 1] - r[..., 1] * s[..., 0]     # [..., 4, 4]
    qmp = q - p
    t = (qmp[..., 0] * s[..., 1] - qmp[..., 1] * s[..., 0]) / (denom + _EPS)
    u = (qmp[..., 0] * r[..., 1] - qmp[..., 1] * r[..., 0]) / (denom + _EPS)
    valid = (denom.abs() > _EPS) & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    pts = p + t[..., None] * r
    lead = pts.shape[:-3]
    return pts.reshape(*lead, 16, 2), valid.reshape(*lead, 16)


def _convex_area(points, valid):
    """Shoelace area of the convex polygon of the valid points [..., M, 2]
    (sorted by angle around their centroid; invalid slots take the first
    vertex, adding no area)."""
    num_valid = valid.sum(-1)
    w = valid.to(points.dtype)
    centroid = (points * w[..., None]).sum(-2) / \
        torch.clamp(num_valid, min=1)[..., None].to(points.dtype)
    rel = points - centroid[..., None, :]
    ang = torch.where(valid, torch.atan2(rel[..., 1], rel[..., 0]),
                      torch.full_like(rel[..., 0], 1e10))
    order = torch.argsort(ang, dim=-1, stable=True)
    sorted_pts = torch.gather(points, -2,
                              order[..., None].expand_as(points))
    sorted_valid = torch.gather(valid, -1, order)
    sorted_pts = torch.where(sorted_valid[..., None], sorted_pts,
                             sorted_pts[..., :1, :])
    nxt = torch.roll(sorted_pts, -1, dims=-2)
    cross = sorted_pts[..., 0] * nxt[..., 1] - sorted_pts[..., 1] * nxt[..., 0]
    area = 0.5 * cross.sum(-1).abs()
    return torch.where(num_valid >= 3, area, torch.zeros_like(area))


def boxes_overlap_bev(boxes_a, boxes_b):
    """[N, 5], [M, 5] (cx, cy, w, l, yaw) -> [N, M] intersection areas."""
    qa = corners_bev(boxes_a)[:, None].expand(-1, boxes_b.shape[0], 4, 2)
    qb = corners_bev(boxes_b)[None].expand(boxes_a.shape[0], -1, 4, 2)
    a_in_b = _point_in_quad(qa, qb)
    b_in_a = _point_in_quad(qb, qa)
    inter_pts, inter_valid = _segment_intersections(qa, qb)
    points = torch.cat([qa, qb, inter_pts], -2)               # [N, M, 24, 2]
    valid = torch.cat([a_in_b, b_in_a, inter_valid], -1)
    return _convex_area(points, valid)


def boxes_iou_bev(boxes_a, boxes_b):
    """Pairwise rotated BEV IoU [N, M] of [N, 5], [M, 5] (cx, cy, w, l,
    yaw) boxes (reference ops/iou3d/iou3d_utils.py:6-24)."""
    overlap = boxes_overlap_bev(boxes_a, boxes_b)
    area_a = boxes_a[:, 2] * boxes_a[:, 3]
    area_b = boxes_b[:, 2] * boxes_b[:, 3]
    union = area_a[:, None] + area_b[None, :] - overlap
    return overlap / torch.clamp(union, min=_EPS)


def boxes_iou_3d(boxes_a, boxes_b, mode: str = 'iou'):
    """Pairwise 3D IoU [N, M] of bottom-centre boxes [N, 7+], [M, 7+]: BEV
    polygon overlap times vertical overlap over the union of volumes
    (``mode='iof'``: over the volume of ``boxes_a``)."""
    def bev(b):
        return torch.cat([b[:, 0:2], b[:, 3:5], b[:, 6:7]], -1)
    overlap_bev = boxes_overlap_bev(bev(boxes_a), bev(boxes_b))
    za0, za1 = boxes_a[:, 2], boxes_a[:, 2] + boxes_a[:, 5]
    zb0, zb1 = boxes_b[:, 2], boxes_b[:, 2] + boxes_b[:, 5]
    z_overlap = torch.clamp(
        torch.minimum(za1[:, None], zb1[None, :])
        - torch.maximum(za0[:, None], zb0[None, :]), min=0.0)
    inter = overlap_bev * z_overlap
    vol_a = boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5]
    vol_b = boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5]
    if mode == 'iou':
        union = vol_a[:, None] + vol_b[None, :] - inter
    else:
        union = vol_a[:, None].expand_as(inter)
    return inter / torch.clamp(union, min=_EPS)
