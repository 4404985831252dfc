"""3D box geometry (LiDAR frame, bottom-centre boxes).

Counterpart of the JAX package's ``core/boxes.py`` ``corners_3d``
(reference ``LiDARInstance3DBoxes.corners``,
mmdet3d/core/bbox/structures/lidar_box3d.py:46-86), ``points_in_rbbox``
on ``box_frame`` (reference points_in_boxes_cuda.cu:51), ``limit_period`` and
``xywhr2xyxyr`` (mmdet3d/core/bbox/structures/utils.py): boxes are plain
``[..., 7+]`` tensors ``(x, y, z, w, l, h, yaw[, vx, vy])`` with the
origin at the bottom centre ``(0.5, 0.5, 0)``.
"""
from __future__ import annotations

import math

import torch

# unit-cube corners (x, y, z) in the reference order (000, 001, 011, 010,
# 110, 111, 101, 100), shifted to the bottom-centre origin
_UNIT = ((0, 0, 0), (0, 0, 1), (0, 1, 1), (0, 1, 0),
         (1, 1, 0), (1, 1, 1), (1, 0, 1), (1, 0, 0))


def corners_3d(boxes):
    """[..., 7+] boxes -> [..., 8, 3] corners: the unit cube scaled by the
    dims, rotated by the yaw about z and moved to the box's bottom centre."""
    unit = torch.tensor(_UNIT, dtype=boxes.dtype, device=boxes.device) \
        - boxes.new_tensor([0.5, 0.5, 0.0])
    corners = unit * boxes[..., None, 3:6]                    # [..., 8, 3]
    yaw = boxes[..., 6:7]
    cos, sin = torch.cos(yaw), torch.sin(yaw)
    x = corners[..., 0] * cos - corners[..., 1] * sin
    y = corners[..., 0] * sin + corners[..., 1] * cos
    return torch.stack([x, y, corners[..., 2]], -1) + boxes[..., None, :3]


def box_frame(points, boxes):
    """points [P, 3+], boxes [N, 7] -> ((lx, ly, lz), inside), each [P, N]:
    each point moved into each box's frame (translated to the bottom
    centre, rotated by -yaw), and whether it lies within the half width
    and length and within [0, h] above the bottom centre."""
    local = points[:, None, :3] - boxes[None, :, :3]          # [P, N, 3]
    yaw = boxes[:, 6]
    cos, sin = torch.cos(-yaw), torch.sin(-yaw)
    lx = local[..., 0] * cos - local[..., 1] * sin
    ly = local[..., 0] * sin + local[..., 1] * cos
    lz = local[..., 2]
    inside = ((lx.abs() <= boxes[:, 3] * 0.5) & (ly.abs() <= boxes[:, 4] * 0.5)
              & (lz >= 0) & (lz <= boxes[:, 5]))
    return (lx, ly, lz), inside


def points_in_rbbox(points, boxes):
    """points [P, 3+], boxes [N, 7] -> [P, N] bool (``box_frame``)."""
    return box_frame(points, boxes)[1]


def limit_period(val, offset: float = 0.5, period: float = math.pi):
    """``val`` moved into [-offset * period, (1 - offset) * period)."""
    return val - torch.floor(val / period + offset) * period


def xywhr2xyxyr(boxes_xywhr):
    """[..., 5] (cx, cy, w, l, yaw) -> (x1, y1, x2, y2, yaw)."""
    half_w = boxes_xywhr[..., 2:3] / 2
    half_l = boxes_xywhr[..., 3:4] / 2
    return torch.cat([
        boxes_xywhr[..., 0:1] - half_w, boxes_xywhr[..., 1:2] - half_l,
        boxes_xywhr[..., 0:1] + half_w, boxes_xywhr[..., 1:2] + half_l,
        boxes_xywhr[..., 4:5]], -1)
