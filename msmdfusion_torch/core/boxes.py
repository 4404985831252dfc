"""3D box geometry (LiDAR frame, bottom-centre boxes).

Counterpart of the JAX package's ``core/boxes.py`` ``corners_3d``
(reference ``LiDARInstance3DBoxes.corners``,
mmdet3d/core/bbox/structures/lidar_box3d.py:46-86): boxes are plain
``[..., 7+]`` tensors ``(x, y, z, w, l, h, yaw[, vx, vy])`` with the
origin at the bottom centre ``(0.5, 0.5, 0)``.
"""
from __future__ import annotations

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
