"""Numpy box math for the CPU data pipeline.

Counterpart of the JAX package's ``core/box_np_ops.py`` (reference
mmdet3d/core/bbox/box_np_ops.py): the subset that the GT-paste sampler,
the per-object noise, the GT-database tool and the KITTI reader need,
copied, numpy only: corners, point-in-rotated-box, frame transforms,
projections and range masks.
"""
from __future__ import annotations

import numpy as np


def corners_bev_np(boxes):
    """[N, 5] (cx, cy, w, l, yaw) -> [N, 4, 2] ccw corners."""
    cx, cy, w, l, yaw = [boxes[:, i] for i in range(5)]
    dx = np.stack([w, w, -w, -w], axis=1) * 0.5
    dy = np.stack([-l, l, l, -l], axis=1) * 0.5
    c, s = np.cos(yaw)[:, None], np.sin(yaw)[:, None]
    rx = dx * c - dy * s + cx[:, None]
    ry = dx * s + dy * c + cy[:, None]
    return np.stack([rx, ry], axis=-1)


def corners_3d_np(boxes):
    """[N, 7] bottom-center boxes -> [N, 8, 3] corners."""
    dims = boxes[:, 3:6]
    unit = np.array([[0, 0, 0], [0, 0, 1], [0, 1, 1], [0, 1, 0],
                     [1, 1, 0], [1, 1, 1], [1, 0, 1], [1, 0, 0]],
                    boxes.dtype) - [0.5, 0.5, 0.0]
    corners = unit[None] * dims[:, None, :]
    yaw = boxes[:, 6]
    c, s = np.cos(yaw), np.sin(yaw)
    x = corners[..., 0] * c[:, None] - corners[..., 1] * s[:, None]
    y = corners[..., 0] * s[:, None] + corners[..., 1] * c[:, None]
    out = np.stack([x, y, corners[..., 2]], axis=-1)
    return out + boxes[:, None, :3]


def points_in_rbbox_np(points, boxes):
    """points [P, 3], boxes [N, 7+] -> [P, N] bool."""
    if len(boxes) == 0:
        return np.zeros((len(points), 0), bool)
    local = points[:, None, :3] - boxes[None, :, :3]
    yaw = boxes[:, 6]
    c, s = np.cos(-yaw), np.sin(-yaw)
    lx = local[..., 0] * c[None] - local[..., 1] * s[None]
    ly = local[..., 0] * s[None] + local[..., 1] * c[None]
    lz = local[..., 2]
    return ((np.abs(lx) <= boxes[:, 3] * 0.5) &
            (np.abs(ly) <= boxes[:, 4] * 0.5) &
            (lz >= 0) & (lz <= boxes[:, 5]))


# ---------------------------------------------------------------------------
# frame transforms (reference box_np_ops.py:8-47)
# ---------------------------------------------------------------------------

def camera_to_lidar(points, r_rect, velo2cam):
    """Camera-frame points -> LiDAR frame via (rect @ velo2cam)^-1."""
    n = points.shape[0]
    hom = np.concatenate([points[:, :3], np.ones((n, 1), points.dtype)], 1)
    lidar = hom @ np.linalg.inv((r_rect @ velo2cam).T)
    return np.concatenate([lidar[:, :3], points[:, 3:]], axis=1)


def lidar_to_camera(points, r_rect, velo2cam):
    n = points.shape[0]
    hom = np.concatenate([points[:, :3], np.ones((n, 1), points.dtype)], 1)
    cam = hom @ (r_rect @ velo2cam).T
    return np.concatenate([cam[:, :3], points[:, 3:]], axis=1)


def box_camera_to_lidar(data, r_rect, velo2cam):
    """[N, 7] camera boxes (x, y, z, l, h, w, ry) -> LiDAR
    (x, y, z, w, l, h, yaw) with yaw = -ry - pi/2 (SECOND convention)."""
    xyz = camera_to_lidar(data[:, :3], r_rect, velo2cam)
    l, h, w = data[:, 3:4], data[:, 4:5], data[:, 5:6]
    r = data[:, 6:7]
    return np.concatenate([xyz, w, l, h, -r - np.pi / 2], axis=1)


def box_lidar_to_camera(data, r_rect, velo2cam):
    xyz = lidar_to_camera(data[:, :3], r_rect, velo2cam)
    w, l, h = data[:, 3:4], data[:, 4:5], data[:, 5:6]
    yaw = data[:, 6:7]
    return np.concatenate([xyz, l, h, w, -yaw - np.pi / 2], axis=1)


# ---------------------------------------------------------------------------
# corners (reference box_np_ops.py:48-305, 793-857)
# ---------------------------------------------------------------------------

def corners_nd(dims, origin=0.5):
    """Relative box corners per dim length + origin ([N, 2^d, d]).

    Corner order matches the reference (2d: clockwise from min point; 3d:
    the standard mmdet3d enumeration), box_np_ops.py:48-79.
    """
    ndim = int(dims.shape[1])
    corners_norm = np.stack(
        np.unravel_index(np.arange(2 ** ndim), [2] * ndim),
        axis=1).astype(dims.dtype)
    if ndim == 2:
        corners_norm = corners_norm[[0, 1, 3, 2]]
    elif ndim == 3:
        corners_norm = corners_norm[[0, 1, 3, 2, 4, 5, 7, 6]]
    corners_norm = corners_norm - np.array(origin, dtype=dims.dtype)
    return dims.reshape(-1, 1, ndim) * corners_norm.reshape(1, 2 ** ndim,
                                                            ndim)


def rotation_2d(points, angles):
    """Rotate [N, P, 2] point sets clockwise-positive (reference :81-96)."""
    c, s = np.cos(angles), np.sin(angles)
    rot_t = np.stack([[c, -s], [s, c]])          # [2, 2, N]
    return np.einsum('aij,jka->aik', points, rot_t)


def rotation_3d_in_axis_np(points, angles, axis=0):
    """Rotate [N, P, 3] point sets about a coordinate axis (:170-199)."""
    c, s = np.cos(angles), np.sin(angles)
    ones, zeros = np.ones_like(c), np.zeros_like(c)
    if axis == 1:
        rot_t = np.stack([[c, zeros, -s], [zeros, ones, zeros],
                          [s, zeros, c]])
    elif axis in (2, -1):
        rot_t = np.stack([[c, -s, zeros], [s, c, zeros],
                          [zeros, zeros, ones]])
    elif axis == 0:
        rot_t = np.stack([[ones, zeros, zeros], [zeros, c, -s],
                          [zeros, s, c]])
    else:
        raise ValueError(f'axis should be in range [0, 2], got {axis}')
    return np.einsum('aij,jka->aik', points, rot_t)


def rotation_points_single_angle(points, angle, axis=0):
    """Rotate [N, 3] points by one angle; returns (points, rot_mat_T)."""
    out = rotation_3d_in_axis_np(points[None, :, :3],
                                 np.asarray([angle]), axis=axis)[0]
    rot_t = rotation_3d_in_axis_np(np.eye(3)[None],
                                   np.asarray([angle]), axis=axis)[0]
    if points.shape[1] > 3:
        out = np.concatenate([out, points[:, 3:]], axis=1)
    return out, rot_t


def center_to_corner_box2d(centers, dims, angles=None, origin=0.5):
    """[N, 2] centers + dims (+ angles) -> [N, 4, 2] corners (:98-119)."""
    corners = corners_nd(dims, origin=origin)
    if angles is not None:
        corners = rotation_2d(corners, angles)
    return corners + centers.reshape(-1, 1, 2)


def corner_to_standup_nd(boxes_corner):
    """[N, P, d] corners -> [N, 2d] axis-aligned minmax boxes (:262-280)."""
    return np.concatenate([boxes_corner.min(axis=1),
                           boxes_corner.max(axis=1)], axis=1)
