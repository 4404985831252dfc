"""Camera/LiDAR/Depth box frames: Box3DMode / Coord3DMode conversions.

Counterpart of the JAX package's ``core/box_modes.py`` (reference
mmdet3d/core/bbox/structures/{box_3d_mode.py:12-165, cam_box3d.py:9-308,
coord_3d_mode.py:12-281}), in numpy: boxes stay plain ``[N, 7+]`` arrays
``(x, y, z, dx, dy, dz, yaw[, ...])`` and the frame is an explicit mode
argument. Only the conversions and the camera-frame corners that the
KITTI reader uses are ported. Arrays keep their dtype (float32 boxes give
float32 results, as the JAX package's computes them). ``convert_points``
also takes torch tensors (ImVoteNet's ``VoteFusion`` on the card): the
same matrices, applied on the tensor's device, with no copy to the host;
each frame's constant matrices are copied to a device once and kept.

Frame conventions (identical to the reference):

- LIDAR: x front, y left, z up; yaw about z; bottom-center origin
  ``(0.5, 0.5, 0)``; box dims ``(w=x_size, l=y_size, h=z_size)``.
- CAM: x right, y down, z front; yaw about y; origin ``(0.5, 1.0, 0.5)``;
  dims ``(x_size, y_size=height, z_size)``.
- DEPTH: x right, y front, z up; yaw about z; origin ``(0.5, 0.5, 0)``.
"""
from __future__ import annotations

import numpy as np
import torch

LIDAR = 0
CAM = 1
DEPTH = 2

# default sensor-frame change-of-basis (reference box_3d_mode.py:100-130)
_DEFAULT_RT = {
    (LIDAR, CAM): np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], np.float32),
    (CAM, LIDAR): np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32),
    (DEPTH, CAM): np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32),
    (CAM, DEPTH): np.array([[1, 0, 0], [0, 0, 1], [0, -1, 0]], np.float32),
    (LIDAR, DEPTH): np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32),
    (DEPTH, LIDAR): np.array([[0, 1, 0], [-1, 0, 0], [0, 0, 1]], np.float32),
}

# how (x_size, y_size, z_size) columns permute under each conversion
# (reference box_3d_mode.py:102-128: e.g. LIDAR->CAM keeps [y, z, x])
_SIZE_PERM = {
    (LIDAR, CAM): (1, 2, 0),
    (CAM, LIDAR): (2, 0, 1),
    (DEPTH, CAM): (0, 2, 1),
    (CAM, DEPTH): (0, 2, 1),
    (LIDAR, DEPTH): (1, 0, 2),
    (DEPTH, LIDAR): (1, 0, 2),
}

# unit-cube corners in the reference order (cam_box3d.py:101-140)
_CORNER_ORDER = np.stack(np.unravel_index(np.arange(8), [2] * 3),
                         axis=1)[[0, 1, 3, 2, 4, 5, 7, 6]].astype(np.float32)


_ON_DEVICE = {}


def _constant(pair, like):
    """The default change of basis of ``pair`` as a tensor on ``like``'s
    device and dtype (copied there once)."""
    key = (pair, like.device, like.dtype)
    if key not in _ON_DEVICE:
        _ON_DEVICE[key] = torch.as_tensor(_DEFAULT_RT[pair], dtype=like.dtype,
                                          device=like.device)
    return _ON_DEVICE[key]


def _apply_rt(xyz, rt_mat):
    if torch.is_tensor(xyz):
        rt_mat = torch.as_tensor(rt_mat, dtype=xyz.dtype, device=xyz.device)
        if rt_mat.shape[-1] == 4:
            xyz = torch.cat([xyz, torch.ones_like(xyz[..., :1])], -1)
            return (xyz @ rt_mat.T)[..., :3]
        return xyz @ rt_mat.T
    rt_mat = np.asarray(rt_mat, xyz.dtype)
    if rt_mat.shape[-1] == 4:
        ones = np.ones(xyz.shape[:-1] + (1,), xyz.dtype)
        return (np.concatenate([xyz, ones], -1) @ rt_mat.T)[..., :3]
    return xyz @ rt_mat.T


def convert_boxes(boxes, src: int, dst: int, rt_mat=None):
    """Box3DMode.convert for plain arrays (box_3d_mode.py:60-165).

    ``boxes`` [N, 7+] in the ``src`` frame -> [N, 7+] in ``dst`` (the
    trailing columns kept); ``rt_mat``: an optional [3, 3] or [3/4, 4]
    change of basis in place of the canonical axis permutation (e.g. a
    real cam2lidar extrinsic).
    """
    if src == dst:
        return boxes
    if (src, dst) not in _SIZE_PERM:
        raise NotImplementedError(f'Box3DMode {src} -> {dst}')
    boxes = np.asarray(boxes)
    if rt_mat is None:
        rt_mat = _DEFAULT_RT[(src, dst)]
    xyz = _apply_rt(boxes[..., :3], rt_mat)
    size = boxes[..., 3:6][..., list(_SIZE_PERM[(src, dst)])]
    yaw = boxes[..., 6:7]
    # this package's LiDAR yaw is counter-clockwise (core/boxes.py), so
    # LiDAR <-> CAM/DEPTH conversions negate it to keep the corners'
    # geometry (the reference passes it through, its LiDAR corners rotating
    # clockwise)
    if (src == LIDAR) != (dst == LIDAR):
        yaw = -yaw
    return np.concatenate([xyz, size, yaw, boxes[..., 7:]], axis=-1)


def convert_points(points, src: int, dst: int, rt_mat=None):
    """Coord3DMode.convert_point for plain arrays (coord_3d_mode.py:180-281);
    extra feature columns (intensity, ring, ...) pass through unchanged."""
    if src == dst:
        return points
    if (src, dst) not in _DEFAULT_RT:
        raise NotImplementedError(f'Coord3DMode {src} -> {dst}')
    if torch.is_tensor(points):
        if rt_mat is None:
            rt_mat = _constant((src, dst), points)
        elif (src, dst) == (DEPTH, CAM):
            rt_mat = _constant((DEPTH, CAM), points) @ rt_mat.T
        elif (src, dst) == (CAM, DEPTH):
            rt_mat = rt_mat @ _constant((CAM, DEPTH), points)
        xyz = _apply_rt(points[..., :3], rt_mat)
        return torch.cat([xyz, points[..., 3:]], -1)
    points = np.asarray(points)
    if rt_mat is None:
        rt_mat = _DEFAULT_RT[(src, dst)]
    elif (src, dst) == (DEPTH, CAM):
        # the reference composes the canonical flip with the given Rt
        rt_mat = _DEFAULT_RT[(DEPTH, CAM)].astype(points.dtype) @ \
            np.asarray(rt_mat).T
    elif (src, dst) == (CAM, DEPTH):
        rt_mat = np.asarray(rt_mat) @ \
            _DEFAULT_RT[(CAM, DEPTH)].astype(points.dtype)
    xyz = _apply_rt(points[..., :3], rt_mat)
    return np.concatenate([xyz, points[..., 3:]], axis=-1)


def rotation_3d_in_axis(points, angles, axis: int = 0):
    """[N, M, 3] points rotated by per-set angles about a coordinate axis
    (reference structures/utils.py:40-76; axis 1 is the CAM yaw axis,
    2 the LiDAR one), ``points @ rot_mat_T`` as the reference."""
    sin, cos = np.sin(angles), np.cos(angles)
    one = np.ones_like(sin)
    zero = np.zeros_like(sin)
    if axis == 1:
        rot = np.stack([
            np.stack([cos, zero, -sin], -1),
            np.stack([zero, one, zero], -1),
            np.stack([sin, zero, cos], -1)], -2)
    elif axis in (2, -1):
        rot = np.stack([
            np.stack([cos, -sin, zero], -1),
            np.stack([sin, cos, zero], -1),
            np.stack([zero, zero, one], -1)], -2)
    elif axis == 0:
        rot = np.stack([
            np.stack([one, zero, zero], -1),
            np.stack([zero, cos, -sin], -1),
            np.stack([zero, sin, cos], -1)], -2)
    else:
        raise ValueError(f'axis should be in range [0, 2], got {axis}')
    return np.einsum('nmj,njk->nmk', points, rot)


def cam_corners_3d(boxes):
    """[N, 8, 3] corners of CAM-frame boxes (cam_box3d.py:101-140)."""
    boxes = np.asarray(boxes)
    corners_norm = _CORNER_ORDER.astype(boxes.dtype) - np.asarray(
        [0.5, 1.0, 0.5], boxes.dtype)
    corners = boxes[..., 3:6][:, None, :] * corners_norm[None]
    corners = rotation_3d_in_axis(corners, boxes[..., 6], axis=1)
    return corners + boxes[:, None, :3]
