"""Host voxel generator (numpy).

Counterpart of the JAX package's ``core/voxel_generator.py`` (reference
numba VoxelGenerator, mmdet3d/core/voxel/voxel_generator.py:5-279):
first-come-first-served hard voxelization on the host, used by
``VoxelBasedPointSampler``.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


class VoxelGenerator:
    """points -> (voxels, coords, num_points_per_voxel)."""

    def __init__(self, voxel_size: Sequence[float],
                 point_cloud_range: Sequence[float],
                 max_num_points: int, max_voxels: int = 20000):
        self.voxel_size = np.asarray(voxel_size, np.float32)
        self.point_cloud_range = np.asarray(point_cloud_range, np.float32)
        self.max_num_points = int(max_num_points)
        self.max_voxels = int(max_voxels)
        grid = (self.point_cloud_range[3:] -
                self.point_cloud_range[:3]) / self.voxel_size
        self.grid_size = np.round(grid).astype(np.int64)

    def generate(self, points: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """[N, D] points -> (voxels [V, P, D], coords [V, 3] (z, y, x),
        num_points [V]): voxels in the order of their first point, each
        voxel's points in arrival order, both capped."""
        lo = self.point_cloud_range[:3]
        c = np.floor((points[:, :3] - lo) / self.voxel_size).astype(np.int64)
        idx = np.nonzero(np.all((c >= 0) & (c < self.grid_size), 1))[0]
        c = c[idx]
        key = (c[:, 2] * self.grid_size[1] + c[:, 1]) * self.grid_size[0] \
            + c[:, 0]
        uniq, first, inv = np.unique(key, return_index=True,
                                     return_inverse=True)
        order = np.argsort(first, kind='stable')
        slot_of_uniq = np.empty(len(uniq), np.int64)
        slot_of_uniq[order] = np.arange(len(uniq))
        slot = slot_of_uniq[inv]
        keep_voxel = slot < self.max_voxels
        n_vox = min(len(uniq), self.max_voxels)

        voxels = np.zeros((n_vox, self.max_num_points, points.shape[1]),
                          points.dtype)
        coords = np.zeros((n_vox, 3), np.int32)
        arrival = np.argsort(slot, kind='stable')
        counts = np.bincount(slot, minlength=len(uniq))
        starts = np.zeros(len(uniq) + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        ranks = np.empty(len(slot), np.int64)
        ranks[arrival] = np.arange(len(slot)) - starts[slot[arrival]]
        keep_pt = keep_voxel & (ranks < self.max_num_points)
        voxels[slot[keep_pt], ranks[keep_pt]] = points[idx[keep_pt]]
        first_pt = keep_voxel & (ranks == 0)
        coords[slot[first_pt]] = np.stack(
            [c[:, 2][first_pt], c[:, 1][first_pt], c[:, 0][first_pt]], 1)
        num_points = np.minimum(counts[:n_vox],
                                self.max_num_points).astype(np.int32)
        return voxels, coords, num_points
