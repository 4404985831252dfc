"""Batched voxelization with the mean voxel encoder fused in.

Counterpart of the JAX package's ``ops/voxelize.py``
(``compute_voxel_coords``, ``voxelize_mean_batch``): one stable sort of the
packed (b, z, y, x) keys over the whole batch, a segment mean of the point
features, and output rows in ascending key order so that the sparse
encoder skips its own sort. Past ``max_voxels_total`` the highest keys are
dropped and counted at ``voxelize.mean_batch.voxel_cap``.

The segment sums run in a fixed order, so a frame's voxel features are the
same bits on every run: after the sort each voxel's points are one
contiguous run, summed in point order (``segment_sum``: one sequential
sum per voxel and channel; a float ``index_add_`` on the card adds by
atomics in no fixed order, and its last-bit differences grew to ~3e-5 of
the dense heatmap between two forwards).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..utils import overflow
from .sparse.tensor import INT_MAX


def compute_voxel_coords(points, voxel_size, point_cloud_range):
    """Per-point voxel coords (z, y, x) int32, in-range mask, grid (X, Y, Z).

    The float32 arithmetic (subtract, divide, floor) is the JAX package's,
    so a point on a voxel boundary lands in the same voxel.
    """
    vs = torch.tensor(voxel_size, dtype=points.dtype, device=points.device)
    pcr = torch.tensor(point_cloud_range, dtype=points.dtype,
                       device=points.device)
    grid = torch.round((pcr[3:] - pcr[:3]) / vs).to(torch.int32)
    cxyz = torch.floor((points[:, :3] - pcr[:3]) / vs).to(torch.int32)
    in_range = ((cxyz >= 0) & (cxyz < grid)).all(dim=-1)
    return cxyz.flip(-1), in_range, grid


def grid_shape(voxel_size: Sequence[float],
               point_cloud_range: Sequence[float]) -> Tuple[int, int, int]:
    """Static (Z, Y, X) voxel grid of a range."""
    vs = [float(v) for v in voxel_size]
    pcr = [float(v) for v in point_cloud_range]
    return (int(round((pcr[5] - pcr[2]) / vs[2])),
            int(round((pcr[4] - pcr[1]) / vs[1])),
            int(round((pcr[3] - pcr[0]) / vs[0])))


def segment_sum(x, seg, n: int):
    """[n, C] sums of the rows of ``x`` [N, C] by segment id ``seg`` [N]:
    the rows with an id below ``n`` come first, in non-decreasing id
    order; the others (parked) are dropped. Each segment is summed in row
    order from 0 (``torch.segment_reduce``: one sequential sum per segment
    and channel), the same bits on every run and device. Each parked row
    is a segment of its own, so that no sum walks all of them, and the
    segments' lengths come from a search of the sorted ids (no host
    sync)."""
    rows = seg.shape[0]
    ids = torch.where(seg < n, seg,
                      n + torch.arange(rows, device=seg.device))
    bounds = torch.searchsorted(
        ids, torch.arange(n + rows + 1, device=seg.device))
    return torch.segment_reduce(x, 'sum', lengths=bounds[1:] - bounds[:-1],
                                axis=0, unsafe=True)[:n]


def voxelize_mean_batch(points, point_mask, voxel_size, point_cloud_range,
                        max_voxels_total: int):
    """points [B, N, F], point_mask [B, N] -> (feats [V, F], coors [V, 4]
    int32 (b, z, y, x), valid [V]) with V = ``max_voxels_total``."""
    b, n, f = points.shape
    dev = points.device
    flat = points.reshape(b * n, f)
    mask = point_mask.reshape(b * n)
    coords, in_range, _ = compute_voxel_coords(flat, voxel_size,
                                               point_cloud_range)
    gz, gy, gx = grid_shape(voxel_size, point_cloud_range)
    if b * gz * gy * gx >= 2 ** 31:
        raise ValueError('voxel key space exceeds int32')
    batch_ids = torch.arange(b, device=dev).repeat_interleave(n)
    c = coords.to(torch.int64)
    key = (batch_ids * gz + c[:, 0]) * gy * gx + c[:, 1] * gx + c[:, 2]
    key = torch.where(in_range & mask, key, INT_MAX).to(torch.int32)

    skey, order = torch.sort(key, stable=True)
    sorted_valid = skey != INT_MAX
    head = torch.cat([sorted_valid[:1],
                      (skey[1:] != skey[:-1]) & sorted_valid[1:]])
    slot = torch.cumsum(head.to(torch.int64), 0) - 1
    v = max_voxels_total
    n_vox = head.sum()
    overflow.record('voxelize.mean_batch.voxel_cap',
                    torch.clamp(n_vox - v, min=0))
    overflow.gauge('occ.voxelize_mean', n_vox)
    keep = sorted_valid & (slot < v)
    seg = torch.where(keep, slot, v)

    sorted_feats = flat[order]
    aug = torch.cat([torch.where(keep[:, None], sorted_feats, 0),
                     keep.to(flat.dtype)[:, None]], dim=1)
    sums_counts = segment_sum(aug, seg, v)
    sums = sums_counts[:, :f]
    counts = sums_counts[:, f]
    feats = sums / torch.clamp(counts[:, None], min=1)
    voxel_valid = counts > 0

    # the j-th group head's key lands in slot j (written once per slot;
    # the rest park on the spare row v)
    out_keys = torch.full((v + 1,), INT_MAX, dtype=torch.int32, device=dev)
    out_keys.index_copy_(0, torch.where(head & keep, slot, v), skey)
    k = out_keys[:v].to(torch.int64)
    xc = k % gx
    rest = k // gx
    yc = rest % gy
    rest = rest // gy
    zc = rest % gz
    bc = rest // gz
    coors = torch.stack([bc, zc, yc, xc], dim=-1).to(torch.int32)
    coors = torch.where(voxel_valid[:, None], coors, -1)
    feats = torch.where(voxel_valid[:, None], feats, 0)
    return feats, coors, voxel_valid
