"""Voxelization: hard (per-voxel point buffers), dynamic (per-point
coords and a segment reduce) and batched with the mean voxel encoder fused
in.

Counterpart of the JAX package's ``ops/voxelize.py`` (reference
mmdet3d/ops/voxel/src/voxelization_cuda.cu ``hard_voxelize``,
``dynamic_voxelize``, and scatter_points.py ``DynamicScatter``).
``voxelize_mean_batch``: one stable sort of the packed (b, z, y, x) keys
over the whole batch, a segment mean of the point features, and output
rows in ascending key order so that the sparse encoder skips its own sort.
Past ``max_voxels_total`` the highest keys are dropped and counted at
``voxelize.mean_batch.voxel_cap``.

``hard_voxelize`` and ``dynamic_scatter`` give voxel slots in the order of
each voxel's first point, as the reference's first-come hash table does:
a stable sort of the keys groups the points, and each group's rank by its
first point's index is its slot (an inverse permutation: no scatter with
repeated indices). Past ``max_voxels`` the latest voxels are dropped
(``voxelize.hard.voxel_cap``, ``voxelize.dynamic_scatter.voxel_cap``),
past ``max_points`` a voxel's latest points
(``voxelize.hard.point_truncation``).

The segment sums run in a fixed order, so a frame's voxel features are the
same bits on every run: after the sort each voxel's points are one
contiguous run, summed in point order (``segment_sum``: one sequential
sum per voxel and channel; a float ``index_add_`` on the card adds by
atomics in no fixed order, and its last-bit differences grew to ~3e-5 of
the dense heatmap between two forwards).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

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


def segment_sum(x, seg, n: int, reduce: str = 'sum'):
    """[n, C] sums of the rows of ``x`` [N, C] by segment id ``seg`` [N]:
    the rows with an id below ``n`` come first, in non-decreasing id
    order; the others (parked) are dropped. Each segment is summed in row
    order from 0 (``torch.segment_reduce``: one sequential sum per segment
    and channel), the same bits on every run and device. Each parked row
    is a segment of its own, so that no sum walks all of them, and the
    segments' lengths come from a search of the sorted ids (no host
    sync). ``reduce='max'``: the maxima instead (-inf where a segment is
    empty)."""
    rows = seg.shape[0]
    ids = torch.where(seg < n, seg,
                      n + torch.arange(rows, device=seg.device))
    bounds = torch.searchsorted(
        ids, torch.arange(n + rows + 1, device=seg.device))
    return torch.segment_reduce(x, reduce, lengths=bounds[1:] - bounds[:-1],
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


class VoxelizationResult(NamedTuple):
    """voxels [V, P, F] (zero padded), num_points [V], coors [V, 3] int32
    (z, y, x; -1 on empty slots), valid [V]."""
    voxels: torch.Tensor
    num_points: torch.Tensor
    coors: torch.Tensor
    valid: torch.Tensor


def _first_come_groups(key):
    """The points of ``key`` [N] (INT_MAX: invalid) grouped by a stable
    sort: (order, sorted_valid, head, group_id, slot_of_group) with
    ``slot_of_group`` [N] each group's rank by its first point's index (the
    JAX ``argsort(argsort(first_orig))``, both sorts stable; empty groups
    rank last) and ``group_of_slot`` its inverse."""
    n = key.shape[0]
    dev = key.device
    skey, order = torch.sort(key, stable=True)
    sorted_valid = skey != INT_MAX
    head = torch.cat([sorted_valid[:1],
                      (skey[1:] != skey[:-1]) & sorted_valid[1:]])
    group_id = torch.cumsum(head.to(torch.int64), 0) - 1
    group_id = torch.where(sorted_valid, group_id, n - 1)
    first_orig = torch.full((n,), INT_MAX, dtype=torch.int64, device=dev)
    first_orig.scatter_reduce_(
        0, group_id, torch.where(sorted_valid, order, INT_MAX), 'amin')
    group_of_slot = torch.argsort(first_orig, stable=True)
    slot_of_group = torch.empty_like(group_of_slot)
    slot_of_group[group_of_slot] = torch.arange(n, device=dev)
    return (order, sorted_valid, head, group_id, slot_of_group,
            group_of_slot)


def _linear_key(coords, grid, valid):
    z, y, x = (coords[:, i].to(torch.int64) for i in range(3))
    key = (z * grid[1] + y) * grid[2] + x
    return torch.where(valid, key, INT_MAX)


def _on_spill(values, index, rows: int, fill):
    """[rows, ...] filled with ``fill``, ``values`` copied to ``index``;
    an index of ``rows`` (repeated, unlike the others) lands on a spare
    row that is dropped."""
    out = torch.full((rows + 1,) + values.shape[1:], fill,
                     dtype=values.dtype, device=values.device)
    out.index_copy_(0, index, values)
    return out[:rows]


def hard_voxelize(points, point_mask, voxel_size, point_cloud_range,
                  max_points: int, max_voxels: int) -> VoxelizationResult:
    """points [N, F] (xyz first), point_mask [N] -> fixed-capacity voxels
    of at most ``max_points`` points each, at most ``max_voxels`` of them,
    in the order of their first point."""
    n, f = points.shape
    dev = points.device
    coords, in_range, _ = compute_voxel_coords(points, voxel_size,
                                               point_cloud_range)
    grid = grid_shape(voxel_size, point_cloud_range)
    key = _linear_key(coords, grid, in_range & point_mask)
    order, sorted_valid, head, group_id, slot_of_group, _ = \
        _first_come_groups(key)
    pos = torch.arange(n, device=dev)
    start_pos = torch.full((n,), INT_MAX, dtype=torch.int64, device=dev)
    start_pos.scatter_reduce_(
        0, group_id, torch.where(sorted_valid, pos, INT_MAX), 'amin')
    slot = slot_of_group[group_id]
    in_cap_voxel = slot < max_voxels
    rank_in_voxel = pos - start_pos[group_id]
    keep = sorted_valid & in_cap_voxel & (rank_in_voxel < max_points)
    overflow.record('voxelize.hard.point_truncation',
                    (sorted_valid & in_cap_voxel
                     & (rank_in_voxel >= max_points)).sum())
    overflow.record('voxelize.hard.voxel_cap', (head & ~in_cap_voxel).sum())

    cells = max_voxels * max_points
    flat_idx = torch.where(keep, slot * max_points + rank_in_voxel, cells)
    voxels = _on_spill(points[order], flat_idx, cells, 0.0).reshape(
        max_voxels, max_points, f)
    num_points = torch.zeros(max_voxels + 1, dtype=torch.int32, device=dev)
    num_points.index_add_(0, torch.where(keep, slot, max_voxels),
                          keep.to(torch.int32))
    num_points = num_points[:max_voxels]
    coors = _on_spill(coords[order],
                      torch.where(head & in_cap_voxel, slot, max_voxels),
                      max_voxels, -1)
    voxel_valid = num_points > 0
    coors = torch.where(voxel_valid[:, None], coors, -1)
    return VoxelizationResult(voxels, num_points, coors, voxel_valid)


def dynamic_voxelize(points, point_mask, voxel_size, point_cloud_range):
    """Per-point voxel coords [N, 3] (z, y, x; -1 where the point is
    masked or out of range) and that validity [N]."""
    coords, in_range, _ = compute_voxel_coords(points, voxel_size,
                                               point_cloud_range)
    valid = in_range & point_mask
    return torch.where(valid[:, None], coords, -1), valid


def dynamic_scatter(feats, coords_zyx, valid, grid_zyx: Tuple[int, int, int],
                    max_voxels: int, mode: str = 'mean'):
    """Reduce point features [N, C] into their voxels (``mode`` 'mean' or
    'max') -> (voxel_feats [V, C], voxel_coors [V, 3], voxel_valid [V],
    point_slot [N]: each point's voxel slot, -1 where it has none).

    Each voxel's rows are one contiguous run of the sorted points, reduced
    in point order (``segment_sum``: the same bits on every run); the
    voxels then take their slots by a gather."""
    n, c = feats.shape
    dev = feats.device
    if mode not in ('mean', 'max'):
        raise ValueError(mode)
    key = _linear_key(coords_zyx, grid_zyx, valid)
    order, sorted_valid, head, group_id, slot_of_group, group_of_slot = \
        _first_come_groups(key)
    slot = slot_of_group[group_id]
    keep = sorted_valid & (slot < max_voxels)
    n_vox = head.sum()
    overflow.record('voxelize.dynamic_scatter.voxel_cap',
                    n_vox - torch.clamp(n_vox, max=max_voxels))
    # every valid point's group (ascending; the invalid points sort last):
    # a group past the cap is reduced too, and never taken
    seg = torch.where(sorted_valid, group_id, n)
    sorted_feats = feats[order]
    counts = segment_sum(sorted_valid.to(feats.dtype)[:, None], seg, n)[:, 0]
    if mode == 'mean':
        sums = segment_sum(torch.where(sorted_valid[:, None], sorted_feats,
                                       0), seg, n)
        group_feats = sums / torch.clamp(counts[:, None], min=1)
    else:
        group_feats = segment_sum(sorted_feats, seg, n, 'max')
    take = group_of_slot[:max_voxels]
    if take.shape[0] < max_voxels:          # more slots than points
        take = torch.cat([take, take.new_full((max_voxels - n,), n)])
    group_feats = torch.cat([group_feats, group_feats.new_zeros(1, c)])
    counts = torch.cat([counts, counts.new_zeros(1)])
    voxel_valid = counts[take] > 0
    voxel_feats = torch.where(voxel_valid[:, None], group_feats[take], 0.0)

    coors = _on_spill(coords_zyx[order].to(torch.int32),
                      torch.where(head & (slot < max_voxels), slot,
                                  max_voxels), max_voxels, -1)
    coors = torch.where(voxel_valid[:, None], coors, -1)
    point_slot = torch.empty(n, dtype=torch.int32, device=dev)
    point_slot[order] = torch.where(keep, slot, -1).to(torch.int32)
    return voxel_feats, coors, voxel_valid, point_slot


def voxelize_batch(points, point_mask, voxel_size, point_cloud_range,
                   max_points: int, max_voxels: int):
    """points [B, N, F], point_mask [B, N] -> each sample's
    ``hard_voxelize`` concatenated: voxels [B*V, P, F], num_points [B*V],
    coors [B*V, 4] (b, z, y, x; -1 on empty slots), valid [B*V]
    (reference MVXTwoStageDetector.voxelize, mvx_two_stage.py:248-273)."""
    res = [hard_voxelize(p, m, voxel_size, point_cloud_range, max_points,
                         max_voxels) for p, m in zip(points, point_mask)]
    coors = []
    for i, r in enumerate(res):
        c = torch.cat([torch.full_like(r.coors[:, :1], i), r.coors], -1)
        coors.append(torch.where(r.valid[:, None], c, -1))
    return (torch.cat([r.voxels for r in res]),
            torch.cat([r.num_points for r in res]), torch.cat(coors),
            torch.cat([r.valid for r in res]))
