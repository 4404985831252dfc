"""Point-in-box tests and RoI-aware pooling.

Counterpart of ``points_in_boxes_batch`` and ``roiaware_pool3d`` in the
JAX package's ``ops/sampling.py`` (reference
mmdet3d/ops/roiaware_pool3d): each point is moved into each box's frame
and bucketed into the box's (ox, oy, oz) grid, then reduced per cell by a
max or a mean (a fixed-order segment sum, so two runs agree bit for
bit). All boxes go through one reduction (in chunks of boxes that
bound the [boxes, points, C] intermediate), with no loop over single
boxes. The rest of the JAX module (farthest-point sampling, ball query,
three-NN) serves the indoor models.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..core.boxes import box_frame, points_in_rbbox
from .voxelize import segment_sum

# elements of the [boxes, points, C] intermediate a chunk of boxes holds
POOL_ELEMENTS = 2 ** 26


def points_in_boxes_batch(points, boxes):
    """points [B, P, 3+], boxes [B, N, 7] -> [B, P, N] bool."""
    return torch.stack([points_in_rbbox(p, b) for p, b in zip(points, boxes)])


def _cells(points, boxes, out_size):
    """Each point's cell in each box's grid, [N, P] int64, the spare cell
    ``ox*oy*oz`` where the point lies outside the box. The cell index is
    truncated to int32 before its clip, as the JAX function's."""
    ox, oy, oz = out_size
    (lx, ly, lz), inside = box_frame(points, boxes)           # [P, N]
    w, l, h = boxes[:, 3], boxes[:, 4], boxes[:, 5]
    ix = torch.clamp(((lx / w + 0.5) * ox).to(torch.int32), 0, ox - 1)
    iy = torch.clamp(((ly / l + 0.5) * oy).to(torch.int32), 0, oy - 1)
    iz = torch.clamp((lz / h * oz).to(torch.int32), 0, oz - 1)
    cell = (ix.to(torch.int64) * oy + iy) * oz + iz
    return torch.where(inside, cell, ox * oy * oz).T, inside.T


def roiaware_pool3d(points, feats, boxes, out_size: Tuple[int, int, int],
                    mode: str = 'max'):
    """points [P, 3], feats [P, C], boxes [N, 7] -> [N, ox, oy, oz, C]: per
    box and cell the max (``'max'``; an empty cell 0) or the mean
    (``'avg'``, the sum over max(count, 1)) of the features of the points
    in that cell."""
    if mode not in ('max', 'avg'):
        raise ValueError(f'roiaware_pool3d mode {mode!r}')
    n, c = boxes.shape[0], feats.shape[-1]
    ox, oy, oz = out_size
    cells = ox * oy * oz + 1
    chunk = max(1, POOL_ELEMENTS // max(points.shape[0] * c, 1))
    outs = []
    for start in range(0, n, chunk):
        part = boxes[start:start + chunk]
        m = part.shape[0]
        cell, inside = _cells(points, part, out_size)
        index = (cell + torch.arange(m, device=cell.device)[:, None] * cells
                 ).reshape(-1)
        src = feats[None].expand(m, -1, -1)
        if mode == 'max':
            src = torch.where(inside[..., None], src, float('-inf'))
            out = feats.new_full((m * cells, c), float('-inf'))
            out = out.scatter_reduce(0, index[:, None].expand(-1, c),
                                     src.reshape(-1, c), 'amax')
            out = torch.where(torch.isfinite(out), out, 0.0)
        else:
            # a fixed-order sum per cell (no float atomics: two runs give
            # the same bits), the points outside every cell parked
            key = torch.where(inside.reshape(-1), index, m * cells)
            key, order = torch.sort(key, stable=True)
            out = segment_sum(src.reshape(-1, c).index_select(0, order),
                              key, m * cells)
            bounds = torch.searchsorted(
                key, torch.arange(m * cells + 1, device=key.device))
            cnt = (bounds[1:] - bounds[:-1]).to(feats.dtype)
            out = out / torch.clamp(cnt[:, None], min=1)
        outs.append(out.reshape(m, cells, c)[:, :-1])
    return torch.cat(outs).reshape(n, ox, oy, oz, c)
