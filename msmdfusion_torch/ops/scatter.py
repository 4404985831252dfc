"""Segment reduce with a validity mask.

Counterpart of the JAX package's ``ops/scatter.py`` (reference
mmdet3d/ops/centerfusion/centerfusion_ops.py ``scatter_v2``): a fixed
number of segments, rows outside ``valid`` dropped. The sums are summed in
row order within each segment after a stable sort of the ids
(``voxelize.segment_sum``), so two runs give the same bits; the maxima are
exact in any order.
"""
from __future__ import annotations

import torch

from .voxelize import segment_sum


def scatter_v2(feats, segment_ids, num_segments: int, mode: str = 'max',
               valid=None):
    """feats [N, C], segment_ids [N] -> (reduced [num_segments, C],
    segment_valid [num_segments]); ``mode`` 'max', 'mean' or 'sum'; empty
    segments give 0."""
    if mode not in ('max', 'mean', 'sum'):
        raise ValueError(mode)
    ids = segment_ids.to(torch.int64)
    keep = (ids >= 0) & (ids < num_segments)    # others drop, as in JAX
    if valid is not None:
        keep = keep & valid
    ids = torch.where(keep, ids, num_segments)
    seg, order = torch.sort(ids, stable=True)
    rows = feats[order]
    counts = segment_sum(torch.ones_like(seg, dtype=torch.float32)[:, None],
                         seg, num_segments)[:, 0]
    seg_valid = counts > 0
    if mode == 'max':
        out = segment_sum(rows, seg, num_segments, 'max')
        return torch.where(torch.isfinite(out) & seg_valid[:, None], out,
                           0.0), seg_valid
    out = segment_sum(rows, seg, num_segments)
    if mode == 'mean':
        out = out / torch.clamp(counts[:, None], min=1)
    return out, seg_valid
