"""Pillar features scattered onto a dense BEV canvas.

Counterpart of the JAX package's ``models/middle_encoders/pillar_scatter.py``
(reference mmdet3d/models/middle_encoders/pillar_scatter.py
``PointPillarsScatter``): one copy of every valid pillar's features to its
cell of the batch's canvas (the invalid rows land on a spare row that is
dropped), channels-first out. Where several valid rows share a cell (a
voxel grid with more than one z level), the last row writes it and alone
takes its gradient, as the JAX package's scatter on the CPU keeps the last
update and differentiates only it; the winner is chosen by a maximum over
the row indices, so the card gives the same bits on every run.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...registry import MIDDLE_ENCODERS


@MIDDLE_ENCODERS.register('PointPillarsScatter')
class PointPillarsScatter(nn.Module):

    def __init__(self, in_channels: int = 64,
                 output_shape: Sequence[int] = (496, 432)):
        super().__init__()
        self.in_channels = in_channels
        self.output_shape = tuple(int(v) for v in output_shape)  # (ny, nx)

    def forward(self, voxel_features, coors, valid, batch_size: int):
        """voxel_features [K, C], coors [K, 4] (b, z, y, x), valid [K] ->
        [B, C, H, W]."""
        h, w = self.output_shape
        c = voxel_features.shape[-1]
        cells = batch_size * h * w
        co = coors.to(torch.int64)
        flat = torch.where(valid, (co[:, 0] * h + co[:, 2]) * w + co[:, 3],
                           cells)
        rows = torch.arange(flat.shape[0], device=flat.device)
        last = torch.full((cells + 1,), -1, dtype=torch.int64,
                          device=flat.device)
        last.scatter_reduce_(0, flat, rows, 'amax')
        flat = torch.where(last[flat] == rows, flat, cells)
        canvas = voxel_features.new_zeros(cells + 1, c)
        canvas.index_copy_(0, flat, voxel_features)
        return canvas[:cells].reshape(batch_size, h, w, c).permute(
            0, 3, 1, 2).contiguous()
