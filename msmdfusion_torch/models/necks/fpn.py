"""FPN image neck.

Counterpart of the JAX package's ``models/necks/fpn.py`` (the mmdet FPN of
configs/MSMDFusion_nusc_voxel_LC.py: in [256, 512, 1024, 2048], out 256,
five outputs). Lateral 1 x 1 and output 3 x 3 convs with bias under the
mmdet names ``lateral_convs.{i}.conv`` and ``fpn_convs.{i}.conv``; the
top-down path adds a 2x nearest upsample cropped to the finer level; the
extra levels are 1 x 1 stride-2 max-pools of the last output.
"""
from __future__ import annotations

from typing import Sequence

import torch.nn.functional as F
from torch import nn

from ...registry import NECKS
from ..layers import ConvModule


@NECKS.register('FPN')
class FPN(nn.Module):

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 5):
        super().__init__()
        self.num_outs = num_outs

        def conv(cin, k):
            return ConvModule(cin, out_channels, k, padding=k // 2,
                              bias=True, norm=False, act=None)
        self.lateral_convs = nn.ModuleList(conv(c, 1) for c in in_channels)
        self.fpn_convs = nn.ModuleList(conv(out_channels, 3)
                                       for _ in in_channels)

    def forward(self, inputs):
        """list of [N, C_i, H_i, W_i] -> tuple of ``num_outs`` maps."""
        laterals = [m(x) for m, x in zip(self.lateral_convs, inputs)]
        for i in range(len(laterals) - 1, 0, -1):
            th, tw = laterals[i - 1].shape[-2:]
            up = F.interpolate(laterals[i], scale_factor=2, mode='nearest')
            laterals[i - 1] = laterals[i - 1] + up[..., :th, :tw]
        outs = [m(x) for m, x in zip(self.fpn_convs, laterals)]
        while len(outs) < self.num_outs:
            outs.append(outs[-1][..., ::2, ::2])
        return tuple(outs)
