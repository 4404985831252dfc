"""SECOND FPN neck: per-level (de)conv upsample and channel concat.

Counterpart of the JAX package's ``models/necks/second_fpn.py`` (reference
mmdet3d/models/necks/second_fpn.py:11-92). Channels-first; the module
tree is the reference's ``deblocks.{i}`` = Sequential(ConvTranspose2d or
Conv2d, BatchNorm2d, ReLU).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...registry import NECKS
from ..layers import BatchNorm2d, Conv2d, ConvTranspose2d


@NECKS.register('SECONDFPN')
class SECONDFPN(nn.Module):

    def __init__(self, in_channels: Sequence[int] = (128, 128, 256),
                 out_channels: Sequence[int] = (256, 256, 256),
                 upsample_strides: Sequence[int] = (1, 2, 4),
                 use_conv_for_no_stride: bool = False,
                 norm_eps: float = 1e-3, norm_momentum: float = 0.01):
        super().__init__()
        deblocks = []
        for cin, cout, stride in zip(in_channels, out_channels,
                                     upsample_strides):
            if stride > 1 or (stride == 1 and not use_conv_for_no_stride):
                up = ConvTranspose2d(cin, cout, stride, stride=stride,
                                     bias=False)
            else:
                k = int(round(1 / stride)) if stride < 1 else 1
                up = Conv2d(cin, cout, k, stride=k, bias=False)
            deblocks.append(nn.Sequential(
                up, BatchNorm2d(cout, eps=norm_eps, momentum=norm_momentum),
                nn.ReLU(inplace=True)))
        self.deblocks = nn.ModuleList(deblocks)

    def forward(self, inputs):
        """inputs: tuple of [B, C_i, H_i, W_i] -> [[B, sum(C_out), H, W]]."""
        assert len(inputs) == len(self.deblocks)
        ups = [block(x) for block, x in zip(self.deblocks, inputs)]
        return [torch.cat(ups, dim=1) if len(ups) > 1 else ups[0]]
