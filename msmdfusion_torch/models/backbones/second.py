"""SECOND BEV backbone.

Counterpart of the JAX package's ``models/backbones/second.py`` (reference
mmdet3d/models/backbones/second.py:8-86): stacked stride-1/2 3x3
conv-BN-ReLU blocks producing multi-scale BEV features. Dense
channels-first convs (see ``SECOND.forward`` for their engine); the
module tree is the reference's
``blocks.{i}`` = Sequential(Conv2d, BatchNorm2d, ReLU, ...).
"""
from __future__ import annotations

from typing import Sequence

from torch import nn

from ...registry import BACKBONES
from ..layers import BatchNorm2d, Conv2d, cudnn_enabled


@BACKBONES.register('SECOND')
class SECOND(nn.Module):

    def __init__(self, in_channels: int = 128,
                 out_channels: Sequence[int] = (128, 128, 256),
                 layer_nums: Sequence[int] = (3, 5, 5),
                 layer_strides: Sequence[int] = (2, 2, 2),
                 norm_eps: float = 1e-3, norm_momentum: float = 0.01):
        super().__init__()
        blocks = []
        c = in_channels
        for out, num, stride in zip(out_channels, layer_nums, layer_strides):
            layers = []
            for li in range(num + 1):
                layers += [
                    Conv2d(c, out, 3, stride=stride if li == 0 else 1,
                           padding=1, bias=False),
                    BatchNorm2d(out, eps=norm_eps, momentum=norm_momentum),
                    nn.ReLU(inplace=True)]
                c = out
            blocks.append(nn.Sequential(*layers))
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x):
        """x [B, C, H, W] -> tuple of per-stage [B, C_i, H_i, W_i].

        The convs run on PyTorch's own im2col + cuBLAS path, not cuDNN: in
        float32 without TF32, cuDNN's engine for the first conv of the
        TransFusion-L stack (256 -> 128, 3x3, 180 x 180) ran two orders of
        magnitude slower than this path on an H100, and the other convs
        here run at about the same speed on both.
        """
        outs = []
        with cudnn_enabled(False):
            for block in self.blocks:
                x = block(x)
                outs.append(x)
        return tuple(outs)
