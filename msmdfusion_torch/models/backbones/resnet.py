"""ResNet image backbone.

Counterpart of the JAX package's ``models/backbones/resnet.py`` (the mmdet
ResNet the reference configures as the frozen image backbone,
configs/MSMDFusion_nusc_voxel_LC.py: depth 50, out_indices (0, 1, 2, 3),
norm_eval). Channels-first dense convs; module names are torchvision's
(``conv1``, ``bn1``, ``layer{s}.{b}.conv{c}``/``bn{c}``, ``downsample.0/1``),
so a reference checkpoint loads as is. Bottleneck blocks (depth >= 50)
stride on the 3 x 3 conv; basic blocks (depth 18, 34) on their first conv.

In training mode (the image branch trained, ``freeze_img=False``) the
convs take gradients and, under ``norm_eval``, every batch norm stays on
its running statistics, never updated (JAX ``resnet.py:100-104``).
``frozen_stages`` is not read here, as in the JAX package, which freezes
parameters in the optimizer's mask alone (its ``apis/train.py``).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...registry import BACKBONES
from ..layers import BatchNorm2d, Conv2d, common_dtype, cudnn_enabled

ARCH = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
        101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
BASIC_DEPTHS = (18, 34)


def _downsample(cin: int, cout: int, stride: int) -> nn.Sequential:
    return nn.Sequential(Conv2d(cin, cout, 1, stride=stride, bias=False),
                         BatchNorm2d(cout))


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = Conv2d(cin, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=1,
                            bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(planes * 4)
        self.downsample = (_downsample(cin, planes * 4, stride)
                           if downsample else None)

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = Conv2d(cin, planes, 3, stride=stride, padding=1,
                            bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = (_downsample(cin, planes, stride)
                           if downsample else None)

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


@BACKBONES.register('ResNet')
class ResNet(nn.Module):

    def __init__(self, depth: int = 50, num_stages: int = 4,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 frozen_stages: int = -1, norm_eval: bool = True,
                 style: str = 'pytorch'):
        super().__init__()
        if style != 'pytorch':
            raise NotImplementedError(f'style {style!r}: only pytorch')
        del frozen_stages
        self.norm_eval = norm_eval
        self.out_indices = tuple(out_indices)
        block = BasicBlock if depth in BASIC_DEPTHS else Bottleneck
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        # the JAX stem pads with -inf before a VALID 3 x 3 / 2 max-pool
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        cin, planes = 64, 64
        self.num_stages = num_stages
        for s in range(num_stages):
            stride = 1 if s == 0 else 2
            blocks = []
            for b in range(ARCH[depth][s]):
                expands = block is Bottleneck or s > 0
                blocks.append(block(cin, planes, stride if b == 0 else 1,
                                    downsample=b == 0 and expands))
                cin = planes * block.expansion
            self.add_module(f'layer{s + 1}', nn.Sequential(*blocks))
            planes *= 2

    def train(self, mode: bool = True):
        """Set the mode; under ``norm_eval`` the batch norms stay in eval
        mode."""
        super().train(mode)
        if mode and self.norm_eval:
            for m in self.modules():
                if isinstance(m, nn.modules.batchnorm._BatchNorm):
                    m.eval()
        return self

    def forward(self, x):
        """x [N, 3, H, W] -> tuple of the ``out_indices`` stage outputs."""
        # off cuDNN in fp32, on it below: see layers.cudnn_enabled
        fp32 = common_dtype(x, self.conv1.weight) == torch.float32
        with cudnn_enabled(not fp32):
            x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
            outs = []
            for s in range(self.num_stages):
                x = getattr(self, f'layer{s + 1}')(x)
                if s in self.out_indices:
                    outs.append(x)
        return tuple(outs)
