"""Extra necks: FPNC (the FPN pyramid fused into one map) and SCConv (the
self-calibrated BEV neck).

Counterpart of the JAX package's ``models/necks/extra_necks.py``
(reference necks/fpnc.py:119 and scconv.py:197, registered but used by no
config), channels-first. FPNC resizes every FPN level to ``final_dim /
downsample`` (bilinear, antialiased where it shrinks, as
``jax.image.resize``), optionally through a 1 x 1
conv each (``adp``), concatenates them and reduces them with a 3 x 3 conv
(``reduc_conv``); its FPN is the port's (it subclasses it, so its keys
are ``lateral_convs``/``fpn_convs``). SCConv runs segments of
self-calibrated blocks with strided downsampling and transposed-conv
re-upsampling, concatenating every segment's output. The norms are flax
``BatchNorm``s in the JAX necks (momentum 0.99, i.e. the torch momentum
0.01); their running variance keeps the torch convention (unbiased).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...registry import NECKS
from ..layers import BatchNorm2d, Conv2d, ConvModule, ConvTranspose2d
from .fpn import FPN


def resize_bilinear(x, size: Tuple[int, int]):
    """x [..., h, w] -> [..., H, W] as ``jax.image.resize(..., 'bilinear')``
    computes it: half-pixel centres, the triangle kernel widened by in/out
    where the map shrinks (``antialias``)."""
    return F.interpolate(x, size=tuple(size), mode='bilinear',
                         align_corners=False, antialias=True)


def resize_nearest(x, size: Tuple[int, int]):
    """x [..., h, w] -> [..., H, W] as ``jax.image.resize(..., 'nearest')``:
    output i reads input floor((i + 0.5) * in / out)."""
    return F.interpolate(x, size=tuple(size), mode='nearest-exact')


@NECKS.register('FPNC')
class FPNC(FPN):
    """FPN collapsed to one fused map (reference fpnc.py:44-119)."""

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 5,
                 final_dim: Tuple[int, int] = (900, 1600),
                 downsample: int = 4, use_adp: bool = False,
                 outC: int = 256):
        super().__init__(in_channels, out_channels, num_outs)
        self.target = (final_dim[0] // downsample, final_dim[1] // downsample)
        self.use_adp = use_adp
        if use_adp:
            self.adp = nn.ModuleList(
                ConvModule(out_channels, out_channels, 1, norm_eps=1e-5,
                           norm_momentum=0.01) for _ in range(num_outs))
        self.reduc_conv = ConvModule(out_channels * num_outs, outC, 3,
                                     padding=1, norm_eps=1e-5,
                                     norm_momentum=0.01)

    def forward(self, inputs):
        """list of [N, C_i, H_i, W_i] -> [one map [N, outC, H/d, W/d]]."""
        outs = super().forward(inputs)
        if len(outs) == 1:
            return [outs[0]]
        resized = []
        for i, f in enumerate(outs):
            if self.use_adp:
                f = self.adp[i](resize_bilinear(f, self.target))
            elif tuple(f.shape[-2:]) != self.target:
                f = resize_bilinear(f, self.target)
            resized.append(f)
        return [self.reduc_conv(torch.cat(resized, 1))]


def conv_bn(cin: int, cout: int, kernel: int = 3, stride: int = 1):
    """conv (no bias) + batch norm (eps 1e-3), no activation: the JAX
    ``_ConvBN``."""
    return ConvModule(cin, cout, kernel, stride=stride,
                      padding=1 if kernel == 3 else 0, norm_eps=1e-3,
                      norm_momentum=0.01, act=None)


class SCBlock(nn.Module):
    """Self-calibrated block (reference scconv.py:28-85): a light two-conv
    branch (``conv_l0``, ``conv_l1``) and a heavy branch (``conv_h0``,
    ``conv_h1``, ``conv_h2``) gated by a self-calibration map from a 4x
    average-pooled copy (``conv_ds``), fused by ``conv_fuse`` with the
    skip. The JAX block creates them in the order l0, l1, h0, h1, ds, h2,
    fuse."""

    def __init__(self, channels: int, ds_padding: int = 0):
        super().__init__()
        h = channels // 2
        self.ds_padding = ds_padding
        self.conv_l0 = conv_bn(channels, h, 1)
        self.conv_l1 = conv_bn(h, h, 3)
        self.conv_h0 = conv_bn(channels, h, 1)
        self.conv_h1 = conv_bn(h, h, 3)
        self.conv_ds = conv_bn(h, h, 3)
        self.conv_h2 = conv_bn(h, h, 3)
        self.conv_fuse = conv_bn(2 * h, channels, 3)

    def forward(self, x):
        l1 = torch.relu(self.conv_l1(torch.relu(self.conv_l0(x))))
        h0 = torch.relu(self.conv_h0(x))
        h1 = self.conv_h1(h0)
        d = F.avg_pool2d(h0, 4, 4, padding=self.ds_padding,
                         count_include_pad=True)
        d = resize_nearest(self.conv_ds(d), tuple(h0.shape[-2:])) + h0
        h2 = self.conv_h2(torch.sigmoid(d) * h1)
        return torch.relu(self.conv_fuse(torch.cat([h2, l1], 1)) + x)


@NECKS.register('SCConv')
class SCConv(nn.Module):
    """Segmented self-calibrated BEV neck (reference scconv.py:87-197):
    segment i is a strided ``downs.{i}`` conv, ``blocks.{i}`` SCBlocks and
    an up-projection ``ups.{i}`` (a transposed conv where the segment's
    rate is above 1 or it is the last, else a 1 x 1 conv; then a norm)."""

    def __init__(self, num_input_features: int = 256,
                 num_proj_features: int = 128,
                 chn_per_segment: Sequence[int] = (256, 256, 256),
                 blocks_per_segment: Sequence[int] = (3, 3, 3),
                 ds_rates: Sequence[int] = (1, 2, 2),
                 us_rates: Sequence[int] = (1, 2, 4),
                 ds_paddings: Sequence[int] = (0, 0, 1)):
        super().__init__()
        downs, blocks, ups = [], [], []
        c = num_input_features
        n = len(chn_per_segment)
        for i, ch in enumerate(chn_per_segment):
            downs.append(conv_bn(c, ch, 3, stride=ds_rates[i]))
            blocks.append(nn.Sequential(*(SCBlock(ch, ds_paddings[i])
                                          for _ in range(
                                              blocks_per_segment[i]))))
            r = us_rates[i]
            up = (ConvTranspose2d(ch, num_proj_features, r, stride=r,
                                  bias=False) if r > 1 or i == n - 1 else
                  Conv2d(ch, num_proj_features, 1, bias=False))
            ups.append(nn.Sequential(up, BatchNorm2d(
                num_proj_features, eps=1e-3, momentum=0.01)))
            c = ch
        self.downs = nn.ModuleList(downs)
        self.blocks = nn.ModuleList(blocks)
        self.ups = nn.ModuleList(ups)

    def forward(self, x):
        outs = []
        for down, block, up in zip(self.downs, self.blocks, self.ups):
            x = block(torch.relu(down(x)))
            outs.append(torch.relu(up(x)))
        return torch.cat(outs, 1)
