"""Sparse encoder-decoder (U-Net) middle encoder of Part-A2.

Counterpart of the JAX package's ``models/middle_encoders/sparse_unet.py``
(reference mmdet3d/models/middle_encoders/sparse_unet.py:16-292): the
``conv_module`` encoder of ``SparseEncoder`` (``conv_input``,
``encoder_layers.encoder_layer{i}.{j}``, ``conv_out``, densified to the BEV
map), then a decoder that climbs back through the stored stage coordinate
sets. Decoder step i takes the current tensor to stage ``-2 - i``'s set by
an inverse conv block (``up_{i}``: inverse conv, batch norm, ReLU) where
the two sets differ, concatenates that stage's features and runs a
submanifold block (``dec_block_{i}``) on a plan of its own, as the JAX
decoder builds each on an empty cache. The decoder's module names are the
JAX package's: the reference decoder (lateral, merge and reduce blocks)
has no counterpart of them.

Only the order ``('conv', 'norm', 'act')`` is accepted, the one the JAX
U-Net computes (it has no ``order`` field; the reference configs pass
it). The inverse convs run in PyTorch (``ops/sparse/conv.inverse_conv``),
as the JAX package runs them outside any Pallas kernel; every other conv
runs on the rulebook engine's kernels.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ...ops.sparse.conv import inverse_conv, triple
from ...ops.sparse.tensor import SparseTensor
from ...registry import MIDDLE_ENCODERS
from ...utils.timing import section
from ..layers import MaskedBatchNorm
from ..sparse_blocks import SparseConvBlock, _SparseConvBase
from .sparse_encoder import SparseEncoder


class SparseInverseConv3d(_SparseConvBase):
    """Inverse sparse conv onto a target coordinate set (weights in
    spconv's [O, kz, ky, kx, I] layout, no bias)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=3,
                 stride=2, padding=1):
        super().__init__(in_channels, out_channels, kernel_size, None,
                         bias=False)
        self.stride = triple(stride)
        self.padding = triple(padding)

    def forward(self, st: SparseTensor, target: SparseTensor):
        return inverse_conv(st, self.taps(), target.keys, target.coords,
                            target.valid, target.spatial_shape,
                            self.kernel_size, self.stride, self.padding)


class InverseConvBlock(nn.Sequential):
    """Inverse conv (``0``) + batch norm (``1``) + ReLU onto a stored
    coordinate set (JAX ``InverseConvBlock``): the norm on the valid rows,
    the batch's moments in training mode, the running ones in eval."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 2, padding: int = 1,
                 norm_eps: float = 1e-3, norm_momentum: float = 0.01):
        super().__init__(
            SparseInverseConv3d(in_channels, out_channels, kernel_size,
                                stride, padding),
            MaskedBatchNorm(out_channels, eps=norm_eps,
                            momentum=norm_momentum))

    def forward(self, st: SparseTensor, target: SparseTensor):
        out = self[0](st, target)
        feats = self[1](out.features, mask=out.valid)
        return out.replace_features(
            torch.where(out.valid[:, None], torch.relu(feats), 0.0))


@MIDDLE_ENCODERS.register('SparseUNet')
class SparseUNet(SparseEncoder):

    def __init__(self, in_channels: int = 4,
                 sparse_shape: Sequence[int] = (41, 1600, 1408),
                 order: Tuple[str, ...] = ('conv', 'norm', 'act'),
                 base_channels: int = 16, output_channels: int = 128,
                 encoder_channels=((16,), (32, 32, 32), (64, 64, 64),
                                   (64, 64, 64)),
                 encoder_paddings=((1,), (1, 1, 1), (1, 1, 1),
                                   ((0, 1, 1), 1, 1)),
                 decoder_channels=((64, 64, 64), (64, 64, 32), (32, 32, 16),
                                   (16, 16, 16)),
                 norm_eps: float = 1e-3, norm_momentum: float = 0.01,
                 stage_capacities: Optional[Sequence[int]] = None):
        if tuple(order) != ('conv', 'norm', 'act'):
            raise NotImplementedError(
                f'SparseUNet order {tuple(order)}: only (conv, norm, act), '
                'the order the JAX U-Net computes, is ported')
        super().__init__(in_channels, sparse_shape, order=order,
                         base_channels=base_channels,
                         output_channels=output_channels,
                         encoder_channels=encoder_channels,
                         encoder_paddings=encoder_paddings,
                         block_type='conv_module',
                         stage_capacities=stage_capacities,
                         norm_eps=norm_eps, norm_momentum=norm_momentum)
        # the JAX U-Net's conv_out writes into the input's capacity
        self.conv_out[0].out_capacity = None
        # stages[0] is conv_input's output, stages[k] encoder stage k - 1's
        widths = [base_channels] + [tuple(b)[-1] for b in encoder_channels]
        kw = dict(norm_eps=norm_eps, norm_momentum=norm_momentum)
        c = widths[-1]
        for i, dec in enumerate(decoder_channels):
            target = len(widths) - 2 - i
            # x lies on stages[target + 1], encoder stage ``target``'s set,
            # which differs from stages[target]'s iff that stage downsamples
            if target != 0:
                self.add_module(f'up_{i}', InverseConvBlock(c, dec[0], **kw))
                c = dec[0]
            self.add_module(f'dec_block_{i}', SparseConvBlock(
                c + widths[target], dec[-1], 3, padding=1,
                conv_type='SubMConv3d', indice_key=f'dec_subm{i}',
                order=order, **kw))
            c = dec[-1]
        self.num_decoder = len(decoder_channels)
        self.seg_channels = c           # the per-voxel features' width

    def forward(self, voxel_features, coors, valid, batch_size: int,
                assume_sorted: bool = False):
        """voxel_features [K, C], coors [K, 4], valid [K] -> (BEV [B, C*D,
        H, W] channels-first, the full-resolution per-voxel features as a
        ``SparseTensor`` on the first stage's coordinate set)."""
        bev, stages = super().forward(voxel_features, coors, valid,
                                      batch_size,
                                      assume_sorted=assume_sorted)
        x = stages[-1]
        with section('unet_decoder'):
            for i in range(self.num_decoder):
                target = stages[len(stages) - 2 - i]
                if x.spatial_shape != target.spatial_shape:
                    with section('convs'):
                        x = getattr(self, f'up_{i}')(x, target)
                x = x.replace_features(torch.cat(
                    [x.features, target.features], -1))
                x, _ = getattr(self, f'dec_block_{i}')(x, {})
        return bev, x
