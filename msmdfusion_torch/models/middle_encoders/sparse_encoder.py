"""SECOND-style sparse voxel encoder.

Counterpart of the JAX package's ``models/middle_encoders/sparse_encoder.py``
(reference mmdet3d/models/middle_encoders/sparse_encoder.py:10-209):
stages of submanifold blocks with strided downsamples between them, a
(3,1,1)/(2,1,1) ``conv_out``, densified to a BEV map. With
``block_type='basicblock'`` (the defaults, TransFusion-L's) a stage is
basic blocks and ends on its downsample (but the last); with
``'conv_module'`` (SECOND's) a stage is conv-norm-ReLU blocks and starts
on its downsample (but the first). Module names follow the reference
(``conv_input``, ``encoder_layers.encoder_layer{i}.{j}``, ``conv_out``).

Every downsample writes into a fixed-capacity output (``stage_capacities``,
default: the input capacity); past it the highest keys are dropped and
counted at ``sparse.downsample.out_cap[spconv{i}]``.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence, Tuple

from torch import nn

from ...ops.sparse.tensor import make_sparse_tensor, to_dense_bev
from ...registry import MIDDLE_ENCODERS
from ...utils.timing import section
from ..sparse_blocks import SparseBasicBlock, SparseConvBlock


@MIDDLE_ENCODERS.register('SparseEncoder')
class SparseEncoder(nn.Module):

    def __init__(self, in_channels: int, sparse_shape: Sequence[int],
                 order: Tuple[str, ...] = ('conv', 'norm', 'act'),
                 base_channels: int = 16, output_channels: int = 128,
                 encoder_channels=((16, 16, 32), (32, 32, 64),
                                   (64, 64, 128), (128, 128)),
                 encoder_paddings=((0, 0, 1), (0, 0, 1), (0, 0, (0, 1, 1)),
                                   (0, 0)),
                 block_type: str = 'basicblock',
                 stage_capacities: Optional[Sequence[int]] = None,
                 norm_eps: float = 1e-3, norm_momentum: float = 0.01):
        super().__init__()
        if block_type not in ('basicblock', 'conv_module'):
            raise ValueError(f'block_type {block_type!r}')
        self.sparse_shape = tuple(int(v) for v in sparse_shape)
        kw = dict(order=order, norm_eps=norm_eps, norm_momentum=norm_momentum)
        self.conv_input = SparseConvBlock(
            in_channels, base_channels, 3, padding=1, conv_type='SubMConv3d',
            indice_key='subm1', **kw)
        caps = stage_capacities
        num_stages = len(encoder_channels)
        c = base_channels
        layers = OrderedDict()
        for i, blocks in enumerate(encoder_channels):
            stage = []
            for j, out_channels in enumerate(tuple(blocks)):
                padding = tuple(encoder_paddings[i])[j]
                if block_type == 'conv_module':
                    down = i != 0 and j == 0
                else:
                    down = j == len(blocks) - 1 and i != num_stages - 1
                if down:
                    stage.append(SparseConvBlock(
                        c, out_channels, 3, stride=2, padding=padding,
                        conv_type='SparseConv3d', indice_key=f'spconv{i + 1}',
                        out_capacity=caps[i] if caps is not None else None,
                        **kw))
                elif block_type == 'conv_module':
                    stage.append(SparseConvBlock(
                        c, out_channels, 3, padding=padding,
                        conv_type='SubMConv3d', indice_key=f'subm{i + 1}',
                        **kw))
                else:
                    if out_channels != c:
                        raise ValueError(f'basic block {c} -> {out_channels}'
                                         ': a basic block keeps its width')
                    stage.append(SparseBasicBlock(
                        c, indice_key=f'subm{i + 1}', norm_eps=norm_eps,
                        norm_momentum=norm_momentum))
                c = out_channels
            layers[f'encoder_layer{i + 1}'] = nn.Sequential(*stage)
        self.encoder_layers = nn.Sequential(layers)
        self.conv_out = SparseConvBlock(
            c, output_channels, kernel_size=(3, 1, 1), stride=(2, 1, 1),
            padding=0, conv_type='SparseConv3d', indice_key='spconv_down2',
            out_capacity=caps[-1] if caps is not None else None, **kw)

    def forward(self, voxel_features, coors, valid, batch_size: int,
                assume_sorted: bool = False, return_cache: bool = False):
        """voxel_features [K, C], coors [K, 4] (b, z, y, x), valid [K] ->
        (BEV [B, C*D, H, W] channels-first, per-stage sparse tensors).

        ``assume_sorted``: rows already ascend in packed key (the fused
        voxelizer's order), so no sort runs. ``return_cache``: also return
        the plan cache, keyed ``('subm', 'subm{i}')`` and so on, so that
        convs on the same coordinate sets (the GMA grouped convs) reuse its
        rulebooks.
        """
        st = make_sparse_tensor(voxel_features, coors, valid,
                                self.sparse_shape, batch_size,
                                assume_sorted=assume_sorted)
        cache: dict = {}
        st, cache = self.conv_input(st, cache)
        encode_features = [st]
        for stage in self.encoder_layers:
            for block in stage:
                st, cache = block(st, cache)
            encode_features.append(st)
        out, cache = self.conv_out(st, cache)
        with section('bev'):
            bev = to_dense_bev(out).permute(0, 3, 1, 2).contiguous()
        if return_cache:
            return bev, encode_features, cache
        return bev, encode_features
