"""Sparse conv layers and blocks over the rulebook engine.

Counterpart of the JAX package's ``models/sparse_blocks.py``
(``make_sparse_convmodule``/``SparseBasicBlock`` of the reference,
mmdet3d/ops/sparse_block.py). The reference's implicit ``indice_key``
rulebook reuse is an explicit ``cache`` dict threaded through the calls:
every conv on one coordinate set shares one plan and, under the default
``MSMD_CONV_ALGO=vgather``, its rulebook rows (computed once per
``indice_key``; the one-hot engine attaches none and matches inside every
conv). In eval mode each conv is one kernel launch with the batch norm (+
ReLU) folded into its epilogue. In training mode the conv runs through
the differentiable ``MatchConv`` with no epilogue, then a masked batch
norm on the batch's valid rows and a masked ReLU; a strided conv also
builds its transpose ("dual") plan (and its rows) once per
``indice_key``, for the backward. Where the rulebook engine's kernels
read it (``needs_order()``: the default x3 product and the packed bf16
engine, not ``MSMD_CONV_GEMM=highest``), ``attach_rows(..., order=True)``
also caches the ``RowOrder`` of each plan's rows (and its dual's),
inside stage ``plans``; in training mode with the weight gradient's pair
lists. Under ``MSMD_FUSE_BN=0`` (``matchconv.fuse_bn``) eval mode runs
the training mode's unfused order on the running statistics: the conv
with no epilogue, the masked batch norm, the masked ReLU (JAX
``sparse_blocks.py:237,301``).

Weights keep spconv's ``[O, kz, ky, kx, I]`` layout and the reference
parameter names; the conv reads them as ``[Ta, I, O]`` taps, z-major and
x fastest.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..ops.sparse.conv import downsample_out_coords, triple
from ..ops.sparse.matchconv import (apply_match_conv, attach_rows,
                                    build_downsample_plan,
                                    build_dual_down_plan, build_subm_plan,
                                    conv_algo, fuse_bn, needs_order)
from ..ops.sparse.tensor import SparseTensor
from ..utils.timing import section
from .layers import MaskedBatchNorm


class _SparseConvBase(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 indice_key: Optional[str], bias: bool):
        super().__init__()
        self.kernel_size = triple(kernel_size)
        self.indice_key = indice_key or f'auto_{id(self)}'
        kz, ky, kx = self.kernel_size
        self.weight = nn.Parameter(
            torch.empty(out_channels, kz, ky, kx, in_channels))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        bound = 1.0 / math.sqrt(in_channels * kz * ky * kx)
        nn.init.uniform_(self.weight, -bound, bound)

    def taps(self):
        """Weights as [Ta, I, O] in spconv tap order."""
        o, i = self.weight.shape[0], self.weight.shape[-1]
        return self.weight.permute(1, 2, 3, 4, 0).reshape(-1, i, o) \
            .contiguous()


class SubMConv3d(_SparseConvBase):
    """Submanifold sparse conv; output coords == input coords."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=3,
                 indice_key: Optional[str] = None, bias: bool = False):
        super().__init__(in_channels, out_channels, kernel_size, indice_key,
                         bias)

    def forward(self, st: SparseTensor, cache: Dict[Any, Any], scale=None,
                shift=None, relu: bool = False):
        key = ('subm', self.indice_key)
        plan = cache.get(key)
        if plan is None:
            with section('plans'):
                plan = build_subm_plan(st, self.kernel_size)
                if conv_algo() == 'vgather':
                    plan = attach_rows(st.keys, plan, site=self.indice_key,
                                       order=needs_order(),
                                       pairs=self.training)
            cache[key] = plan
        with section('convs'):
            out = apply_match_conv(st, plan, self.taps(), st.coords,
                                   st.valid, st.keys, st.spatial_shape,
                                   bias=self.bias, scale=scale, shift=shift,
                                   relu=relu)
        return out, cache


class SparseConv3d(_SparseConvBase):
    """Strided sparse conv onto a new active coordinate set of at most
    ``out_capacity`` rows (default: the input capacity)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=3,
                 stride=1, padding=0, out_capacity: Optional[int] = None,
                 indice_key: Optional[str] = None, bias: bool = False):
        super().__init__(in_channels, out_channels, kernel_size, indice_key,
                         bias)
        self.stride = triple(stride)
        self.padding = triple(padding)
        self.out_capacity = out_capacity

    def forward(self, st: SparseTensor, cache: Dict[Any, Any], scale=None,
                shift=None, relu: bool = False):
        key = ('spconv', self.indice_key)
        entry = cache.get(key)
        if entry is None:
            with section('plans'):
                out_keys, out_coords, out_valid, out_shape = \
                    downsample_out_coords(
                        st, self.kernel_size, self.stride, self.padding,
                        self.out_capacity or st.capacity,
                        site=self.indice_key)
                plan = build_downsample_plan(
                    st, out_coords, out_valid, self.kernel_size, self.stride,
                    self.padding)
                with_rows = conv_algo() == 'vgather'
                if with_rows:
                    plan = attach_rows(st.keys, plan, site=self.indice_key,
                                       order=needs_order(),
                                       pairs=self.training)
                if self.training:
                    dual = build_dual_down_plan(
                        st, out_shape, self.kernel_size, self.stride,
                        self.padding)
                    if with_rows:
                        dual = attach_rows(out_keys, dual,
                                           site=self.indice_key + '_dual',
                                           order=needs_order())
                    plan = dataclasses.replace(plan, dual=dual,
                                               dual_keys=out_keys)
            entry = (out_keys, out_coords, out_valid, out_shape, plan)
            cache[key] = entry
        out_keys, out_coords, out_valid, out_shape, plan = entry
        with section('convs'):
            out = apply_match_conv(st, plan, self.taps(), out_coords,
                                   out_valid, out_keys, out_shape,
                                   bias=self.bias, scale=scale, shift=shift,
                                   relu=relu)
        return out, cache


def _masked_relu(st: SparseTensor) -> SparseTensor:
    return st.replace_features(
        torch.where(st.valid[:, None], torch.relu(st.features), 0.0))


class SparseConvBlock(nn.Sequential):
    """conv (``0``) + batch norm (``1``) + ReLU, the reference's
    ``make_sparse_convmodule`` with its default order. In eval mode the
    batch norm and the ReLU fold into the conv kernel's epilogue (unless
    ``MSMD_FUSE_BN=0``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=3,
                 stride=1, padding=0, conv_type: str = 'SubMConv3d',
                 indice_key: Optional[str] = None,
                 out_capacity: Optional[int] = None,
                 order=('conv', 'norm', 'act'), norm_eps: float = 1e-3,
                 norm_momentum: float = 0.01):
        if tuple(order) != ('conv', 'norm', 'act'):
            raise NotImplementedError(f'order {order}: only conv, norm, act '
                                      'is ported')
        if conv_type == 'SubMConv3d':
            conv = SubMConv3d(in_channels, out_channels, kernel_size,
                              indice_key=indice_key)
        elif conv_type == 'SparseConv3d':
            conv = SparseConv3d(in_channels, out_channels, kernel_size,
                                stride, padding, out_capacity=out_capacity,
                                indice_key=indice_key)
        else:
            raise ValueError(conv_type)
        super().__init__(conv, MaskedBatchNorm(out_channels, eps=norm_eps,
                                               momentum=norm_momentum))

    def forward(self, st: SparseTensor, cache: Dict[Any, Any]):
        if self.training or not fuse_bn():
            st, cache = self[0](st, cache)
            st = st.replace_features(self[1](st.features, mask=st.valid))
            return _masked_relu(st), cache
        scale, shift = self[1].fold()
        return self[0](st, cache, scale=scale, shift=shift, relu=True)


class SparseBasicBlock(nn.Module):
    """ResNet basic block on sparse voxels: two 3x3x3 submanifold convs
    and the skip (reference mmdet3d/ops/sparse_block.py:9-74)."""

    def __init__(self, channels: int, indice_key: Optional[str] = None,
                 norm_eps: float = 1e-3, norm_momentum: float = 0.01):
        super().__init__()
        self.conv1 = SubMConv3d(channels, channels, 3, indice_key=indice_key)
        self.bn1 = MaskedBatchNorm(channels, eps=norm_eps,
                                   momentum=norm_momentum)
        self.conv2 = SubMConv3d(channels, channels, 3, indice_key=indice_key)
        self.bn2 = MaskedBatchNorm(channels, eps=norm_eps,
                                   momentum=norm_momentum)

    def forward(self, st: SparseTensor, cache: Dict[Any, Any]):
        identity = st.features
        if self.training or not fuse_bn():
            st, cache = self.conv1(st, cache)
            st = _masked_relu(st.replace_features(
                self.bn1(st.features, mask=st.valid)))
            st, cache = self.conv2(st, cache)
            st = st.replace_features(self.bn2(st.features, mask=st.valid))
        else:
            s1, b1 = self.bn1.fold()
            st, cache = self.conv1(st, cache, scale=s1, shift=b1, relu=True)
            s2, b2 = self.bn2.fold()
            st, cache = self.conv2(st, cache, scale=s2, shift=b2)
        with section('convs'):
            out = torch.relu(st.features + identity)
            out = torch.where(st.valid[:, None], out, 0.0)
        return st.replace_features(out), cache
