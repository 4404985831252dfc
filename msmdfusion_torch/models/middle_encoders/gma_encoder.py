"""Gated modality-aware multimodal sparse encoder (GMA), inference.

Counterpart of the JAX package's ``models/middle_encoders/gma_encoder.py``
(reference mmdet3d/models/middle_encoders/
sparse_multimodal_encoder_painting.py, ``SparseMultiModalEncoderPaint``).
Per stage, on the LiDAR voxels ``v3`` of the encoder stage and the
camera-decorated voxels ``v2`` of the same scale:

1. ``modality_split``: the only-3D, only-2D and mixed rows of both sets;
2. orphan gating: each only-2D voxel takes the cross gate of its nearest
   3D voxel found through 2048 representatives (``approx_nn_3d``, two
   ``masked_nn`` kernel launches), or of the learned dummy row;
3. mixed gating: ``gate(3D feature) * 2D feature``;
4. the grouped SubM conv on the only-3D rows, on the encoder's own
   rulebook for that coordinate set;
5. the union [f3 | 0], [0 | f2], [f3 | g * f2] at ``union_capacities``,
   a SubM basic block, the cross-stage ``sparse_add`` with the previous
   stage's output (stages 1-3) and the strided downscale.

Module names are the reference's (``grouped_sp_conv_blocks_3D``,
``gate_control``, ``cross_gate_control``, ``aggregation_blocks``,
``downscale_blocks``); ``dummy_embedding_{i}`` has no reference key.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ...ops.nn_argmin import masked_nn
from ...ops.sparse.tensor import (SparseTensor, lookup_sorted_pair,
                                  make_sparse_tensor, sparse_add)
from ...registry import MIDDLE_ENCODERS
from ...utils.switches import require_default
from ..layers import MLP
from ..sparse_blocks import SparseBasicBlock, SparseConvBlock


def modality_split(voxel_3d: SparseTensor, voxel_2d: SparseTensor):
    """Row masks ``only_3d``/``only_2d``/``mix_3d``/``mix_2d`` and, for the
    mixed rows, the row of the same key in the other set (-1 elsewhere)."""
    row_in_2d, row_in_3d = lookup_sorted_pair(voxel_3d.keys, voxel_2d.keys)
    mix_3d = (row_in_2d >= 0) & voxel_3d.valid
    mix_2d = (row_in_3d >= 0) & voxel_2d.valid
    return {
        'only_3d': voxel_3d.valid & ~mix_3d,
        'only_2d': voxel_2d.valid & ~mix_2d,
        'mix_3d': mix_3d,
        'mix_2d': mix_2d,
        'mix_2d_row_for_3d': torch.where(mix_3d, row_in_2d, -1),
        'mix_3d_row_for_2d': torch.where(mix_2d, row_in_3d, -1),
    }


def approx_nn_3d(query_coords, query_valid, key_coords, key_valid,
                 num_reps: int, radius: float, dist_thresh: float):
    """Representative-based nearest 3D voxel of each valid query, in
    voxel-index space: [K2] int32 key row, -1 where unassigned.

    The representatives are every ``K2 // num_reps``-th row of the valid
    queries in row order (a stable sort puts the valid rows first, as the
    JAX ``argsort(~query_valid)`` does). A representative is kept when its
    nearest key lies within ``dist_thresh``; a query joins its nearest
    representative within ``radius``.
    """
    q = query_coords[:, 1:].to(torch.float32).contiguous()
    k = key_coords[:, 1:].to(torch.float32).contiguous()
    qb = query_coords[:, 0].contiguous()
    kb = key_coords[:, 0].contiguous()
    k2 = q.shape[0]
    order = torch.argsort((~query_valid).to(torch.int8), stable=True)
    stride = max(k2 // num_reps, 1)
    rep_rows = order[::stride][:num_reps]
    reps = q[rep_rows]
    reps_b = qb[rep_rows]
    reps_valid = query_valid[rep_rows]

    nn_row, nn_d2 = masked_nn(reps, reps_b, k, kb, key_valid)
    rep_ok = reps_valid & (torch.sqrt(nn_d2) < dist_thresh)
    best_rep, best_d2 = masked_nn(q, qb, reps, reps_b, reps_valid)
    safe_rep = torch.clamp(best_rep, min=0).to(torch.int64)
    assigned = (query_valid & (best_rep >= 0)
                & (torch.sqrt(best_d2) <= radius) & rep_ok[safe_rep])
    return torch.where(assigned, nn_row[safe_rep], -1)


def _rows(x, row):
    """x[row] with the -1 rows read as row 0 (callers mask them)."""
    return x.index_select(0, torch.clamp(row, min=0).to(torch.int64))


@MIDDLE_ENCODERS.register('SparseMultiModalEncoderPaint')
class SparseMultiModalEncoderPaint(nn.Module):

    def __init__(self, in_channels_3D: Sequence[int] = (16, 32, 64, 128),
                 in_channels_2D: Sequence[int] = (64, 64, 64, 64),
                 out_channels: Sequence[int] = (32, 64, 128, 128),
                 padding: Sequence[Any] = (1, 1, (0, 1, 1), 0),
                 down_kernel_size: Sequence[Any] = (3, 3, 3, (3, 1, 1)),
                 down_stride: Sequence[Any] = (2, 2, 2, (2, 1, 1)),
                 order: Tuple[str, ...] = ('conv', 'norm', 'act'),
                 norm_eps: float = 1e-3, norm_momentum: float = 0.01,
                 stage_capacities: Optional[Sequence[int]] = None,
                 union_capacities: Optional[Sequence[int]] = None):
        super().__init__()
        self.stage_capacities = stage_capacities
        self.union_capacities = union_capacities
        kw = dict(order=order, norm_eps=norm_eps, norm_momentum=norm_momentum)
        grouped, agg, down = {}, {}, {}
        gate, cross_gate = [], []
        for i, (c3, c2) in enumerate(zip(in_channels_3D, in_channels_2D)):
            st = f'stage_{i + 1}'
            grouped[st] = SparseConvBlock(
                c3, c3, 3, padding=1, conv_type='SubMConv3d',
                indice_key=f'subm3D_{i + 1}', **kw)
            gate.append(MLP(c3, (c2,), final_act=True))
            cross_gate.append(MLP(c3, (c2,), final_act=True))
            agg[st] = SparseBasicBlock(c3 + c2, indice_key=f'agg_{i + 1}',
                                       norm_eps=norm_eps,
                                       norm_momentum=norm_momentum)
            down[st] = SparseConvBlock(
                c3 + c2, out_channels[i] + c2, down_kernel_size[i],
                stride=down_stride[i], padding=padding[i],
                conv_type='SparseConv3d', indice_key=f'spconv_ds_{i + 1}',
                out_capacity=(stage_capacities[i]
                              if stage_capacities is not None else None),
                **kw)
            # the row an unassigned orphan is gated by (the reference draws
            # a fresh uniform row per step; a learned row is its
            # deterministic counterpart)
            self.register_parameter(f'dummy_embedding_{i}',
                                    nn.Parameter(torch.rand(c3)))
        self.grouped_sp_conv_blocks_3D = nn.ModuleDict(grouped)
        self.gate_control = nn.ModuleList(gate)
        self.cross_gate_control = nn.ModuleList(cross_gate)
        self.aggregation_blocks = nn.ModuleDict(agg)
        self.downscale_blocks = nn.ModuleDict(down)

    def forward(self, voxel_3d_list, voxel_2d_list, fps_num_list,
                radius_list, max_cluster_samples_list, dist_thresh_list,
                shared_plans=None) -> List[SparseTensor]:
        """Per-stage outputs of the downscale convs. ``shared_plans``:
        per-stage SubM plans (with rows) of the ``voxel_3d_list`` coordinate
        sets, the LiDAR encoder's ``subm{i}`` rulebooks."""
        del max_cluster_samples_list    # FPS/ball-query clusters: not used
        stage_outs: List[SparseTensor] = []
        for i, (v3, v2) in enumerate(zip(voxel_3d_list, voxel_2d_list)):
            st = f'stage_{i + 1}'
            split = modality_split(v3, v2)
            c3 = v3.num_channels

            # orphan 2D gating by the approximate nearest 3D voxel (the JAX
            # package's MSMD_GMA_NN=exact and MSMD_GMA_DUMMY=random:<seed>
            # ablations are not ported: they raise)
            require_default('MSMD_GMA_NN')
            nn_row = approx_nn_3d(v2.coords, split['only_2d'], v3.coords,
                                  v3.valid, fps_num_list[i], radius_list[i],
                                  dist_thresh_list[i])
            require_default('MSMD_GMA_DUMMY')
            dummy = getattr(self, f'dummy_embedding_{i}')
            nn_feat = torch.where((nn_row >= 0)[:, None],
                                  _rows(v3.features, nn_row), dummy[None, :])
            gated_2d = self.cross_gate_control[i](nn_feat) * v2.features
            feats_2d = torch.where(split['only_2d'][:, None], gated_2d,
                                   v2.features)

            # mixed gating: gate(3D feat) * 2D feat
            feat_3d_for_2d = _rows(v3.features, split['mix_3d_row_for_2d'])
            mixed_gated = self.gate_control[i](feat_3d_for_2d) * feats_2d
            feats_2d = torch.where(split['mix_2d'][:, None], mixed_gated,
                                   feats_2d)

            # grouped conv on the only-3D rows: the keys stay the full set,
            # so the encoder's rulebook for it serves (the other rows are
            # zero and add w @ 0)
            only_3d = SparseTensor(
                features=torch.where(split['only_3d'][:, None], v3.features,
                                     0.0),
                coords=v3.coords, valid=split['only_3d'], keys=v3.keys,
                spatial_shape=v3.spatial_shape, batch_size=v3.batch_size)
            grouped_cache: Dict[Any, Any] = {}
            plan = shared_plans[i] if shared_plans is not None else None
            if plan is not None and plan.k_out == v3.capacity:
                grouped_cache[('subm', f'subm3D_{i + 1}')] = plan
            only_3d, _ = self.grouped_sp_conv_blocks_3D[st](only_3d,
                                                            grouped_cache)

            # union: only-3D [f3 | 0], only-2D [0 | f2], mixed [f3 | g*f2]
            f3_rows = torch.where(
                split['mix_3d'][:, None],
                torch.cat([v3.features,
                           _rows(feats_2d, split['mix_2d_row_for_3d'])], 1),
                torch.cat([only_3d.features,
                           v3.features.new_zeros((v3.capacity,
                                                  v2.num_channels))], 1))
            f2_rows = torch.cat([v2.features.new_zeros((v2.capacity, c3)),
                                 feats_2d], 1)
            unified = make_sparse_tensor(
                torch.cat([f3_rows, f2_rows]),
                torch.cat([v3.coords, v2.coords]),
                torch.cat([v3.valid, split['only_2d']]),
                v3.spatial_shape, v3.batch_size,
                capacity=(self.union_capacities[i]
                          if self.union_capacities is not None else None),
                site=f'gma_union_{i}')
            unified, cache = self.aggregation_blocks[st](unified, {})
            if i > 0:
                # the sum's key set is the previous downscale's output set,
                # so the previous stage's capacity is the output size
                prev = stage_outs[i - 1]
                unified = sparse_add(unified, prev,
                                     capacity=max(unified.capacity,
                                                  prev.capacity))
                cache = {}
            out, _ = self.downscale_blocks[st](unified, cache)
            stage_outs.append(out)
        return stage_outs
