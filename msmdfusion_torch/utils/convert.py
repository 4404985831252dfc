"""JAX-package parameters -> port ``state_dict``.

The port's parameters carry the reference mmdet3d torch names and layouts,
which the JAX package's checkpoint converter (``utils/torch_convert.py``,
``convert_transfusion_l``) maps onto its flax tree. This module holds a
private copy of that converter's TransFusion-L table (``_pts_trunk_rules``)
and reads it backwards: a flax variable tree (as numpy arrays) becomes a
state dict the port loads with ``load_state_dict``.

| flax                               | torch (port)                        |
|------------------------------------|-------------------------------------|
| kernel [T, I, O] (sparse conv)     | spconv weight [O, kz, ky, kx, I]    |
| Conv kernel [kh, kw, I, O]         | Conv2d weight [O, I, kh, kw]        |
| ConvTranspose [kh, kw, I, O]       | ConvTranspose2d [I, O, kh, kw], taps flipped |
| Dense kernel [I, O]                | Conv1d [O, I, 1] or Linear [O, I]   |
| scale/bias + batch_stats mean/var  | BN weight/bias/running_mean/var     |
| q/k/v/out Dense kernels [E, E]     | MHA in_proj_weight [3E, E], out_proj |
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

# (torch prefix, flax path, kind, spconv kernel size)
Rule = Tuple[str, str, str, Tuple[int, int, int]]


def transfusion_l_rules() -> List[Rule]:
    """The TransFusion-L mapping: SparseEncoder (basic blocks, four stages)
    + SECOND (5, 5) + SECONDFPN + TransFusionHead with one decoder layer,
    the layout of ``configs/transfusion_nusc_voxel_L.py``."""
    rules: List[Rule] = []
    cube = (3, 3, 3)

    def add(t, f, kind, ks=cube):
        rules.append((t, f, kind, ks))

    me_t, me_f = 'pts_middle_encoder', 'middle_encoder'
    add(f'{me_t}.conv_input.0', f'{me_f}/SparseConvBlock_0/SubMConv3d_0',
        'spconv')
    add(f'{me_t}.conv_input.1', f'{me_f}/SparseConvBlock_0/MaskedBatchNorm_0',
        'bn')
    basic, down = 0, 1
    for stage in range(1, 5):
        for j in range(2):
            t = f'{me_t}.encoder_layers.encoder_layer{stage}.{j}'
            f = f'{me_f}/SparseBasicBlock_{basic}'
            add(f'{t}.conv1', f + '/SubMConv3d_0', 'spconv')
            add(f'{t}.bn1', f + '/MaskedBatchNorm_0', 'bn')
            add(f'{t}.conv2', f + '/SubMConv3d_1', 'spconv')
            add(f'{t}.bn2', f + '/MaskedBatchNorm_1', 'bn')
            basic += 1
        if stage != 4:
            t = f'{me_t}.encoder_layers.encoder_layer{stage}.2'
            f = f'{me_f}/SparseConvBlock_{down}'
            add(f'{t}.0', f + '/SparseConv3d_0', 'spconv')
            add(f'{t}.1', f + '/MaskedBatchNorm_0', 'bn')
            down += 1
    add(f'{me_t}.conv_out.0', f'{me_f}/SparseConvBlock_{down}/SparseConv3d_0',
        'spconv', (3, 1, 1))
    add(f'{me_t}.conv_out.1',
        f'{me_f}/SparseConvBlock_{down}/MaskedBatchNorm_0', 'bn')

    cm = 0
    for s, num in enumerate((5, 5)):
        for li in range(num + 1):
            base = f'pts_backbone.blocks.{s}'
            add(f'{base}.{li * 3}', f'backbone/ConvModule_{cm}/Conv_0',
                'conv2d')
            add(f'{base}.{li * 3 + 1}',
                f'backbone/ConvModule_{cm}/MaskedBatchNorm_0', 'bn')
            cm += 1

    add('pts_neck.deblocks.0.0', 'neck/Conv_0', 'conv2d')
    add('pts_neck.deblocks.0.1', 'neck/MaskedBatchNorm_0', 'bn')
    add('pts_neck.deblocks.1.0', 'neck/ConvTranspose_0', 'deconv2d')
    add('pts_neck.deblocks.1.1', 'neck/MaskedBatchNorm_1', 'bn')

    h_t, h_f = 'pts_bbox_head', 'bbox_head'
    add(f'{h_t}.shared_conv', f'{h_f}/shared_conv', 'conv2d')
    add(f'{h_t}.heatmap_head.0.conv', f'{h_f}/heatmap_conv1/Conv_0', 'conv2d')
    add(f'{h_t}.heatmap_head.0.bn', f'{h_f}/heatmap_conv1/MaskedBatchNorm_0',
        'bn')
    add(f'{h_t}.heatmap_head.1', f'{h_f}/heatmap_conv2', 'conv2d')
    add(f'{h_t}.class_encoding', f'{h_f}/class_encoding', 'conv1d')
    d_t, d_f = f'{h_t}.decoder.0', f'{h_f}/decoder_0'
    add(f'{d_t}.self_attn', f'{d_f}/self_attn', 'mha')
    add(f'{d_t}.multihead_attn', f'{d_f}/multihead_attn', 'mha')
    add(f'{d_t}.linear1', f'{d_f}/linear1', 'linear')
    add(f'{d_t}.linear2', f'{d_f}/linear2', 'linear')
    for i in (1, 2, 3):
        add(f'{d_t}.norm{i}', f'{d_f}/norm{i}', 'ln')
    for pe in ('self_posembed', 'cross_posembed'):
        add(f'{d_t}.{pe}.position_embedding_head.0', f'{d_f}/{pe}/Dense_0',
            'conv1d')
        add(f'{d_t}.{pe}.position_embedding_head.1',
            f'{d_f}/{pe}/MaskedBatchNorm_0', 'bn')
        add(f'{d_t}.{pe}.position_embedding_head.3', f'{d_f}/{pe}/Dense_1',
            'conv1d')
    for head in ('center', 'height', 'dim', 'rot', 'vel', 'heatmap'):
        t = f'{h_t}.prediction_heads.0.{head}'
        f = f'{h_f}/prediction_head_0'
        add(f'{t}.0.conv', f + f'/{head}_0', 'conv1d')
        add(f'{t}.0.bn', f + f'/{head}_0_bn', 'bn')
        add(f'{t}.1', f + f'/{head}_out', 'conv1d')
    return rules


def _flatten(tree, prefix: str = '') -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f'{prefix}/{k}' if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def from_jax_variables(variables) -> Dict[str, torch.Tensor]:
    """{'params': ..., 'batch_stats': ...} flax tree of numpy arrays (a
    JAX TransFusion-L's variables) -> port ``state_dict`` (float32 CPU
    tensors). Raises if the tree lacks a mapped leaf or holds one the
    table does not map."""
    params = _flatten(variables['params'])
    stats = _flatten(variables.get('batch_stats', {}))
    used = set()
    sd: Dict[str, np.ndarray] = {}

    def p(path):
        used.add(('p', path))
        return params[path]

    def s(path):
        used.add(('s', path))
        return stats[path]

    def put(key, value):
        sd[key] = np.ascontiguousarray(value, dtype=np.float32)

    def dense(t, f, conv1d):
        k = p(f + '/kernel').T
        put(t + '.weight', k[..., None] if conv1d else k)
        if f + '/bias' in params:
            put(t + '.bias', p(f + '/bias'))

    for t, f, kind, ks in transfusion_l_rules():
        if kind == 'spconv':
            k = p(f + '/kernel')                        # [T, I, O]
            put(t + '.weight', k.reshape(*ks, *k.shape[1:]).transpose(
                4, 0, 1, 2, 3))
        elif kind == 'conv2d':
            put(t + '.weight', p(f + '/kernel').transpose(3, 2, 0, 1))
            if f + '/bias' in params:
                put(t + '.bias', p(f + '/bias'))
        elif kind == 'deconv2d':
            put(t + '.weight',
                p(f + '/kernel')[::-1, ::-1].transpose(2, 3, 0, 1))
        elif kind in ('conv1d', 'linear'):
            dense(t, f, kind == 'conv1d')
        elif kind in ('bn', 'ln'):
            put(t + '.weight', p(f + '/scale'))
            put(t + '.bias', p(f + '/bias'))
            if kind == 'bn':
                put(t + '.running_mean', s(f + '/mean'))
                put(t + '.running_var', s(f + '/var'))
                sd[t + '.num_batches_tracked'] = np.zeros((), np.int64)
        elif kind == 'mha':
            put(t + '.in_proj_weight', np.concatenate(
                [p(f'{f}/Dense_{i}/kernel').T for i in range(3)]))
            put(t + '.in_proj_bias', np.concatenate(
                [p(f'{f}/Dense_{i}/bias') for i in range(3)]))
            put(t + '.out_proj.weight', p(f + '/Dense_3/kernel').T)
            put(t + '.out_proj.bias', p(f + '/Dense_3/bias'))
        else:
            raise ValueError(kind)
    unused = sorted([path for path in params if ('p', path) not in used] +
                    [path for path in stats if ('s', path) not in used])
    if unused:
        raise KeyError(f'flax leaves with no port parameter: {unused[:8]}')
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
