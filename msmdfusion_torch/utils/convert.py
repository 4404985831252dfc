"""JAX-package parameters -> port ``state_dict``.

The port's parameters carry the reference mmdet3d torch names and layouts,
which the JAX package's checkpoint converter (``utils/torch_convert.py``,
``convert_transfusion_l``) maps onto its flax tree. This module holds a
private copy of that converter's TransFusion-L and MSMDFusion tables
(``_pts_trunk_rules``, ``resnet_rules``, ``fpn_rules``, ``msmdfusion_rules``),
adds TransFusion-LC's (``transfusion_lc_rules``: the head's image fusion
under the reference TransFusion head's keys, which the JAX converter's
view-order contract names) and the code-size-8 Waymo head's, and reads
them backwards: a flax variable tree (as numpy arrays) becomes a state
dict the port loads with ``load_state_dict``.

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

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# the reference's view order (nuscenes_dataset.py:203; the JAX package's
# ``datasets.nuscenes.CAM_ORDER``): the LC head's image-to-BEV decoder of
# view v is the one trained on camera CAM_ORDER[v]
CAM_ORDER = ('CAM_FRONT_LEFT', 'CAM_FRONT', 'CAM_FRONT_RIGHT',
             'CAM_BACK_RIGHT', 'CAM_BACK', 'CAM_BACK_LEFT')

# (torch prefix, flax path, kind, spconv kernel size)
Rule = Tuple[str, str, str, Tuple[int, int, int]]


def _pts_trunk_rules(add, backbone_f: str, neck_f: str,
                     layer_nums: Sequence[int] = (5, 5),
                     velocity: bool = True) -> None:
    """SparseEncoder (basic blocks, four stages) + SECOND + SECONDFPN +
    TransFusionHead with one decoder layer: the torch keys TransFusion-L and
    MSMDFusion share (the head's ``vel`` branch where ``velocity``)."""
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
    for s, num in enumerate(layer_nums):
        for li in range(num + 1):
            base = f'pts_backbone.blocks.{s}'
            add(f'{base}.{li * 3}', f'{backbone_f}/ConvModule_{cm}/Conv_0',
                'conv2d')
            add(f'{base}.{li * 3 + 1}',
                f'{backbone_f}/ConvModule_{cm}/MaskedBatchNorm_0', 'bn')
            cm += 1

    add('pts_neck.deblocks.0.0', f'{neck_f}/Conv_0', 'conv2d')
    add('pts_neck.deblocks.0.1', f'{neck_f}/MaskedBatchNorm_0', 'bn')
    add('pts_neck.deblocks.1.0', f'{neck_f}/ConvTranspose_0', 'deconv2d')
    add('pts_neck.deblocks.1.1', f'{neck_f}/MaskedBatchNorm_1', 'bn')

    h_t, h_f = 'pts_bbox_head', 'bbox_head'
    add(f'{h_t}.shared_conv', f'{h_f}/shared_conv', 'conv2d')
    add(f'{h_t}.heatmap_head.0.conv', f'{h_f}/heatmap_conv1/Conv_0', 'conv2d')
    add(f'{h_t}.heatmap_head.0.bn', f'{h_f}/heatmap_conv1/MaskedBatchNorm_0',
        'bn')
    add(f'{h_t}.heatmap_head.1', f'{h_f}/heatmap_conv2', 'conv2d')
    add(f'{h_t}.class_encoding', f'{h_f}/class_encoding', 'conv1d')
    _decoder_rules(add, f'{h_t}.decoder.0', f'{h_f}/decoder_0')
    _ffn_rules(add, f'{h_t}.prediction_heads.0', f'{h_f}/prediction_head_0',
               velocity)


def _decoder_rules(add, d_t: str, d_f: str, cross_only: bool = False):
    """One ``TransformerDecoderLayer``. A cross-only layer (the LC head's
    image-to-BEV decoders) has no self-attention; its ``norm1``, which the
    reference module holds and never applies and the flax layer lacks,
    takes LayerNorm's initial values (``ln_init``, shaped as norm2)."""
    if cross_only:
        add(f'{d_t}.norm1', f'{d_f}/norm2', 'ln_init')
    else:
        add(f'{d_t}.self_attn', f'{d_f}/self_attn', 'mha')
        add(f'{d_t}.norm1', f'{d_f}/norm1', 'ln')
    add(f'{d_t}.multihead_attn', f'{d_f}/multihead_attn', 'mha')
    add(f'{d_t}.linear1', f'{d_f}/linear1', 'linear')
    add(f'{d_t}.linear2', f'{d_f}/linear2', 'linear')
    for i in (2, 3):
        add(f'{d_t}.norm{i}', f'{d_f}/norm{i}', 'ln')
    for pe in ('self_posembed', 'cross_posembed'):
        add(f'{d_t}.{pe}.position_embedding_head.0', f'{d_f}/{pe}/Dense_0',
            'conv1d')
        add(f'{d_t}.{pe}.position_embedding_head.1',
            f'{d_f}/{pe}/MaskedBatchNorm_0', 'bn')
        add(f'{d_t}.{pe}.position_embedding_head.3', f'{d_f}/{pe}/Dense_1',
            'conv1d')


def _ffn_rules(add, t: str, f: str, velocity: bool = True):
    """One FFN prediction head (``vel`` where ``velocity``: code size 10)."""
    heads = ('center', 'height', 'dim', 'rot') + \
        (('vel',) if velocity else ()) + ('heatmap',)
    for head in heads:
        add(f'{t}.{head}.0.conv', f + f'/{head}_0', 'conv1d')
        add(f'{t}.{head}.0.bn', f + f'/{head}_0_bn', 'bn')
        add(f'{t}.{head}.1', f + f'/{head}_out', 'conv1d')


def _lc_head_rules(add, num_views: int, velocity: bool = True,
                   num_decoder_layers: int = 1) -> None:
    """The LC head's image-fusion modules onto the reference TransFusion
    head's torch keys: ``decoder.{L}`` the fusion decoder,
    ``decoder.{L + 1 + v}`` view ``v``'s image-to-BEV decoder (the JAX
    converter's ``decoder[2 + idx_view]`` for L = 1), ``prediction_heads.
    {L}`` the fused FFN, for L decoder layers. View ``v`` is the camera
    ``CAM_ORDER`` gives it."""
    h_t, h_f = 'pts_bbox_head', 'bbox_head'
    nl = num_decoder_layers
    add(f'{h_t}.shared_conv_img', f'{h_f}/shared_conv_img', 'conv2d')
    add(f'{h_t}.heatmap_head_img.0.conv', f'{h_f}/heatmap_conv1_img/Conv_0',
        'conv2d')
    add(f'{h_t}.heatmap_head_img.0.bn',
        f'{h_f}/heatmap_conv1_img/MaskedBatchNorm_0', 'bn')
    add(f'{h_t}.heatmap_head_img.1', f'{h_f}/heatmap_conv2_img', 'conv2d')
    add(f'{h_t}.fc.0', f'{h_f}/fc_collapsed', 'conv1d')
    _decoder_rules(add, f'{h_t}.decoder.{nl}', f'{h_f}/img_fusion_decoder')
    for v in range(num_views):
        _decoder_rules(add, f'{h_t}.decoder.{nl + 1 + v}',
                       f'{h_f}/img_bev_decoder_{v}', cross_only=True)
    _ffn_rules(add, f'{h_t}.prediction_heads.{nl}',
               f'{h_f}/prediction_head_fused', velocity)


def new_rules():
    """(an empty rule list, its ``add(torch, flax, kind, ks)``)."""
    rules: List[Rule] = []

    def add(t, f, kind, ks=(3, 3, 3)):
        rules.append((t, f, kind, ks))
    return rules, add


def transfusion_l_rules(layer_nums: Sequence[int] = (5, 5),
                        velocity: bool = True) -> List[Rule]:
    """The TransFusion-L mapping, the layout of
    ``configs/transfusion_nusc_voxel_L.py`` (``velocity=False``: the
    code-size-8 head of ``configs/transfusion_waymo_voxel_L.py``)."""
    rules, add = new_rules()
    _pts_trunk_rules(add, 'backbone', 'neck', layer_nums, velocity)
    return rules


def resnet_rules(add, t: str, f: str, depth: int = 50) -> None:
    """torchvision/mmdet ResNet -> flax ResNet (``layer{s}_{b}`` blocks)."""
    blocks = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
              101: (3, 4, 23, 3)}[depth]
    bottleneck = depth >= 50
    add(f'{t}.conv1', f'{f}/conv1', 'conv2d')
    add(f'{t}.bn1', f'{f}/bn1', 'bn')
    for s, nb in enumerate(blocks):
        for b in range(nb):
            tb, fb = f'{t}.layer{s + 1}.{b}', f'{f}/layer{s + 1}_{b}'
            for c in range(1, (3 if bottleneck else 2) + 1):
                add(f'{tb}.conv{c}', f'{fb}/conv{c}', 'conv2d')
                add(f'{tb}.bn{c}', f'{fb}/bn{c}', 'bn')
            if b == 0 and (bottleneck or s > 0):
                add(f'{tb}.downsample.0', f'{fb}/downsample_conv', 'conv2d')
                add(f'{tb}.downsample.1', f'{fb}/downsample_bn', 'bn')


def fpn_rules(add, t: str, f: str, num_ins: int = 4) -> None:
    """mmdet FPN -> flax FPN (``lateral_{i}`` / ``fpn_conv_{i}``)."""
    for i in range(num_ins):
        add(f'{t}.lateral_convs.{i}.conv', f'{f}/lateral_{i}', 'conv2d')
        add(f'{t}.fpn_convs.{i}.conv', f'{f}/fpn_conv_{i}', 'conv2d')


def transfusion_lc_rules(num_views: int, depth: int = 50,
                         velocity: bool = True) -> List[Rule]:
    """The TransFusion-LC mapping (``configs/transfusion_nusc_voxel_LC.py``,
    ``transfusion_waymo_voxel_LC.py`` with ``velocity=False``): the
    TransFusion-L trunk, the ResNet and FPN image branch (flax
    ``backbone_img``/``neck_img``) and the head's image fusion for
    ``num_views`` views."""
    rules, add = new_rules()
    _pts_trunk_rules(add, 'backbone', 'neck', velocity=velocity)
    resnet_rules(add, 'img_backbone', 'backbone_img', depth)
    fpn_rules(add, 'img_neck', 'neck_img')
    _lc_head_rules(add, num_views, velocity)
    return rules


def msmdfusion_rules(depth: int = 50, layer_nums: Sequence[int] = (5, 5),
                     num_stages: int = 4) -> List[Rule]:
    """The MSMDFusion mapping (``msmdfusion_rules`` of the JAX converter):
    the shared LiDAR trunk, ResNet + FPN, the compression convs,
    ``score_net``, SPP and the GMA encoder, whose last downscale is
    (3, 1, 1). ``dummy_embedding_{i}`` has no reference key; it is carried
    under the port's own ``multimodal_middle_encoder.dummy_embedding_{i}``."""
    rules, add = new_rules()
    _pts_trunk_rules(add, 'backbone_pts', 'neck_pts', layer_nums)
    resnet_rules(add, 'img_backbone', 'backbone_img', depth)
    fpn_rules(add, 'img_neck', 'neck_img')
    for i in range(3):
        add(f'conv1x1_blocks.{i}.0', f'compress_{i}/Conv_0', 'conv2d')
        add(f'conv1x1_blocks.{i}.1', f'compress_{i}/MaskedBatchNorm_0', 'bn')
    add('score_net.0', 'score_net/Dense_0', 'linear')
    for i, name in enumerate(('conv1x1', 'conv3x3', 'dilated_conv3x3_rate6',
                              'dilated_conv3x3_rate12', 'fuse')):
        add(f'bev_fusion.{name}.0', f'bev_fusion/ConvModule_{i}/Conv_0',
            'conv2d')
        add(f'bev_fusion.{name}.1',
            f'bev_fusion/ConvModule_{i}/MaskedBatchNorm_0', 'bn')
    g_t, g_f = 'multimodal_middle_encoder', 'mm_encoder'
    for i in range(num_stages):
        st = f'stage_{i + 1}'
        add(f'{g_t}.grouped_sp_conv_blocks_3D.{st}.0',
            f'{g_f}/grouped_3d_{i}/SubMConv3d_0', 'spconv')
        add(f'{g_t}.grouped_sp_conv_blocks_3D.{st}.1',
            f'{g_f}/grouped_3d_{i}/MaskedBatchNorm_0', 'bn')
        add(f'{g_t}.gate_control.{i}.0', f'{g_f}/gate_{i}/Dense_0', 'linear')
        add(f'{g_t}.cross_gate_control.{i}.0',
            f'{g_f}/cross_gate_{i}/Dense_0', 'linear')
        agg_t, agg_f = f'{g_t}.aggregation_blocks.{st}', \
            f'{g_f}/aggregation_{i}'
        add(f'{agg_t}.conv1', f'{agg_f}/SubMConv3d_0', 'spconv')
        add(f'{agg_t}.bn1', f'{agg_f}/MaskedBatchNorm_0', 'bn')
        add(f'{agg_t}.conv2', f'{agg_f}/SubMConv3d_1', 'spconv')
        add(f'{agg_t}.bn2', f'{agg_f}/MaskedBatchNorm_1', 'bn')
        add(f'{g_t}.downscale_blocks.{st}.0',
            f'{g_f}/downscale_{i}/SparseConv3d_0', 'spconv',
            (3, 1, 1) if i == num_stages - 1 else (3, 3, 3))
        add(f'{g_t}.downscale_blocks.{st}.1',
            f'{g_f}/downscale_{i}/MaskedBatchNorm_0', 'bn')
        add(f'{g_t}.dummy_embedding_{i}', f'{g_f}/dummy_embedding_{i}',
            'param')
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


def from_jax_variables(variables, rules: Optional[List[Rule]] = None
                       ) -> Dict[str, torch.Tensor]:
    """{'params': ..., 'batch_stats': ...} flax tree of numpy arrays (a
    JAX model's variables) -> port ``state_dict`` (CPU tensors: float32,
    and bfloat16 for the bf16 leaves of a tree cast as the JAX bench casts
    its params, carried bit for bit through a uint16 view: numpy has no
    bf16 of its own and ``torch.from_numpy`` refuses ``ml_dtypes``'),
    through ``rules`` (default: ``transfusion_l_rules()``). Raises if the
    tree lacks a mapped leaf or holds one the table does not map."""
    params = _flatten(variables['params'])
    stats = _flatten(variables.get('batch_stats', {}))
    used = set()
    sd: Dict[str, np.ndarray] = {}
    bf16 = set()

    def p(path):
        used.add(('p', path))
        return params[path]

    def s(path):
        used.add(('s', path))
        return stats[path]

    def put(key, value):
        value = np.asarray(value)
        if value.dtype.name == 'bfloat16':
            bf16.add(key)
            sd[key] = np.ascontiguousarray(value).view(np.uint16)
        else:
            sd[key] = np.ascontiguousarray(value, dtype=np.float32)

    def dense(t, f, conv1d):
        k = p(f + '/kernel').T
        put(t + '.weight', k[..., None] if conv1d else k)
        if f + '/bias' in params:
            put(t + '.bias', p(f + '/bias'))

    for t, f, kind, ks in (transfusion_l_rules() if rules is None
                           else rules):
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
        elif kind == 'ln_init':
            put(t + '.weight', np.ones_like(params[f + '/scale']))
            put(t + '.bias', np.zeros_like(params[f + '/bias']))
        elif kind in ('bn', 'ln'):
            put(t + '.weight', p(f + '/scale'))
            put(t + '.bias', p(f + '/bias'))
            if kind == 'bn':
                put(t + '.running_mean', s(f + '/mean'))
                put(t + '.running_var', s(f + '/var'))
                sd[t + '.num_batches_tracked'] = np.zeros((), np.int64)
        elif kind == 'param':
            put(t, p(f))
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
    return {k: torch.from_numpy(np.array(v)).view(torch.bfloat16)
            if k in bf16 else torch.from_numpy(np.array(v))
            for k, v in sd.items()}
