"""JAX-package parameters -> port ``state_dict``.

The port's parameters carry the reference mmdet3d torch names and layouts,
which the JAX package's checkpoint converter (``utils/torch_convert.py``,
``convert_transfusion_l``) maps onto its flax tree. This module holds a
private copy of that converter's TransFusion-L and MSMDFusion tables
(``_pts_trunk_rules``, ``resnet_rules``, ``fpn_rules``, ``msmdfusion_rules``),
adds TransFusion-LC's (``transfusion_lc_rules``: the head's image fusion
under the reference TransFusion head's keys, which the JAX converter's
view-order contract names), the code-size-8 Waymo head's and the
zoo's (``zoo_rules``: the single-stage detectors, PartA2, MVXNet and
the point-based indoor zoo, with mmdet3d's module names where the
reference has the module; the JAX converter has none), and reads
them backwards: a flax variable tree (as numpy arrays) becomes a state
dict the port loads with ``load_state_dict``.

| flax                               | torch (port)                        |
|------------------------------------|-------------------------------------|
| kernel [T, I, O] (sparse conv)     | spconv weight [O, kz, ky, kx, I]    |
| Conv kernel [kh, kw, I, O]         | Conv2d weight [O, I, kh, kw]        |
| Conv kernel [kx, ky, kz, I, O]     | Conv3d weight [O, I, kx, ky, kz]    |
| ConvTranspose [kh, kw, I, O]       | ConvTranspose2d [I, O, kh, kw], taps flipped |
| Dense kernel [I, O]                | Conv1d [O, I, 1] or Linear [O, I]   |
| Dense kernel [I, O] (shared MLP)   | Conv2d [O, I, 1, 1] (``pointwise``) |
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


def sparse_encoder_rules(add, encoder_channels, block_type: str,
                         t: str = 'pts_middle_encoder',
                         f: str = 'middle_encoder') -> None:
    """A ``SparseEncoder`` of any stage layout: the flax blocks are counted
    in creation order by kind (``SparseConvBlock_{k}`` for conv_input, the
    downsamples, the conv_module blocks and conv_out;
    ``SparseBasicBlock_{k}``), as the port's walk creates its modules."""
    conv, basic = 1, 0
    add(f'{t}.conv_input.0', f'{f}/SparseConvBlock_0/SubMConv3d_0', 'spconv')
    add(f'{t}.conv_input.1', f'{f}/SparseConvBlock_0/MaskedBatchNorm_0', 'bn')
    num_stages = len(encoder_channels)
    for i, blocks in enumerate(encoder_channels):
        for j in range(len(blocks)):
            tb = f'{t}.encoder_layers.encoder_layer{i + 1}.{j}'
            if block_type == 'conv_module':
                down = i != 0 and j == 0
            else:
                down = j == len(blocks) - 1 and i != num_stages - 1
            if down or block_type == 'conv_module':
                kind = 'SparseConv3d' if down else 'SubMConv3d'
                fb = f'{f}/SparseConvBlock_{conv}'
                add(f'{tb}.0', f'{fb}/{kind}_0', 'spconv')
                add(f'{tb}.1', f'{fb}/MaskedBatchNorm_0', 'bn')
                conv += 1
            else:
                fb = f'{f}/SparseBasicBlock_{basic}'
                for c in (1, 2):
                    add(f'{tb}.conv{c}', f'{fb}/SubMConv3d_{c - 1}', 'spconv')
                    add(f'{tb}.bn{c}', f'{fb}/MaskedBatchNorm_{c - 1}', 'bn')
                basic += 1
    add(f'{t}.conv_out.0', f'{f}/SparseConvBlock_{conv}/SparseConv3d_0',
        'spconv', (3, 1, 1))
    add(f'{t}.conv_out.1', f'{f}/SparseConvBlock_{conv}/MaskedBatchNorm_0',
        'bn')


def second_rules(add, layer_nums, t: str = 'pts_backbone',
                 f: str = 'backbone') -> None:
    """SECOND: stage s's (1 + layer_nums[s]) ConvModules."""
    cm = 0
    for s, num in enumerate(layer_nums):
        for li in range(num + 1):
            add(f'{t}.blocks.{s}.{li * 3}', f'{f}/ConvModule_{cm}/Conv_0',
                'conv2d')
            add(f'{t}.blocks.{s}.{li * 3 + 1}',
                f'{f}/ConvModule_{cm}/MaskedBatchNorm_0', 'bn')
            cm += 1


def second_fpn_rules(add, upsample_strides, use_conv_for_no_stride: bool,
                     t: str = 'pts_neck', f: str = 'neck') -> None:
    """SECONDFPN: each level's (transposed) conv and norm; flax counts
    ``Conv_{k}`` and ``ConvTranspose_{k}`` apart."""
    n_conv = n_deconv = 0
    for i, stride in enumerate(upsample_strides):
        if stride > 1 or (stride == 1 and not use_conv_for_no_stride):
            add(f'{t}.deblocks.{i}.0', f'{f}/ConvTranspose_{n_deconv}',
                'deconv2d')
            n_deconv += 1
        else:
            add(f'{t}.deblocks.{i}.0', f'{f}/Conv_{n_conv}', 'conv2d')
            n_conv += 1
        add(f'{t}.deblocks.{i}.1', f'{f}/MaskedBatchNorm_{i}', 'bn')


def voxel_encoder_rules(add, cfg, t: str = 'pts_voxel_encoder',
                        f: str = 'voxel_encoder') -> None:
    """``PillarFeatureNet`` (``pfn_layers.{i}.linear``/``.norm``),
    ``HardVFE`` (``vfe_layers.{i}.linear``/``.norm``) or ``DynamicVFE``
    (``vfe_layers.{i}.0``/``.1``); ``HardSimpleVFE`` has no parameters."""
    n = len(cfg.get('feat_channels', (64,)))
    for i in range(n):
        if cfg['type'] == 'PillarFeatureNet':
            add(f'{t}.pfn_layers.{i}.linear', f'{f}/PFNLayer_{i}/Dense_0',
                'linear')
            add(f'{t}.pfn_layers.{i}.norm',
                f'{f}/PFNLayer_{i}/MaskedBatchNorm_0', 'bn')
        elif cfg['type'] in ('HardVFE', 'DynamicVFE'):
            lin, norm = (('linear', 'norm') if cfg['type'] == 'HardVFE'
                         else ('0', '1'))
            add(f'{t}.vfe_layers.{i}.{lin}', f'{f}/Dense_{i}', 'linear')
            add(f'{t}.vfe_layers.{i}.{norm}', f'{f}/BatchNorm_{i}', 'bn')


def center_head_rules(add, cfg, t: str = 'pts_bbox_head',
                      f: str = 'bbox_head') -> None:
    """CenterHead: ``shared_conv`` and ``task_heads.{t}.{name}.{i}``."""
    add(f'{t}.shared_conv.conv', f'{f}/shared_conv/Conv_0', 'conv2d')
    add(f'{t}.shared_conv.bn', f'{f}/shared_conv/MaskedBatchNorm_0', 'bn')
    for ti, _ in enumerate(cfg['tasks']):
        heads = dict(cfg['common_heads'])
        heads['heatmap'] = (None, cfg.get('num_heatmap_convs', 2))
        for name, (_, num_conv) in heads.items():
            tb, fb = f'{t}.task_heads.{ti}.{name}', f'{f}/task_{ti}/{name}'
            for i in range(num_conv - 1):
                add(f'{tb}.{i}.conv', f'{fb}_{i}/Conv_0', 'conv2d')
                add(f'{tb}.{i}.bn', f'{fb}_{i}/MaskedBatchNorm_0', 'bn')
            add(f'{tb}.{num_conv - 1}', f'{fb}_out', 'conv2d')


def anchor_head_rules(add, head, t: str = 'pts_bbox_head',
                      f: str = 'bbox_head') -> None:
    """``Anchor3DHead`` (and its subclasses): the three 1 x 1 branches."""
    for name in ('conv_cls', 'conv_reg') + (
            ('conv_dir_cls',) if head.get('use_direction_classifier', True)
            else ()):
        add(f'{t}.{name}', f'{f}/{name}', 'conv2d')


def shape_aware_head_rules(add, head, t: str = 'pts_bbox_head',
                           f: str = 'bbox_head') -> None:
    """``ShapeAwareHead``: per task ``heads.{i}`` (flax ``heads_{i}``) its
    shared convs and norms (flax ``Conv_{j}``/``BatchNorm_{j}``) and
    branches."""
    for i, task in enumerate(head['tasks']):
        tb, fb = f'{t}.heads.{i}', f'{f}/heads_{i}'
        for j in range(len(task['shared_conv_channels'])):
            add(f'{tb}.shared_conv.{j}.conv', f'{fb}/Conv_{j}', 'conv2d')
            add(f'{tb}.shared_conv.{j}.bn', f'{fb}/BatchNorm_{j}', 'bn')
        anchor_head_rules(add, head, tb, fb)


def fpnc_rules(add, cfg, t: str = 'neck', f: str = 'neck') -> None:
    """``FPNC``: its FPN (flax ``fpn``), the ``adp`` 1 x 1 convs and norms
    where ``use_adp`` (flax ``Conv_{i}``/``BatchNorm_{i}``) and
    ``reduc_conv`` (the next ``Conv``/``BatchNorm``)."""
    n_in = len(cfg.get('in_channels', (256, 512, 1024, 2048)))
    fpn_rules(add, t, f'{f}/fpn', n_in)
    k = 0
    if cfg.get('use_adp', False):
        for k in range(cfg.get('num_outs', 5)):
            add(f'{t}.adp.{k}.conv', f'{f}/Conv_{k}', 'conv2d')
            add(f'{t}.adp.{k}.bn', f'{f}/BatchNorm_{k}', 'bn')
        k += 1
    add(f'{t}.reduc_conv.conv', f'{f}/Conv_{k}', 'conv2d')
    add(f'{t}.reduc_conv.bn', f'{f}/BatchNorm_{k}', 'bn')


def scconv_rules(add, cfg, t: str = 'neck', f: str = 'neck') -> None:
    """``SCConv``: per segment its downsample (flax ``_ConvBN_{i}``), its
    blocks (``SCBlock_{k}``, counted over the segments, each block's seven
    ``_ConvBN_{j}`` in ``SCBlock.PARTS`` order) and its up-projection
    (``ConvTranspose_{j}`` or ``Conv_{j}``, counted apart, then
    ``BatchNorm_{i}``)."""
    chn = cfg.get('chn_per_segment', (256, 256, 256))
    blocks = cfg.get('blocks_per_segment', (3, 3, 3))
    us = cfg.get('us_rates', (1, 2, 4))
    parts = ('l0', 'l1', 'h0', 'h1', 'ds', 'h2', 'fuse')
    block = n_conv = n_deconv = 0

    def conv_bn(tt, ff):
        add(f'{tt}.conv', f'{ff}/Conv_0', 'conv2d')
        add(f'{tt}.bn', f'{ff}/BatchNorm_0', 'bn')
    for i in range(len(chn)):
        conv_bn(f'{t}.downs.{i}', f'{f}/_ConvBN_{i}')
        for j in range(blocks[i]):
            for k, part in enumerate(parts):
                conv_bn(f'{t}.blocks.{i}.{j}.conv_{part}',
                        f'{f}/SCBlock_{block}/_ConvBN_{k}')
            block += 1
        if us[i] > 1 or i == len(chn) - 1:
            add(f'{t}.ups.{i}.0', f'{f}/ConvTranspose_{n_deconv}',
                'deconv2d')
            n_deconv += 1
        else:
            add(f'{t}.ups.{i}.0', f'{f}/Conv_{n_conv}', 'conv2d')
            n_conv += 1
        add(f'{t}.ups.{i}.1', f'{f}/BatchNorm_{i}', 'bn')


def sparse_unet_rules(add, cfg, t: str = 'middle_encoder',
                      f: str = 'middle_encoder') -> None:
    """``SparseUNet``: the ``conv_module`` encoder, then per decoder step
    its inverse conv block (``up_{i}``, where the step changes the
    coordinate set) and submanifold block (``dec_block_{i}``)."""
    enc = cfg.get('encoder_channels', ((16,), (32, 32, 32), (64, 64, 64),
                                       (64, 64, 64)))
    dec = cfg.get('decoder_channels', ((64, 64, 64), (64, 64, 32),
                                       (32, 32, 16), (16, 16, 16)))
    sparse_encoder_rules(add, enc, 'conv_module', t, f)
    for i in range(len(dec)):
        if len(enc) - 1 - i != 0:
            add(f'{t}.up_{i}.0', f'{f}/up_{i}', 'spconv')
            add(f'{t}.up_{i}.1', f'{f}/up_{i}/MaskedBatchNorm_0', 'bn')
        add(f'{t}.dec_block_{i}.0', f'{f}/dec_block_{i}/SubMConv3d_0',
            'spconv')
        add(f'{t}.dec_block_{i}.1', f'{f}/dec_block_{i}/MaskedBatchNorm_0',
            'bn')


def parta2_roi_rules(add, cfg, t: str = 'roi_head', f: str = 'roi') -> None:
    """``PartAggregationROIHead``: the JAX head's own names, the dense 3-D
    convs and norms of its four stacks and its fully connected layers."""
    defaults = dict(part_conv_channels=(64, 64), seg_conv_channels=(64, 64),
                    merge_conv_channels=(128, 128),
                    down_conv_channels=(128, 256),
                    shared_fc_channels=(256, 512), cls_channels=(256, 256),
                    reg_channels=(256, 256))
    width = {k: len(cfg.get(k, v)) for k, v in defaults.items()}
    for stack in ('part_conv', 'seg_conv', 'merge_conv', 'down_conv'):
        for i in range(width[f'{stack}_channels']):
            add(f'{t}.{stack}_{i}', f'{f}/{stack}_{i}', 'conv3d')
            add(f'{t}.{stack}_bn_{i}', f'{f}/{stack}_bn_{i}', 'bn')
    for fc, key in (('shared_fc', 'shared_fc_channels'),
                    ('cls_fc', 'cls_channels'), ('reg_fc', 'reg_channels')):
        for i in range(width[key]):
            add(f'{t}.{fc}_{i}', f'{f}/{fc}_{i}', 'linear')
    add(f'{t}.cls_out', f'{f}/cls_out', 'linear')
    add(f'{t}.reg_out', f'{f}/reg_out', 'linear')


def parta2_rules(model_cfg) -> List[Rule]:
    """``PartA2``: the U-Net, SECOND, SECONDFPN, the RPN (flax ``rpn``),
    the semantic branch and the RoI head (flax ``roi``)."""
    rules, add = new_rules()
    voxel_encoder_rules(add, model_cfg['pts_voxel_encoder'], 'voxel_encoder')
    sparse_unet_rules(add, model_cfg['pts_middle_encoder'])
    second_rules(add, model_cfg['pts_backbone']['layer_nums'], 'backbone')
    neck = model_cfg.get('pts_neck')
    if neck:
        second_fpn_rules(add, neck.get('upsample_strides', (1, 2, 4)),
                         neck.get('use_conv_for_no_stride', False), 'neck')
    anchor_head_rules(add, model_cfg['rpn_head'], 'rpn_head', 'rpn')
    for name in ('semantic_fc', 'semantic_seg', 'semantic_part'):
        add(name, name, 'linear')
    parta2_roi_rules(add, model_cfg['roi_head'])
    return rules


def mvx_rules(model_cfg) -> List[Rule]:
    """``MVXFasterRCNN``: the LiDAR stack as the single-stage zoo's, the
    ResNet and FPN image branch (flax ``backbone_img``/``neck_img``) and
    ``PointFusion`` (flax ``fusion``: ``Dense_0`` the image map, ``Dense_1``
    the points', ``Dense_2`` the ``fuse_out`` one)."""
    rules, add = new_rules()
    _voxel_trunk_rules(add, model_cfg)
    if model_cfg.get('img_backbone'):
        resnet_rules(add, 'img_backbone', 'backbone_img',
                     model_cfg['img_backbone'].get('depth', 50))
    if model_cfg.get('img_neck'):
        fpn_rules(add, 'img_neck', 'neck_img',
                  len(model_cfg['img_neck']['in_channels']))
    fusion = model_cfg.get('fusion_layer')
    if fusion:
        t = 'pts_fusion_layer'
        add(f'{t}.img_transform.0', 'fusion/Dense_0', 'linear')
        add(f'{t}.pts_transform.0', 'fusion/Dense_1', 'linear')
        if fusion.get('fuse_out', False):
            add(f'{t}.fuse_conv.0', 'fusion/Dense_2', 'linear')
    return rules


def _voxel_trunk_rules(add, model_cfg) -> None:
    """The voxel encoder, ``SparseEncoder`` (either block type) or no
    parameters (``PointPillarsScatter``), SECOND, SECONDFPN and the head
    (``CenterHead``, ``ShapeAwareHead`` or an anchor head)."""
    if model_cfg['type'] != 'DynamicVoxelNet':
        voxel_encoder_rules(add, model_cfg['pts_voxel_encoder'])
    me = model_cfg['pts_middle_encoder']
    if me['type'] == 'SparseEncoder':
        sparse_encoder_rules(
            add, me.get('encoder_channels', ((16, 16, 32), (32, 32, 64),
                                             (64, 64, 128), (128, 128))),
            me.get('block_type', 'basicblock'))
    second_rules(add, model_cfg['pts_backbone']['layer_nums'])
    neck = model_cfg.get('pts_neck')
    if neck:
        second_fpn_rules(add, neck.get('upsample_strides', (1, 2, 4)),
                         neck.get('use_conv_for_no_stride', False))
    head = model_cfg['pts_bbox_head']
    if head['type'] == 'CenterHead':
        center_head_rules(add, head)
    elif head['type'] == 'ShapeAwareHead':
        shape_aware_head_rules(add, head)
    else:
        anchor_head_rules(add, head)


def mlp_rules(add, t: str, f: str, layers: int) -> None:
    """The JAX ``MLP``'s ``Dense_{k}`` -> the port ``MLP``'s Linear
    ``{2k}`` (a ReLU between)."""
    for k in range(layers):
        add(f'{t}.{2 * k}', f'{f}/Dense_{k}', 'linear')


def shared_mlp_rules(add, t: str, f: str, layers: int,
                     scale: Optional[int] = None) -> None:
    """An SA/FP module's shared MLP: mmdet3d's ``layer{j}.{conv,bn}``
    from the JAX module's ``mlp_[{scale}_]{j}``/``bn_[...]``."""
    tag = '' if scale is None else f'{scale}_'
    for j in range(layers):
        add(f'{t}.layer{j}.conv', f'{f}/mlp_{tag}{j}', 'pointwise')
        add(f'{t}.layer{j}.bn', f'{f}/bn_{tag}{j}', 'bn')


def pointnet2_rules(add, cfg, t: str = 'backbone',
                    f: str = 'backbone_net') -> None:
    """``PointNet2SASSG``/``PointNet2SAMSG``: ``SA_modules.{i}.mlps.{s}``
    and ``FP_modules.{i}.mlps`` (the JAX ``sa_{i}``, ``fp_{i}``)."""
    msg = cfg['type'] == 'PointNet2SAMSG'
    for i, channels in enumerate(cfg['sa_channels']):
        if msg:
            for sc, mlp in enumerate(channels):
                shared_mlp_rules(add, f'{t}.SA_modules.{i}.mlps.{sc}',
                                 f'{f}/sa_{i}', len(mlp), sc)
        else:
            shared_mlp_rules(add, f'{t}.SA_modules.{i}.mlps.0',
                             f'{f}/sa_{i}', len(channels))
    for i, mlp in enumerate(() if msg else cfg['fp_channels']):
        shared_mlp_rules(add, f'{t}.FP_modules.{i}.mlps', f'{f}/fp_{i}',
                         len(mlp))


def vote_head_rules(add, t: str, f: str, ssd3d: bool = False) -> None:
    """``VoteHead`` (or ``SSD3DHead``): the JAX names under the head's
    prefix, the aggregation SA as mmdet3d's ``vote_aggregation``."""
    mlp_rules(add, f'{t}.vote_mlp', f'{f}/vote_mlp', 1 if ssd3d else 2)
    add(f'{t}.vote_out', f'{f}/vote_out', 'linear')
    shared_mlp_rules(add, f'{t}.vote_aggregation.mlps.0', f'{f}/' + (
        'candidate_aggregation' if ssd3d else 'vote_aggregation'), 3)
    mlp_rules(add, f'{t}.pred_mlp', f'{f}/pred_mlp', 2)
    add(f'{t}.pred_out', f'{f}/pred_out', 'linear')


def indoor_rules(model_cfg) -> List[Rule]:
    """The point-based zoo: ``VoteNet``, ``SSD3DNet``, ``H3DNet`` and
    ``ImVoteNet``. mmdet3d's keys where the JAX module has the
    reference's structure (``backbone.SA_modules``/``FP_modules``, the
    heads' ``vote_aggregation``); the JAX names under mmdet3d's prefixes
    where it departs (the heads' norm-free linear stacks; H3DNet's
    ``rpn_head``, ``roi_head.primitive_{z,xy,line}`` from the JAX
    ``head``, ``primitive_heads_{i}``; ``roi_head.bbox_head`` from
    ``refine``; ImVoteNet's ``cue_proj``/``img_proj``, its image branch
    from ``backbone_img``/``neck_img``). ImVoteNet's JAX variables are
    those of both image paths (each init creates one path's projection;
    their union loads)."""
    rules, add = new_rules()
    kind = model_cfg['type']
    pointnet2_rules(add, model_cfg['backbone'])
    if kind == 'H3DNet':
        vote_head_rules(add, 'rpn_head', 'head')
        prims = model_cfg.get('primitive_list') or [
            dict(primitive_mode=m) for m in ('z', 'xy', 'line')]
        for i, cfg in enumerate(prims):
            t = f'roi_head.primitive_{cfg["primitive_mode"]}'
            f = f'primitive_heads_{i}'
            mlp_rules(add, f'{t}.flag_mlp', f'{f}/flag_mlp', 2)
            mlp_rules(add, f'{t}.vote_mlp', f'{f}/vote_mlp', 1)
            for name in ('flag_out', 'vote_out', 'feat_res'):
                add(f'{t}.{name}', f'{f}/{name}', 'linear')
        mlp_rules(add, 'roi_head.bbox_head.refine_mlp', 'refine/refine_mlp',
                  2)
        add('roi_head.bbox_head.refine_out', 'refine/refine_out', 'linear')
        return rules
    vote_head_rules(add, 'bbox_head', 'head', kind == 'SSD3DNet')
    if kind == 'ImVoteNet':
        mlp_rules(add, 'cue_proj', 'cue_proj', 1)
        if model_cfg.get('img_backbone'):
            resnet_rules(add, 'img_backbone', 'backbone_img',
                         model_cfg['img_backbone'].get('depth', 50))
            if model_cfg.get('img_neck'):
                fpn_rules(add, 'img_neck', 'neck_img',
                          len(model_cfg['img_neck']['in_channels']))
            mlp_rules(add, 'img_proj', 'img_proj', 1)
    return rules


INDOOR = ('VoteNet', 'SSD3DNet', 'H3DNet', 'ImVoteNet')


def zoo_rules(model_cfg) -> List[Rule]:
    """The mapping of a zoo detector, read from its config's ``model``:
    the point-based zoo (``indoor_rules``), ``PartA2``
    (``parta2_rules``), ``MVXFasterRCNN`` (``mvx_rules``; its JAX
    variables initialised with images) or a single-stage detector
    (``VoxelNet``, ``CenterPoint``, ``DynamicVoxelNet``: the voxel encoder,
    none for ``DynamicVoxelNet``, whose JAX detector calls none, the
    middle encoder, SECOND, SECONDFPN and the head)."""
    if model_cfg['type'] in INDOOR:
        return indoor_rules(model_cfg)
    if model_cfg['type'] == 'PartA2':
        return parta2_rules(model_cfg)
    if model_cfg['type'] == 'MVXFasterRCNN':
        return mvx_rules(model_cfg)
    rules, add = new_rules()
    _voxel_trunk_rules(add, model_cfg)
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
        elif kind == 'conv3d':
            put(t + '.weight', p(f + '/kernel').transpose(4, 3, 0, 1, 2))
        elif kind == 'deconv2d':
            put(t + '.weight',
                p(f + '/kernel')[::-1, ::-1].transpose(2, 3, 0, 1))
        elif kind in ('conv1d', 'linear'):
            dense(t, f, kind == 'conv1d')
        elif kind == 'pointwise':
            put(t + '.weight', p(f + '/kernel').T[:, :, None, None])
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
