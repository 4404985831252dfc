"""Port MSMDFusion vs the JAX package's, end to end on the CPU.

A tiny flagship keeps the layout of ``configs/MSMDFusion_nusc_voxel_LC.py``
(ResNet + FPN, the depth-aware compression to 49 channels, four 2D voxel
scales, four GMA stages, SPP, SECOND, SECONDFPN, one decoder layer) with
ResNet-18, narrow sparse widths, a 64 x 64 x 41 grid, two 64 x 96 cameras
and 10 proposals. Random JAX variables (numpy, seeded) go into the port
through ``from_jax_variables``; the dense heatmap, the chosen proposals,
the head outputs and the decoded boxes agree to 1e-4 of the largest
reference value. The port's ``state_dict()`` of the full-width layout
converts back through the JAX package's ``convert_msmdfusion`` and
``merge_variables`` leaf for leaf, and the port's realistic scene equals
the JAX package's ``realistic_batch``.
"""
import copy

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import msmdfusion_tpu.models  # noqa: F401
from msmdfusion_tpu.models.builder import build_detector as jax_build
from msmdfusion_tpu.utils.synth_scene import realistic_batch as jax_scene
from msmdfusion_tpu.utils.torch_convert import (convert_msmdfusion,
                                                merge_variables)

import msmdfusion_torch.models  # noqa: F401
from msmdfusion_torch.models.builder import build_detector as port_build
from msmdfusion_torch.utils import overflow
from msmdfusion_torch.utils.convert import (from_jax_variables,
                                            msmdfusion_rules)
from msmdfusion_torch.utils.synth_scene import realistic_batch
from tests.test_torch_transfusion_l import flatten, randomize

TOL = 1e-4
PCR = [-2.4, -2.4, -5.0, 2.4, 2.4, 3.0]
VOX = [0.075, 0.075, 0.2]
CAP = 6000
IMG_HW = (64, 96)
FG_KEYS = ('fg_pixels', 'fg_points', 'fg_mask', 'fg_real_pixels',
           'fg_real_mask', 'lidar2img')


def tiny_config(depth=18, layer_nums=(2, 2)):
    """The flagship's layout at a 64 x 64 x 41 grid with narrow widths."""
    in_ch = {18: [64, 128, 256, 512], 50: [256, 512, 1024, 2048]}[depth]
    return dict(
        type='MSMDFusionDetector',
        spatial_shapes=[[41, 64, 64], [21, 32, 32], [11, 16, 16], [5, 8, 8]],
        downscale_factors=[1, 2, 4, 8],
        fps_num_list=[16] * 4,
        radius_list=[6, 3, 2, 1],
        max_cluster_samples_list=[8] * 4,
        dist_thresh_list=[13.3, 6.6, 3.3, 1.6],
        fg_max_voxels=[600] * 4,
        img_backbone=dict(type='ResNet', depth=depth, num_stages=4,
                          out_indices=(0, 1, 2, 3), frozen_stages=1,
                          norm_eval=True),
        img_neck=dict(type='FPN', in_channels=in_ch, out_channels=16,
                      num_outs=5),
        pts_voxel_layer=dict(max_num_points=10, voxel_size=VOX,
                             max_voxels=(CAP, CAP), point_cloud_range=PCR),
        pts_voxel_encoder=dict(type='HardSimpleVFE', num_features=5),
        pts_middle_encoder=dict(
            type='SparseEncoder', in_channels=5, sparse_shape=[41, 64, 64],
            base_channels=4, output_channels=8,
            encoder_channels=((4, 4, 8), (8, 8, 8), (8, 8, 8), (8, 8)),
            encoder_paddings=((0, 0, 1), (0, 0, 1), (0, 0, (0, 1, 1)),
                              (0, 0)),
            block_type='basicblock'),
        multimodal_middle_encoder=dict(
            type='SparseMultiModalEncoderPaint',
            in_channels_3D=(4, 8, 8, 8), in_channels_2D=(64, 64, 64, 64),
            out_channels=(8, 8, 8, 8), padding=(1, 1, (0, 1, 1), 0)),
        pts_backbone=dict(type='SECOND', in_channels=256,
                          out_channels=[8, 16], layer_nums=list(layer_nums),
                          layer_strides=[1, 2]),
        pts_neck=dict(type='SECONDFPN', in_channels=[8, 16],
                      out_channels=[8, 8], upsample_strides=[1, 2],
                      use_conv_for_no_stride=True),
        pts_bbox_head=dict(
            type='TransFusionHead', num_proposals=10, auxiliary=True,
            in_channels=16, hidden_channel=16, num_classes=10,
            num_decoder_layers=1, num_heads=2, nms_kernel_size=3,
            ffn_channel=32, dropout=0.1,
            common_heads=dict(center=(2, 2), height=(1, 2), dim=(3, 2),
                              rot=(2, 2), vel=(2, 2)),
            bbox_coder=dict(
                type='TransFusionBBoxCoder', pc_range=PCR[:2],
                voxel_size=VOX[:2], out_size_factor=8,
                post_center_range=[-61.2, -61.2, -10.0, 61.2, 61.2, 10.0],
                score_threshold=0.0, code_size=10)),
        test_cfg=dict(pts=dict(
            dataset='nuScenes', grid_size=[64, 64, 40], out_size_factor=8,
            pc_range=PCR[:2], voxel_size=VOX[:2], nms_type=None)))


def make_batch(rng, v=2, m=256, mr=128):
    """One frame: a ground plane and four box clusters of LiDAR points;
    foreground points on and around the boxes (so 2D voxels are mixed and
    orphaned); real foreground pixels with repeats on the canvas."""
    h, w = IMG_HW
    ground = np.stack([rng.uniform(-2.4, 2.4, 4000),
                       rng.uniform(-2.4, 2.4, 4000),
                       -1.8 + rng.normal(0, 0.03, 4000)], 1)
    boxes = []
    for _ in range(4):
        c = rng.uniform(-1.8, 1.8, 2)
        boxes.append(np.stack([c[0] + rng.uniform(-0.4, 0.4, 300),
                               c[1] + rng.uniform(-0.2, 0.2, 300),
                               rng.uniform(-1.8, -0.2, 300)], 1))
    boxes = np.concatenate(boxes)
    xyz = np.concatenate([ground, boxes])
    points = np.concatenate([xyz, rng.rand(len(xyz), 2)], 1)
    fg_xyz = boxes[rng.randint(0, len(boxes), (v, m))]
    fg_xyz += rng.normal(0, 0.05, fg_xyz.shape) * (rng.rand(v, m, 1) < 0.5)
    label = np.eye(11)[rng.randint(0, 10, (v, m))]
    fg_points = np.concatenate([fg_xyz, label, np.zeros((v, m, 1))], -1)
    fg_pixels = np.stack([rng.uniform(-2, w + 2, (v, m)),
                          rng.uniform(-2, h + 2, (v, m)),
                          rng.uniform(1, 50, (v, m))], -1)
    cells = rng.randint(0, 40, (v, mr, 2)) + rng.rand(v, mr, 2)
    fg_real = np.concatenate([cells * [w / 40, h / 40],
                              rng.uniform(1, 50, (v, mr, 1))], -1)
    fg = dict(fg_pixels=fg_pixels, fg_points=fg_points,
              fg_mask=rng.rand(v, m) < 0.9, fg_real_pixels=fg_real,
              fg_real_mask=rng.rand(v, mr) < 0.9,
              lidar2img=rng.randn(v, 4, 4) * 0.1)
    fg = {k: np.asarray(x[None], np.float32 if x.dtype != bool else bool)
          for k, x in fg.items()}
    return dict(points=points[None].astype(np.float32),
                points_mask=np.ones((1, len(xyz)), bool),
                img=rng.randn(1, v, h, w, 3).astype(np.float32), fg=fg)


def jax_inputs(batch):
    return (jnp.asarray(batch['points']), jnp.asarray(batch['points_mask']),
            jnp.asarray(batch['img']),
            {k: jnp.asarray(batch['fg'][k]) for k in FG_KEYS})


def port_inputs(batch):
    return (torch.from_numpy(batch['points']),
            torch.from_numpy(batch['points_mask']),
            torch.from_numpy(batch['img']),
            {k: torch.from_numpy(batch['fg'][k]) for k in FG_KEYS})


def build_pair(cfg, batch, rules, seed=0):
    """(JAX model, seeded random variables, port model loaded from them)."""
    jmodel = jax_build({k: v for k, v in cfg.items()})
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            *jax_inputs(batch))
    variables = randomize(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), dict(shapes)),
        np.random.RandomState(seed))
    port = port_build(copy.deepcopy(cfg), device='cpu')
    port.load_state_dict(from_jax_variables(variables, rules))
    return jmodel, variables, port


@pytest.fixture(scope='module')
def tiny():
    batch = make_batch(np.random.RandomState(0))
    jmodel, variables, port = build_pair(
        tiny_config(), batch, msmdfusion_rules(depth=18, layer_nums=(2, 2)))
    return jmodel, variables, port, batch


def assert_close(got, want, msg=''):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=TOL,
                               atol=TOL * np.abs(want).max(), err_msg=msg)


def test_detector_outputs_and_boxes_match_jax(tiny):
    jmodel, variables, port, batch = tiny

    @jax.jit
    def run(v, *args):
        preds = jmodel.apply(v, *args)
        return preds, jmodel.apply(v, preds, method=type(jmodel).get_bboxes)
    jpreds, jboxes = run(variables, *jax_inputs(batch))
    with torch.no_grad(), overflow.capture() as cap:
        preds = port(*port_inputs(batch))
        boxes = port.get_bboxes(preds)
    assert cap.total() == 0, cap.counters()
    assert preds['dense_heatmap'].shape == (1, 10, 8, 8)
    np.testing.assert_array_equal(preds['query_labels'].numpy(),
                                  np.asarray(jpreds['query_labels']))
    for key in ('dense_heatmap', 'query_heatmap_score', 'heatmap', 'center',
                'height', 'dim', 'rot', 'vel'):
        assert preds[key].shape == tuple(jpreds[key].shape), key
        assert_close(preds[key].numpy(), jpreds[key], key)
    for key in ('bboxes', 'scores'):
        assert_close(boxes[key].numpy(), jboxes[key], key)
    for key in ('labels', 'valid'):
        np.testing.assert_array_equal(boxes[key].numpy(),
                                      np.asarray(jboxes[key]), key)
    assert np.isfinite(boxes['bboxes'].numpy()).all()


def test_state_dict_round_trips_through_jax_converter():
    """The full-width layout (ResNet-50, SECOND (5, 5)) that the JAX
    converter's table is written for, on the tiny grid."""
    batch = make_batch(np.random.RandomState(1))
    cfg = tiny_config(depth=50, layer_nums=(5, 5))
    _, variables, port = build_pair(cfg, batch, msmdfusion_rules(), seed=1)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    converted, unused = convert_msmdfusion(copy.deepcopy(sd))
    dummies = [f'multimodal_middle_encoder.dummy_embedding_{i}'
               for i in range(4)]
    assert sorted(unused) == dummies
    zeros = jax.tree_util.tree_map(np.zeros_like, variables)
    merged = merge_variables(zeros, converted)
    for col in ('params', 'batch_stats'):
        got, want = flatten(merged[col]), flatten(variables[col])
        assert set(got) == set(want), sorted(set(got) ^ set(want))[:5]
        for path, value in want.items():
            if 'dummy_embedding' in path:
                continue            # no reference key: carried by the port
            np.testing.assert_array_equal(got[path], value, err_msg=path)
    for i, key in enumerate(dummies):
        np.testing.assert_array_equal(
            sd[key], variables['params']['mm_encoder'][f'dummy_embedding_{i}'])


def test_realistic_scene_equals_jax():
    shape = dict(n=4000, v=6, m=1500, mr=600, img_hw=(96, 160),
                 pcr=[-54.0, -54.0, -5.0, 54.0, 54.0, 3.0])
    want = jax_scene(shape, b=1, seed=3)
    with overflow.capture() as cap:
        got = realistic_batch(shape, b=1, seed=3)
    for key in ('points', 'points_mask', 'img'):
        np.testing.assert_array_equal(got[key], want[key], key)
    assert set(got['fg']) == set(want['fg'])
    for key, value in want['fg'].items():
        assert got['fg'][key].dtype == value.dtype, key
        np.testing.assert_array_equal(got['fg'][key], value, key)
    assert got['fg']['fg_mask'].sum() > 500       # foreground was generated
    assert set(cap.counters()) <= {'foreground.points_cap',
                                   'foreground.pixels_cap',
                                   'foreground.real_pixels_cap'}
