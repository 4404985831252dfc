"""Port TransFusion-L vs the JAX package's, end to end on the CPU.

A tiny TransFusion-L keeps the stage layout of
``configs/transfusion_nusc_voxel_L.py`` (four encoder stages of two basic
blocks, SECOND (5, 5), SECONDFPN, one decoder layer, z = 41) with narrow
channels, a 64 x 64 grid and 10 proposals. Random JAX variables (numpy,
seeded) go into the port through ``from_jax_variables``; the encoder BEV,
the dense heatmap, the chosen proposals and the decoded boxes agree to
1e-4 relative to the largest reference value. The port's ``state_dict()``
converts back through the JAX package's own ``convert_transfusion_l`` to
the same tree, leaf for leaf.
"""
import copy

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import msmdfusion_tpu.models  # noqa: F401
from msmdfusion_tpu.config import load_config
from msmdfusion_tpu.models.builder import build_detector as jax_build
from msmdfusion_tpu.ops.voxelize import voxelize_mean_batch as jax_voxelize
from msmdfusion_tpu.utils.torch_convert import convert_transfusion_l

import msmdfusion_torch.models  # noqa: F401
from msmdfusion_torch.config import load_config as port_load_config
from msmdfusion_torch.models.builder import build_detector as port_build
from msmdfusion_torch.ops.voxelize import voxelize_mean_batch
from msmdfusion_torch.utils import overflow
from msmdfusion_torch.utils.convert import from_jax_variables
from tests.torch_threads import one_thread  # noqa: F401

TOL = 1e-4
PCR = [-2.4, -2.4, -5.0, 2.4, 2.4, 3.0]
CAP = 6000


def tiny_model_cfg(load=load_config,
                   config='configs/transfusion_nusc_voxel_L.py'):
    cfg = load(config).model
    cfg.pts_voxel_layer.update(max_voxels=(CAP, CAP), point_cloud_range=PCR)
    cfg.pts_middle_encoder.update(
        sparse_shape=[41, 64, 64], base_channels=4, output_channels=8,
        encoder_channels=((4, 4, 8), (8, 8, 8), (8, 8, 8), (8, 8)),
        stage_capacities=[8000, 4000, 2000, 2000])
    cfg.pts_backbone.update(in_channels=16, out_channels=[8, 16])
    cfg.pts_neck.update(in_channels=[8, 16], out_channels=[8, 8])
    cfg.pts_bbox_head.update(num_proposals=10, in_channels=16,
                             hidden_channel=16, num_heads=2, ffn_channel=32)
    cfg.pts_bbox_head.bbox_coder.update(pc_range=PCR[:2])
    cfg.test_cfg.pts.update(grid_size=[64, 64, 40], pc_range=PCR[:2])
    return cfg


def make_points(rng):
    """A ground plane over the whole grid plus four upright box clusters."""
    ground = np.stack([rng.uniform(-2.4, 2.4, 5000),
                       rng.uniform(-2.4, 2.4, 5000),
                       -1.8 + rng.normal(0, 0.03, 5000)], 1)
    boxes = []
    for _ in range(4):
        c = rng.uniform(-1.8, 1.8, 2)
        boxes.append(np.stack([c[0] + rng.uniform(-0.4, 0.4, 300),
                               c[1] + rng.uniform(-0.2, 0.2, 300),
                               rng.uniform(-1.8, -0.2, 300)], 1))
    xyz = np.concatenate([ground] + boxes)
    feats = np.concatenate([xyz, rng.rand(len(xyz), 2)], 1)
    return feats[None].astype(np.float32), np.ones((1, len(xyz)), bool)


def randomize(tree, rng, path=''):
    """Seeded random values for every leaf of a flax variable tree."""
    out = {}
    for k, v in tree.items():
        p = f'{path}/{k}'
        if isinstance(v, dict):
            out[k] = randomize(v, rng, p)
            continue
        shape = tuple(v.shape)
        if k == 'kernel':
            fan_in = int(np.prod(shape[:-1]))
            val = rng.randn(*shape) * np.sqrt(2.0 / fan_in)
        elif k in ('scale', 'var'):
            val = rng.uniform(0.5, 1.5, shape)
        elif k == 'mean':
            val = rng.randn(*shape) * 0.1
        else:                                   # biases
            val = rng.randn(*shape) * 0.05
        out[k] = val.astype(np.float32)
    return out


def flatten(tree, prefix=''):
    out = {}
    for k, v in tree.items():
        path = f'{prefix}/{k}' if prefix else k
        if isinstance(v, dict):
            out.update(flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


@pytest.fixture(scope='module')
def models():
    rng = np.random.RandomState(0)
    points, mask = make_points(rng)
    jmodel = jax_build(tiny_model_cfg())
    init = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(points),
                       jnp.asarray(mask))
    variables = randomize(jax.tree_util.tree_map(np.asarray, dict(init)),
                          rng)
    port = port_build(tiny_model_cfg(port_load_config), device='cpu')
    port.load_state_dict(from_jax_variables(variables))
    return jmodel, variables, port, points, mask


def assert_close(got, want, msg=''):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=TOL,
                               atol=TOL * np.abs(want).max(), err_msg=msg)


def test_encoder_bev_matches_jax(models):
    jmodel, variables, port, points, mask = models

    def encode(m, pts, msk):
        vl = m.pts_voxel_layer
        f, c, v = jax_voxelize(pts, msk, vl['voxel_size'],
                               vl['point_cloud_range'], CAP)
        return m.middle_encoder(f, c, v, 1, assume_sorted=True)[0]

    want = jmodel.apply(variables, jnp.asarray(points), jnp.asarray(mask),
                        method=encode)                     # [B, H, W, C*D]
    with torch.no_grad(), overflow.capture() as cap:
        f, c, v = voxelize_mean_batch(torch.from_numpy(points),
                                      torch.from_numpy(mask),
                                      port.pts_voxel_layer['voxel_size'], PCR,
                                      CAP)
        bev, stages = port.pts_middle_encoder(f, c, v, 1, assume_sorted=True)
    assert cap.total() == 0, cap.counters()
    assert bev.shape == (1, 16, 8, 8)
    assert [s.num_channels for s in stages] == [4, 8, 8, 8, 8]
    assert float(bev.abs().max()) > 0
    assert_close(bev.permute(0, 2, 3, 1).numpy(), want)


def test_detector_outputs_and_boxes_match_jax(models):
    jmodel, variables, port, points, mask = models
    jpreds = jmodel.apply(variables, jnp.asarray(points), jnp.asarray(mask))
    jboxes = jmodel.apply(variables, jpreds, method=type(jmodel).get_bboxes)
    with torch.no_grad(), overflow.capture() as cap:
        preds = port(torch.from_numpy(points), torch.from_numpy(mask))
        boxes = port.get_bboxes(preds)
    assert cap.total() == 0, cap.counters()
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
    assert boxes['bboxes'].shape == (1, 10, 9)


def test_state_dict_round_trips_through_jax_converter(models):
    _, variables, port, _, _ = models
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    converted, unused = convert_transfusion_l(copy.deepcopy(sd))
    assert not unused, unused[:5]
    for col in ('params', 'batch_stats'):
        got, want = flatten(converted[col]), flatten(variables[col])
        assert set(got) == set(want), sorted(set(got) ^ set(want))[:5]
        for path, value in want.items():
            np.testing.assert_array_equal(got[path], value, err_msg=path)
    with pytest.raises(KeyError):
        extra = copy.deepcopy(variables)
        extra['params']['stray'] = {'kernel': np.zeros((2, 2), np.float32)}
        from_jax_variables(extra)
