"""The Waymo TransFusion configs, port vs the JAX package, on the CPU.

``configs/transfusion_waymo_voxel_{L,LC}.py`` differ from nuScenes where
the port had code that nothing ran yet: a code-size-8 coder (no ``vel``
branch, no velocity in the targets), 3 classes with the flat classes
(1, 2) in the local-maximum NMS, 300 proposals, SECONDFPN's conv for its
stride-1 branch, a [41, 1504, 1504] grid with 150,000 voxels, and five
cameras for LC.

- The code-size-8 head at tiny widths (an 8 x 8 BEV, 10 proposals) with
  seeded JAX variables carried by ``from_jax_variables``: inference and
  decode, and in training the targets and the losses, against the JAX
  head (one compile) to ``test_torch_train_step``'s ``TOL``.
- Both configs build at full width on the port, and the converter's
  tables (``transfusion_l_rules``/``transfusion_lc_rules`` with
  ``velocity=False``) name every key.
- Port only: a tiny Waymo TransFusion-L runs inference and one
  ``make_train_step`` under the config's recipe (its cyclic schedule, 8
  code weights), a tiny Waymo LC inference on five views, and
  ``synth_scene.lc_batch`` gives both datasets' frames.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import msmdfusion_tpu.models  # noqa: F401
from msmdfusion_tpu.config import load_config
from msmdfusion_tpu.registry import HEADS as JAX_HEADS

import msmdfusion_torch.models  # noqa: F401
from msmdfusion_torch.apis.train import (build_lr_schedule, build_optimizer,
                                         frozen_prefixes, make_train_step)
from msmdfusion_torch.config import load_config as port_load_config
from msmdfusion_torch.models.builder import build_detector as port_build
from msmdfusion_torch.models.layers import Conv2d
from msmdfusion_torch.registry import HEADS
from msmdfusion_torch.utils import synth_scene
from msmdfusion_torch.utils.convert import (from_jax_variables,
                                            transfusion_l_rules,
                                            transfusion_lc_rules)
from tests.test_torch_bf16_train import one_thread  # noqa: F401
from tests.test_torch_train_step import TOL
from tests.test_torch_transfusion_l import (PCR, make_points, randomize,
                                            tiny_model_cfg)
from tests.test_torch_transfusion_lc import (IMG_HW, assert_close,
                                             lc_model_cfg, rig, rule_keys)

WAYMO_L = 'configs/transfusion_waymo_voxel_L.py'
WAYMO_LC = 'configs/transfusion_waymo_voxel_LC.py'
HEAD_IN = 16


def head_cfg(load):
    """The Waymo head at the tiny TransFusion-L's widths and range."""
    cfg = tiny_model_cfg(load, WAYMO_L)
    cfg.pts_bbox_head.update(dropout=0.0)
    train = dict(cfg.train_cfg.pts, grid_size=[64, 64, 40],
                 point_cloud_range=PCR)
    return dict(cfg.pts_bbox_head, train_cfg=train,
                test_cfg=dict(cfg.test_cfg.pts))


def make_gt7(rng, g=6, valid=4):
    """Padded Waymo ground truth: 7-wide bottom-centre boxes, 3 classes."""
    boxes = np.zeros((1, g, 7), np.float32)
    boxes[0, :, :2] = rng.uniform(-1.8, 1.8, (g, 2))
    boxes[0, :, 2] = -1.8
    boxes[0, :, 3:6] = rng.uniform(0.4, 1.6, (g, 3))
    boxes[0, :, 6] = rng.uniform(-np.pi, np.pi, g)
    labels = rng.randint(0, 3, (1, g)).astype(np.int32)
    ok = np.zeros((1, g), bool)
    ok[0, :valid] = True
    return dict(gt_bboxes=boxes, gt_labels=labels, gt_valid=ok)


@pytest.fixture(scope='module')
def waymo_head():
    rng = np.random.RandomState(7)
    bev = rng.randn(1, 8, 8, HEAD_IN).astype(np.float32)
    gt = make_gt7(rng)
    jhead = JAX_HEADS.build(head_cfg(load_config))
    shapes = jax.eval_shape(jhead.init, jax.random.PRNGKey(0), bev)
    variables = randomize(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), dict(shapes)), rng)
    jgt = [jnp.asarray(gt[k]) for k in ('gt_bboxes', 'gt_labels',
                                        'gt_valid')]

    @jax.jit
    def jax_side(variables):
        preds = jhead.apply(variables, bev)
        boxes = jhead.apply(variables, preds, method=type(jhead).get_bboxes)
        tpreds, _ = jhead.apply(variables, bev, train=True,
                                mutable=['batch_stats'])
        targets = jhead.apply(variables, tpreds, *jgt,
                              method=type(jhead).get_targets)
        losses = jhead.apply(variables, tpreds, *jgt,
                             method=type(jhead).loss)
        return preds, boxes, tpreds, targets, losses
    preds, boxes, tpreds, targets, losses = jax_side(variables)

    head = HEADS.build(head_cfg(port_load_config))
    rules = [(t[len('pts_bbox_head.'):], f[len('bbox_head/'):], kind, ks)
             for t, f, kind, ks in transfusion_l_rules(velocity=False)
             if t.startswith('pts_bbox_head.')]
    head.load_state_dict(from_jax_variables(variables, rules))
    x = torch.from_numpy(bev).permute(0, 3, 1, 2).contiguous()
    tgt = [torch.from_numpy(gt[k]) for k in ('gt_bboxes', 'gt_labels',
                                             'gt_valid')]
    with torch.no_grad():
        head.eval()
        got = head(x)
        got_boxes = head.get_bboxes(got)
        head.train()
        got_t = head(x)
        got_targets = head.get_targets(got_t, *tgt)
        got_losses = head.loss(got_t, *tgt, targets=got_targets)
    return dict(preds=preds, boxes=boxes, tpreds=tpreds, targets=targets,
                losses=losses, got=got, got_boxes=got_boxes, got_t=got_t,
                got_targets=got_targets, got_losses=got_losses)


def test_waymo_head_forward_and_decode_match_jax(waymo_head):
    got, want = waymo_head['got'], waymo_head['preds']
    assert 'vel' not in got and set(got) == set(want) | {'query_spatial'}
    np.testing.assert_array_equal(got['query_labels'].numpy(),
                                  np.asarray(want['query_labels']))
    for key in ('dense_heatmap', 'query_heatmap_score', 'heatmap', 'center',
                'height', 'dim', 'rot'):
        assert got[key].shape == tuple(want[key].shape), key
        assert_close(got[key].numpy(), want[key], key)
    assert got['dense_heatmap'].shape == (1, 3, 8, 8)
    boxes, jboxes = waymo_head['got_boxes'], waymo_head['boxes']
    assert boxes['bboxes'].shape == (1, 10, 7)
    for key in ('bboxes', 'scores'):
        assert_close(boxes[key].numpy(), jboxes[key], key)
    for key in ('labels', 'valid'):
        np.testing.assert_array_equal(boxes[key].numpy(),
                                      np.asarray(jboxes[key]), key)


def test_waymo_head_targets_and_losses_match_jax(waymo_head):
    labels, _, bbox_targets, bbox_weights, num_pos, ious, heatmap = \
        waymo_head['got_targets']
    jlabels, _, jtargets, jweights, jnum, jious, jheatmap = \
        waymo_head['targets']
    assert bbox_targets.shape == (1, 10, 8)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
    np.testing.assert_array_equal(bbox_weights.numpy(), np.asarray(jweights))
    assert int(num_pos) == int(jnum) > 0
    np.testing.assert_allclose(bbox_targets.numpy(), np.asarray(jtargets),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(heatmap.numpy(), np.asarray(jheatmap),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(ious), float(jious), rtol=1e-5,
                               atol=1e-6)
    losses, jlosses = waymo_head['got_losses'], waymo_head['losses']
    assert set(losses) == set(jlosses)
    for key, want in jlosses.items():
        np.testing.assert_allclose(float(losses[key]), float(want),
                                   rtol=TOL, atol=1e-6, err_msg=key)


@pytest.mark.parametrize('config,num_views', [(WAYMO_L, 0), (WAYMO_LC, 5)])
def test_waymo_configs_build_at_full_width(config, num_views):
    cfg = port_load_config(config)
    model = port_build(cfg.model, device='cpu')
    head = model.pts_bbox_head
    assert head.coder.code_size == 8 and head.num_proposals == 300
    assert head._flat_classes() == (1, 2) and head.num_classes == 3
    assert not any(k.startswith('pts_bbox_head.prediction_heads.0.vel')
                   for k in model.state_dict())
    assert isinstance(model.pts_neck.deblocks[0][0], Conv2d)
    assert list(model.pts_middle_encoder.sparse_shape) == [41, 1504, 1504]
    assert head._bev_shape() == (188, 188)
    assert len(head.decoder) == (2 + num_views if num_views else 1)
    rules = (transfusion_lc_rules(num_views, velocity=False) if num_views
             else transfusion_l_rules(velocity=False))
    got, want = rule_keys(rules), set(model.state_dict())
    assert got >= want and all(k.endswith('.bias') for k in got - want)


def waymo_tiny(lc):
    """A tiny Waymo TransFusion-L (or LC with five views) on the port."""
    if lc:
        cfg = lc_model_cfg(port_load_config, WAYMO_LC, num_views=5)
    else:
        cfg = tiny_model_cfg(port_load_config, WAYMO_L)
    cfg.pts_bbox_head.update(dropout=0.0)
    cfg.train_cfg.pts.update(grid_size=[64, 64, 40], point_cloud_range=PCR)
    return port_build(cfg, device='cpu', seed=2)


def test_waymo_tiny_l_infers_and_trains():
    rng = np.random.RandomState(8)
    points, mask = make_points(rng)
    inputs = (torch.from_numpy(points), torch.from_numpy(mask))
    model = waymo_tiny(lc=False)
    with torch.no_grad():
        boxes = model.get_bboxes(model(*inputs))
    assert boxes['bboxes'].shape == (1, 10, 7)
    assert torch.isfinite(boxes['bboxes']).all()
    assert int(boxes['labels'].max()) < 3
    cfg = port_load_config(WAYMO_L)
    assert cfg.lr_config['policy'] == 'cyclic'
    assert list(cfg.model.train_cfg.pts.code_weights) == [1.0] * 8
    opt = build_optimizer(model, dict(cfg.optimizer),
                          dict(cfg.optimizer_config), build_lr_schedule(
                              dict(cfg.lr_config), cfg.optimizer['lr'], 10,
                              1), frozen_prefixes=frozen_prefixes(cfg))
    gt = {k: torch.from_numpy(v)
          for k, v in make_gt7(np.random.RandomState(9)).items()}
    before = {k: v.clone() for k, v in model.state_dict().items()}
    metrics = make_train_step(model, opt)(dict(inputs=inputs, **gt), 0)
    assert all(bool(torch.isfinite(v).all()) for v in metrics.values())
    assert float(metrics['layer_-1_loss_bbox']) > 0
    moved = [k for k, v in model.state_dict().items()
             if not torch.equal(v, before[k])]
    assert any(k.startswith('pts_bbox_head.') for k in moved)


def test_waymo_tiny_lc_infers_with_five_views():
    rng = np.random.RandomState(8)
    points, mask = make_points(rng)
    inputs = (torch.from_numpy(points), torch.from_numpy(mask),
              torch.from_numpy(rng.randn(1, 5, *IMG_HW, 3).astype(
                  np.float32)),
              dict(lidar2img=torch.from_numpy(
                  rig((0.0, 72.0, 144.0, 216.0, 288.0)))))
    model = waymo_tiny(lc=True)
    with torch.no_grad():
        preds = model(*inputs)
        boxes = model.get_bboxes(preds)
    assert 'vel' not in preds and preds['on_the_image'].any()
    assert boxes['bboxes'].shape == (1, 10, 7)
    assert torch.isfinite(boxes['bboxes']).all()
    assert int(boxes['labels'].max()) < 3


@pytest.mark.parametrize('dataset', ['nuScenes', 'Waymo'])
def test_lc_batch(dataset):
    pcr = ([-54.0, -54.0, -5.0, 54.0, 54.0, 3.0] if dataset == 'nuScenes'
           else [-75.2, -75.2, -2.0, 75.2, 75.2, 4.0])
    waymo = dataset == 'Waymo'
    n = 30000
    shape = dict(n=n, img_hw=(64, 96), pcr=pcr,
                 yaws=synth_scene.LC_YAWS[dataset])
    batch = synth_scene.lc_batch(shape, seed=3, return_gt=True,
                                 num_classes=3 if waymo else 10,
                                 box_dim=7 if waymo else 9)
    v = 5 if waymo else 6
    assert batch['img'].shape == (1, v, 64, 96, 3)
    # the points are the TransFusion-L frame's of the same seed
    pts, objects = synth_scene.lidar_scene(np.random.RandomState(3), n, pcr)
    np.testing.assert_array_equal(batch['points'][0], pts)
    assert np.abs(pts[:, :2]).max() > 0.9 * pcr[3]
    l2i = batch['metas']['lidar2img']
    np.testing.assert_array_equal(l2i[0], synth_scene.camera_rig(
        (64, 96), v, 3, synth_scene.LC_YAWS[dataset]))
    gt = batch['gt']
    assert gt['gt_bboxes'].shape == (1, 32, 7 if waymo else 9)
    assert gt['gt_valid'].sum() == min(len(objects), 32)
    assert gt['gt_labels'].max() < (3 if waymo else 10)
    # each camera looks along its yaw: a point ahead of it projects in front
    for cam, yaw in enumerate(np.deg2rad(synth_scene.LC_YAWS[dataset])):
        ahead = np.array([20 * np.cos(yaw), 20 * np.sin(yaw), 0, 1])
        u, vv, d = (l2i[0, cam] @ ahead)[:3]
        assert d > 0 and 0 < u / d < 96 and 0 < vv / d < 64
