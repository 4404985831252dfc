"""MVXNet's fusion and test-time augmentation, port vs the JAX package, on
the CPU.

- ``apply_3d_transformation`` (both directions, a recorded flow),
  ``coord_2d_transform`` and ``bbox_2d_transform`` (scale, crop, flip,
  both directions), ``project_points_to_image`` (points behind the
  camera: the 1e-5 depth clamp) and ``bilinear_sample`` (points off the
  map's edges: the clamped corners), each within ``TOL`` of the JAX
  function; ``bilinear_sample`` also against ``F.grid_sample(...,
  padding_mode='border', align_corners=False)``.
- ``PointFusion`` with and without ``fuse_out`` on seeded weights.
- the tiny ``MVXFasterRCNN`` of ``tests/test_mvx_fusion.py`` (two samples,
  two views, ``PointPillarsScatter``, a ResNet-18 image branch) with
  images: the eval forward, and the training-mode forward, losses and
  every gradient against ``jax.grad``, in one jitted JAX function; each
  sample's outputs unmoved by the other sample's image; without images it
  raises; the CLIs refuse it.
- ``MultiScaleFlipAug3D`` (one view: the sample itself; eight views: their
  points and records), ``merge_aug_bboxes_3d`` on 9-wide boxes, and
  ``aug_test_detector`` over the tiny TransFusion-L of
  ``tests/test_torch_transfusion_l.py`` on four views (the JAX
  ``simple_test`` one jitted function).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

import msmdfusion_tpu.datasets  # noqa: F401
import msmdfusion_tpu.models  # noqa: F401
from msmdfusion_tpu.datasets.pipelines import test_time_aug as jtta
from msmdfusion_tpu.models import fusion_layers as jfl
from msmdfusion_tpu.models.builder import build_detector as jax_build
from msmdfusion_tpu.models.detectors import mvx_two_stage as jmvx

import msmdfusion_torch.datasets  # noqa: F401
import msmdfusion_torch.models  # noqa: F401
from msmdfusion_torch.apis.inference import make_batch_infer
from msmdfusion_torch.config import load_config
from msmdfusion_torch.datasets.pipelines import test_time_aug as ttta
from msmdfusion_torch.models import fusion_layers as tfl
from msmdfusion_torch.models.builder import build_detector as port_build
from msmdfusion_torch.models.detectors import mvx_two_stage as tmvx
from msmdfusion_torch.utils.convert import (from_jax_variables, mvx_rules,
                                            new_rules, zoo_rules)
from tests.test_mvx_fusion import _cfg as mvx_cfg
from tests.test_torch_parta2 import port_state, seeded_variables
from tests.test_torch_train_step import GRAD_TOL, NOISE
from tests.test_torch_transfusion_l import make_points, tiny_model_cfg
from tests.test_torch_zoo_detectors import channels_last, close, to_flax
from tests.torch_threads import one_thread  # noqa: F401

TOL = 1e-5


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_3d_and_2d_replays_match_jax():
    rng = np.random.RandomState(0)
    pts = rng.randn(40, 3).astype(np.float32) * 5
    for state in (dict(angle=0.3, scale=1.05, trans=(0.5, -0.2, 0.1),
                       flip_horizontal=True),
                  dict(angle=-0.7, scale=0.95, flip_vertical=True,
                       flip_horizontal=True,
                       transformation_3d_flow=['HF', 'S', 'R', 'VF', 'T'])):
        for reverse in (False, True):
            close(tfl.apply_3d_transformation(t(pts), state, reverse),
                  jfl.apply_3d_transformation(jnp.asarray(pts), state,
                                              reverse), TOL)
    uv = rng.uniform(0, 300, (30, 2)).astype(np.float32)
    boxes = np.concatenate([uv, uv + rng.uniform(5, 40, (30, 2)),
                            rng.rand(30, 2)], -1).astype(np.float32)
    for meta in ({}, dict(img_shape=(320, 480), scale_factor=0.5, flip=True,
                          img_crop_offset=(4.0, -2.0)),
                 dict(img_shape=(320, 480), scale_factor=(0.75, 0.5, 0.75,
                                                          0.5))):
        for ori2new in (True, False):
            close(tfl.coord_2d_transform(meta, t(uv), ori2new),
                  jfl.coord_2d_transform(meta, jnp.asarray(uv), ori2new),
                  TOL)
            close(tfl.bbox_2d_transform(meta, t(boxes), ori2new),
                  jfl.bbox_2d_transform(meta, jnp.asarray(boxes), ori2new),
                  TOL)


def test_projection_and_sampling_match_jax():
    rng = np.random.RandomState(1)
    # x forward (some behind), y left, z up; a camera looking along x
    pts = np.concatenate([rng.uniform(-1, 30, (60, 1)),
                          rng.uniform(-10, 10, (60, 2))], -1).astype(np.float32)
    intrinsics = np.eye(4, dtype=np.float32)
    intrinsics[:3, :3] = [[700, 0, 600], [0, 700, 180], [0, 0, 1]]
    l2i = intrinsics @ np.array([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0],
                                 [0, 0, 0, 1]], np.float32)
    uv, ok = tfl.project_points_to_image(t(pts), t(l2i), (360, 1200))
    juv, jok = jfl.project_points_to_image(jnp.asarray(pts),
                                           jnp.asarray(l2i), (360, 1200))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert 0 < int(ok.sum()) < len(ok) and (pts[:, 0] < 0).any()
    close(uv[ok], np.asarray(juv)[np.asarray(jok)], TOL)
    feat = rng.randn(6, 12, 40).astype(np.float32)
    samples = np.concatenate([rng.uniform(-20, 1220, (50, 1)),
                              rng.uniform(-20, 380, (50, 1))], -1)
    samples = samples.astype(np.float32)
    got = tfl.bilinear_sample(t(feat), t(samples), (360, 1200))
    close(got, jfl.bilinear_sample(jnp.asarray(feat.transpose(1, 2, 0)),
                                   jnp.asarray(samples), (360, 1200)), TOL)
    grid = torch.stack([t(samples[:, 0]) / 1200 * 2 - 1,
                        t(samples[:, 1]) / 360 * 2 - 1], -1)
    ref = F.grid_sample(t(feat)[None], grid[None, None], mode='bilinear',
                        padding_mode='border', align_corners=False)
    close(got, ref[0, :, 0].t().numpy(), TOL)


@pytest.mark.parametrize('fuse_out', [False, True])
def test_point_fusion_matches_jax(fuse_out):
    rng = np.random.RandomState(2)
    cfg = dict(img_channels=8, pts_channels=4, mid_channels=16,
               out_channels=6, img_levels=(0, 2), fuse_out=fuse_out)
    feats = [rng.randn(2, 8, h, w).astype(np.float32)
             for h, w in ((16, 16), (8, 8), (4, 4))]
    pts = rng.uniform(-4, 4, (80, 3)).astype(np.float32)
    pf = rng.randn(80, 4).astype(np.float32)
    l2i = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    l2i[:, 0, 0] = l2i[:, 1, 1] = 8.0
    l2i[1, 0, 3] = 10.0
    l2i[:, 2, 3] = 5.0
    jm = jfl.PointFusion(**cfg)
    jargs = ([jnp.asarray(f.transpose(0, 2, 3, 1)) for f in feats],
             jnp.asarray(pts), jnp.asarray(pf), jnp.asarray(l2i), (32, 32))
    variables = seeded_variables(lambda k: jm.init(k, *jargs), rng)
    want = jm.apply(variables, *jargs)
    rules, add = new_rules()
    for i, name in enumerate(('img_transform', 'pts_transform',
                              'fuse_conv')[:3 if fuse_out else 2]):
        add(f'fusion.{name}.0', f'fusion/Dense_{i}', 'linear')
    tm = tfl.PointFusion(**cfg)
    assert tm.out_width == (6 if fuse_out else 16)
    tm.load_state_dict(port_state({'params': {'fusion': variables['params']}},
                                  rules, 'fusion'))
    with torch.no_grad():
        got = tm([t(f) for f in feats], t(pts), t(pf), t(l2i), (32, 32))
    assert float(got.abs().max()) > 0
    close(got, want)


def mvx_train_cfg():
    cfg = mvx_cfg()
    cfg['train_cfg'] = dict(pts=dict(pos_iou_thr=0.5, neg_iou_thr=0.35,
                                     min_pos_iou=0.3))
    cfg['pts_bbox_head'].update(
        loss_cls=dict(gamma=2.0, alpha=0.25, loss_weight=1.0),
        loss_bbox=dict(beta=0.111, loss_weight=2.0),
        loss_dir=dict(loss_weight=0.2))
    return cfg


def mvx_inputs(rng, b=2, v=2, n=200):
    pts = np.concatenate([
        rng.uniform(-4.5, 4.5, (b, n, 2)), rng.uniform(-3.5, 3.5, (b, n, 1)),
        rng.uniform(0, 1, (b, n, 1))], -1).astype(np.float32)
    img = rng.randn(b, v, 32, 32, 3).astype(np.float32)
    l2i = np.tile(np.eye(4, dtype=np.float32), (b, v, 1, 1))
    l2i[:, :, 0, 0] = l2i[:, :, 1, 1] = 8.0
    l2i[:, 1, 0, 3] = 6.0
    l2i[:, :, 2, 3] = 5.0
    return pts, np.ones((b, n), bool), img, l2i


def test_tiny_mvx_matches_jax(one_thread):
    rng = np.random.RandomState(3)
    cfg = mvx_train_cfg()
    pts, mask, img, l2i = mvx_inputs(rng)
    jm = jax_build(cfg)
    jin = (jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(img),
           dict(lidar2img=jnp.asarray(l2i)))
    variables = seeded_variables(jm.init, rng, *jin)
    # residuals of a few units: seeded weights of the full scale decode
    # sizes past fp32's range (exp of the residual)
    variables['params']['bbox_head']['conv_reg']['kernel'] *= 0.05
    gt = np.zeros((2, 2, 7), np.float32)
    gt[..., :2] = rng.uniform(-3, 3, (2, 2, 2))
    gt[..., 2], gt[..., 3:6], gt[..., 6] = -1.0, [1.6, 3.9, 1.56], 0.3
    jgt = (jnp.asarray(gt), jnp.zeros((2, 2), jnp.int32),
           jnp.ones((2, 2), bool))

    def loss_fn(params):
        v = {'params': params, 'batch_stats': variables['batch_stats']}
        preds, _ = jm.apply(v, *jin, train=True, mutable=['batch_stats'])
        losses = jm.apply(v, preds, *jgt, method=type(jm).loss)
        return sum(losses.values()), (losses, preds)

    @jax.jit
    def run(variables):
        eval_preds = jm.apply(variables, *jin)
        (_, (losses, preds)), g = jax.value_and_grad(
            loss_fn, has_aux=True)(variables['params'])
        return eval_preds, jm.apply(variables, eval_preds,
                                    method=type(jm).get_bboxes), preds, \
            losses, g
    jeval, jdet, jtrain, jloss, jgrads = run(variables)

    port = port_build(cfg, device='cpu')
    assert port.pts_middle_encoder.in_channels == 8
    port.load_state_dict(from_jax_variables(variables, zoo_rules(cfg)))
    tin = (t(pts), t(mask), t(img), dict(lidar2img=t(l2i)))
    with torch.no_grad():
        preds = port(*tin)
        det = port.get_bboxes(preds)
    for key in jeval:
        close(channels_last(preds)[key], jeval[key], 1e-4)
    for key in ('labels', 'valid'):
        np.testing.assert_array_equal(det[key].numpy(), np.asarray(jdet[key]))
    close(det['boxes'], jdet['boxes'], 1e-4)
    # sample 0 does not see sample 1's image
    img2 = img.copy()
    img2[1] = 0
    with torch.no_grad():
        other = port(t(pts), t(mask), t(img2), dict(lidar2img=t(l2i)))
    for key in preds:
        assert torch.equal(other[key][0], preds[key][0]), key
        assert not torch.equal(other[key][1], preds[key][1]), key

    port.train()
    train_preds = port(*tin)
    for key in jtrain:
        close(channels_last(train_preds)[key], jtrain[key], 1e-4)
    losses = port.loss(train_preds, t(gt), torch.zeros(2, 2, dtype=torch.int64),
                       torch.ones(2, 2, dtype=torch.bool))
    assert sorted(losses) == sorted(jloss)
    for key in jloss:
        close(losses[key], jloss[key], 1e-4)
    sum(losses.values()).backward()
    want = from_jax_variables({'params': jax.tree_util.tree_map(
        np.asarray, jgrads), 'batch_stats': variables['batch_stats']},
        zoo_rules(cfg))
    params = dict(port.named_parameters())
    top = max(float(np.abs(v.numpy()).max()) for k, v in want.items()
              if k in params)
    for k, p in params.items():
        # the FPN levels PointFusion does not sample take no gradient
        grad = torch.zeros_like(p) if p.grad is None else p.grad
        close(grad, want[k].numpy(), GRAD_TOL, GRAD_TOL * NOISE * top)

    port.eval()
    with pytest.raises(ValueError, match='takes images'):
        port(t(pts), t(mask))
    with pytest.raises(NotImplementedError, match='fusion layer'):
        make_batch_infer(port, 'MVXFasterRCNN')


def test_mvxnet_config_widths_and_rules():
    cfg = load_config('configs/mvxnet_kitti.py').model
    port = port_build(cfg, device='cpu', seed=0)
    conv = port.pts_middle_encoder.conv_input[0].weight
    assert tuple(conv.shape) == (16, 3, 3, 3, 128)      # (27, 128, 16) taps
    assert port.pts_fusion_layer.img_transform[0].weight.shape == (128, 1280)
    assert sum(p.numel() for p in port.parameters()) == 32_396_168
    sd = port.state_dict()
    rules = mvx_rules(cfg)
    back = from_jax_variables(to_flax(sd, rules), rules)
    fresh = port_build(cfg, device='cpu')
    fresh.load_state_dict(back, strict=True)
    for k, v in fresh.state_dict().items():
        if not k.endswith('num_batches_tracked'):
            assert torch.equal(v, sd[k]), k


def test_multi_scale_flip_aug_matches_jax():
    rng = np.random.RandomState(4)
    sample = dict(points=rng.randn(50, 4).astype(np.float32), token='a')
    for kw in (dict(), dict(pts_scale_ratio=[1.0, 1.05], flip=True,
                            pcd_horizontal_flip=True,
                            pcd_vertical_flip=True)):
        got = ttta.MultiScaleFlipAug3D([], **kw)(dict(sample))
        want = jtta.MultiScaleFlipAug3D([], **kw)(dict(sample))
        if not kw:
            assert 'aug_samples' not in got and got['token'] == 'a'
            got, want = [got], [want]
        else:
            got, want = got['aug_samples'], want['aug_samples']
        assert len(got) == len(want) == (8 if kw else 1)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g['points'], w['points'])
            assert g['aug_state'] == w['aug_state']
            assert sorted(g['aug_state']) == ['flip_h', 'flip_v', 'scale']
    np.testing.assert_array_equal(sample['points'], sample['points'])


def merge_inputs(rng, views=4):
    results, states = [], []
    for i in range(views):
        n = 30 + i
        boxes = np.concatenate([rng.uniform(-20, 20, (n, 3)),
                                rng.uniform(1, 4, (n, 3)),
                                rng.uniform(-3, 3, (n, 3))], -1)
        results.append(dict(bboxes=boxes.astype(np.float32),
                            scores=rng.rand(n).astype(np.float32),
                            labels=rng.randint(0, 10, n)))
        states.append(dict(scale=1.0 + 0.05 * (i % 2), flip_h=bool(i & 1),
                           flip_v=bool(i & 2)))
    return results, states


def test_merge_aug_bboxes_matches_jax():
    rng = np.random.RandomState(5)
    results, states = merge_inputs(rng)
    for max_num in (500, 20):
        got = ttta.merge_aug_bboxes_3d(results, states, max_num=max_num)
        want = jtta.merge_aug_bboxes_3d(results, states, max_num=max_num)
        assert 0 < len(got['scores']) <= max_num
        for key in ('bboxes', 'scores', 'labels'):
            np.testing.assert_array_equal(got[key], want[key])


class JittedSimpleTest:
    """The JAX detector's ``simple_test`` as one jitted function, in the
    shape ``aug_test_detector`` calls (``model.apply(..., method=...)``)."""

    simple_test = None

    def __init__(self, model):
        self.fn = jax.jit(lambda v, p, m: model.apply(
            v, p, m, method=type(model).simple_test))

    def apply(self, variables, points, mask, method=None):
        return self.fn(variables, points, mask)


def test_aug_test_detector_matches_jax(one_thread):
    from msmdfusion_torch.config import load_config as port_load_config
    rng = np.random.RandomState(0)
    points, mask = make_points(rng)
    jmodel = jax_build(tiny_model_cfg())
    variables = seeded_variables(jmodel.init, rng, jnp.asarray(points),
                                 jnp.asarray(mask))
    port = port_build(tiny_model_cfg(port_load_config), device='cpu')
    port.load_state_dict(from_jax_variables(variables))
    views = ttta.MultiScaleFlipAug3D(
        [], flip=True, pcd_horizontal_flip=True, pcd_vertical_flip=True)(
        dict(points=points[0]))['aug_samples']
    assert len(views) == 4
    jviews = [dict(points=jnp.asarray(v['points'][None]),
                   points_mask=jnp.asarray(mask), aug=v['aug_state'])
              for v in views]
    tviews = [dict(points=t(v['points'][None]), points_mask=t(mask),
                   aug=v['aug_state']) for v in views]
    want = jmvx.aug_test_detector(JittedSimpleTest(jmodel), variables,
                                  jviews)
    got = tmvx.aug_test_detector(port, tviews)
    assert len(got['scores']) > 10
    np.testing.assert_array_equal(got['labels'], want['labels'])
    np.testing.assert_allclose(got['scores'], want['scores'], atol=1e-5)
    np.testing.assert_allclose(got['bboxes'], want['bboxes'], atol=1e-4 *
                               np.abs(want['bboxes']).max())
