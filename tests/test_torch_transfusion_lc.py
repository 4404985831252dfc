"""TransFusion-LC, port vs the JAX package, on the CPU.

The LC stack of ``configs/transfusion_nusc_voxel_LC.py`` cut to tiny
widths (``test_torch_transfusion_l.py``'s TransFusion-L trunk, an 8 x 8
BEV, 10 proposals, a ResNet-18 and FPN image branch, two 32 x 64 views).
The JAX side never compiles its sparse encoder: both detectors take a
seeded BEV map in place of ``extract_pts_feat``'s, so the image branch
(views into the batch, ResNet, FPN, level 0 back to [B, V, ...]) and the
head's image fusion are the JAX detector's own (``detectors/
transfusion.py:96-108``). Seeded random JAX variables go into the port
through ``from_jax_variables`` with ``transfusion_lc_rules``. Two rigs:
``front``, two cameras behind the range facing it, so that some
proposals lie on both images (the later view wins), some on one and one
on none, all in front of both cameras; ``around``, two cameras at the
origin, so that proposals behind a camera go through the projection's
1e-5 depth clamp.

- ``corners_3d`` against the JAX package's; on ``around`` the image
  decoders' proposal positions, through the depth clamp, against the
  JAX head's own.
- Inference on each rig: every output key (``on_the_image`` included)
  and the decoded boxes to 1e-4 of the largest reference value (``TOL``).
- Training on each rig (``freeze_img``: the image branch in eval mode,
  its gradients still computed, as in the JAX detector): the targets and
  the losses with the ``on_the_image`` weighting (``test_torch_train_step``'s
  ``TOL``); on ``front`` every parameter gradient against ``jax.grad``
  (its ``GRAD_TOL``). On ``around`` a point behind a camera lands ~1e5
  pixels out and feeds the fusion decoder's position embedding and
  self-attention at that scale, where fp32 leaves the two packages'
  gradients up to ~1e-3 of max apart (the port's own, on 1 or 8 threads,
  lie up to ~2e-4 apart); their outputs and losses agree to ``TOL``
  there.
- Port only: the LC model called without images is TransFusion-L, output
  for output; ``make_train_step`` under ``freeze_img`` leaves the image
  branch's parameters and statistics bit-equal and counts its gradients
  in ``grad_norm``; the converter's LC table names every key of the
  full-width model.
"""
import contextlib
import copy

import numpy as np
import pytest
import flax.linen as nn
import jax
import jax.numpy as jnp
import torch

import msmdfusion_tpu.models  # noqa: F401
from msmdfusion_tpu.config import load_config
from msmdfusion_tpu.core.boxes import corners_3d as jax_corners_3d
from msmdfusion_tpu.models.builder import build_detector as jax_build
from msmdfusion_tpu.models.detectors.transfusion import \
    TransFusionDetector as JaxTransFusion

import msmdfusion_torch.models  # noqa: F401
from msmdfusion_torch.apis.train import (build_lr_schedule, build_optimizer,
                                         frozen_prefixes, global_norm,
                                         make_train_step)
from msmdfusion_torch.config import load_config as port_load_config
from msmdfusion_torch.core.boxes import corners_3d
from msmdfusion_torch.models.builder import build_detector as port_build
from msmdfusion_torch.utils.convert import (from_jax_variables,
                                            transfusion_lc_rules)
from tests.test_torch_bf16_train import one_thread  # noqa: F401
from tests.test_torch_train_step import GRAD_TOL, NOISE, TOL, as_port, \
    jax_loss_fn, make_gt
from tests.test_torch_transfusion_l import make_points, randomize, \
    tiny_model_cfg

CONFIG = 'configs/transfusion_nusc_voxel_LC.py'
V = 2
IMG_HW = (32, 64)           # the FPN's level 0: 8 x 16, padded 32 x 64
BEV_HW = (8, 8)
HEAD_IN = 16
FROZEN = ('img_backbone', 'img_neck')


def lc_model_cfg(load, config=CONFIG, num_views=V):
    cfg = tiny_model_cfg(load, config)
    cfg.img_backbone.update(depth=18)
    cfg.img_neck.update(in_channels=[64, 128, 256, 512], out_channels=16)
    cfg.pts_bbox_head.update(num_views=num_views, in_channels_img=16,
                             dropout=0.0)
    cfg.train_cfg.pts.update(grid_size=[64, 64, 40],
                             point_cloud_range=cfg.pts_voxel_layer
                             .point_cloud_range)
    return cfg


def rig(yaws=(30.0, 120.0)):
    """[1, V, 4, 4] lidar2img of cameras at the origin (``around``) with a
    152-degree horizontal field over the padded 64-pixel width (focal
    length 8) and a vertical one wide enough for every proposal's
    height."""
    h, w = IMG_HW
    intr = np.array([[w / 8, 0, w / 2, 0], [0, 1, h / 2, 0], [0, 0, 1, 0],
                     [0, 0, 0, 1]])
    mats = []
    for yaw in np.deg2rad(yaws):
        c, s = np.cos(yaw), np.sin(yaw)
        ext = np.eye(4)
        ext[:3, :3] = [[s, -c, 0], [0, 0, -1], [c, s, 0]]
        mats.append(intr @ ext)
    return np.stack(mats)[None].astype(np.float32)


def front_rig(ys=(-1.5, 0.5)):
    """[1, V, 4, 4] lidar2img of cameras 8 m behind the range's centre
    (x = -8, at the given ys) facing +x with focal length 146: every
    proposal lies in front of both, and their fields overlap."""
    h, w = IMG_HW
    intr = np.array([[146.0, 0, w / 2, 0], [0, 1, h / 2, 0], [0, 0, 1, 0],
                     [0, 0, 0, 1]])
    mats = []
    for y in ys:
        ext = np.eye(4)
        ext[:3, :3] = [[0, -1, 0], [0, 0, -1], [1, 0, 0]]
        ext[:3, 3] = -ext[:3, :3] @ np.array([-8.0, y, 0.0])
        mats.append(intr @ ext)
    return np.stack(mats)[None].astype(np.float32)


RIGS = {'front': front_rig(), 'around': rig()}


@contextlib.contextmanager
def bev_in_place_of_lidar(detector):
    """Inside the scope ``detector`` (the JAX class or a port instance)
    takes its points input as the BEV map ``extract_pts_feat`` would
    give."""
    if isinstance(detector, type):
        def stub(self, points, points_mask, train=False):
            return [points], None
    else:
        def stub(points, points_mask):
            return [points], None
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(detector, 'extract_pts_feat', stub)
        yield


def head_rules(tree, num_views=V, velocity=True):
    """``transfusion_lc_rules`` without the LiDAR trunk's flax modules
    that ``tree`` lacks."""
    return [r for r in transfusion_lc_rules(num_views, 18, velocity=velocity)
            if r[1].split('/')[0] in tree['params']]


def assert_close(got, want, msg=''):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=TOL,
                               atol=TOL * np.abs(want).max(), err_msg=msg)


def test_corners_3d_matches_jax():
    rng = np.random.RandomState(3)
    boxes = np.concatenate([rng.uniform(-50, 50, (64, 3)),
                            rng.uniform(0.3, 6, (64, 3)),
                            rng.uniform(-4, 4, (64, 1)),
                            rng.normal(0, 1, (64, 2))], 1).astype(np.float32)
    got = corners_3d(torch.from_numpy(boxes))
    np.testing.assert_allclose(got.numpy(), jax_corners_3d(boxes),
                               rtol=1e-6, atol=1e-5)
    # the reference order: bottom face then top, x/y at +-d/2 before the yaw
    unit = corners_3d(torch.tensor([[1.0, 2.0, 3.0, 2.0, 4.0, 6.0, 0.0]]))
    np.testing.assert_array_equal(unit[0, :4].numpy(), [
        [0, 0, 3], [0, 0, 9], [0, 4, 9], [0, 4, 3]])
    np.testing.assert_array_equal(unit[0, 4:, 2].numpy(), [3, 9, 9, 3])


def test_projection_clamps_depth_in_jax_order(lc):
    """The image-fusion decoders' proposal positions on the ``around`` rig,
    half of the proposals behind a camera: per view and proposal, the
    port head's (its image decoder's third argument, ``fusion_pos``)
    against the JAX head's own (``centers_feat``, the third argument of
    its ``img_fusion_decoder``, ``models/heads/transfusion_head.py:
    414-421,427``, recorded by ``nn.intercept_methods``), within ``TOL``
    of each value's magnitude (measured: 9e-6 behind the cameras, 2e-5 in
    front, from the heads' predicted heights). Behind a camera the depth
    is clamped at 1e-5 and the position lands ~1e5 pixels out: a clamp
    elsewhere moves those by orders of magnitude. The order of the
    division and the scale changes only roundings, which this comparison
    does not separate from the heads' own deviation."""
    run = lc['around']
    got = torch.stack(run['fusion_pos'], 1)[0].numpy()        # [V, P, 2]
    want = np.asarray(run['jfusion_pos'])[:, 0]               # [V, P, 2]
    assert got.shape == want.shape == (V, 10, 2)
    far = np.abs(want).max(-1) > 1e4
    assert 0.2 < far.mean() < 0.8
    np.testing.assert_allclose(got, want, rtol=TOL, atol=0)


@pytest.fixture(scope='module')
def lc():
    """Per rig, the JAX detector's inference, decode, targets, losses and
    gradients (one compile for both rigs) and the port's on the same
    weights and inputs."""
    rng = np.random.RandomState(0)
    bev = rng.randn(1, *BEV_HW, HEAD_IN).astype(np.float32)
    img = rng.randn(1, V, *IMG_HW, 3).astype(np.float32)
    gt = make_gt(rng)
    jmodel = jax_build(lc_model_cfg(load_config))
    jgt = {k: jnp.asarray(v) for k, v in gt.items()}

    def jax_inputs(lidar2img):
        return (jnp.asarray(bev), jnp.ones((1, 1), bool), jnp.asarray(img),
                dict(lidar2img=lidar2img))
    with bev_in_place_of_lidar(JaxTransFusion):
        shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                                *jax_inputs(jnp.asarray(RIGS['front'])))
        variables = randomize(jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, s.dtype), dict(shapes)), rng)

        @jax.jit
        def jax_side(params, batch_stats, lidar2img):
            v = {'params': params, 'batch_stats': batch_stats}
            inputs = jax_inputs(lidar2img)
            fusion_pos = []

            def record(call, args, kwargs, context):
                # the image-fusion decoder's proposal positions, per view
                if (context.module.name == 'img_fusion_decoder'
                        and context.method_name == '__call__'):
                    fusion_pos.append(args[2])
                return call(*args, **kwargs)
            with nn.intercept_methods(record):
                preds = jmodel.apply(v, *inputs)
            boxes = jmodel.apply(v, preds, method=JaxTransFusion.get_bboxes)
            (total, (losses, _, tpreds)), grads = jax.value_and_grad(
                jax_loss_fn(jmodel, batch_stats, inputs, jgt),
                has_aux=True)(params)
            targets = jmodel.apply(
                v, tpreds, jgt['gt_bboxes'], jgt['gt_labels'],
                jgt['gt_valid'],
                method=lambda m, *a: m.bbox_head.get_targets(*a))
            return (preds, boxes, total, losses, grads, targets, tpreds,
                    jnp.stack(fusion_pos))
        jax_out = {name: jax_side(variables['params'],
                                  variables['batch_stats'], jnp.asarray(l2i))
                   for name, l2i in RIGS.items()}
    rules = head_rules(variables)
    loaded = port_build(lc_model_cfg(port_load_config), device='cpu')
    missing, unexpected = loaded.load_state_dict(
        from_jax_variables(variables, rules), strict=False)
    assert not unexpected and missing
    assert all(k.startswith(('pts_middle_encoder.', 'pts_backbone.',
                             'pts_neck.')) for k in missing), missing[:4]
    tgt = {k: torch.from_numpy(v) for k, v in gt.items()}
    out = dict(variables=variables, rules=rules)
    for name, l2i in RIGS.items():
        port = copy.deepcopy(loaded)
        t_inputs = (torch.from_numpy(bev).permute(0, 3, 1, 2).contiguous(),
                    torch.ones((1, 1), dtype=torch.bool),
                    torch.from_numpy(img),
                    dict(lidar2img=torch.from_numpy(l2i)))
        fusion_pos = []
        hook = port.pts_bbox_head.decoder[1].register_forward_hook(
            lambda m, args, out: fusion_pos.append(args[2].detach()))
        with bev_in_place_of_lidar(port):
            with torch.no_grad():
                preds = port(*t_inputs)
                boxes = port.get_bboxes(preds)
            hook.remove()
            port.train()
            tpreds = port(*t_inputs)
        targets = port.pts_bbox_head.get_targets(
            tpreds, tgt['gt_bboxes'], tgt['gt_labels'], tgt['gt_valid'])
        losses = port.loss(tpreds, tgt['gt_bboxes'], tgt['gt_labels'],
                           tgt['gt_valid'], targets=targets)
        sum(v for k, v in losses.items() if 'loss' in k).backward()
        keys = ('preds', 'boxes', 'jtotal', 'jlosses', 'jgrads', 'jtargets',
                'jtpreds', 'jfusion_pos')
        out[name] = dict(zip(keys, jax_out[name]), port=port,
                         port_preds=preds, port_boxes=boxes,
                         fusion_pos=fusion_pos, tpreds=tpreds,
                         targets=targets, losses=losses)
    return out


@pytest.mark.parametrize('name', sorted(RIGS))
def test_lc_forward_matches_jax(lc, name):
    run = lc[name]
    preds, want = run['port_preds'], run['preds']
    assert set(preds) == set(want) | {'query_spatial'}
    np.testing.assert_array_equal(preds['query_labels'].numpy(),
                                  np.asarray(want['query_labels']))
    np.testing.assert_array_equal(preds['on_the_image'].numpy(),
                                  np.asarray(want['on_the_image']))
    for key in ('dense_heatmap', 'query_heatmap_score', 'heatmap', 'center',
                'height', 'dim', 'rot', 'vel'):
        assert preds[key].shape == tuple(want[key].shape), key
        assert_close(preds[key].numpy(), want[key], key)
    # the rig's proposals: on one image, on both (the later view's
    # refinement wins) and on none (the LiDAR layer's predictions)
    size = torch.tensor([IMG_HW[1] / 4, IMG_HW[0] / 4])    # level 0 (w, h)
    on = torch.stack([((p > 0) & (p < size)).all(-1)
                      for p in run['fusion_pos']], 1)[0]       # [V, P]
    on_img = np.asarray(want['on_the_image'])[0]
    np.testing.assert_array_equal(on.any(0).numpy(), on_img)
    assert on.all(0).any() and (on.sum(0) == 1).any() and not on_img.all()


@pytest.mark.parametrize('name', sorted(RIGS))
def test_lc_decode_matches_jax(lc, name):
    boxes, want = lc[name]['port_boxes'], lc[name]['boxes']
    for key in ('bboxes', 'scores'):
        assert_close(boxes[key].numpy(), want[key], key)
    for key in ('labels', 'valid'):
        np.testing.assert_array_equal(boxes[key].numpy(),
                                      np.asarray(want[key]), key)
    assert boxes['bboxes'].shape == (1, 10, 9)


@pytest.mark.parametrize('name', sorted(RIGS))
def test_lc_targets_and_losses_match_jax(lc, name):
    run = lc[name]
    np.testing.assert_array_equal(run['tpreds']['on_the_image'].numpy(),
                                  np.asarray(run['jtpreds']['on_the_image']))
    labels, _, bbox_targets, bbox_weights, num_pos, ious, heatmap = \
        run['targets']
    jlabels, _, jtargets, jweights, jnum, jious, jheatmap = run['jtargets']
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
    np.testing.assert_array_equal(bbox_weights.numpy(), np.asarray(jweights))
    assert int(num_pos) == int(jnum) > 0
    np.testing.assert_allclose(bbox_targets.numpy(), np.asarray(jtargets),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(heatmap.numpy(), np.asarray(jheatmap),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(ious), float(jious), rtol=1e-5,
                               atol=1e-6)
    # some positive proposal lies on no image: the on_the_image weighting
    # leaves it out of the losses
    on = run['tpreds']['on_the_image'][0]
    assert name != 'around' or bool((bbox_weights[0, :, 0] > 0)[~on].any())
    assert set(run['losses']) == set(run['jlosses'])
    for key, want in run['jlosses'].items():
        np.testing.assert_allclose(float(run['losses'][key].detach()),
                                   float(want), rtol=TOL, atol=1e-6,
                                   err_msg=key)


def test_lc_gradients_match_jax_grad(lc):
    run = lc['front']
    want = as_port(run['jgrads'], lc['variables'], lc['rules'])
    named = {n: p for n, p in run['port'].named_parameters() if n in want}
    # no gradient where the forward never uses a parameter: a cross-only
    # layer's norm1 (the converter writes LayerNorm's initial values for
    # it) and the FPN levels above 0 (a zero JAX gradient)
    unused = {n for n in named if named[n].grad is None}
    assert any('.norm1.' in n for n in unused)
    for n in unused:
        assert '.norm1.' in n or not np.abs(want[n]).any(), n
    scale = max(float(np.abs(want[n]).max()) for n in named)
    errs = []
    for name, p in named.items():
        if name in unused:
            continue
        ref = want[name]
        limit = GRAD_TOL * max(float(np.abs(ref).max()), NOISE * scale)
        errs.append((float(np.abs(p.grad.numpy() - ref).max()) / limit,
                     name))
    errs.sort(reverse=True)
    assert errs[0][0] <= 1.0, f'error over limit, worst: {errs[:5]}'
    # the frozen image branch has gradients, as the JAX detector's
    img = [n for n in named if n.startswith(FROZEN) and n not in unused]
    assert len(img) > 20 and all(
        float(named[n].grad.abs().max()) > 0 for n in img)


@pytest.fixture(scope='module')
def pair():
    """The tiny TransFusion-LC (image branch on seeded weights) and a
    TransFusion-L with the same LiDAR weights, on the port alone."""
    rng = np.random.RandomState(4)
    points, mask = make_points(rng)
    lc_model = port_build(lc_model_cfg(port_load_config), device='cpu',
                          seed=1)
    tl = port_build(tiny_model_cfg(port_load_config), device='cpu')
    missing, unexpected = tl.load_state_dict(lc_model.state_dict(),
                                             strict=False)
    assert not missing and unexpected
    img = rng.randn(1, V, *IMG_HW, 3).astype(np.float32)
    inputs = (torch.from_numpy(points), torch.from_numpy(mask),
              torch.from_numpy(img), dict(lidar2img=torch.from_numpy(rig())))
    return lc_model, tl, inputs


def test_lc_without_images_is_transfusion_l(pair):
    lc_model, tl, inputs = pair
    with torch.no_grad():
        got = lc_model(*inputs[:2])
        want = tl(*inputs[:2])
        fused = lc_model(*inputs)
    assert set(got) == set(want) and 'on_the_image' in fused
    for key in want:
        assert torch.equal(got[key], want[key]), key
    for key in ('bboxes', 'scores', 'labels'):
        assert torch.equal(lc_model.get_bboxes(got)[key],
                           tl.get_bboxes(want)[key]), key
    assert not torch.equal(fused['dense_heatmap'], want['dense_heatmap'])


def test_lc_train_step_keeps_the_frozen_image_branch(pair):
    lc_model, _, inputs = pair
    cfg = port_load_config(CONFIG)
    frozen = frozen_prefixes(cfg)
    assert frozen == FROZEN
    before = {k: v.clone() for k, v in lc_model.state_dict().items()
              if k.startswith(FROZEN)}
    modes = []
    hooks = [m.register_forward_pre_hook(
        lambda m, a: modes.append(m.training))
        for n, m in lc_model.named_modules() if n.startswith(FROZEN)
        and isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    opt = build_optimizer(lc_model, dict(cfg.optimizer),
                          dict(cfg.optimizer_config), build_lr_schedule(
                              dict(cfg.lr_config), cfg.optimizer['lr'], 20,
                              1), frozen_prefixes=frozen)
    step = make_train_step(lc_model, opt)
    gt = {k: torch.from_numpy(v)
          for k, v in make_gt(np.random.RandomState(5)).items()}
    metrics = step(dict(inputs=inputs, **gt), 0)
    for h in hooks:
        h.remove()
    assert modes and not any(modes)
    assert all(torch.isfinite(v).all() for v in metrics.values())
    after = lc_model.state_dict()
    for k, v in before.items():
        assert torch.equal(after[k], v), k
    grads = {n: p.grad for n, p in lc_model.named_parameters()}
    img = [g for n, g in grads.items() if n.startswith(FROZEN)]
    assert sum(g is not None for g in img) > 20
    assert float(global_norm(img)) > 0
    torch.testing.assert_close(metrics['grad_norm'],
                               global_norm(grads.values()))
    assert float(metrics['grad_norm']) > float(opt.grad_norm())


def rule_keys(rules):
    """The port state-dict keys a converter table writes."""
    keys = set()
    for t, _, kind, _ in rules:
        if kind == 'mha':
            keys |= {f'{t}.in_proj_weight', f'{t}.in_proj_bias',
                     f'{t}.out_proj.weight', f'{t}.out_proj.bias'}
        elif kind == 'bn':
            keys |= {f'{t}.{s}' for s in ('weight', 'bias', 'running_mean',
                                          'running_var',
                                          'num_batches_tracked')}
        elif kind == 'param':
            keys.add(t)
        else:
            keys |= {f'{t}.weight', f'{t}.bias'}
    return keys


def test_lc_rules_name_every_key_of_the_full_width_model():
    model = port_build(port_load_config(CONFIG).model, device='cpu')
    head = model.pts_bbox_head
    assert len(head.decoder) == 1 + 1 + 6 and len(head.prediction_heads) == 2
    assert not hasattr(head.decoder[2], 'self_attn')
    want = set(model.state_dict())
    got = rule_keys(transfusion_lc_rules(6))
    # conv2d rules write a bias where the flax conv has one: the ResNet's
    # convs have none
    assert got >= want and all(k.endswith('.bias') for k in got - want)
