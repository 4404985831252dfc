"""The single-stage zoo's detectors end to end, port vs the JAX package, on
the CPU, and the converter's zoo rules.

The tiny CenterPoint and ``conv_module`` VoxelNet of
``tests/test_centerpoint_and_anchor.py`` (SECOND's ``in_channels`` set to
the BEV map's 16: flax infers it), a tiny DynamicVoxelNet (the VoxelNet's
stack) and a tiny PointPillars (``PillarFeatureNet``,
``PointPillarsScatter``, a three-level SECONDFPN, ``Anchor3DHead`` with
custom values). The JAX variables come from ``jax.eval_shape`` and seeded
arrays, and go into the port through ``zoo_rules``; each JAX model is one
jitted function in a module fixture.

- CenterPoint and the VoxelNet: the training-mode forward, the decode of
  its outputs and the losses within ``TOL`` of each output's largest
  value; CenterPoint's every gradient of that step against
  ``jax.grad`` within ``GRAD_TOL`` of its tensor's largest value (plus
  ``NOISE`` of the model's largest gradient: a bias ahead of a train-mode
  norm has a zero gradient in exact arithmetic), as the flagship's step
  test holds them. DynamicVoxelNet and PointPillars: the eval-mode
  forward within ``TOL`` (their encoders, heads and decode are held here
  and in ``test_torch_zoo_{voxelize,heads}.py``). One JAX compile a model.
- ``zoo_rules`` on the five configs at their own widths: a flax tree made
  from the port's ``state_dict`` by the inverse of each rule converts back
  to the same tensors, loads with ``strict=True`` and uses every leaf.
- ``unpack_detections`` on the anchor heads' ``boxes`` dict.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import msmdfusion_tpu.models  # noqa: F401
from msmdfusion_tpu.models.builder import build_detector as jax_build

import msmdfusion_torch.models  # noqa: F401
from msmdfusion_torch.apis.inference import unpack_detections
from msmdfusion_torch.config import load_config
from msmdfusion_torch.models.builder import build_detector as port_build
from msmdfusion_torch.utils.convert import from_jax_variables, zoo_rules
from tests.test_torch_bf16_train import one_thread  # noqa: F401
from tests.test_torch_train_step import GRAD_TOL, NOISE
from tests.test_torch_transfusion_l import randomize

TOL = 1e-4
PCR = [0, -3.2, -3.0, 6.4, 3.2, 1.0]
VOX = [0.2, 0.2, 0.2]
PILLAR = [0.2, 0.2, 4.0]

CENTERPOINT = dict(
    type='CenterPoint',
    pts_voxel_layer=dict(max_num_points=4, voxel_size=VOX,
                         max_voxels=(200, 256), point_cloud_range=PCR),
    pts_voxel_encoder=dict(type='HardSimpleVFE', num_features=5),
    pts_middle_encoder=dict(
        type='SparseEncoder', in_channels=5, sparse_shape=(21, 32, 32),
        base_channels=4, output_channels=8,
        encoder_channels=((4, 4, 8), (8, 8, 8), (8, 8)),
        encoder_paddings=((0, 0, 1), (0, 0, 1), (0, 0)),
        block_type='basicblock'),
    pts_backbone=dict(type='SECOND', in_channels=16, out_channels=[16, 32],
                      layer_nums=[1, 1], layer_strides=[1, 2]),
    pts_neck=dict(type='SECONDFPN', in_channels=[16, 32],
                  out_channels=[16, 16], upsample_strides=[1, 2],
                  use_conv_for_no_stride=True),
    pts_bbox_head=dict(
        type='CenterHead', in_channels=32, share_conv_channel=16,
        tasks=[dict(num_class=1, class_names=['car']),
               dict(num_class=2, class_names=['pedestrian',
                                              'traffic_cone'])],
        common_heads=dict(reg=(2, 2), height=(1, 2), dim=(3, 2), rot=(2, 2),
                          vel=(2, 2)),
        bbox_coder=dict(
            type='CenterPointBBoxCoder', pc_range=PCR[:2],
            voxel_size=VOX[:2], out_size_factor=4,
            post_center_range=[-10, -10, -10, 10, 10, 10], max_num=16,
            score_threshold=0.0, code_size=9)),
    train_cfg=dict(pts=dict(
        grid_size=[32, 32, 20], voxel_size=VOX, out_size_factor=4,
        gaussian_overlap=0.1, min_radius=2, point_cloud_range=PCR,
        code_weights=[1.0] * 8 + [0.2, 0.2])),
    test_cfg=dict(pts=dict(
        post_center_limit_range=[-10, -10, -10, 10, 10, 10],
        min_radius=[4, 0.5], score_threshold=0.0, out_size_factor=4,
        voxel_size=VOX[:2], pc_range=PCR[:2], nms_type='circle',
        post_max_size=8)))

ANCHOR_HEAD = dict(
    type='Anchor3DHead', num_classes=3, in_channels=32, feat_channels=32,
    anchor_generator=dict(
        type='Anchor3DRangeGenerator',
        ranges=[[0, -3.2, -0.6, 6.4, 3.2, -0.6]] * 3,
        sizes=[[0.6, 0.8, 1.7], [0.6, 1.76, 1.73], [1.6, 3.9, 1.56]],
        rotations=[0, 1.57]),
    bbox_coder=dict(type='DeltaXYZWLHRBBoxCoder', code_size=7),
    loss_cls=dict(gamma=2.0, alpha=0.25, loss_weight=1.0),
    loss_bbox=dict(beta=0.111, loss_weight=2.0),
    loss_dir=dict(loss_weight=0.2))
VOXELNET = dict(
    CENTERPOINT, type='VoxelNet',
    pts_middle_encoder=dict(
        type='SparseEncoder', in_channels=5, sparse_shape=(21, 32, 32),
        base_channels=4, output_channels=8,
        encoder_channels=((4,), (8, 8, 8), (8, 8, 8)),
        encoder_paddings=((1,), (1, 1, 1), (1, 1, 1)),
        block_type='conv_module'),
    pts_bbox_head=ANCHOR_HEAD,
    train_cfg=dict(pts=dict(pos_iou_thr=0.5, neg_iou_thr=0.35,
                            min_pos_iou=0.3)),
    test_cfg=dict(pts=dict(nms_pre=64, nms_thr=0.5, score_thr=0.05,
                           max_num=16)))
DYNAMIC = dict(VOXELNET, type='DynamicVoxelNet', pts_voxel_layer=dict(
    max_num_points=-1, voxel_size=VOX, max_voxels=(256, 256),
    point_cloud_range=PCR))
POINTPILLARS = dict(
    VOXELNET,
    pts_voxel_layer=dict(max_num_points=8, voxel_size=PILLAR,
                         max_voxels=(100, 100), point_cloud_range=PCR),
    pts_voxel_encoder=dict(type='PillarFeatureNet', in_channels=5,
                           feat_channels=[8], voxel_size=PILLAR,
                           point_cloud_range=PCR),
    pts_middle_encoder=dict(type='PointPillarsScatter', in_channels=8,
                            output_shape=[32, 32]),
    pts_backbone=dict(type='SECOND', in_channels=8, out_channels=[8, 8, 16],
                      layer_nums=[1, 1, 1], layer_strides=[2, 2, 2]),
    pts_neck=dict(type='SECONDFPN', in_channels=[8, 8, 16],
                  out_channels=[8, 8, 8], upsample_strides=[1, 2, 4]),
    pts_bbox_head=dict(
        ANCHOR_HEAD, in_channels=24, feat_channels=24,
        anchor_generator=dict(ANCHOR_HEAD['anchor_generator'],
                              type='AlignedAnchor3DRangeGenerator',
                              custom_values=[0, 0]),
        bbox_coder=dict(type='DeltaXYZWLHRBBoxCoder', code_size=9)))
MODELS = {'CenterPoint': CENTERPOINT, 'VoxelNet': VOXELNET,
          'DynamicVoxelNet': DYNAMIC, 'PointPillars': POINTPILLARS}


def make_points(rng, n=256):
    pts = np.concatenate([
        rng.uniform(0, 6.4, (1, n, 1)), rng.uniform(-3.2, 3.2, (1, n, 1)),
        rng.uniform(-3, 1, (1, n, 1)), rng.uniform(0, 1, (1, n, 2))], -1)
    return pts.astype(np.float32), np.ones((1, n), bool)


def make_gt(rng, width):
    gt = np.zeros((1, 4, width), np.float32)
    gt[0, :, 0] = [1.0, 3.0, 5.0, 4.0]
    gt[0, :, 1] = rng.uniform(-2.5, 2.5, 4)
    gt[0, :, 2] = -1.5
    gt[0, :, 3:6] = [1.6, 3.9, 1.56]
    gt[0, :, 6] = rng.uniform(-3, 3, 4)
    if width > 7:
        gt[0, :, 7:] = rng.randn(4, width - 7) * 0.5
    return (gt, np.array([[0, 1, 2, 2]], np.int32),
            np.array([[True, True, True, False]]))


def jax_side(jmodel, variables, inputs, gt, train, grads):
    """One compile: the forward (train mode: with the losses, and the
    gradients where ``grads``) and the decode of its outputs where
    ``train``; the eval-mode forward alone otherwise."""
    def loss_fn(params):
        v = {'params': params, 'batch_stats': variables['batch_stats']}
        preds, _ = jmodel.apply(v, *inputs, train=True,
                                mutable=['batch_stats'])
        losses = jmodel.apply(v, preds, *gt, method=type(jmodel).loss)
        return sum(losses.values()), (losses, preds)

    @jax.jit
    def run(variables):
        if not train:
            return jmodel.apply(variables, *inputs), None, None, None
        if grads:
            (_, (losses, preds)), g = jax.value_and_grad(
                loss_fn, has_aux=True)(variables['params'])
        else:
            (losses, preds), g = loss_fn(variables['params'])[1], None
        boxes = jmodel.apply(variables, preds,
                             method=type(jmodel).get_bboxes)
        return preds, boxes, losses, g
    return run(variables)


# train: the forward in training mode with its decode and losses (and for
# CenterPoint the gradients); the other two: the eval-mode forward
TRAIN = ('CenterPoint', 'VoxelNet')


@pytest.fixture(scope='module', params=sorted(MODELS))
def pair(request):
    name = request.param
    cfg = MODELS[name]
    rng = np.random.RandomState(sorted(MODELS).index(name))
    points, mask = make_points(rng)
    width = 9 if cfg['pts_bbox_head']['type'] == 'CenterHead' or \
        cfg['pts_bbox_head']['bbox_coder']['code_size'] == 9 else 7
    gt = make_gt(rng, width)
    jmodel = jax_build(cfg)
    inputs = (jnp.asarray(points), jnp.asarray(mask))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), *inputs)
    variables = randomize(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), dict(shapes)), rng)
    want = jax_side(jmodel, variables, inputs,
                    tuple(jnp.asarray(x) for x in gt), name in TRAIN,
                    name == 'CenterPoint')
    port = port_build(cfg, device='cpu')
    port.load_state_dict(from_jax_variables(variables, zoo_rules(cfg)))
    return dict(name=name, port=port, variables=variables, want=want,
                inputs=(torch.from_numpy(points), torch.from_numpy(mask)),
                gt=tuple(torch.from_numpy(x) for x in gt))


def close(got, want, tol=TOL, noise=0.0):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale + noise, (err, scale)


def channels_last(preds):
    if isinstance(preds, list):
        return [channels_last(p) for p in preds]
    return {k: v.permute(0, 2, 3, 1) for k, v in preds.items()}


def test_forward_decode_and_losses_match_jax(pair, one_thread):
    port, (jpreds, jboxes, jlosses, jgrads) = pair['port'], pair['want']
    train = pair['name'] in TRAIN
    port.train(train)
    port.zero_grad(set_to_none=True)
    with torch.set_grad_enabled(train):
        preds = port(*pair['inputs'])
    got = channels_last(preds)
    for g, w in zip(got if isinstance(got, list) else [got],
                    jpreds if isinstance(jpreds, list) else [jpreds]):
        for key in w:
            close(g[key], w[key])
    if not train:
        return
    with torch.no_grad():
        boxes = port.get_bboxes(preds)
    for key in ('labels', 'valid'):
        np.testing.assert_array_equal(boxes[key].numpy(),
                                      np.asarray(jboxes[key]))
    key = 'bboxes' if 'bboxes' in boxes else 'boxes'
    close(boxes[key], jboxes[key])
    close(boxes['scores'], jboxes['scores'])
    assert int(boxes['valid'].sum()) > 0

    losses = port.loss(preds, *pair['gt'])
    assert sorted(losses) == sorted(jlosses)
    for key in jlosses:
        close(losses[key], jlosses[key])
    if jgrads is None:
        return
    sum(losses.values()).backward()
    want = from_jax_variables({'params': jax.tree_util.tree_map(
        np.asarray, jgrads), 'batch_stats': pair['variables']['batch_stats']},
        zoo_rules(MODELS[pair['name']]))
    params = dict(port.named_parameters())
    top = max(float(np.abs(v.numpy()).max()) for k, v in want.items()
              if k in params)
    for k, p in params.items():
        close(p.grad, want[k].numpy(), GRAD_TOL, GRAD_TOL * NOISE * top)


CONFIGS = ('centerpoint_nusc_voxel', 'pointpillars_nusc', 'free_anchor_nusc',
           'second_kitti', 'dynamic_voxelnet_kitti')


def to_flax(sd, rules):
    """The inverse of each rule: a port ``state_dict`` as a flax tree."""
    params, stats = {}, {}

    def put(tree, path, value):
        *parents, leaf = path.split('/')
        for p in parents:
            tree = tree.setdefault(p, {})
        tree[leaf] = np.asarray(value)

    for t, f, kind, ks in rules:
        if kind == 'spconv':
            w = sd[t + '.weight'].numpy()               # [O, kz, ky, kx, I]
            put(params, f + '/kernel', w.transpose(1, 2, 3, 4, 0).reshape(
                -1, w.shape[-1], w.shape[0]))
        elif kind == 'conv2d':
            put(params, f + '/kernel',
                sd[t + '.weight'].numpy().transpose(2, 3, 1, 0))
            if t + '.bias' in sd:
                put(params, f + '/bias', sd[t + '.bias'].numpy())
        elif kind == 'conv3d':
            put(params, f + '/kernel',
                sd[t + '.weight'].numpy().transpose(2, 3, 4, 1, 0))
        elif kind == 'deconv2d':
            put(params, f + '/kernel', sd[t + '.weight'].numpy().transpose(
                2, 3, 0, 1)[::-1, ::-1])
        elif kind == 'linear':
            put(params, f + '/kernel', sd[t + '.weight'].numpy().T)
            if t + '.bias' in sd:
                put(params, f + '/bias', sd[t + '.bias'].numpy())
        elif kind == 'bn':
            put(params, f + '/scale', sd[t + '.weight'].numpy())
            put(params, f + '/bias', sd[t + '.bias'].numpy())
            put(stats, f + '/mean', sd[t + '.running_mean'].numpy())
            put(stats, f + '/var', sd[t + '.running_var'].numpy())
        else:
            raise ValueError(kind)
    return {'params': params, 'batch_stats': stats}


@pytest.mark.parametrize('config', CONFIGS)
def test_zoo_rules_round_trip(config):
    cfg = load_config(f'configs/{config}.py').model
    port = port_build(cfg, device='cpu', seed=0)
    sd = port.state_dict()
    rules = zoo_rules(cfg)
    back = from_jax_variables(to_flax(sd, rules), rules)
    fresh = port_build(cfg, device='cpu')
    fresh.load_state_dict(back, strict=True)
    for k, v in fresh.state_dict().items():
        if not k.endswith('num_batches_tracked'):
            assert torch.equal(v, sd[k]), k
    assert len(back) == len(sd)


def test_unpack_detections_takes_either_box_key():
    rng = np.random.RandomState(5)
    res = {'scores': torch.rand(2, 6), 'labels': torch.randint(0, 3, (2, 6)),
           'valid': torch.from_numpy(rng.rand(2, 6) > 0.4)}
    boxes = torch.randn(2, 6, 7)
    anchor = unpack_detections(dict(res, boxes=boxes))
    center = unpack_detections(dict(res, bboxes=boxes))
    for a, c, i in zip(anchor, center, range(2)):
        keep = res['valid'][i].numpy()
        for key in ('bboxes', 'scores', 'labels'):
            np.testing.assert_array_equal(a[key], c[key])
        np.testing.assert_array_equal(a['bboxes'], boxes[i].numpy()[keep])
