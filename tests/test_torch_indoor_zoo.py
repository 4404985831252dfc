"""The point-based zoo, port vs the JAX package, on the CPU.

Tiny VoteNet, SSD3DNet, H3DNet and ImVoteNet (512 points, SA levels of
64/32/16/8 points, widths 16-32, B = 2), the JAX variables from
``jax.eval_shape`` and seeded arrays, carried into the port by
``zoo_rules`` (``indoor_rules``). Each JAX model is one jitted function
in a module fixture: the eval-mode forward, the training-mode forward
with its running statistics, its decode, its losses and every gradient.
Each scene has duplicated points (equal distances: the ties of FPS, the
ball query and three-NN) and invalid points.

- the eval forward, the training forward, the decode and the losses
  within ``TOL`` of each output's largest value; indices and masks
  equal;
- every gradient against ``jax.grad`` within ``GRAD_TOL`` of its
  tensor's largest value plus ``NOISE`` of the model's largest gradient
  (as ``tests/test_torch_zoo_detectors.py`` holds them);
- the running statistics after one training call on B = 2: the norms
  take each sample's moments in turn, as the JAX per-sample loop does;
- ImVoteNet by both image paths (the 2-D detections' cues; a ResNet-18
  and FPN on one view), from the union of both paths' JAX variables, and
  its refusal without images;
- the rules on the five configs at their own widths (the round trip of
  ``tests/test_torch_zoo_detectors.py``, with the shared MLPs'
  ``pointwise`` kind) and the CLIs' refusal of ImVoteNet.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import msmdfusion_tpu.models  # noqa: F401
from msmdfusion_tpu.models.builder import build_detector as jax_build

import msmdfusion_torch.models  # noqa: F401
from msmdfusion_torch.apis.inference import make_batch_infer
from msmdfusion_torch.config import load_config
from msmdfusion_torch.models.builder import build_detector as port_build
from msmdfusion_torch.utils.convert import from_jax_variables, zoo_rules
from tests.test_torch_train_step import GRAD_TOL, NOISE
from tests.test_torch_transfusion_l import randomize
from tests.test_torch_zoo_detectors import close, to_flax
from tests.torch_threads import one_thread  # noqa: F401

TOL = 1e-4
B, N = 2, 512

SSG = dict(type='PointNet2SASSG', in_channels=4, num_points=(64, 32, 16, 8),
           radius=(0.5, 0.8, 1.2, 1.8), num_samples=(8, 8, 8, 4),
           sa_channels=((16, 16), (16, 32), (16, 32), (16, 32)),
           fp_channels=((32, 32), (32, 32)))
VOTE_HEAD = dict(type='VoteHead', num_classes=4, in_channels=32,
                 num_proposals=16, num_dir_bins=6,
                 mean_sizes=[[0.6, 0.6, 0.6], [1.0, 0.8, 0.6],
                             [0.5, 1.2, 0.8], [1.4, 1.0, 0.5]],
                 aggregation_radius=0.8, aggregation_samples=8)
TRAIN = dict(pos_distance_thr=1.0, neg_distance_thr=1.6)
VOTENET = dict(type='VoteNet', backbone=SSG, bbox_head=VOTE_HEAD,
               train_cfg=TRAIN, test_cfg=dict(score_thr=0.05))
SSD3DNET = dict(
    type='SSD3DNet',
    backbone=dict(type='PointNet2SAMSG', in_channels=4,
                  num_points=(64, 32), radii=((0.5, 1.0), (1.0, 2.0)),
                  num_samples=((8, 8), (8, 8)),
                  sa_channels=(((8, 16), (8, 16)), ((16, 16), (16, 32)))),
    bbox_head=dict(type='SSD3DHead', num_classes=3, in_channels=48,
                   num_candidates=16, num_dir_bins=12,
                   aggregation_radius=2.0, aggregation_samples=8),
    train_cfg=dict(), test_cfg=dict())
H3DNET = dict(
    type='H3DNet', backbone=SSG, bbox_head=VOTE_HEAD,
    primitive_list=[dict(type='PrimitiveHead', primitive_mode=m,
                         in_channels=32) for m in ('z', 'xy', 'line')],
    refine_head=dict(type='H3DBboxHead', in_channels=32, num_classes=4,
                     radius=0.6, num_samples=4),
    train_cfg=TRAIN, test_cfg=dict())
IMVOTENET = dict(
    VOTENET, type='ImVoteNet',
    img_backbone=dict(type='ResNet', depth=18, num_stages=4,
                      out_indices=(0, 1, 2, 3), frozen_stages=1,
                      norm_eval=True),
    img_neck=dict(type='FPN', in_channels=[64, 128, 256, 512],
                  out_channels=16, num_outs=5))
MODELS = {'VoteNet': VOTENET, 'SSD3DNet': SSD3DNET, 'H3DNet': H3DNET,
          'ImVoteNet': IMVOTENET}
# what each model's JAX side computes, per input set (ImVoteNet: the cue
# path, then the image path): the eval forward of the two backbones only
# (the heads' eval mode differs from training in the norms alone), one
# compile a set
PARTS = {'VoteNet': [('eval', 'train')], 'SSD3DNet': [('eval', 'train')],
         'H3DNet': [('train',)], 'ImVoteNet': [('train',), ('eval',)]}
IMG_HW = (48, 64)


def scene(rng, b=B, n=N):
    """Indoor-like points [b, n, 4] (xyz in a 4 x 4 x 2 m room and the
    height above its floor), some duplicated, a few invalid, and 4
    boxes a sample near the points (one padded)."""
    xyz = np.concatenate([rng.uniform(-2, 2, (b, n, 2)),
                          rng.uniform(0, 2, (b, n, 1))], -1)
    xyz[:, n // 2:n // 2 + 40] = xyz[:, :40]                # duplicates
    pts = np.concatenate([xyz, xyz[..., 2:3] - 0.05], -1).astype(np.float32)
    mask = np.ones((b, n), bool)
    mask[:, -20:] = False
    boxes = np.zeros((b, 4, 7), np.float32)
    boxes[..., :2] = rng.uniform(-1.5, 1.5, (b, 4, 2))
    boxes[..., 2] = rng.uniform(0, 0.5, (b, 4))
    boxes[..., 3:6] = rng.uniform(0.5, 1.2, (b, 4, 3))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (b, 4))
    labels = rng.randint(0, 3, (b, 4)).astype(np.int32)
    valid = np.ones((b, 4), bool)
    valid[:, -1] = False
    return (pts, mask), (boxes, labels, valid)


def depth_camera(b=B):
    """A pinhole over the room (DEPTH frame: y forward, z up), 3 m back:
    [b, 4, 4] depth2img (the JAX VoteFusion's K on CAM points) and
    lidar2img (depth points straight to pixels)."""
    k = np.array([[40.0, 0, 32, 0], [0, 40, 24, 0], [0, 0, 1, 0],
                  [0, 0, 0, 1]], np.float32)
    to_cam = np.array([[1, 0, 0, 0], [0, 0, -1, 1.0], [0, 1, 0, 3.0],
                       [0, 0, 0, 1]], np.float32)
    return (np.tile(k[None], (b, 1, 1)),
            np.tile((k @ to_cam)[None, None], (b, 1, 1, 1)))


def image_inputs(rng, b=B):
    """The two image paths' extra inputs: (img [b, H, W, 3], metas with
    2-D boxes) and (img [b, 1, H, W, 3], metas with lidar2img)."""
    h, w = IMG_HW
    img = rng.randint(0, 255, (b, h, w, 3)).astype(np.float32)
    nb = 5
    boxes2d = np.zeros((b, nb, 6), np.float32)
    boxes2d[..., :2] = rng.uniform(0, 40, (b, nb, 2))
    boxes2d[..., 2:4] = boxes2d[..., :2] + rng.uniform(8, 24, (b, nb, 2))
    boxes2d[..., 4] = rng.uniform(0.3, 0.9, (b, nb))
    boxes2d[..., 5] = rng.randint(0, 4, (b, nb))
    boxes2d[:, 0] = [0, 0, w, h, 0.9, 1]
    bvalid = np.ones((b, nb), bool)
    bvalid[:, -1] = False
    d2i, l2i = depth_camera(b)
    cues = (img, dict(bboxes_2d=boxes2d, bbox_valid=bvalid, depth2img=d2i))
    views = (img[:, None] / 255.0 - 0.5, dict(lidar2img=l2i))
    return cues, views


def jax_side(jm, variables, inputs, gt, parts):
    """One compile of ``parts``: 'eval', the eval forward; 'train', the
    training forward with its running statistics, its decode, losses and
    gradients."""
    kind = type(jm)

    def loss_fn(params):
        v = {'params': params, 'batch_stats': variables['batch_stats']}
        preds, stats = jm.apply(v, *inputs, train=True,
                                mutable=['batch_stats'])
        losses = jm.apply(v, preds, *gt, method=kind.loss)
        return sum(losses.values()), (losses, preds, stats)

    @jax.jit
    def run(variables):
        out = {}
        if 'eval' in parts:
            out['eval'] = jm.apply(variables, *inputs)
        if 'train' in parts:
            (_, (losses, preds, stats)), g = jax.value_and_grad(
                loss_fn, has_aux=True)(variables['params'])
            out.update(train=preds, stats=stats['batch_stats'],
                       losses=losses, grads=g, boxes=jm.apply(
                           variables, preds, method=kind.get_bboxes))
        return out
    return run(variables)


def as_jax(x):
    if isinstance(x, dict):
        return {k: as_jax(v) for k, v in x.items()}
    return jnp.asarray(x)


def as_torch(x):
    if isinstance(x, dict):
        return {k: as_torch(v) for k, v in x.items()}
    return torch.from_numpy(np.ascontiguousarray(x))


def seeded(jm, rng, *input_sets):
    """Seeded variables for the union of each input set's init."""
    tree = {}

    def merge(dst, src):
        for k, v in src.items():
            if isinstance(v, dict):
                merge(dst.setdefault(k, {}), v)
            else:
                dst[k] = np.zeros(v.shape, v.dtype)
    for inputs in input_sets:
        merge(tree, jax.eval_shape(jm.init, jax.random.PRNGKey(0), *inputs))
    return randomize(tree, rng)


def near_proposals(port, inputs, gt):
    """The ground truth with its first two boxes a sample moved next to
    the training forward's first two proposals (or shifted candidates),
    so that the losses have positives."""
    boxes, labels, valid = (x.copy() for x in gt)
    port.train()
    with torch.no_grad():
        preds = port(*inputs)
    preds = preds.get('vote', preds)
    if 'shifted_xyz' in preds:      # 3DSSD: the shifted point in its box
        boxes[:, :2, :3] = preds['shifted_xyz'][:, :2].numpy() + \
            [0.05, -0.03, 0.02]
    else:       # one near (H3DNet refines within 0.3 m), one far enough
        # for a centre loss well above the two packages' rounding
        boxes[:, :2, :3] = preds['center'][:, :2].numpy() + \
            [[0.1, -0.08, 0.05], [0.5, -0.4, 0.3]]
    boxes[:, :2, 2] -= boxes[:, :2, 5] / 2          # bottom centres
    return boxes, labels, valid


@pytest.fixture(scope='module', params=sorted(MODELS))
def pair(request, one_thread):
    name = request.param
    cfg = MODELS[name]
    rng = np.random.RandomState(sorted(MODELS).index(name))
    (pts, mask), gt = scene(rng)
    inputs = (pts, mask)
    sets = [inputs]
    if name == 'ImVoteNet':
        cues, views = image_inputs(rng)
        sets = [inputs + cues, inputs + views]
    jm = jax_build(cfg)
    variables = seeded(jm, rng, *[tuple(as_jax(x) for x in s)
                                  for s in sets])
    port = port_build(cfg, device='cpu')
    state = from_jax_variables(variables, zoo_rules(cfg))
    port.load_state_dict(state)
    gt = near_proposals(port, tuple(as_torch(x) for x in sets[0]), gt)
    port.load_state_dict(state)
    jgt = tuple(jnp.asarray(x) for x in gt)
    want = [jax_side(jm, variables, tuple(as_jax(x) for x in s), jgt, p)
            for s, p in zip(sets, PARTS[name])]
    return dict(name=name, cfg=cfg, port=port, variables=variables,
                want=want, sets=[tuple(as_torch(x) for x in s) for s in sets],
                gt=tuple(torch.from_numpy(x) for x in gt))


def flat(preds, prefix=''):
    out = {}
    for k, v in preds.items():
        if isinstance(v, dict):
            out.update(flat(v, f'{prefix}{k}.'))
        else:
            out[prefix + k] = v
    return out


def same(got, want):
    """Every output of ``want`` in ``got``: integer and mask outputs
    equal, floats within ``TOL`` of their largest value."""
    got, want = flat(got), flat(want)
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    for key, w in want.items():
        g = got[key].detach()
        if g.is_floating_point():
            close(g, w)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), key)


def stats_of(variables, rules, stats):
    """The port's running statistics from a JAX batch_stats tree."""
    sd = from_jax_variables({'params': variables['params'],
                             'batch_stats': stats}, rules)
    return {k: v for k, v in sd.items() if k.endswith(('running_mean',
                                                       'running_var'))}


def test_forward_decode_losses_and_gradients_match_jax(pair):
    port, rules = pair['port'], zoo_rules(pair['cfg'])
    start = {k: v.clone() for k, v in port.state_dict().items()}
    for inputs, want in zip(pair['sets'], pair['want']):
        port.load_state_dict(start)
        port.eval()
        if 'eval' in want:
            with torch.no_grad():
                same(port(*inputs), want['eval'])
        if 'train' not in want:
            continue
        port.train()
        port.zero_grad(set_to_none=True)
        preds = port(*inputs)
        same(preds, want['train'])
        with torch.no_grad():
            boxes = port.get_bboxes(preds)
        same(boxes, want['boxes'])
        assert int(boxes['valid'].sum()) > 0
        stats = stats_of(pair['variables'], rules, want['stats'])
        for k, v in stats.items():
            close(port.state_dict()[k], v.numpy())
        losses = port.loss(preds, *pair['gt'])
        assert sorted(losses) == sorted(want['losses'])
        for key, w in want['losses'].items():
            close(losses[key], w)
        if inputs is pair['sets'][0]:   # the set the GT was placed by
            for key in ('center_loss', 'vote_loss', 'refine_reg_loss'):
                assert float(want['losses'].get(key, 1.0)) > 0, key
        sum(losses.values()).backward()
        grads = from_jax_variables({'params': jax.tree_util.tree_map(
            np.asarray, want['grads']),
            'batch_stats': pair['variables']['batch_stats']}, rules)
        params = dict(port.named_parameters())
        top = max(float(np.abs(v.numpy()).max()) for k, v in grads.items()
                  if k in params)
        for k, p in params.items():
            g = grads[k].numpy()
            if p.grad is None:          # the other image path's layers
                assert not np.any(g), k
                continue
            close(p.grad, g, GRAD_TOL, GRAD_TOL * NOISE * top)
    port.load_state_dict(start)


@pytest.mark.parametrize('calib', ['matrix', 'K_Rt'])
def test_vote_fusion_matches_jax(calib):
    """One sample's VoteFusion cues and mask against the JAX layer: a
    depth2img matrix (the JAX detector's input) or dict(K, Rt) (DEPTH ->
    CAM through Rt: the tensor path of ``box_modes.convert_points``);
    fewer boxes than votes (padded pairs, ties at score 0)."""
    from msmdfusion_tpu.models.fusion_layers import VoteFusion as JaxFusion
    from msmdfusion_torch.models.fusion_layers import VoteFusion
    rng = np.random.RandomState(11)
    (pts, _), _ = scene(rng, b=1)
    (img, metas), _ = image_inputs(rng, b=1)
    seeds = pts[0, :200, :3]
    depth2img = metas['depth2img'][0]
    if calib == 'K_Rt':
        c, s = np.cos(0.2), np.sin(0.2)
        depth2img = dict(K=depth2img, Rt=np.array(
            [[1, 0, 0], [0, c, -s], [0, s, c]], np.float32))
    for nb in (5, 2):
        args = (img[0], metas['bboxes_2d'][0, :nb],
                metas['bbox_valid'][0, :nb], seeds, depth2img)
        want = jax.jit(lambda *a: JaxFusion(num_classes=4).apply(
            {}, *a, IMG_HW))(*as_jax(dict(enumerate(args))).values())
        got = VoteFusion(num_classes=4)(
            *as_torch(dict(enumerate(args))).values(), IMG_HW)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        close(got[0], want[0])
        assert 0 < int(got[1].sum()) < got[1].numel()


def test_imvotenet_refuses_points_alone(one_thread):
    rng = np.random.RandomState(7)
    (pts, mask), _ = scene(rng)
    cues = tuple(as_torch(x) for x in (pts, mask) + image_inputs(rng)[0])
    port = port_build(IMVOTENET, device='cpu', seed=0)
    with pytest.raises(ValueError, match='images'):
        port(*cues[:2])
    # 2-D detections all invalid: the cues move the forward
    with torch.no_grad():
        a = port(*cues)['obj_scores']
        b = port(*cues[:3], dict(cues[3], bbox_valid=torch.zeros_like(
            cues[3]['bbox_valid'])))['obj_scores']
    assert float((a - b).abs().max()) > 1e-6
    with pytest.raises(NotImplementedError, match='ImVoteNet'):
        make_batch_infer(port, 'ImVoteNet')


def to_flax_points(sd, rules):
    """``to_flax`` with the shared MLPs' ``pointwise`` kind."""
    pw = [r for r in rules if r[2] == 'pointwise']
    tree = to_flax(sd, [r for r in rules if r[2] != 'pointwise'])
    for t, f, _, _ in pw:
        node = tree['params']
        *parents, leaf = f.split('/')
        for p in parents:
            node = node.setdefault(p, {})
        node.setdefault(leaf, {})['kernel'] = \
            sd[t + '.weight'].numpy()[:, :, 0, 0].T
    return tree


CONFIGS = ('votenet_scannet', 'votenet_sunrgbd', 'h3dnet_scannet',
           'ssd3d_kitti', 'imvotenet_sunrgbd')


@pytest.mark.parametrize('config', CONFIGS)
def test_indoor_rules_round_trip(config):
    cfg = load_config(f'configs/{config}.py').model
    port = port_build(cfg, device='cpu', seed=0)
    sd = port.state_dict()
    rules = zoo_rules(cfg)
    back = from_jax_variables(to_flax_points(sd, rules), rules)
    fresh = port_build(cfg, device='cpu')
    fresh.load_state_dict(back, strict=True)
    for k, v in fresh.state_dict().items():
        if not k.endswith('num_batches_tracked'):
            assert torch.equal(v, sd[k]), k
    assert len(back) == len(sd)
    head = port.rpn_head if config.startswith('h3d') else port.bbox_head
    width = {'ssd3d_kitti': 768, 'imvotenet_sunrgbd': 384}.get(config, 256)
    assert head.vote_mlp[0].weight.shape[1] == width
