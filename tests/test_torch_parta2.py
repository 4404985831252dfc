"""Part-A2 and its modules, port vs the JAX package, on the CPU.

- ``inverse_conv``: the rows each fine row gathers (rows whose division by
  the stride is inexact gather none) equal to the JAX lookup's, the
  features within ``TOL`` of the largest value.
- ``SparseUNet`` (the tiny U-Net of ``tests/test_parta2.py``) in eval and
  training mode: the BEV map and the full-resolution features within
  ``TOL``; the order the JAX U-Net lacks raises.
- ``roiaware_pool3d`` in both modes (points in the edge cells, just
  inside a box's faces, included) and ``points_in_boxes_batch``: equal bits where the JAX
  function's sums run in the same order, ``TOL`` otherwise.
- the samplers: equal index arrays under equal seeds.
- ``PartA2RPNHead`` (losses, ``get_proposals``) and
  ``PartAggregationROIHead`` (forward in both modes, losses, decode; the
  canonical frame, its inverse and the corner loss) on seeded inputs.
- the tiny Part-A2 end to end in training mode: every output, the losses,
  the decode and every gradient against ``jax.grad`` (``GRAD_TOL`` of its
  tensor's largest value plus ``NOISE`` of the model's largest gradient),
  in one jitted JAX function. The ground truth is two of the model's RoIs
  moved by a few centimetres (so the RoI losses have positives) and one
  other box; their z and height are moved too, since at equal values the
  vertical overlap's min/max has no derivative and the two packages pick
  different one-sided ones.
- the converter's rules round trip on ``configs/parta2_kitti.py``, and
  the CLIs' refusal of Part-A2 (its decode gives no ``labels``).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import msmdfusion_tpu.models  # noqa: F401
from msmdfusion_tpu.core import samplers as jsamplers
from msmdfusion_tpu.models.builder import build_detector as jax_build
from msmdfusion_tpu.models.detectors import PartA2 as JaxPartA2
from msmdfusion_tpu.models.heads import parta2_roi_head as jroi
from msmdfusion_tpu.models.heads.parta2_rpn_head import \
    PartA2RPNHead as JaxRPN
from msmdfusion_tpu.models.middle_encoders.sparse_unet import \
    SparseUNet as JaxUNet
from msmdfusion_tpu.ops import sampling as jsampling
from msmdfusion_tpu.ops.sparse import conv as jconv
from msmdfusion_tpu.ops.sparse.tensor import make_sparse_tensor as jmake

import msmdfusion_torch.models  # noqa: F401
from msmdfusion_torch.apis.inference import batch_model_inputs
from msmdfusion_torch.config import load_config
from msmdfusion_torch.core import samplers as tsamplers
from msmdfusion_torch.models.builder import build_detector as port_build
from msmdfusion_torch.models.heads import parta2_roi_head as troi
from msmdfusion_torch.models.heads.parta2_rpn_head import PartA2RPNHead
from msmdfusion_torch.models.middle_encoders.sparse_unet import SparseUNet
from msmdfusion_torch.ops import sampling as tsampling
from msmdfusion_torch.ops.sparse import conv as tconv
from msmdfusion_torch.ops.sparse.tensor import make_sparse_tensor as tmake
from msmdfusion_torch.utils.convert import (anchor_head_rules,
                                            from_jax_variables, new_rules,
                                            parta2_roi_rules,
                                            sparse_unet_rules, zoo_rules)
from tests.test_torch_transfusion_l import randomize
from tests.test_torch_train_step import GRAD_TOL, NOISE
from tests.test_torch_zoo_detectors import close, to_flax
from tests.torch_threads import one_thread  # noqa: F401

TOL = 1e-4
PCR = [0, -3.2, -3.0, 6.4, 3.2, 1.0]
VOX = [0.2, 0.2, 0.2]
UNET = dict(type='SparseUNet', in_channels=4, sparse_shape=(21, 32, 32),
            base_channels=4, output_channels=8,
            encoder_channels=((4,), (8, 8, 8), (8, 8, 8)),
            encoder_paddings=((1,), (1, 1, 1), (1, 1, 1)),
            decoder_channels=((8, 8, 8), (8, 8, 4), (4, 4, 4)))
RPN = dict(
    type='PartA2RPNHead', num_classes=3, in_channels=32, feat_channels=32,
    anchor_generator=dict(
        type='Anchor3DRangeGenerator',
        ranges=[[0, -3.2, -0.6, 6.4, 3.2, -0.6]] * 3,
        sizes=[[0.6, 0.8, 1.7], [0.6, 1.76, 1.73], [1.6, 3.9, 1.56]],
        rotations=[0, 1.57]),
    bbox_coder=dict(type='DeltaXYZWLHRBBoxCoder', code_size=7),
    loss_cls=dict(gamma=2.0, alpha=0.25, loss_weight=1.0),
    loss_bbox=dict(beta=0.111, loss_weight=2.0),
    loss_dir=dict(loss_weight=0.2))
ROI = dict(type='PartAggregationROIHead', num_classes=3, roi_grid=(4, 4, 4),
           in_channels=4, seg_conv_channels=(8,), part_conv_channels=(8,),
           merge_conv_channels=(8,), down_conv_channels=(8,),
           shared_fc_channels=(16,), cls_channels=(16,), reg_channels=(16,))
# the tiny Part-A2 of tests/test_parta2.py with the Part-A2 RPN head and no
# dropout (the JAX step's dropout mask cannot be drawn by the port)
PARTA2 = dict(
    type='PartA2',
    pts_voxel_layer=dict(max_num_points=4, voxel_size=VOX,
                         max_voxels=(256, 256), point_cloud_range=PCR),
    pts_voxel_encoder=dict(type='HardSimpleVFE', num_features=4),
    pts_middle_encoder=UNET,
    pts_backbone=dict(type='SECOND', in_channels=16, out_channels=[16, 32],
                      layer_nums=[2, 2], layer_strides=[1, 2]),
    pts_neck=dict(type='SECONDFPN', in_channels=[16, 32],
                  out_channels=[16, 16], upsample_strides=[1, 2],
                  use_conv_for_no_stride=True),
    rpn_head=RPN, roi_head=dict(ROI, dropout_ratio=0.0), num_proposals=8,
    train_cfg=dict(rpn=dict(pos_iou_thr=0.5, neg_iou_thr=0.35,
                            min_pos_iou=0.3), rcnn=dict()),
    test_cfg=dict(rpn=dict(nms_pre=64, nms_thr=0.7, score_thr=0.0,
                           max_num=32), rcnn=dict()))


def seeded_variables(init, rng, *args):
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *args)
    return randomize(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), dict(shapes)), rng)


def port_state(variables, rules, prefix):
    """The rules' state dict with ``prefix + '.'`` taken off its keys."""
    sd = from_jax_variables(variables, rules)
    return {k[len(prefix) + 1:]: v for k, v in sd.items()}


def sparse_sets(rng, n_coarse=120, fine_k=400):
    """A coarse (11, 16, 16) set of two samples and a fine (21, 32, 32)
    set around its upsampled cells (most fine rows hit, many taps divide
    inexactly), both padded with empty rows."""
    coarse = np.stack([rng.randint(0, 2, n_coarse)] + [
        rng.randint(0, s, n_coarse) for s in (11, 16, 16)], -1)
    coarse = np.unique(coarse, axis=0)
    fine = coarse[rng.randint(0, len(coarse), 2 * fine_k)].copy()
    fine[:, 1:] = fine[:, 1:] * 2 + rng.randint(-1, 2, (2 * fine_k, 3))
    fine[:, 1:] = np.clip(fine[:, 1:], 0, np.array([20, 31, 31]))
    fine = np.unique(fine, axis=0)[:fine_k - 20]

    def pad(c, k):
        out = -np.ones((k, 4), np.int32)
        out[:len(c)] = c
        return out, np.arange(k) < len(c)
    return pad(coarse, len(coarse) + 10), pad(fine, fine_k)


def test_inverse_conv_matches_jax():
    rng = np.random.RandomState(0)
    (cco, cv), (fco, fv) = sparse_sets(rng)
    feats = rng.randn(len(cv), 6).astype(np.float32)
    w = rng.randn(27, 6, 5).astype(np.float32)

    @jax.jit
    def run(feats, cco, cv, fco, fv, w):
        jst = jmake(feats, cco, cv, (11, 16, 16), 2)
        jfine = jmake(jnp.zeros((fv.shape[0], 1)), fco, fv, (21, 32, 32), 2)
        out = jconv.inverse_conv(jst, w, jfine.keys, jfine.coords,
                                 jfine.valid, (21, 32, 32), 3, 2, 1)
        return out.features, out.keys, jst.keys, jfine.coords
    want_feats, want_keys, coarse_keys, fine_coords = run(
        *map(jnp.asarray, (feats, cco, cv, fco, fv, w)))
    tst = tmake(torch.from_numpy(feats), torch.from_numpy(cco),
                torch.from_numpy(cv), (11, 16, 16), 2)
    tfine = tmake(torch.zeros(len(fv), 1), torch.from_numpy(fco),
                  torch.from_numpy(fv), (21, 32, 32), 2)
    got = tconv.inverse_conv(tst, torch.from_numpy(w), tfine.keys,
                             tfine.coords, tfine.valid, (21, 32, 32), 3, 2,
                             1)
    close(got.features, want_feats)
    np.testing.assert_array_equal(got.keys.numpy(), np.asarray(want_keys))
    rows = tconv.inverse_rows(tst, tfine.coords, tfine.valid, 3, 2, 1)
    # the JAX rows: the same taps through its own lookup
    taps = np.stack(np.meshgrid(*[np.arange(3)] * 3, indexing='ij'),
                    -1).reshape(-1, 3)
    numer = np.asarray(fine_coords)[None, :, 1:] + 1 - taps[:, None]
    exact = (numer % 2 == 0).all(-1)
    hit = rows.numpy() >= 0
    assert hit.any() and (fv[None] & ~exact).any()
    assert not (hit & ~exact).any()
    ok = fv[None] & exact & ((numer // 2 >= 0) & (numer // 2 < np.array(
        [11, 16, 16]))).all(-1)
    keys = np.asarray(coarse_keys)
    q = np.concatenate([np.broadcast_to(np.asarray(fine_coords)[None, :, :1],
                                        ok.shape + (1,)), numer // 2], -1)
    qkey = ((q[..., 0] * 11 + q[..., 1]) * 16 + q[..., 2]) * 16 + q[..., 3]
    pos = np.clip(np.searchsorted(keys, qkey), 0, len(keys) - 1)
    jrows = np.where(ok & (keys[pos] == qkey), pos, -1)
    np.testing.assert_array_equal(rows.numpy(), jrows)


@pytest.fixture(scope='module')
def unet(one_thread):
    """The tiny U-Net's inputs, seeded variables and JAX outputs in eval
    and training mode (one jitted function)."""
    rng = np.random.RandomState(1)
    _, (fco, fv) = sparse_sets(rng)
    vf = rng.randn(len(fv), 4).astype(np.float32)
    cfg = {k: v for k, v in UNET.items() if k != 'type'}
    jm = JaxUNet(**cfg)
    args = tuple(jnp.asarray(x) for x in (vf, fco, fv))
    variables = seeded_variables(
        lambda k, a, b, c: jm.init(k, a, b, c, 2), rng, *args)

    @jax.jit
    def run(variables, *args):
        return [jm.apply(variables, *args, 2, train=train,
                         mutable=['batch_stats'])[0]
                for train in (False, True)]
    return dict(cfg=cfg, inputs=(vf, fco, fv), variables=variables,
                want=run(variables, *args))


@pytest.mark.parametrize('train', [False, True])
def test_sparse_unet_matches_jax(unet, train):
    cfg, variables = unet['cfg'], unet['variables']
    jbev, jseg = unet['want'][int(train)]
    rules, add = new_rules()
    sparse_unet_rules(add, cfg, 'unet', 'unet')
    tm = SparseUNet(**cfg)
    tm.load_state_dict(port_state(
        {'params': {'unet': variables['params']},
         'batch_stats': {'unet': variables['batch_stats']}}, rules, 'unet'))
    tm.train(train)
    with torch.no_grad():
        bev, seg = tm(*map(torch.from_numpy, unet['inputs']), 2)
    close(bev.permute(0, 2, 3, 1), jbev)
    close(seg.features, jseg.features)
    np.testing.assert_array_equal(seg.keys.numpy(), np.asarray(jseg.keys))
    with pytest.raises(NotImplementedError, match='order'):
        SparseUNet(**dict(cfg, order=('norm', 'conv', 'act')))


def pool_inputs(rng, p=300, n=6):
    pts = rng.uniform(-2, 2, (p, 3)).astype(np.float32)
    boxes = np.concatenate([rng.uniform(-1, 1, (n, 3)),
                            rng.uniform(0.8, 2.5, (n, 3)),
                            rng.uniform(-3, 3, (n, 1))], -1).astype(np.float32)
    # a few points just inside box 0's faces and bottom (the edge cells;
    # on a face itself a point's side turns on the rotation's last bit)
    c, (w, l, h), yaw = boxes[0, :3], boxes[0, 3:6], boxes[0, 6]
    local = np.array([[0.499 * w, 0, 0.5], [0, -0.499 * l, 0.2],
                      [0.1, 0.1, 1e-3 * h]], np.float32)
    rot = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                    [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]])
    pts[:3] = (local @ rot.T + c).astype(np.float32)
    return pts, rng.randn(p, 5).astype(np.float32), boxes


@pytest.mark.parametrize('mode', ['max', 'avg'])
def test_roiaware_pool3d_matches_jax(mode):
    rng = np.random.RandomState(2)
    pts, feats, boxes = pool_inputs(rng)
    want = jax.jit(lambda *a: jsampling.roiaware_pool3d(*a, (4, 3, 5), mode))(
        jnp.asarray(pts), jnp.asarray(feats), jnp.asarray(boxes))
    got = tsampling.roiaware_pool3d(torch.from_numpy(pts),
                                    torch.from_numpy(feats),
                                    torch.from_numpy(boxes), (4, 3, 5), mode)
    assert int((np.asarray(want) != 0).any(-1).sum()) > 10
    close(got, want, 1e-6)
    if mode == 'max':           # a maximum is one of its inputs
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # chunks of boxes change no number
    small = tsampling.POOL_ELEMENTS
    try:
        tsampling.POOL_ELEMENTS = pts.shape[0] * feats.shape[1] * 2
        again = tsampling.roiaware_pool3d(
            torch.from_numpy(pts), torch.from_numpy(feats),
            torch.from_numpy(boxes), (4, 3, 5), mode)
    finally:
        tsampling.POOL_ELEMENTS = small
    assert torch.equal(again, got)
    inside = tsampling.points_in_boxes_batch(
        torch.from_numpy(np.stack([pts, pts[::-1].copy()])),
        torch.from_numpy(np.stack([boxes, boxes[::-1].copy()])))
    jinside = jax.jit(jsampling.points_in_boxes_batch)(
        jnp.asarray(np.stack([pts, pts[::-1]])),
        jnp.asarray(np.stack([boxes, boxes[::-1]])))
    np.testing.assert_array_equal(inside.numpy(), np.asarray(jinside))
    assert inside[0, :3, 0].all()


def test_samplers_match_jax():
    rng = np.random.RandomState(3)
    gt_inds = rng.choice([-1, 0, 0, 0, 1, 2, 3], 200)
    ovl = rng.uniform(0, 1, 200).astype(np.float32)
    kw = dict(num=64, pos_fraction=0.55, neg_piece_fractions=[0.8, 0.2],
              neg_iou_piece_thrs=[0.55, 0.1], return_iou=True)
    for cls, kwargs in (('PseudoSampler', {}),
                        ('IoUNegPiecewiseSampler', kw),
                        ('IoUNegPiecewiseSampler', dict(kw, num=512)),
                        ('IoUNegPiecewiseSampler', dict(kw, neg_pos_ub=1))):
        got = tsamplers.BBOX_SAMPLERS.get(cls)(**kwargs).sample(
            gt_inds, ovl, np.random.RandomState(7))
        want = jsamplers.BBOX_SAMPLERS.get(cls)(**kwargs).sample(
            gt_inds, ovl, np.random.RandomState(7))
        for key in ('pos_inds', 'neg_inds', 'pos_assigned_gt_inds', 'inds',
                    'iou'):
            a, b = getattr(got, key), getattr(want, key)
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a, b)


def test_rpn_head_matches_jax(one_thread):
    rng = np.random.RandomState(4)
    x = rng.randn(2, 8, 8, 32).astype(np.float32)
    tcfg = dict(nms_pre=64, nms_thr=0.7, score_thr=0.0, nms_post=16,
                max_num=32)
    train = dict(pos_iou_thr=0.5, neg_iou_thr=0.35, min_pos_iou=0.3)
    jh = JaxRPN(**{k: v for k, v in RPN.items() if k != 'type'},
                train_cfg=train, test_cfg=tcfg)
    variables = seeded_variables(jh.init, rng, jnp.asarray(x))
    gt = np.zeros((2, 3, 7), np.float32)
    gt[..., :2] = rng.uniform(0.5, 3, (2, 3, 2))
    gt[..., 2], gt[..., 3:6], gt[..., 6] = -1.5, [1.6, 3.9, 1.56], 0.4
    gl, gv = np.array([[2, 0, 1], [1, 2, 0]]), np.array([[1, 1, 0],
                                                          [1, 1, 1]], bool)

    @jax.jit
    def run(variables, x, *gt):
        preds = jh.apply(variables, x)
        return (preds, jh.apply(variables, preds, *gt, method=JaxRPN.loss),
                jh.apply(variables, preds, method=JaxRPN.get_proposals))
    jpreds, jloss, jprop = run(variables, jnp.asarray(x),
                               *map(jnp.asarray, (gt, gl, gv)))
    rules, add = new_rules()
    anchor_head_rules(add, RPN, 'rpn', 'rpn')
    th = PartA2RPNHead(**{k: v for k, v in RPN.items() if k != 'type'},
                       train_cfg=train, test_cfg=tcfg)
    th.load_state_dict(port_state({'params': {'rpn': variables['params']}},
                                  rules, 'rpn'))
    preds = th(torch.from_numpy(x).permute(0, 3, 1, 2))
    for key in jpreds:
        close(preds[key].permute(0, 2, 3, 1), jpreds[key])
    losses = th.loss(preds, *map(torch.from_numpy, (gt, gl, gv)))
    assert sorted(losses) == sorted(jloss)
    for key in jloss:
        close(losses[key], jloss[key])
    prop = th.get_proposals(preds)
    for key in ('labels', 'valid'):
        np.testing.assert_array_equal(prop[key].numpy(),
                                      np.asarray(jprop[key]))
    assert int(prop['valid'].sum()) > 4
    close(prop['boxes'], jprop['boxes'])
    close(prop['scores'], jprop['scores'])


def roi_inputs(rng, p=400, r=6):
    pts = np.concatenate([rng.uniform(0, 6.4, (p, 1)),
                          rng.uniform(-3.2, 3.2, (p, 1)),
                          rng.uniform(-3, 1, (p, 1))], -1).astype(np.float32)
    feats = rng.randn(p, 4).astype(np.float32)
    valid = rng.rand(p) > 0.1
    part = rng.rand(p, 4).astype(np.float32)
    rois = np.concatenate([rng.uniform(1, 5, (r, 1)),
                           rng.uniform(-2, 2, (r, 1)),
                           rng.uniform(-2.5, -1.5, (r, 1)),
                           rng.uniform(1, 3, (r, 3)),
                           rng.uniform(-3, 3, (r, 1))], -1).astype(np.float32)
    roi_valid = np.arange(r) < r - 1
    return pts, feats, valid, rois, roi_valid, part


@pytest.mark.parametrize('train', [False, True])
def test_roi_head_matches_jax(train, one_thread):
    rng = np.random.RandomState(5)
    args = roi_inputs(rng)
    cfg = {k: v for k, v in ROI.items() if k != 'type'}
    jh = jroi.PartAggregationROIHead(**cfg, dropout_ratio=0.0,
                                     train_cfg=dict(pos_iou_thr=0.3))
    jargs = tuple(jnp.asarray(a) for a in args[:5])
    variables = seeded_variables(
        lambda k, *a: jh.init(k, *a, part_feats=jnp.asarray(args[5])), rng,
        *jargs)
    gt = args[3][:3].copy()
    gt[:, :3] += [0.1, -0.05, 0.04]
    gt[:, 5] *= 1.1
    gtl, gtv = np.array([0, 1, 2]), np.array([True, True, False])
    head = jroi.PartAggregationROIHead

    @jax.jit
    def run(variables, part, *gts):
        out = jh.apply(variables, *jargs, part_feats=part, train=train,
                       mutable=['batch_stats'])[0]
        return (out, jh.apply(variables, out, *gts, method=head.loss),
                jh.apply(variables, out, method=head.get_bboxes))
    jout, jloss, jdet = run(variables, jnp.asarray(args[5]),
                            *map(jnp.asarray, (gt, gtl, gtv)))
    rules, add = new_rules()
    parta2_roi_rules(add, cfg, 'roi', 'roi')
    th = troi.PartAggregationROIHead(**cfg, dropout_ratio=0.0,
                                     train_cfg=dict(pos_iou_thr=0.3))
    th.load_state_dict(port_state(
        {'params': {'roi': variables['params']},
         'batch_stats': {'roi': variables['batch_stats']}}, rules, 'roi'))
    th.train(train)
    targs = tuple(torch.from_numpy(a) for a in args)
    out = th(*targs[:5], part_feats=targs[5])
    for key in ('cls_score', 'bbox_pred'):
        close(out[key], jout[key])
    losses = th.loss(out, *map(torch.from_numpy, (gt, gtl, gtv)))
    assert sorted(losses) == sorted(jloss)
    for key in jloss:
        close(losses[key], jloss[key])
    det = th.get_bboxes(out)
    assert sorted(det) == sorted(jdet) == ['bboxes', 'scores', 'valid']
    for key in jdet:
        close(det[key].float(), jnp.asarray(jdet[key], jnp.float32))


def test_canonical_frame_matches_jax():
    rng = np.random.RandomState(6)
    boxes = rng.randn(50, 7).astype(np.float32) * 3
    boxes[:, 3:6] = np.abs(boxes[:, 3:6]) + 0.5
    rois = rng.randn(50, 7).astype(np.float32) * 3
    rois[:, 3:6] = np.abs(rois[:, 3:6]) + 0.5
    tb, tr = torch.from_numpy(boxes), torch.from_numpy(rois)
    ct = troi.canonical_transform(tb, tr)

    @jax.jit
    def run(boxes, rois, ct):
        return (jroi.canonical_transform(boxes, rois),
                jroi.decanonicalize(ct, rois),
                jroi.corner_loss_lidar(boxes, rois))
    jct, jback, jcorner = run(jnp.asarray(boxes), jnp.asarray(rois),
                              jnp.asarray(ct.numpy()))
    close(ct, jct, 1e-5)
    close(troi.decanonicalize(ct, tr), jback, 1e-5)
    close(troi.corner_loss_lidar(tb, tr), jcorner, 1e-5)


def parta2_points(rng, n=256):
    pts = np.concatenate([
        rng.uniform(0, 6.4, (1, n, 1)), rng.uniform(-3.2, 3.2, (1, n, 1)),
        rng.uniform(-3, 1, (1, n, 1)), rng.uniform(0, 1, (1, n, 1))], -1)
    return pts.astype(np.float32), np.ones((1, n), bool)


@pytest.fixture(scope='module')
def tiny(one_thread):
    rng = np.random.RandomState(0)
    pts, mask = parta2_points(rng)
    jm = jax_build(PARTA2)
    inputs = (jnp.asarray(pts), jnp.asarray(mask))
    variables = seeded_variables(jm.init, rng, *inputs)
    port = port_build(PARTA2, device='cpu')
    port.load_state_dict(from_jax_variables(variables, zoo_rules(PARTA2)))
    tin = (torch.from_numpy(pts), torch.from_numpy(mask))
    port.train()
    with torch.no_grad():
        rois = port(*tin)['roi']['rois'][0].numpy()
    gt = np.zeros((1, 3, 7), np.float32)
    gt[0, :2] = rois[:2]
    gt[0, :2, 0] += 0.05
    gt[0, :2, 2] += 0.03
    gt[0, :2, 5] *= 1.05
    gt[0, 2] = [2.0, 0.0, -1.5, 1.6, 3.9, 1.56, 0.3]
    labels, valid = np.array([[2, 1, 0]], np.int32), np.ones((1, 3), bool)
    jgt = tuple(jnp.asarray(x) for x in (gt, labels, valid))

    def loss_fn(params):
        v = {'params': params, 'batch_stats': variables['batch_stats']}
        preds, _ = jm.apply(v, *inputs, train=True, mutable=['batch_stats'])
        losses = jm.apply(v, preds, *jgt, method=JaxPartA2.loss)
        return sum(losses.values()), (losses, preds)

    @jax.jit
    def run(variables):
        (_, (losses, preds)), g = jax.value_and_grad(
            loss_fn, has_aux=True)(variables['params'])
        return preds, jm.apply(variables, preds,
                               method=JaxPartA2.get_bboxes), losses, g
    return dict(port=port, variables=variables, want=run(variables),
                inputs=tin, gt=tuple(map(torch.from_numpy,
                                         (gt, labels, valid))))


def test_tiny_parta2_matches_jax(tiny):
    port, (jpreds, jdet, jloss, jgrads) = tiny['port'], tiny['want']
    port.train()
    port.zero_grad(set_to_none=True)
    preds = port(*tiny['inputs'])
    assert tuple(preds['roi']['rois'].shape) == (1, 8, 7)
    for key in preds['rpn']:
        close(preds['rpn'][key].permute(0, 2, 3, 1), jpreds['rpn'][key])
    for key in ('rois', 'cls_score', 'bbox_pred'):
        close(preds['roi'][key], jpreds['roi'][key])
    np.testing.assert_array_equal(preds['roi']['roi_valid'].numpy(),
                                  np.asarray(jpreds['roi']['roi_valid']))
    for key in ('seg_logit', 'part_reg', 'centers'):
        close(preds['semantic'][key], jpreds['semantic'][key])
    with torch.no_grad():
        det = port.get_bboxes(preds)
    assert sorted(det) == sorted(jdet)
    for key in jdet:
        close(det[key].float(), jnp.asarray(jdet[key], jnp.float32))
    losses = port.loss(preds, *tiny['gt'])
    assert sorted(losses) == sorted(jloss)
    assert float(jloss['loss_roi_bbox']) > 0
    for key in jloss:
        close(losses[key], jloss[key])
    sum(losses.values()).backward()
    want = from_jax_variables({'params': jax.tree_util.tree_map(
        np.asarray, jgrads), 'batch_stats': tiny['variables']['batch_stats']},
        zoo_rules(PARTA2))
    params = dict(port.named_parameters())
    top = max(float(np.abs(v.numpy()).max()) for k, v in want.items()
              if k in params)
    for k, p in params.items():
        close(p.grad, want[k].numpy(), GRAD_TOL, GRAD_TOL * NOISE * top)


def test_parta2_config_rules_and_cli_refusal():
    cfg = load_config('configs/parta2_kitti.py').model
    port = port_build(cfg, device='cpu', seed=0)
    assert port.roi_head.shared_fc_0.weight.shape == (256, 256 * 7 ** 3)
    sd = port.state_dict()
    rules = zoo_rules(cfg)
    back = from_jax_variables(to_flax(sd, rules), rules)
    fresh = port_build(cfg, device='cpu')
    fresh.load_state_dict(back, strict=True)
    for k, v in fresh.state_dict().items():
        if not k.endswith('num_batches_tracked'):
            assert torch.equal(v, sd[k]), k
    assert len(back) == len(sd)
    batch = {'points': torch.zeros(1, 4, 4),
             'points_mask': torch.ones(1, 4, dtype=torch.bool)}
    with pytest.raises(NotImplementedError, match='labels'):
        batch_model_inputs('PartA2', batch, 'cpu')
