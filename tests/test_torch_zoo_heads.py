"""The zoo's anchors, coders, NMS, losses and heads, port vs the JAX
package, on the CPU.

- The anchor generators: equal arrays.
- ``DeltaXYZWLHRBBoxCoder`` encode and decode and ``CenterPointBBoxCoder``
  decode within 1e-6 (relative to each output's largest value), the top K
  of a heatmap with ties in ``jax.lax.top_k``'s order (``topk_lower_index``).
- ``nms_bev``, ``circle_nms``, ``box3d_multiclass_nms`` and
  ``aligned_3d_nms``: the same keep set and order as JAX, on inputs where
  no pair lies within ``MARGIN`` of its threshold (asserted).
- ``CenterHead``, ``Anchor3DHead`` and ``FreeAnchor3DHead`` on one seeded
  BEV map and seeded weights (the converter's rules): the forward within
  ``TOL``, then the losses and ``get_bboxes`` of both packages on the JAX
  forward's outputs (the decode's top K and NMS are discontinuous: on the
  same inputs they must agree exactly), boxes within ``TOL``.
- The forced assignment where boxes share their best anchor: the later box
  takes it on both sides (the JAX scatter's last write on the CPU), also
  where padded boxes (IoU -1 everywhere, best anchor 0) follow a valid box
  whose best anchor is 0.
"""
import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from msmdfusion_tpu.core import anchors as janchors
from msmdfusion_tpu.core import boxes as jboxes
from msmdfusion_tpu.core import coders as jcoders
from msmdfusion_tpu.core import nms as jnms
from msmdfusion_tpu.core.iou3d import boxes_iou_bev as jiou
from msmdfusion_tpu.models import losses as jlosses
from msmdfusion_tpu.models.heads.anchor3d_head import \
    Anchor3DHead as JaxAnchorHead
from msmdfusion_tpu.models.heads.centerpoint_head import \
    CenterHead as JaxCenterHead
from msmdfusion_tpu.models.heads.free_anchor3d_head import \
    FreeAnchor3DHead as JaxFreeAnchor

from msmdfusion_torch.core import anchors as tanchors
from msmdfusion_torch.core import boxes as tboxes
from msmdfusion_torch.core import coders as tcoders
from msmdfusion_torch.core import nms as tnms
from msmdfusion_torch.core.iou3d import boxes_iou_bev as tiou
from msmdfusion_torch.models import losses as tlosses
from msmdfusion_torch.models.heads.anchor3d_head import Anchor3DHead, assign
from msmdfusion_torch.models.heads.centerpoint_head import CenterHead
from msmdfusion_torch.models.heads.free_anchor3d_head import FreeAnchor3DHead
from msmdfusion_torch.utils.convert import (center_head_rules,
                                            from_jax_variables, new_rules)
from tests.test_torch_transfusion_l import randomize

TOL = 1e-5
MARGIN = 1e-3        # no IoU or distance this near its threshold in a case
# the JAX functions jitted: eagerly the rotated IoU compiles op by op
J_IOU = jax.jit(jiou)
J_NMS_BEV = jax.jit(jnms.nms_bev, static_argnums=(2, 4, 5))
J_CIRCLE = jax.jit(jax.vmap(jnms.circle_nms, (0, 0, None, 0, None)),
                   static_argnums=(2, 4))
J_MULTICLASS = jax.jit(jnms.box3d_multiclass_nms, static_argnums=(3, 4, 5))
J_ALIGNED = jax.jit(jnms.aligned_3d_nms, static_argnums=(3,))


def t(x):
    return torch.from_numpy(np.asarray(x))


def close(got, want, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, err


def equal(got, want):
    np.testing.assert_array_equal(
        got.detach().numpy() if torch.is_tensor(got) else got,
        np.asarray(want))


def random_boxes(rng, n, extent=6.0, extra=0):
    b = np.concatenate([rng.uniform(-extent, extent, (n, 2)),
                        rng.uniform(-2, 0, (n, 1)),
                        rng.uniform(0.5, 4.0, (n, 3)),
                        rng.uniform(-math.pi, math.pi, (n, 1)),
                        rng.randn(n, extra)], 1)
    return b.astype(np.float32)


@pytest.mark.parametrize('aligned,custom', [(False, ()), (True, (0, 0))])
def test_anchors_match_jax(aligned, custom):
    kw = dict(ranges=[[-4.8, -4.8, -1.8, 4.8, 4.8, -1.8]],
              sizes=[[1.6, 3.9, 1.56], [0.6, 0.8, 1.7]],
              rotations=[0, 1.57], custom_values=custom)
    name = ('AlignedAnchor3DRangeGenerator' if aligned
            else 'Anchor3DRangeGenerator')
    got = getattr(tanchors, name)(**kw)
    want = getattr(janchors, name)(**kw)
    assert got.num_base_anchors == want.num_base_anchors == 4
    equal(got.grid_anchors((6, 10)), want.grid_anchors((6, 10)))


def test_box_helpers_match_jax():
    rng = np.random.RandomState(0)
    vals = rng.uniform(-20, 20, 200).astype(np.float32)
    for off, period in ((0.5, math.pi), (0, 2 * math.pi), (1.0, math.pi)):
        equal(tboxes.limit_period(t(vals), off, period),
              jboxes.limit_period(jnp.asarray(vals), off, period))
    b = random_boxes(rng, 30)[:, [0, 1, 3, 4, 6]]
    equal(tboxes.xywhr2xyxyr(t(b)), jboxes.xywhr2xyxyr(jnp.asarray(b)))


def test_losses_match_jax():
    rng = np.random.RandomState(1)
    a, b = (rng.randn(64, 7).astype(np.float32) for _ in range(2))
    lab = (rng.rand(64, 7) > 0.5).astype(np.float32)
    ids = rng.randint(0, 7, 64)
    want = jax.jit(lambda a, b, lab, ids: (
        jlosses.smooth_l1_loss(a, b, 0.111),
        jlosses.binary_cross_entropy(a, lab),
        jlosses.cross_entropy(a, ids, 7)))(a, b, lab, ids)
    got = (tlosses.smooth_l1_loss(t(a), t(b), 0.111),
           tlosses.binary_cross_entropy(t(a), t(lab)),
           tlosses.cross_entropy(t(a), t(ids), 7))
    for g, w in zip(got, want):
        close(g, w, 1e-6)


def test_delta_coder_matches_jax():
    rng = np.random.RandomState(2)
    anchors, gts = random_boxes(rng, 50, extra=2), random_boxes(rng, 50,
                                                                extra=2)
    gts[:, 3:6] = np.abs(gts[:, 3:6])
    got = tcoders.DeltaXYZWLHRBBoxCoder(9)
    want = jcoders.DeltaXYZWLHRBBoxCoder(9)
    deltas = got.encode(t(anchors), t(gts))
    jdeltas, jboxes = jax.jit(lambda a, g, d: (
        want.encode(a, g), want.decode(a, d)))(anchors, gts, deltas.numpy())
    close(deltas, jdeltas, 1e-6)
    close(got.decode(t(anchors), deltas), jboxes, 1e-6)
    close(got.decode(t(anchors), deltas), gts, 1e-5)       # a round trip


def test_topk_ties_in_jax_order():
    rng = np.random.RandomState(3)
    x = rng.randint(0, 6, (4, 300)).astype(np.float32)   # many ties
    for k in (1, 17, 64, 300):
        v, i = tcoders.topk_lower_index(t(x), k)
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        equal(v, jv)
        equal(i, ji)


def test_centerpoint_coder_matches_jax():
    rng = np.random.RandomState(4)
    b, c, h, w = 2, 3, 12, 16
    heat = rng.rand(b, c, h, w).astype(np.float32)
    heat[0, :, :3] = 0.75                                 # ties
    maps = [rng.randn(b, ch, h, w).astype(np.float32) * 0.3
            for ch in (1, 1, 1, 3, 2, 2)]
    kw = dict(pc_range=[-5.0, -4.0], out_size_factor=4,
              voxel_size=[0.2, 0.2], post_center_range=[-5, -4, -3, 6, 4, 3],
              max_num=40, score_threshold=0.3)
    got = tcoders.CenterPointBBoxCoder(**kw).decode(
        *(t(m) for m in [heat] + maps))
    want = jax.jit(jcoders.CenterPointBBoxCoder(**kw).decode)(
        *(jnp.asarray(m) for m in [heat] + maps))
    for key in ('scores', 'labels', 'valid'):
        equal(got[key], want[key])
    close(got['bboxes'], want['bboxes'], 1e-6)


def margin(values, thresh):
    """The distance of the nearest value to ``thresh``."""
    return float(np.abs(np.asarray(values) - thresh).min())


def separated_boxes(rng, n, thresh):
    """Boxes (cx, cy, w, l, yaw) in clusters, no pair's IoU near
    ``thresh``."""
    ctr = rng.uniform(-6, 6, (n // 4 + 1, 2))
    b = np.concatenate([ctr[rng.randint(0, len(ctr), n)]
                        + rng.normal(0, 0.4, (n, 2)),
                        rng.uniform(1, 3, (n, 2)),
                        rng.uniform(-math.pi, math.pi, (n, 1))], 1)
    b = b.astype(np.float32)
    iou = np.asarray(J_IOU(jnp.asarray(b), jnp.asarray(b)))
    assert margin(iou[~np.eye(n, dtype=bool)], thresh) > MARGIN
    return b


@pytest.mark.parametrize('pre,post', [(None, None), (24, 9)])
def test_nms_bev_matches_jax(pre, post):
    rng = np.random.RandomState(5)
    boxes = separated_boxes(rng, 40, 0.2)
    scores = rng.rand(40).astype(np.float32)
    scores[5:9] = scores[4]                                # ties
    valid = rng.rand(40) > 0.15
    keep, order = tnms.nms_bev(t(boxes), t(scores), 0.2, t(valid), pre, post)
    jkeep, jorder = J_NMS_BEV(jnp.asarray(boxes), jnp.asarray(scores), 0.2,
                              jnp.asarray(valid), pre, post)
    equal(order, jorder)
    equal(keep, jkeep)
    assert 0 < int(keep.sum()) < int(valid.sum())


def test_circle_nms_matches_jax():
    rng = np.random.RandomState(6)
    ctr = rng.uniform(-4, 4, (3, 60, 2)).astype(np.float32)
    d2 = ((ctr[:, :, None] - ctr[:, None]) ** 2).sum(-1)
    assert margin(d2, 0.85 ** 2) > MARGIN
    scores = rng.rand(3, 60).astype(np.float32)
    valid = rng.rand(3, 60) > 0.1
    keep, order = tnms.circle_nms(t(ctr), t(scores), 0.85, t(valid), 20)
    jkeep, jorder = J_CIRCLE(jnp.asarray(ctr), jnp.asarray(scores), 0.85,
                             jnp.asarray(valid), 20)
    equal(order, jorder)
    equal(keep, jkeep)


def test_multiclass_and_aligned_nms_match_jax():
    rng = np.random.RandomState(7)
    bev = separated_boxes(rng, 48, 0.25)
    boxes = np.concatenate([bev[:, :2], rng.uniform(-2, 0, (48, 1)),
                            bev[:, 2:4], rng.uniform(1, 2, (48, 1)),
                            bev[:, 4:]], 1).astype(np.float32)
    scores = rng.rand(48, 4).astype(np.float32)
    got = tnms.box3d_multiclass_nms(t(boxes), t(bev), t(scores), 0.3, 0.25,
                                    30)
    want = J_MULTICLASS(jnp.asarray(boxes), jnp.asarray(bev),
                        jnp.asarray(scores), 0.3, 0.25, 30)
    for key in ('boxes', 'scores', 'labels', 'valid'):
        equal(got[key], want[key])
    lo = rng.uniform(-3, 3, (50, 3)).astype(np.float32)
    box6 = np.concatenate([lo, lo + rng.uniform(0.5, 2, (50, 3))],
                          1).astype(np.float32)
    cls = rng.randint(0, 3, 50)
    keep, order = tnms.aligned_3d_nms(t(box6), t(scores[:, 0].repeat(2)[:50]),
                                      t(cls), 0.25)
    jkeep, jorder = J_ALIGNED(
        jnp.asarray(box6), jnp.asarray(scores[:, 0].repeat(2)[:50]),
        jnp.asarray(cls), 0.25)
    equal(order, jorder)
    equal(keep, jkeep)


def jax_variables(module, rng, *args):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    return randomize(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), dict(shapes)), rng)


def bare(rules):
    return [(a[1:], b[1:], k, ks) for a, b, k, ks in rules]


CENTER = dict(
    in_channels=12, share_conv_channel=8,
    tasks=[dict(num_class=1, class_names=['car']),
           dict(num_class=2, class_names=['truck', 'bus'])],
    common_heads=dict(reg=(2, 2), height=(1, 2), dim=(3, 2), rot=(2, 2),
                      vel=(2, 2)),
    bbox_coder=dict(type='CenterPointBBoxCoder', pc_range=[-4.8, -4.8],
                    voxel_size=[0.2, 0.2], out_size_factor=2,
                    post_center_range=[-6, -6, -10, 6, 6, 10], max_num=30,
                    score_threshold=0.05, code_size=9),
    train_cfg=dict(grid_size=[48, 48, 40], voxel_size=[0.2, 0.2, 0.2],
                   out_size_factor=2, gaussian_overlap=0.1, min_radius=2,
                   point_cloud_range=[-4.8, -4.8, -5, 4.8, 4.8, 3],
                   code_weights=[1.0] * 8 + [0.2, 0.2]),
    test_cfg=dict(min_radius=[1.5, 0.6], nms_type='circle',
                  post_max_size=12))


def gt_boxes(rng, b, g, extent=4.0, width=9):
    gt = random_boxes(rng, b * g, extent, extra=width - 7).reshape(b, g,
                                                                   width)
    gt[..., 3:6] = np.abs(gt[..., 3:6])
    return gt


def test_center_head_matches_jax():
    rng = np.random.RandomState(8)
    x = rng.randn(2, 24, 24, 12).astype(np.float32)
    jhead = JaxCenterHead(**CENTER)
    variables = jax_variables(jhead, rng, jnp.asarray(x))
    rules, add = new_rules()
    center_head_rules(add, CENTER, t='', f='')
    head = CenterHead(**CENTER)
    head.load_state_dict(from_jax_variables(variables, bare(rules)))
    head.eval()
    jpreds = jax.jit(lambda v, x: jhead.apply(v, x))(variables,
                                                     jnp.asarray(x))
    preds = head(t(x).permute(0, 3, 1, 2))
    for p, jp in zip(preds, jpreds):
        for key in jp:
            close(p[key].permute(0, 2, 3, 1), jp[key])
    # the decode and the losses on the JAX forward's outputs
    same = [{k: t(v).permute(0, 3, 1, 2) for k, v in jp.items()}
            for jp in jpreds]
    gt = gt_boxes(rng, 2, 6)
    labels = rng.randint(0, 3, (2, 6))
    valid = rng.rand(2, 6) > 0.2
    want, jboxes = jax.jit(lambda v, p, *g: (
        jhead.apply(v, p, *g, method=JaxCenterHead.loss),
        jhead.apply(v, p, method=JaxCenterHead.get_bboxes)))(
        variables, jpreds, *(jnp.asarray(a) for a in (gt, labels, valid)))
    got = head.loss(same, t(gt), t(labels), t(valid))
    assert sorted(got) == sorted(want)
    for key in want:
        close(got[key], want[key], 1e-5)
    want = jboxes
    got = head.get_bboxes(same)
    for key in ('scores', 'labels', 'valid'):
        equal(got[key], want[key])
    close(got['bboxes'], want['bboxes'])
    assert 0 < int(got['valid'].sum()) < got['valid'].numel()


ANCHOR = dict(
    num_classes=3, in_channels=12, feat_channels=12,
    anchor_generator=dict(
        type='AlignedAnchor3DRangeGenerator',
        ranges=[[-4.8, -4.8, -1.8, 4.8, 4.8, -1.8],
                [-4.8, -4.8, -1.7, 4.8, 4.8, -1.7],
                [-4.8, -4.8, -0.6, 4.8, 4.8, -0.6]],
        sizes=[[1.6, 3.9, 1.56], [2.5, 6.7, 2.7], [0.6, 0.8, 1.7]],
        custom_values=[0, 0], rotations=[0, 1.57]),
    bbox_coder=dict(type='DeltaXYZWLHRBBoxCoder', code_size=9),
    loss_cls=dict(type='FocalLoss', gamma=2.0, alpha=0.25, loss_weight=1.0),
    loss_bbox=dict(type='SmoothL1Loss', beta=0.111, loss_weight=2.0),
    loss_dir=dict(type='CrossEntropyLoss', loss_weight=0.2),
    train_cfg=dict(pos_iou_thr=0.5, neg_iou_thr=0.35, min_pos_iou=0.2,
                   code_weight=[1.0] * 7 + [0.25, 0.25]),
    test_cfg=dict(nms_pre=120, nms_thr=0.2, score_thr=0.05, max_num=40))
HEADS = {'Anchor3DHead': (JaxAnchorHead, Anchor3DHead, {}),
         'FreeAnchor3DHead': (JaxFreeAnchor, FreeAnchor3DHead,
                              dict(pre_anchor_topk=10, bbox_thr=0.3))}


def anchor_rules():
    rules, add = new_rules()
    for name in ('conv_cls', 'conv_reg', 'conv_dir_cls'):
        add(name, name, 'conv2d')
    return rules


@pytest.mark.parametrize('name', sorted(HEADS))
def test_anchor_heads_match_jax(name):
    jcls, tcls, extra = HEADS[name]
    rng = np.random.RandomState(9)
    x = rng.randn(1, 12, 12, 12).astype(np.float32)
    jhead = jcls(**ANCHOR, **extra)
    variables = jax_variables(jhead, rng, jnp.asarray(x))
    head = tcls(**ANCHOR, **extra)
    head.load_state_dict(from_jax_variables(variables, anchor_rules()))
    jpreds = jax.jit(lambda v, x: jhead.apply(v, x))(variables,
                                                     jnp.asarray(x))
    preds = head(t(x).permute(0, 3, 1, 2))
    for key in jpreds:
        close(preds[key].permute(0, 2, 3, 1), jpreds[key])
    same = {k: t(v).permute(0, 3, 1, 2) for k, v in jpreds.items()}
    gt = gt_boxes(rng, 1, 5)
    gt[..., 3:6] = [2.5, 6.7, 2.7]                   # near an anchor size
    labels = rng.randint(0, 3, (1, 5))
    valid = np.array([[True, True, True, True, False]])
    want, jboxes = jax.jit(lambda v, p, *g: (
        jhead.apply(v, p, *g, method=jcls.loss),
        jhead.apply(v, p, method=jcls.get_bboxes)))(
        variables, jpreds, *(jnp.asarray(a) for a in (gt, labels, valid)))
    got = head.loss(same, t(gt), t(labels), t(valid))
    assert sorted(got) == sorted(want)
    for key in want:
        close(got[key], want[key], 1e-5)
    want = jboxes
    got = head.get_bboxes(same)
    for key in ('scores', 'labels', 'valid'):
        equal(got[key], want[key])
    close(got['boxes'], want['boxes'])
    assert 0 < int(got['valid'].sum())


TC = dict(pos_iou_thr=0.99, neg_iou_thr=0.3, min_pos_iou=0.1)


@jax.jit
def jax_assign(anc_bev, gt_bev, valid):
    """The JAX head's ``assign_one`` (``anchor3d_head.py:91-110``) under
    ``vmap``, as the head's loss calls it, over a batch of one."""
    return jax.vmap(lambda g, v: assign_one(anc_bev, g, v, TC))(
        gt_bev[None], valid[None])


def assign_one(anc_bev, gt_bev, valid, tc):
    m = anc_bev.shape[0]
    iou = jnp.where(valid[None, :], jiou(anc_bev, gt_bev), -1.0)
    max_iou, argmax = jnp.max(iou, axis=1), jnp.argmax(iou, axis=1)
    pos = max_iou >= tc['pos_iou_thr']
    neg = (max_iou < tc['neg_iou_thr']) & (max_iou >= 0)
    best_anchor = jnp.argmax(iou, axis=0)
    force = jnp.zeros((m,), bool).at[best_anchor].set(
        valid & (jnp.max(iou, axis=0) > tc['min_pos_iou']))
    forced_gt = jnp.zeros((m,), jnp.int32).at[best_anchor].set(
        jnp.arange(gt_bev.shape[0], dtype=jnp.int32))
    pos = pos | force
    return jnp.where(force, forced_gt, argmax), pos, neg & ~pos


@pytest.mark.parametrize('case', ['shared', 'padded_after_anchor_0'])
def test_duplicate_best_anchor_matches_jax(case, monkeypatch):
    gen = tanchors.Anchor3DRangeGenerator(
        ranges=[[0, 0, -1, 4, 4, -1]], sizes=[[1.6, 3.9, 1.56]],
        rotations=[0, 1.57])
    anchors = gen.grid_anchors((4, 4)).reshape(-1, 7)
    anc_bev = anchors[:, [0, 1, 3, 4, 6]]
    if case == 'shared':
        # boxes 1 and 3 are the same box: they share their best anchor
        gt = anc_bev[[5, 9, 2, 9]] + np.float32([0.05, 0, 0, 0, 0])
        valid = np.array([True, True, True, True])
    else:
        # box 0's best anchor is anchor 0; padded boxes follow it
        gt = anc_bev[[0, 0, 0, 0]] + np.float32([0.3, -0.2, 0, 0, 0.1])
        valid = np.array([True, False, False, False])
    want = jax_assign(jnp.asarray(anc_bev), jnp.asarray(gt),
                      jnp.asarray(valid))
    monkeypatch.setattr('msmdfusion_torch.models.heads.anchor3d_head.'
                        'ASSIGN_PAIRS', 5)        # chunks of a few anchors
    got = assign(t(anc_bev), t(gt), t(valid), TC['pos_iou_thr'],
                 TC['neg_iou_thr'], TC['min_pos_iou'])
    for g, w in zip(got, want):
        equal(g, w[0])
    best = int(tiou(t(anc_bev), t(gt))[:, 0 if case != 'shared' else 3]
               .argmax())
    if case == 'shared':
        assert int(got[0][best]) == 3 and bool(got[1][best])
    else:
        assert best == 0 and not bool(got[1][0])   # the padded box's write
