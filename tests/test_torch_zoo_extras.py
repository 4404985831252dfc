"""The zoo's config-unused modules and a repair of the pillar scatter, port
vs the JAX package, on the CPU.

- ``ShapeAwareHead`` (two shape groups, one of them strided) on seeded
  weights: the training-mode forward, its losses (the max-IoU assignment
  over the groups' concatenated anchors) and the decode of its outputs,
  within ``TOL`` of each output's largest value, the labels and the kept
  set equal; the eval forward too. One jitted JAX function.
- ``FPNC`` (with and without ``adp``: levels shrunk with the antialiased
  triangle kernel and grown) and ``SCConv`` (a strided segment, a padded
  self-calibration pool, a transposed up-projection) in eval and training
  mode, within ``TOL``.
- ``PointPillarsScatter`` where several valid rows share a cell (a grid
  with more than one z level, as the tiny MVXNet's): the canvas equal to
  the JAX scatter's (the last row's features) and the gradient of every
  row against ``jax.grad`` (the last row's alone, the others zero).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import msmdfusion_tpu.models  # noqa: F401
from msmdfusion_tpu.models.heads.shape_aware_head import \
    ShapeAwareHead as JaxShapeAware
from msmdfusion_tpu.models.middle_encoders.pillar_scatter import \
    PointPillarsScatter as JaxScatter
from msmdfusion_tpu.models.necks import extra_necks as jnecks

import msmdfusion_torch.models  # noqa: F401
from msmdfusion_torch.models.heads.shape_aware_head import ShapeAwareHead
from msmdfusion_torch.models.middle_encoders.pillar_scatter import \
    PointPillarsScatter
from msmdfusion_torch.models.necks import extra_necks as tnecks
from msmdfusion_torch.utils.convert import (fpnc_rules, new_rules,
                                            scconv_rules,
                                            shape_aware_head_rules)
from tests.test_torch_parta2 import port_state, seeded_variables
from tests.test_torch_zoo_detectors import close
from tests.torch_threads import one_thread  # noqa: F401

TOL = 1e-4
SHAPE_AWARE = dict(
    num_classes=3, in_channels=8,
    tasks=[dict(num_class=2, shared_conv_channels=(8,),
                shared_conv_strides=(1,)),
           dict(num_class=1, shared_conv_channels=(8, 8),
                shared_conv_strides=(2, 1))],
    anchor_generator=dict(
        type='Anchor3DRangeGenerator',
        ranges=[[-6.4, -6.4, -1.8, 6.4, 6.4, -1.8],
                [-6.4, -6.4, -1.2, 6.4, 6.4, -1.2],
                [-6.4, -6.4, -0.6, 6.4, 6.4, -0.6]],
        sizes=[[0.6, 0.8, 1.7], [0.6, 1.76, 1.73], [1.9, 4.7, 1.7]],
        rotations=[0, 1.57]),
    bbox_coder=dict(type='DeltaXYZWLHRBBoxCoder', code_size=7),
    loss_cls=dict(gamma=2.0, alpha=0.25, loss_weight=1.0),
    loss_bbox=dict(beta=0.111, loss_weight=2.0),
    loss_dir=dict(loss_weight=0.2),
    train_cfg=dict(pos_iou_thr=0.5, neg_iou_thr=0.35, min_pos_iou=0.3),
    test_cfg=dict(nms_pre=60, nms_thr=0.5, score_thr=0.05, max_num=20))


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_shape_aware_head_matches_jax(one_thread):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 16, 16, 8).astype(np.float32)
    jh = JaxShapeAware(**SHAPE_AWARE)
    variables = seeded_variables(lambda k, a: jh.init(k, a), rng,
                                 jnp.asarray(x))
    gt = np.zeros((2, 3, 7), np.float32)
    gt[..., :2] = rng.uniform(-5, 5, (2, 3, 2))
    gt[..., 2], gt[..., 6] = -1.5, rng.uniform(-3, 3, (2, 3))
    gt[..., 3:6] = [[0.6, 0.8, 1.7], [0.6, 1.76, 1.73], [1.9, 4.7, 1.7]]
    gl = np.array([[0, 1, 2], [2, 2, 0]], np.int32)
    gv = np.array([[1, 1, 1], [1, 0, 1]], bool)

    @jax.jit
    def run(variables, x, *gts):
        preds, _ = jh.apply(variables, x, train=True, mutable=['batch_stats'])
        return (jh.apply(variables, x), preds,
                jh.apply(variables, preds, *gts, method=JaxShapeAware.loss),
                jh.apply(variables, preds, method=JaxShapeAware.get_bboxes))
    jeval, jpreds, jloss, jdet = run(variables, jnp.asarray(x),
                                     *map(jnp.asarray, (gt, gl, gv)))
    rules, add = new_rules()
    shape_aware_head_rules(add, SHAPE_AWARE, 'head', 'head')
    th = ShapeAwareHead(**SHAPE_AWARE)
    th.load_state_dict(port_state(
        {'params': {'head': variables['params']},
         'batch_stats': {'head': variables['batch_stats']}}, rules, 'head'))
    xt = t(x).permute(0, 3, 1, 2)
    th.eval()
    with torch.no_grad():
        evals = th(xt)
    th.train()
    preds = th(xt)
    assert preds['featmap_sizes'] == ((16, 16), (8, 8))
    for key in ('cls_score', 'bbox_pred', 'dir_cls'):
        close(evals[key], jeval[key])
        close(preds[key], jpreds[key])
    losses = th.loss(preds, t(gt), t(gl), t(gv))
    assert sorted(losses) == sorted(jloss)
    for key in jloss:
        close(losses[key], jloss[key])
    with torch.no_grad():
        det = th.get_bboxes(preds)
    for key in ('labels', 'valid'):
        np.testing.assert_array_equal(det[key].numpy(), np.asarray(jdet[key]))
    assert int(det['valid'].sum()) > 0
    close(det['boxes'], jdet['boxes'])
    close(det['scores'], jdet['scores'])


def neck_case(kind, use_adp, rng):
    if kind == 'FPNC':
        cfg = dict(in_channels=(4, 8, 8, 8), out_channels=4, num_outs=5,
                   final_dim=(64, 96), downsample=4, use_adp=use_adp,
                   outC=6)
        feats = [rng.randn(2, 32 // 2 ** i, 48 // 2 ** i, c).astype(
            np.float32) for i, c in enumerate(cfg['in_channels'])]
        return cfg, feats, jnecks.FPNC, tnecks.FPNC, fpnc_rules
    cfg = dict(num_input_features=8, num_proj_features=4,
               chn_per_segment=(8, 8), blocks_per_segment=(1, 2),
               ds_rates=(1, 2), us_rates=(1, 2), ds_paddings=(0, 1))
    feats = rng.randn(2, 16, 16, 8).astype(np.float32)
    return cfg, feats, jnecks.SCConv, tnecks.SCConv, scconv_rules


@pytest.mark.parametrize('case', ['FPNC', 'FPNC adp', 'SCConv'])
def test_extra_necks_match_jax(case, one_thread):
    rng = np.random.RandomState(1)
    cfg, feats, jcls, tcls, rules_of = neck_case(case.split()[0],
                                                 case.endswith('adp'), rng)
    jm = jcls(**cfg)
    jin = ([jnp.asarray(f) for f in feats] if isinstance(feats, list)
           else jnp.asarray(feats))
    variables = seeded_variables(jm.init, rng, jin)

    @jax.jit
    def run(variables, x):
        return (jm.apply(variables, x),
                jm.apply(variables, x, train=True,
                         mutable=['batch_stats'])[0])
    jeval, jtrain = run(variables, jin)
    rules, add = new_rules()
    rules_of(add, cfg, 'neck', 'neck')
    tm = tcls(**cfg)
    tm.load_state_dict(port_state(
        {'params': {'neck': variables['params']},
         'batch_stats': {'neck': variables['batch_stats']}}, rules, 'neck'))
    tin = ([t(f).permute(0, 3, 1, 2) for f in feats]
           if isinstance(feats, list) else t(feats).permute(0, 3, 1, 2))
    for train, want in ((False, jeval), (True, jtrain)):
        tm.train(train)
        with torch.no_grad():
            got = tm(tin)
        if isinstance(got, list):
            assert len(got) == len(want) == 1
            got, want = got[0], want[0]
        close(got.permute(0, 2, 3, 1), want)


def test_resize_matches_jax_image_resize():
    """The necks' resizes (``F.interpolate``: bilinear with antialias,
    nearest-exact) against ``jax.image.resize``, shrinking and growing."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 3, 9, 14).astype(np.float32)
    for size in ((4, 5), (9, 28), (20, 7), (3, 30), (9, 14)):
        for method, fn in (('bilinear', tnecks.resize_bilinear),
                           ('nearest', tnecks.resize_nearest)):
            want = jax.image.resize(jnp.asarray(x), (2, 3) + size, method)
            close(fn(t(x), size), want, 1e-5)


def test_pillar_scatter_repeated_cells_match_jax():
    rng = np.random.RandomState(3)
    k, c = 60, 5
    coors = np.stack([rng.randint(0, 2, k), rng.randint(0, 4, k),
                      rng.randint(0, 3, k), rng.randint(0, 4, k)],
                     -1).astype(np.int32)
    valid = rng.rand(k) > 0.1
    coors[~valid] = -1
    feats = rng.randn(k, c).astype(np.float32)
    weight = rng.randn(2, 3, 4, c).astype(np.float32)
    cells = coors[valid][:, [0, 2, 3]]
    assert len(np.unique(cells, axis=0)) < len(cells)     # repeated cells
    jm = JaxScatter(in_channels=c, output_shape=(3, 4))

    def f(x):
        out = jm.apply({}, x, jnp.asarray(coors), jnp.asarray(valid), 2)
        return (out * weight).sum(), out
    (_, want), grad = jax.value_and_grad(f, has_aux=True)(jnp.asarray(feats))
    x = t(feats).requires_grad_()
    out = PointPillarsScatter(c, (3, 4))(x, t(coors), t(valid), 2)
    np.testing.assert_array_equal(out.permute(0, 2, 3, 1).detach().numpy(),
                                  np.asarray(want))
    (out.permute(0, 2, 3, 1) * t(weight)).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(grad))
    assert (x.grad.abs().sum(1) == 0).sum() > (~valid).sum()
