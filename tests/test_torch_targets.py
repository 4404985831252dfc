"""Port detection targets and losses vs the JAX package on the CPU.

Seeded numpy inputs through the JAX functions and the port's:
``auction_assign`` and ``assign_proposals`` (equal, ties included: the
same Jacobi bids and tie-breaks), ``boxes_iou_3d``, ``draw_heatmap``,
the losses, ``TransFusionBBoxCoder.encode`` and the head's
``get_targets`` (assignment equal, targets to 1e-5: the same fp32
arithmetic in another library).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from msmdfusion_tpu.core import coders as jcoders
from msmdfusion_tpu.core import gaussian as jgaussian
from msmdfusion_tpu.core.iou3d import boxes_iou_3d as jax_iou
from msmdfusion_tpu.models import losses as jlosses
from msmdfusion_tpu.models.heads.transfusion_head import \
    TransFusionHead as JaxHead
from msmdfusion_tpu.ops import matching as jmatching

from msmdfusion_torch.core import gaussian
from msmdfusion_torch.core.coders import TransFusionBBoxCoder
from msmdfusion_torch.core.iou3d import boxes_iou_3d
from msmdfusion_torch.models import losses
from msmdfusion_torch.models.heads.transfusion_head import TransFusionHead
from msmdfusion_torch.ops import matching

TOL = 1e-5
PCR = [-54.0, -54.0, -5.0, 54.0, 54.0, 3.0]
VOX = [0.6, 0.6, 0.2]
CODER = dict(type='TransFusionBBoxCoder', pc_range=PCR[:2],
             voxel_size=VOX[:2], out_size_factor=8,
             post_center_range=[-61.2, -61.2, -10.0, 61.2, 61.2, 10.0],
             score_threshold=0.0, code_size=10)


def t(x):
    return torch.from_numpy(np.asarray(x))


def random_boxes(rng, n, spread=10.0):
    """[n, 9] bottom-centre boxes with yaw and velocity."""
    return np.concatenate([
        rng.uniform(-spread, spread, (n, 2)), rng.uniform(-2, 0, (n, 1)),
        rng.uniform(0.5, 4.0, (n, 3)), rng.uniform(-np.pi, np.pi, (n, 1)),
        rng.normal(0, 1, (n, 2))], 1).astype(np.float32)


@pytest.mark.parametrize('seed,ties', [(0, False), (1, False), (2, True)])
def test_auction_assign_equals_jax(seed, ties):
    rng = np.random.RandomState(seed)
    r, c = 40, 12
    cost = rng.uniform(0, 5, (r, c)).astype(np.float32)
    if ties:                         # few distinct values: ties everywhere
        cost = np.round(cost).astype(np.float32)
    valid = rng.rand(c) < 0.8
    cost = np.where(valid[None, :], cost, 1e8).astype(np.float32)
    want = np.asarray(jmatching.auction_assign(jnp.asarray(cost),
                                               jnp.asarray(valid)))
    got = matching.auction_assign(t(cost), t(valid)).numpy()
    np.testing.assert_array_equal(got, want)
    rows = got[valid]
    assert (rows >= 0).all() and len(set(rows.tolist())) == len(rows)
    np.testing.assert_array_equal(
        matching.assign_proposals(t(cost), t(valid)).numpy(),
        np.asarray(jmatching.assign_proposals(jnp.asarray(cost),
                                              jnp.asarray(valid))))


def test_boxes_iou_3d_matches_jax():
    rng = np.random.RandomState(3)
    a, b = random_boxes(rng, 30, 3.0), random_boxes(rng, 20, 3.0)
    b[:5] = a[:5]                                    # identical pairs
    want = np.asarray(jax_iou(jnp.asarray(a[:, :7]), jnp.asarray(b[:, :7])))
    got = boxes_iou_3d(t(a[:, :7]), t(b[:, :7])).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(np.diag(got[:5, :5]), 1.0, atol=1e-4)
    assert (got > 0).sum() > 20
    np.testing.assert_allclose(
        boxes_iou_3d(t(a[:, :7]), t(b[:, :7]), mode='iof').numpy(),
        np.asarray(jax_iou(jnp.asarray(a[:, :7]), jnp.asarray(b[:, :7]),
                           mode='iof')), rtol=TOL, atol=TOL)


def test_draw_heatmap_matches_jax():
    rng = np.random.RandomState(4)
    g, c, shape = 9, 10, (40, 48)
    centers = rng.randint(-3, 50, (g, 2)).astype(np.int32)
    size = rng.uniform(1, 12, (2, g)).astype(np.float32)
    radius = np.maximum(2, np.asarray(jgaussian.gaussian_radius(
        jnp.asarray(size), 0.1)).astype(np.int32)).astype(np.float32)
    np.testing.assert_allclose(
        gaussian.gaussian_radius(t(size), 0.1).numpy(),
        np.asarray(jgaussian.gaussian_radius(jnp.asarray(size), 0.1)),
        rtol=TOL)
    labels = rng.randint(0, c, g).astype(np.int32)
    valid = rng.rand(g) < 0.8
    want = np.asarray(jgaussian.draw_heatmap(
        jnp.asarray(centers), jnp.asarray(radius), jnp.asarray(labels),
        jnp.asarray(valid), c, shape))
    got = gaussian.draw_heatmap(t(centers), t(radius), t(labels), t(valid),
                                c, shape).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=1e-7)
    assert (got == 1.0).sum() > 0


def test_losses_match_jax():
    rng = np.random.RandomState(5)
    logits = rng.normal(0, 3, (64, 10)).astype(np.float32)
    labels = rng.randint(0, 11, 64).astype(np.int32)    # 10 = background
    np.testing.assert_allclose(
        losses.sigmoid_focal_loss(t(logits), t(labels), 10).numpy(),
        np.asarray(jlosses.sigmoid_focal_loss(jnp.asarray(logits),
                                              jnp.asarray(labels), 10)),
        rtol=TOL, atol=1e-7)
    pred = losses.clip_sigmoid(t(logits))
    np.testing.assert_allclose(
        pred.numpy(), np.asarray(jlosses.clip_sigmoid(jnp.asarray(logits))),
        rtol=TOL)
    target = np.where(rng.rand(64, 10) < 0.05, 1.0,
                      rng.uniform(0, 1, (64, 10))).astype(np.float32)
    np.testing.assert_allclose(
        losses.gaussian_focal_loss(pred, t(target)).numpy(),
        np.asarray(jlosses.gaussian_focal_loss(jnp.asarray(pred.numpy()),
                                               jnp.asarray(target))),
        rtol=TOL, atol=1e-7)
    np.testing.assert_array_equal(
        losses.l1_loss(t(logits), t(target)).numpy(),
        np.asarray(jlosses.l1_loss(jnp.asarray(logits),
                                   jnp.asarray(target))))


def test_encode_matches_jax():
    boxes = random_boxes(np.random.RandomState(6), 25, 50.0)
    cfg = {k: v for k, v in CODER.items() if k != 'type'}
    want = np.asarray(jcoders.TransFusionBBoxCoder(**cfg).encode(
        jnp.asarray(boxes)))
    got = TransFusionBBoxCoder(**cfg).encode(t(boxes)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert got.shape == (25, 10)


HEAD = dict(
    num_proposals=20, auxiliary=True, in_channels=16, hidden_channel=16,
    num_classes=10, num_decoder_layers=1, num_heads=2, nms_kernel_size=3,
    ffn_channel=32, dropout=0.0,
    common_heads=dict(center=(2, 2), height=(1, 2), dim=(3, 2), rot=(2, 2),
                      vel=(2, 2)),
    bbox_coder=CODER,
    train_cfg=dict(
        dataset='nuScenes',
        assigner=dict(cls_cost=dict(gamma=2, alpha=0.25, weight=0.15),
                      reg_cost=dict(weight=0.25),
                      iou_cost=dict(weight=0.25)),
        gaussian_overlap=0.1, min_radius=2, grid_size=[180, 180, 40],
        voxel_size=VOX, out_size_factor=8,
        code_weights=[1.0] * 8 + [0.2, 0.2], point_cloud_range=PCR),
    test_cfg=dict(dataset='nuScenes', grid_size=[180, 180, 40],
                  out_size_factor=8, pc_range=PCR[:2], voxel_size=VOX[:2],
                  nms_type=None))


def test_get_targets_match_jax():
    """Proposals scattered around the ground truth, so that some are
    matched with a real IoU and the auction has work to do."""
    rng = np.random.RandomState(7)
    b, p, g = 2, HEAD['num_proposals'], 8
    gt = np.stack([random_boxes(rng, g, 40.0) for _ in range(b)])
    valid = rng.rand(b, g) < 0.8
    labels = rng.randint(0, 10, (b, g)).astype(np.int32)
    near = gt[:, rng.randint(0, g, p)]
    cell = 8 * 0.6
    preds = dict(
        heatmap=rng.normal(-2, 1, (b, 10, p)),
        center=((near[..., :2] + rng.normal(0, 0.5, (b, p, 2)) - PCR[0])
                / cell).transpose(0, 2, 1),
        height=(near[..., 2:3] + near[..., 5:6] / 2).transpose(0, 2, 1),
        dim=np.log(near[..., 3:6] * rng.uniform(0.8, 1.2, (b, p, 3)))
        .transpose(0, 2, 1),
        rot=np.stack([np.sin(near[..., 6]), np.cos(near[..., 6])], 1),
        vel=near[..., 7:9].transpose(0, 2, 1))
    preds = {k: v.astype(np.float32) for k, v in preds.items()}
    jhead = JaxHead(**{k: v for k, v in HEAD.items()})
    want = jhead.apply({}, {k: jnp.asarray(v) for k, v in preds.items()},
                       jnp.asarray(gt), jnp.asarray(labels),
                       jnp.asarray(valid), method=JaxHead.get_targets)
    head = TransFusionHead(**HEAD)
    got = head.get_targets({k: t(v) for k, v in preds.items()}, t(gt),
                           t(labels), t(valid))
    names = ('labels', 'label_weights', 'bbox_targets', 'bbox_weights',
             'num_pos', 'matched_ious', 'heatmap')
    for name, x, y in zip(names, got, want):
        if name in ('labels', 'num_pos', 'bbox_weights'):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y), name)
        else:
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=TOL,
                                       atol=TOL, err_msg=name)
    assert int(got[4]) == int(valid.sum())
    assert float(got[5]) > 0.1
