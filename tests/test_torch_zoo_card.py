"""The single-stage zoo's voxelization, segment reduce, top K and NMS on an
NVIDIA card against the same functions on the CPU:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_zoo_card.py

- ``hard_voxelize``, ``voxelize_batch``, ``dynamic_scatter`` (mean and
  max) and ``scatter_v2`` on 40,000 clustered points with caps that
  overflow: slots, coords, counts and overflow counts equal; the maxima
  equal; the means within 1e-6 relative (each voxel's points summed in
  point order on both); two card runs bit-equal.
- ``topk_lower_index`` with ties equal to the CPU's.
- ``nms_bev``, ``circle_nms``, ``box3d_multiclass_nms`` and
  ``aligned_3d_nms`` at the zoo's sizes (1,000 candidates, ten classes;
  500 a task): the same keep set and order as on the CPU, on inputs where
  no pair's IoU or distance lies within ``MARGIN`` of its threshold
  (asserted on the CPU's values).
- The anchor assignment with shared best anchors, chunked, equal.

Without a card every test skips. No JAX here: the machine with the card
runs the port alone.
"""
import math

import numpy as np
import pytest
import torch

from msmdfusion_torch.core import nms
from msmdfusion_torch.core.coders import topk_lower_index
from msmdfusion_torch.core.iou3d import boxes_iou_bev
from msmdfusion_torch.models.heads.anchor3d_head import assign
from msmdfusion_torch.ops import scatter, voxelize
from msmdfusion_torch.utils import overflow

PCR = [0.0, -40.0, -3.0, 70.4, 40.0, 1.0]
VOX = [0.05, 0.05, 0.1]
MARGIN = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card: the zoo runs there on CUDA')
    return torch.device('cuda')


def cloud(rng, n=40000, centres=3000):
    c = rng.uniform(np.array(PCR[:3]), np.array(PCR[3:]), (centres, 3))
    xyz = c[rng.randint(0, centres, n)] + rng.normal(0, 0.05, (n, 3))
    xyz[: n // 50] += 100.0                             # out of range
    pts = np.concatenate([xyz, rng.rand(n, 1)], 1).astype(np.float32)
    return torch.from_numpy(pts), torch.from_numpy(rng.rand(n) > 0.05)


def both(fn, *args):
    """(CPU result, counts), (card result, counts), card again."""
    out = []
    for dev in ('cpu', 'cuda', 'cuda'):
        moved = [a.to(dev) if torch.is_tensor(a) else a for a in args]
        with overflow.capture() as cap:
            res = fn(*moved)
        res = [r.cpu() for r in res]
        out.append((res, cap.counters()))
    return out


def held(cpu, gpu, again, means=()):
    (c, cc), (g, gc), (a, _) = cpu, gpu, again
    assert cc == gc
    for i, (x, y, z) in enumerate(zip(c, g, a)):
        assert torch.equal(y, z), i                     # two card runs
        if i in means:
            torch.testing.assert_close(y, x, rtol=1e-6, atol=1e-6)
        else:
            assert torch.equal(y, x), i


@pytest.mark.cuda
@pytest.mark.parametrize('max_points,max_voxels', [(5, 40000), (2, 9000)])
def test_hard_voxelize_on_card(card, max_points, max_voxels):
    pts, mask = cloud(np.random.RandomState(max_voxels))
    runs = both(voxelize.hard_voxelize, pts, mask, VOX, PCR, max_points,
                max_voxels)
    held(*runs)
    if max_voxels == 9000:
        assert runs[0][1]['voxelize.hard.voxel_cap'] > 0
    b = both(voxelize.voxelize_batch, torch.stack([pts, pts.flip(0)]),
             torch.stack([mask, mask.flip(0)]), VOX, PCR, max_points,
             max_voxels)
    held(*b)


@pytest.mark.cuda
@pytest.mark.parametrize('mode,max_voxels', [('mean', 40000), ('max', 40000),
                                             ('mean', 9000)])
def test_dynamic_scatter_on_card(card, mode, max_voxels):
    pts, mask = cloud(np.random.RandomState(3))
    coords, valid = voxelize.dynamic_voxelize(pts, mask, VOX, PCR)
    grid = voxelize.grid_shape(VOX, PCR)
    runs = both(voxelize.dynamic_scatter, pts * 7 - 3, coords, valid, grid,
                max_voxels, mode)
    held(*runs, means=(0,) if mode == 'mean' else ())


@pytest.mark.cuda
@pytest.mark.parametrize('mode', ['max', 'mean', 'sum'])
def test_scatter_v2_on_card(card, mode):
    rng = np.random.RandomState(4)
    feats = torch.from_numpy(rng.randn(50000, 8).astype(np.float32))
    ids = torch.from_numpy(rng.randint(-5, 5000, 50000))
    valid = torch.from_numpy(rng.rand(50000) > 0.1)
    held(*both(lambda *a: scatter.scatter_v2(*a[:3], mode, a[3]), feats,
               ids, 4000, valid), means=(0,) if mode != 'max' else ())


@pytest.mark.cuda
def test_topk_ties_on_card(card):
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randint(0, 50, (3, 560000)).astype(np.float32))
    for k in (25, 1000):
        v, i = topk_lower_index(x, k)
        gv, gi = topk_lower_index(x.to(card), k)
        assert torch.equal(gv.cpu(), v) and torch.equal(gi.cpu(), i)


def separated(rng, n, thresh, spread=60.0):
    ctr = rng.uniform(-spread, spread, (n // 3, 2))
    b = np.concatenate([ctr[rng.randint(0, len(ctr), n)]
                        + rng.normal(0, 0.8, (n, 2)),
                        rng.uniform(0.5, 4.5, (n, 2)),
                        rng.uniform(-math.pi, math.pi, (n, 1))], 1)
    b = torch.from_numpy(b.astype(np.float32))
    iou = boxes_iou_bev(b, b)
    near = ((iou - thresh).abs() < MARGIN) & ~torch.eye(n, dtype=torch.bool)
    return b[~near.any(1)]                  # every box of a near pair goes


@pytest.mark.cuda
def test_nms_bev_and_multiclass_on_card(card):
    rng = np.random.RandomState(6)
    bev = separated(rng, 1100, 0.2)[:1000]
    n = bev.shape[0]
    scores = torch.from_numpy(rng.rand(n).astype(np.float32))
    k, o = nms.nms_bev(bev, scores, 0.2, post_max_size=83)
    gk, go = nms.nms_bev(bev.to(card), scores.to(card), 0.2,
                         post_max_size=83)
    assert torch.equal(go.cpu(), o) and torch.equal(gk.cpu(), k)
    boxes = torch.cat([bev[:, :2], torch.zeros(n, 1), bev[:, 2:4],
                       torch.ones(n, 1), bev[:, 4:]], 1)
    cls = torch.from_numpy(rng.rand(n, 10).astype(np.float32))
    want = nms.box3d_multiclass_nms(boxes, bev, cls, 0.05, 0.2, 500)
    got = nms.box3d_multiclass_nms(boxes.to(card), bev.to(card),
                                   cls.to(card), 0.05, 0.2, 500)
    for key in want:
        assert torch.equal(got[key].cpu(), want[key]), key
    assert 0 < int(want['valid'].sum())


@pytest.mark.cuda
def test_circle_and_aligned_nms_on_card(card):
    rng = np.random.RandomState(7)
    ctr = torch.from_numpy(rng.uniform(-50, 50, (6, 500, 2)).astype(
        np.float32))
    d2 = ((ctr[:, :, None] - ctr[:, None]) ** 2).sum(-1)
    radius = 4.0
    assert float((d2 - radius * radius).abs().min()) > MARGIN
    scores = torch.from_numpy(rng.rand(6, 500).astype(np.float32))
    valid = torch.from_numpy(rng.rand(6, 500) > 0.1)
    k, o = nms.circle_nms(ctr, scores, radius, valid, 83)
    gk, go = nms.circle_nms(ctr.to(card), scores.to(card), radius,
                            valid.to(card), 83)
    assert torch.equal(go.cpu(), o) and torch.equal(gk.cpu(), k)
    lo = torch.from_numpy(rng.uniform(-20, 20, (400, 3)).astype(np.float32))
    box6 = torch.cat([lo, lo + torch.from_numpy(
        rng.uniform(0.5, 3, (400, 3)).astype(np.float32))], 1)
    classes = torch.from_numpy(rng.randint(0, 3, 400))
    lo_, hi_ = torch.maximum(box6[:, None, :3], box6[None, :, :3]), \
        torch.minimum(box6[:, None, 3:], box6[None, :, 3:])
    inter = (hi_ - lo_).clamp(min=0).prod(-1)
    vol = (box6[:, 3:] - box6[:, :3]).prod(-1)
    iou = inter / (vol[:, None] + vol[None, :] - inter)
    assert float((iou - 0.25).abs().min()) > MARGIN
    k, o = nms.aligned_3d_nms(box6, scores[0, :400], classes, 0.25)
    gk, go = nms.aligned_3d_nms(box6.to(card), scores[0, :400].to(card),
                                classes.to(card), 0.25)
    assert torch.equal(go.cpu(), o) and torch.equal(gk.cpu(), k)


@pytest.mark.cuda
def test_assignment_on_card(card, monkeypatch):
    from msmdfusion_torch.core.anchors import Anchor3DRangeGenerator
    gen = Anchor3DRangeGenerator(
        ranges=[[0, -40, -0.6, 70.4, 40, -0.6]], sizes=[[1.6, 3.9, 1.56]],
        rotations=[0, 1.57])
    anchors = torch.from_numpy(gen.grid_anchors((100, 88)).reshape(-1, 7))
    anc_bev = anchors[:, [0, 1, 3, 4, 6]]
    rng = np.random.RandomState(8)
    gt = anc_bev[torch.from_numpy(rng.randint(0, len(anc_bev), 12))]
    gt = torch.cat([gt, gt[:3]])                    # shared best anchors
    gt[:, :2] += torch.from_numpy(rng.normal(0, 0.1, (15, 2)).astype(
        np.float32))
    valid = torch.ones(15, dtype=torch.bool)
    valid[-2:] = False
    monkeypatch.setattr('msmdfusion_torch.models.heads.anchor3d_head.'
                        'ASSIGN_PAIRS', 2 ** 14)
    want = assign(anc_bev, gt, valid, 0.6, 0.45, 0.45)
    got = assign(anc_bev.to(card), gt.to(card), valid.to(card), 0.6, 0.45,
                 0.45)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
