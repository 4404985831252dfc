"""``chip_smoke.py``'s twin checks on the CPU.

The twin is the plain path's forward that replays the kernel path's
rounding and decodes its proposals. ``PinnedProposals`` keeps the given
cells through the head's local-max NMS. ``check_proposals`` takes a kernel
heatmap within TOL of the plain one, with a near-tie at the NMS or at the
top-P cut, and refuses one farther away or proposals that are not the
head's choice on it. ``compare_outputs`` holds a box's yaw through the
head's ``rot``. Last, the twin of a tiny TransFusion-L, where both paths
are the plain ones.
"""
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke as smoke
from msmdfusion_torch.models.heads import transfusion_head as th

C, H, W, P = 2, 10, 10, 3
# interior cells that stand above every neighbour of theirs
PEAKS = ((0, 2, 2), (0, 2, 6), (1, 5, 3), (1, 7, 7), (0, 7, 2), (1, 2, 7))


def head(flat=()):
    return SimpleNamespace(nms_kernel_size=3, num_proposals=P,
                           _flat_classes=lambda: flat)


def logits(seed):
    """[1, C, H, W] heatmap logits: noise below 0, and at ``PEAKS`` local
    maxima between 1 and 5."""
    rng = np.random.RandomState(seed)
    out = rng.uniform(-4, 0, (1, C, H, W))
    for c, y, x in PEAKS:
        out[0, c, y, x] = rng.uniform(1, 5)
    return torch.from_numpy(out.astype(np.float32))


def choice(dense):
    hm = th.local_maximum_nms(torch.sigmoid(dense), 3, ()).flatten(1)
    return th.topk_lower_index_first(hm, P)[1]


def flat(c, y, x):
    return (c * H + y) * W + x


def test_pinned_proposals_keep_their_cells_through_the_nms():
    hm = torch.sigmoid(logits(0))
    strict = th.local_maximum_nms(hm, 3, ())
    suppressed = int((strict[0, :, 1:-1, 1:-1] == 0).flatten()
                     .nonzero()[0])
    c, rest = divmod(suppressed, (H - 2) * (W - 2))
    cell = flat(c, 1 + rest // (W - 2), 1 + rest % (W - 2))
    kept = int(strict.flatten(1).argmax())
    index = torch.tensor([[cell, kept]])
    orig = th.local_maximum_nms, th.topk_lower_index_first
    with smoke.PinnedProposals(index):
        pinned = th.local_maximum_nms(hm, 3, ()).flatten(1)
        values, top = th.topk_lower_index_first(pinned, 2)
    assert (th.local_maximum_nms, th.topk_lower_index_first) == orig
    assert torch.equal(top, index)
    want = strict.flatten(1).clone()
    want[0, cell] = hm.flatten(1)[0, cell]
    assert torch.equal(pinned, want)
    assert torch.equal(values, hm.flatten(1)[:, [cell, kept]])


def tie(ref, at, by):
    """``ref`` with the logit at ``at`` set ``by`` above its neighbour's
    to the right (``by`` < 0: below it)."""
    out = ref.clone()
    c, y, x = at
    out[0, c, y, x] = out[0, c, y, x + 1] + by
    return out


def test_check_proposals_takes_a_near_tie_at_the_nms():
    # a cell above all others, its right neighbour a hair above it in the
    # plain heatmap and a hair below it in the kernel's: the plain NMS
    # suppresses the cell that the kernel path chooses
    ref = logits(1)
    ref[0, 0, 2, 3] = 6.0
    ref = tie(ref, (0, 2, 2), -1e-4)
    run = tie(ref, (0, 2, 2), 1e-4)
    index = choice(run)
    assert flat(0, 2, 2) in index and flat(0, 2, 3) not in index
    dist, excess, suppressed, differ = smoke.check_proposals(
        head(), index, dict(dense_heatmap=run), dict(dense_heatmap=ref))
    assert 0 < dist <= smoke.TOL
    assert suppressed == 1 and differ == 1
    # what the plain heatmap's own rule says: the chosen cell scores 0
    assert excess > 0.99


def test_check_proposals_takes_a_near_tie_at_the_cut():
    ref = logits(2)
    hm = th.local_maximum_nms(torch.sigmoid(ref), 3, ()).flatten(1)[0]
    order = hm.argsort(descending=True)
    inside, outside = int(order[P - 1]), int(order[P])
    assert hm[outside] > 0
    run = ref.clone().flatten(1)
    run[0, outside] = run[0, inside] + 1e-4
    run[0, inside] -= 1e-4
    ref = ref.clone().flatten(1)
    ref[0, outside] = ref[0, inside] - 1e-4
    run, ref = run.view(1, C, H, W), ref.view(1, C, H, W)
    index = choice(run)
    assert outside in index and inside not in index
    dist, excess, suppressed, differ = smoke.check_proposals(
        head(), index, dict(dense_heatmap=run), dict(dense_heatmap=ref))
    assert dist <= smoke.TOL and suppressed == 0 and differ == 1
    assert 0 < excess <= smoke.TOL


def test_check_proposals_refuses_a_heatmap_beyond_tol():
    ref = logits(3)
    run = ref.clone()
    # one logit 2 TOL of the largest away
    run[0, 0, 1, 1] += 2 * smoke.TOL * float(ref.abs().max())
    with pytest.raises(RuntimeError, match='heatmap lies'):
        smoke.check_proposals(head(), choice(run), dict(dense_heatmap=run),
                              dict(dense_heatmap=ref))


def test_check_proposals_refuses_proposals_not_the_heads_choice():
    ref = logits(4)
    index = choice(ref).clone()
    hm = th.local_maximum_nms(torch.sigmoid(ref), 3, ()).flatten(1)[0]
    index[0, -1] = int(hm.argsort(descending=True)[P + 1])
    with pytest.raises(RuntimeError, match='not the head'):
        smoke.check_proposals(head(), index, dict(dense_heatmap=ref),
                              dict(dense_heatmap=ref))


def outputs(rot, seed=5, n=8):
    """A twin's outputs on ``n`` proposals whose boxes are decoded from
    ``rot`` [1, 2, n] as the head's coder does (yaw = atan2(sin, cos))."""
    rng = np.random.RandomState(seed)

    def draw(*shape):
        return torch.from_numpy(rng.uniform(0.5, 2.0, shape)
                                .astype(np.float32))
    center, dim = draw(1, 2, n), draw(1, 3, n)
    yaw = torch.atan2(rot[:, 0], rot[:, 1])
    boxes = torch.cat([center.transpose(1, 2), draw(1, n, 1),
                       dim.transpose(1, 2), yaw[..., None],
                       draw(1, n, 2)], -1)
    return dict(head_input=draw(1, 4, H, W), dense_heatmap=logits(seed),
                heatmap=draw(1, C, n), center=center, dim=dim, rot=rot,
                bboxes=boxes, scores=draw(1, n),
                labels=torch.zeros(1, n, dtype=torch.long),
                valid=torch.ones(1, n, dtype=torch.bool))


def twin_outputs(rot_run, rot_alt, rot_ref):
    ref = outputs(rot_ref)
    run, alt = outputs(rot_run), outputs(rot_alt)
    for out, scale in ((run, 3e-6), (alt, 1e-6)):
        for key in ('center', 'dim', 'heatmap', 'scores'):
            out[key] = ref[key] * (1 + scale)
        b = ref['bboxes'] * (1 + scale)
        b[..., smoke.YAW] = out['bboxes'][..., smoke.YAW]
        out['bboxes'] = b
    return run, ref, alt


def short_rot(n=8, at=3, length=1e-4):
    """[1, 2, n] (sine, cosine) of length ~1, the one at ``at`` short."""
    rot = torch.from_numpy(np.random.RandomState(6).uniform(
        0.5, 1.0, (1, 2, n)).astype(np.float32))
    rot[0, :, at] = torch.tensor([0.6, 0.8]) * length
    return rot


def test_compare_outputs_holds_the_yaw_through_rot():
    # the short rot moves by 3e-6 of rot's largest value, across itself in
    # the kernel path and not at all in the reordered one: its angle turns
    # by ~0.03 rad, and rot lies within 3 times the reordered spread
    ref_rot = short_rot()
    run_rot, alt_rot = ref_rot.clone(), ref_rot * (1 + 1e-6)
    run_rot[0, :, 3] += torch.tensor([0.8, -0.6]) * 3e-6
    run_rot[0, :, :3] *= 1 + 3e-6
    run, ref, alt = twin_outputs(run_rot, alt_rot, ref_rot)
    worst = smoke.compare_outputs(run, ref, alt)
    rel, limit, floor, _ = worst['yaw']
    assert math.isnan(limit) and rel > smoke.FLOOR_MARGIN * max(
        floor, smoke.TOL)
    assert worst['rot'][0] <= worst['rot'][1]
    assert worst['bboxes'][0] <= worst['bboxes'][1]


def test_compare_outputs_refuses_rot_beyond_its_limit():
    ref_rot = short_rot()
    run_rot = ref_rot.clone()
    run_rot[0, 0, 0] += 0.01
    run, ref, alt = twin_outputs(run_rot, ref_rot * (1 + 1e-6), ref_rot)
    with pytest.raises(RuntimeError, match='^rot: kernel vs plain'):
        smoke.compare_outputs(run, ref, alt)


def test_compare_outputs_refuses_a_box_beyond_its_limit():
    rot = short_rot()
    run, ref, alt = twin_outputs(rot, rot, rot)
    run['bboxes'][0, 2, 4] += 0.01
    with pytest.raises(RuntimeError, match='^bboxes: kernel vs plain'):
        smoke.compare_outputs(run, ref, alt)


@pytest.fixture(scope='module')
def tiny():
    from msmdfusion_torch.config import load_config
    from msmdfusion_torch.models.builder import build_detector
    from tests.test_torch_transfusion_l import make_points, tiny_model_cfg
    model = build_detector(tiny_model_cfg(load_config), device='cpu',
                           seed=smoke.SEED)
    model.eval()
    points, mask = make_points(np.random.RandomState(0))
    return model, (torch.from_numpy(points), torch.from_numpy(mask))


def test_tiny_twin_passes_its_checks(tiny):
    model, inputs = tiny
    with torch.no_grad():
        run = smoke.pinned_forward(model, inputs, None)
        index = smoke.proposal_index(run)
        ref = smoke.pinned_forward(model, inputs, index)
        alt = smoke.pinned_forward(model, inputs, index, smoke.ReorderedSums())
    dist, excess, suppressed, differ = smoke.check_proposals(
        model.pts_bbox_head, index, run, ref)
    assert (dist, suppressed, differ) == (0.0, 0, 0) and excess <= 0
    worst = smoke.compare_outputs(run, ref, alt)
    assert {'rot', 'bboxes', 'yaw'} <= set(worst)
    assert worst['bboxes'][0] == 0.0


def test_tiny_twin_decodes_a_suppressed_cell(tiny):
    # a proposal the plain NMS suppresses keeps its heatmap score when the
    # twin decodes it
    model, inputs = tiny
    with torch.no_grad():
        run = smoke.pinned_forward(model, inputs, None)
        raw = torch.sigmoid(run['dense_heatmap'])
        strict = th.local_maximum_nms(
            raw, model.pts_bbox_head.nms_kernel_size,
            model.pts_bbox_head._flat_classes()).flatten(1)
        cell = int(torch.where(strict == 0, raw.flatten(1), -1.0).argmax())
        index = smoke.proposal_index(run).clone()
        index[0, -1] = cell
        twin = smoke.pinned_forward(model, inputs, index)
    hw = raw[0, 0].numel()
    value = float(raw.flatten(1)[0, cell])
    assert value > 0
    assert float(twin['query_heatmap_score'][0, cell // hw, -1]) == value
