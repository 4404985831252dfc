"""The packed bf16 kernels' row order (``matchconv.RowOrder``) on the CPU.

The packed conv walks its output rows stably sorted by their tap-hit mask,
skipping, per 16-row slice, the taps no row of the slice hits; its weight
gradient walks each tap's hit pairs only. On small plans made from a numpy
seed (submanifold, strided and the strided conv's dual):

- the permutation is a stable sort by mask and inverting it gives the rows
  back; each slice mask is exactly the OR of its rows' hits; each tap's
  pair list is ``nonzero(rows[:, t] >= 0)`` in ascending order;
- a plain conv and a plain weight gradient that read that layout (slices,
  their taps, the pair lists) equal ``gather_gemm_conv_plain`` and
  ``conv_dw_plain`` bit for bit under ``MSMD_CONV_DTYPE=bfloat16``. The
  values lie on a coarse dyadic grid, bf16-exact, so that every fp32 sum
  is exact in any order: the layout, not the order of the sums, is what is
  compared;
- the rows wrappers return each row's tap-hit mask beside the rows when
  asked (the kernels write it in the same launch);
- the order is built where ``needs_order()``: under ``packed()`` and on
  the fp32 engine's default x3 route, whose kernels walk it too
  (``MSMD_CONV_GEMM=highest`` and one-hot plans carry none), by
  ``attach_rows`` beside the rows and cached on the plan and its dual, and
  ``MatchConv`` hands the plan's orders to the packed kernels, which
  refuse to run without them;
- the weight gradient's chunking is a function of the plan and shapes.

``test_torch_conv_bf16_card.py`` holds the kernels themselves to their
plain versions on the card.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from msmdfusion_torch.models import sparse_blocks
from msmdfusion_torch.ops.sparse import matchconv as tmc
from msmdfusion_torch.ops.sparse.tensor import SparseTensor
from tests.test_torch_sparse_ops import both_tensors, random_sparse
from tests.test_torch_train_ops import port_plan, strided

PLANS = ['subm', 'strided', 'dual']


@pytest.fixture
def bf16(monkeypatch):
    monkeypatch.setenv('MSMD_CONV_DTYPE', 'bfloat16')


def plan_rows(kind, seed=40):
    """Rulebook rows of a small plan from a numpy seed."""
    rng = np.random.RandomState(seed)
    if kind == 'subm':
        _, t = both_tensors(*random_sparse(rng, 512, 400, (9, 24, 24), 8),
                            (9, 24, 24))
        return tmc.attach_rows(t.keys, tmc.build_subm_plan(t, 3)).rows
    _, t, _, tout = strided(rng, 3, 2, 1)
    plan = port_plan(t, tout, (3, 2, 1))
    return plan.rows if kind == 'strided' else plan.dual.rows


def training_plan(t, tout, conv=(3, 2, 1)):
    """A strided training plan as the sparse conv layers build it: the
    forward rows with the weight gradient's pair lists, the dual's
    without."""
    ks, stride, pad = conv
    out_keys, out_coords, out_valid, out_shape = tout
    plan = tmc.attach_rows(t.keys, tmc.build_downsample_plan(
        t, out_coords, out_valid, ks, stride, pad), order=True, pairs=True)
    dual = tmc.attach_rows(out_keys, tmc.build_dual_down_plan(
        t, out_shape, ks, stride, pad), order=True)
    return dataclasses.replace(plan, dual=dual)


def masks_of(rows):
    hit = (rows >= 0).numpy()
    return (hit.astype(np.int64) << np.arange(hit.shape[1])).sum(1)


def dyadic(rng, *shape):
    """Values k / 16, |k| <= 64: bf16-exact, products and their sums exact
    in fp32."""
    return torch.from_numpy(
        (rng.randint(-64, 65, shape) / 16.0).astype(np.float32))


def ordered_conv_plain(feats, rows, weights, order, scale=None, shift=None,
                       relu=False, out_valid=None):
    """The conv as the packed kernel walks it: per tap, only the slices
    whose mask holds it, rows in sorted order, each result row written to
    its original position."""
    feats, weights = tmc.bf16_round(feats), tmc.bf16_round(weights)
    k, ta = rows.shape
    perm = order.perm.long()
    srows = rows[perm]
    slice_of = torch.arange(k) // tmc.SLICE_ROWS
    acc = feats.new_zeros((k, weights.shape[2]))
    for t in range(ta):
        live = ((order.slice_masks() >> t) & 1).bool()[slice_of]
        idx = torch.nonzero(live).flatten()
        r = srows[idx, t].long()
        g = torch.where((r >= 0)[:, None], feats[r.clamp(min=0)], 0.0)
        acc[idx] = acc[idx] + g @ weights[t]
    out = torch.empty_like(acc)
    out[perm] = acc
    return tmc.apply_epilogue(out, out_valid, scale, shift, relu)


def pairs_dw_plain(feats, g, order):
    """The weight gradient over each tap's pair list only."""
    feats, g = tmc.bf16_round(feats), tmc.bf16_round(g)
    ta = len(order.tap_hits)
    dw = feats.new_empty((ta, feats.shape[1], g.shape[1]))
    for t in range(ta):
        s, e = int(order.tap_start[t]), int(order.tap_start[t + 1])
        dw[t] = feats[order.pair_in[s:e].long()].T @ \
            g[order.pair_out[s:e].long()]
    return dw


@pytest.mark.parametrize('kind', PLANS)
def test_permutation_is_a_stable_sort_by_mask(kind):
    rows = plan_rows(kind)
    order = tmc.row_order(rows)
    perm = order.perm.numpy()
    assert order.perm.dtype == torch.int64
    np.testing.assert_array_equal(np.sort(perm), np.arange(rows.shape[0]))
    masks = masks_of(rows)
    np.testing.assert_array_equal(order.masks.numpy(), masks[perm])
    np.testing.assert_array_equal(perm, np.argsort(masks, kind='stable'))
    assert (np.diff(masks[perm]) >= 0).all()
    inverse = np.empty_like(perm)
    inverse[perm] = np.arange(perm.size)
    np.testing.assert_array_equal(rows.numpy()[perm][inverse], rows.numpy())
    # the plan really has several distinct masks and misses to skip
    assert len(np.unique(masks)) > 10 and (rows < 0).any()


@pytest.mark.parametrize('kind', PLANS)
def test_rows_wrappers_give_the_row_masks(kind):
    rng = np.random.RandomState(40)
    if kind == 'subm':
        _, t = both_tensors(*random_sparse(rng, 512, 400, (9, 24, 24), 8),
                            (9, 24, 24))
        keys, plan = t.keys, tmc.build_subm_plan(t, 3)
    else:
        _, t, _, tout = strided(rng, 3, 2, 1)
        keys, plan = t.keys, tmc.build_downsample_plan(
            t, tout[1], tout[2], 3, 2, 1)
        if kind == 'dual':
            keys, plan = tout[0], tmc.build_dual_down_plan(
                t, tout[3], 3, 2, 1)
    rows, masks = tmc.plan_rows(keys, plan, masks=True)
    assert torch.equal(rows, tmc.plan_rows(keys, plan))
    assert masks.dtype == torch.int64
    np.testing.assert_array_equal(masks.numpy(), masks_of(rows))
    assert torch.equal(tmc.row_masks(rows), masks)
    # the order sorts by those masks
    order = tmc.row_order(rows, pairs=False, masks=masks)
    assert torch.equal(order.perm, tmc.row_order(rows, pairs=False).perm)
    with pytest.raises(ValueError, match='fit the mask'):
        tmc.row_masks(torch.zeros((4, 63), dtype=torch.int32))


def test_packed_kernels_refuse_a_missing_order():
    rows = plan_rows('subm')
    for name, order, pairs in (
            ('gather_gemm_conv_bf16', None, False),
            ('conv_dw_bf16', None, True),
            ('conv_dw_bf16', tmc.row_order(rows, pairs=False), True)):
        with pytest.raises(ValueError, match='row order'):
            tmc._check_order(name, order, rows, pairs)
    tmc._check_order('conv_dw_bf16', tmc.row_order(rows), rows, True)
    with pytest.raises(ValueError, match='rows for rows'):
        tmc._check_order('gather_gemm_conv_bf16', tmc.row_order(rows[:-1]),
                         rows, False)


@pytest.mark.parametrize('kind', PLANS)
def test_pair_lists_are_each_taps_hits_ascending(kind):
    rows = plan_rows(kind)
    order = tmc.row_order(rows)
    ta = rows.shape[1]
    assert order.tap_start.tolist() == [0] + list(
        np.cumsum(order.tap_hits))
    for t in range(ta):
        s, e = int(order.tap_start[t]), int(order.tap_start[t + 1])
        want = torch.nonzero(rows[:, t] >= 0).flatten()
        assert torch.equal(order.pair_out[s:e].long(), want)
        assert torch.equal(order.pair_in[s:e], rows[want, t])
        assert order.tap_hits[t] == int((rows[:, t] >= 0).sum())
    assert order.pair_in.shape[0] == int((rows >= 0).sum())


@pytest.mark.parametrize('kind', PLANS)
def test_slice_masks_cover_exactly_the_hit_taps(kind):
    rows = plan_rows(kind)
    order = tmc.row_order(rows)
    hit = (rows >= 0)[order.perm.long()].numpy()
    n = -(-rows.shape[0] // tmc.SLICE_ROWS)
    assert order.slice_masks().shape == (n,)
    for i, mask in enumerate(order.slice_masks().tolist()):
        taps = hit[i * tmc.SLICE_ROWS:(i + 1) * tmc.SLICE_ROWS].any(0)
        assert [bool(mask >> t & 1) for t in range(rows.shape[1])] == \
            taps.tolist()
        assert mask >> rows.shape[1] == 0
    # sorting gathered the hits: a larger share of the staged row-taps
    # are hits than in the plan's own row order
    def staged(h):
        n = -(-len(h) // tmc.SLICE_ROWS) * tmc.SLICE_ROWS
        h = np.pad(h, ((0, n - len(h)), (0, 0)))
        return h.reshape(-1, tmc.SLICE_ROWS, h.shape[1]).any(1).sum() * \
            tmc.SLICE_ROWS
    staged_sorted = sum(bin(m).count('1') for m in
                        order.slice_masks().tolist()) * tmc.SLICE_ROWS
    assert staged_sorted == staged(hit)
    assert hit.sum() / staged_sorted > hit.sum() / staged(
        (rows >= 0).numpy())


@pytest.mark.parametrize('kind', PLANS)
def test_ordered_plain_conv_is_bit_equal(kind, bf16):
    rows = plan_rows(kind)
    order = tmc.row_order(rows)
    rng = np.random.RandomState(41)
    k_in = int(rows.max()) + 1 + int(rng.randint(0, 5))
    cin, cout = 8, 12
    feats, w = dyadic(rng, k_in, cin), dyadic(rng, rows.shape[1], cin, cout)
    want = tmc.gather_gemm_conv_plain(feats, rows, w)
    assert torch.equal(ordered_conv_plain(feats, rows, w, order), want)
    assert want.abs().max() > 0
    epi = dict(scale=torch.from_numpy(rng.uniform(0.5, 1.5, cout)
                                      .astype(np.float32)),
               shift=torch.from_numpy(rng.uniform(-0.3, 0.3, cout)
                                      .astype(np.float32)),
               relu=True,
               out_valid=torch.from_numpy(rng.rand(rows.shape[0]) < 0.9))
    assert torch.equal(ordered_conv_plain(feats, rows, w, order, **epi),
                       tmc.gather_gemm_conv_plain(feats, rows, w, **epi))
    # and the wrapper on the CPU, given the order, is the plain version
    assert torch.equal(tmc.gather_gemm_conv(feats, rows, w, order=order,
                                            **epi),
                       tmc.gather_gemm_conv_plain(feats, rows, w, **epi))


@pytest.mark.parametrize('kind', PLANS)
def test_pairs_plain_dw_is_bit_equal(kind, bf16):
    rows = plan_rows(kind)
    order = tmc.row_order(rows)
    rng = np.random.RandomState(42)
    k_in = int(rows.max()) + 1
    feats, g = dyadic(rng, k_in, 6), dyadic(rng, rows.shape[0], 10)
    want = tmc.conv_dw_plain(feats, rows, g)
    assert torch.equal(pairs_dw_plain(feats, g, order), want)
    assert torch.equal(tmc.conv_dw(feats, rows, g, order=order), want)


def test_order_only_under_packed(monkeypatch):
    rng = np.random.RandomState(43)
    _, t, _, tout = strided(rng, 3, 2, 1)
    torch.manual_seed(0)
    subm_layer = sparse_blocks.SubMConv3d(8, 8, 3, indice_key='s').train()
    down_layer = sparse_blocks.SparseConv3d(8, 8, 3, stride=2, padding=1,
                                            indice_key='d').train()
    for env, packed in (({}, True), ({'MSMD_CONV_DTYPE': 'bfloat16'}, True),
                        ({'MSMD_CONV_GEMM': 'highest'}, False),
                        ({'MSMD_CONV_ALGO': 'onehot'}, False)):
        for k in ('MSMD_CONV_DTYPE', 'MSMD_CONV_ALGO', 'MSMD_CONV_GEMM'):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        # the packed and the (default) x3 kernels walk the order
        assert tmc.needs_order() == packed
        _, cache = subm_layer(t, {})
        _, cache = down_layer(t, cache)
        subm = cache[('subm', 's')]
        plan = cache[('spconv', 'd')][-1]
        assert (subm.order is not None) == packed
        assert (plan.order is not None) == packed
        assert (plan.dual.order is not None) == packed
        # under highest the plans carry no order; one-hot no rows
        assert (subm.rows is not None) == (env != {'MSMD_CONV_ALGO':
                                                   'onehot'})
        if packed:
            # the weight gradient's pairs for the forward rows, never for
            # the dual
            assert plan.order.tap_hits is not None
            assert plan.dual.order.tap_hits is None
            assert subm.order.tap_hits is not None
            assert torch.equal(plan.order.perm,
                               tmc.row_order(plan.rows).perm)
            assert torch.equal(plan.dual.order.perm,
                               tmc.row_order(plan.dual.rows).perm)
            assert tmc.dual_order(subm) is subm.order
            assert tmc.dual_order(plan) is plan.dual.order
    # and attach_rows itself builds an order only when asked
    bare = tmc.attach_rows(t.keys, tmc.build_subm_plan(t, 3))
    assert bare.order is None
    asked = tmc.attach_rows(t.keys, tmc.build_subm_plan(t, 3), order=True)
    assert asked.order.tap_hits is None
    assert torch.equal(asked.order.perm, tmc.row_order(asked.rows).perm)


@pytest.mark.parametrize('packed', [False, True])
def test_sparse_blocks_cache_the_order(packed, monkeypatch):
    # packed, or the fp32 engine's default x3 route: both walk the order
    monkeypatch.delenv('MSMD_CONV_GEMM', raising=False)
    if packed:
        monkeypatch.setenv('MSMD_CONV_DTYPE', 'bfloat16')
    rng = np.random.RandomState(44)
    feats, coords, valid = random_sparse(rng, 384, 300, (8, 20, 20), 4)
    _, st = both_tensors(feats, coords, valid, (8, 20, 20))
    torch.manual_seed(0)
    subm = sparse_blocks.SubMConv3d(4, 8, 3, indice_key='s')
    down = sparse_blocks.SparseConv3d(8, 8, 3, stride=2, padding=1,
                                      indice_key='d').train()
    cache = {}
    out, cache = subm(st, cache)
    out, cache = down(out, cache)
    plan = cache[('subm', 's')]
    dplan = cache[('spconv', 'd')][-1]
    assert plan.order is not None
    assert dplan.order is not None
    assert dplan.dual.order is not None
    assert isinstance(out, SparseTensor)
    # training-mode layers build the weight gradient's pair lists
    assert plan.order.tap_hits is not None
    assert dplan.order.tap_hits is not None
    subm.eval()
    _, cache = subm(st, {})
    assert cache[('subm', 's')].order.tap_hits is None


def test_matchconv_hands_the_plans_orders_to_the_kernels(bf16, monkeypatch):
    rng = np.random.RandomState(45)
    _, t, _, tout = strided(rng, 3, 2, 1)
    plan = training_plan(t, tout)
    seen = []

    def conv(feats, rows, weights, order=None, **kw):
        seen.append(('conv', rows, order))
        return tmc.gather_gemm_conv_plain(feats, rows, weights, **kw)

    def dw(feats, rows, g, order=None):
        seen.append(('dw', rows, order))
        return tmc.conv_dw_plain(feats, rows, g)
    monkeypatch.setattr(tmc, 'gather_gemm_conv', conv)
    monkeypatch.setattr(tmc, 'conv_dw', dw)
    feats = t.features.clone().requires_grad_(True)
    w = torch.randn(27, 8, 6, requires_grad=True)
    out = tmc.MatchConv.apply(feats, w, plan)
    out.sum().backward()
    kinds = [(k, id(o)) for k, _, o in seen]
    assert kinds[0] == ('conv', id(plan.order))
    assert ('conv', id(plan.dual.order)) in kinds
    assert ('dw', id(plan.order)) in kinds
    for _, rows, order in seen:
        assert order is not None and order.perm.shape[0] == rows.shape[0]


def test_dw_chunking_is_a_function_of_the_plan():
    hits = (0, 1000, 146235, 70000, 5)
    for cin, cout in ((16, 16), (80, 96), (192, 192), (5, 16)):
        tile, chunk, n = tmc.conv_dw_bf16_launch(hits, cin, cout)
        assert (tile, chunk, n) == tmc.conv_dw_bf16_launch(hits, cin, cout)
        narrow = min(cin, cout)
        assert tile == (128 if narrow > 64 else 64 if narrow > 32 else
                        32 if narrow > 16 else 16)
        assert chunk >= 512 and chunk % tmc.DW_CHUNK_STEP == 0
        assert chunk % tmc.dw_stage_pairs(tile) == 0
        assert n == sum(math.ceil(h / chunk) for h in hits)
    assert tmc.conv_dw_bf16_launch((0, 0), 16, 16)[2] == 0


def test_packed_weights_rounded_once_and_padded():
    rng = np.random.RandomState(46)
    for cin, cout, np_, kc in ((5, 16, 16, 16), (80, 96, 96, 16),
                               (128, 192, 192, 32), (96, 80, 80, 32),
                               (16, 200, 192, 16)):
        w = torch.from_numpy(rng.randn(27, cin, cout).astype(np.float32))
        wt, got_np, got_kc = tmc.packed_weights(w)
        assert (got_np, got_kc) == (np_, kc)
        assert wt.dtype == torch.bfloat16
        assert wt.shape == (27, math.ceil(cout / np_) * np_,
                            math.ceil(cin / kc) * kc)
        assert torch.equal(wt[:, :cout, :cin].float(),
                           tmc.bf16_round(w).transpose(1, 2))
        assert not wt[:, cout:].any() and not wt[:, :, cin:].any()
