"""The rows kernels' key windows as ``chip_smoke.py`` states them
(``rows_windows``, for its measurements), the plain versions' edge cases
and ``chip_smoke.plan_queries``, on the CPU.

``csrc/rows_affine.cu`` matches a tile of output rows inside windows of
the sorted input keys; ``rows_windows`` states those windows in PyTorch,
with the design's constants read from the source (``rows_design``).
On the subm, downsample and dual plans of a synthetic LiDAR frame (the
flagship's grid; ``test_torch_rows_card.py`` holds the kernels to their
plain versions on the same plans on the card): every live query's lower
bound lies in its group's window, so every matched row does; the window
bounds come from the least and greatest live query; nearly every tile's
windows fit the block's buffer at stride 1. Dense keys under widely
spaced rows need a sampled index; so do windows that fit the buffer only
until they are copied from 16-byte boundaries. ``rows_design`` reads the
source's constants. The plain versions give -1 rows for no input keys and
no row for no output rows.
"""
import pytest
import torch

import chip_smoke as smoke
from msmdfusion_torch.ops.sparse import matchconv as tmc
from msmdfusion_torch.ops.sparse.tensor import INT_MAX
from tests.test_torch_rows_card import dense_plan, edge_plan, frame_plans

WINDOW_CAP, _, TILE_ROWS = smoke.rows_design()
INT_MIN = smoke.INT_MIN


@pytest.fixture(scope='module')
def plans():
    return frame_plans(torch.device('cpu'), n_points=20000)


def expected_ranges(plan, tile):
    """[T, Ta] least and greatest query of each tile's taps, restated:
    over the live queries of an explicit plan; over the valid okeys plus
    dkey of an affine one (int32-clamped; empty where none is valid)."""
    k, ta = plan.inb.shape
    tiles = torch.arange(k) // tile
    n = int(tiles[-1]) + 1 if k else 0
    if plan.queries is not None:
        q = plan.queries.to(torch.int64)
        live = plan.inb & (plan.queries != INT_MAX)
    else:
        q = plan.okeys.to(torch.int64)[:, None] + plan.dkey[None]
        live = (plan.okeys != INT_MAX)[:, None].expand(k, ta)
    idx = tiles[:, None].expand(k, ta)
    least = torch.full((n, ta), INT_MAX, dtype=torch.int64).scatter_reduce(
        0, idx, torch.where(live, q, INT_MAX), 'amin')
    most = torch.full((n, ta), INT_MIN, dtype=torch.int64) \
        .scatter_reduce(0, idx, torch.where(live, q, INT_MIN), 'amax')
    some = (least <= most) & (least <= INT_MAX) & (most >= INT_MIN)
    return (torch.where(some, least.clamp(min=INT_MIN), INT_MAX),
            torch.where(some, most.clamp(max=INT_MAX), INT_MIN))


@pytest.mark.parametrize('which', range(7))
def test_windows_hold_every_live_query(plans, which):
    name, keys, plan = plans[which]
    q, live = smoke.plan_queries(plan)
    w = smoke.rows_windows(keys, plan)
    k, ta = q.shape
    tile = TILE_ROWS(ta)
    assert w['group'].shape == (-(-k // tile), ta)
    tiles = torch.arange(k) // tile
    g = w['group'][tiles]                                      # [K, Ta]
    assert ((g >= 0) | ~live).all() and (g >= 0).any()
    lo = torch.gather(w['lo'][tiles], 1, g.clamp(min=0))
    hi = torch.gather(w['hi'][tiles], 1, g.clamp(min=0))
    pos = torch.searchsorted(keys.to(torch.int64), q)
    assert ((pos >= lo) & (pos <= hi) | ~live).all(), name
    rows = tmc.plan_rows_plain(keys, plan)
    hit = rows >= 0
    assert ((rows >= lo) & (rows < hi))[hit].all(), name
    assert int(hit.sum()) > k // 2
    # the bounds are those of the group's least and greatest query
    least, most = expected_ranges(plan, tile)
    slot = w['group'].clamp(min=0)
    gl = torch.full_like(least, INT_MAX).scatter_reduce(
        1, slot, torch.where(w['group'] >= 0, least, INT_MAX), 'amin')
    gm = torch.full_like(most, INT_MIN).scatter_reduce(
        1, slot, torch.where(w['group'] >= 0, most, INT_MIN), 'amax')
    valid = torch.arange(ta)[None] < w['groups'][:, None]
    keys64 = keys.to(torch.int64)
    assert torch.equal(w['lo'], torch.where(
        valid, torch.searchsorted(keys64, gl), 0))
    assert torch.equal(w['hi'], torch.where(
        valid, torch.searchsorted(keys64, gm, right=True), 0))
    assert float((w['stride'] == 1).float().mean()) > 0.98, name
    assert (w['staged'] <= WINDOW_CAP).all() and w['staged_keys'] > 0


def test_dense_keys_take_a_sampled_index():
    keys, plan = dense_plan(torch.device('cpu'), 27)
    w = smoke.rows_windows(keys, plan)
    assert (w['stride'] > 1).all()
    valid = torch.arange(27)[None] < w['groups'][:, None]
    per_tile = torch.where(valid & (w['hi'] > w['lo']),
                           (w['hi'] - w['lo'] + w['stride'][:, None] - 1)
                           // w['stride'][:, None], 0).sum(1)
    assert (per_tile <= WINDOW_CAP).all()
    assert torch.equal(w['staged'], per_tile)
    assert w['staged_keys'] == int(per_tile.sum())


def test_windows_at_the_buffer_edge_are_sampled():
    # three windows whose keys fit the buffer but whose copies from 16-byte
    # boundaries do not: every other key, not a copy past the buffer
    keys, plan = edge_plan(torch.device('cpu'))
    w = smoke.rows_windows(keys, plan)
    assert (w['groups'] == 3).all()
    span = (w['hi'] - w['lo']).sum(1)
    assert (span <= WINDOW_CAP - 3).all()
    assert ((w['hi'] - (w['lo'] & ~3) + 3) // 4 * 4).sum(1).gt(
        WINDOW_CAP).all()
    assert (w['stride'] == 2).all() and (w['staged'] <= WINDOW_CAP).all()


def test_constants_are_the_kernels():
    # what chip_smoke.py reads from csrc/rows_affine.cu: an 8 KB buffer of
    # keys, one sampled key per tile row, 128-row tiles up to 64 taps,
    # then 64 and 32 for shared memory
    assert (WINDOW_CAP, smoke.rows_design()[1]) == (2048, 1)
    assert [TILE_ROWS(ta) for ta in (1, 3, 8, 27, 64, 65, 128, 129, 343)] \
        == [128] * 5 + [64] * 2 + [32] * 2


def test_plain_rows_without_keys_or_rows():
    none = torch.zeros(0, dtype=torch.int32)
    dkey = torch.arange(-13, 14, dtype=torch.int32)
    okeys = torch.tensor([5, 9, INT_MAX], dtype=torch.int32)
    inb = torch.ones((3, 27), dtype=torch.bool)
    for plan in (tmc.MatchPlan(inb=inb, okeys=okeys, dkey=dkey),
                 tmc.MatchPlan(inb=inb, queries=(
                     okeys[:, None] + dkey[None]).contiguous())):
        rows, masks = tmc.plan_rows(none, plan, masks=True)
        assert rows.shape == (3, 27) and (rows == -1).all()
        assert not masks.any()
    keys = torch.tensor([1, 5, 9, INT_MAX], dtype=torch.int32)
    empty = tmc.MatchPlan(inb=inb[:0], okeys=okeys[:0], dkey=dkey)
    rows, masks = tmc.plan_rows(keys, empty, masks=True)
    assert rows.shape == (0, 27) and masks.shape == (0,)
    assert smoke.rows_windows(keys, empty)['groups'] \
        .shape == (0,)


def test_plan_queries_liveness():
    okeys = torch.tensor([0, 2 ** 31 - 20, INT_MAX, 7], dtype=torch.int32)
    dkey = torch.tensor([-1, 0, 30], dtype=torch.int32)
    inb = torch.tensor([[True] * 3, [True] * 3, [True] * 3,
                        [True, False, True]])
    q, live = smoke.plan_queries(tmc.MatchPlan(inb=inb, okeys=okeys,
                                             dkey=dkey))
    assert live.tolist() == [[True] * 3, [True, True, False],
                             [False] * 3, [True, False, True]]
    assert q[0].tolist() == [-1, 0, 30]
    queries = torch.where(inb, q, INT_MAX).clamp(max=INT_MAX) \
        .to(torch.int32)
    _, live_q = smoke.plan_queries(tmc.MatchPlan(inb=inb, queries=queries))
    assert (live_q == (inb & (queries != INT_MAX))).all()
    keys = torch.tensor([-1, 0, 7, 37, INT_MAX], dtype=torch.int32)
    rows = tmc.plan_rows_plain(keys, tmc.MatchPlan(inb=inb, okeys=okeys,
                                                   dkey=dkey))
    assert rows.tolist() == [[0, 1, -1], [-1, -1, -1], [-1, -1, -1],
                             [-1, -1, 3]]
