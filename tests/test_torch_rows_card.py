"""The rulebook-rows kernels (``rows_affine``, ``rows_queries``) and the
two paths of the ``merge_take`` kernel against their plain versions on an
NVIDIA card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_rows_card.py

Rows, and the tap-hit masks where asked, equal to the plain versions and
``row_masks`` on: the subm, downsample and dual plans of a synthetic
LiDAR frame (~40k voxels on the flagship's 1440 x 1440 x 41 grid; Ta 27,
3 and 8); unsorted affine ``okeys`` and random explicit queries; a tile
whose windows exceed the block's buffer (dense keys under widely spaced
rows: the in-kernel device-memory branch); all-INT_MAX rows, K_in = 0 and
K_out = 0; K_out not a multiple of the tile; windows that fit the buffer
only until they are copied from 16-byte boundaries; unaligned views.
``merge_take_rows`` equal to
its plain version by float4 slices and by elements (widths 5 and 7, an
unaligned table). Without a card every test skips. No JAX here: the
machine with the card runs the port alone.
"""
import numpy as np
import pytest
import torch

import chip_smoke as smoke
from msmdfusion_torch import kernels
from msmdfusion_torch.ops.sparse import conv as tconv
from msmdfusion_torch.ops.sparse import matchconv as tmc
from msmdfusion_torch.ops.sparse import merge_take as tmt
from msmdfusion_torch.ops.sparse.tensor import INT_MAX, make_sparse_tensor
from msmdfusion_torch.ops.voxelize import grid_shape, voxelize_mean_batch
from msmdfusion_torch.utils.synth_scene import lidar_scene

# the flagship's LiDAR grid (configs/MSMDFusion_nusc_voxel_LC.py)
PCR = [-54.0, -54.0, -5.0, 54.0, 54.0, 3.0]
VOXEL = [0.075, 0.075, 0.2]
# (kernel, stride, padding) of the encoder's strided convs: spconv1-3
# (Ta 27), conv_out (Ta 3), and a 2 x 2 x 2 one (Ta 8)
STRIDED = [(3, 2, 1), ((3, 1, 1), (2, 1, 1), 0), (2, 2, 0)]


def frame_plans(device, n_points=60000, seed=3):
    """[(name, in_keys, plan)]: the subm plan of a synthetic LiDAR frame's
    voxels, and per strided conv of ``STRIDED`` its downsample plan (rows
    against the voxels' keys) and its dual (rows against its output
    keys)."""
    pts, _ = lidar_scene(np.random.RandomState(seed), n_points, PCR)
    points = torch.from_numpy(pts)[None].to(device)
    mask = torch.ones(points.shape[:2], dtype=torch.bool, device=device)
    feats, coors, valid = voxelize_mean_batch(points, mask, VOXEL, PCR,
                                              n_points)
    shape = grid_shape(VOXEL, PCR)
    st = make_sparse_tensor(feats, coors, valid, shape, 1,
                            assume_sorted=True)
    plans = [('subm', st.keys, tmc.build_subm_plan(st, 3))]
    for kernel, stride, pad in STRIDED:
        out_keys, out_coords, out_valid, out_shape = \
            tconv.downsample_out_coords(st, kernel, stride, pad, n_points)
        tag = f'k{kernel} s{stride}'
        plans.append((f'down {tag}', st.keys, tmc.build_downsample_plan(
            st, out_coords, out_valid, kernel, stride, pad)))
        plans.append((f'dual {tag}', out_keys, tmc.build_dual_down_plan(
            st, out_shape, kernel, stride, pad)))
    return plans


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card: the CUDA kernels run only there')
    return torch.device('cuda')


def assert_rows(in_keys, plan, min_hits=0):
    """The kernel's rows, and rows and masks from one launch, equal to the
    plain versions; two launches."""
    want = tmc.plan_rows_plain(in_keys, plan)
    kernels.reset_launches()
    rows = tmc.plan_rows(in_keys, plan)
    got, masks = tmc.plan_rows(in_keys, plan, masks=True)
    torch.cuda.synchronize()
    name = 'rows_queries' if plan.queries is not None else 'rows_affine'
    assert kernels.launches[name] == 2
    assert torch.equal(rows, want), int((rows != want).sum())
    assert torch.equal(got, want), int((got != want).sum())
    assert torch.equal(masks, tmc.row_masks(want))
    assert int((want >= 0).sum()) >= min_hits


@pytest.mark.cuda
def test_rows_kernels_on_frame_plans(card):
    plans = frame_plans(card)
    assert {p.num_taps for _, _, p in plans} == {27, 3, 8}
    for name, in_keys, plan in plans:
        assert_rows(in_keys, plan, min_hits=plan.k_out // 2)


def random_keys(rng, k_in, span):
    keys = np.sort(rng.choice(span, k_in, replace=False))
    return torch.from_numpy(np.concatenate(
        [keys, [INT_MAX] * 7]).astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize('ta', [27, 8, 3])
@pytest.mark.parametrize('k_out', [6000, 1000, 1])
def test_rows_kernels_unsorted_and_random(ta, k_out, card):
    rng = np.random.RandomState(51 + ta)
    keys = random_keys(rng, 5000, 1 << 14).to(card)
    inb = torch.from_numpy(rng.rand(k_out, ta) < 0.9).to(card)
    okeys = rng.randint(0, 1 << 13, k_out)
    okeys[rng.rand(k_out) < 0.05] = INT_MAX
    dkey = rng.randint(-(1 << 12), 1 << 13, ta)
    affine = tmc.MatchPlan(
        inb=inb, okeys=torch.from_numpy(okeys.astype(np.int32)).to(card),
        dkey=torch.from_numpy(dkey.astype(np.int32)).to(card))
    q = rng.randint(0, 1 << 14, (k_out, ta))
    q[rng.rand(k_out, ta) < 0.05] = INT_MAX
    explicit = tmc.MatchPlan(inb=inb, queries=torch.from_numpy(
        q.astype(np.int32)).to(card))
    for plan in (affine, explicit):
        assert_rows(keys, plan, min_hits=k_out // 5)


def dense_plan(device, ta):
    """Dense keys 0..59999 under output rows 300 keys apart: a 128-row
    tile's queries span ~38k keys, beyond the block's window buffer."""
    keys = torch.arange(60000, dtype=torch.int32)
    okeys = torch.arange(0, 60000, 300, dtype=torch.int32)
    dkey = torch.tensor({3: [-1, 0, 1], 8: [0, 1, 2, 3, 900, 901, 902, 903],
                         27: list(range(-13, 14))}[ta], dtype=torch.int32)
    inb = torch.ones((okeys.shape[0], ta), dtype=torch.bool)
    return keys.to(device), tmc.MatchPlan(
        inb=inb.to(device), okeys=okeys.to(device), dkey=dkey.to(device))


def edge_plan(device):
    """Dense keys under three taps 400,000 keys apart and 128-row tiles
    (512 of them) that span 681 keys: three windows of 681 keys, which fit
    the block's buffer (3 x 681 <= 2048 - 3) but not once each is copied
    from a 16-byte boundary (3 x 684 > 2048)."""
    k = 128 * 512
    keys = torch.arange(1200000, dtype=torch.int32)
    okeys = (torch.arange(k) * 680 // 127).to(torch.int32)
    dkey = torch.tensor([0, 400000, 800000], dtype=torch.int32)
    inb = torch.ones((k, 3), dtype=torch.bool)
    return keys.to(device), tmc.MatchPlan(
        inb=inb.to(device), okeys=okeys.to(device), dkey=dkey.to(device))


@pytest.mark.cuda
def test_rows_kernels_windows_at_the_buffer_edge(card):
    keys, plan = edge_plan(card)
    assert (smoke.rows_windows(keys, plan)['stride']
            == 2).all()
    assert_rows(keys, plan, min_hits=3 * plan.k_out)
    explicit = tmc.MatchPlan(inb=plan.inb, queries=(
        plan.okeys[:, None] + plan.dkey[None]).contiguous())
    assert_rows(keys, explicit, min_hits=3 * plan.k_out)


@pytest.mark.cuda
@pytest.mark.parametrize('ta', [27, 8, 3])
def test_rows_kernels_windows_over_the_buffer(ta, card):
    keys, plan = dense_plan(card, ta)
    assert (smoke.rows_windows(keys, plan)['stride']
            > 1).all()
    assert_rows(keys, plan, min_hits=plan.k_out // 2)
    explicit = tmc.MatchPlan(inb=plan.inb, queries=(
        plan.okeys[:, None] + plan.dkey[None]).contiguous())
    assert_rows(keys, explicit, min_hits=plan.k_out // 2)


@pytest.mark.cuda
def test_rows_kernels_empty_and_invalid(card):
    rng = np.random.RandomState(52)
    keys = random_keys(rng, 3000, 1 << 13).to(card)
    none = torch.zeros(0, dtype=torch.int32, device=card)
    dkey = torch.arange(-13, 14, dtype=torch.int32, device=card)
    for k_out in (0, 700):
        inb = torch.ones((k_out, 27), dtype=torch.bool, device=card)
        invalid = torch.full((k_out,), INT_MAX, dtype=torch.int32,
                             device=card)
        okeys = torch.randint(0, 1 << 13, (k_out,), dtype=torch.int32,
                              device=card)
        q = (okeys[:, None] + dkey[None]).contiguous()
        for in_keys, plan in (
                (keys, tmc.MatchPlan(inb=inb, okeys=invalid, dkey=dkey)),
                (keys, tmc.MatchPlan(inb=inb, queries=invalid[:, None]
                                     .expand(k_out, 27).contiguous())),
                (none, tmc.MatchPlan(inb=inb, okeys=okeys, dkey=dkey)),
                (none, tmc.MatchPlan(inb=inb, queries=q))):
            assert_rows(in_keys, plan)
            rows, masks = tmc.plan_rows(in_keys, plan, masks=True)
            assert rows.shape == (k_out, 27) and not (rows >= 0).any()
            assert masks.shape == (k_out,) and not masks.any()


def offset_by_one(t):
    """A copy of ``t`` one element into its storage: no longer 16-byte
    aligned."""
    store = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = store[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.cuda
def test_rows_kernels_on_unaligned_tensors(card):
    _, keys, plan = frame_plans(card, n_points=20000)[1]     # down k3 s2
    assert plan.num_taps == 27
    keys, plan = offset_by_one(keys), tmc.MatchPlan(
        inb=offset_by_one(plan.inb), okeys=offset_by_one(plan.okeys),
        dkey=plan.dkey)
    assert keys.data_ptr() % 16 and plan.inb.data_ptr() % 16
    assert_rows(keys, plan, min_hits=plan.k_out // 2)
    q, _ = smoke.plan_queries(plan)
    explicit = tmc.MatchPlan(inb=plan.inb, queries=offset_by_one(
        q.clamp(max=INT_MAX).to(torch.int32)))
    assert_rows(keys, explicit, min_hits=plan.k_out // 2)


def take_case(rng, c, device, offset=0):
    """(table [300, c], idx, idx2, dup) with out-of-range and INT_MAX
    indices; the table ``offset`` floats into its storage."""
    store = torch.from_numpy(rng.randn(300 * c + offset).astype(np.float32))
    table = store.to(device)[offset:].view(300, c)
    idx = rng.randint(-5, 320, 4000)
    idx[::13] = INT_MAX
    idx2 = rng.randint(0, 300, 4000)
    dup = rng.rand(4000) < 0.4
    return (table, torch.from_numpy(idx.astype(np.int32)).to(device),
            torch.from_numpy(idx2.astype(np.int32)).to(device),
            torch.from_numpy(dup).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize('c,offset,vec4', [(96, 0, True), (5, 0, False),
                                           (7, 0, False), (8, 1, False)])
def test_merge_take_both_paths_on_card(c, offset, vec4, card):
    rng = np.random.RandomState(53 + c)
    table, idx, idx2, dup = take_case(rng, c, card, offset)
    kernels.reset_launches()
    for args in ((table, idx), (table, idx, idx2, dup)):
        got = tmt.merge_take_rows(*args)
        assert tmt.take_vec4(table, got) == vec4
        torch.cuda.synchronize()
        assert torch.equal(got, tmt.merge_take_rows_plain(*args))
    assert kernels.launches['merge_take'] == 2
