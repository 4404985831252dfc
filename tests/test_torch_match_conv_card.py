"""The one-hot engine's tensor-core kernels (``match_conv_x3``,
``match_conv_bf16``) against their plain versions on an NVIDIA card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_match_conv_card.py

``match_conv_x3``: each element within 1e-4 of the magnitude of its own
sum, and the whole within 1e-4 of the largest value, against the x3 plain
version (the same split, fp32 sums in another order) and the exact one;
``match_conv_bf16``: each element within one bf16 ulp of the bf16 plain
version plus 1e-4 of the magnitude of its sum, and at least 0.999 of them
bit-equal to it (``chip_smoke.bf16_equal``). With and without the
epilogue, on: every width pair of the flagship's sparse convs; Cin 5, 16
and 192 on the subm, downsample and dual plans of a synthetic LiDAR frame
(affine and explicit queries, Ta 27, 3 and 8, the keys' INT_MAX tail,
misses inside the 16-row slices that hit a tap); random keys under INT_MAX
rows and queries, a 128-row block that no tap hits, K_out not a multiple
of the block, unaligned feature views. ``MSMD_CONV_GEMM=highest`` takes
the exact FFMA kernel ``match_conv`` for fp32 features. The bf16 train
step's input gradient: ``MatchConv``'s backward on bf16 features runs
``match_conv_bf16`` over a strided conv's dual plan. Without a card
every test skips. No JAX here: the machine with the card runs the port
alone.
"""
import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import bf16_equal, bf16_ulp
from msmdfusion_torch import kernels
from msmdfusion_torch.ops.sparse import matchconv as tmc
from msmdfusion_torch.ops.sparse.tensor import INT_MAX
from tests.test_torch_rows_card import frame_plans, random_keys

TOL = 1e-4
# the flagship's sparse-conv width pairs (chip_smoke.FLAGSHIP and the
# encoder's, chip_smoke.TL)
WIDTHS = [(5, 16), (16, 16), (16, 32), (32, 32), (32, 64), (64, 64),
          (64, 128), (128, 128), (80, 80), (96, 96), (192, 192), (80, 96),
          (96, 128), (128, 192)]


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card: the CUDA kernels run only there')
    for k in ('MSMD_CONV_GEMM', 'MSMD_CONV_DTYPE', 'MSMD_CONV_ALGO'):
        monkeypatch.delenv(k, raising=False)
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


@pytest.fixture(scope='module')
def frame():
    """The synthetic frame's plans on the card (built once)."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card: the CUDA kernels run only there')
    return frame_plans(torch.device('cuda'))


def rand_feats(rng, k, cin, valid=None):
    """fp32 features over eight binades, zero on rows not ``valid``."""
    f = rng.randn(k, cin) * 2.0 ** rng.randint(-4, 4, (k, cin))
    if valid is not None:
        f = f * valid[:, None]
    return torch.from_numpy(f.astype(np.float32))


def check_bf16(got, want, mag):
    """``match_conv_bf16``'s output against its plain version: bit-equal
    on all but a few elements, and within one bf16 ulp plus TOL of each
    sum's magnitude ``mag``."""
    assert got.dtype == want.dtype == torch.bfloat16
    diff = (got.float() - want.float()).abs()
    ulp = bf16_ulp(want.float())
    outside = int((diff > ulp + TOL * mag).sum())
    share, enough = bf16_equal(got, want)
    assert enough, (f'{share:.5f} of the elements bit-equal ({outside} '
                    f'outside the bound)')
    assert outside == 0, float((diff / ulp).max())


def check_call(feats, keys, plan, w, epi=None):
    """Both tensor-core kernels on one call, with the epilogue ``epi`` and
    without any, against their plain versions; launches counted. Returns
    the number of hits."""
    cout = w.shape[2]
    half = feats.to(torch.bfloat16)
    kernels.reset_launches()
    for kw in ({}, epi) if epi else ({},):
        mag = tmc.match_conv_plain(feats.abs(), keys, plan, w.abs())
        mag16 = tmc.match_conv_plain(half.float().abs(), keys, plan, w.abs())
        if kw.get('scale') is not None:
            mag, mag16 = mag * kw['scale'].abs(), mag16 * kw['scale'].abs()
        if kw.get('shift') is not None:
            mag, mag16 = mag + kw['shift'].abs(), mag16 + kw['shift'].abs()
        got = tmc.match_conv(feats, keys, plan, w, **kw)
        for gemm in ('x3', 'exact'):
            want = tmc.match_conv_plain(feats, keys, plan, w, gemm=gemm, **kw)
            torch.cuda.synchronize()
            assert got.shape == (plan.k_out, cout) and torch.isfinite(
                got).all()
            diff = (got - want).abs()
            assert (diff <= TOL * mag).all(), (gemm, float(
                (diff / mag.clamp_min(1e-30)).max()))
            assert float(diff.max()) <= TOL * float(want.abs().max())
        got16 = tmc.match_conv(half, keys, plan, w, **kw)
        want16 = tmc.match_conv_plain(half, keys, plan, w, **kw)
        torch.cuda.synchronize()
        check_bf16(got16, want16, mag16)
    n = 2 if epi else 1
    assert kernels.launches['match_conv_x3'] == n
    assert kernels.launches['match_conv_bf16'] == n
    assert kernels.launches['match_conv'] == 0
    return int((tmc.plan_rows_plain(keys, plan) >= 0).sum())


def epilogue(rng, k_out, cout, device):
    return dict(scale=torch.from_numpy(rng.uniform(0.5, 1.5, cout).astype(
                    np.float32)).to(device),
                shift=torch.from_numpy(rng.uniform(-0.3, 0.3, cout).astype(
                    np.float32)).to(device), relu=True,
                out_valid=torch.from_numpy(rng.rand(k_out) < 0.9).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize('cin,cout', WIDTHS)
def test_match_kernels_at_flagship_widths(cin, cout, card, frame):
    """The frame's subm plan (Ta 27, ~40k rows, INT_MAX tail)."""
    rng = np.random.RandomState(90 + cin + cout)
    _, keys, plan = frame[0]
    valid = (keys != INT_MAX).cpu().numpy()
    feats = rand_feats(rng, keys.shape[0], cin, valid).to(card)
    w = torch.from_numpy((rng.randn(27, cin, cout) * 0.1).astype(
        np.float32)).to(card)
    hits = check_call(feats, keys, plan, w,
                      epilogue(rng, plan.k_out, cout, card))
    assert hits > plan.k_out


@pytest.mark.cuda
@pytest.mark.parametrize('cin', [5, 16, 192])
def test_match_kernels_on_frame_plans(cin, card, frame):
    """Subm, downsample (affine) and dual (explicit queries) plans, Ta 27,
    3 and 8."""
    rng = np.random.RandomState(95 + cin)
    assert {p.num_taps for _, _, p in frame} == {27, 3, 8}
    assert any(p.queries is not None for _, _, p in frame)
    for name, keys, plan in frame:
        valid = (keys != INT_MAX).cpu().numpy()
        feats = rand_feats(rng, keys.shape[0], cin, valid).to(card)
        w = torch.from_numpy((rng.randn(plan.num_taps, cin, 32) * 0.1)
                             .astype(np.float32)).to(card)
        hits = check_call(feats, keys, plan, w,
                          epilogue(rng, plan.k_out, 32, card))
        assert hits > plan.k_out // 2, name


@pytest.mark.cuda
@pytest.mark.parametrize('ta', [27, 8, 3])
@pytest.mark.parametrize('k_out', [1000, 1])
def test_match_kernels_random_plans(ta, k_out, card):
    """Random keys with an INT_MAX tail; INT_MAX rows and queries; a
    128-row block (rows 256-383) that no tap hits."""
    rng = np.random.RandomState(97 + ta + k_out)
    keys = random_keys(rng, 5000, 1 << 14).to(card)
    inb = rng.rand(k_out, ta) < 0.9
    inb[256:384] = False
    inb = torch.from_numpy(inb).to(card)
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
    feats = rand_feats(rng, keys.shape[0], 48).to(card)
    w = torch.from_numpy((rng.randn(ta, 48, 40) * 0.1).astype(
        np.float32)).to(card)
    epi = epilogue(rng, k_out, 40, card)
    for plan in (affine, explicit):
        check_call(feats, keys, plan, w, epi)
        if k_out > 384:
            # the block no tap hits: the epilogue of a zero sum
            out = tmc.match_conv(feats, keys, plan, w, **epi)
            want = torch.where(epi['out_valid'][256:384, None],
                               torch.relu(epi['shift']).expand(128, 40), 0.0)
            assert torch.equal(out[256:384], want)


@pytest.mark.cuda
def test_match_kernels_odd_widths_and_unaligned_views(card):
    """Views 4 and 8 bytes off a 16-byte boundary (the narrow copies at
    widths 16-byte copies would fit), an INT_MAX row whose tap offsets land
    on a real key or wrap."""
    rng = np.random.RandomState(99)
    _, keys, plan = frame_plans(card, n_points=8000, seed=5)[0]
    k_in = keys.shape[0]
    for cin, skip in ((16, 1), (8, 4), (12, 2), (7, 1)):
        big = rand_feats(rng, k_in + 1, cin).to(card).view(-1)
        feats = big[skip:skip + k_in * cin].view(k_in, cin)
        w = torch.from_numpy((rng.randn(27, cin, 24) * 0.1).astype(
            np.float32)).to(card)
        check_call(feats, keys, plan, w)
        half = big.to(torch.bfloat16)[skip:skip + k_in * cin].view(k_in, cin)
        got = tmc.match_conv(half, keys, plan, w)
        want = tmc.match_conv_plain(half, keys, plan, w)
        torch.cuda.synchronize()
        mag = tmc.match_conv_plain(half.float().abs(), keys, plan, w.abs())
        check_bf16(got, want, mag)
    wrap_keys = torch.tensor([0, 5, 9, INT_MAX], dtype=torch.int32,
                             device=card)
    wrap = tmc.MatchPlan(
        inb=torch.ones(2, 2, dtype=torch.bool, device=card),
        okeys=torch.tensor([4, INT_MAX], dtype=torch.int32, device=card),
        dkey=torch.tensor([1, -INT_MAX + 5], dtype=torch.int32, device=card))
    feats = torch.arange(8, dtype=torch.float32, device=card).reshape(4, 2)
    ones = torch.ones(2, 2, 1, device=card)
    for f in (feats, feats.to(torch.bfloat16)):
        out = tmc.match_conv(f, wrap_keys, wrap, ones).float()
        assert out.cpu().tolist() == [[5.0], [0.0]]


@pytest.mark.cuda
def test_highest_takes_the_ffma_kernel_for_fp32(card, monkeypatch):
    monkeypatch.setenv('MSMD_CONV_GEMM', 'highest')
    rng = np.random.RandomState(100)
    _, keys, plan = frame_plans(card, n_points=8000, seed=6)[0]
    feats = rand_feats(rng, keys.shape[0], 32).to(card)
    w = torch.from_numpy((rng.randn(27, 32, 32) * 0.1).astype(
        np.float32)).to(card)
    kernels.reset_launches()
    out = tmc.match_conv(feats, keys, plan, w)
    out16 = tmc.match_conv(feats.to(torch.bfloat16), keys, plan, w)
    torch.cuda.synchronize()
    assert {k: v for k, v in kernels.launches.items() if v} == \
        {'match_conv': 1, 'match_conv_bf16': 1}
    mag = tmc.match_conv_plain(feats.abs(), keys, plan, w.abs())
    diff = (out - tmc.match_conv_plain(feats, keys, plan, w)).abs()
    assert (diff <= TOL * mag).all()
    assert out16.dtype == torch.bfloat16


@pytest.mark.cuda
@pytest.mark.parametrize('cin,cout', [(16, 32), (32, 64), (64, 128),
                                      (128, 128)])
def test_bf16_input_gradient_over_the_dual_plan(cin, cout, card, frame,
                                                monkeypatch):
    """The bf16-compute train step's one-hot ``d_feats``: ``MatchConv``'s
    backward on bf16 features and a bf16 cotangent runs ``match_conv_bf16``
    over a strided conv's dual plan (explicit queries against the conv's
    output keys) with the weights tap-flipped and transposed, held to the
    plain bf16 version of that call by the bf16 rule; ``dw``, the exact
    ``conv_dw`` on the widened operands, to its plain version."""
    monkeypatch.setenv('MSMD_CONV_ALGO', 'onehot')
    rng = np.random.RandomState(101 + cin)
    (keys, down), (out_keys, dual) = [
        (k, p) for name, k, p in frame if name.startswith(
            ('down k3', 'dual k3'))][:2]
    plan = dataclasses.replace(down, dual=dual, dual_keys=out_keys)
    valid = (keys != INT_MAX).cpu().numpy()
    feats = rand_feats(rng, keys.shape[0], cin, valid).to(card).to(
        torch.bfloat16).requires_grad_(True)
    w = torch.from_numpy((rng.randn(plan.num_taps, cin, cout) * 0.1)
                         .astype(np.float32)).to(card).requires_grad_(True)
    out = tmc.MatchConv.apply(feats, w, plan, keys)
    g = rand_feats(rng, plan.k_out, cout).to(card).to(torch.bfloat16)
    kernels.reset_launches()
    out.backward(g)
    torch.cuda.synchronize()
    assert kernels.launches['match_conv_bf16'] == 1
    assert kernels.launches['conv_dw'] == 1
    assert feats.grad.dtype == torch.bfloat16 and w.grad.dtype == torch.float32
    w_t = w.detach().flip(0).transpose(1, 2).contiguous()
    want = tmc.match_conv_plain(g, out_keys, dual, w_t)
    mag = tmc.match_conv_plain(g.float().abs(), out_keys, dual, w_t.abs())
    check_bf16(feats.grad, want, mag)
    rows = tmc.plan_rows_plain(keys, plan)
    dw = tmc.conv_dw_plain(feats.detach().float(), rows, g.float())
    dw_mag = tmc.conv_dw_plain(feats.detach().float().abs(), rows,
                               g.float().abs())
    assert ((w.grad - dw).abs() <= TOL * dw_mag).all()
    assert int((rows >= 0).sum()) > plan.k_out
