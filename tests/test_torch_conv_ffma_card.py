"""The exact fp32 (FFMA) conv kernels ``gather_gemm_conv`` (rulebook rows)
and ``match_conv`` (the one-hot engine's search inside), the
``MSMD_CONV_GEMM=highest`` products, against their exact plain versions on
an NVIDIA card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_conv_ffma_card.py

Both kernels run on the same calls: ``match_conv`` on a plan,
``gather_gemm_conv`` on the plan's rows (``plan_rows_plain``). Each
element within 1e-4 (``chip_smoke.TOL``) of the magnitude of its own sum,
and the whole within 1e-4 of the largest value, with the epilogue and
without; two calls bit-equal. On: widths 16-192, Cin != Cout, 5 and 200
(two column blocks of 104); Ta 27, 8 and 3; affine and explicit-query
plans; the subm, downsample and dual plans of a synthetic LiDAR frame; a
tap without hits, every row missing, K_out 0 and K_out not a multiple of
the 128-row block; unaligned views of the features and the weights (the
4-byte copies, the same bits). Without a card every test skips. No JAX
here: the machine with the card runs the port alone.
"""
import numpy as np
import pytest
import torch

from chip_smoke import TOL
from msmdfusion_torch import kernels
from msmdfusion_torch.ops.sparse import matchconv as tmc
from msmdfusion_torch.ops.sparse.tensor import INT_MAX
from tests.test_torch_conv_dw_card import WIDTHS
from tests.test_torch_rows_card import frame_plans, random_keys


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card: the CUDA kernels run only there')
    for k in ('MSMD_CONV_DTYPE', 'MSMD_CONV_ALGO'):
        monkeypatch.delenv(k, raising=False)
    # the exact product (the default x3 route takes the tensor-core kernels)
    monkeypatch.setenv('MSMD_CONV_GEMM', 'highest')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


@pytest.fixture(scope='module')
def frame():
    """The synthetic frame's plans on the card (built once)."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card: the CUDA kernels run only there')
    return frame_plans(torch.device('cuda'))


def rand(rng, shape, device, binades=4):
    """fp32 values over 2 x ``binades`` binades."""
    x = rng.randn(*shape) * 2.0 ** rng.randint(-binades, binades, shape)
    return torch.from_numpy(x.astype(np.float32)).to(device)


def epilogue(rng, k_out, cout, device):
    return dict(scale=torch.from_numpy(rng.uniform(0.5, 1.5, cout).astype(
                    np.float32)).to(device),
                shift=torch.from_numpy(rng.uniform(-0.3, 0.3, cout).astype(
                    np.float32)).to(device), relu=True,
                out_valid=torch.from_numpy(rng.rand(k_out) < 0.9).to(device))


def held(got, want, mag):
    assert got.shape == want.shape and torch.isfinite(got).all()
    diff = (got - want).abs()
    assert (diff <= TOL * mag).all(), float((diff / mag.clamp_min(1e-30))
                                            .max())
    if diff.numel():
        assert float(diff.max()) <= TOL * float(want.abs().max())


def check_both(feats, keys, plan, w, epi=None):
    """Both exact kernels on one call, with the epilogue ``epi`` and
    without any: each against the exact plain version, two calls
    bit-equal, launches counted. Returns (rulebook, one-hot) outputs of
    the call without epilogue."""
    rows = tmc.plan_rows_plain(keys, plan)
    outs = []
    kernels.reset_launches()
    for kw in ({}, epi) if epi else ({},):
        mag = tmc.gather_gemm_conv_plain(feats.abs(), rows, w.abs())
        if kw.get('scale') is not None:
            mag = mag * kw['scale'].abs()
        if kw.get('shift') is not None:
            mag = mag + kw['shift'].abs()
        want = tmc.gather_gemm_conv_plain(feats, rows, w, **kw)
        for run in (lambda: tmc.gather_gemm_conv(feats, rows, w, **kw),
                    lambda: tmc.match_conv(feats, keys, plan, w, **kw)):
            got, again = run(), run()
            torch.cuda.synchronize()
            assert torch.equal(got, again)
            held(got, want, mag)
            if not kw:
                outs.append(got)
    n = 4 if epi else 2
    assert {k: v for k, v in kernels.launches.items() if v} == \
        {'gather_gemm_conv': n, 'match_conv': n}
    return outs


@pytest.mark.cuda
@pytest.mark.parametrize('cin,cout', WIDTHS)
def test_exact_conv_kernels_widths_on_card(cin, cout, card, frame):
    """The frame's subm plan (Ta 27, ~40k rows, the keys' INT_MAX tail)
    with a tap that no row hits."""
    rng = np.random.RandomState(200 + cin * 7 + cout)
    _, keys, plan = frame[0]
    inb = plan.inb.clone()
    inb[:, 4] = False
    plan = tmc.MatchPlan(inb=inb, okeys=plan.okeys, dkey=plan.dkey)
    feats = rand(rng, (keys.shape[0], cin), card)
    w = rand(rng, (27, cin, cout), card, 2) * 0.1
    rulebook, onehot = check_both(feats, keys, plan, w,
                                  epilogue(rng, plan.k_out, cout, card))
    # the same rows, the same sums in the same order
    assert torch.equal(rulebook, onehot)
    assert plan.k_out % tmc.FFMA_ROWS


@pytest.mark.cuda
@pytest.mark.parametrize('cin,cout', [(5, 16), (16, 16), (64, 64),
                                      (192, 128), (80, 96)])
def test_exact_conv_kernels_on_frame_plans_on_card(cin, cout, card, frame):
    """Subm, downsample (affine) and dual (explicit queries) plans, Ta 27,
    3 and 8."""
    rng = np.random.RandomState(300 + cin + cout)
    assert {p.num_taps for _, _, p in frame} == {27, 3, 8}
    assert any(p.queries is not None for _, _, p in frame)
    for name, keys, plan in frame:
        valid = (keys != INT_MAX)[:, None]
        feats = rand(rng, (keys.shape[0], cin), card) * valid
        w = rand(rng, (plan.num_taps, cin, cout), card, 2) * 0.1
        check_both(feats, keys, plan, w,
                   epilogue(rng, plan.k_out, cout, card))


@pytest.mark.cuda
@pytest.mark.parametrize('ta', [27, 8, 3])
@pytest.mark.parametrize('k_out', [3001, 128, 1])
def test_exact_conv_kernels_random_plans_on_card(ta, k_out, card):
    """Random keys with an INT_MAX tail; affine plans with INT_MAX rows
    and explicit ones with INT_MAX queries; a 128-row block (rows 256-383)
    that no tap hits, whose outputs are the epilogue of a zero sum."""
    rng = np.random.RandomState(400 + ta + k_out)
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
    feats = rand(rng, (keys.shape[0], 48), card)
    w = rand(rng, (ta, 48, 40), card, 2) * 0.1
    epi = epilogue(rng, k_out, 40, card)
    for plan in (affine, explicit):
        check_both(feats, keys, plan, w, epi)
        if k_out > 384:
            for out in (tmc.match_conv(feats, keys, plan, w, **epi),
                        tmc.gather_gemm_conv(
                            feats, tmc.plan_rows_plain(keys, plan), w,
                            **epi)):
                want = torch.where(epi['out_valid'][256:384, None],
                                   torch.relu(epi['shift']).expand(128, 40),
                                   0.0)
                assert torch.equal(out[256:384], want)


@pytest.mark.cuda
def test_exact_conv_kernels_empty_missing_and_unaligned_on_card(card):
    rng = np.random.RandomState(500)
    _, keys, plan = frame_plans(card, n_points=8000, seed=7)[0]
    k_in, k_out = keys.shape[0], plan.k_out
    for cin, cout in ((16, 16), (96, 192)):
        feats = rand(rng, (k_in, cin), card)
        w = rand(rng, (27, cin, cout), card, 2)
        epi = epilogue(rng, k_out, cout, card)
        # every row missing: the epilogue of zero sums
        none = tmc.MatchPlan(inb=torch.zeros_like(plan.inb),
                             okeys=plan.okeys, dkey=plan.dkey)
        for out in check_both(feats, keys, none, w):
            assert out.shape == (k_out, cout) and not out.any()
        # K_out 0
        empty = tmc.MatchPlan(inb=plan.inb[:0], okeys=plan.okeys[:0],
                              dkey=plan.dkey)
        kernels.reset_launches()
        a = tmc.gather_gemm_conv(feats, tmc.plan_rows_plain(keys, empty), w)
        b = tmc.match_conv(feats, keys, empty, w, **epilogue(rng, 0, cout,
                                                             card))
        torch.cuda.synchronize()
        assert a.shape == b.shape == (0, cout)
        assert kernels.launches['gather_gemm_conv'] == 1
        assert kernels.launches['match_conv'] == 1
    # views off 16 bytes (features and weights), and widths that 16-byte
    # copies do not fit: the 4-byte copies, the same sums in the same order
    for cin, cout, skip in ((16, 16, 1), (32, 64, 2), (96, 96, 3),
                            (12, 24, 1), (7, 13, 0), (5, 16, 1)):
        feats = rand(rng, (k_in, cin), card)
        w = rand(rng, (27, cin, cout), card, 2)
        fbuf = torch.empty(feats.numel() + skip, device=card)
        wbuf = torch.empty(w.numel() + skip, device=card)
        fbuf[skip:] = feats.reshape(-1)
        wbuf[skip:] = w.reshape(-1)
        f_view = fbuf[skip:].view(feats.shape)
        w_view = wbuf[skip:].view(w.shape)
        assert (f_view.data_ptr() % 16 != 0) == (skip != 0)
        aligned = check_both(feats, keys, plan, w)
        unaligned = check_both(f_view, keys, plan, w_view)
        for x, y in zip(aligned, unaligned):
            assert torch.equal(x, y)


@pytest.mark.cuda
def test_exact_conv_kernels_refuse_too_many_taps_on_card(card):
    rows = torch.full((10, tmc.FFMA_MAX_TAPS + 1), -1, dtype=torch.int32,
                      device=card)
    feats = torch.zeros(4, 8, device=card)
    w = torch.zeros(tmc.FFMA_MAX_TAPS + 1, 8, 8, device=card)
    with pytest.raises(ValueError, match='taps'):
        tmc.gather_gemm_conv(feats, rows, w)
