"""The fp32 rulebook engine's x3 kernels (``gather_gemm_conv_x3``,
``conv_dw_x3``, the Hopper wgmma kernels of ``csrc/gather_gemm_conv_x3.cu``
and ``csrc/conv_dw_x3.cu``) against their plain versions on an NVIDIA card,
at the flagship's widths and beyond (Cin 5 takes the 4-byte gather; 200
output channels one 208-wide block in the forward, three column blocks of
80 beside three slabs in ``dw``; 256 two column blocks of 192), 27 and 62
taps, 64-row tiles that miss whole taps, an empty plan and few-row calls:

    python -m pytest -m cuda tests/test_torch_conv_x3_card.py

Each conv element within 1e-4 of the magnitude of its own sum, and the
whole within 1e-4 of the largest value, against the x3 plain version (the
same split, fp32 sums in another order) and against the exact one (x3 is
~2^-17 of each sum's magnitude from it), with and without the epilogue;
``dw`` the same; two calls of either bit-equal; an x3 call without its plan's
``RowOrder`` raises; ``MSMD_CONV_GEMM=highest`` launches the exact fp32
kernels. Without a card every test skips. No JAX here: the machine with
the card runs the port alone.
"""
import numpy as np
import pytest
import torch

from msmdfusion_torch import kernels
from msmdfusion_torch.ops.sparse import matchconv as tmc


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card: the CUDA kernels run only there')
    for k in ('MSMD_CONV_GEMM', 'MSMD_CONV_DTYPE', 'MSMD_CONV_ALGO'):
        monkeypatch.delenv(k, raising=False)
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def held(got, want, magnitude, tol=1e-4):
    assert torch.isfinite(got).all()
    diff = (got - want).abs()
    assert (diff <= tol * magnitude).all(), float((diff / magnitude).max())
    assert float(diff.max()) <= tol * float(want.abs().max())


def big_rows(rng, k_out, k_in, ta, fill):
    rows = rng.randint(0, k_in, (k_out, ta))
    rows[rng.rand(k_out, ta) > fill] = -1
    return torch.from_numpy(rows.astype(np.int32))


def tap_tiles(rng, k_out, k_in, ta, tile=64):
    """Rows whose sorted 64-row tiles each hit only a few taps: row r hits
    the taps of its group r // 200 (a run of 5), so that after the
    ``RowOrder`` sort most tiles skip most taps."""
    rows = np.full((k_out, ta), -1)
    for r in range(k_out):
        first = (r // 200 * 5) % ta
        for t in range(first, min(first + 5, ta)):
            if rng.rand() < 0.7:
                rows[r, t] = rng.randint(0, k_in)
    return torch.from_numpy(rows.astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize('cin,cout,ta', [
    (5, 16, 27), (16, 16, 27), (32, 64, 27), (64, 128, 27), (80, 96, 27),
    (96, 128, 27), (128, 128, 27), (128, 192, 27), (192, 192, 27),
    (192, 200, 27), (16, 200, 27), (16, 16, 62), (64, 64, 62),
    (32, 256, 8)])
def test_x3_conv_kernel_on_card(cin, cout, ta, card):
    rng = np.random.RandomState(70)
    rows = big_rows(rng, 3000, 2500, ta, 0.3)
    feats = torch.from_numpy((rng.randn(2500, cin)
                              * 2.0 ** rng.randint(-4, 4, (2500, cin)))
                             .astype(np.float32))
    w = torch.from_numpy((rng.randn(ta, cin, cout) * 0.1).astype(np.float32))
    epi = dict(scale=torch.rand(cout) + 0.5, shift=torch.rand(cout) - 0.5,
               relu=True, out_valid=torch.rand(3000) < 0.9)
    args = [x.to(card) for x in (feats, rows, w)]
    epi_d = {k: v.to(card) if torch.is_tensor(v) else v
             for k, v in epi.items()}
    order = tmc.row_order(args[1])
    kernels.reset_launches()
    for kw in ({}, epi_d):
        got = tmc.gather_gemm_conv(*args, order=order, **kw)
        again = tmc.gather_gemm_conv(*args, order=order, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        mag = tmc.gather_gemm_conv_plain(args[0].abs(), args[1],
                                         args[2].abs())
        if kw:
            mag = mag * kw['scale'].abs() + kw['shift'].abs()
        for gemm in ('x3', 'exact'):
            want = tmc.gather_gemm_conv_plain(*args, gemm=gemm, **kw)
            torch.cuda.synchronize()
            held(got, want, mag)
    assert kernels.launches['gather_gemm_conv_x3'] == 4
    assert kernels.launches['gather_gemm_conv'] == 0


@pytest.mark.cuda
@pytest.mark.parametrize('cin,cout,ta', [
    (5, 16, 27), (16, 16, 27), (32, 32, 27), (32, 64, 27), (64, 64, 27),
    (64, 128, 27), (80, 96, 27), (96, 96, 27), (128, 128, 27),
    (128, 192, 27), (192, 192, 27), (192, 200, 27), (256, 64, 27),
    (16, 16, 62), (64, 64, 62)])
def test_x3_dw_kernel_on_card(cin, cout, ta, card):
    rng = np.random.RandomState(71)
    rows = big_rows(rng, 4000, 3000, ta, 0.3)
    feats = torch.from_numpy(rng.randn(3000, cin).astype(np.float32))
    g = torch.from_numpy((rng.randn(4000, cout)
                          * 2.0 ** rng.randint(-4, 4, (4000, cout)))
                         .astype(np.float32))
    feats, rows, g = feats.to(card), rows.to(card), g.to(card)
    order = tmc.row_order(rows)
    kernels.reset_launches()
    got = tmc.conv_dw(feats, rows, g, order=order)
    again = tmc.conv_dw(feats, rows, g, order=order)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    mag = tmc.conv_dw_plain(feats.abs(), rows, g.abs())
    for gemm in ('x3', 'exact'):
        held(got, tmc.conv_dw_plain(feats, rows, g, gemm=gemm), mag)
    assert kernels.launches['conv_dw_x3'] == 2
    assert kernels.launches['conv_dw'] == 0


@pytest.mark.cuda
@pytest.mark.parametrize('cin,cout', [(16, 16), (64, 64), (192, 192)])
def test_x3_kernels_on_tiles_missing_taps_and_few_rows_on_card(cin, cout,
                                                              card):
    """Sorted 64-row tiles that hit a few taps each (the kernels skip the
    rest), and calls of 1, 7, 64 and 65 rows (one block, part of a tile),
    each held as above, the forward and dw twice bit-equal."""
    rng = np.random.RandomState(74)
    k_in = 1500
    feats = torch.from_numpy(rng.randn(k_in, cin).astype(np.float32)).to(card)
    w = torch.from_numpy((rng.randn(27, cin, cout) * 0.1)
                         .astype(np.float32)).to(card)
    for rows in [tap_tiles(rng, 2000, k_in, 27)] + [
            big_rows(rng, k, k_in, 27, 0.5) for k in (1, 7, 64, 65)]:
        rows = rows.to(card)
        order = tmc.row_order(rows)
        shift = torch.rand(cout, device=card)
        got = tmc.gather_gemm_conv(feats, rows, w, shift=shift, relu=True,
                                   order=order)
        again = tmc.gather_gemm_conv(feats, rows, w, shift=shift, relu=True,
                                     order=order)
        mag = tmc.gather_gemm_conv_plain(feats.abs(), rows, w.abs()) \
            + shift.abs()
        for gemm in ('x3', 'exact'):
            want = tmc.gather_gemm_conv_plain(feats, rows, w, shift=shift,
                                              relu=True, gemm=gemm)
            torch.cuda.synchronize()
            held(got, want, mag)
        assert torch.equal(got, again)
        g = torch.from_numpy(rng.randn(rows.shape[0], cout)
                             .astype(np.float32)).to(card)
        dw = tmc.conv_dw(feats, rows, g, order=order)
        dw_again = tmc.conv_dw(feats, rows, g, order=order)
        torch.cuda.synchronize()
        assert torch.equal(dw, dw_again)
        mag = tmc.conv_dw_plain(feats.abs(), rows, g.abs())
        for gemm in ('x3', 'exact'):
            held(dw, tmc.conv_dw_plain(feats, rows, g, gemm=gemm), mag)


@pytest.mark.cuda
def test_x3_kernels_sparse_empty_and_unordered_on_card(card):
    rng = np.random.RandomState(72)
    k_in = 700
    rows = big_rows(rng, 900, k_in, 27, 0.15).to(card)
    feats = torch.from_numpy(rng.randn(k_in, 32).astype(np.float32)).to(card)
    w = torch.from_numpy(rng.randn(rows.shape[1], 32, 16)
                         .astype(np.float32)).to(card)
    held(tmc.gather_gemm_conv(feats, rows, w, order=tmc.row_order(rows)),
         tmc.gather_gemm_conv_plain(feats, rows, w, gemm='x3'),
         tmc.gather_gemm_conv_plain(feats.abs(), rows, w.abs()))
    none = torch.full((40, 27), -1, dtype=torch.int32, device=card)
    order = tmc.row_order(none)
    shift = torch.rand(16, device=card)
    out = tmc.gather_gemm_conv(feats, none, w[:27], shift=shift, order=order)
    assert torch.equal(out, shift.expand(40, 16))
    g = torch.rand(40, 16, device=card)
    assert not tmc.conv_dw(feats, none, g, order=order).any()
    # an empty plan: no output rows, no pairs
    empty = torch.zeros((0, 27), dtype=torch.int32, device=card)
    order = tmc.row_order(empty)
    assert tmc.gather_gemm_conv(feats, empty, w[:27], order=order).shape \
        == (0, 16)
    assert not tmc.conv_dw(feats, empty, torch.zeros(0, 16, device=card),
                           order=order).any()
    # the plan's order is built once per plan, never per call
    with pytest.raises(ValueError, match='row order'):
        tmc.gather_gemm_conv(feats, rows, w)
    with pytest.raises(ValueError, match='row order'):
        tmc.conv_dw(feats, rows, torch.rand(900, 16, device=card))
    with pytest.raises(ValueError, match='pair lists'):
        tmc.conv_dw(feats, none, g, order=tmc.row_order(none, pairs=False))


@pytest.mark.cuda
def test_highest_launches_the_exact_kernels_on_card(card, monkeypatch):
    monkeypatch.setenv('MSMD_CONV_GEMM', 'highest')
    rng = np.random.RandomState(73)
    rows = big_rows(rng, 2000, 1500, 27, 0.3).to(card)
    feats = torch.from_numpy(rng.randn(1500, 64).astype(np.float32)).to(card)
    w = torch.from_numpy((rng.randn(27, 64, 64) * 0.1)
                         .astype(np.float32)).to(card)
    g = torch.from_numpy(rng.randn(2000, 64).astype(np.float32)).to(card)
    kernels.reset_launches()
    out = tmc.gather_gemm_conv(feats, rows, w)         # no order needed
    dw = tmc.conv_dw(feats, rows, g)
    torch.cuda.synchronize()
    assert {k: v for k, v in kernels.launches.items() if v} == \
        {'gather_gemm_conv': 1, 'conv_dw': 1}
    held(out, tmc.gather_gemm_conv_plain(feats, rows, w),
         tmc.gather_gemm_conv_plain(feats.abs(), rows, w.abs()))
    held(dw, tmc.conv_dw_plain(feats, rows, g),
         tmc.conv_dw_plain(feats.abs(), rows, g.abs()))
