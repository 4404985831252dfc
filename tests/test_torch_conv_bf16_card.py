"""The packed bf16 kernels (``gather_gemm_conv_bf16``, ``conv_dw_bf16``)
against their plain versions on an NVIDIA card, at the flagship's widths
(Cin 5 takes the 4-byte gather; 200 output channels two column blocks):

    python -m pytest -m cuda tests/test_torch_conv_bf16_card.py

Each conv element within 1e-4 of the magnitude of its own sum and the
whole within 1e-4 of the largest value, with and without the epilogue;
``dw`` the same, and two calls bit-equal; the rows kernels' tap-hit masks
equal to ``row_masks`` of their rows. Without a card every test skips.
No JAX here: the machine with the card runs the port alone.
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
    monkeypatch.setenv('MSMD_CONV_DTYPE', 'bfloat16')
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


@pytest.mark.cuda
@pytest.mark.parametrize('cin,cout', [(5, 16), (16, 16), (32, 64), (80, 96),
                                      (96, 128), (128, 192), (192, 192),
                                      (16, 200)])
def test_packed_conv_kernel_on_card(cin, cout, card):
    rng = np.random.RandomState(47)
    rows = big_rows(rng, 3000, 2500, 27, 0.3)
    feats = torch.from_numpy(rng.randn(2500, cin).astype(np.float32))
    w = torch.from_numpy((rng.randn(27, cin, cout) * 0.1).astype(np.float32))
    epi = dict(scale=torch.rand(cout) + 0.5, shift=torch.rand(cout) - 0.5,
               relu=True, out_valid=torch.rand(3000) < 0.9)
    args = [x.to(card) for x in (feats, rows, w)]
    epi_d = {k: v.to(card) if torch.is_tensor(v) else v
             for k, v in epi.items()}
    order = tmc.row_order(args[1])
    kernels.reset_launches()
    for kw in ({}, epi_d):
        got = tmc.gather_gemm_conv(*args, order=order, **kw)
        want = tmc.gather_gemm_conv_plain(*args, **kw)
        torch.cuda.synchronize()
        mag = tmc.gather_gemm_conv_plain(args[0].abs(), args[1],
                                         args[2].abs())
        if kw:
            mag = mag * kw['scale'].abs() + kw['shift'].abs()
        held(got, want, mag)
    assert kernels.launches['gather_gemm_conv_bf16'] == 2


@pytest.mark.cuda
@pytest.mark.parametrize('cin,cout', [(5, 16), (16, 16), (32, 32), (64, 64),
                                      (80, 96), (128, 128), (192, 192)])
def test_packed_dw_kernel_on_card(cin, cout, card):
    rng = np.random.RandomState(48)
    rows = big_rows(rng, 4000, 3000, 27, 0.3)
    feats = torch.from_numpy(rng.randn(3000, cin).astype(np.float32))
    g = torch.from_numpy(rng.randn(4000, cout).astype(np.float32))
    feats, rows, g = feats.to(card), rows.to(card), g.to(card)
    order = tmc.row_order(rows)
    got = tmc.conv_dw(feats, rows, g, order=order)
    again = tmc.conv_dw(feats, rows, g, order=order)
    want = tmc.conv_dw_plain(feats, rows, g)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    held(got, want, tmc.conv_dw_plain(feats.abs(), rows, g.abs()))


@pytest.mark.cuda
def test_packed_kernels_sparse_and_empty_on_card(card):
    rng = np.random.RandomState(49)
    k_in = 700
    rows = big_rows(rng, 900, k_in, 27, 0.15).to(card)
    feats = torch.from_numpy(rng.randn(k_in, 32).astype(np.float32)).to(card)
    w = torch.from_numpy(rng.randn(rows.shape[1], 32, 16)
                         .astype(np.float32)).to(card)
    held(tmc.gather_gemm_conv(feats, rows, w, order=tmc.row_order(rows)),
         tmc.gather_gemm_conv_plain(feats, rows, w),
         tmc.gather_gemm_conv_plain(feats.abs(), rows, w.abs()))
    none = torch.full((40, 27), -1, dtype=torch.int32, device=card)
    order = tmc.row_order(none)
    shift = torch.rand(16, device=card)
    out = tmc.gather_gemm_conv(feats, none, w[:27], shift=shift, order=order)
    assert torch.equal(out, shift.expand(40, 16))
    g = torch.rand(40, 16, device=card)
    assert not tmc.conv_dw(feats, none, g, order=order).any()
    # the plan's order is built once per plan, never per call
    with pytest.raises(ValueError, match='row order'):
        tmc.gather_gemm_conv(feats, rows, w)
    with pytest.raises(ValueError, match='pair lists'):
        tmc.conv_dw(feats, none, g, order=tmc.row_order(none, pairs=False))


@pytest.mark.cuda
@pytest.mark.parametrize('queries', [False, True])
def test_rows_kernels_write_the_masks_on_card(queries, card):
    rng = np.random.RandomState(50)
    k_in, k_out, ta = 5000, 6000, 27
    keys = np.sort(rng.choice(1 << 14, k_in, replace=False))
    keys = torch.from_numpy(np.concatenate(
        [keys, [2 ** 31 - 1] * 7]).astype(np.int32)).to(card)
    inb = torch.from_numpy(rng.rand(k_out, ta) < 0.9).to(card)
    if queries:
        q = torch.from_numpy(rng.randint(0, 1 << 14, (k_out, ta))
                             .astype(np.int32)).to(card)
        args, fn = (keys, q, inb), tmc.rows_queries
    else:
        okeys = torch.from_numpy(rng.randint(0, 1 << 13, k_out)
                                 .astype(np.int32)).to(card)
        dkey = torch.from_numpy(rng.randint(0, 1 << 13, ta)
                                .astype(np.int32)).to(card)
        args, fn = (keys, okeys, dkey, inb), tmc.rows_affine
    rows, masks = fn(*args, masks=True)
    assert torch.equal(rows, fn(*args))
    assert torch.equal(masks, tmc.row_masks(rows))
    assert int((rows >= 0).sum()) > 1000
