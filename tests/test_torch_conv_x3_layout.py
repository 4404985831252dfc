"""The host side of the Hopper x3 kernels (``gather_gemm_conv_x3``,
``conv_dw_x3``), on the CPU:

- ``x3_layout``: the weights' bf16 hi and lo parts laid out for the
  forward's bulk copies ([col_blocks][Ta][units][hi, lo][np / 8][2][8][8],
  wgmma's K-major core matrices), un-laid back, bit-equal to
  ``split_hi_lo``'s parts, zeros in the padding, at every width the
  kernel serves (5-208 channels, column blocks above 208, 3-62 taps);
- ``conv_dw_x3_launch``: blocks that fit the kernel (slabs, column
  widths), the same launch for the same shapes and plan, and chunks that
  cover every pair of the order's lists exactly once, in tap order
  (``dw_x3_chunks``, the kernel's ``find_chunk``), on synthetic hit
  counts and on a plan's own ``RowOrder``.
"""
import math

import numpy as np
import pytest
import torch

from msmdfusion_torch.ops.sparse import matchconv as tmc


def unlay(laid, ta, cin, cout):
    """[Ta, Cin, Cout] hi and lo from ``x3_layout``'s tiles."""
    cb, _, units, _, groups, _, _, _ = laid.shape
    w = laid.permute(3, 1, 2, 5, 7, 0, 4, 6).reshape(
        2, ta, units * tmc.X3_UNIT, cb * groups * 8)
    return w[:, :, :cin, :cout], w


@pytest.mark.parametrize('ta,cin,cout', [
    (27, 5, 16), (27, 16, 16), (27, 16, 32), (27, 32, 64), (27, 64, 128),
    (27, 80, 80), (27, 96, 96), (27, 128, 128), (3, 128, 192),
    (27, 192, 192), (27, 192, 200), (8, 64, 256), (62, 16, 16),
    (27, 4, 20)])
def test_x3_layout_unlays_to_the_split(ta, cin, cout):
    rng = np.random.RandomState(ta * 1000 + cin + cout)
    w = torch.from_numpy((rng.randn(ta, cin, cout)
                          * 2.0 ** rng.randint(-8, 8, (ta, cin, cout)))
                         .astype(np.float32))
    laid, np_, col_blocks = tmc.x3_layout(w)
    assert laid.dtype == torch.bfloat16 and laid.is_contiguous()
    assert np_ in tmc.X3_WIDTHS and col_blocks * np_ >= cout
    assert col_blocks == 1 or np_ == 192
    units = math.ceil(cin / tmc.X3_UNIT)
    assert laid.shape == (col_blocks, ta, units, 2, np_ // 8, 2, 8, 8)
    (hi, lo), whole = unlay(laid, ta, cin, cout)
    want_hi, want_lo = tmc.split_hi_lo(w)
    assert torch.equal(hi.float(), want_hi)
    assert torch.equal(lo.float(), want_lo)
    # the padding of Cin and of Cout is zero
    pad = torch.ones_like(whole, dtype=torch.bool)
    pad[:, :, :cin, :cout] = False
    assert not whole[pad].any()
    # one unit's hi and lo: one contiguous tile of np x 16 x 2 bf16
    assert laid[0, 0, 0].numel() * 2 == np_ * 64


def test_x3_layout_core_matrices():
    """Element (n, k) of a unit sits in core matrix (n // 8, k // 8), row
    n % 8, column k % 8: wgmma's K-major layout without swizzle (16 bytes
    a row of 8 k, B_LBO = 128 bytes between a group's two halves of K,
    B_SBO = 256 between groups of 8 columns)."""
    ta, cin, cout = 2, 16, 32
    w = torch.arange(ta * cin * cout, dtype=torch.float32).view(
        ta, cin, cout)
    laid, _, _ = tmc.x3_layout(w)
    tile = laid[0, 1, 0, 0].reshape(-1)          # tap 1, unit 0, hi
    for n in range(cout):
        for k in range(cin):
            off = (((n // 8) * 2 + k // 8) * 8 + n % 8) * 8 + k % 8
            assert float(tile[off]) == float(
                w[1, k, n].to(torch.bfloat16))


SHAPES = [(5, 16), (16, 16), (16, 32), (32, 64), (64, 64), (64, 128),
          (80, 80), (80, 96), (96, 96), (96, 128), (128, 128), (128, 192),
          (192, 192), (192, 200), (256, 64)]


@pytest.mark.parametrize('cin,cout', SHAPES)
def test_dw_x3_launch_covers_every_pair_once(cin, cout):
    rng = np.random.RandomState(cin * 7 + cout)
    for hits in ([0] * 27, [1] + [0] * 26,
                 list(rng.randint(0, 90000, 27)),
                 list(rng.randint(0, 300, 3)), [2247000] + [0] * 26,
                 list(rng.randint(0, 900, 62))):
        launch = tmc.conv_dw_x3_launch(hits, cin, cout)
        assert launch == tmc.conv_dw_x3_launch(list(hits), cin, cout)
        assert 1 <= launch.slabs <= 3
        assert launch.nb in tmc.DW_X3_WIDTHS
        assert launch.slabs <= 2 or launch.nb <= 96
        assert launch.nb * launch.col_blocks >= cout
        assert launch.nb * (launch.col_blocks - 1) < cout
        assert launch.slabs * tmc.DW_X3_SLAB >= min(cin, 3 * tmc.DW_X3_SLAB)
        assert launch.chunk % tmc.DW_X3_PAIRS == 0
        assert launch.chunk >= tmc.DW_X3_MIN_CHUNK
        chunks = tmc.dw_x3_chunks(hits, launch.chunk)
        assert len(chunks) == launch.n_chunks
        # every pair once, in order: the chunks tile 0 .. sum(hits)
        ends = [0] + [p1 for _, _, p1 in chunks]
        assert [p0 for _, p0, _ in chunks] == ends[:-1]
        assert ends[-1] == sum(hits)
        start = np.concatenate([[0], np.cumsum(hits)])
        taps = [t for t, _, _ in chunks]
        assert taps == sorted(taps)
        for t, p0, p1 in chunks:
            assert start[t] <= p0 < p1 <= start[t + 1]
            assert p1 - p0 <= launch.chunk


def test_dw_x3_chunks_walk_the_orders_pair_lists():
    """On a plan's own ``RowOrder``: chunk by chunk, the pairs the kernel
    takes are tap t's hits (rows[o, t], o), each once, o ascending."""
    rng = np.random.RandomState(90)
    rows = rng.randint(0, 500, (700, 27))
    rows[rng.rand(700, 27) > 0.3] = -1
    rows = torch.from_numpy(rows.astype(np.int32))
    order = tmc.row_order(rows)
    launch = tmc.conv_dw_x3_launch(order.tap_hits, 32, 32)
    seen = {t: [] for t in range(27)}
    for t, p0, p1 in tmc.dw_x3_chunks(order.tap_hits, launch.chunk):
        outs = order.pair_out[p0:p1].long()
        assert torch.equal(rows[outs, t], order.pair_in[p0:p1])
        seen[t] += outs.tolist()
    for t in range(27):
        want = torch.nonzero(rows[:, t] >= 0).squeeze(1).tolist()
        assert seen[t] == want
