"""The exact fp32 weight-gradient kernel ``conv_dw`` (the one-hot engine's
``dw`` and ``MSMD_CONV_GEMM=highest``'s) against its plain version on an
NVIDIA card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_conv_dw_card.py

Each element within 1e-4 (``chip_smoke.TOL``) of the magnitude of its own
sum, and the whole within 1e-4 of the largest value; two calls bit-equal.
On: widths 16, 32, 64, 80, 96, 128 and 192 and pairs with Cin != Cout (5
and 200 too), on both designs (row streaming up to 32, the GEMM design
above); K_out not a multiple of the chunk; many chunks and several
2048-row segments a chunk; a tap without hits, every row missing, K_out =
0; Ta 27, 8 and 3; the subm, downsample and dual rows of a synthetic LiDAR
frame; unaligned views (the 4-byte copies, the same bits). The one-hot
engine and ``highest`` launch this kernel. Without a card every test
skips. No JAX here: the machine with the card runs the port alone.
"""
import numpy as np
import pytest
import torch

from chip_smoke import TOL
from msmdfusion_torch import kernels
from msmdfusion_torch.ops.sparse import matchconv as tmc
from tests.test_torch_rows_card import frame_plans

WIDTHS = [(16, 16), (32, 32), (64, 64), (96, 96), (128, 128), (192, 192),
          (5, 16), (16, 32), (32, 16), (32, 64), (64, 128), (80, 80),
          (80, 96), (96, 128), (128, 192), (192, 96), (16, 200)]


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card: the CUDA kernels run only there')
    for k in ('MSMD_CONV_DTYPE', 'MSMD_CONV_ALGO'):
        monkeypatch.delenv(k, raising=False)
    # the exact product on the rulebook engine (the default x3 route takes
    # conv_dw_x3)
    monkeypatch.setenv('MSMD_CONV_GEMM', 'highest')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


@pytest.fixture(scope='module')
def frame():
    """The synthetic frame's plans on the card (built once)."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card: the CUDA kernels run only there')
    return frame_plans(torch.device('cuda'))


def make(rng, k_out, k_in, ta, cin, cout, device, fill=0.3):
    """Rows with ~``fill`` hits; features over eight binades."""
    rows = rng.randint(0, k_in, (k_out, ta))
    rows[rng.rand(k_out, ta) > fill] = -1
    feats = rng.randn(k_in, cin) * 2.0 ** rng.randint(-4, 4, (k_in, cin))
    g = rng.randn(k_out, cout)
    return (torch.from_numpy(feats.astype(np.float32)).to(device),
            torch.from_numpy(rows.astype(np.int32)).to(device),
            torch.from_numpy(g.astype(np.float32)).to(device))


def check_dw(feats, rows, g):
    """Two kernel calls, bit-equal, each element held to TOL of its sum's
    magnitude against the plain version; returns the kernel's dw."""
    kernels.reset_launches()
    got = tmc.conv_dw(feats, rows, g)
    again = tmc.conv_dw(feats, rows, g)
    torch.cuda.synchronize()
    assert kernels.launches['conv_dw'] == 2
    assert torch.equal(got, again)
    want = tmc.conv_dw_plain(feats, rows, g)
    mag = tmc.conv_dw_plain(feats.abs(), rows, g.abs())
    assert torch.isfinite(got).all()
    diff = (got - want).abs()
    assert (diff <= TOL * mag).all(), float((diff / mag.clamp_min(1e-30))
                                            .max())
    assert float(diff.max()) <= TOL * float(want.abs().max())
    return got


@pytest.mark.cuda
@pytest.mark.parametrize('cin,cout', WIDTHS)
def test_exact_dw_kernel_widths_on_card(cin, cout, card):
    rng = np.random.RandomState(cin * 1000 + cout)
    # 5003 rows: not a multiple of any chunk or step
    feats, rows, g = make(rng, 5003, 4000, 27, cin, cout, card)
    rows[:, 4] = -1                                   # a tap without hits
    got = check_dw(feats, rows, g)
    assert not got[4].any()


@pytest.mark.cuda
@pytest.mark.parametrize('cin,cout,ta,k_out', [
    (16, 16, 27, 150000), (32, 32, 8, 90000), (96, 96, 27, 60000),
    (192, 192, 8, 30000), (32, 64, 3, 40000), (128, 128, 27, 21000)])
def test_exact_dw_kernel_chunks_and_segments_on_card(cin, cout, ta, k_out,
                                                     card):
    launch = tmc.conv_dw_launch(k_out, ta, cin, cout)
    assert launch.n_chunks > 1
    rng = np.random.RandomState(k_out + ta)
    feats, rows, g = make(rng, k_out, 50000, ta, cin, cout, card,
                          fill=0.25)
    check_dw(feats, rows, g)


@pytest.mark.cuda
@pytest.mark.parametrize('cin,cout', [(16, 16), (16, 32), (64, 64),
                                      (192, 128)])
def test_exact_dw_kernel_on_frame_plans_on_card(cin, cout, card, frame):
    rng = np.random.RandomState(cin + cout)
    for name, in_keys, plan in frame:
        rows = tmc.plan_rows(in_keys, plan)
        k_in, k_out = in_keys.shape[0], rows.shape[0]
        feats = torch.from_numpy(rng.randn(k_in, cin).astype(np.float32))
        g = torch.from_numpy(rng.randn(k_out, cout).astype(np.float32))
        check_dw(feats.to(card), rows, g.to(card))


@pytest.mark.cuda
def test_exact_dw_kernel_empty_missing_and_unaligned_on_card(card):
    rng = np.random.RandomState(9)
    for cin, cout in ((16, 16), (96, 96)):
        feats, rows, g = make(rng, 3000, 2000, 27, cin, cout, card)
        none = torch.full_like(rows, -1)
        kernels.reset_launches()
        assert not tmc.conv_dw(feats, none, g).any()
        empty = tmc.conv_dw(feats, rows[:0], g[:0])
        torch.cuda.synchronize()
        assert empty.shape == (27, cin, cout) and not empty.any()
        assert kernels.launches['conv_dw'] == 2
    # unaligned views: rows of the features and gradients off 16 bytes
    for cin, cout in ((5, 16), (16, 16), (32, 64), (96, 96), (192, 192)):
        feats, rows, g = make(rng, 3000, 2000, 27, cin, cout, card)
        fbuf = torch.empty(feats.numel() + 1, device=card)
        gbuf = torch.empty(g.numel() + 1, device=card)
        fbuf[1:] = feats.reshape(-1)
        gbuf[1:] = g.reshape(-1)
        f_view, g_view = fbuf[1:].view(feats.shape), gbuf[1:].view(g.shape)
        assert f_view.data_ptr() % 16 and g_view.data_ptr() % 16
        # the same sums in the same order, by 4-byte copies
        assert torch.equal(check_dw(f_view, rows, g_view),
                           check_dw(feats, rows, g))


@pytest.mark.cuda
def test_onehot_and_highest_take_the_exact_kernel_on_card(card,
                                                          monkeypatch):
    rng = np.random.RandomState(11)
    feats, rows, g = make(rng, 2000, 1500, 27, 64, 64, card)
    for env in ({'MSMD_CONV_ALGO': 'onehot'}, {'MSMD_CONV_GEMM': 'highest'}):
        monkeypatch.delenv('MSMD_CONV_GEMM', raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        kernels.reset_launches()
        tmc.conv_dw(feats, rows, g)
        torch.cuda.synchronize()
        assert kernels.launches['conv_dw'] == 1
        assert kernels.launches['conv_dw_x3'] == 0
        monkeypatch.delenv('MSMD_CONV_ALGO', raising=False)
