"""The exact fp32 conv kernels' (``gather_gemm_conv``, ``match_conv`` under
``MSMD_CONV_GEMM=highest``) launch, ``chip_smoke``'s count of the
row-taps they multiply, and their exact plain versions against the JAX
package on the CPU.

- ``ffma_launch`` gives the tiles and chunk depths the kernels take at
  each flagship width (192 as two column blocks of 96, 80 and 96 whole,
  Cin 16 in 16-deep chunks), as a function of the widths alone;
- ``chip_smoke.ffma_multiplied`` (the useful share's denominator) equals a
  walk of the kernels' blocks: per 128-row block and tap, the tap's hits
  in whole 16-row slices;
- ``gather_gemm_conv_plain``/``match_conv_plain`` (``gemm='exact'``, the
  exact kernels' function) against JAX ``_vgather_conv`` and
  ``_pallas_conv`` in Pallas interpret mode under ``highest``, at the
  widths the tiling cuts (80, 96, 128 -> 192, 192) on a submanifold plan
  (Ta 27) and a 2 x 2 x 2 downsample plan (Ta 8), through the epilogue's
  affine and valid mask: each element within 2^-20 of its sum's magnitude of
  ``_vgather_conv`` (an fp32 ``HIGHEST`` product, sums in another order)
  and within 2^-15 of ``_pallas_conv`` (whose fp32 features go through an
  exact-to-2^-16 bf16 hi/lo gather), the whole within 1e-4 of max.

``test_torch_conv_ffma_card.py`` holds the kernels to the plain versions on
the card.
"""
import functools

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from msmdfusion_tpu.ops.sparse import conv as jconv
from msmdfusion_tpu.ops.sparse import matchconv as jmc

import chip_smoke
from msmdfusion_torch.ops.sparse import conv as tconv
from msmdfusion_torch.ops.sparse import matchconv as tmc
from tests.test_torch_sparse_ops import both_tensors, random_sparse

VGATHER_TOL = 2.0 ** -20    # of each sum's magnitude: fp32 sum order
PALLAS_TOL = 2.0 ** -15     # of each sum's magnitude: its hi/lo gather
SWITCHES = ('MSMD_CONV_GEMM', 'MSMD_CONV_DTYPE', 'MSMD_CONV_ALGO')

# Cout: (register tile, tile_n, column blocks) at the flagship's widths
FLAGSHIP = {16: (16, 16, 1), 32: (32, 32, 1), 64: (64, 64, 1),
            80: (80, 80, 1), 96: (96, 96, 1), 128: (128, 128, 1),
            192: (96, 96, 2)}
# (Cin, register tile): the chunk depth
KC = {(5, 16): 8, (16, 16): 16, (16, 32): 16, (32, 32): 32, (32, 64): 32,
      (64, 64): 32, (64, 128): 32, (128, 128): 32, (80, 80): 16,
      (80, 96): 16, (96, 96): 16, (192, 96): 16, (128, 96): 16,
      (96, 128): 32}


@pytest.fixture
def highest(monkeypatch):
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv('MSMD_CONV_GEMM', 'highest')


@pytest.mark.parametrize('cin,cout', [
    (5, 16), (16, 16), (16, 32), (32, 32), (32, 64), (64, 64), (64, 128),
    (128, 128), (80, 80), (96, 96), (192, 192), (80, 96), (96, 128),
    (128, 192)])
def test_ffma_launch_at_flagship_widths(cin, cout):
    launch = tmc.ffma_launch(cin, cout)
    tile, tile_n, col_blocks = FLAGSHIP[cout]
    assert launch == (tile, tile_n, KC[cin, tile], col_blocks)
    assert launch.tile in tmc.FFMA_TILES and launch.tile_n <= launch.tile
    # the column blocks cover Cout with no empty tail tile
    assert (launch.col_blocks - 1) * launch.tile_n < cout
    assert launch.col_blocks * launch.tile_n >= cout
    # a function of the widths alone
    assert tmc.ffma_launch(cin, cout) == launch


@pytest.mark.parametrize('cin,cout', [(3, 200), (200, 5), (48, 40),
                                      (7, 13), (0, 8), (256, 257)])
def test_ffma_launch_odd_widths(cin, cout):
    launch = tmc.ffma_launch(cin, cout)
    assert launch.tile_n % 8 == 0 and launch.tile_n <= 128
    assert launch.tile == min(w for w in tmc.FFMA_TILES
                              if w >= launch.tile_n)
    assert (launch.col_blocks - 1) * launch.tile_n < cout
    assert launch.col_blocks * launch.tile_n >= cout
    assert launch.kc in (8, 16, 32)
    assert cin % launch.kc == 0 or launch.kc == 8


def walk_blocks(rows):
    """Row-taps the exact kernels multiply, block by block in Python."""
    rows = rows.numpy()
    k_out, ta = rows.shape
    total = 0
    for r0 in range(0, k_out, tmc.FFMA_ROWS):
        for t in range(ta):
            n = sum(rows[r, t] >= 0 for r in range(r0, min(k_out,
                                                         r0 + tmc.FFMA_ROWS)))
            total += tmc.FFMA_SLICE * -(-n // tmc.FFMA_SLICE)
    return total


@pytest.mark.parametrize('k_out,ta,fill', [
    (1000, 27, 0.3), (300, 8, 0.6), (129, 3, 0.9), (128, 27, 1.0),
    (5, 27, 0.2), (256, 8, 0.0)])
def test_ffma_multiplied_walks_the_blocks(k_out, ta, fill):
    rng = np.random.RandomState(k_out + ta)
    rows = rng.randint(0, 50, (k_out, ta))
    rows[rng.rand(k_out, ta) >= fill] = -1
    rows = torch.from_numpy(rows.astype(np.int32))
    multiplied = chip_smoke.ffma_multiplied(rows)
    assert multiplied == walk_blocks(rows)
    hits = int((rows >= 0).sum())
    assert hits <= multiplied < hits + tmc.FFMA_SLICE * ta * (
        -(-k_out // tmc.FFMA_ROWS))
    if fill == 1.0:
        assert multiplied == hits
    if fill == 0.0:
        assert multiplied == 0


def test_ffma_multiplied_packs_each_taps_hits():
    """Rows hitting alternate taps: each tap's 64 hits of a 128-row block
    fill 4 whole slices, whatever rows they lie in."""
    rows = torch.full((256, 4), -1, dtype=torch.int32)
    rows[0::2, :2] = 1
    rows[1::2, 2:] = 1
    assert chip_smoke.ffma_multiplied(rows) == int((rows >= 0).sum())


@functools.lru_cache(maxsize=1)
def plans():
    """(JAX keys, port keys, valid, [(name, JAX plan with its rows, port
    plan, port rows)]): a subm plan (Ta 27) and a 2 x 2 x 2 stride-2 plan
    (Ta 8) of a (9, 24, 24) coordinate set, tile 128; built once, the
    features drawn per width."""
    rng = np.random.RandomState(90)
    shape = (9, 24, 24)
    feats, coords, valid = random_sparse(rng, 384, 300, shape, 1)
    j, t = both_tensors(feats, coords, valid, shape)
    out = [('subm', jmc.build_subm_plan(j, 3, tile=128),
            tmc.build_subm_plan(t, 3))]
    _, jc, jv, _ = jconv.downsample_out_coords(j, 2, 2, 0, 256)
    _, tc, tv, _ = tconv.downsample_out_coords(t, 2, 2, 0, 256)
    out.append(('down k2 s2', jmc.build_downsample_plan(j, jc, jv, 2, 2, 0,
                                                        tile=128),
                tmc.build_downsample_plan(t, tc, tv, 2, 2, 0)))
    return j.keys, t.keys, valid, [
        (name, jmc.attach_rows(j.keys, jp, interpret=True), tp,
         tmc.plan_rows_plain(t.keys, tp)) for name, jp, tp in out]


def held(got, want, magnitude, tol):
    got, want, magnitude = (np.asarray(x, np.float64)
                            for x in (got, want, magnitude))
    assert np.isfinite(got).all()
    worst = float((np.abs(got - want) / np.maximum(magnitude, 1e-30)).max())
    assert worst <= tol, f'{worst:.3g} of the sums, above {tol:.3g}'
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize('cin,cout', [(80, 80), (96, 96), (128, 192),
                                      (192, 192)])
def test_exact_plain_versions_match_jax_under_highest(cin, cout, highest):
    rng = np.random.RandomState(cin + cout)
    jkeys, tkeys, valid, cases = plans()
    feats = (rng.randn(len(valid), cin) * valid[:, None]).astype(np.float32)
    jf, tf = jnp.asarray(feats), torch.from_numpy(feats)
    for name, jp, tp, rows in cases:
        k_out, ta = tp.k_out, tp.num_taps
        assert ta == (27 if name == 'subm' else 8)
        w = (rng.randn(ta, cin, cout) * 0.2).astype(np.float32)
        tw = torch.from_numpy(w)
        scale = rng.uniform(0.5, 1.5, cout).astype(np.float32)
        shift = rng.uniform(-0.3, 0.3, cout).astype(np.float32)
        out_valid = tp.okeys != jmc.INT_MAX
        # the epilogue without ReLU (which would hide the negative sums)
        tkw = dict(scale=torch.from_numpy(scale),
                   shift=torch.from_numpy(shift), out_valid=out_valid)
        jkw = dict(scale=jnp.asarray(scale), shift=jnp.asarray(shift),
                   out_valid=jnp.asarray(out_valid.numpy()))
        mag = (tmc.gather_gemm_conv_plain(tf.abs(), rows, tw.abs())
               * torch.from_numpy(np.abs(scale))
               + torch.from_numpy(np.abs(shift))).numpy()
        rulebook = tmc.gather_gemm_conv_plain(tf, rows, tw, gemm='exact',
                                              **tkw)
        onehot = tmc.match_conv_plain(tf, tkeys, tp, tw, gemm='exact', **tkw)
        assert torch.equal(rulebook, onehot)
        assert (rows >= 0).sum() > k_out // 2
        vgather = jmc._vgather_conv(jf, jp, jnp.asarray(w), interpret=True,
                                    **jkw)
        held(rulebook.numpy(), np.asarray(vgather)[:k_out], mag,
             VGATHER_TOL)
        pallas = jmc._pallas_conv(jf, jkeys, jp, jnp.asarray(w),
                                  interpret=True, **jkw)
        held(onehot.numpy(), np.asarray(pallas)[:k_out], mag, PALLAS_TOL)
