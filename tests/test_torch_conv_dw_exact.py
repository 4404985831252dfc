"""The exact fp32 weight gradient against the JAX package on the CPU.

``conv_dw_plain`` (kernel ``conv_dw``'s plain version: the one-hot
engine's ``dw`` and ``MSMD_CONV_GEMM=highest``'s) against the JAX
package's ``_dw_from_rows``, the ``HIGHEST`` einsum that the one-hot
``_pallas_bwd`` takes, on the same seeded numpy inputs, at the widths
where the kernel changes design (row streaming up to 32; above, the GEMM
design's tiles: 96 whole, 192 as two of 96), Cin != Cout, Ta 27 and the
strided plans' 8 and 3, a tap without hits; each element within 1e-4 of
the magnitude of its sum (both are fp32 sums, in other orders). On the
CPU the wrapper runs the plain version.

Then ``chip_smoke.dw_multiplied`` (the row-taps the kernel multiplies,
the denominator of its useful share) against a walk of the kernel's
chunks, 2048-row segments and 16-hit stages.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from msmdfusion_tpu.ops.sparse.matchconv import _dw_from_rows

import chip_smoke
from msmdfusion_torch import kernels
from msmdfusion_torch.ops.sparse import matchconv as tmc

TOL = 1e-4          # of each element's sum magnitude (chip_smoke.TOL)


def make(rng, k_out, k_in, ta, cin, cout, fill=0.3):
    """Rows with ~``fill`` hits; features over eight binades."""
    rows = rng.randint(0, k_in, (k_out, ta))
    rows[rng.rand(k_out, ta) > fill] = -1
    feats = rng.randn(k_in, cin) * 2.0 ** rng.randint(-4, 4, (k_in, cin))
    g = rng.randn(k_out, cout)
    return (feats.astype(np.float32), rows.astype(np.int32),
            g.astype(np.float32))


@pytest.mark.parametrize('cin,cout,ta', [
    (16, 16, 27), (32, 32, 27), (96, 96, 27), (192, 192, 27),
    (16, 32, 8), (32, 64, 27), (80, 96, 3), (192, 64, 8)])
def test_exact_dw_plain_matches_jax_dw_from_rows(cin, cout, ta):
    rng = np.random.RandomState(cin * 1000 + cout + ta)
    feats, rows, g = make(rng, 700, 500, ta, cin, cout)
    rows[:, 1] = -1                                   # a tap without hits
    want = np.asarray(_dw_from_rows(
        jnp.asarray(feats), jnp.asarray(rows), jnp.asarray(g),
        jnp.zeros((ta, cin, cout), jnp.float32)))
    t = [torch.from_numpy(x) for x in (feats, rows, g)]
    kernels.reset_launches()
    got = tmc.conv_dw(*t)
    assert kernels.launches['conv_dw'] == 0           # CPU: the plain version
    assert got.shape == (ta, cin, cout) and got.dtype == torch.float32
    mag = tmc.conv_dw_plain(t[0].abs(), t[1], t[2].abs()).numpy()
    diff = np.abs(got.numpy() - want)
    assert (diff <= TOL * mag).all(), float((diff / np.maximum(mag, 1e-30))
                                            .max())
    assert not got[1].any()


@pytest.mark.parametrize('k_out,ta,cin,cout', [
    (5003, 27, 16, 16), (5003, 27, 192, 192), (60000, 27, 96, 96),
    (9000, 8, 32, 64)])
def test_dw_multiplied_walks_the_kernels_segments(k_out, ta, cin, cout):
    rng = np.random.RandomState(k_out + cin)
    rows = rng.randint(0, 1000, (k_out, ta))
    rows[rng.rand(k_out, ta) > rng.rand(ta) * 0.6] = -1  # taps' own rates
    rows[:, 2] = -1
    launch = tmc.conv_dw_launch(k_out, ta, cin, cout)
    hit = rows >= 0
    want = 0
    for c in range(launch.n_chunks):
        lo = c * launch.chunk_rows
        hi = min(k_out, lo + launch.chunk_rows)
        if tmc.dw_narrow(cin, cout):
            want += int(hit[lo:hi].sum())       # each warp walks its hits
            continue
        for s0 in range(lo, hi, tmc.DW_SEG):
            n = hit[s0:min(hi, s0 + tmc.DW_SEG)].sum(0)
            want += tmc.DW_BK * int(np.ceil(n / tmc.DW_BK).sum())
    got = chip_smoke.dw_multiplied(torch.from_numpy(rows.astype(np.int32)),
                                   cin, cout)
    assert got == want
    assert got >= hit.sum()
    if not tmc.dw_narrow(cin, cout):
        assert launch.chunk_rows % tmc.DW_CHUNK == 0
        assert launch.n_chunks > 1
