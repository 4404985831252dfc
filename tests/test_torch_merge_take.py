"""Port ``merge_take_rows``, ``sparse_add`` and ``lookup_sorted_pair`` vs
the JAX package's, on the CPU.

The index streams are built the way ``sparse_add`` builds them: a stable
key sort over two key-sorted halves, the group heads' rows, the next
row where a key repeats (``dup``) and INT_MAX past the last head. The
port's wrapper runs its plain version on CPU tensors; it equals the JAX
package's exact XLA gather (``_xla_take``) and agrees with the TPU
kernel in Pallas interpret mode within 1e-4 of the largest value (that
kernel splits the table into bf16 hi/lo halves, ~2^-16 relative).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from msmdfusion_tpu.ops.sparse import merge_take as jmt
from msmdfusion_tpu.ops.sparse import tensor as jtensor
from msmdfusion_tpu.utils import overflow as joverflow

from msmdfusion_torch import kernels
from msmdfusion_torch.ops.sparse import tensor as ttensor
from msmdfusion_torch.ops.sparse.merge_take import (merge_take_rows,
                                                    merge_take_rows_plain)
from msmdfusion_torch.utils import overflow

INT_MAX = 2 ** 31 - 1
TOL = 1e-4


def sparse_add_streams(rng, n_a, n_b, n_common):
    """(idx, idx2, dup) of a sparse_add over two sorted key halves with
    ``n_common`` shared keys and a few INT_MAX rows in each half; one
    output row per input row, INT_MAX past the last group head."""
    common = rng.choice(10 ** 6, n_common, replace=False)
    rest = np.setdiff1d(rng.choice(10 ** 6, n_a + n_b, replace=False), common)
    ka = np.sort(np.concatenate([common, rest[:n_a - n_common - 30]]))
    kb = np.sort(np.concatenate([common, rest[n_a:n_a + n_b - n_common - 20]]))
    keys = np.concatenate([ka, np.full(30, INT_MAX), kb, np.full(20, INT_MAX)])
    n = len(keys)
    order = np.argsort(keys, kind='stable')
    skey = keys[order]
    valid = skey != INT_MAX
    head = np.concatenate([valid[:1], (skey[1:] != skey[:-1]) & valid[1:]])
    hp = np.flatnonzero(head)
    nxt = np.minimum(hp + 1, n - 1)
    dup = (hp + 1 < n) & (skey[nxt] == skey[hp])
    pad = n - len(hp)
    idx = np.concatenate([order[hp], np.full(pad, INT_MAX)]).astype(np.int32)
    idx2 = np.concatenate([order[nxt], np.zeros(pad)]).astype(np.int32)
    dup = np.concatenate([dup, np.zeros(pad, bool)])
    return idx, idx2, dup


def test_merge_take_equals_xla_take_and_pallas_kernel():
    rng = np.random.RandomState(0)
    n_a, n_b, c = 2400, 2200, 96           # n_a % 8 == 0: the kernel engages
    idx, idx2, dup = sparse_add_streams(rng, n_a, n_b, 700)
    assert len(idx) >= 4096 and dup.sum() >= 600 and (idx == INT_MAX).any()
    table = rng.randn(n_a + n_b, c).astype(np.float32)
    got = merge_take_rows(torch.from_numpy(table), torch.from_numpy(idx),
                          torch.from_numpy(idx2), torch.from_numpy(dup))
    active = idx != INT_MAX
    assert (got.numpy()[~active] == 0).all()

    j = [jnp.asarray(x) for x in (table, idx, idx2, dup)]
    xla = np.asarray(jmt._xla_take(j[0], j[1], j[2], j[3]))
    np.testing.assert_array_equal(got.numpy()[active], xla[active])

    pallas = np.asarray(jmt.merge_take_rows(j[0], j[1], n_a, j[2], j[3],
                                            interpret=True))
    scale = np.abs(xla[active]).max()
    np.testing.assert_allclose(got.numpy()[active], pallas[active],
                               rtol=TOL, atol=TOL * scale)


def test_single_stream_and_out_of_range_rows():
    rng = np.random.RandomState(1)
    table = rng.randn(300, 20).astype(np.float32)
    idx = rng.permutation(300)[:200].astype(np.int32)
    idx[::17] = INT_MAX
    idx[5] = -3
    got = merge_take_rows(torch.from_numpy(table), torch.from_numpy(idx))
    ok = (idx >= 0) & (idx < 300)
    np.testing.assert_array_equal(got.numpy()[ok], table[idx[ok]])
    assert (got.numpy()[~ok] == 0).all()
    want = np.asarray(jmt._xla_take(jnp.asarray(table), jnp.asarray(idx),
                                    None, None))
    np.testing.assert_array_equal(got.numpy()[ok], want[ok])


def test_merge_take_checks_and_counts():
    t = torch.zeros(10, 4)
    i = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError):
        merge_take_rows(t, i, i)                       # idx2 without dup
    with pytest.raises(TypeError):
        merge_take_rows(t, i.long())
    kernels.reset_launches()
    with overflow.capture() as cap:
        out = merge_take_rows(t, i, site='s')
    assert out.shape == (3, 4)
    assert cap.counters() == {'merge_take.win[s]': 0}
    assert kernels.launches['merge_take'] == 0         # CPU: plain version
    assert torch.equal(out, merge_take_rows_plain(t, i))


def random_sparse(rng, k_cap, keys, shape, c):
    """(features, coords, valid) of the sorted unique cells ``keys``."""
    z, y, x = shape
    keys = np.unique(keys)
    n = len(keys)
    coords = np.stack([keys // (z * y * x), keys // (y * x) % z,
                       keys // x % y, keys % x], 1).astype(np.int32)
    coords = np.concatenate([coords, np.full((k_cap - n, 4), -1, np.int32)])
    valid = np.arange(k_cap) < n
    feats = (rng.randn(k_cap, c) * valid[:, None]).astype(np.float32)
    return feats, coords, valid


def both(feats, coords, valid, shape):
    j = jtensor.make_sparse_tensor(jnp.asarray(feats), jnp.asarray(coords),
                                   jnp.asarray(valid), shape, 2,
                                   assume_sorted=True)
    t = ttensor.make_sparse_tensor(torch.from_numpy(feats),
                                   torch.from_numpy(coords),
                                   torch.from_numpy(valid), shape, 2,
                                   assume_sorted=True)
    return j, t


@pytest.mark.parametrize('cut', [0, 40])
def test_sparse_add_matches_jax(cut):
    rng = np.random.RandomState(2 + cut)
    shape = (9, 24, 24)
    cells = 2 * 9 * 24 * 24
    common = rng.choice(cells, 150, replace=False)
    ka = np.concatenate([common, rng.choice(cells, 300)])
    kb = np.concatenate([common, rng.choice(cells, 250)])
    ja, ta = both(*random_sparse(rng, 500, ka, shape, 24), shape)
    jb, tb = both(*random_sparse(rng, 420, kb, shape, 24), shape)
    n_union = len(np.union1d(ka, kb))
    cap = n_union - cut if cut else 900
    with joverflow.capture() as jcap:
        j = jtensor.sparse_add(ja, jb, cap)
        jcounts = {k: int(v) for k, v in jcap.counters().items()}
    with overflow.capture() as tcap:
        t = ttensor.sparse_add(ta, tb, cap)
    assert tcap.counters() == {**jcounts, 'merge_take.win[sparse_add]': 0}
    assert tcap.counters()['sparse.sparse_add.union_cap'] == cut
    assert tcap.gauge_values() == {'occ.sparse_add_union': [n_union]}
    for name in ('keys', 'coords', 'valid', 'features'):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)), name)
    assert t.capacity == cap and int(t.valid.sum()) == n_union - cut
    assert (t.features.abs().sum(1) > 0).sum() == n_union - cut


def test_lookup_sorted_pair_matches_jax():
    rng = np.random.RandomState(4)
    a = np.sort(rng.choice(5000, 700, replace=False))
    b = np.sort(np.concatenate([a[rng.choice(700, 200, replace=False)],
                                rng.choice(np.arange(5000, 9000), 300,
                                           replace=False)]))
    a = np.concatenate([a, np.full(50, INT_MAX)]).astype(np.int32)
    b = np.concatenate([b, np.full(30, INT_MAX)]).astype(np.int32)
    got = ttensor.lookup_sorted_pair(torch.from_numpy(a), torch.from_numpy(b))
    want = jtensor.lookup_sorted_pair(jnp.asarray(a), jnp.asarray(b))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0] >= 0).sum() == 200 and (got[1] >= 0).sum() == 200
