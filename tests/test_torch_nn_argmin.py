"""Port ``masked_nn`` vs the JAX package's, exactly, on the CPU.

The same seeded numpy inputs go through the port's wrapper (its plain
version on CPU tensors), the JAX ``masked_nn`` in Pallas interpret mode
(``_nn_kernel``) and the JAX non-TPU path. The coordinates are voxel
indices, so every intermediate is an integer below 2^24 and the three
agree bit for bit on ``idx`` and ``d2``: two batches, invalid B rows,
forced ties (duplicate B points) and A rows with no candidate.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from msmdfusion_tpu.ops.nn_argmin import masked_nn as jax_masked_nn

from msmdfusion_torch import kernels
from msmdfusion_torch.ops.nn_argmin import masked_nn, masked_nn_plain


def make_inputs(rng, na, nb, grid=(41, 180, 180)):
    """Integer (z, y, x) points in two batches; B has duplicated rows (ties
    at equal distance to the lowest index), ~10% invalid rows, and A has
    rows of a batch id B does not hold (no candidate)."""
    def pts(n):
        return np.stack([rng.randint(0, g, n) for g in grid], 1)
    b = pts(nb).astype(np.float32)
    dup = rng.choice(nb, nb // 5, replace=False)
    b[dup] = b[rng.randint(0, nb, len(dup))]
    bb = rng.randint(0, 2, nb).astype(np.int32)
    b_valid = rng.rand(nb) > 0.1
    a = pts(na).astype(np.float32)
    ab = rng.randint(0, 2, na).astype(np.int32)
    src = rng.choice(np.flatnonzero(b_valid), na // 4)
    a[: na // 4] = b[src]                               # exact hits (d2 = 0)
    ab[: na // 4] = bb[src]
    ab[-5:] = 7                                         # no candidate
    return a, ab, b, bb, b_valid


def port(*arrays):
    return masked_nn(*(torch.from_numpy(x) for x in arrays))


@pytest.mark.parametrize('na,nb', [(300, 2500), (700, 300)])
def test_masked_nn_matches_jax_kernel_and_xla_path_exactly(na, nb):
    rng = np.random.RandomState(na)
    inputs = make_inputs(rng, na, nb)
    idx, d2 = port(*inputs)
    assert idx.dtype == torch.int32 and d2.dtype == torch.float32
    j_inputs = [jnp.asarray(x) for x in inputs]
    for interpret in (True, False):
        j_idx, j_d2 = jax_masked_nn(*j_inputs, interpret=interpret)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
        np.testing.assert_array_equal(d2.numpy(), np.asarray(j_d2))
    assert (idx[-5:] == -1).all() and torch.isinf(d2[-5:]).all()
    assert (d2 == 0).sum() >= na // 4
    assert (idx >= 0).sum() > na // 2


def test_ties_go_to_the_lowest_index():
    b = np.array([[0, 0, 3], [0, 0, 1], [0, 0, 1], [0, 0, 5], [0, 0, 1]],
                 np.float32)
    bb = np.zeros(5, np.int32)
    valid = np.array([True, False, True, True, True])
    a = np.array([[0, 0, 0], [0, 0, 4], [0, 0, 2]], np.float32)
    idx, d2 = port(a, np.zeros(3, np.int32), b, bb, valid)
    # row 1 is invalid, so the first valid point at z=1 is row 2; (0,0,4)
    # is 1 from rows 0 and 3 and takes row 0; (0,0,2) is 1 from rows 0, 2
    # and 4 and takes row 0
    np.testing.assert_array_equal(idx.numpy(), [2, 0, 0])
    np.testing.assert_array_equal(d2.numpy(), [1, 1, 1])


def first_nearest(a, ab, b, bb, b_valid):
    """numpy brute force: the least j of the least squared distance (the
    same fp32 operations, in the same order)."""
    prod = (a[:, None, 0] * b[None, :, 0] + a[:, None, 1] * b[None, :, 1]) \
        + a[:, None, 2] * b[None, :, 2]
    sq = lambda x: (x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1]) + x[:, 2] * x[:, 2]
    d = (sq(a)[:, None] + sq(b)[None, :]) - np.float32(2) * prod
    ok = (ab[:, None] == bb[None, :]) & b_valid[None, :]
    d = np.where(ok, np.maximum(d, np.float32(0)), np.float32(np.inf))
    idx = np.argmin(d, 1).astype(np.int32)           # the first minimum
    d2 = d[np.arange(len(a)), idx]
    return np.where(np.isfinite(d2), idx, -1), d2


@pytest.mark.parametrize('n_batches', [1, 3, 5])
def test_ties_and_interleaved_batches_match_jax_kernel(n_batches):
    """Points on a 6-cell cube (most rows of A tie between several rows of
    B), batch ids interleaved row by row, one batch of A absent from B."""
    rng = np.random.RandomState(40 + n_batches)
    na, nb = 500, 1200
    b = rng.randint(0, 6, (nb, 3)).astype(np.float32)
    bb = rng.randint(0, n_batches, nb).astype(np.int32)
    b_valid = rng.rand(nb) > 0.2
    a = rng.randint(0, 6, (na, 3)).astype(np.float32)
    ab = rng.randint(0, n_batches + 1, na).astype(np.int32)
    idx, d2 = port(a, ab, b, bb, b_valid)
    w_idx, w_d2 = first_nearest(a, ab, b, bb, b_valid)
    np.testing.assert_array_equal(idx.numpy(), w_idx)
    np.testing.assert_array_equal(d2.numpy(), w_d2)
    j_idx, j_d2 = jax_masked_nn(*(jnp.asarray(x) for x in
                                  (a, ab, b, bb, b_valid)), interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(d2.numpy(), np.asarray(j_d2))
    # the cases are there: ties at the minimum, and rows without a batch
    found = idx.numpy() >= 0
    ties = [int(((b == b[j]).all(1) & (bb == bb[j]) & b_valid).sum())
            for j in idx.numpy()[found]]
    assert max(ties) > 1 and (~found).any() and found.any()


def test_plain_version_chunks_rows_of_a():
    rng = np.random.RandomState(3)
    inputs = make_inputs(rng, 257, 4000)
    t = [torch.from_numpy(x) for x in inputs]
    whole = masked_nn_plain(*t)
    from msmdfusion_torch.ops import nn_argmin
    old = nn_argmin._PLAIN_ELEMS
    nn_argmin._PLAIN_ELEMS = 4000 * 10          # ten rows per chunk
    try:
        chunked = masked_nn_plain(*t)
    finally:
        nn_argmin._PLAIN_ELEMS = old
    for w, c in zip(whole, chunked):
        assert torch.equal(w, c)


def test_empty_b_and_input_checks():
    a = torch.zeros(4, 3)
    ab = torch.zeros(4, dtype=torch.int32)
    idx, d2 = masked_nn(a, ab, torch.zeros(0, 3),
                        torch.zeros(0, dtype=torch.int32),
                        torch.zeros(0, dtype=torch.bool))
    assert (idx == -1).all() and torch.isinf(d2).all()
    with pytest.raises(TypeError):
        masked_nn(a.double(), ab, a, ab, torch.ones(4, dtype=torch.bool))
    with pytest.raises(ValueError):
        masked_nn(a, ab, a[:, :2].contiguous(), ab,
                  torch.ones(4, dtype=torch.bool))
    kernels.reset_launches()
    masked_nn(a, ab, a, ab, torch.ones(4, dtype=torch.bool))
    assert kernels.launches['masked_nn'] == 0      # CPU: the plain version
