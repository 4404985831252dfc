"""The masked nearest-neighbour kernel ``masked_nn`` against its plain
version on an NVIDIA card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_nn_argmin_card.py

``idx`` equal and ``d2`` bit-equal to ``masked_nn_plain`` (the same fp32
operations in the same order, none fused), on: exact ties (duplicated
points of B, and points at equal distance), which go to the lowest index;
interleaved batch ids, with a batch of A absent from B; batch-sorted rows
(single-batch tiles: the compares skipped, or the tile); every row of B
invalid, and Nb = 0; Na not a multiple of a block's 2048 rows; both GMA
call shapes at a small size (2048 representatives against a key capacity
with an invalid tail, and a query capacity against 2048), on voxel-index
and on fractional coordinates. Without a card every test skips. No JAX
here: the machine with the card runs the port alone.
"""
import numpy as np
import pytest
import torch

from msmdfusion_torch import kernels
from msmdfusion_torch.ops.nn_argmin import masked_nn, masked_nn_plain


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card: the CUDA kernels run only there')
    return torch.device('cuda')


def on(device, *arrays):
    return [torch.from_numpy(x).to(device) for x in arrays]


def check_nn(a, ab, b, bb, b_valid):
    """One kernel call: idx equal, d2 bit-equal to the plain version."""
    kernels.reset_launches()
    idx, d2 = masked_nn(a, ab, b, bb, b_valid)
    want_idx, want_d2 = masked_nn_plain(a, ab, b, bb, b_valid)
    torch.cuda.synchronize()
    assert kernels.launches['masked_nn'] == 1
    assert idx.dtype == torch.int32 and d2.dtype == torch.float32
    assert torch.equal(idx, want_idx), int((idx != want_idx).sum())
    assert torch.equal(d2.view(torch.int32), want_d2.view(torch.int32))
    return idx, d2


def points(rng, n, grid):
    return np.stack([rng.randint(0, s, n) for s in grid], 1) \
        .astype(np.float32)


@pytest.mark.cuda
def test_exact_ties_go_to_the_lowest_index_on_card(card):
    b = np.array([[0, 0, 3], [0, 0, 1], [0, 0, 1], [0, 0, 5], [0, 0, 1]],
                 np.float32)
    valid = np.array([True, False, True, True, True])
    a = np.array([[0, 0, 0], [0, 0, 4], [0, 0, 2]], np.float32)
    idx, d2 = check_nn(*on(card, a, np.zeros(3, np.int32), b,
                           np.zeros(5, np.int32), valid))
    assert idx.tolist() == [2, 0, 0] and d2.tolist() == [1, 1, 1]
    # a 6-cell cube: most rows of A tie between many rows of B, across
    # the blocks' splits of B
    rng = np.random.RandomState(1)
    b = points(rng, 20000, (6, 6, 6))
    a = points(rng, 5000, (6, 6, 6))
    idx, _ = check_nn(*on(card, a, np.zeros(5000, np.int32), b,
                          np.zeros(20000, np.int32), rng.rand(20000) > 0.3))
    assert (idx >= 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize('na', [1, 2047, 2048 * 3 + 17])
def test_interleaved_batches_on_card(na, card):
    rng = np.random.RandomState(na)
    nb = 9000
    b = points(rng, nb, (41, 180, 180))
    bb = rng.randint(0, 3, nb).astype(np.int32)
    a = points(rng, na, (41, 180, 180))
    ab = rng.randint(0, 4, na).astype(np.int32)      # batch 3: not in B
    idx, d2 = check_nn(*on(card, a, ab, b, bb, rng.rand(nb) > 0.1))
    missing = torch.from_numpy(ab).to(card) == 3
    assert (idx[missing] == -1).all() and torch.isinf(d2[missing]).all()
    if (~missing).any():
        assert (idx[~missing] >= 0).all()


@pytest.mark.cuda
def test_batch_sorted_rows_on_card(card):
    """Rows of A and B sorted by batch, as the GMA's keys and queries are:
    most staged tiles of B hold one batch id, so warps whose rows all have
    it skip the id compares and warps whose rows have none skip the tile;
    a tile that straddles two batches takes the compares."""
    rng = np.random.RandomState(3)
    na, nb = 6000, 12000
    a = points(rng, na, (41, 180, 180))
    b = points(rng, nb, (41, 180, 180))
    ab = np.sort(rng.randint(0, 3, na)).astype(np.int32)
    bb = np.sort(rng.randint(0, 2, nb)).astype(np.int32)   # batch 2 absent
    idx, d2 = check_nn(*on(card, a, ab, b, bb, rng.rand(nb) > 0.1))
    assert ((idx == -1) == torch.from_numpy(ab == 2).to(card)).all()


@pytest.mark.cuda
def test_invalid_and_empty_b_on_card(card):
    rng = np.random.RandomState(5)
    a = points(rng, 3000, (41, 180, 180))
    ab = np.zeros(3000, np.int32)
    b = points(rng, 4000, (41, 180, 180))
    for nb in (4000, 0):
        idx, d2 = check_nn(*on(card, a, ab, b[:nb], np.zeros(nb, np.int32),
                               np.zeros(nb, bool)))
        assert (idx == -1).all() and torch.isinf(d2).all()


@pytest.mark.cuda
@pytest.mark.parametrize('fractional', [False, True])
def test_gma_call_shapes_on_card(fractional, card):
    """Stage-sized calls: 2048 representatives against a key capacity of
    30000 (the last 8000 invalid), then a query capacity of 30000 against
    the 2048 representatives (10% invalid)."""
    rng = np.random.RandomState(7 + fractional)
    keys = points(rng, 30000, (41, 360, 360))
    reps = points(rng, 2048, (41, 360, 360))
    if fractional:
        keys = keys * np.float32(0.37) + rng.rand(30000, 3).astype(np.float32)
        reps = reps * np.float32(0.37) + rng.rand(2048, 3).astype(np.float32)
    key_ok = np.arange(30000) < 22000
    zeros = lambda n: np.zeros(n, np.int32)
    nn_row, _ = check_nn(*on(card, reps, zeros(2048), keys, zeros(30000),
                             key_ok))
    assert (nn_row >= 0).all() and (nn_row < 22000).all()
    best, _ = check_nn(*on(card, keys, zeros(30000), reps, zeros(2048),
                           rng.rand(2048) > 0.1))
    assert (best >= 0).all()
