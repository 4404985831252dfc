"""The voxel mean's fixed-order segment sum, on the CPU.

``voxelize.segment_sum`` sums each segment's rows in row order from 0,
the same bits on every run (on the card a float ``index_add_`` adds by
atomics in no fixed order): it must equal a sequential float32 loop bit
for bit, with empty segments, and drop the parked rows (ids of n or more)
that follow the segments' rows.
Through ``voxelize_mean_batch`` on dense clusters (hundreds of points a
voxel, where the order of the sums shows) the voxel features are held to
the JAX package's ``voxelize_mean_batch`` to 1e-6 relative, and two runs
give the same bits.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from msmdfusion_tpu.ops import voxelize as jvox

from msmdfusion_torch.ops import voxelize as tvox
from tests.test_torch_voxelize import PCR, VOXEL


def sequential_sums(x, seg, n):
    out = np.zeros((n, x.shape[1]), np.float32)
    for row, s in zip(x, seg):
        out[s] = out[s] + row           # float32, one row at a time
    return out


@pytest.mark.parametrize('n_rows,n_seg', [(1, 1), (500, 40), (3000, 7)])
def test_segment_sum_is_the_sequential_sum(n_rows, n_seg):
    rng = np.random.RandomState(n_rows)
    x = (rng.randn(n_rows, 6) * 10 ** rng.uniform(-3, 3, (n_rows, 1))
         ).astype(np.float32)
    seg = np.sort(rng.randint(0, n_seg + 3, n_rows))   # ids >= n: parked
    got = tvox.segment_sum(torch.from_numpy(x), torch.from_numpy(seg),
                           n_seg).numpy()
    want = sequential_sums(x[seg < n_seg], seg[seg < n_seg], n_seg + 1)
    assert got.shape == (n_seg, 6)
    np.testing.assert_array_equal(got.view(np.uint32),
                                  want[:n_seg].view(np.uint32))
    empty = np.bincount(seg[seg < n_seg], minlength=n_seg) == 0
    assert not got[empty].any()             # empty segments sum to 0


def clusters(rng, b, n_centres, per):
    """Points in a few tight clusters: hundreds of points a voxel."""
    centres = rng.uniform(np.array(PCR[:3]) + 0.5, np.array(PCR[3:]) - 0.5,
                          (b, n_centres, 3))
    pts = centres[:, :, None, :] + rng.normal(0, 0.02, (b, n_centres, per,
                                                        3))
    pts = pts.reshape(b, n_centres * per, 3)
    feats = np.concatenate([pts, rng.rand(b, n_centres * per, 2) * 50], -1)
    return feats.astype(np.float32), rng.rand(b, n_centres * per) < 0.95


@pytest.mark.parametrize('b', [1, 2])
def test_voxel_mean_of_dense_clusters_matches_jax(b):
    points, mask = clusters(np.random.RandomState(b), b, 12, 400)
    cap = 2000
    jf, jc, jv = jvox.voxelize_mean_batch(jnp.asarray(points),
                                          jnp.asarray(mask), VOXEL, PCR, cap)
    runs = [tvox.voxelize_mean_batch(torch.from_numpy(points),
                                     torch.from_numpy(mask), VOXEL, PCR,
                                     cap) for _ in range(2)]
    tf, tc, tv = (t.numpy() for t in runs[0])
    np.testing.assert_array_equal(tc, np.asarray(jc))
    np.testing.assert_array_equal(tv, np.asarray(jv))
    np.testing.assert_allclose(tf, np.asarray(jf), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(runs[1][0].numpy().view(np.uint32),
                                  tf.view(np.uint32))
    assert 0 < 10 * tv.sum() < mask.sum()     # tens of points a voxel
