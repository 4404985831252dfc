"""Port voxelizer vs the JAX package on the CPU.

``voxelize_mean_batch`` on the same numpy points: voxel coordinates and
validity exactly, mean features to 1e-6 relative (segment sums in another
order). Points sit on voxel boundaries on purpose: the float32
subtract-divide-floor order decides their voxel.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from msmdfusion_tpu.ops import voxelize as jvox

from msmdfusion_torch.ops import voxelize as tvox
from msmdfusion_torch.utils import overflow

VOXEL = [0.075, 0.075, 0.2]
PCR = [-2.4, -2.4, -5.0, 2.4, 2.4, 3.0]


def make_points(rng, b, n):
    lo, hi = np.array(PCR[:3]), np.array(PCR[3:])
    pts = rng.uniform(lo - 0.3, hi + 0.3, (b, n, 3))
    # a quarter of the points exactly on voxel boundaries
    on_edge = rng.rand(b, n) < 0.25
    cells = np.floor((pts - lo) / VOXEL)
    pts = np.where(on_edge[..., None], lo + cells * VOXEL, pts)
    feats = np.concatenate([pts, rng.rand(b, n, 2)], -1).astype(np.float32)
    mask = rng.rand(b, n) < 0.9
    return feats, mask


def run_both(points, mask, cap):
    jf, jc, jv = jvox.voxelize_mean_batch(jnp.asarray(points),
                                          jnp.asarray(mask), VOXEL, PCR, cap)
    with overflow.capture() as c:
        tf, tc, tv = tvox.voxelize_mean_batch(torch.from_numpy(points),
                                              torch.from_numpy(mask), VOXEL,
                                              PCR, cap)
    return (np.asarray(jf), np.asarray(jc), np.asarray(jv)), \
        (tf.numpy(), tc.numpy(), tv.numpy()), c.counters()


@pytest.mark.parametrize('b,n,cap', [(1, 3000, 4000), (2, 2000, 5000)])
def test_voxelize_mean_batch_matches_jax(b, n, cap):
    points, mask = make_points(np.random.RandomState(b), b, n)
    (jf, jc, jv), (tf, tc, tv), counts = run_both(points, mask, cap)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_allclose(tf, jf, rtol=1e-6, atol=1e-6)
    assert counts == {'voxelize.mean_batch.voxel_cap': 0}
    assert 0 < tv.sum() < cap
    c = tc[tv].astype(np.int64)
    keys = ((c[:, 0] * 40 + c[:, 1]) * 64 + c[:, 2]) * 64 + c[:, 3]
    assert (np.diff(keys) > 0).all()        # ascending unique keys


def test_voxel_overflow_drops_highest_keys():
    points, mask = make_points(np.random.RandomState(3), 1, 3000)
    (_, full_c, full_v), _, _ = run_both(points, mask, 4000)
    n = int(full_v.sum())
    (jf, jc, jv), (tf, tc, tv), counts = run_both(points, mask, n - 100)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tc, full_c[:n - 100])
    np.testing.assert_allclose(tf, jf, rtol=1e-6, atol=1e-6)
    assert counts == {'voxelize.mean_batch.voxel_cap': 100}


def test_compute_voxel_coords_matches_jax():
    points, _ = make_points(np.random.RandomState(4), 1, 2000)
    jc, jr, jg = jvox.compute_voxel_coords(jnp.asarray(points[0]), VOXEL, PCR)
    tc, tr, tg = tvox.compute_voxel_coords(torch.from_numpy(points[0]), VOXEL,
                                           PCR)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    assert tvox.grid_shape(VOXEL, PCR) == (40, 64, 64)
