"""The point ops of ``msmdfusion_torch/ops/sampling.py`` against the JAX
package's ``ops/sampling.py``, on the CPU.

The port's ops are batched over B; the JAX ones take one sample, so each
sample's result is held against the JAX call on that sample. Two scenes
of B = 2:

- ``uniform``: 512 points in a 4 x 4 x 2 m box, 40 of them duplicated
  (equal distances: ties), the last 20 of each sample invalid;
- ``resampled``: a 300-point cloud drawn up to 512 points with
  replacement by ``IndoorPointSample`` (the indoor pipeline's draw where
  a scene has fewer points than the config's count: many exact
  duplicates), the last 20 invalid.

Integer outputs (indices) equal; distances and interpolated features
within 1e-6 of their largest value. The ball query also runs on centres
far from every point (empty balls: -1 slots) and with more slots than
in-radius points (the nearest repeated).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from msmdfusion_tpu.ops import sampling as J

from msmdfusion_torch.datasets.pipelines.indoor import IndoorPointSample
from msmdfusion_torch.ops import sampling as T
from tests.torch_threads import one_thread  # noqa: F401

DIST_TOL = 1e-6
B, N = 2, 512


def make_scene(kind, seed=0):
    rng = np.random.RandomState(seed)
    clouds = []
    for _ in range(B):
        if kind == 'uniform':
            xyz = np.concatenate([rng.uniform(-2, 2, (N, 2)),
                                  rng.uniform(0, 2, (N, 1))], 1)
            xyz[N // 2:N // 2 + 40] = xyz[:40]
        else:
            small = np.concatenate([rng.uniform(-2, 2, (300, 2)),
                                    rng.uniform(0, 2, (300, 1))], 1)
            xyz = IndoorPointSample(N)(dict(points=small), rng)['points']
        clouds.append(xyz)
    xyz = np.stack(clouds).astype(np.float32)
    valid = np.ones((B, N), bool)
    valid[:, -20:] = False
    feats = rng.randn(B, N, 8).astype(np.float32)
    return xyz, valid, feats


SCENES = ('uniform', 'resampled')


@pytest.fixture(scope='module', params=SCENES)
def scene(request):
    xyz, valid, feats = make_scene(request.param)
    centres = np.stack([np.asarray(J.gather_points(
        jnp.asarray(xyz[b]), J.furthest_point_sample(
            jnp.asarray(xyz[b]), 64, jnp.asarray(valid[b]))))
        for b in range(B)])
    centres[:, :4] += 50.0                          # empty balls
    return dict(kind=request.param, xyz=xyz, valid=valid, feats=feats,
                centres=centres)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def close(got, want, tol=DIST_TOL):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_square_distance_matches_jax(scene):
    # every scene holds exactly equal points: the ties the tests hold
    assert len(np.unique(scene['xyz'][0], axis=0)) < N
    got = T.square_distance(t(scene['centres']), t(scene['xyz']))
    for b in range(B):
        close(got[b], jax.jit(J.square_distance)(
            jnp.asarray(scene['centres'][b]), jnp.asarray(scene['xyz'][b])))


@pytest.mark.parametrize('count', [64, 500])
def test_furthest_point_sample_matches_jax(scene, count):
    """500 of 492 valid points: the valid ones run out, FPS repeats."""
    got = T.furthest_point_sample(t(scene['xyz']), count, t(scene['valid']))
    fps = jax.jit(J.furthest_point_sample, static_argnums=1)
    for b in range(B):
        want = fps(jnp.asarray(scene['xyz'][b]), count,
                   jnp.asarray(scene['valid'][b]))
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))


@pytest.mark.parametrize('weight', [None, 1.0, 0.5])
def test_combined_fps_matches_jax(scene, weight):
    feats = None if weight is None else t(scene['feats'])
    got = T.combined_fps(t(scene['xyz']), feats, 32, t(scene['valid']),
                         feature_weight=weight or 1.0)
    fn = jax.jit(J.combined_fps, static_argnums=2,
                 static_argnames='feature_weight')
    for b in range(B):
        want = fn(jnp.asarray(scene['xyz'][b]),
                  None if weight is None else jnp.asarray(
                      scene['feats'][b]), 32,
                  jnp.asarray(scene['valid'][b]),
                  feature_weight=weight or 1.0)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))


@pytest.mark.parametrize('k', [3, 16])
def test_knn_and_three_nn_match_jax(scene, k):
    fn = T.three_nn if k == 3 else (lambda q, p, v: T.knn(q, p, k, v))
    d2, idx = fn(t(scene['centres']), t(scene['xyz']), t(scene['valid']))
    jfn = jax.jit(J.knn, static_argnums=2)
    for b in range(B):
        jd, ji = jfn(jnp.asarray(scene['centres'][b]),
                     jnp.asarray(scene['xyz'][b]), k,
                     jnp.asarray(scene['valid'][b]))
        np.testing.assert_array_equal(idx[b].numpy(), np.asarray(ji))
        close(d2[b], jd)


@pytest.mark.parametrize('radius,k', [(0.2, 8), (0.4, 16), (0.8, 64)])
def test_ball_query_matches_jax(scene, radius, k):
    got = T.ball_query(radius, k, t(scene['xyz']), t(scene['centres']),
                       xyz_valid=t(scene['valid']))
    fn = jax.jit(J.ball_query, static_argnums=(0, 1))
    for b in range(B):
        want = np.asarray(fn(radius, k, jnp.asarray(scene['xyz'][b]),
                             jnp.asarray(scene['centres'][b]),
                             jnp.asarray(scene['valid'][b])))
        np.testing.assert_array_equal(got[b].numpy(), want)
    assert bool((got[:, :4] == -1).all())               # the empty balls
    assert bool((got[:, 4:] >= 0).all())


def test_gathers_and_interpolation_match_jax(scene):
    xyz, feats, valid = scene['xyz'], scene['feats'], scene['valid']
    idx = T.ball_query(0.4, 16, t(xyz), t(scene['centres']),
                       xyz_valid=t(valid))
    grouped = T.group_points(t(feats), idx)
    gathered = T.gather_points(t(feats), idx[..., 0])
    d2, nn = T.three_nn(t(xyz), t(scene['centres'][:, 4:]))
    interp = T.three_interpolate(t(feats[:, :60]), nn, d2)
    for b in range(B):
        i = jnp.asarray(idx[b].numpy())
        np.testing.assert_array_equal(
            grouped[b].numpy(), np.asarray(J.group_points(
                jnp.asarray(feats[b]), i)))
        np.testing.assert_array_equal(
            gathered[b].numpy(), np.asarray(J.gather_points(
                jnp.asarray(feats[b]), i[:, 0])))
        jd, ji = J.three_nn(jnp.asarray(xyz[b]),
                            jnp.asarray(scene['centres'][b, 4:]))
        close(interp[b], jax.jit(J.three_interpolate)(
            jnp.asarray(feats[b, :60]), ji, jd))
    assert bool((grouped[:, :4] == 0).all())            # -1 slots zeroed
