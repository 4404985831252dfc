"""The point-based zoo's point ops on an NVIDIA card against the same
functions on the CPU:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_indoor_card.py

The points lie on a 1/8 m grid (with duplicates, invalid points and
centres far from every point): every squared distance is exact in fp32 on
both devices, so the ties (equal distances) and the radius tests must
come out the same.

- ``furthest_point_sample`` and ``combined_fps`` (B = 2): equal indices;
- ``ball_query`` with empty balls and balls with fewer points than
  slots: equal indices;
- ``knn``/``three_nn``: equal indices and distances;
- ``gather_points``, ``group_points`` (-1 slots zeroed) and
  ``three_interpolate`` on seeded features within 1e-6 of max;
- two card runs of each bit-equal.

Without a card every test skips. No JAX here.
"""
import numpy as np
import pytest
import torch

from msmdfusion_torch.ops import sampling


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card: the point zoo runs there on CUDA')
    return torch.device('cuda')


def grid_points(rng, b=2, n=4000):
    """[b, n, 3] points on a 1/8 m grid in a 4 x 4 x 2 m box, a tenth of
    them duplicated, the last 50 of each sample invalid."""
    xyz = rng.randint(0, 33, (b, n, 3)) / 8.0
    xyz[..., 2] /= 2
    xyz[:, n // 2:n // 2 + n // 10] = xyz[:, :n // 10]
    valid = np.ones((b, n), bool)
    valid[:, -50:] = False
    return torch.from_numpy(xyz.astype(np.float32)), torch.from_numpy(valid)


def both(card, fn, *args, **kwargs):
    """fn on the CPU and twice on the card: (cpu, card) results; the two
    card runs bit-equal."""
    def on(dev):
        return [a.to(dev) if torch.is_tensor(a) else a for a in args]

    def kw(dev):
        return {k: v.to(dev) if torch.is_tensor(v) else v
                for k, v in kwargs.items()}
    want = fn(*on('cpu'), **kw('cpu'))
    got = [fn(*on(card), **kw(card)) for _ in range(2)]
    flat = [g if isinstance(g, tuple) else (g,) for g in got]
    for a, b in zip(*flat):
        assert torch.equal(a, b)
    return want, got[0]


@pytest.mark.cuda
def test_fps_matches_cpu(card):
    rng = np.random.RandomState(0)
    xyz, valid = grid_points(rng)
    feats = torch.from_numpy((rng.randint(-16, 17, (2, 4000, 8)) / 8.0)
                             .astype(np.float32))
    for fn, args in ((sampling.furthest_point_sample, (xyz, 512, valid)),
                     (sampling.combined_fps, (xyz, feats, 256, valid))):
        want, got = both(card, fn, *args)
        assert torch.equal(got.cpu(), want)
        assert bool(valid.gather(1, want).all())


@pytest.mark.cuda
def test_ball_query_and_knn_match_cpu(card):
    rng = np.random.RandomState(1)
    xyz, valid = grid_points(rng)
    centres = sampling.gather_points(
        xyz, sampling.furthest_point_sample(xyz, 256, valid))
    centres[:, :16] += 50.0                           # empty balls
    for radius, k in ((0.25, 16), (0.5, 64)):
        want, got = both(card, sampling.ball_query, radius, k, xyz, centres,
                         xyz_valid=valid)
        assert torch.equal(got.cpu(), want)
        assert bool((want[:, :16] == -1).all())
        assert bool((want[:, 16:] >= 0).all())
    want, got = both(card, sampling.three_nn, centres, xyz, valid)
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[0].cpu(), want[0])


@pytest.mark.cuda
def test_gathers_and_interpolation_match_cpu(card):
    rng = np.random.RandomState(2)
    xyz, valid = grid_points(rng)
    feats = torch.from_numpy(rng.randn(2, 4000, 32).astype(np.float32))
    centres = sampling.gather_points(
        xyz, sampling.furthest_point_sample(xyz, 128, valid))
    centres[:, :8] += 50.0
    idx = sampling.ball_query(0.5, 16, xyz, centres, xyz_valid=valid)
    want, got = both(card, sampling.group_points, feats, idx)
    assert bool((want[:, :8] == 0).all())
    assert float((got.cpu() - want).abs().max()) == 0.0
    d2, nn = sampling.three_nn(xyz, centres[:, 8:])
    want, got = both(card, sampling.three_interpolate, feats[:, 8:128],
                     nn, d2)
    scale = float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) <= 1e-6 * scale
