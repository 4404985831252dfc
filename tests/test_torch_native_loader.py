"""The port's binding of the native sweep loader
(``msmdfusion_torch/utils/native_loader.py``, ``native/loader.cc`` built
into ``msmdfusion_torch/_build/``) vs its numpy version and the JAX
package's ``load_sweeps``, on the same ``.bin`` files.

Four files (a keyframe and three sweeps, points within 1 m of the sensor
among them), each with its own rotation, translation and time delta: with
and without the close-point removal and the range filter, and a capacity
that cuts the last file. The masks are equal and the points within 1e-6
relative (the library's fp32 transform may fuse its multiply-adds). A
failed build, a missing file and a bad transform raise; the build is
named by the hash of the source, never the library checked in beside
it.
"""
import numpy as np
import pytest

from msmdfusion_tpu.utils import native_loader as jax_loader
from msmdfusion_torch.utils import native_loader


@pytest.fixture(scope='module')
def files(tmp_path_factory):
    rng = np.random.RandomState(0)
    root = tmp_path_factory.mktemp('sweeps')
    paths, transforms = [], []
    for i in range(4):
        pts = rng.uniform(-20, 20, (200 + 30 * i, 5)).astype(np.float32)
        pts[:10, :2] = rng.uniform(-0.7, 0.7, (10, 2))     # close points
        path = root / f'sweep_{i}.bin'
        pts.tofile(path)
        paths.append(str(path))
        a = 0.1 * i
        t = np.zeros((3, 4), np.float32)
        t[:, :3] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                    [0, 0, 1]]
        t[:, 3] = [0.5 * i, -0.2 * i, 0.05 * i]
        transforms.append(t)
    return paths, np.stack(transforms), [0.0, 0.05, 0.1, 0.15]


@pytest.mark.parametrize('remove_close,point_range,capacity', [
    (False, None, 2000), (True, None, 2000),
    (True, [-10, -12, -15, 12, 10, 15], 2000), (True, None, 700)])
def test_native_matches_numpy_and_jax(files, remove_close, point_range,
                                      capacity):
    paths, transforms, deltas = files
    kw = dict(capacity=capacity, load_dim=5, out_dim=5,
              point_range=point_range, remove_close=remove_close)
    got, got_mask = native_loader.load_sweeps(paths, transforms, deltas,
                                              **kw)
    plain, plain_mask = native_loader.load_sweeps_plain(
        paths, transforms, deltas, **kw)
    want, want_mask = jax_loader.load_sweeps(paths, transforms, deltas, **kw)
    for pts, mask in ((plain, plain_mask), (want, want_mask)):
        np.testing.assert_array_equal(got_mask, mask)
        np.testing.assert_allclose(got, pts, rtol=1e-6, atol=1e-6)
    assert 0 < got_mask.sum() <= capacity
    assert not got[~got_mask].any()
    if capacity == 700:
        assert got_mask.all()
    if not remove_close and point_range is None:
        assert got_mask.sum() == sum(200 + 30 * i for i in range(4))
    assert native_loader.library_path().is_file()
    assert native_loader.library_path().parent.name == '_build'


def test_refusals(files, tmp_path, monkeypatch):
    paths, transforms, deltas = files
    monkeypatch.setattr(native_loader, 'BUILD_DIR', tmp_path / '_build')
    monkeypatch.setattr(native_loader, '_lib', None)
    monkeypatch.setenv('CXX', 'false')
    with pytest.raises(RuntimeError, match='building'):
        native_loader.load_sweeps(paths, transforms, deltas, capacity=10)
    assert not list((tmp_path / '_build').iterdir())
    monkeypatch.undo()
    with pytest.raises(FileNotFoundError):
        native_loader.load_sweeps(paths + [str(tmp_path / 'no.bin')],
                                  np.concatenate([transforms,
                                                  transforms[:1]]),
                                  deltas + [0.2], capacity=10)
    with pytest.raises(ValueError, match='transforms'):
        native_loader.load_sweeps(paths, transforms[:2], deltas,
                                  capacity=10)
