"""The port's MDU virtual-point generator
(``msmdfusion_torch/tools/generate_virtual_points.py``) vs the repository's
``tools/generate_virtual_points.py``, on the CPU.

Three cameras over a LiDAR frame of two walls and scattered points, each
with a mask instance and a box instance (and one instance no point falls
in): every array of the artifact (virtual and real pixels, virtual and
real points) within 1e-5 of the tool's, the same virtual pixels drawn
(``RandomState(seed + camera)`` in the tool's order); the port's CLI
writes the ``.pkl.npy`` that the port's ``LoadForeground2D`` reads.
"""
import importlib.util
import os
import pickle

import numpy as np

from msmdfusion_torch.datasets.pipelines.foreground import LoadForeground2D
from msmdfusion_torch.tools import generate_virtual_points as gvp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
KEYS = ('virtual_pixel_indices', 'real_pixel_indices', 'virtual_points',
        'real_points')


def root_tool():
    spec = importlib.util.spec_from_file_location(
        'root_generate_virtual_points',
        os.path.join(REPO, 'tools', 'generate_virtual_points.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def scene(rng):
    """(points [N, 5], cams): two walls at 10 m and 14 m ahead and
    scattered points; three pinhole cameras yawed -0.3, 0, 0.3 rad."""
    yy, zz = np.meshgrid(np.linspace(-3, 3, 40), np.linspace(-1.5, 1.5, 30))
    walls = [np.stack([np.full(yy.size, x) + rng.normal(0, 0.05, yy.size),
                       yy.ravel() + off, zz.ravel()], 1)
             for x, off in ((10.0, -1.0), (14.0, 2.0))]
    scatter = rng.uniform([-5, -20, -2], [40, 20, 3], (500, 3))
    xyz = np.concatenate(walls + [scatter])
    points = np.concatenate([xyz, rng.rand(len(xyz), 2)], 1).astype(
        np.float32)
    intr = np.array([[400.0, 0, 320, 0], [0, 400, 240, 0], [0, 0, 1, 0],
                     [0, 0, 0, 1]])
    cams = []
    for i, yaw in enumerate((-0.3, 0.0, 0.3)):
        c, s = np.cos(yaw), np.sin(yaw)
        lidar2cam = np.array([[-s, -c, 0, 0], [0, 0, -1, 0], [c, -s, 0, 0],
                              [0, 0, 0, 1]])
        mask = np.zeros((480, 640), bool)
        mask[150 + 20 * i:330, 180:420 - 30 * i] = True
        cams.append(dict(lidar2img=intr @ lidar2cam, img_hw=(480, 640),
                         instances=[
                             dict(mask=mask, label=2),
                             dict(bbox=[60.0, 100.0, 300.0, 400.0],
                                  label=7),
                             dict(bbox=[630.0, 0.0, 639.0, 2.0], label=1)]))
    return points, cams


def test_artifact_matches_the_tool(tmp_path):
    points, cams = scene(np.random.RandomState(0))
    want = root_tool().generate_sample_artifact(points, cams,
                                                num_virtual=60, seed=3)
    got = gvp.generate_sample_artifact(points, cams, num_virtual=60, seed=3,
                                       device='cpu')
    for key in KEYS:
        assert len(got[key]) == len(want[key]) == 3
        for cam, (g, w) in enumerate(zip(got[key], want[key])):
            assert g.dtype == w.dtype and g.shape == w.shape, (key, cam)
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL,
                                       err_msg=f'{key} camera {cam}')
    assert all(len(v) == 120 for v in got['virtual_points'])
    assert all(len(r) > 50 for r in got['real_points'])

    # the CLI's artifact, read by the port's LoadForeground2D
    lidar = tmp_path / 'samples' / 'LIDAR_TOP'
    lidar.mkdir(parents=True)
    points.tofile(lidar / 'f.bin')
    with open(tmp_path / 'dets.pkl', 'wb') as f:
        pickle.dump({'f.bin': cams, 'missing.bin': cams}, f)
    assert gvp.main([str(tmp_path), '--detections',
                     str(tmp_path / 'dets.pkl'), '--num-virtual', '60',
                     '--device', 'cpu']) == 1
    out = LoadForeground2D()(dict(pts_filename=str(lidar / 'f.bin')))
    fg = out['foreground2D_info']
    assert len(fg['fg_pixels']) == 3
    assert fg['fg_points'][0].shape[1] == 15       # xyz, 11 labels, time
