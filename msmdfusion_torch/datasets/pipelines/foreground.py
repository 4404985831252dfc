"""Foreground-2D (MDU virtual point) loading pipeline.

Counterpart of the JAX package's ``datasets/pipelines/foreground.py``
(reference mmdet3d/datasets/pipelines/my_loading_multi_proj.py):

- ``LoadForeground2D`` (:14-120): the per-camera virtual and real point /
  pixel sets of the precomputed ``FOREGROUND_MIXED_6NN_WITH_DEPTH``
  .pkl.npy artifacts, with the one-hot label block and a timestamp channel
  appended (points end up 15 wide: xyz + 11 labels + ts);
- ``LoadForeground2DFromMultiSweeps`` (:163-338): per-sweep loads with
  sensor2lidar transforms; a sweep without artifacts is skipped, as the
  reference does (:315-329);
- ``GlobalRotTransFilterForeground2D`` (:340-411): replays the recorded 3D
  augmentation flow and the range filter on the foreground points;
- ``ImgScaleCropFlipForeground2D`` (:422): replays the 2D resize on the
  foreground pixels;
- ``ShuffleForeground2D`` (:460), which draws from the ``rng`` ``Compose``
  hands it;
- ``PadForeground2D``: fixed-capacity padding per camera with masks; rows
  past a capacity are dropped and counted at ``foreground.points_cap``,
  ``foreground.pixels_cap`` and ``foreground.real_pixels_cap``.
"""
from __future__ import annotations

import os

import numpy as np

from ...registry import PIPELINES
from ...utils import overflow
from .loading import require_rng

NUM_CAMS = 6


def _fg_artifact_path(pts_filename: str, subdir: str) -> str:
    tokens = pts_filename.split('/')
    prefix = '/' if pts_filename.startswith('/') else ''
    return prefix + os.path.join(*tokens[:-2], subdir, tokens[-1] + '.pkl.npy')


def _load_artifact(path: str):
    return np.load(path, allow_pickle=True).item()


@PIPELINES.register('LoadForeground2D')
class LoadForeground2D:
    def __init__(self, dataset='NuScenesDataset',
                 subdir='FOREGROUND_MIXED_6NN_WITH_DEPTH', **kwargs):
        self.dataset = dataset
        self.subdir = subdir

    def _organize(self, fg_info):
        fg_pixels, fg_points = [], []
        fg_real_pixels, fg_real_points = [], []
        for i in range(len(fg_info['virtual_pixel_indices'])):
            vp = fg_info['virtual_pixel_indices'][i]
            rp = fg_info['real_pixel_indices'][i]
            pixels = np.concatenate([vp[:, :3], rp[:, :3]], axis=0)
            vpts = fg_info['virtual_points'][i]
            rpts = fg_info['real_points'][i]
            if vpts.shape[1] == 3:  # append the label block after xyz
                vpts = np.concatenate([vpts, vp[:, -11:]], axis=1)
                rpts = np.concatenate([rpts, rp[:, -11:]], axis=1)
            pts = np.concatenate([vpts, rpts], axis=0)
            ts = np.zeros((pts.shape[0], 1), pts.dtype)
            fg_pixels.append(pixels)
            fg_points.append(np.concatenate([pts, ts], axis=1))
            rts = np.zeros((rpts.shape[0], 1), rpts.dtype)
            fg_real_pixels.append(rp[:, :3])
            fg_real_points.append(np.concatenate([rpts, rts], axis=1))
        return dict(fg_pixels=fg_pixels, fg_points=fg_points,
                    fg_real_pixels=fg_real_pixels,
                    fg_real_points=fg_real_points)

    def __call__(self, results):
        path = _fg_artifact_path(results['pts_filename'], self.subdir)
        results['foreground2D_info'] = self._organize(_load_artifact(path))
        return results


@PIPELINES.register('LoadForeground2DFromMultiSweeps')
class LoadForeground2DFromMultiSweeps:
    def __init__(self, dataset='NuScenesDataset', sweeps_num=10,
                 subdir='FOREGROUND_MIXED_6NN_WITH_DEPTH'):
        self.sweeps_num = sweeps_num
        self.subdir = subdir

    def __call__(self, results):
        fg = results['foreground2D_info']
        ts = results.get('timestamp', 0) / 1e6
        for sweep in results.get('sweeps', [])[:self.sweeps_num]:
            path = _fg_artifact_path(sweep['data_path'], self.subdir)
            if not os.path.exists(path):
                continue  # the reference skips sweeps without artifacts
            sweep_info = _load_artifact(path)
            rot = np.asarray(sweep['sensor2lidar_rotation'])
            trans = np.asarray(sweep['sensor2lidar_translation'])
            sweep_ts = sweep['timestamp'] / 1e6
            for cam in range(len(fg['fg_points'])):
                vpts = sweep_info['virtual_points'][cam]
                vp = sweep_info['virtual_pixel_indices'][cam]
                if vpts.shape[1] == 3:
                    vpts = np.concatenate([vpts, vp[:, -11:]], axis=1)
                vpts = vpts.copy()
                vpts[:, :3] = vpts[:, :3] @ rot.T + trans
                col_ts = np.full((vpts.shape[0], 1), ts - sweep_ts,
                                 vpts.dtype)
                fg['fg_points'][cam] = np.concatenate(
                    [fg['fg_points'][cam],
                     np.concatenate([vpts, col_ts], axis=1)], axis=0)
                fg['fg_pixels'][cam] = np.concatenate(
                    [fg['fg_pixels'][cam], vp[:, :3]], axis=0)
        return results


@PIPELINES.register('GlobalRotTransFilterForeground2D')
class GlobalRotTransFilterForeground2D:
    """Replay the recorded 3D augmentation flow on foreground points."""

    def __init__(self, point_cloud_range):
        self.pcr = np.asarray(point_cloud_range, np.float32)

    def __call__(self, results):
        flow = results.get('transformation_3d_flow', [])
        fg = results['foreground2D_info']
        for cam in range(len(fg['fg_points'])):
            pts = fg['fg_points'][cam]
            pix = fg['fg_pixels'][cam]
            if not len(pts):
                continue
            xyz = pts[:, :3]
            for kind, args in flow:
                if kind == 'GRT':
                    c, s = np.cos(args['angle']), np.sin(args['angle'])
                    rot = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]],
                                   xyz.dtype)
                    xyz = (xyz @ rot) * args['scale'] + args['trans']
                elif kind == 'flip':
                    if args['horizontal']:
                        xyz[:, 1] = -xyz[:, 1]
                    if args['vertical']:
                        xyz[:, 0] = -xyz[:, 0]
            keep = np.all((xyz >= self.pcr[:3]) & (xyz <= self.pcr[3:]),
                          axis=1)
            pts = pts[keep]
            pts[:, :3] = xyz[keep]
            fg['fg_points'][cam] = pts
            fg['fg_pixels'][cam] = pix[keep]
        return results


@PIPELINES.register('ImgScaleCropFlipForeground2D')
class ImgScaleCropFlipForeground2D:
    """Replay the 2D image augmentation (resize scale) on fg pixel coords."""

    def __call__(self, results):
        scale = results.get('scale_factor', 1.0)
        if isinstance(scale, (list, tuple, np.ndarray)):
            sx, sy = float(scale[0]), float(scale[1])
        else:
            sx = sy = float(scale)
        fg = results['foreground2D_info']
        for key in ('fg_pixels', 'fg_real_pixels'):
            for cam in range(len(fg[key])):
                pix = fg[key][cam]
                if len(pix):
                    pix = pix.copy()
                    pix[:, 0] *= sx
                    pix[:, 1] *= sy
                    fg[key][cam] = pix
        return results


@PIPELINES.register('ShuffleForeground2D')
class ShuffleForeground2D:
    draws = True

    def __call__(self, results, rng=None):
        rng = require_rng(rng, type(self).__name__)
        fg = results['foreground2D_info']
        for cam in range(len(fg['fg_points'])):
            n = len(fg['fg_points'][cam])
            if n:
                idx = rng.permutation(n)
                fg['fg_points'][cam] = fg['fg_points'][cam][idx]
                fg['fg_pixels'][cam] = fg['fg_pixels'][cam][idx]
        return results


@PIPELINES.register('PadForeground2D')
class PadForeground2D:
    """Fixed-capacity per-camera padding -> the device-side fg dict."""

    def __init__(self, max_points: int = 25000, max_real_points: int = 20000,
                 point_dim: int = 15, num_cams: int = NUM_CAMS):
        self.max_points = max_points
        self.max_real = max_real_points
        self.point_dim = point_dim
        self.num_cams = num_cams

    def _pad(self, arrays, cap, dim, site):
        out = np.zeros((self.num_cams, cap, dim), np.float32)
        mask = np.zeros((self.num_cams, cap), bool)
        for cam, arr in enumerate(arrays[:self.num_cams]):
            n = min(len(arr), cap)
            if len(arr) > cap:
                overflow.record(site, len(arr) - cap)
            if n:
                out[cam, :n, :min(arr.shape[1], dim)] = \
                    arr[:n, :dim].astype(np.float32)
                mask[cam, :n] = True
        return out, mask

    def __call__(self, results):
        fg = results['foreground2D_info']
        pts, mask = self._pad(fg['fg_points'], self.max_points,
                              self.point_dim, 'foreground.points_cap')
        pix, _ = self._pad(fg['fg_pixels'], self.max_points, 3,
                           'foreground.pixels_cap')
        real_pix, real_mask = self._pad(fg['fg_real_pixels'], self.max_real,
                                        3, 'foreground.real_pixels_cap')
        results['foreground'] = dict(
            fg_pixels=pix, fg_points=pts, fg_mask=mask,
            fg_real_pixels=real_pix, fg_real_mask=real_mask,
            lidar2img=np.asarray(results.get(
                'lidar2img', np.eye(4)[None].repeat(self.num_cams, 0)),
                np.float32))
        return results
