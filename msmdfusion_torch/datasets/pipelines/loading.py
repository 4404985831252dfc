"""Point-cloud, annotation and image loading transforms (numpy, CPU side).

Counterpart of the JAX package's ``datasets/pipelines/loading.py``
(reference mmdet3d/datasets/pipelines/loading.py):

- ``LoadPointsFromFile`` (:728): .bin float32 readers with a use_dim select;
- ``LoadPointsFromMultiSweeps`` (:503): per-sweep sensor2lidar transform,
  timestamp channel, concat (loading.py:604-637);
- ``LoadAnnotations3D`` (:834): GT boxes and labels from the info dict;
- ``LoadMultiViewImageFromFiles`` (:429): the camera image stack. ``.npy``
  views are read with numpy; any other file is decoded by PIL, and without
  PIL reading it raises an error that names the file;
- ``MyResize``/``ImageResize``: a port of PIL's ``BILINEAR`` resampling in
  torch (``pil_bilinear_resize``), so that it needs no PIL;
- ``MyNormalize``, ``MyPad``, ``PadPoints``, ``PadGroundTruth``,
  ``FormatBundle3D`` and ``Compose``.

Random transforms draw from an explicit ``np.random.RandomState``:
``Compose`` hands its ``rng`` to each transform whose class sets
``draws = True``, and nothing reads numpy's global generator.
"""
from __future__ import annotations

import math
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ...registry import PIPELINES
from ...utils import overflow


def require_rng(rng, who: str) -> np.random.RandomState:
    """``rng``, or an error naming the transform that needed one."""
    if rng is None:
        raise ValueError(f'{who} draws random numbers: pass an '
                         'np.random.RandomState (the loader seeds one per '
                         'sample)')
    return rng


@PIPELINES.register('LoadPointsFromFile')
class LoadPointsFromFile:
    def __init__(self, coord_type='LIDAR', load_dim=5, use_dim=(0, 1, 2, 3),
                 file_client_args=None):
        self.coord_type = coord_type
        self.load_dim = load_dim
        self.use_dim = list(use_dim) if not isinstance(use_dim, int) \
            else list(range(use_dim))

    def __call__(self, results):
        points = np.fromfile(results['pts_filename'], dtype=np.float32)
        points = points.reshape(-1, self.load_dim)[:, self.use_dim]
        results['points'] = points.astype(np.float32)
        return results


@PIPELINES.register('LoadPointsFromMultiSweeps')
class LoadPointsFromMultiSweeps:
    draws = True    # the sweep choice in training, where sweeps abound

    def __init__(self, sweeps_num=10, load_dim=5, use_dim=(0, 1, 2, 3, 4),
                 pad_empty_sweeps=True, remove_close=True, test_mode=False,
                 file_client_args=None):
        self.sweeps_num = sweeps_num
        self.load_dim = load_dim
        self.use_dim = list(use_dim)
        self.pad_empty_sweeps = pad_empty_sweeps
        self.remove_close = remove_close
        self.test_mode = test_mode

    def _remove_close(self, points, radius=1.0):
        dist = np.linalg.norm(points[:, :2], axis=1)
        return points[dist > radius]

    def __call__(self, results, rng=None):
        points = results['points']
        points[:, 4] = 0.0 if points.shape[1] > 4 else 0
        sweep_points = [points]
        ts = results.get('timestamp', 0) / 1e6
        sweeps = results.get('sweeps', [])
        if len(sweeps) == 0 and self.pad_empty_sweeps:
            for _ in range(self.sweeps_num):
                sweep_points.append(
                    self._remove_close(points) if self.remove_close
                    else points)
        else:
            if len(sweeps) <= self.sweeps_num:
                choices = np.arange(len(sweeps))
            elif self.test_mode:
                choices = np.arange(self.sweeps_num)
            else:
                choices = require_rng(rng, type(self).__name__).choice(
                    len(sweeps), self.sweeps_num, replace=False)
            for idx in choices:
                sweep = sweeps[idx]
                pts = np.fromfile(sweep['data_path'],
                                  dtype=np.float32).reshape(-1, self.load_dim)
                if self.remove_close:
                    pts = self._remove_close(pts)
                rot = sweep['sensor2lidar_rotation']
                trans = sweep['sensor2lidar_translation']
                pts[:, :3] = pts[:, :3] @ rot.T + trans
                sweep_ts = sweep['timestamp'] / 1e6
                pts[:, 4] = ts - sweep_ts
                sweep_points.append(pts)
        points = np.concatenate(sweep_points, axis=0)[:, self.use_dim]
        results['points'] = points.astype(np.float32)
        return results


@PIPELINES.register('LoadAnnotations3D')
class LoadAnnotations3D:
    def __init__(self, with_bbox_3d=True, with_label_3d=True, **kwargs):
        self.with_bbox_3d = with_bbox_3d
        self.with_label_3d = with_label_3d

    def __call__(self, results):
        ann = results['ann_info']
        if self.with_bbox_3d:
            results['gt_bboxes_3d'] = ann['gt_bboxes_3d'].astype(np.float32)
        if self.with_label_3d:
            results['gt_labels_3d'] = ann['gt_labels_3d'].astype(np.int64)
        return results


def read_image(path: str) -> np.ndarray:
    """One view as an array: ``.npy`` with numpy, anything else (JPEG,
    PNG) decoded by PIL; without PIL the error names the file."""
    if path.endswith('.npy'):
        return np.load(path)
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f'{path}: decoding this image needs PIL (Pillow), which is not '
            'installed; install it or store the views as .npy arrays') from e
    with Image.open(path) as im:
        return np.asarray(im)


@PIPELINES.register('LoadMultiViewImageFromFiles')
class LoadMultiViewImageFromFiles:
    def __init__(self, to_float32=False, color_type='color'):
        self.to_float32 = to_float32

    def __call__(self, results):
        img = np.stack([read_image(p) for p in results['img_filename']],
                       axis=0)
        if self.to_float32:
            img = img.astype(np.float32)
        results['img'] = img
        results['img_shape'] = img.shape[1:]
        results['ori_shape'] = img.shape[1:]
        return results


# PIL's fixed-point resampling of 8-bit images (Pillow's Resample.c)
_PRECISION_BITS = 32 - 8 - 2


def bilinear_taps(in_size: int, out_size: int):
    """PIL's ``BILINEAR`` coefficients for resizing an axis of ``in_size``
    to ``out_size`` (``precompute_coeffs`` with the triangle filter, whose
    support widens with the downscale factor, then
    ``normalize_coeffs_8bpc``): (index [out, k], weight [out, k]) int64,
    the weights in fixed point with 22 fractional bits, zero past each
    output's taps. Same double arithmetic, in the same order, as Pillow."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    index = np.zeros((out_size, ksize), np.int64)
    weight = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        taps = []
        ww = 0.0
        for x in range(xmax):
            w = abs((x + xmin - center + 0.5) * ss)
            w = 1.0 - w if w < 1.0 else 0.0
            taps.append(w)
            ww += w
        for x, w in enumerate(taps):
            if ww != 0.0:
                w /= ww
            index[xx, x] = xmin + x
            weight[xx, x] = int((-0.5 if w < 0 else 0.5)
                                + w * (1 << _PRECISION_BITS))
    return index, weight


def _resample_axis(img: torch.Tensor, axis: int, taps) -> torch.Tensor:
    """One pass of PIL's 8-bit resampling along ``axis`` of a uint8 image
    with ``taps`` (``bilinear_taps``): the sum of taps times fixed-point
    weights in int32, rounded, clipped to 0..255 (``clip8``)."""
    index, weight = taps
    shape = [1] * img.dim()
    shape[axis] = index.shape[0]
    acc = None
    for k in range(index.shape[1]):
        term = img.index_select(axis, index[:, k]) * \
            weight[:, k].reshape(shape)           # uint8 * int32 -> int32
        acc = term.add_(1 << (_PRECISION_BITS - 1)) if acc is None \
            else acc.add_(term)
    return torch.clamp(acc >> _PRECISION_BITS, 0, 255).to(torch.uint8)


def pil_bilinear_resize(img: np.ndarray, new_h: int, new_w: int
                        ) -> np.ndarray:
    """uint8 [..., H, W, C] -> uint8 [..., new_h, new_w, C], as PIL's
    ``Image.resize((new_w, new_h), Image.BILINEAR)`` gives each image
    (horizontal pass first, an 8-bit image between the passes), computed
    in torch on the CPU, one image at a time."""
    if img.dtype != np.uint8:
        raise TypeError(f'pil_bilinear_resize takes uint8, got {img.dtype}')
    h, w, c = img.shape[-3:]

    def taps(n, m):
        index, weight = bilinear_taps(n, m)
        return torch.from_numpy(index), torch.from_numpy(weight).to(
            torch.int32)
    across, down = taps(w, new_w), taps(h, new_h)
    out = []
    for x in torch.from_numpy(np.ascontiguousarray(img)).reshape(-1, h, w, c):
        if new_w != w:
            x = _resample_axis(x, 1, across)
        if new_h != h:
            x = _resample_axis(x, 0, down)
        out.append(x)
    return torch.stack(out).reshape(*img.shape[:-3], new_h, new_w,
                                    c).numpy()


@PIPELINES.register('MyResize')
@PIPELINES.register('ImageResize')
class ImageResize:
    """Resize the multi-view image stack, recording ``scale_factor``.

    Equivalent of the reference's ``MyResize`` (mmdet3d/datasets/pipelines/
    loading.py:11-312) in single-scale keep_ratio mode: the rescale factor is
    ``min(max(scale)/max(h,w), min(scale)/min(h,w))`` (mmcv imrescale), and
    ``scale_factor = [w_scale, h_scale, w_scale, h_scale]`` is stored for the
    foreground pixel replay (``ImgScaleCropFlipForeground2D``). Each view
    is resampled as PIL's ``BILINEAR`` does (``pil_bilinear_resize``).
    """

    def __init__(self, img_scale=None, keep_ratio=True, multiscale_mode=None,
                 ratio_range=None, bbox_clip_border=True, backend=None):
        self.img_scale = tuple(img_scale)
        self.keep_ratio = keep_ratio

    def _target_hw(self, h, w):
        if self.keep_ratio:
            f = min(max(self.img_scale) / max(h, w),
                    min(self.img_scale) / min(h, w))
            return int(h * f + 0.5), int(w * f + 0.5)
        return min(self.img_scale), max(self.img_scale)

    @staticmethod
    def _resize(img, new_h, new_w):
        if img.dtype == np.uint8:
            return pil_bilinear_resize(img, new_h, new_w)
        return pil_bilinear_resize(img.astype(np.uint8), new_h,
                                   new_w).astype(img.dtype)

    def __call__(self, results):
        img = results['img']                     # [V, H, W, 3]
        h, w = img.shape[1:3]
        new_h, new_w = self._target_hw(h, w)
        results['img'] = self._resize(img, new_h, new_w)
        w_scale, h_scale = new_w / w, new_h / h
        results['img_shape'] = results['img'].shape[1:]
        results['scale_factor'] = np.array(
            [w_scale, h_scale, w_scale, h_scale], np.float32)
        results['keep_ratio'] = self.keep_ratio
        return results


@PIPELINES.register('MyNormalize')
@PIPELINES.register('ImageNormalize')
class ImageNormalize:
    """Normalize the multi-view image stack (reference ``MyNormalize``,
    loading.py:313-354). The views are read in RGB order, so ``to_rgb``
    is kept for config parity only: the mean and std are RGB values."""

    def __init__(self, mean, std, to_rgb=True):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.to_rgb = to_rgb

    def __call__(self, results):
        img = results['img'].astype(np.float32)
        results['img'] = (img - self.mean) / self.std
        results['img_norm_cfg'] = dict(mean=self.mean, std=self.std,
                                       to_rgb=self.to_rgb)
        return results


@PIPELINES.register('MyPad')
@PIPELINES.register('ImagePad')
class ImagePad:
    """Zero-pad images to a size divisor / fixed size (reference ``MyPad``,
    loading.py:355-428)."""

    def __init__(self, size=None, size_divisor=None, pad_val=0):
        if (size is None) == (size_divisor is None):
            raise ValueError('ImagePad takes exactly one of size and '
                             'size_divisor')
        self.size = size
        self.size_divisor = size_divisor
        self.pad_val = pad_val

    def __call__(self, results):
        img = results['img']
        h, w = img.shape[1:3]
        if self.size_divisor is not None:
            d = self.size_divisor
            ph, pw = -(-h // d) * d, -(-w // d) * d
        else:
            ph, pw = self.size
        if (ph, pw) != (h, w):
            out = np.full((img.shape[0], ph, pw, img.shape[3]),
                          self.pad_val, img.dtype)
            out[:, :h, :w] = img
            results['img'] = out
        results['pad_shape'] = results['img'].shape[1:]
        results['pad_fixed_size'] = self.size
        results['pad_size_divisor'] = self.size_divisor
        return results


@PIPELINES.register('PadPoints')
class PadPoints:
    """Pad/crop the point cloud to a fixed capacity with a validity mask;
    points past it are dropped and counted at ``pipeline.points_cap``."""

    def __init__(self, max_points: int):
        self.max_points = max_points

    def __call__(self, results):
        points = results['points']
        n = points.shape[0]
        cap = self.max_points
        if n >= cap:
            if n > cap:
                overflow.record('pipeline.points_cap', n - cap)
            results['points'] = points[:cap]
            results['points_mask'] = np.ones(cap, bool)
        else:
            pad = np.zeros((cap - n, points.shape[1]), points.dtype)
            results['points'] = np.concatenate([points, pad])
            mask = np.zeros(cap, bool)
            mask[:n] = True
            results['points_mask'] = mask
        return results


@PIPELINES.register('PadGroundTruth')
class PadGroundTruth:
    """Pad GT boxes/labels to a fixed capacity with a validity mask."""

    def __init__(self, max_gt: int = 500, box_dim: int = 9):
        self.max_gt = max_gt
        self.box_dim = box_dim

    def __call__(self, results):
        boxes = results.get('gt_bboxes_3d',
                            np.zeros((0, self.box_dim), np.float32))
        labels = results.get('gt_labels_3d', np.zeros((0,), np.int64))
        g = min(boxes.shape[0], self.max_gt)
        out_boxes = np.zeros((self.max_gt, self.box_dim), np.float32)
        out_labels = np.zeros((self.max_gt,), np.int64)
        mask = np.zeros((self.max_gt,), bool)
        if boxes.shape[0]:
            d = min(boxes.shape[1], self.box_dim)
            out_boxes[:g, :d] = boxes[:g, :d]
            out_labels[:g] = labels[:g]
            mask[:g] = True
        results['gt_bboxes_3d'] = out_boxes
        results['gt_labels_3d'] = out_labels
        results['gt_valid'] = mask
        return results


@PIPELINES.register('FormatBundle3D')
class FormatBundle3D:
    """Collect the fixed-shape arrays for batching (DefaultFormatBundle3D +
    Collect3D equivalent, reference formating.py:262); the metas also keep
    ``ObjectSample``'s ``gt_paste`` counts where it ran (the JAX package's
    have no such key)."""

    KEYS = ('points', 'points_mask', 'gt_bboxes_3d', 'gt_labels_3d',
            'gt_valid', 'img', 'foreground')

    def __init__(self, class_names=None, with_label=True):
        self.class_names = class_names
        self.with_label = with_label

    def __call__(self, results):
        out = {k: results[k] for k in self.KEYS if k in results}
        out['metas'] = {
            k: results[k] for k in
            ('sample_idx', 'pts_filename', 'token', 'timestamp',
             'lidar2img', 'flip_state', 'aug_state', 'scale_factor',
             'img_shape', 'ori_shape', 'pad_shape', 'img_norm_cfg',
             'gt_paste')
            if k in results}
        return out


class Compose:
    """Sequential pipeline composition (mmcv Compose equivalent); ``rng``
    goes to the transforms that draw (class attribute ``draws``)."""

    def __init__(self, transforms: Sequence[Any]):
        self.transforms = []
        for t in transforms:
            if isinstance(t, dict):
                self.transforms.append(PIPELINES.build(dict(t)))
            else:
                self.transforms.append(t)

    def __call__(self, results,
                 rng: Optional[np.random.RandomState] = None):
        for t in self.transforms:
            results = t(results, rng) if getattr(t, 'draws', False) \
                else t(results)
            if results is None:
                return None
        return results
