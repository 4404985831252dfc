"""Camera-LiDAR fusion: the 3-D and 2-D augmentation replays, projection,
bilinear sampling and ``PointFusion``.

Counterpart of the JAX package's ``models/fusion_layers.py`` (reference
mmdet3d/models/fusion_layers/coord_transform.py and point_fusion.py:306):

- ``apply_3d_transformation`` replays (or inverts) a recorded 3-D
  augmentation flow on [N, 3] points; ``extract_2d_aug``,
  ``coord_2d_transform`` and ``bbox_2d_transform`` replay the 2-D one on
  pixel coordinates and boxes;
- ``project_points_to_image`` projects through a lidar2img matrix, the
  depth clamped at 1e-5; ``bilinear_sample`` samples a feature map at
  pixel coordinates of the original image, its corners clamped into the
  map (``F.grid_sample(..., padding_mode='border', align_corners=False)``
  computes the same);
- ``PointFusion`` decorates points with the image features sampled at
  their projections (summed over the views that see them) through linear
  maps (``img_transform``, ``pts_transform`` and, with ``fuse_out``,
  ``fuse_conv``: mmdet3d's names; the JAX layer has no norms there, and
  neither has the port).

``VoteFusion`` (ImVoteNet's) comes with the indoor models.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import torch
from torch import nn

from ..registry import FUSION_LAYERS
from .layers import Linear


def apply_3d_transformation(points, aug_state: Dict[str, Any],
                            reverse: bool = False):
    """Replay (or invert) the recorded augmentation flow on [N, 3] points.

    ``aug_state``: {'angle', 'scale', 'trans', 'flip_horizontal',
    'flip_vertical'} and an optional ``transformation_3d_flow``, the order
    of the ops among ``('R', 'S', 'T', 'HF', 'VF')`` (default that
    order); ``reverse`` undoes them in the opposite order."""
    angle = aug_state.get('angle', 0.0)
    scale = aug_state.get('scale', 1.0)
    trans = torch.as_tensor(aug_state.get('trans', (0.0, 0.0, 0.0)),
                            dtype=points.dtype, device=points.device)
    flip_h = aug_state.get('flip_horizontal', False)
    flip_v = aug_state.get('flip_vertical', False)
    flow = list(aug_state.get('transformation_3d_flow',
                              ('R', 'S', 'T', 'HF', 'VF')))

    def rot(p, a):
        a = torch.as_tensor(a, dtype=p.dtype, device=p.device)
        c, s = torch.cos(a), torch.sin(a)
        zero, one = torch.zeros_like(c), torch.ones_like(c)
        r = torch.stack([torch.stack([c, s, zero]),
                         torch.stack([-s, c, zero]),
                         torch.stack([zero, zero, one])])
        return p @ r

    def flip(p, axis, on):
        if not on:
            return p
        sign = torch.ones(3, dtype=p.dtype, device=p.device)
        sign[axis] = -1
        return p * sign

    sign = -1.0 if reverse else 1.0
    ops = {
        'R': lambda p: rot(p, sign * angle),
        'S': lambda p: p * (1.0 / scale if reverse else scale),
        'T': lambda p: p - trans if reverse else p + trans,
        'HF': lambda p: flip(p, 1, flip_h),
        'VF': lambda p: flip(p, 0, flip_v),
    }
    if reverse:
        flow = flow[::-1]
    for op in flow:
        points = ops[op](points)
    return points


def extract_2d_aug(img_meta: Dict[str, Any]):
    """(img_h, img_w, scale_factor [2], flip, crop_offset [2]) from the
    metas (reference coord_transform.py:93-119; defaults: no aug)."""
    shape = img_meta.get('img_shape', (1, 1))
    sf = img_meta.get('scale_factor', (1.0, 1.0))
    if torch.as_tensor(sf).dim() == 0:
        sf = (float(sf), float(sf))
    return (shape[0], shape[1],
            torch.as_tensor(sf[:2], dtype=torch.float32),
            bool(img_meta.get('flip', False)),
            torch.as_tensor(img_meta.get('img_crop_offset', (0.0, 0.0)),
                            dtype=torch.float32))


def _flip_x(xy, img_w):
    return torch.cat([img_w - xy[..., :1], xy[..., 1:]], -1)


def coord_2d_transform(img_meta: Dict[str, Any], coord_2d,
                       ori2new: bool = True):
    """Replay (``ori2new``) or invert the 2-D aug on [..., 2] pixel
    coordinates: scale, crop, flip (reference coord_transform.py:175-214)."""
    img_h, img_w, sf, flip, crop = extract_2d_aug(img_meta)
    coord_2d = torch.as_tensor(coord_2d)
    sf, crop = sf.to(coord_2d), crop.to(coord_2d)
    if ori2new:
        out = coord_2d * sf + crop
        return _flip_x(out, img_w) if flip else out
    out = _flip_x(coord_2d, img_w) if flip else coord_2d
    return (out - crop) / sf


def bbox_2d_transform(img_meta: Dict[str, Any], bbox_2d,
                      ori2new: bool = True):
    """Replay or invert the 2-D aug on [N, >=4] (x1, y1, x2, y2, ...)
    boxes; the flip swaps the left and right edges (reference
    coord_transform.py:121-173)."""
    img_h, img_w, sf, flip, crop = extract_2d_aug(img_meta)
    bbox_2d = torch.as_tensor(bbox_2d)
    sf, crop = sf.to(bbox_2d), crop.to(bbox_2d)
    xy1, xy2 = bbox_2d[..., 0:2], bbox_2d[..., 2:4]

    def flipped(a, b):
        return (torch.stack([img_w - b[..., 0], a[..., 1]], -1),
                torch.stack([img_w - a[..., 0], b[..., 1]], -1))
    if ori2new:
        xy1, xy2 = xy1 * sf + crop, xy2 * sf + crop
        if flip:
            xy1, xy2 = flipped(xy1, xy2)
    else:
        if flip:
            xy1, xy2 = flipped(xy1, xy2)
        xy1, xy2 = (xy1 - crop) / sf, (xy2 - crop) / sf
    return torch.cat([xy1, xy2, bbox_2d[..., 4:]], -1)


def bilinear_sample(feat, uv, img_hw):
    """feat [C, h, w], uv [N, 2] pixel coordinates in the original image
    of ``img_hw`` -> [N, C]: bilinear with half-pixel centres, the four
    corners clamped into the map."""
    c, fh, fw = feat.shape
    x = uv[:, 0] * (fw / img_hw[1]) - 0.5
    y = uv[:, 1] * (fh / img_hw[0]) - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    x0, y0 = x0.to(torch.int64), y0.to(torch.int64)
    flat = feat.reshape(c, fh * fw)
    out = 0.0
    for dy, dx, w in ((0, 0, (1 - wx) * (1 - wy)), (0, 1, wx * (1 - wy)),
                      (1, 0, (1 - wx) * wy), (1, 1, wx * wy)):
        xi = torch.clamp(x0 + dx, 0, fw - 1)
        yi = torch.clamp(y0 + dy, 0, fh - 1)
        out = out + flat[:, yi * fw + xi].t() * w[:, None]
    return out


def project_points_to_image(points, lidar2img, img_hw,
                            img_scale_factor=None):
    """[N, 3] LiDAR points through a [4, 4] lidar2img -> (uv [N, 2] in
    pixels, the depth clamped at 1e-5 below; a mask [N] of the points in
    front of the camera and on the image)."""
    hom = torch.cat([points, points.new_ones(points.shape[0], 1)], -1)
    proj = hom @ lidar2img.t()
    depth = proj[:, 2]
    uv = proj[:, :2] / torch.clamp(depth[:, None], min=1e-5)
    if img_scale_factor is not None:
        uv = uv * torch.as_tensor(img_scale_factor, dtype=uv.dtype,
                                  device=uv.device)
    h, w = img_hw
    ok = (depth > 1e-5) & (uv[:, 0] >= 0) & (uv[:, 0] < w) & \
        (uv[:, 1] >= 0) & (uv[:, 1] < h)
    return uv, ok


@FUSION_LAYERS.register('PointFusion')
class PointFusion(nn.Module):
    """Points decorated with multi-level image features (reference
    point_fusion.py:306). Its output width is ``mid_channels``, or
    ``out_channels`` with ``fuse_out`` (``out_width``). ``align_corners``
    is read by neither package: both sample half-pixel centres."""

    def __init__(self, img_channels: int = 256, pts_channels: int = 64,
                 mid_channels: int = 128, out_channels: int = 128,
                 img_levels: Sequence[int] = (0, 1, 2, 3, 4),
                 align_corners: bool = False, activate_out: bool = True,
                 fuse_out: bool = False):
        super().__init__()
        del align_corners
        self.img_levels = tuple(img_levels)
        self.activate_out = activate_out
        self.fuse_out = fuse_out
        self.img_transform = nn.Sequential(
            Linear(img_channels * len(self.img_levels), mid_channels))
        self.pts_transform = nn.Sequential(Linear(pts_channels, mid_channels))
        if fuse_out:
            self.fuse_conv = nn.Sequential(Linear(mid_channels, out_channels))
        self.out_width = out_channels if fuse_out else mid_channels

    def forward(self, img_feats, points, pts_feats, lidar2img, img_hw):
        """One sample: img_feats a list of [V, C, h, w] maps, points [N,
        3], pts_feats [N, Cp], lidar2img [V, 4, 4] -> [N, out_width]."""
        v = img_feats[0].shape[0]
        proj = [project_points_to_image(points, lidar2img[vi], img_hw)
                for vi in range(v)]
        sampled = []
        for lvl in self.img_levels:
            feat = img_feats[lvl]
            acc = 0.0
            for vi, (uv, ok) in enumerate(proj):
                g = bilinear_sample(feat[vi], uv, img_hw)
                acc = acc + torch.where(ok[:, None], g, 0.0)
            sampled.append(acc)
        fused = self.img_transform(torch.cat(sampled, -1)) + \
            self.pts_transform(pts_feats)
        if self.activate_out:
            fused = torch.relu(fused)
        if self.fuse_out:
            fused = torch.relu(self.fuse_conv(fused))
        return fused
