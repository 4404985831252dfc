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

- ``VoteFusion`` (ImVoteNet's) lifts 2-D detections into per-seed vote
  cues on the device: the seeds go DEPTH -> CAM through
  ``core/box_modes.convert_points``' tensor path (the same matrices as
  its numpy one), pixel coordinates round half to even as ``jnp.round``,
  and the top seed-box pairs are taken by ``topk_lower_index`` (padded
  boxes score 0: ties, taken lower index first as ``jax.lax.top_k``).
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import torch
from torch import nn

from ..core import box_modes
from ..core.coders import topk_lower_index
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


@FUSION_LAYERS.register('VoteFusion')
class VoteFusion(nn.Module):
    """2-D detections lifted into per-seed image-vote cues (ImVoteNet;
    reference fusion_layers/vote_fusion.py:12-212, the JAX layer's
    redesign): each seed's projection is tested against every (padded,
    masked) 2-D box; the ``max_imvote_per_pixel`` seed-box pairs of
    highest in-box + confidence give a cue of 5 + ``num_classes``
    (the lifted image vote (2), the ray (3), the class confidence) and the
    3 texture values of the pixel under the seed. One sample; no
    parameters. An empty ``aug_state`` or ``img_meta`` is the identity
    and is not replayed (the replays would copy constants to the card)."""

    def __init__(self, num_classes: int = 10, max_imvote_per_pixel: int = 3):
        super().__init__()
        self.num_classes = num_classes
        self.max_imvote_per_pixel = max_imvote_per_pixel

    def forward(self, img, bboxes_2d, bbox_valid, seeds_3d, depth2img,
                img_hw, aug_state=None, img_meta=None):
        """img [H, W, 3] (0-255); bboxes_2d [nb, 6] (l, t, r, b, conf,
        cls); bbox_valid [nb]; seeds_3d [S, 3] in the DEPTH frame;
        depth2img [4, 4] or dict(K=[4, 4], Rt=[3, 3]) -> (cues [feat,
        K*S], mask [K*S]), vote-major (column k*S + s: seed s's k-th
        vote)."""
        eps = 1e-6
        s, nb = seeds_3d.shape[0], bboxes_2d.shape[0]
        kmax = self.max_imvote_per_pixel
        rt = depth2img.get('Rt') if isinstance(depth2img, dict) else None
        k_mat = depth2img['K'] if isinstance(depth2img, dict) else depth2img
        xyz_depth = (apply_3d_transformation(seeds_3d, aug_state, True)
                     if aug_state else seeds_3d)
        xyz_cam = box_modes.convert_points(xyz_depth, box_modes.DEPTH,
                                           box_modes.CAM, rt_mat=rt)
        hom = torch.cat([xyz_cam, xyz_cam.new_ones(s, 1)], -1)
        proj = hom @ k_mat.t()
        uv_origin = torch.round(
            proj[:, :2] / torch.clamp(proj[:, 2:3], min=eps) - 1)
        uv_rescaled = (coord_2d_transform(img_meta, uv_origin, True)
                       if img_meta else uv_origin)

        # seed-in-box tests on the original-frame boxes
        l, t, r, bo = (bboxes_2d[:, i] for i in range(4))
        conf = torch.where(bbox_valid, bboxes_2d[:, 4], 0.0)
        cls = bboxes_2d[:, 5].to(torch.int32)
        u, v = uv_origin[:, None, 0], uv_origin[:, None, 1]
        in_box = (u > l) & (u < r) & (v > t) & (v < bo) & bbox_valid[None]
        # one-hot as jax.nn.one_hot: a class outside the range gives zeros
        onehot = (cls[:, None] == torch.arange(
            self.num_classes, device=cls.device)).to(conf.dtype)
        sem_cue = (onehot * conf[:, None])[None].expand(s, nb, -1)

        # the geometric cue: the pixel offset to the box centre lifted to 3D
        z_cam = xyz_cam[:, 2:3]
        delta_u = ((l + r)[None] / 2 - uv_origin[:, 0:1]) * z_cam \
            / k_mat[0, 0]
        delta_v = ((t + bo)[None] / 2 - uv_origin[:, 1:2]) * z_cam \
            / k_mat[0, 0]
        imvote = torch.stack([delta_u, delta_v, torch.zeros_like(delta_u)],
                             -1).reshape(-1, 3)
        imvote = box_modes.convert_points(imvote, box_modes.CAM,
                                          box_modes.DEPTH, rt_mat=rt)
        if aug_state:
            imvote = apply_3d_transformation(imvote, aug_state, False)
        seed_exp = seeds_3d[:, None].expand(s, nb, 3).reshape(-1, 3)
        ray = seed_exp + imvote
        ray = ray / torch.sqrt((ray ** 2).sum(-1, keepdim=True) + eps)
        # columns 0 and 2 by a strided slice (a list index is copied to
        # the card, a synchronisation)
        xz = ray[:, ::2] / (ray[:, 1:2] + eps) * seed_exp[:, 1:2] \
            - seed_exp[:, ::2]
        geo_cue = torch.cat([xz, ray], -1).reshape(s, nb, 5)
        two_cues = torch.cat([geo_cue, sem_cue], -1) * \
            in_box[..., None].to(conf.dtype)
        feat_dim = 5 + self.num_classes

        # the top-k seed-box pairs by in-box + confidence
        pair_score = in_box.to(conf.dtype) + conf[None]
        if nb < kmax:
            pad = kmax - nb
            pair_score = torch.cat([pair_score, pair_score.new_zeros(
                s, pad)], 1)
            two_cues = torch.cat([two_cues, two_cues.new_zeros(
                s, pad, feat_dim)], 1)
        score, idx = topk_lower_index(pair_score, kmax)
        two_cues = torch.gather(two_cues, 1,
                                idx[..., None].expand(-1, -1, feat_dim))
        mask = torch.floor(score).to(torch.bool)              # [S, K]

        # the texture cue: the normalised pixel under each seed
        h, w = img_hw
        ui = torch.clamp(torch.round(uv_rescaled[:, 0]).to(torch.int64), 0,
                         w - 1)
        vi = torch.clamp(torch.round(uv_rescaled[:, 1]).to(torch.int64), 0,
                         h - 1)
        txt = (img[vi, ui].to(torch.float32) / 255.0)[:, None] \
            .expand(s, kmax, 3)
        cues = torch.cat([two_cues, txt], -1)                 # [S, K, 18]
        cues = cues.transpose(0, 1).reshape(kmax * s, feat_dim + 3).t()
        return cues, mask.t().reshape(-1)
