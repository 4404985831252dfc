"""MSMDFusion: LiDAR + camera detector, inference and training.

Counterpart of the JAX package's ``models/detectors/msmdfusion.py``
(reference mmdet3d/models/detectors/MSMDFusion.py, ``MSMDFusionDetector``):

- ``extract_img_feat``: ResNet + FPN over the [B*V] camera images;
- ``depth_aware_compression``: a sparse depth canvas of the real
  foreground pixels, resized to the first three FPN levels and compressed
  with the feature map to 49 channels;
- ``get_foreground2d``: the compressed feature under each foreground
  (virtual or real) pixel, weighted by ``score_net``, appended to its point;
- ``fetch_2d_voxels``: those decorated points voxelized at four scales;
- the LiDAR encoder, the GMA encoder over its stages and the 2D voxels,
  SPP fusion of the two BEV maps, SECOND, SECONDFPN and the TransFusion
  head.

In training mode (``model.train()``) every norm but the image branch's
takes the batch's moments, the strided sparse convs build their transpose
plans for the backward, and ``loss`` gives the head's losses. With
``freeze_img`` (the reference's stage-2 recipe) the image branch stays in
eval mode and runs under ``torch.no_grad()``, the port's form of the JAX
package's ``stop_gradient``: no gradient reaches it and its norm
statistics never move. Without it the image branch trains: its convs take
gradients and its norms stay on their running statistics (the ResNet's
``norm_eval``; FPN has none).

``compute_dtype='bfloat16'`` (the JAX package's ``MSMD_BF16``) casts the images (JAX ``:115-116``) and the LiDAR voxel features
(``:214-215``) to bf16; every layer after them computes in the dtype the
JAX layer produces (``layers.py``'s flax rule: a bf16 input meets fp32
parameters in fp32, so with fp32 parameters only the sparse encoder and
the GMA's grouped 3D convs run bf16; with parameters cast by
``layers.cast_params``, as the JAX bench casts them, the image branch and
the GMA gates too, while the depth canvas, the 2D voxels and everything
from the GMA union on stay fp32), and the decode runs in fp32. It trains
with fp32 parameters, as the JAX bench's train step does (``bench.py:
258-300``): bf16 activations and their gradients through the sparse
encoder and the grouped convs, fp32 gradients for every parameter.
Training with parameters cast by ``cast_params`` raises: no JAX entry
point trains them (ROADMAP).

Dense maps are channels-first (NCHW); the sparse tensors and the
foreground arrays keep the JAX package's layouts. Module names are the
reference checkpoint's (``img_backbone``, ``img_neck``, ``conv1x1_blocks``,
``score_net``, ``bev_fusion``, ``pts_middle_encoder``,
``multimodal_middle_encoder``, ``pts_backbone``, ``pts_neck``,
``pts_bbox_head``).
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.sparse.tensor import make_sparse_tensor, to_dense_bev
from ...ops.voxelize import voxelize_mean_batch
from ...registry import (BACKBONES, DETECTORS, HEADS, MIDDLE_ENCODERS,
                         NECKS)
from ...utils.timing import section
from ..layers import MLP, BatchNorm2d, Conv2d, cudnn_enabled
from ..sparse_blocks import SparseConv3d


def conv_bn_relu(cin: int, cout: int, k: int, padding: int = 0,
                 dilation: int = 1) -> nn.Sequential:
    """Conv2d (no bias) + BatchNorm2d (eps 1e-3) + ReLU as ``.0``/``.1``."""
    return nn.Sequential(
        Conv2d(cin, cout, k, padding=padding, dilation=dilation,
               bias=False),
        BatchNorm2d(cout, eps=1e-3, momentum=0.01), nn.ReLU())


class SPPModule(nn.Module):
    """ASPP-style BEV fusion (reference MSMDFusion.py SPPModule): 1 x 1,
    3 x 3 and 3 x 3 dilated 6 and 12 branches, concatenated and fused by a
    1 x 1 conv. The JAX ConvModule multiplies an int padding by the
    dilation, so its ``padding=1, dilation=d`` pads by d here."""

    def __init__(self, in_channels: int, out_channels: int = 256):
        super().__init__()
        self.conv1x1 = conv_bn_relu(in_channels, out_channels, 1)
        self.conv3x3 = conv_bn_relu(in_channels, out_channels, 3, 1)
        self.dilated_conv3x3_rate6 = conv_bn_relu(in_channels, out_channels,
                                                  3, 6, 6)
        self.dilated_conv3x3_rate12 = conv_bn_relu(in_channels,
                                                   out_channels, 3, 12, 12)
        self.fuse = conv_bn_relu(4 * out_channels, out_channels, 1)

    def forward(self, x):
        branches = [self.conv1x1(x), self.conv3x3(x)]
        # the dilated convs off cuDNN: see layers.cudnn_enabled
        with cudnn_enabled(False):
            branches += [self.dilated_conv3x3_rate6(x),
                         self.dilated_conv3x3_rate12(x)]
        return self.fuse(torch.cat(branches, 1))


def depth_canvas(fg_real_pixels, fg_real_mask, h: int, w: int):
    """[B*V, 1, h, w] sparse depth image of the real foreground pixels.

    Pixel coordinates truncate towards zero. Where several pixels land on
    one cell the last in row-major (b, v, mr) order wins, as XLA's serial
    scatter does; it is computed deterministically as the largest source
    position per cell, then a gather.
    """
    b, v, mr = fg_real_pixels.shape[:3]
    u = fg_real_pixels[..., 0].to(torch.int32)
    vv = fg_real_pixels[..., 1].to(torch.int32)
    ok = fg_real_mask & (u >= 0) & (u < w) & (vv >= 0) & (vv < h)
    cam = torch.arange(b * v, device=u.device).reshape(b, v, 1)
    flat = (cam * h + vv) * w + u
    cells = b * v * h * w
    flat = torch.where(ok, flat, cells).reshape(-1)
    src = torch.arange(flat.shape[0], device=u.device)
    winner = torch.full((cells + 1,), -1, dtype=torch.int64, device=u.device)
    winner.scatter_reduce_(0, flat, src, 'amax')
    winner = winner[:cells]
    depth = fg_real_pixels[..., 2].reshape(-1)
    canvas = torch.where(winner >= 0, depth[torch.clamp(winner, min=0)], 0.0)
    return canvas.reshape(b * v, 1, h, w)


COMPUTE_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


@DETECTORS.register('MSMDFusionDetector')
class MSMDFusionDetector(nn.Module):

    def __init__(self, img_backbone: Any, img_neck: Any,
                 pts_voxel_layer: Any, pts_voxel_encoder: Any,
                 pts_middle_encoder: Any, multimodal_middle_encoder: Any,
                 pts_backbone: Any, pts_neck: Any, pts_bbox_head: Any,
                 spatial_shapes: Sequence[Sequence[int]] = (
                     (41, 1440, 1440), (21, 720, 720), (11, 360, 360),
                     (5, 180, 180)),
                 downscale_factors: Sequence[int] = (1, 2, 4, 8),
                 fps_num_list: Sequence[int] = (2048,) * 4,
                 radius_list: Sequence[float] = (6, 3, 2, 1),
                 max_cluster_samples_list: Sequence[int] = (200, 100, 50, 25),
                 dist_thresh_list: Sequence[float] = (13.3, 6.6, 3.3, 1.6),
                 fg_max_voxels: Sequence[int] = (40000, 30000, 20000, 10000),
                 freeze_img: bool = True, compute_dtype: str = 'float32',
                 train_cfg: Any = None, test_cfg: Any = None):
        super().__init__()
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f'compute_dtype {compute_dtype!r}: expected one '
                             f'of {sorted(COMPUTE_DTYPES)}')
        self.compute_dtype = COMPUTE_DTYPES[compute_dtype]
        if pts_voxel_encoder['type'] != 'HardSimpleVFE':
            raise NotImplementedError(
                f"voxel encoder {pts_voxel_encoder['type']}: only the fused "
                'HardSimpleVFE path is ported')
        self.freeze_img = freeze_img
        self.spatial_shapes = [tuple(s) for s in spatial_shapes]
        self.downscale_factors = list(downscale_factors)
        self.fps_num_list = list(fps_num_list)
        self.radius_list = list(radius_list)
        self.max_cluster_samples_list = list(max_cluster_samples_list)
        self.dist_thresh_list = list(dist_thresh_list)
        self.fg_max_voxels = list(fg_max_voxels)
        self.pts_voxel_layer = dict(pts_voxel_layer)

        self.img_backbone = BACKBONES.build(dict(img_backbone))
        self.img_neck = NECKS.build(dict(img_neck))
        self.pts_middle_encoder = MIDDLE_ENCODERS.build(
            dict(pts_middle_encoder))
        self.multimodal_middle_encoder = MIDDLE_ENCODERS.build(
            dict(multimodal_middle_encoder))
        # SECOND reads SPP's 256-channel output (the JAX modules take their
        # input widths from the data, so a config's in_channels is not read)
        self.pts_backbone = BACKBONES.build(dict(pts_backbone,
                                                 in_channels=256))
        self.pts_neck = NECKS.build(dict(pts_neck))
        head_cfg = dict(pts_bbox_head)
        head_cfg['test_cfg'] = dict(test_cfg['pts'])
        head_cfg['train_cfg'] = dict(train_cfg['pts']) if train_cfg else None
        self.pts_bbox_head = HEADS.build(head_cfg)

        c_img = img_neck['out_channels']
        # depth-aware channel compression: 5x5, 5x5, 3x3 -> 49 channels
        self.conv1x1_blocks = nn.ModuleList(
            conv_bn_relu(c_img + 1, 49, k, k // 2) for k in (5, 5, 3))
        # score_net: Linear(49 feature + 1 depth + 16 lidar2img -> 1) + ReLU
        self.score_net = MLP(49 + 1 + 16, (1,), final_act=True)
        self.bev_fusion = SPPModule(self._bev_channels(), 256)

    def train(self, mode: bool = True):
        """Set the training mode; a frozen image branch stays in eval."""
        super().train(mode)
        if mode and self.freeze_img:
            self.img_backbone.eval()
            self.img_neck.eval()
        return self

    def _bev_channels(self) -> int:
        """Channels of the two BEV maps SPP fuses: each sparse map's width
        times the z extent its strided convs leave."""
        def depth(z, convs):
            for conv in convs:
                z = (z + 2 * conv.padding[0] - conv.kernel_size[0]) \
                    // conv.stride[0] + 1
            return z
        enc = self.pts_middle_encoder
        enc_convs = [m for m in enc.modules() if isinstance(m, SparseConv3d)]
        last = list(self.multimodal_middle_encoder.downscale_blocks.values()
                    )[-1][0]
        return (enc_convs[-1].weight.shape[0]
                * depth(enc.sparse_shape[0], enc_convs)
                + last.weight.shape[0]
                * depth(self.spatial_shapes[-1][0], [last]))

    # ------------------------------------------------------------------
    def extract_img_feat(self, img):
        """img [B, V, H, W, 3] -> FPN levels, each [B*V, 256, h, w]."""
        b, v, h, w, _ = img.shape
        flat = img.reshape(b * v, h, w, 3).permute(0, 3, 1, 2).contiguous()
        return self.img_neck(self.img_backbone(flat.to(self.compute_dtype)))

    def depth_aware_compression(self, img_feats, fg_real_pixels,
                                fg_real_mask, input_hw):
        """The first three FPN levels with the depth canvas appended,
        compressed to 49 channels."""
        canvas = depth_canvas(fg_real_pixels, fg_real_mask, *input_hw)
        out = []
        for i in range(3):
            feat = img_feats[i]
            # jax.image.resize('bilinear') antialiases when it downsamples
            sp = F.interpolate(canvas, size=tuple(feat.shape[-2:]),
                               mode='bilinear', antialias=True,
                               align_corners=False)
            out.append(self.conv1x1_blocks[i](torch.cat([feat, sp], 1)))
        return out

    def get_foreground2d(self, feat, fg_pixels, fg_points, fg_mask,
                         lidar2img, input_hw):
        """feat [B*V, 49, h, w]; fg_pixels [B, V, M, 3] (u, v, depth);
        fg_points [B, V, M, Dp]; lidar2img [B, V, 4, 4] -> decorated
        points [B, V*M, Dp + 49] and their mask [B, V*M]."""
        b, v, m = fg_pixels.shape[:3]
        c, fh, fw = feat.shape[1:]
        scale = fw / input_hw[1]
        u = (fg_pixels[..., 0] * scale).to(torch.int32)
        vv = (fg_pixels[..., 1] * scale).to(torch.int32)
        ok = fg_mask & (u >= 0) & (u < fw) & (vv >= 0) & (vv < fh)
        cell = torch.clamp(vv, 0, fh - 1) * fw + torch.clamp(u, 0, fw - 1)
        gathered = torch.gather(
            feat.reshape(b, v, c, fh * fw), 3,
            cell.to(torch.int64)[:, :, None, :].expand(b, v, c, m))
        gathered = torch.where(ok[..., None], gathered.transpose(2, 3), 0.0)
        trans = lidar2img.reshape(b, v, 1, 16).expand(b, v, m, 16)
        score = self.score_net(
            torch.cat([gathered, fg_pixels[..., 2:3], trans], -1))
        pcd = torch.cat([fg_points, gathered * score], -1)
        return pcd.reshape(b, v * m, -1), ok.reshape(b, v * m)

    def fetch_2d_voxels(self, pcd, mask, scale_idx: int):
        """Decorated foreground points voxelized at scale ``scale_idx``
        (voxel size times its downscale factor), xyz over (13.5, 13.5, 2)."""
        vl = self.pts_voxel_layer
        factor = self.downscale_factors[scale_idx]
        voxel_size = [s * factor for s in vl['voxel_size']]
        feats, coors, valid = voxelize_mean_batch(
            pcd, mask, voxel_size, vl['point_cloud_range'],
            self.fg_max_voxels[scale_idx] * pcd.shape[0])
        norm = feats.new_tensor([13.5, 13.5, 2.0])
        feats = torch.cat([feats[:, :3] / norm, feats[:, 3:]], 1)
        return make_sparse_tensor(feats, coors, valid,
                                  self.spatial_shapes[scale_idx],
                                  pcd.shape[0], assume_sorted=True)

    def extract_pts_feat(self, points, points_mask, img_feats, fg,
                         input_hw):
        vl = self.pts_voxel_layer
        max_voxels = vl['max_voxels']
        if isinstance(max_voxels, (tuple, list)):
            # the train-time capacity, else the test-time one
            max_voxels = max_voxels[0 if self.training else 1]
        batch_size = points.shape[0]
        with section('voxelize'):
            voxel_features, coors, valid = voxelize_mean_batch(
                points, points_mask, vl['voxel_size'],
                vl['point_cloud_range'], max_voxels * batch_size)
        x, encode_features, enc_cache = self.pts_middle_encoder(
            voxel_features.to(self.compute_dtype), coors, valid, batch_size,
            assume_sorted=True, return_cache=True)
        shared_plans = [enc_cache.get(('subm', f'subm{i + 1}'))
                        for i in range(4)]

        with section('mdu'):
            comp = self.depth_aware_compression(
                img_feats, fg['fg_real_pixels'], fg['fg_real_mask'],
                input_hw)
            feat_list = [comp[0], comp[0], comp[1], comp[2]]
            voxel_2d_list = []
            for i in range(4):
                pcd, mask = self.get_foreground2d(
                    feat_list[i], fg['fg_pixels'], fg['fg_points'],
                    fg['fg_mask'], fg['lidar2img'], input_hw)
                voxel_2d_list.append(self.fetch_2d_voxels(pcd, mask, i))

        with section('gma'):
            stage_outs = self.multimodal_middle_encoder(
                encode_features[:4], voxel_2d_list, self.fps_num_list,
                self.radius_list, self.max_cluster_samples_list,
                self.dist_thresh_list, shared_plans=shared_plans)
            x_mm = to_dense_bev(stage_outs[-1]).permute(0, 3, 1, 2)
        with section('spp'):
            x = self.bev_fusion(torch.cat([x, x_mm], 1))
        with section('bev'):
            return self.pts_neck(self.pts_backbone(x))

    def forward(self, points, points_mask, img, fg: Dict[str, Any],
                generator=None):
        """points [B, N, 5], points_mask [B, N], img [B, V, H, W, 3] and
        the foreground dict (fg_pixels [B, V, M, 3], fg_points [B, V, M,
        15], fg_mask [B, V, M], fg_real_pixels [B, V, Mr, 3], fg_real_mask
        [B, V, Mr], lidar2img [B, V, 4, 4]; pixels in input-image scale)
        -> head predictions. ``generator``: the ``torch.Generator`` the
        head's dropout draws from in training mode."""
        if self.training and any(p.dtype != torch.float32
                                 for p in self.parameters()):
            raise NotImplementedError(
                'training with parameters cast below fp32 is not ported: '
                'no JAX entry point trains them (ROADMAP, queue 1)')
        input_hw = (img.shape[2], img.shape[3])
        with section('img'), torch.set_grad_enabled(
                torch.is_grad_enabled() and not self.freeze_img):
            img_feats = self.extract_img_feat(img)
        feats = self.extract_pts_feat(points, points_mask, img_feats, fg,
                                      input_hw)
        with section('head'):
            return self.pts_bbox_head(feats[0], generator=generator)

    def loss(self, preds, gt_bboxes, gt_labels, gt_valid, targets=None):
        """The head's losses (``TransFusionHead.loss``)."""
        with section('loss'):
            return self.pts_bbox_head.loss(preds, gt_bboxes, gt_labels,
                                           gt_valid, targets=targets)

    def get_bboxes(self, preds):
        with section('decode'):
            return self.pts_bbox_head.get_bboxes(preds)

