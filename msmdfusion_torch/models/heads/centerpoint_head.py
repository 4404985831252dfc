"""CenterPoint's multi-task centre-heatmap head.

Counterpart of the JAX package's ``models/heads/centerpoint_head.py``
(reference mmdet3d/models/dense_heads/centerpoint_head.py ``CenterHead``
and ``SeparateHead``): a shared conv, then per task group a branch per
output (heatmap, reg, height, dim, rot, vel). Channels-first; module names
are the reference's (``shared_conv``, ``task_heads.{t}.{name}.{i}``).

Targets draw each box's gaussian with ``core/gaussian.py``; the losses are
the gaussian focal loss over the heatmaps and an L1 loss at the boxes'
centre cells. ``get_bboxes`` decodes each task's top K cells
(``CenterPointBBoxCoder``, ties by the lower index) and, with
``nms_type='circle'``, keeps them through circle NMS.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import torch
from torch import nn

from ...core.gaussian import draw_heatmap, gaussian_radius
from ...core.nms import circle_nms
from ...registry import BBOX_CODERS, HEADS
from ..layers import Conv2d, ConvModule
from ..losses import clip_sigmoid, gaussian_focal_loss


class SeparateHead(nn.Module):
    """One conv stack per output: (num_conv - 1) conv-BN-ReLU of
    ``head_conv`` channels, then a 3x3 conv to the output's channels."""

    def __init__(self, in_channels: int, heads: Dict[str, Tuple[int, int]],
                 head_conv: int = 64, init_bias: float = -2.19):
        super().__init__()
        self.heads = dict(heads)
        for name, (classes, num_conv) in self.heads.items():
            layers, c = [], in_channels
            for _ in range(num_conv - 1):
                layers.append(ConvModule(c, head_conv, 3, padding=1,
                                         bias=True))
                c = head_conv
            layers.append(Conv2d(c, classes, 3, padding=1, bias=True))
            if name == 'heatmap':
                nn.init.constant_(layers[-1].bias, init_bias)
            self.add_module(name, nn.Sequential(*layers))

    def forward(self, x):
        return {name: getattr(self, name)(x) for name in self.heads}


@HEADS.register('CenterHead')
class CenterHead(nn.Module):

    def __init__(self, in_channels: int = 128, tasks: Sequence[Any] = (),
                 common_heads: Any = None, share_conv_channel: int = 64,
                 num_heatmap_convs: int = 2, bbox_coder: Any = None,
                 train_cfg: Any = None, test_cfg: Any = None,
                 norm_bbox: bool = True, max_objs: int = 500):
        super().__init__()
        self.class_names = [t['class_names'] for t in tasks]
        self.num_classes = [len(t['class_names']) for t in tasks]
        self.coder = BBOX_CODERS.build(dict(bbox_coder))
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg
        self.norm_bbox = norm_bbox
        self.shared_conv = ConvModule(in_channels, share_conv_channel, 3,
                                      padding=1, bias=True)
        heads = []
        for n in self.num_classes:
            h = dict(common_heads)
            h['heatmap'] = (n, num_heatmap_convs)
            heads.append(SeparateHead(share_conv_channel, h))
        self.task_heads = nn.ModuleList(heads)

    def forward(self, x, generator=None):
        """x [B, C, H, W] -> per task a dict of [B, ch, H, W]."""
        x = self.shared_conv(x)
        return [head(x) for head in self.task_heads]

    def loss(self, preds: List[Dict[str, torch.Tensor]], gt_bboxes,
             gt_labels, gt_valid) -> Dict[str, torch.Tensor]:
        """gt_bboxes [B, G, 9], gt_labels [B, G] (global class ids),
        gt_valid [B, G] -> per task 'task{t}.loss_heatmap' and
        'task{t}.loss_bbox'."""
        tc = self.train_cfg
        h, w = preds[0]['heatmap'].shape[2:4]
        vx = tc['voxel_size'][0] * tc['out_size_factor']
        vy = tc['voxel_size'][1] * tc['out_size_factor']
        x0, y0 = tc['point_cloud_range'][0], tc['point_cloud_range'][1]
        code_weights = gt_bboxes.new_tensor(tc['code_weights'])
        losses = {}
        base = 0
        for ti, num_cls in enumerate(self.num_classes):
            in_task = (gt_labels >= base) & (gt_labels < base + num_cls) & \
                gt_valid
            task_labels = torch.clamp(gt_labels - base, 0, num_cls - 1)
            width = gt_bboxes[..., 3] / vx
            length = gt_bboxes[..., 4] / vy
            radius = gaussian_radius((length, width), tc['gaussian_overlap'])
            radius = torch.clamp(radius.to(torch.int32),
                                 min=tc['min_radius']).to(torch.float32)
            ok = in_task & (gt_bboxes[..., 3] > 0) & (gt_bboxes[..., 4] > 0)
            cx = (gt_bboxes[..., 0] - x0) / vx
            cy = (gt_bboxes[..., 1] - y0) / vy
            cxi, cyi = cx.to(torch.int32), cy.to(torch.int32)
            ok = ok & (cxi >= 0) & (cxi < w) & (cyi >= 0) & (cyi < h)
            centers = torch.stack([cxi, cyi], -1)
            hm_tgt = torch.stack([
                draw_heatmap(centers[i], radius[i], task_labels[i], ok[i],
                             num_cls, (h, w))
                for i in range(gt_bboxes.shape[0])])

            p = preds[ti]
            pred_hm = clip_sigmoid(p['heatmap'])
            num_pos = torch.clamp((hm_tgt == 1.0).sum(), min=1)
            losses[f'task{ti}.loss_heatmap'] = gaussian_focal_loss(
                pred_hm, hm_tgt).sum() / num_pos

            dims = gt_bboxes[..., 3:6]
            if self.norm_bbox:
                dims = torch.log(torch.clamp(dims, min=1e-6))
            tgt = torch.cat([
                (cx - cxi)[..., None], (cy - cyi)[..., None],
                (gt_bboxes[..., 2] + gt_bboxes[..., 5] * 0.5)[..., None],
                dims, torch.sin(gt_bboxes[..., 6:7]),
                torch.cos(gt_bboxes[..., 6:7]), gt_bboxes[..., 7:9]], -1)
            pred_cat = torch.cat([p['reg'], p['height'], p['dim'], p['rot'],
                                  p['vel']], 1)
            b, c = pred_cat.shape[:2]
            flat_idx = (centers[..., 1] * w + centers[..., 0]).to(
                torch.int64).clamp(0, h * w - 1)          # masked where not ok
            pred_at = torch.gather(pred_cat.reshape(b, c, h * w), 2,
                                   flat_idx[:, None, :].expand(-1, c, -1)
                                   ).transpose(1, 2)       # [B, G, 10]
            l1 = (pred_at - tgt).abs() * code_weights
            l1 = torch.where(ok[..., None], l1, 0.0)
            losses[f'task{ti}.loss_bbox'] = l1.sum() / torch.clamp(
                ok.sum(), min=1)
            base += num_cls
        return losses

    def get_bboxes(self, preds: List[Dict[str, torch.Tensor]]):
        """Each task's top-K decode (and circle NMS), labels made global ->
        dict 'bboxes' [B, T*K, 9], 'scores', 'labels', 'valid' [B, T*K]."""
        tcfg = self.test_cfg
        outs = []
        base = 0
        for ti, num_cls in enumerate(self.num_classes):
            p = preds[ti]
            res = self.coder.decode(torch.sigmoid(p['heatmap']),
                                    p['rot'][:, 0:1], p['rot'][:, 1:2],
                                    p['height'], p['dim'], p['vel'],
                                    reg=p['reg'])
            if tcfg.get('nms_type') == 'circle':
                keep, order = circle_nms(
                    res['bboxes'][..., :2], res['scores'],
                    tcfg['min_radius'][ti], valid=res['valid'],
                    post_max_size=tcfg.get('post_max_size', 83))
                res['valid'] = res['valid'] & torch.zeros_like(
                    keep).scatter_(-1, order, keep)
            res['labels'] = res['labels'] + base
            outs.append(res)
            base += num_cls
        return {k: torch.cat([o[k] for o in outs], 1)
                for k in ('bboxes', 'scores', 'labels', 'valid')}
