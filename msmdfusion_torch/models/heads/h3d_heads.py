"""H3DNet's primitive heads and proposal refinement.

Counterpart of the JAX package's ``models/heads/h3d_heads.py`` (reference
mmdet3d/models/dense_heads/primitive_head.py:967 and
mmdet3d/models/roi_heads/bbox_heads/h3d_bbox_head.py:932):

- ``box_primitives``: a box's primitive centres, 'z' its 2 horizontal
  face centres, 'xy' its 4 vertical ones, 'line' its 12 edge midpoints,
  all turned by the yaw;
- ``PrimitiveHead`` (``primitive_mode`` 'z', 'xy' or 'line'): per seed a
  flag (on a primitive of an object?), a vote to the primitive's centre
  and a feature residual; losses against the nearest GT primitive;
- ``H3DBboxHead``: around each proposal's expected primitive locations
  the predicted primitive centres within ``radius`` (ball query), their
  flag-weighted features averaged, then box residuals and an objectness
  rescore.

The JAX heads' linear stacks (no norms) keep their JAX names
(``flag_mlp``, ``flag_out``, ``vote_mlp``, ``vote_out``, ``feat_res``;
``refine_mlp``, ``refine_out``). ``feat_channels`` is the width of the
seed features they read (the backbone's; flax infers it).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from ...ops import sampling
from ...registry import HEADS
from ..layers import MLP, Linear
from ..losses import cross_entropy, smooth_l1_loss
from .vote_head import gravity_centers, nearest_gt, take_rows

PRIMITIVE_COUNTS = {'z': 2, 'xy': 4, 'line': 12}


def box_primitives(boxes, kind: str):
    """Primitive centres of [..., 7+] boxes -> [..., P, 3]."""
    ctr = gravity_centers(boxes)
    w, l, h = boxes[..., 3], boxes[..., 4], boxes[..., 5]
    zeros = torch.zeros_like(w)
    if kind == 'z':
        loc = [(zeros, zeros, h / 2), (zeros, zeros, -h / 2)]
    elif kind == 'xy':
        loc = [(w / 2, zeros, zeros), (-w / 2, zeros, zeros),
               (zeros, l / 2, zeros), (zeros, -l / 2, zeros)]
    else:                               # 'line': the 12 edge midpoints
        loc = [(sx * w, sy * l, zeros) for sx in (-0.5, 0.5)
               for sy in (-0.5, 0.5)]
        loc += [(sx * w, zeros, sz * h) for sx in (-0.5, 0.5)
                for sz in (-0.5, 0.5)]
        loc += [(zeros, sy * l, sz * h) for sy in (-0.5, 0.5)
                for sz in (-0.5, 0.5)]
    loc = torch.stack([torch.stack(p, -1) for p in loc], -2)
    c = torch.cos(boxes[..., 6])[..., None]
    s = torch.sin(boxes[..., 6])[..., None]
    rot = torch.stack([loc[..., 0] * c - loc[..., 1] * s,
                       loc[..., 0] * s + loc[..., 1] * c, loc[..., 2]], -1)
    return ctr[..., None, :] + rot


@HEADS.register('PrimitiveHead')
class PrimitiveHead(nn.Module):

    def __init__(self, primitive_mode: str = 'z', in_channels: int = 256,
                 feat_channels: Optional[int] = None, train_cfg: Any = None,
                 **unused):
        super().__init__()
        del unused
        c, f = in_channels, feat_channels or in_channels
        self.primitive_mode = primitive_mode
        self.flag_mlp = MLP(f, (c, c), final_act=True)
        self.flag_out = Linear(c, 2)
        self.vote_mlp = MLP(f, (c,), final_act=True)
        self.vote_out = Linear(c, 3)
        self.feat_res = Linear(c, f)

    def forward(self, feat_dict: Dict[str, torch.Tensor]):
        feats, xyz = feat_dict['fp_features'], feat_dict['fp_xyz']
        valid = feat_dict['fp_valid']
        k = self.primitive_mode
        v = self.vote_mlp(feats)
        centers = xyz + torch.where(valid[..., None], self.vote_out(v), 0.0)
        return {f'{k}_flag': self.flag_out(self.flag_mlp(feats)),
                f'{k}_centers': centers,
                f'{k}_features': feats + self.feat_res(v),
                f'{k}_valid': valid, f'{k}_xyz': xyz}

    def loss(self, preds, gt_bboxes, gt_valid, near_thr: float = 0.3):
        k = self.primitive_mode
        xyz, valid = preds[f'{k}_xyz'], preds[f'{k}_valid']
        prim = box_primitives(gt_bboxes, k)               # [B, G, P, 3]
        b, g, p, _ = prim.shape
        prim = prim.reshape(b, g * p, 3)
        nearest, nearest_d = nearest_gt(
            xyz, prim, torch.repeat_interleave(gt_valid, p, 1))
        on_prim = (nearest_d < near_thr) & valid
        flag_loss = cross_entropy(preds[f'{k}_flag'].reshape(-1, 2),
                                  on_prim.reshape(-1).to(torch.int64), 2)
        flag_loss = torch.where(valid.reshape(-1), flag_loss, 0.0).sum() / \
            torch.clamp(valid.sum(), min=1)
        center_loss = smooth_l1_loss(preds[f'{k}_centers'],
                                     take_rows(prim, nearest)).sum(-1)
        center_loss = torch.where(on_prim, center_loss, 0.0).sum() / \
            torch.clamp(on_prim.sum(), min=1)
        return {f'{k}_flag_loss': flag_loss, f'{k}_center_loss': center_loss}


@HEADS.register('H3DBboxHead')
class H3DBboxHead(nn.Module):

    def __init__(self, num_proposals: int = 256, in_channels: int = 256,
                 num_classes: int = 18, radius: float = 0.3,
                 num_samples: int = 8, feat_channels: Optional[int] = None,
                 train_cfg: Any = None, **unused):
        super().__init__()
        del unused
        c, f = in_channels, feat_channels or in_channels
        self.radius, self.num_samples = radius, num_samples
        self.refine_mlp = MLP(3 * f, (c, c), final_act=True)
        self.refine_out = Linear(c, 2 + 7)

    def forward(self, proposals: Dict[str, torch.Tensor],
                primitives: Dict[str, torch.Tensor]):
        """proposals: the VoteHead's decode ('bboxes' [B, P, 7], 'valid');
        primitives: the three PrimitiveHeads' outputs merged."""
        boxes = proposals['bboxes']
        b, p = boxes.shape[:2]
        gathered = []
        for kind in ('z', 'xy', 'line'):
            expected = box_primitives(boxes, kind)          # [B, P, Pk, 3]
            pk = expected.shape[2]
            flag = torch.softmax(primitives[f'{kind}_flag'], -1)[..., 1]
            feats = primitives[f'{kind}_features'] * flag[..., None]
            idx = sampling.ball_query(
                self.radius, self.num_samples, primitives[f'{kind}_centers'],
                expected.reshape(b, p * pk, 3),
                xyz_valid=primitives[f'{kind}_valid'])      # [B, P*Pk, S]
            member = (idx >= 0)[..., None]
            grouped = sampling.group_points(feats, idx)
            mean = torch.where(member, grouped, 0.0).sum(2) / \
                torch.clamp(member.sum(2), min=1)
            gathered.append(mean.reshape(b, p, pk, -1).mean(2))
        out = self.refine_out(self.refine_mlp(torch.cat(gathered, -1)))
        return {'refine_obj': out[..., :2], 'refine_delta': out[..., 2:9],
                'refined_bboxes': boxes + 0.1 * out[..., 2:9],
                'refine_valid': proposals['valid']}

    def loss(self, preds, gt_bboxes, gt_labels, gt_valid):
        boxes, valid = preds['refined_bboxes'], preds['refine_valid']
        nearest, nd = nearest_gt(gravity_centers(boxes),
                                 gravity_centers(gt_bboxes), gt_valid)
        pos = (nd < 0.3) & valid
        neg = (nd > 0.6) & valid
        w = (pos | neg).to(boxes.dtype)
        obj_loss = cross_entropy(preds['refine_obj'].reshape(-1, 2),
                                 pos.reshape(-1).to(torch.int64), 2)
        obj_loss = (obj_loss * w.reshape(-1)).sum() / \
            torch.clamp(w.sum(), min=1)
        reg_loss = smooth_l1_loss(
            boxes, take_rows(gt_bboxes[..., :7], nearest)).sum(-1)
        reg_loss = torch.where(pos, reg_loss, 0.0).sum() / \
            torch.clamp(pos.sum(), min=1)
        return {'refine_obj_loss': obj_loss, 'refine_reg_loss': reg_loss}
