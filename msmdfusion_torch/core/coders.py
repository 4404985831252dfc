"""TransFusion box coder (encode and decode).

Counterpart of ``TransFusionBBoxCoder`` in the JAX package's
``core/coders.py`` (reference
mmdet3d/core/bbox/coders/transfusion_bbox_coder.py:7-126). Batched and
mask-based: ``filter`` returns a validity mask instead of a gather.
"""
from __future__ import annotations

import torch

from ..registry import BBOX_CODERS


@BBOX_CODERS.register('TransFusionBBoxCoder')
class TransFusionBBoxCoder:
    """Grid-relative center / log-dim / sin-cos yaw / gravity-z coder."""

    def __init__(self, pc_range, out_size_factor, voxel_size,
                 post_center_range=None, score_threshold=None, code_size=8):
        self.pc_range = pc_range
        self.out_size_factor = out_size_factor
        self.voxel_size = voxel_size
        self.post_center_range = post_center_range
        self.score_threshold = score_threshold
        self.code_size = code_size

    def encode(self, dst_boxes):
        """[..., 7 or 9] bottom-centre boxes -> [..., code_size] targets:
        grid-relative centre, gravity-centre z, log dims, sin and cos of
        the yaw, and the velocity with code size 10."""
        tx = (dst_boxes[..., 0] - self.pc_range[0]) / (
            self.out_size_factor * self.voxel_size[0])
        ty = (dst_boxes[..., 1] - self.pc_range[1]) / (
            self.out_size_factor * self.voxel_size[1])
        tz = dst_boxes[..., 2] + dst_boxes[..., 5] * 0.5
        tdims = torch.log(torch.clamp(dst_boxes[..., 3:6], min=1e-12))
        parts = [tx[..., None], ty[..., None], tz[..., None], tdims,
                 torch.sin(dst_boxes[..., 6:7]), torch.cos(dst_boxes[..., 6:7])]
        if self.code_size == 10:
            parts.append(dst_boxes[..., 7:9])
        return torch.cat(parts, -1)

    def decode(self, heatmap, rot, dim, center, height, vel=None,
               filter: bool = False):
        """heatmap [B, C, P], rot [B, 2, P], dim [B, 3, P] (log), center
        [B, 2, P] (feature-map cells), height [B, 1, P], vel [B, 2, P] ->
        dict of 'bboxes' [B, P, 7|9], 'scores' [B, P], 'labels' [B, P] and,
        with ``filter``, 'valid' [B, P]."""
        final_preds = torch.argmax(heatmap, dim=1)   # first max on ties
        final_scores = torch.amax(heatmap, dim=1)
        cx = center[:, 0, :] * self.out_size_factor * self.voxel_size[0] + \
            self.pc_range[0]
        cy = center[:, 1, :] * self.out_size_factor * self.voxel_size[1] + \
            self.pc_range[1]
        dims = torch.exp(dim)
        z_bottom = height[:, 0, :] - dims[:, 2, :] * 0.5
        yaw = torch.atan2(rot[:, 0, :], rot[:, 1, :])
        parts = [cx[..., None], cy[..., None], z_bottom[..., None],
                 dims.transpose(1, 2), yaw[..., None]]
        if vel is not None:
            parts.append(vel.transpose(1, 2))
        boxes = torch.cat(parts, dim=-1)
        out = {'bboxes': boxes, 'scores': final_scores, 'labels': final_preds}
        if filter:
            pcr = torch.tensor(self.post_center_range, dtype=boxes.dtype,
                               device=boxes.device)
            mask = (boxes[..., :3] >= pcr[:3]).all(dim=-1)
            mask &= (boxes[..., :3] <= pcr[3:]).all(dim=-1)
            if self.score_threshold is not None and self.score_threshold > 0:
                mask &= final_scores > self.score_threshold
            out['valid'] = mask
        return out
