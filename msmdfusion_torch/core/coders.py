"""Box coders.

Counterpart of the JAX package's ``core/coders.py``:
``TransFusionBBoxCoder`` (reference
mmdet3d/core/bbox/coders/transfusion_bbox_coder.py:7-126),
``DeltaXYZWLHRBBoxCoder`` (delta_xyzwhlr_bbox_coder.py, the anchor heads'
residuals) and ``CenterPointBBoxCoder`` (centerpoint_bbox_coders.py, the
top-K heatmap decode). Batched and mask-based: ``filter`` returns a
validity mask instead of a gather.
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


@BBOX_CODERS.register('DeltaXYZWLHRBBoxCoder')
class DeltaXYZWLHRBBoxCoder:
    """Residuals of boxes against anchors: the centre over the anchor's
    diagonal (z at gravity centre over its height), log size ratios, the
    yaw difference, extra columns (velocity) as differences."""

    def __init__(self, code_size=7):
        self.code_size = code_size

    def encode(self, src_boxes, dst_boxes):
        """anchors ``src_boxes`` [..., 7+], ground truth ``dst_boxes``
        [..., 7+] -> targets [..., 7+]."""
        xa, ya, za, wa, la, ha, ra = src_boxes[..., :7].split(1, -1)
        xg, yg, zg, wg, lg, hg, rg = dst_boxes[..., :7].split(1, -1)
        za = za + ha / 2
        zg = zg + hg / 2
        diag = torch.sqrt(la ** 2 + wa ** 2)
        parts = [(xg - xa) / diag, (yg - ya) / diag, (zg - za) / ha,
                 torch.log(wg / wa), torch.log(lg / la), torch.log(hg / ha),
                 rg - ra]
        if src_boxes.shape[-1] > 7:
            parts.append(dst_boxes[..., 7:] - src_boxes[..., 7:])
        return torch.cat(parts, -1)

    def decode(self, anchors, deltas):
        xa, ya, za, wa, la, ha, ra = anchors[..., :7].split(1, -1)
        xt, yt, zt, wt, lt, ht, rt = deltas[..., :7].split(1, -1)
        za = za + ha / 2
        diag = torch.sqrt(la ** 2 + wa ** 2)
        hg = torch.exp(ht) * ha
        parts = [xt * diag + xa, yt * diag + ya, zt * ha + za - hg / 2,
                 torch.exp(wt) * wa, torch.exp(lt) * la, hg, rt + ra]
        if anchors.shape[-1] > 7:
            parts.append(deltas[..., 7:] + anchors[..., 7:])
        return torch.cat(parts, -1)


def topk_lower_index(x, k: int):
    """(values, indices) of the top ``k`` along the last axis, ties broken
    by the lower index first, as ``jax.lax.top_k`` orders them
    (``torch.topk`` promises no order among ties). ``torch.topk`` gives the
    k-th value; every larger element and the first ties up to k are taken
    (their places by a running count: one spare column takes the rest),
    then ordered by value with a stable sort."""
    m = x.shape[-1]
    if k >= m:
        v, i = torch.sort(x, dim=-1, descending=True, stable=True)
        return v[..., :k], i[..., :k]
    kth = torch.topk(x, k, dim=-1).values[..., -1:]
    above = x > kth
    tie = x == kth
    need = k - above.sum(-1, keepdim=True)
    take = above | (tie & (torch.cumsum(tie, -1) <= need))
    place = torch.where(take, torch.cumsum(take, -1) - 1, k)
    index = torch.zeros(x.shape[:-1] + (k + 1,), dtype=torch.int64,
                        device=x.device)
    index.scatter_(-1, place, torch.arange(m, device=x.device).expand_as(x))
    index = index[..., :k]
    values = torch.gather(x, -1, index)
    values, order = torch.sort(values, dim=-1, descending=True, stable=True)
    return values, torch.gather(index, -1, order)


@BBOX_CODERS.register('CenterPointBBoxCoder')
class CenterPointBBoxCoder:
    """Top-K heatmap decoder for ``CenterHead``."""

    def __init__(self, pc_range, out_size_factor, voxel_size,
                 post_center_range=None, max_num=100, score_threshold=None,
                 code_size=9):
        self.pc_range = pc_range
        self.out_size_factor = out_size_factor
        self.voxel_size = voxel_size
        self.post_center_range = post_center_range
        self.max_num = max_num
        self.score_threshold = score_threshold
        self.code_size = code_size

    def decode(self, heat, rot_sine, rot_cosine, hei, dim, vel, reg=None):
        """heat [B, C, H, W] (sigmoid), rot_sine/rot_cosine/hei [B, 1, H,
        W], dim [B, 3, H, W] (log), vel [B, 2, H, W] or None, reg [B, 2, H,
        W] (sub-cell offsets) -> dict 'bboxes' [B, K, 7|9], 'scores',
        'labels', 'valid' [B, K] of the top K = ``max_num`` cells over all
        classes (ties by the lower flat index)."""
        b, num_classes, h, w = heat.shape
        scores, inds = topk_lower_index(heat.reshape(b, -1), self.max_num)
        labels = torch.div(inds, h * w, rounding_mode='floor')
        spatial = inds % (h * w)
        ys = torch.div(spatial, w, rounding_mode='floor').to(torch.float32)
        xs = (spatial % w).to(torch.float32)

        def gather_channels(feat):
            f = feat.reshape(b, feat.shape[1], h * w)
            return torch.gather(f, 2, spatial[:, None, :].expand(
                -1, feat.shape[1], -1))

        if reg is not None:
            off = gather_channels(reg)
            xs = xs + off[:, 0]
            ys = ys + off[:, 1]
        else:
            xs = xs + 0.5
            ys = ys + 0.5
        yaw = torch.atan2(gather_channels(rot_sine)[:, 0],
                          gather_channels(rot_cosine)[:, 0])
        z = gather_channels(hei)[:, 0]
        dims = torch.exp(gather_channels(dim))
        x_world = xs * self.out_size_factor * self.voxel_size[0] + \
            self.pc_range[0]
        y_world = ys * self.out_size_factor * self.voxel_size[1] + \
            self.pc_range[1]
        parts = [x_world[..., None], y_world[..., None],
                 (z - dims[:, 2] * 0.5)[..., None], dims.transpose(1, 2),
                 yaw[..., None]]
        if vel is not None:
            parts.append(gather_channels(vel).transpose(1, 2))
        boxes = torch.cat(parts, -1)
        valid = torch.ones_like(scores, dtype=torch.bool)
        if self.score_threshold is not None:
            valid &= scores > self.score_threshold
        if self.post_center_range is not None:
            pcr = torch.tensor(self.post_center_range, dtype=boxes.dtype,
                               device=boxes.device)
            valid &= (boxes[..., :3] >= pcr[:3]).all(-1)
            valid &= (boxes[..., :3] <= pcr[3:]).all(-1)
        return {'bboxes': boxes, 'scores': scores, 'labels': labels,
                'valid': valid}
