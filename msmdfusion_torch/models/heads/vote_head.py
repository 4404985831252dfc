"""VoteNet head (deep Hough voting for indoor detection).

Counterpart of the JAX package's ``models/heads/vote_head.py`` (reference
mmdet3d/models/dense_heads/vote_head.py:666): a vote MLP moves each seed
and its features, a set-abstraction module aggregates the votes around
FPS-sampled proposals, and one linear layer predicts objectness, the
centre offset, direction bin and residual, size class and residuals and
the semantic class. The losses assign each proposal (and each seed's
vote) the closest ground-truth centre; ``get_bboxes`` decodes every
proposal and marks the valid ones: no NMS, as the JAX head's decode
(the config's ``nms_thr`` is not read).

The JAX head (flax) takes its width from its input: here ``in_channels``,
which the detectors set to their backbone's output width (plus the image
cues' for ImVoteNet). Module names: ``vote_aggregation`` (mmdet3d's, with
the SA module's ``mlps.0.layer{j}``); the JAX head's own linear stacks
without norms keep the JAX names ``vote_mlp``, ``vote_out``,
``pred_mlp``, ``pred_out``.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
from torch import nn

from ...registry import HEADS
from ...utils.timing import section
from ..backbones.pointnet2 import PointSAModule
from ..layers import MLP, Linear
from ..losses import cross_entropy, smooth_l1_loss


def gravity_centers(boxes):
    """Bottom-centre boxes [..., 7+] -> their gravity centres [..., 3]."""
    return torch.cat([boxes[..., 0:2], boxes[..., 2:3] + boxes[..., 5:6]
                      * 0.5], -1)


def take_rows(x, idx):
    """x [B, G, ...], idx [B, P] -> [B, P, ...] (``take_along_axis`` on
    axis 1)."""
    shape = idx.shape + x.shape[2:]
    flat = idx.reshape(idx.shape[0], -1, *([1] * (x.dim() - 2)))
    return torch.gather(x, 1, flat.expand(-1, -1, *x.shape[2:])) \
        .reshape(shape)


def take_last(x, idx):
    """x [..., K], idx [...] -> [...]: the element ``idx`` of the last
    axis."""
    return torch.gather(x, -1, idx[..., None])[..., 0]


def nearest_gt(points, gt_centers, gt_valid):
    """(index, distance) of each point's nearest valid GT centre (the
    first among equals)."""
    d = ((points[:, :, None, :] - gt_centers[:, None, :, :]) ** 2).sum(-1)
    d = torch.where(gt_valid[:, None, :], d, 1e10)
    return torch.argmin(d, -1), torch.sqrt(torch.amin(d, -1))


def dir_targets(yaw, num_dir_bins: int):
    """(bin, residual) of yaws taken into [0, 2 pi)."""
    yaw = torch.remainder(yaw, 2 * math.pi)
    width = 2 * math.pi / num_dir_bins
    bins = (yaw / width).to(torch.int64) % num_dir_bins
    return bins, yaw - (bins.to(yaw.dtype) + 0.5) * width


def masked_mean(loss, mask, count):
    return torch.where(mask, loss, 0.0).sum() / count


def decode_boxes(center, sizes, dir_class, dir_res_norm, num_dir_bins: int):
    """Bottom-centre boxes [..., 7] from gravity centres, sizes, the best
    direction bin (the first among equals) and its residual."""
    width = 2 * math.pi / num_dir_bins
    dir_bin = torch.argmax(dir_class, -1)
    yaw = (dir_bin.to(sizes.dtype) + 0.5) * width + \
        take_last(dir_res_norm, dir_bin) * width
    return torch.cat([center[..., :2], center[..., 2:3] - sizes[..., 2:3]
                      / 2, sizes, yaw[..., None]], -1)


@HEADS.register('VoteHead')
class VoteHead(nn.Module):

    def __init__(self, num_classes: int = 18, in_channels: int = 256,
                 num_proposals: int = 256, vote_per_seed: int = 1,
                 gt_per_seed: int = 3, mean_sizes: Any = None,
                 num_dir_bins: int = 12, aggregation_radius: float = 0.3,
                 aggregation_samples: int = 16, train_cfg: Any = None,
                 test_cfg: Any = None, **unused):
        super().__init__()
        del unused
        c = in_channels
        self.num_classes, self.num_proposals = num_classes, num_proposals
        self.num_dir_bins = num_dir_bins
        self.train_cfg, self.test_cfg = train_cfg or {}, test_cfg or {}
        if mean_sizes is None:
            raise ValueError('VoteHead needs mean_sizes [num_classes, 3]')
        self.register_buffer('mean_sizes', torch.tensor(
            mean_sizes, dtype=torch.float32), persistent=False)
        self.vote_mlp = MLP(c, (c, c), final_act=True)
        self.vote_out = Linear(c, 3 + c)
        self.vote_aggregation = PointSAModule(
            num_proposals, aggregation_radius, aggregation_samples,
            (c, c, c), in_channels=c)
        self.pred_mlp = MLP(c, (c, c), final_act=True)
        self.pred_out = Linear(c, 2 + 3 + num_dir_bins * 2 +
                               num_classes * 5)

    def forward(self, feat_dict: Dict[str, torch.Tensor]):
        """feat_dict: fp_xyz [B, N, 3], fp_features [B, N, C], fp_valid."""
        xyz, feats = feat_dict['fp_xyz'], feat_dict['fp_features']
        valid = feat_dict['fp_valid']
        with section('vote'):
            offsets = self.vote_out(self.vote_mlp(feats))
            keep = valid[..., None]
            vote_xyz = xyz + torch.where(keep, offsets[..., :3], 0.0)
            vote_feats = feats + torch.where(keep, offsets[..., 3:], 0.0)
        with section('aggregation'):
            agg_xyz, agg_feats, agg_valid = self.vote_aggregation(
                vote_xyz, vote_feats, valid)
        with section('head'):
            raw = self.pred_out(self.pred_mlp(agg_feats))
        b, p = raw.shape[:2]
        nb, nc = self.num_dir_bins, self.num_classes
        res = {'aggregated_points': agg_xyz, 'aggregated_valid': agg_valid,
               'vote_xyz': vote_xyz, 'seed_xyz': xyz, 'seed_valid': valid}
        res['obj_scores'], raw = raw[..., :2], raw[..., 2:]
        res['center_offset'], raw = raw[..., :3], raw[..., 3:]
        res['center'] = agg_xyz + res['center_offset']
        res['dir_class'], raw = raw[..., :nb], raw[..., nb:]
        res['dir_res_norm'], raw = raw[..., :nb], raw[..., nb:]
        res['size_class'], raw = raw[..., :nc], raw[..., nc:]
        res['size_res_norm'] = raw[..., :nc * 3].reshape(b, p, nc, 3)
        res['sem_scores'] = raw[..., nc * 3:]
        return res

    def loss(self, preds, gt_bboxes, gt_labels, gt_valid):
        """Closest-GT assignment; objectness, centre, size, direction,
        semantic and vote losses (the JAX head's)."""
        nc, nb = self.num_classes, self.num_dir_bins
        centers, agg_valid = preds['center'], preds['aggregated_valid']
        gt_centers = gravity_centers(gt_bboxes)
        nearest, nearest_d = nearest_gt(centers, gt_centers, gt_valid)
        near_thr = self.train_cfg.get('pos_distance_thr', 0.3)
        far_thr = self.train_cfg.get('neg_distance_thr', 0.6)
        pos = (nearest_d < near_thr) & agg_valid
        neg = (nearest_d > far_thr) & agg_valid

        obj_w = (pos | neg).to(centers.dtype)
        obj_loss = cross_entropy(preds['obj_scores'].reshape(-1, 2),
                                 pos.reshape(-1).to(torch.int64), 2)
        obj_loss = (obj_loss * obj_w.reshape(-1)).sum() / \
            torch.clamp(obj_w.sum(), min=1)

        gt_for = take_rows(gt_bboxes, nearest)
        lab = torch.clamp(take_rows(gt_labels, nearest).to(torch.int64),
                          min=0)
        gt_ctr = take_rows(gt_centers, nearest)
        num_pos = torch.clamp(pos.sum(), min=1)
        flat_pos = pos.reshape(-1)

        center_loss = masked_mean(smooth_l1_loss(centers, gt_ctr).sum(-1),
                                  pos, num_pos)
        sem_loss = masked_mean(cross_entropy(
            preds['sem_scores'].reshape(-1, nc), lab.reshape(-1), nc),
            flat_pos, num_pos)
        size_cls_loss = masked_mean(cross_entropy(
            preds['size_class'].reshape(-1, nc), lab.reshape(-1), nc),
            flat_pos, num_pos)
        mean = self.mean_sizes[lab]
        pred_res = torch.gather(preds['size_res_norm'], 2, lab[
            ..., None, None].expand(-1, -1, 1, 3))[:, :, 0]
        size_res_loss = masked_mean(smooth_l1_loss(
            pred_res * mean, gt_for[..., 3:6] - mean).sum(-1), pos, num_pos)

        dir_bin, dir_res = dir_targets(gt_for[..., 6], nb)
        dir_cls_loss = masked_mean(cross_entropy(
            preds['dir_class'].reshape(-1, nb), dir_bin.reshape(-1), nb),
            flat_pos, num_pos)
        width = 2 * math.pi / nb
        dir_res_loss = masked_mean(smooth_l1_loss(
            take_last(preds['dir_res_norm'], dir_bin) * width, dir_res),
            pos, num_pos)

        # the seeds near a GT centre vote for it
        seed_near, seed_d = nearest_gt(preds['seed_xyz'], gt_centers,
                                       gt_valid)
        voting = (seed_d < near_thr) & preds['seed_valid']
        vote_loss = masked_mean(smooth_l1_loss(
            preds['vote_xyz'], take_rows(gt_centers, seed_near)).sum(-1),
            voting, torch.clamp(voting.sum(), min=1))

        return {'vote_loss': vote_loss, 'objectness_loss': obj_loss,
                'center_loss': center_loss, 'dir_class_loss': dir_cls_loss,
                'dir_res_loss': dir_res_loss,
                'size_class_loss': size_cls_loss,
                'size_res_loss': size_res_loss, 'semantic_loss': sem_loss}

    def get_bboxes(self, preds):
        """Every proposal decoded: bboxes [B, P, 7] (bottom centre),
        scores (objectness x the best class's), labels, valid."""
        with section('decode'):
            obj = torch.softmax(preds['obj_scores'], -1)[..., 1]
            sem = torch.softmax(preds['sem_scores'], -1)
            labels = torch.argmax(sem, -1)
            scores = obj * torch.amax(sem, -1)
            size_res = torch.gather(preds['size_res_norm'], 2, labels[
                ..., None, None].expand(-1, -1, 1, 3))[:, :, 0]
            sizes = torch.clamp(self.mean_sizes[labels] * (1 + size_res),
                                min=0.05)
            boxes = decode_boxes(preds['center'], sizes, preds['dir_class'],
                                 preds['dir_res_norm'], self.num_dir_bins)
            return {'bboxes': boxes, 'scores': scores, 'labels': labels,
                    'valid': preds['aggregated_valid']}
