"""PointNet++ set-abstraction backbones (single- and multi-scale grouping).

Counterpart of the JAX package's ``models/backbones/pointnet2.py``
(reference mmdet3d/models/backbones/pointnet2_sa_{ssg,msg}.py and the
SA/FP modules, mmdet3d/ops/pointnet_modules/point_sa_module.py:230,
point_fp_module.py:77): farthest-point sampling, ball-query grouping, a
shared MLP and a max pool per group; feature propagation by 3-NN
interpolation. Every point set is fixed-capacity with a validity mask.

The geometry runs over the whole batch at once (``ops/sampling.py``'s ops
are batched, each sample's result its own). The norms are per sample, as
the JAX package's per-sample loop has them: in training each
``MaskedBatchNorm`` takes the moments of one sample's member rows and
updates its running statistics once per sample, in sample order; in eval
mode a row's norm does not depend on the batch, so it runs on all of it.

Module names are mmdet3d's: ``SA_modules.{i}.mlps.{scale}.layer{j}`` and
``FP_modules.{i}.mlps.layer{j}``, each a 1x1 ``conv`` (no bias) and a
``bn``. The JAX modules infer their input widths; here they follow from
``in_channels`` (xyz plus the point features) and the widths before them.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import sampling
from ...registry import BACKBONES
from ...utils.timing import section
from ..layers import Conv2d, MaskedBatchNorm, pointwise


class PointConv(nn.Module):
    """A shared MLP layer: a 1x1 ``conv`` and a masked ``bn``."""

    def __init__(self, in_channels: int, out_channels: int,
                 norm_eps: float = 1e-5, norm_momentum: float = 0.1):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, 1, bias=False)
        self.bn = MaskedBatchNorm(out_channels, eps=norm_eps,
                                  momentum=norm_momentum)


def shared_mlp(in_channels: int, channels: Sequence[int],
               **norm) -> nn.Sequential:
    layers = OrderedDict()
    for j, c in enumerate(channels):
        layers[f'layer{j}'] = PointConv(in_channels, c, **norm)
        in_channels = c
    return nn.Sequential(layers)


def run_mlp(mlp: nn.Sequential, x, mask):
    """Channels-last ``x`` [B, ..., Cin] through each layer's conv, its
    norm over the rows in ``mask`` [B, ...] (zeroing the others) and a
    ReLU. In training each sample's rows are normalised apart, in sample
    order."""
    for layer in mlp:
        x = pointwise(layer.conv, x)
        c = x.shape[-1]
        if layer.bn.training:
            x = torch.stack([layer.bn(xi.reshape(-1, c), mi.reshape(-1))
                             .reshape(xi.shape) for xi, mi in zip(x, mask)])
        else:
            x = layer.bn(x.reshape(-1, c), mask.reshape(-1)).reshape(x.shape)
        x = F.relu(x)
    return x


def group_pool(mlp, radius: float, num_sample: int, xyz, features, valid,
               new_xyz):
    """Ball-query groups around ``new_xyz`` [B, S, 3]: each member's offset
    from its centre and its features through ``mlp``, max-pooled over the
    group (an empty ball gives 0): [B, S, C']."""
    with section('ball_query'):
        idx = sampling.ball_query(radius, num_sample, xyz, new_xyz,
                                  xyz_valid=valid)                # [B, S, K]
    parts = [sampling.group_points(xyz, idx) - new_xyz[:, :, None, :]]
    if features is not None:
        parts.append(sampling.group_points(features, idx))
    member = idx >= 0
    x = run_mlp(mlp, torch.cat(parts, -1), member)
    pooled = torch.amax(torch.where(member[..., None], x, float('-inf')), 2)
    return torch.where(torch.isfinite(pooled), pooled, 0.0)


def sample_points(xyz, valid, num_point: int):
    """Farthest-point samples: (new_xyz [B, S, 3], new_valid [B, S])."""
    with section('fps'):
        idx = sampling.furthest_point_sample(xyz, num_point, valid)
    return sampling.gather_points(xyz, idx), torch.gather(valid, 1, idx)


class PointSAModule(nn.Module):
    """Set abstraction: FPS, ball query, shared MLP, max pool.
    ``in_channels``: the point features' width (without xyz)."""

    def __init__(self, num_point: int, radius: float, num_sample: int,
                 mlp_channels: Sequence[int], in_channels: int = 0,
                 norm_eps: float = 1e-5, norm_momentum: float = 0.1):
        super().__init__()
        self.num_point, self.radius, self.num_sample = \
            num_point, radius, num_sample
        self.mlps = nn.ModuleList([shared_mlp(
            3 + in_channels, mlp_channels, norm_eps=norm_eps,
            norm_momentum=norm_momentum)])

    def forward(self, xyz, features, valid, new_xyz=None, new_valid=None):
        """xyz [B, N, 3], features [B, N, C] or None, valid [B, N];
        ``new_xyz``/``new_valid``: pool around these points instead of
        FPS samples (3DSSD's shifted candidates). Returns (new_xyz, pooled
        [B, S, C'] zero where invalid, new_valid)."""
        if new_xyz is None:
            new_xyz, new_valid = sample_points(xyz, valid, self.num_point)
        pooled = group_pool(self.mlps[0], self.radius, self.num_sample, xyz,
                            features, valid, new_xyz)
        return new_xyz, torch.where(new_valid[..., None], pooled, 0.0), \
            new_valid


class PointSAModuleMSG(nn.Module):
    """Multi-scale grouping: one FPS, a group and MLP per radius, the
    pooled features concatenated (reference point_sa_module.py, MSG)."""

    def __init__(self, num_point: int, radii: Sequence[float],
                 num_samples: Sequence[int],
                 mlp_channels: Sequence[Sequence[int]], in_channels: int = 0,
                 norm_eps: float = 1e-5, norm_momentum: float = 0.1):
        super().__init__()
        self.num_point = num_point
        self.radii, self.num_samples = tuple(radii), tuple(num_samples)
        self.mlps = nn.ModuleList([
            shared_mlp(3 + in_channels, mlp, norm_eps=norm_eps,
                       norm_momentum=norm_momentum) for mlp in mlp_channels])

    def forward(self, xyz, features, valid):
        new_xyz, new_valid = sample_points(xyz, valid, self.num_point)
        out = torch.cat([
            group_pool(mlp, r, k, xyz, features, valid, new_xyz)
            for mlp, r, k in zip(self.mlps, self.radii, self.num_samples)],
            -1)
        return new_xyz, torch.where(new_valid[..., None], out, 0.0), \
            new_valid


class PointFPModule(nn.Module):
    """Feature propagation: 3-NN inverse-distance interpolation of the
    source features at the targets, the targets' own features appended,
    then a shared MLP over the valid targets."""

    def __init__(self, mlp_channels: Sequence[int], in_channels: int,
                 norm_eps: float = 1e-5, norm_momentum: float = 0.1):
        super().__init__()
        self.mlps = shared_mlp(in_channels, mlp_channels, norm_eps=norm_eps,
                               norm_momentum=norm_momentum)

    def forward(self, target_xyz, target_feats, source_xyz, source_feats,
                target_valid, source_valid):
        d2, idx = sampling.three_nn(target_xyz, source_xyz, source_valid)
        parts = [sampling.three_interpolate(source_feats, idx, d2)]
        if target_feats is not None:
            parts.append(target_feats)
        x = run_mlp(self.mlps, torch.cat(parts, -1), target_valid)
        return torch.where(target_valid[..., None], x, 0.0)


def split_points(points):
    """points [B, N, 3+F] -> (xyz, features or None)."""
    xyz = points[..., :3].contiguous()
    return xyz, (points[..., 3:].contiguous() if points.shape[-1] > 3
                 else None)


@BACKBONES.register('PointNet2SASSG')
class PointNet2SASSG(nn.Module):
    """Single-scale-grouping PointNet++ with FP decoding: the last FP
    level's points (``fp_xyz``, ``fp_features``, ``fp_valid``)."""

    def __init__(self, in_channels: int = 4,
                 num_points: Sequence[int] = (2048, 1024, 512, 256),
                 radius: Sequence[float] = (0.2, 0.4, 0.8, 1.2),
                 num_samples: Sequence[int] = (64, 32, 16, 16),
                 sa_channels: Sequence[Sequence[int]] = (
                     (64, 64, 128), (128, 128, 256), (128, 128, 256),
                     (128, 128, 256)),
                 fp_channels: Sequence[Sequence[int]] = ((256, 256),
                                                         (256, 256))):
        super().__init__()
        widths = [in_channels - 3]          # each level's feature width
        sa = []
        for i, mlp in enumerate(sa_channels):
            sa.append(PointSAModule(num_points[i], radius[i], num_samples[i],
                                    mlp, widths[-1]))
            widths.append(mlp[-1])
        self.SA_modules = nn.ModuleList(sa)
        fp, source = [], widths[-1]
        for i, mlp in enumerate(fp_channels):
            fp.append(PointFPModule(mlp, source + widths[-2 - i]))
            source = mlp[-1]
        self.FP_modules = nn.ModuleList(fp)
        self.out_channels = source

    def forward(self, points, points_mask):
        xyz, feats = split_points(points)
        levels = [(xyz, feats, points_mask)]
        with section('sa'):
            for mod in self.SA_modules:
                levels.append(mod(*levels[-1]))
        cur_xyz, cur_feats, cur_valid = levels[-1]
        with section('fp'):
            for i, mod in enumerate(self.FP_modules):
                t_xyz, t_feats, t_valid = levels[-2 - i]
                cur_feats = mod(t_xyz, t_feats, cur_xyz, cur_feats, t_valid,
                                cur_valid)
                cur_xyz, cur_valid = t_xyz, t_valid
        return dict(fp_xyz=cur_xyz, fp_features=cur_feats,
                    fp_valid=cur_valid)


@BACKBONES.register('PointNet2SAMSG')
class PointNet2SAMSG(nn.Module):
    """Multi-scale-grouping PointNet++ (the 3DSSD backbone, no FP
    decoding): the last SA level as the head's point set."""

    def __init__(self, in_channels: int = 4,
                 num_points: Sequence[int] = (4096, 512, 256),
                 radii: Sequence[Sequence[float]] = (
                     (0.2, 0.4, 0.8), (0.4, 0.8, 1.6), (1.6, 3.2, 4.8)),
                 num_samples: Sequence[Sequence[int]] = (
                     (32, 32, 64), (32, 32, 32), (32, 32, 32)),
                 sa_channels: Optional[Sequence] = (
                     ((16, 16, 32), (16, 16, 32), (32, 32, 64)),
                     ((64, 64, 128), (64, 64, 128), (64, 96, 128)),
                     ((128, 128, 256), (128, 192, 256), (128, 256, 256)))):
        super().__init__()
        width, sa = in_channels - 3, []
        for i, mlps in enumerate(sa_channels):
            sa.append(PointSAModuleMSG(num_points[i], radii[i],
                                       num_samples[i], mlps, width))
            width = sum(m[-1] for m in mlps)
        self.SA_modules = nn.ModuleList(sa)
        self.out_channels = width

    def forward(self, points, points_mask):
        level = (*split_points(points), points_mask)
        with section('sa'):
            for mod in self.SA_modules:
                level = mod(*level)
        return dict(fp_xyz=level[0], fp_features=level[1], fp_valid=level[2])
