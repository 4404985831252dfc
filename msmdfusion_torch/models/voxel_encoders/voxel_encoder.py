"""Voxel feature encoders.

Counterpart of the JAX package's ``models/voxel_encoders/voxel_encoder.py``
(reference mmdet3d/models/voxel_encoders/voxel_encoder.py ``HardSimpleVFE``,
``HardVFE``, ``DynamicVFE`` and pillar_encoder.py ``PillarFeatureNet`` with
utils.py ``PFNLayer``), on fixed-capacity voxel buffers [V, P, F] with a
point count per voxel instead of dynamic tensors. Module names are the
reference's (``pfn_layers.{i}.linear``/``.norm``, ``vfe_layers.{i}``).

The norms are the port's ``MaskedBatchNorm`` (global moments inside a
process group): a PFN layer's over the valid points only, as the JAX
layer's; ``HardVFE``'s and ``DynamicVFE``'s over every row, the padding
ones included, as the JAX package's flax ``BatchNorm`` on the flattened
rows (the running variance keeps the torch convention, unbiased).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from ...registry import VOXEL_ENCODERS
from ..layers import Linear, MaskedBatchNorm


def hard_simple_vfe(voxels, num_points):
    """The mean of each voxel's points: voxels [V, P, F], num_points [V] ->
    [V, F]."""
    total = voxels.sum(1)
    return total / torch.clamp(num_points, min=1).to(voxels.dtype)[:, None]


@VOXEL_ENCODERS.register('HardSimpleVFE')
class HardSimpleVFE(nn.Module):
    """The mean of the (at most ``max_points``) points of each voxel."""

    def __init__(self, num_features: int = 4):
        super().__init__()
        self.num_features = num_features

    def forward(self, voxels, num_points, coors=None):
        return hard_simple_vfe(voxels, num_points)


def _masked_max(x, mask):
    """Max over the points axis 1 of the points in ``mask`` [V, P]; 0 for a
    voxel without one."""
    m = torch.where(mask[..., None], x, float('-inf')).amax(1)
    return torch.where(torch.isfinite(m), m, 0.0)


class PFNLayer(nn.Module):
    """Linear + batch norm over the valid points + ReLU + max over the
    voxel's points (concatenated back onto each point but in the last
    layer)."""

    def __init__(self, in_channels: int, out_channels: int,
                 last_layer: bool = False, norm_eps: float = 1e-3,
                 norm_momentum: float = 0.01):
        super().__init__()
        self.last_layer = last_layer
        units = out_channels if last_layer else out_channels // 2
        self.linear = Linear(in_channels, units, bias=False)
        self.norm = MaskedBatchNorm(units, eps=norm_eps,
                                    momentum=norm_momentum)

    def forward(self, inputs, point_mask):
        v, p, _ = inputs.shape
        x = self.linear(inputs)
        x = self.norm(x.reshape(v * p, -1),
                      mask=point_mask.reshape(v * p)).reshape(v, p, -1)
        x = torch.relu(x)
        x_max = _masked_max(x, point_mask)                   # [V, C]
        if self.last_layer:
            return x_max
        x = torch.where(point_mask[..., None], x, 0.0)
        return torch.cat([x, x_max[:, None].expand_as(x)], -1)


def _augment_channels(in_channels, with_cluster_center, with_voxel_center,
                      with_distance):
    return in_channels + 3 * with_cluster_center + 3 * with_voxel_center \
        + int(with_distance)


@VOXEL_ENCODERS.register('PillarFeatureNet')
class PillarFeatureNet(nn.Module):
    """Each pillar point decorated with its offset from the pillar's point
    mean and from the pillar's centre, then PFN layers."""

    def __init__(self, in_channels: int = 4, feat_channels: Sequence[int] =
                 (64,), with_distance: bool = False,
                 with_cluster_center: bool = True,
                 with_voxel_center: bool = True,
                 voxel_size: Tuple[float, float, float] = (0.2, 0.2, 4.0),
                 point_cloud_range: Sequence[float] = (0., -40., -3., 70.4,
                                                       40., 1.),
                 legacy: bool = True, norm_eps: float = 1e-3,
                 norm_momentum: float = 0.01):
        super().__init__()
        self.with_distance = with_distance
        self.with_cluster_center = with_cluster_center
        self.with_voxel_center = with_voxel_center
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        c = _augment_channels(in_channels, with_cluster_center,
                              with_voxel_center, with_distance)
        layers = []
        for i, out in enumerate(feat_channels):
            last = i == len(feat_channels) - 1
            layers.append(PFNLayer(c, out, last_layer=last, norm_eps=norm_eps,
                                   norm_momentum=norm_momentum))
            c = out
        self.pfn_layers = nn.ModuleList(layers)

    def forward(self, voxels, num_points, coors):
        """voxels [V, P, F], num_points [V], coors [V, 4] (b, z, y, x) ->
        [V, C]."""
        v, p, _ = voxels.shape
        point_mask = torch.arange(p, device=voxels.device)[None] < \
            num_points[:, None]
        features = [voxels]
        if self.with_cluster_center:
            mean = (voxels[..., :3] * point_mask[..., None]).sum(
                1, keepdim=True) / torch.clamp(num_points, min=1)[:, None,
                                                                  None]
            features.append(voxels[..., :3] - mean)
        if self.with_voxel_center:
            vx, vy, vz = self.voxel_size
            x0, y0, z0 = self.point_cloud_range[:3]
            c = coors.to(voxels.dtype)
            features.append(torch.cat([
                voxels[..., 0:1] - (c[:, 3, None, None] * vx + (vx / 2 + x0)),
                voxels[..., 1:2] - (c[:, 2, None, None] * vy + (vy / 2 + y0)),
                voxels[..., 2:3] - (c[:, 1, None, None] * vz + (vz / 2 + z0)),
            ], -1))
        if self.with_distance:
            features.append(torch.linalg.norm(voxels[..., :3], dim=-1,
                                              keepdim=True))
        x = torch.where(point_mask[..., None], torch.cat(features, -1), 0.0)
        for layer in self.pfn_layers:
            x = layer(x, point_mask)
        return x


def _all_rows_norm(norm, x):
    """``norm`` over every row of ``x`` [..., C] (no mask)."""
    return norm(x.reshape(-1, x.shape[-1])).reshape(x.shape)


class VFELayer(nn.Module):
    """Linear + batch norm (every row) of a ``HardVFE`` layer."""

    def __init__(self, in_channels: int, out_channels: int,
                 norm_eps: float = 1e-3, norm_momentum: float = 0.01):
        super().__init__()
        self.linear = Linear(in_channels, out_channels, bias=False)
        self.norm = MaskedBatchNorm(out_channels, eps=norm_eps,
                                    momentum=norm_momentum)

    def forward(self, x):
        return _all_rows_norm(self.norm, self.linear(x))


def _voxel_centres(coors_xyz, voxel_size, origin, dtype):
    vs = torch.tensor(voxel_size, dtype=dtype, device=coors_xyz.device)
    org = torch.tensor(origin, dtype=dtype, device=coors_xyz.device)
    return (coors_xyz.to(dtype) + 0.5) * vs + org


@VOXEL_ENCODERS.register('HardVFE')
class HardVFE(nn.Module):
    """Points decorated with their cluster and voxel-centre offsets (and
    distance), stacked VFE layers with the voxel's max concatenated between
    them, and a max over the voxel's points."""

    def __init__(self, in_channels: int = 4, feat_channels: Sequence[int] =
                 (64,), with_distance: bool = False,
                 with_cluster_center: bool = True,
                 with_voxel_center: bool = True,
                 voxel_size: Sequence[float] = (0.2, 0.2, 4),
                 point_cloud_range: Sequence[float] = (0, -40, -3, 70.4, 40,
                                                       1)):
        super().__init__()
        self.with_distance = with_distance
        self.with_cluster_center = with_cluster_center
        self.with_voxel_center = with_voxel_center
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        c = _augment_channels(in_channels, with_cluster_center,
                              with_voxel_center, with_distance)
        layers = []
        for i, out in enumerate(feat_channels):
            layers.append(VFELayer(c, out))
            c = out * 2
        self.vfe_layers = nn.ModuleList(layers)

    def forward(self, voxels, num_points, coors=None):
        """voxels [V, P, D], num_points [V], coors [V, 4] -> [V, C]."""
        p = voxels.shape[1]
        mask = torch.arange(p, device=voxels.device)[None] < \
            num_points[:, None]
        feats = [voxels]
        if self.with_cluster_center:
            mean = (voxels[..., :3] * mask[..., None]).sum(1) / \
                torch.clamp(num_points[:, None], min=1)
            feats.append(voxels[..., :3] - mean[:, None, :])
        if self.with_voxel_center:
            ctr = _voxel_centres(coors[:, [3, 2, 1]], self.voxel_size,
                                 self.point_cloud_range[:3], voxels.dtype)
            feats.append(voxels[..., :3] - ctr[:, None, :])
        if self.with_distance:
            feats.append(torch.linalg.norm(voxels[..., :3], dim=-1,
                                           keepdim=True))
        x = torch.cat(feats, -1) * mask[..., None]
        n_layers = len(self.vfe_layers)
        for i, layer in enumerate(self.vfe_layers):
            x = torch.where(mask[..., None], torch.relu(layer(x)), 0.0)
            if i != n_layers - 1:
                vmax = _masked_max(x, mask)
                x = torch.cat([x, vmax[:, None].expand_as(x)], -1)
        return _masked_max(x, mask)


@VOXEL_ENCODERS.register('DynamicVFE')
class DynamicVFE(nn.Module):
    """Per-point MLP with each layer's voxel reduce (``dynamic_scatter``)
    gathered back onto the points: no per-voxel point cap."""

    def __init__(self, in_channels: int = 4, feat_channels: Sequence[int] =
                 (64,), with_distance: bool = False,
                 with_cluster_center: bool = True,
                 with_voxel_center: bool = True,
                 voxel_size: Sequence[float] = (0.2, 0.2, 4),
                 point_cloud_range: Sequence[float] = (0, -40, -3, 70.4, 40,
                                                       1),
                 mode: str = 'max'):
        super().__init__()
        self.with_distance = with_distance
        self.with_cluster_center = with_cluster_center
        self.with_voxel_center = with_voxel_center
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        self.mode = mode
        c = _augment_channels(in_channels, with_cluster_center,
                              with_voxel_center, with_distance)
        layers = []
        for i, out in enumerate(feat_channels):
            layers.append(nn.Sequential(
                Linear(c, out, bias=False),
                MaskedBatchNorm(out, eps=1e-3, momentum=0.01), nn.ReLU()))
            c = out * 2
        self.vfe_layers = nn.ModuleList(layers)

    def forward(self, points, coords_zyx, valid, max_voxels: int):
        """points [N, D], coords_zyx [N, 3], valid [N] -> (voxel_feats [V,
        C], voxel_coors [V, 3], voxel_valid [V])."""
        from ...ops.voxelize import dynamic_scatter, grid_shape
        grid = grid_shape(self.voxel_size, self.point_cloud_range)
        feats = [points]
        if self.with_cluster_center:
            mean, _, _, p2v = dynamic_scatter(points[:, :3], coords_zyx,
                                              valid, grid, max_voxels, 'mean')
            feats.append(points[:, :3] - torch.where(
                (p2v >= 0)[:, None], mean[p2v.clamp(min=0).long()], 0.0))
        if self.with_voxel_center:
            feats.append(points[:, :3] - _voxel_centres(
                coords_zyx[:, [2, 1, 0]], self.voxel_size,
                self.point_cloud_range[:3], points.dtype))
        if self.with_distance:
            feats.append(torch.linalg.norm(points[:, :3], dim=-1,
                                           keepdim=True))
        x = torch.cat(feats, -1) * valid[:, None]
        n_layers = len(self.vfe_layers)
        vfeats = vcoors = vvalid = None
        for i, layer in enumerate(self.vfe_layers):
            linear, norm, _ = layer
            x = torch.relu(norm(linear(x))) * valid[:, None]
            vfeats, vcoors, vvalid, p2v = dynamic_scatter(
                x, coords_zyx, valid, grid, max_voxels, self.mode)
            if i != n_layers - 1:
                x = torch.cat([x, torch.where(
                    (p2v >= 0)[:, None], vfeats[p2v.clamp(min=0).long()],
                    0.0)], -1)
        return vfeats, vcoors, vvalid
