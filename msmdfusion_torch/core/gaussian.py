"""Gaussian heatmap targets, batched.

Counterpart of the JAX package's ``core/gaussian.py`` (reference
mmdet3d/core/utils/gaussian.py, ``gaussian_radius``,
``draw_heatmap_gaussian``): each ground-truth box renders its gaussian over
the whole grid, cut at the Chebyshev radius like the reference's square
patch, and the boxes of one class combine by their maximum.
"""
from __future__ import annotations

import torch


def gaussian_radius(det_size, min_overlap: float = 0.5):
    """Smallest gaussian radius that keeps ``min_overlap`` IoU (the
    CornerNet formula); det_size = (height, width) in feature-map cells."""
    height, width = det_size
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + torch.sqrt(b1 ** 2 - 4 * c1)) / 2
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + torch.sqrt(b2 ** 2 - 4 * 4.0 * c2)) / 2
    a3 = 4.0 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + torch.sqrt(b3 ** 2 - 4 * a3 * c3)) / 2
    return torch.minimum(torch.minimum(r1, r2), r3)


def render_gaussian(centers_int, radius, shape):
    """[G, H, W] gaussians of integer centres [G, 2] (x, y) and radii [G]:
    sigma = (2r + 1) / 6, support the (2r + 1)^2 square around the
    centre."""
    h, w = shape
    dev = radius.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    dx = xs - centers_int[:, 0].to(torch.float32)[:, None, None]
    dy = ys - centers_int[:, 1].to(torch.float32)[:, None, None]
    r = radius[:, None, None]
    sigma = (2.0 * r + 1.0) / 6.0
    val = torch.exp(-(dx * dx + dy * dy) / (2.0 * sigma * sigma))
    inside = torch.maximum(dx.abs(), dy.abs()) <= r
    return torch.where(inside, val, 0.0)


def draw_heatmap(centers_int, radii, labels, valid, num_classes: int, shape):
    """[C, H, W] per-class heatmap: the maximum of the valid boxes'
    gaussians of each class (0 where a class has none)."""
    h, w = shape
    vals = render_gaussian(centers_int, radii, shape)
    vals = torch.where(valid[:, None, None], vals, 0.0).reshape(-1, h * w)
    seg = torch.full((num_classes, h * w), float('-inf'),
                     dtype=vals.dtype, device=vals.device)
    seg = seg.scatter_reduce(0, labels.to(torch.int64)[:, None].expand_as(vals),
                             vals, 'amax', include_self=True)
    return torch.clamp(seg, min=0.0).reshape(num_classes, h, w)
