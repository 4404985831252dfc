"""3D anchor generation.

Counterpart of the JAX package's ``core/anchors.py`` (reference
mmdet3d/core/anchor/anchor_3d_generator.py ``Anchor3DRangeGenerator`` /
``AlignedAnchor3DRangeGenerator``): dense anchors on the BEV grid for each
(range, size) and rotation, [H, W, A, 7+] with the rotation fastest along
A, made in numpy float64 and cast to float32 as the JAX package's are.
"""
from __future__ import annotations

import numpy as np

from ..registry import ANCHOR_GENERATORS


@ANCHOR_GENERATORS.register('Anchor3DRangeGenerator')
class Anchor3DRangeGenerator:

    def __init__(self, ranges, sizes=((1.6, 3.9, 1.56),),
                 rotations=(0, 1.5707963), custom_values=(),
                 reshape_out=True, size_per_range=True, align_corner=False):
        self.ranges = [list(r) for r in ranges]
        self.sizes = [list(s) for s in sizes]
        self.rotations = list(rotations)
        self.custom_values = list(custom_values)
        self.align_corner = align_corner
        if len(self.ranges) == 1 and len(self.sizes) > 1:
            self.ranges = self.ranges * len(self.sizes)

    @property
    def num_base_anchors(self):
        return len(self.sizes) * len(self.rotations)

    def grid_anchors(self, feature_size):
        """feature_size (H, W) -> [H, W, A, 7+] float32 numpy anchors."""
        h, w = feature_size
        all_anchors = []
        for rng, size in zip(self.ranges, self.sizes):
            x0, y0, z0, x1, y1, z1 = rng
            if self.align_corner:
                xs = np.linspace(x0, x1, w)
                ys = np.linspace(y0, y1, h)
            else:
                xs = np.linspace(x0, x1, w + 1)[:-1] + (x1 - x0) / (2 * w)
                ys = np.linspace(y0, y1, h + 1)[:-1] + (y1 - y0) / (2 * h)
            gx, gy = np.meshgrid(xs, ys)
            for rot in self.rotations:
                a = np.zeros((h, w, 7 + len(self.custom_values)), np.float32)
                a[..., 0] = gx
                a[..., 1] = gy
                a[..., 2] = (z0 + z1) / 2
                a[..., 3:6] = size
                a[..., 6] = rot
                if self.custom_values:
                    a[..., 7:] = self.custom_values
                all_anchors.append(a)
        return np.stack(all_anchors, axis=2)


@ANCHOR_GENERATORS.register('AlignedAnchor3DRangeGenerator')
class AlignedAnchor3DRangeGenerator(Anchor3DRangeGenerator):
    def __init__(self, **kwargs):
        kwargs.setdefault('align_corner', False)
        super().__init__(**kwargs)
