"""Tap offsets and the output coordinate set of a strided sparse conv.

Counterpart of ``kernel_offsets`` and ``downsample_out_coords`` in the JAX
package's ``ops/sparse/conv.py``.
"""
from __future__ import annotations

import itertools
from typing import Tuple

import numpy as np
import torch

from ...utils import overflow
from .tensor import INT_MAX, SparseTensor, unpack_keys


def triple(v) -> Tuple[int, int, int]:
    """A per-axis (z, y, x) triple from an int or a 3-sequence."""
    if isinstance(v, (list, tuple)):
        if len(v) != 3:
            raise ValueError(f'expected 3 values, got {v!r}')
        return tuple(int(x) for x in v)
    return (int(v),) * 3


def kernel_offsets(kernel_size) -> np.ndarray:
    """[T, 3] tap offsets (tap - center), z-major and x fastest: the
    spconv tap order that the weights' ``[Ta, I, O]`` view follows."""
    kz, ky, kx = triple(kernel_size)
    taps = np.array(list(itertools.product(range(kz), range(ky), range(kx))),
                    dtype=np.int32)
    center = np.array([kz // 2, ky // 2, kx // 2], dtype=np.int32)
    return taps - center


def downsample_out_coords(st: SparseTensor, kernel_size, stride, padding,
                          capacity: int, site: str = ''):
    """Active output coordinate set of a strided sparse conv.

    Output o (per axis) receives input i iff ``o*stride - pad + tap == i``
    for a tap in [0, kernel). Candidates are generated per input from the
    taps that meet the stride divisibility, then sorted and uniqued into
    ``capacity`` rows: the smallest keys are kept, the rest counted at
    ``sparse.downsample.out_cap[site]``. Returns (out_keys [capacity],
    out_coords [capacity, 4], out_valid [capacity], out_spatial_shape).
    """
    kz, ky, kx = triple(kernel_size)
    sz, sy, sx = triple(stride)
    pz, py, px = triple(padding)
    z, y, x = st.spatial_shape
    out_shape = ((z + 2 * pz - kz) // sz + 1,
                 (y + 2 * py - ky) // sy + 1,
                 (x + 2 * px - kx) // sx + 1)
    oz, oy, ox = out_shape
    co = st.coords.to(torch.int64)

    def axis_candidates(i, kdim, s, p, odim):
        c_ax = -(-kdim // s)
        shifted = i + p
        k0 = shifted % s
        taps = k0[:, None] + s * torch.arange(c_ax, device=i.device)[None, :]
        o = torch.div(shifted[:, None] - taps, s, rounding_mode='floor')
        ok = (taps < kdim) & (o >= 0) & (o < odim)
        return o, ok

    vz, mz = axis_candidates(co[:, 1], kz, sz, pz, oz)
    vy, my = axis_candidates(co[:, 2], ky, sy, py, oy)
    vx, mx = axis_candidates(co[:, 3], kx, sx, px, ox)
    cz, cy, cx = vz.shape[1], vy.shape[1], vx.shape[1]
    b = co[:, 0]
    rows = []
    for t in range(cz * cy * cx):
        iz, rem = divmod(t, cy * cx)
        iy, ix = divmod(rem, cx)
        okr = mz[:, iz] & my[:, iy] & mx[:, ix] & st.valid
        keyr = ((b * oz + vz[:, iz]) * oy + vy[:, iy]) * ox + vx[:, ix]
        rows.append(torch.where(okr, keyr, INT_MAX))
    cand = torch.stack(rows).reshape(-1).to(torch.int32)

    skey, _ = torch.sort(cand)
    head = torch.cat([skey[:1] != INT_MAX,
                      (skey[1:] != skey[:-1]) & (skey[1:] != INT_MAX)])
    n_out = head.sum()
    tag = f'[{site}]' if site else ''
    overflow.record(f'sparse.downsample.out_cap{tag}',
                    torch.clamp(n_out - capacity, min=0))
    overflow.gauge(f'occ.downsample_out{tag}', n_out)
    out_keys, _ = torch.sort(torch.where(head, skey, INT_MAX))
    out_keys = out_keys[:capacity]
    out_valid = out_keys != INT_MAX
    out_coords = torch.where(out_valid[:, None],
                             unpack_keys(out_keys, out_shape), -1)
    return out_keys, out_coords, out_valid, out_shape
