"""Tap offsets, the output coordinate set of a strided sparse conv, and
the inverse (transposed) sparse conv.

Counterpart of ``kernel_offsets``, ``downsample_out_coords`` and
``inverse_conv`` in the JAX package's ``ops/sparse/conv.py``.
"""
from __future__ import annotations

import itertools
from typing import Tuple

import numpy as np
import torch

from ...utils import overflow
from .tensor import INT_MAX, SparseTensor, pack_keys, unpack_keys


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


def inverse_rows(st: SparseTensor, orig_coords, orig_valid, kernel_size,
                 stride, padding) -> torch.Tensor:
    """[T, K_out] rows of ``st`` (the coarse set) that each fine row of
    ``orig_coords`` gathers per tap, -1 where none: fine row o takes coarse
    row i where ``o = i*stride - pad + tap`` holds exactly (the division
    ``(o + pad - tap) / stride`` without remainder on every axis) and i
    lies in the coarse grid. One binary search of the sorted keys."""
    taps = torch.tensor(list(itertools.product(
        *(range(k) for k in triple(kernel_size)))), device=orig_coords.device)
    stride_a = torch.tensor(triple(stride), device=orig_coords.device)
    pad_a = torch.tensor(triple(padding), device=orig_coords.device)
    bound = torch.tensor(st.spatial_shape, device=orig_coords.device)
    co = orig_coords.to(torch.int64)
    numer = co[None, :, 1:] + pad_a - taps[:, None, :]          # [T, K, 3]
    divisible = (torch.remainder(numer, stride_a) == 0).all(-1)
    in_zyx = torch.div(numer, stride_a, rounding_mode='floor')
    ok = orig_valid[None, :] & divisible & \
        ((in_zyx >= 0) & (in_zyx < bound)).all(-1)
    t, k_out = ok.shape
    b = co[None, :, :1].expand(t, k_out, 1)
    qkeys = pack_keys(torch.cat([b, in_zyx], -1).reshape(t * k_out, 4),
                      st.spatial_shape, st.batch_size, ok.reshape(-1))
    pos = torch.searchsorted(st.keys, qkeys)
    pos = torch.clamp(pos, max=st.keys.shape[0] - 1)
    hit = (st.keys[pos] == qkeys) & (qkeys != INT_MAX)
    return torch.where(hit, pos, -1).reshape(t, k_out)


def inverse_conv(st: SparseTensor, weights, orig_keys, orig_coords,
                 orig_valid, orig_spatial_shape, kernel_size, stride,
                 padding, bias=None) -> SparseTensor:
    """Transposed ("inverse") sparse conv of ``st`` back onto a stored fine
    coordinate set (spconv's ``SparseInverseConv3d``, which pairs the sets
    through its ``indice_key``; here the caller passes the set): output row
    o sums, over the taps, ``feats[rows[t, o]] @ weights[t]`` with the rows
    of ``inverse_rows``. weights [T, Cin, Cout]. The JAX package runs this
    as a lookup and its XLA ``gather_gemm``, outside any Pallas kernel; so
    does the port, with a gather and one ``torch.matmul`` per tap (missing
    rows gather a zero row)."""
    rows = inverse_rows(st, orig_coords, orig_valid, kernel_size, stride,
                        padding)
    feats = st.features
    k_in = feats.shape[0]
    feats_z = torch.cat([feats, feats.new_zeros(1, feats.shape[1])])
    rows = torch.where(rows < 0, k_in, rows)
    out = None
    for t in range(rows.shape[0]):
        # index_select, whose backward adds each row's gradient where it
        # came from: an indexed gather's backward sorts its indices and
        # sums each run of one index in turn, and the missing taps' zero
        # row is most of them (PERF.md, the Part-A2 step)
        part = torch.matmul(feats_z.index_select(0, rows[t]), weights[t])
        out = part if out is None else out + part
    if bias is not None:
        out = out + bias
    out = torch.where(orig_valid[:, None], out, 0.0)
    return SparseTensor(features=out, coords=orig_coords, valid=orig_valid,
                        keys=orig_keys, spatial_shape=tuple(orig_spatial_shape),
                        batch_size=st.batch_size)
