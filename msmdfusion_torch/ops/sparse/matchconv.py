"""Rulebook plans and the sparse-conv kernels' wrappers.

Counterpart of the plan layer and conv entry points of the JAX package's
``ops/sparse/matchconv.py``. A plan holds, for every output row ``r`` and
tap ``t`` of a conv, the query key ``okeys[r] + dkey[t]`` in affine form
and the in-bounds mask ``inb[r, t]``. ``attach_rows`` turns it into the
rulebook ``rows [K_out, Ta]`` (matched input row, -1 = miss) once per
``indice_key``; every conv on that coordinate set then runs as a
gather-GEMM over the same rows.

Two hand-written CUDA kernels carry this path (``csrc/``):

- ``rows_affine``: the rulebook rows, replacing ``_win_rows_kernel``;
- ``gather_gemm_conv``: the conv with its fused BN/ReLU/mask epilogue,
  replacing ``_vgather_kernel`` (forward, fp32).

Each wrapper launches its kernel for a CUDA tensor, raising if the build
or the launch fails, and runs its plain PyTorch version for a CPU tensor
(or inside ``kernels.plain_kernels()``). The TPU plan's slab brackets,
column windows, duplicated sublanes and bf16 splits have no counterpart:
a binary search never drops a match.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ... import kernels
from ...kernels import check_tensor
from ...utils import overflow
from .conv import kernel_offsets, triple
from .tensor import INT_MAX, SparseTensor


@dataclasses.dataclass(frozen=True)
class MatchPlan:
    """Per-coordinate-set conv plan (the counterpart of a spconv rulebook).

    query[r, t] = okeys[r] + dkey[t] on rows where ``inb[r, t]`` holds;
    ``rows`` is the matched input row of each query (``attach_rows``).
    """
    okeys: torch.Tensor            # [K_out] int32, INT_MAX on invalid rows
    dkey: torch.Tensor             # [Ta] int32 key offset of each tap
    inb: torch.Tensor              # [K_out, Ta] bool: tap in bounds, row valid
    rows: Optional[torch.Tensor] = None   # [K_out, Ta] int32, -1 = miss

    @property
    def k_out(self) -> int:
        return self.okeys.shape[0]

    @property
    def num_taps(self) -> int:
        return self.inb.shape[1]


def _axis_ok(c, kdim: int, lim: int, centred: bool):
    d = torch.arange(kdim, device=c.device)
    if centred:
        d = d - kdim // 2
    v = c[:, None] + d[None, :]
    return (v >= 0) & (v < lim)


def _inb(base, kernel_size, spatial_shape, valid, centred: bool):
    kz, ky, kx = triple(kernel_size)
    z, y, x = spatial_shape
    okz = _axis_ok(base[:, 0], kz, z, centred)
    oky = _axis_ok(base[:, 1], ky, y, centred)
    okx = _axis_ok(base[:, 2], kx, x, centred)
    inb = (okz[:, :, None, None] & oky[:, None, :, None]
           & okx[:, None, None, :]).reshape(base.shape[0], -1)
    return inb & valid[:, None]


def build_subm_plan(st: SparseTensor, kernel_size) -> MatchPlan:
    """Plan for a submanifold conv (output coords == input coords)."""
    offs = kernel_offsets(kernel_size)
    z, y, x = st.spatial_shape
    dkey = offs[:, 0] * (y * x) + offs[:, 1] * x + offs[:, 2]
    inb = _inb(st.coords[:, 1:].to(torch.int64), kernel_size,
               st.spatial_shape, st.valid, centred=True)
    return MatchPlan(okeys=st.keys,
                     dkey=torch.as_tensor(dkey, dtype=torch.int32,
                                          device=st.keys.device),
                     inb=inb)


def build_downsample_plan(st: SparseTensor, out_coords, out_valid,
                          kernel_size, stride, padding) -> MatchPlan:
    """Plan for a strided conv onto a precomputed output coordinate set:
    output o gathers the input at ``o*stride - pad + tap``."""
    kz, ky, kx = triple(kernel_size)
    taps = kernel_offsets(kernel_size) + \
        np.array([kz // 2, ky // 2, kx // 2], np.int32)
    s = torch.tensor(triple(stride), device=out_coords.device)
    p = torch.tensor(triple(padding), device=out_coords.device)
    z, y, x = st.spatial_shape
    oc = out_coords.to(torch.int64)
    base = oc[:, 1:] * s - p                                   # [K, 3]
    inb = _inb(base, kernel_size, st.spatial_shape, out_valid,
               centred=False)
    base_key = (oc[:, 0] * z + base[:, 0]) * y * x + base[:, 1] * x \
        + base[:, 2]
    dkey = taps[:, 0] * (y * x) + taps[:, 1] * x + taps[:, 2]
    okeys = torch.where(out_valid, base_key, INT_MAX).to(torch.int32)
    return MatchPlan(okeys=okeys,
                     dkey=torch.as_tensor(dkey, dtype=torch.int32,
                                          device=okeys.device),
                     inb=inb)


# ---------------------------------------------------------------------------
# kernel A: rulebook rows
# ---------------------------------------------------------------------------

def rows_affine_plain(in_keys, okeys, dkey, inb) -> torch.Tensor:
    """Plain version of ``rows_affine``: searchsorted over the sorted keys
    (the JAX package's ``_rows_from_plan(...).T``)."""
    keys64 = in_keys.to(torch.int64)
    q = okeys.to(torch.int64)[:, None] + dkey.to(torch.int64)[None, :]
    pos = torch.searchsorted(keys64, q)
    pos = torch.clamp(pos, max=in_keys.shape[0] - 1)
    hit = (keys64[pos] == q) & inb & (okeys != INT_MAX)[:, None]
    return torch.where(hit, pos, -1).to(torch.int32)


def rows_affine(in_keys, okeys, dkey, inb) -> torch.Tensor:
    """rows [K_out, Ta] int32: the row i with ``in_keys[i] == okeys[r] +
    dkey[t]`` where ``inb[r, t]`` holds and ``okeys[r] != INT_MAX``, else
    -1. ``in_keys`` [K_in] int32 ascending with an INT_MAX tail."""
    dev = in_keys.device
    check_tensor('in_keys', in_keys, torch.int32, 1, dev)
    check_tensor('okeys', okeys, torch.int32, 1, dev)
    check_tensor('dkey', dkey, torch.int32, 1, dev)
    check_tensor('inb', inb, torch.bool, 2, dev)
    k_out, ta = inb.shape
    if okeys.shape[0] != k_out or dkey.shape[0] != ta:
        raise ValueError(f'shape mismatch: okeys {tuple(okeys.shape)}, '
                         f'dkey {tuple(dkey.shape)}, inb {tuple(inb.shape)}')
    if not kernels.use_kernel(in_keys):
        return rows_affine_plain(in_keys, okeys, dkey, inb)
    fn = kernels.entry_point('rows_affine')
    rows = torch.empty((k_out, ta), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        kernels.check('rows_affine', fn(
            in_keys.data_ptr(), in_keys.shape[0], okeys.data_ptr(), k_out,
            dkey.data_ptr(), ta, inb.data_ptr(), rows.data_ptr(), stream))
    kernels.launches['rows_affine'] += 1
    return rows


def attach_rows(in_keys, plan: MatchPlan, site: str = '') -> MatchPlan:
    """The plan with its rulebook rows (once per indice_key)."""
    rows = rows_affine(in_keys, plan.okeys, plan.dkey, plan.inb)
    # the TPU kernels' slab and column-window sites: a binary search has
    # neither window, so nothing is ever dropped there
    tag = f'[{site}]' if site else ''
    overflow.record('matchconv.rows_slab', 0)
    overflow.record(f'matchconv.col_w{tag}', 0)
    return dataclasses.replace(plan, rows=rows)


# ---------------------------------------------------------------------------
# kernel B: gather-GEMM conv with the inference epilogue
# ---------------------------------------------------------------------------

def apply_epilogue(out, out_valid=None, scale=None, shift=None,
                   relu: bool = False):
    """affine, then ReLU, then zero the rows that are not ``out_valid``."""
    if scale is not None:
        out = out * scale
    if shift is not None:
        out = out + shift
    if relu:
        out = torch.clamp(out, min=0.0)
    if out_valid is not None:
        out = torch.where(out_valid[:, None], out, 0.0)
    return out


def gather_gemm_conv_plain(feats, rows, weights, scale=None, shift=None,
                           relu: bool = False, out_valid=None):
    """Plain version of ``gather_gemm_conv``: per-tap index_select + matmul."""
    k_out, ta = rows.shape
    out = feats.new_zeros((k_out, weights.shape[2]))
    for t in range(ta):
        r = rows[:, t]
        hit = (r >= 0)[:, None]
        g = feats.index_select(0, torch.clamp(r, min=0).to(torch.int64))
        out = out + torch.where(hit, g, 0.0) @ weights[t]
    return apply_epilogue(out, out_valid, scale, shift, relu)


def gather_gemm_conv(feats, rows, weights, scale=None, shift=None,
                     relu: bool = False, out_valid=None) -> torch.Tensor:
    """out [K_out, Cout] = epi(sum_t feats[rows[:, t]] @ weights[t]), fp32.

    feats [K_in, Cin] f32; rows [K_out, Ta] int32 (-1 = miss); weights
    [Ta, Cin, Cout] f32; scale/shift [Cout] f32; out_valid [K_out] bool.
    """
    dev = feats.device
    check_tensor('feats', feats, torch.float32, 2, dev)
    check_tensor('rows', rows, torch.int32, 2, dev)
    check_tensor('weights', weights, torch.float32, 3, dev)
    k_out, ta = rows.shape
    cin, cout = weights.shape[1], weights.shape[2]
    if weights.shape[0] != ta or feats.shape[1] != cin:
        raise ValueError(f'shape mismatch: feats {tuple(feats.shape)}, rows '
                         f'{tuple(rows.shape)}, weights {tuple(weights.shape)}')
    for name, v in (('scale', scale), ('shift', shift)):
        if v is not None:
            check_tensor(name, v, torch.float32, 1, dev)
            if v.shape[0] != cout:
                raise ValueError(f'{name}: expected [{cout}]')
    if out_valid is not None:
        check_tensor('out_valid', out_valid, torch.bool, 1, dev)
        if out_valid.shape[0] != k_out:
            raise ValueError(f'out_valid: expected [{k_out}]')
    if not kernels.use_kernel(feats):
        return gather_gemm_conv_plain(feats, rows, weights, scale, shift,
                                      relu, out_valid)
    fn = kernels.entry_point('gather_gemm_conv')
    out = torch.empty((k_out, cout), dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        kernels.check('gather_gemm_conv', fn(
            feats.data_ptr(), cin, rows.data_ptr(), k_out, ta,
            weights.data_ptr(), cout, ptr(scale), ptr(shift), int(relu),
            ptr(out_valid), out.data_ptr(), stream))
    kernels.launches['gather_gemm_conv'] += 1
    return out


def apply_match_conv(st: SparseTensor, plan: MatchPlan, weights, out_coords,
                     out_valid, out_keys, out_spatial_shape, bias=None,
                     scale=None, shift=None, relu: bool = False
                     ) -> SparseTensor:
    """Run a planned conv (weights [Ta, Cin, Cout]) and wrap the result.

    ``scale``/``shift``/``relu`` request the fused inference epilogue. A
    bias under an affine enters the shift pre-scaled: (conv + bias) *
    scale + shift.
    """
    if plan.rows is None:
        raise ValueError('plan has no rows: call attach_rows first')
    if bias is not None:
        b_eff = bias * scale if scale is not None else bias
        shift = b_eff if shift is None else shift + b_eff
    out = gather_gemm_conv(st.features, plan.rows, weights, scale=scale,
                           shift=shift, relu=relu, out_valid=out_valid)
    return SparseTensor(features=out, coords=out_coords, valid=out_valid,
                        keys=out_keys,
                        spatial_shape=tuple(out_spatial_shape),
                        batch_size=st.batch_size)
