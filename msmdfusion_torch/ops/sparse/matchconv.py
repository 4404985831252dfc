"""Rulebook plans, the sparse-conv kernels' wrappers and the conv's autograd.

Counterpart of the plan layer, conv entry points and custom VJP of the JAX
package's ``ops/sparse/matchconv.py``. A plan holds, for every output row
``r`` and tap ``t`` of a conv, a query key and the in-bounds mask
``inb[r, t]``: in affine form ``okeys[r] + dkey[t]`` (submanifold and
downsample plans), or explicit ``queries [K, Ta]`` (the transpose, "dual",
plans of strided convs). ``attach_rows`` turns it into the rulebook ``rows
[K_out, Ta]`` (matched input row, -1 = miss) once per ``indice_key``;
every conv on that coordinate set then runs as a gather-GEMM over the same
rows.

Four hand-written CUDA kernels carry this path (``csrc/``):

- ``rows_affine``: the rulebook rows of affine plans, replacing
  ``_win_rows_kernel``;
- ``rows_queries``: the rows of explicit-query plans, replacing
  ``_rows_kernel``;
- ``gather_gemm_conv``: the conv with its fused BN/ReLU/mask epilogue,
  replacing ``_vgather_kernel`` (forward, fp32); the training backward
  runs it again over the dual rows for the input gradient;
- ``conv_dw``: the weight gradient, replacing ``_vgather_kernel``'s
  ``with_dw`` accumulator.

Each wrapper launches its kernel for a CUDA tensor, raising if the build
or the launch fails, and runs its plain PyTorch version for a CPU tensor
(or inside ``kernels.plain_kernels()``). The TPU plan's slab brackets,
column windows, duplicated sublanes and bf16 splits have no counterpart:
a binary search never drops a match.
"""
from __future__ import annotations

import dataclasses
import math
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

    Affine form: query[r, t] = okeys[r] + dkey[t]; explicit form:
    ``queries[r, t]``. Either way only where ``inb[r, t]`` holds; ``rows``
    is the matched input row of each query (``attach_rows``). A strided
    plan built for training carries its transpose ``dual``, whose rows
    index the conv's output coordinate set.
    """
    inb: torch.Tensor              # [K_out, Ta] bool: tap in bounds, row valid
    okeys: Optional[torch.Tensor] = None   # [K_out] int32, INT_MAX invalid
    dkey: Optional[torch.Tensor] = None    # [Ta] int32 key offset per tap
    queries: Optional[torch.Tensor] = None  # [K_out, Ta] int32
    rows: Optional[torch.Tensor] = None   # [K_out, Ta] int32, -1 = miss
    # centre-symmetric taps (dkey[Ta-1-t] == -dkey[t]): the plan is its own
    # transpose, with tap u <-> Ta-1-u
    self_transpose: bool = False
    dual: Optional['MatchPlan'] = None

    @property
    def k_out(self) -> int:
        return self.inb.shape[0]

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
    return MatchPlan(inb=inb, okeys=st.keys,
                     dkey=torch.as_tensor(dkey, dtype=torch.int32,
                                          device=st.keys.device),
                     self_transpose=bool(np.array_equal(dkey, -dkey[::-1])))


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
    return MatchPlan(inb=inb, okeys=okeys,
                     dkey=torch.as_tensor(dkey, dtype=torch.int32,
                                          device=okeys.device))


def lex_floor_key(batch, o_zyx, ex, out_shape):
    """Monotone packed queries for stride-divided coordinate maps (the JAX
    package's ``_lex_floor_key``).

    On matchable rows (every axis exactly divisible and in bounds) the
    packed key of ``o_zyx`` itself; elsewhere a surrogate that keeps the
    queries of each tap ascending with the row: walking z -> y -> x, the
    first axis that is not clean decides (inexact or above bounds: clamp it
    and saturate the lower axes high; below bounds: saturate them low and
    subtract 1). ``inb`` masks every surrogate, so the rows do not depend
    on it; it keeps the JAX package's query values.

    batch [K]; o_zyx [K, Ta, 3] floor-divided coords; ex [K, Ta, 3]
    per-axis divisibility; out_shape (oz, oy, ox).
    """
    dz, dy, dx = out_shape
    oz, oy, ox = o_zyx[..., 0], o_zyx[..., 1], o_zyx[..., 2]
    cz = ex[..., 0] & (oz >= 0) & (oz < dz)
    cy = ex[..., 1] & (oy >= 0) & (oy < dy)
    lz, ly, lx = oz < 0, oy < 0, ox < 0
    oy_eff = torch.where(cz, torch.clamp(oy, 0, dy - 1),
                         torch.where(lz, 0, dy - 1))
    ox_eff = torch.where(cz & cy, torch.clamp(ox, 0, dx - 1),
                         torch.where(lz | (cz & ly), 0, dx - 1))
    minus1 = (lz | (cz & ly) | (cz & cy & lx)).to(o_zyx.dtype)
    return ((batch[:, None] * dz + torch.clamp(oz, 0, dz - 1)) * dy
            + oy_eff) * dx + ox_eff - minus1


def build_dual_down_plan(st: SparseTensor, out_shape, kernel_size, stride,
                         padding) -> MatchPlan:
    """Transpose plan of a strided conv, for the training backward.

    The backward of ``out[o] += in[i] @ W[t]`` over the pairs with ``i =
    o*stride - pad + tap_t`` is ``d_in[i] += g[o] @ W[t]^T`` over the same
    pairs: a conv over the output coordinate set evaluated at the input
    rows. Input row i queries the output key at ``o = (i + pad - tap_t) /
    stride`` where every axis divides. Taps are enumerated reversed (dual
    tap u <-> forward tap Ta-1-u), the correspondence of the submanifold
    plans, so the backward applies ``weights.flip(0).transpose(1, 2)``
    either way. Its rows are matched against the strided conv's output
    keys (``attach_rows(out_keys, dual)``).
    """
    kz, ky, kx = triple(kernel_size)
    taps = (kernel_offsets(kernel_size)
            + np.array([kz // 2, ky // 2, kx // 2], np.int32))[::-1].copy()
    dev = st.coords.device
    s = torch.tensor(triple(stride), device=dev)
    p = torch.tensor(triple(padding), device=dev)
    oz, oy, ox = (int(v) for v in out_shape)
    numer = st.coords[:, None, 1:].to(torch.int64) + p - \
        torch.as_tensor(taps, dtype=torch.int64, device=dev)[None]
    ex = torch.remainder(numer, s) == 0
    o_zyx = torch.div(numer, s, rounding_mode='floor')
    lim = torch.tensor([oz, oy, ox], device=dev)
    inb = st.valid[:, None] & ex.all(-1) & \
        ((o_zyx >= 0) & (o_zyx < lim)).all(-1)
    queries = lex_floor_key(st.coords[:, 0].to(torch.int64), o_zyx, ex,
                            (oz, oy, ox))
    queries = torch.where(st.valid[:, None], queries, INT_MAX)
    return MatchPlan(inb=inb, queries=queries.to(torch.int32))


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


def rows_queries_plain(in_keys, queries, inb) -> torch.Tensor:
    """Plain version of ``rows_queries``: searchsorted over the sorted keys
    (the JAX package's ``_rows_from_plan(...).T``)."""
    pos = torch.searchsorted(in_keys, queries)
    pos = torch.clamp(pos, max=in_keys.shape[0] - 1)
    hit = (in_keys[pos] == queries) & inb & (queries != INT_MAX)
    return torch.where(hit, pos, -1).to(torch.int32)


def rows_queries(in_keys, queries, inb) -> torch.Tensor:
    """rows [K, Ta] int32: the row i with ``in_keys[i] == queries[r, t]``
    where ``inb[r, t]`` holds and the query is not INT_MAX, else -1.
    ``in_keys`` [K_in] int32 ascending with an INT_MAX tail."""
    dev = in_keys.device
    check_tensor('in_keys', in_keys, torch.int32, 1, dev)
    check_tensor('queries', queries, torch.int32, 2, dev)
    check_tensor('inb', inb, torch.bool, 2, dev)
    if queries.shape != inb.shape:
        raise ValueError(f'shape mismatch: queries {tuple(queries.shape)}, '
                         f'inb {tuple(inb.shape)}')
    if not kernels.use_kernel(in_keys):
        return rows_queries_plain(in_keys, queries, inb)
    k, ta = queries.shape
    fn = kernels.entry_point('rows_queries')
    rows = torch.empty((k, ta), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        kernels.check('rows_queries', fn(
            in_keys.data_ptr(), in_keys.shape[0], queries.data_ptr(), k, ta,
            inb.data_ptr(), rows.data_ptr(), stream))
    kernels.launches['rows_queries'] += 1
    return rows


def attach_rows(in_keys, plan: MatchPlan, site: str = '') -> MatchPlan:
    """The plan with its rulebook rows (once per indice_key): kernel
    ``rows_affine`` for an affine plan, ``rows_queries`` for explicit
    queries."""
    if plan.queries is not None:
        rows = rows_queries(in_keys, plan.queries, plan.inb)
    else:
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


# ---------------------------------------------------------------------------
# kernel D: the weight gradient
# ---------------------------------------------------------------------------

def conv_dw_plain(feats, rows, g) -> torch.Tensor:
    """Plain version of ``conv_dw``: per-tap index_select and product."""
    k_out, ta = rows.shape
    dw = feats.new_empty((ta, feats.shape[1], g.shape[1]))
    for t in range(ta):
        r = rows[:, t]
        gath = feats.index_select(0, torch.clamp(r, min=0).to(torch.int64))
        dw[t] = torch.where((r >= 0)[:, None], gath, 0.0).T @ g
    return dw


def conv_dw_launch(k_out: int, ta: int, cin: int, cout: int):
    """(tile, n_chunks, chunk_rows) of a ``conv_dw`` launch: the widest
    (Cin, Cout) tile the narrower width fills, and enough chunks of the
    rows (each at least 1024) for ~8 blocks per SM of an H100. A function
    of the shapes only, so the order of the sums is the same on every
    run."""
    narrow = min(cin, cout)
    tile = 64 if narrow >= 64 else 32 if narrow >= 32 else 16
    blocks = ta * math.ceil(cin / tile) * math.ceil(cout / tile)
    n_chunks = max(1, min(math.ceil(8 * 132 / blocks),
                          math.ceil(k_out / 1024)))
    chunk_rows = max(1, math.ceil(k_out / n_chunks))
    return tile, math.ceil(k_out / chunk_rows) if k_out else 1, chunk_rows


def conv_dw(feats, rows, g) -> torch.Tensor:
    """dw [Ta, Cin, Cout] = sum_o feats[rows[o, t]]^T (x) g[o], fp32, the
    weight gradient of ``gather_gemm_conv(feats, rows, w)`` under the
    output gradient ``g`` [K_out, Cout]. The sum over the rows runs in a
    fixed order (per-chunk partials, then their sum in chunk order), so
    repeated calls give the same bits."""
    dev = feats.device
    check_tensor('feats', feats, torch.float32, 2, dev)
    check_tensor('rows', rows, torch.int32, 2, dev)
    check_tensor('g', g, torch.float32, 2, dev)
    k_out, ta = rows.shape
    cin, cout = feats.shape[1], g.shape[1]
    if g.shape[0] != k_out:
        raise ValueError(f'shape mismatch: rows {tuple(rows.shape)}, g '
                         f'{tuple(g.shape)}')
    if not kernels.use_kernel(feats):
        return conv_dw_plain(feats, rows, g)
    tile, n_chunks, chunk_rows = conv_dw_launch(k_out, ta, cin, cout)
    dw = torch.empty((ta, cin, cout), dtype=torch.float32, device=dev)
    partials = (torch.empty((n_chunks, ta, cin, cout), dtype=torch.float32,
                            device=dev) if n_chunks > 1 else None)
    fn = kernels.entry_point('conv_dw')
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        kernels.check('conv_dw', fn(
            feats.data_ptr(), cin, rows.data_ptr(), k_out, ta, g.data_ptr(),
            cout, tile, n_chunks, chunk_rows,
            None if partials is None else partials.data_ptr(),
            dw.data_ptr(), stream))
    kernels.launches['conv_dw'] += 1
    return dw


class MatchConv(torch.autograd.Function):
    """``gather_gemm_conv(feats, plan.rows, weights)`` with the training
    backward of the JAX package's ``match_conv`` custom VJP:

    - ``d_feats``: the same gather-GEMM kernel over the transpose plan's
      rows with the weights tap-flipped and transposed (a submanifold plan
      is its own transpose; a strided plan carries its ``dual``), only
      when the features need a gradient;
    - ``d_weights``: kernel ``conv_dw`` over the forward rows.
    """

    @staticmethod
    def forward(ctx, feats, weights, plan: MatchPlan):
        ctx.plan = plan
        ctx.save_for_backward(feats, weights)
        return gather_gemm_conv(feats, plan.rows, weights)

    @staticmethod
    def backward(ctx, g):
        feats, weights = ctx.saved_tensors
        plan = ctx.plan
        g = g.contiguous()
        d_feats = d_weights = None
        if ctx.needs_input_grad[0]:
            d_feats = gather_gemm_conv(
                g, dual_rows(plan), weights.flip(0).transpose(1, 2)
                .contiguous())
        if ctx.needs_input_grad[1]:
            d_weights = conv_dw(feats, plan.rows, g)
        return d_feats, d_weights, None


def dual_rows(plan: MatchPlan) -> torch.Tensor:
    """Rows of the plan's transpose: the plan's own for a submanifold plan
    with centre-symmetric taps, else those of its attached ``dual``."""
    if plan.self_transpose:
        return plan.rows
    if plan.dual is None or plan.dual.rows is None:
        raise ValueError('a strided plan has no dual rows: build the conv '
                         'in training mode')
    return plan.dual.rows


def apply_match_conv(st: SparseTensor, plan: MatchPlan, weights, out_coords,
                     out_valid, out_keys, out_spatial_shape, bias=None,
                     scale=None, shift=None, relu: bool = False
                     ) -> SparseTensor:
    """Run a planned conv (weights [Ta, Cin, Cout]) and wrap the result.

    ``scale``/``shift``/``relu`` request the fused inference epilogue (not
    differentiable); a bias under an affine enters the shift pre-scaled:
    (conv + bias) * scale + shift. Without them the conv runs through
    ``MatchConv`` (differentiable) and a bias lands on the ``out_valid``
    rows only.
    """
    if plan.rows is None:
        raise ValueError('plan has no rows: call attach_rows first')
    if scale is not None or shift is not None or relu:
        if bias is not None:
            b_eff = bias * scale if scale is not None else bias
            shift = b_eff if shift is None else shift + b_eff
        out = gather_gemm_conv(st.features, plan.rows, weights, scale=scale,
                               shift=shift, relu=relu, out_valid=out_valid)
    else:
        out = MatchConv.apply(st.features, weights, plan)
        if bias is not None:
            out = torch.where(out_valid[:, None], out + bias, 0.0)
    return SparseTensor(features=out, coords=out_coords, valid=out_valid,
                        keys=out_keys,
                        spatial_shape=tuple(out_spatial_shape),
                        batch_size=st.batch_size)
