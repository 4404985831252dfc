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

Three switches, read from the environment at call time with the JAX
package's names, values and defaults, pick the engine:

- ``MSMD_CONV_ALGO`` (``conv_algo()``): ``vgather`` (default), the
  rulebook engine above; ``onehot``, the one-hot engine, which stores no
  rulebook: every conv searches its plan's queries in the input keys
  itself (``match_conv``), forward and training backward alike;
- ``MSMD_CONV_DTYPE`` (``conv_dtype()``): ``float32`` (default) or
  ``bfloat16``, the JAX package's packed mode (its benchmarked setting):
  the rulebook engine's forward and input gradient round the features and
  the weights to bf16 and multiply on the tensor cores with fp32 sums,
  and its weight gradient rounds both operands to bf16. The one-hot
  engine ignores it, as the JAX package's ``_pallas_conv`` does;
- ``MSMD_CONV_GEMM`` (``gemm_mode()``), the fp32 convs' product on the
  card: ``x3`` (default), both operands split into bf16 hi + lo and three
  tensor-core products with fp32 sums (hi.hi + hi.lo + lo.hi, ~2^-17 of
  each sum's magnitude from the exact product), or ``highest``, the exact
  fp32 product (FFMA). It picks the fp32 rulebook engine's conv and weight
  gradient, and the one-hot engine's conv (forward and input gradient);
  the packed engine ignores it, and the one-hot weight gradient stays
  exact, as the JAX package's ``_dw_from_rows`` is (the JAX one-hot
  kernel does not read it: it takes a ``HIGHEST`` or an x3 weight product
  per conv by VMEM fit, both in the ~2^-16 class of its hi/lo gather).
  The plain versions, which a CPU tensor takes, compute the exact product
  either way, as the JAX package's CPU fallback does.

Any other value raises. The JAX package's TPU layout and engine knobs
(``MSMD_CONV_SLAB``, ``_TILE``, ``_CW``, ``_COLW``,
``_TAILMODE``, ``MSMD_ROWS_MIN_C``, ``MSMD_DENSE_CELLS``,
``MSMD_CONV_BACKEND``) have no counterpart, nor has
``MSMD_OVERFLOW_CHECK``: the port always counts overflow. Two more
switches keep the JAX package's reading (any value but the one that
selects the other path runs the default): ``MSMD_FUSE_BN`` (``fuse_bn()``,
read by the sparse conv blocks in eval mode: '0' runs the conv with no
epilogue, then the batch norm and the ReLU) and ``MSMD_SPARSE_BACKEND``
(``kernels.sparse_backend()``, read by every wrapper: 'xla' runs the
plain versions on the card too).

The convs take fp32 or bf16 features and weights and return the
features' dtype (the JAX package's ``compute_dtype='bfloat16'``, whose
sparse encoder and GMA grouped convs run on bf16 features): bf16 features
go to the one-hot engine's bf16 kernel as they are and are widened to
fp32 for the rulebook engine's kernels, whose result is rounded once to
bf16 after the epilogue.

Hand-written CUDA kernels carry these paths (``csrc/``):

- ``rows_affine``: the rulebook rows of affine plans, replacing
  ``_win_rows_kernel``;
- ``rows_queries``: the rows of explicit-query plans, replacing
  ``_rows_kernel``; both match a tile of output rows inside windows of
  the sorted input keys staged in shared memory; for the packed engine's
  plans either also writes each row's tap-hit mask, the key of the packed
  kernels' row order;
- ``gather_gemm_conv``: the conv with its fused BN/ReLU/mask epilogue,
  replacing ``_vgather_kernel`` (forward, fp32, ``MSMD_CONV_GEMM=
  highest``, exact fp32 FFMA); the training backward runs it again over
  the dual rows for the input gradient;
- ``gather_gemm_conv_bf16`` and ``gather_gemm_conv_x3``: the same conv on
  bf16 tensor cores, replacing ``_vgather_kernel``'s packed mode
  (``mma.sync``, 16-row slices) and its fp32 mode's default ``x3``
  product (``csrc/gather_gemm_conv_x3.cu``: ``wgmma`` on 64-row tiles,
  weights by the TMA unit from ``x3_layout``); they walk the rows in the
  plan's ``RowOrder`` (rows sorted by tap-hit mask; each slice or tile
  stages the OR of its masks), built by ``attach_rows`` beside the rows
  for the sparse conv layers where ``needs_order()``;
- ``conv_dw``, ``conv_dw_bf16`` and ``conv_dw_x3``: the weight gradient,
  replacing ``_vgather_kernel``'s ``with_dw`` accumulator (fp32 exact,
  packed and x3, ``csrc/conv_dw_x3.cu``: ``wgmma``, launch from
  ``conv_dw_x3_launch``); the last two walk the ``RowOrder``'s per-tap
  hit pairs;
- ``match_conv_x3``, ``match_conv`` and ``match_conv_bf16``: the one-hot
  engine's conv, search and product fused, replacing ``_match_kernel``:
  fp32 features on the x3 product (default) or the exact one (FFMA,
  ``MSMD_CONV_GEMM=highest``), bf16 features (its ``parts=1`` mode) on
  the tensor cores against the weights' hi and lo. The exact
  ``match_conv`` shares its body with ``gather_gemm_conv``
  (``csrc/ffma_conv.cuh``, launch from ``ffma_launch``): blocks of 128
  output rows, each tap's hits compacted and multiplied alone, a 16-hit
  slice a warp.

Each wrapper launches its kernel for a CUDA tensor, raising if the build
or the launch fails, and runs its plain PyTorch version for a CPU tensor
(or inside ``kernels.plain_kernels()``). The TPU plan's slab brackets,
column windows and duplicated sublanes have no counterpart:
a key window that overflows the rows kernels' buffer is indexed, never
cut, so no match is ever dropped.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ... import kernels
from ...kernels import check_tensor
from ...utils import overflow
from .conv import kernel_offsets, triple
from .tensor import INT_MAX, SparseTensor


def conv_algo() -> str:
    """``MSMD_CONV_ALGO``: 'vgather' (default, rulebook rows) or 'onehot'
    (queries matched inside the conv kernel)."""
    algo = os.environ.get('MSMD_CONV_ALGO', 'vgather')
    if algo not in ('vgather', 'onehot'):
        raise ValueError(f'MSMD_CONV_ALGO={algo!r}: expected vgather or '
                         'onehot')
    return algo


def conv_dtype() -> str:
    """``MSMD_CONV_DTYPE``: 'float32' (default) or 'bfloat16' (the
    rulebook engine rounds its operands to bf16, fp32 sums)."""
    dtype = os.environ.get('MSMD_CONV_DTYPE', 'float32')
    if dtype not in ('float32', 'bfloat16'):
        raise ValueError(f'MSMD_CONV_DTYPE={dtype!r}: expected float32 or '
                         'bfloat16')
    return dtype


def gemm_mode() -> str:
    """``MSMD_CONV_GEMM``: 'x3' (default: bf16 hi/lo split of both
    operands, three tensor-core products) or 'highest' (the exact fp32
    product), the fp32 rulebook engine's product on the card."""
    mode = os.environ.get('MSMD_CONV_GEMM', 'x3')
    if mode not in ('x3', 'highest'):
        raise ValueError(f'MSMD_CONV_GEMM={mode!r}: expected x3 or highest')
    return mode


def fuse_bn() -> bool:
    """``MSMD_FUSE_BN``: eval-mode batch norm (+ ReLU) folded into the
    conv's epilogue, unless the value is '0' (the JAX package's
    ``fuse_eval_bn``, ``matchconv.py:106-114``)."""
    return os.environ.get('MSMD_FUSE_BN', '1') != '0'


def packed() -> bool:
    """The rulebook engine in bf16 (the JAX package's packed mode)."""
    return conv_algo() == 'vgather' and conv_dtype() == 'bfloat16'


def x3() -> bool:
    """The rulebook engine in fp32 on its default ``x3`` product."""
    return conv_algo() == 'vgather' and conv_dtype() == 'float32' and \
        gemm_mode() == 'x3'


def needs_order() -> bool:
    """The rulebook engine's kernels read each plan's ``RowOrder``: the
    packed and the x3 kernels do, the exact fp32 (``highest``) ones do
    not."""
    return packed() or x3()


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to bf16 (to nearest, ties to even), as fp32."""
    return x.to(torch.bfloat16).to(torch.float32)


def split_hi_lo(x: torch.Tensor):
    """(hi, lo), fp32 tensors of bf16 values: ``hi = bf16(x)``, ``lo =
    bf16(x - hi)`` (the subtraction is exact in fp32), so that ``hi + lo``
    is ``x`` to ~2^-16 of its magnitude: the x3 kernels' split, the JAX
    package's ``_split_hi_lo``."""
    hi = bf16_round(x)
    return hi, bf16_round(x - hi)


GEMMS = ('exact', 'x3')     # the plain versions' products


@dataclasses.dataclass(frozen=True)
class MatchPlan:
    """Per-coordinate-set conv plan (the counterpart of a spconv rulebook).

    Affine form: query[r, t] = okeys[r] + dkey[t]; explicit form:
    ``queries[r, t]``. Either way only where ``inb[r, t]`` holds; ``rows``
    is the matched input row of each query (``attach_rows``; the one-hot
    engine attaches none). A strided plan built for training carries its
    transpose ``dual``, whose queries are matched against the conv's
    output keys ``dual_keys``.
    """
    inb: torch.Tensor              # [K_out, Ta] bool: tap in bounds, row valid
    okeys: Optional[torch.Tensor] = None   # [K_out] int32, INT_MAX invalid
    dkey: Optional[torch.Tensor] = None    # [Ta] int32 key offset per tap
    queries: Optional[torch.Tensor] = None  # [K_out, Ta] int32
    rows: Optional[torch.Tensor] = None   # [K_out, Ta] int32, -1 = miss
    # the tensor-core kernels' walk of ``rows`` (``row_order``; built
    # where ``needs_order()``)
    order: Optional['RowOrder'] = None
    # centre-symmetric taps (dkey[Ta-1-t] == -dkey[t]): the plan is its own
    # transpose, with tap u <-> Ta-1-u
    self_transpose: bool = False
    dual: Optional['MatchPlan'] = None
    dual_keys: Optional[torch.Tensor] = None   # [K_out] int32

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
    if not in_keys.shape[0]:
        return torch.full(q.shape, -1, dtype=torch.int32, device=q.device)
    pos = torch.searchsorted(keys64, q)
    pos = torch.clamp(pos, max=in_keys.shape[0] - 1)
    hit = (keys64[pos] == q) & inb & (okeys != INT_MAX)[:, None]
    return torch.where(hit, pos, -1).to(torch.int32)


MASK_TAPS = 62      # taps a row's int64 mask holds with its sign bit clear


def row_masks(rows) -> torch.Tensor:
    """[K] int64: each row's tap-hit mask, bit t set where ``rows[r, t] >=
    0`` (Ta <= 62): what the rows kernels write beside the rows when asked,
    and the key of ``row_order``'s sort."""
    ta = rows.shape[1]
    if ta > MASK_TAPS:
        raise ValueError(f'{ta} taps: at most {MASK_TAPS} fit the mask')
    return ((rows >= 0).to(torch.int64)
            << torch.arange(ta, device=rows.device)).sum(1)


def _rows_launch(name, dev, k, ta, masks, *args):
    """Launch rows kernel ``name`` (``args`` before its outputs); returns
    rows [k, ta], and their ``row_masks`` from the same launch where
    ``masks``."""
    if masks and ta > MASK_TAPS:
        raise ValueError(f'{ta} taps: at most {MASK_TAPS} fit the mask')
    fn = kernels.entry_point(name)
    rows = torch.empty((k, ta), dtype=torch.int32, device=dev)
    m = torch.empty(k, dtype=torch.int64, device=dev) if masks else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        kernels.check(name, fn(*args, rows.data_ptr(), _ptr(m), stream))
    kernels.launches[name] += 1
    return (rows, m) if masks else rows


def rows_affine(in_keys, okeys, dkey, inb, masks: bool = False):
    """rows [K_out, Ta] int32: the row i with ``in_keys[i] == okeys[r] +
    dkey[t]`` where ``inb[r, t]`` holds and ``okeys[r] != INT_MAX``, else
    -1. ``in_keys`` [K_in] int32 ascending with an INT_MAX tail. With
    ``masks``, (rows, ``row_masks(rows)``), both from the one launch."""
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
        rows = rows_affine_plain(in_keys, okeys, dkey, inb)
        return (rows, row_masks(rows)) if masks else rows
    return _rows_launch('rows_affine', dev, k_out, ta, masks,
                        in_keys.data_ptr(), in_keys.shape[0],
                        okeys.data_ptr(), k_out, dkey.data_ptr(), ta,
                        inb.data_ptr())


def rows_queries_plain(in_keys, queries, inb) -> torch.Tensor:
    """Plain version of ``rows_queries``: searchsorted over the sorted keys
    (the JAX package's ``_rows_from_plan(...).T``)."""
    if not in_keys.shape[0]:
        return torch.full(queries.shape, -1, dtype=torch.int32,
                          device=queries.device)
    pos = torch.searchsorted(in_keys, queries)
    pos = torch.clamp(pos, max=in_keys.shape[0] - 1)
    hit = (in_keys[pos] == queries) & inb & (queries != INT_MAX)
    return torch.where(hit, pos, -1).to(torch.int32)


def rows_queries(in_keys, queries, inb, masks: bool = False):
    """rows [K, Ta] int32: the row i with ``in_keys[i] == queries[r, t]``
    where ``inb[r, t]`` holds and the query is not INT_MAX, else -1.
    ``in_keys`` [K_in] int32 ascending with an INT_MAX tail. With
    ``masks``, (rows, ``row_masks(rows)``), both from the one launch."""
    dev = in_keys.device
    check_tensor('in_keys', in_keys, torch.int32, 1, dev)
    check_tensor('queries', queries, torch.int32, 2, dev)
    check_tensor('inb', inb, torch.bool, 2, dev)
    if queries.shape != inb.shape:
        raise ValueError(f'shape mismatch: queries {tuple(queries.shape)}, '
                         f'inb {tuple(inb.shape)}')
    if not kernels.use_kernel(in_keys):
        rows = rows_queries_plain(in_keys, queries, inb)
        return (rows, row_masks(rows)) if masks else rows
    k, ta = queries.shape
    return _rows_launch('rows_queries', dev, k, ta, masks,
                        in_keys.data_ptr(), in_keys.shape[0],
                        queries.data_ptr(), k, ta, inb.data_ptr())


def plan_rows(in_keys, plan: MatchPlan, masks: bool = False):
    """The plan's rulebook rows: kernel ``rows_affine`` for an affine plan,
    ``rows_queries`` for explicit queries (with ``masks``, rows and their
    ``row_masks``)."""
    if plan.queries is not None:
        return rows_queries(in_keys, plan.queries, plan.inb, masks=masks)
    return rows_affine(in_keys, plan.okeys, plan.dkey, plan.inb,
                       masks=masks)


def plan_rows_plain(in_keys, plan: MatchPlan) -> torch.Tensor:
    """Plain version of ``plan_rows``."""
    if plan.queries is not None:
        return rows_queries_plain(in_keys, plan.queries, plan.inb)
    return rows_affine_plain(in_keys, plan.okeys, plan.dkey, plan.inb)


def attach_rows(in_keys, plan: MatchPlan, site: str = '',
                order: bool = False, pairs: bool = False) -> MatchPlan:
    """The plan with its rulebook rows (once per indice_key); with
    ``order`` (where ``needs_order()``) also with the tensor-core
    kernels' ``row_order`` of them, sorted by the masks the rows kernel
    writes in the same launch (with the weight gradient's pair lists where
    ``pairs``: a training plan's forward rows, not a dual's, which only the
    input gradient's conv reads)."""
    if order:
        rows, masks = plan_rows(in_keys, plan, masks=True)
        walk = row_order(rows, pairs, masks)
    else:
        rows, walk = plan_rows(in_keys, plan), None
    # the TPU kernels' slab and column-window sites: the rows kernels index
    # a window that overflows their buffer instead of cutting it, so
    # nothing is ever dropped there
    tag = f'[{site}]' if site else ''
    overflow.record('matchconv.rows_slab', 0)
    overflow.record(f'matchconv.col_w{tag}', 0)
    return dataclasses.replace(plan, rows=rows, order=walk)


SLICE_ROWS = 16     # rows of an mma.sync tile: the tensor-core convs' skip


@dataclasses.dataclass(frozen=True)
class RowOrder:
    """How the tensor-core kernels (packed bf16 and x3) walk a rulebook
    ``rows [K, Ta]``.

    ``perm[s]`` is the row at sorted position ``s``: the rows stably
    sorted by their tap-hit mask (bit t set where ``rows[r, t] >= 0``), so
    that rows hitting the same taps sit together; ``masks[s]`` is that
    row's mask. A 16-row slice of the conv stages and multiplies the taps
    of the OR of its rows' masks (``slice_masks()``; the kernel ORs them
    itself). The weight gradient's per-tap pair lists, where built: tap
    t's pairs are ``pair_in[p], pair_out[p]`` for ``p`` in ``tap_start[t]
    .. tap_start[t + 1]`` (the input row ``rows[o, t]`` and the output row
    ``o``, ``o`` ascending); ``tap_hits`` their counts on the host. The
    sort and the masks need no host synchronisation; the pair lists do.
    """
    perm: torch.Tensor                          # [K] int64
    masks: torch.Tensor                         # [K] int64, ascending
    pair_in: Optional[torch.Tensor] = None      # [hits] int32
    pair_out: Optional[torch.Tensor] = None     # [hits] int32
    tap_start: Optional[torch.Tensor] = None    # [Ta + 1] int32
    tap_hits: Optional[tuple] = None            # Ta ints

    def slice_masks(self, rows: int = SLICE_ROWS) -> torch.Tensor:
        """[ceil(K / rows)] int64: the OR of the masks of each slice of
        ``rows`` (a power of two) sorted rows: 16, an mma.sync tile, or 64,
        a wgmma one."""
        sliced = torch.nn.functional.pad(
            self.masks, (0, -self.masks.shape[0] % rows))
        sliced = sliced.view(-1, rows)
        while sliced.shape[1] > 1:
            half = sliced.shape[1] // 2
            sliced = sliced[:, :half] | sliced[:, half:]
        return sliced.reshape(-1)


def row_order(rows, pairs: bool = True, masks=None) -> RowOrder:
    """The ``RowOrder`` of rulebook ``rows [K, Ta]`` (Ta <= 62), with the
    pair lists where ``pairs``: plan building, plain PyTorch. ``masks``:
    the rows' ``row_masks``, which the rows kernel writes beside them
    (computed here where not given); then the order is one stable sort,
    and the pairs one ``nonzero`` and the counts' copy to the host."""
    if masks is None:
        masks = row_masks(rows)
    ta = rows.shape[1]
    if masks.shape != rows.shape[:1]:
        raise ValueError(f'{tuple(masks.shape)} masks for rows '
                         f'{tuple(rows.shape)}')
    masks, perm = torch.sort(masks, stable=True)
    order = RowOrder(perm=perm, masks=masks)
    if not pairs:
        return order
    hit = rows >= 0
    t, o = torch.nonzero(hit.t(), as_tuple=True)     # t, then o, ascending
    counts = hit.sum(0)
    start = torch.zeros(ta + 1, dtype=torch.int32, device=rows.device)
    start[1:] = torch.cumsum(counts, 0)
    return dataclasses.replace(
        order, pair_in=rows[o, t].contiguous(), pair_out=o.to(torch.int32),
        tap_start=start, tap_hits=tuple(counts.tolist()))


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


def _check_gemm(gemm: str) -> None:
    if gemm not in GEMMS:
        raise ValueError(f'gemm={gemm!r}: expected one of {GEMMS}')


def _rows_product(feats, rows, weights, gemm: str = 'exact'):
    """sum_t feats[rows[:, t]] @ weights[t] in fp32, per-tap index_select
    and matmul; ``gemm='x3'``: hi.hi + hi.lo + lo.hi of both operands'
    ``split_hi_lo``, one matmul of the bf16-valued fp32 parts per tap
    (products exact, sums in fp32)."""
    _check_gemm(gemm)
    if gemm == 'x3':
        hi, lo = split_hi_lo(feats)
        feats = torch.cat([hi, hi, lo], 1)
        w_hi, w_lo = split_hi_lo(weights)
        weights = torch.cat([w_hi, w_lo, w_hi], 1)
    k_out, ta = rows.shape
    out = feats.new_zeros((k_out, weights.shape[2]))
    for t in range(ta):
        r = rows[:, t]
        hit = (r >= 0)[:, None]
        g = feats.index_select(0, torch.clamp(r, min=0).to(torch.int64))
        out = out + torch.where(hit, g, 0.0) @ weights[t]
    return out


def gather_gemm_conv_plain(feats, rows, weights, scale=None, shift=None,
                           relu: bool = False, out_valid=None, order=None,
                           gemm: str = 'exact'):
    """Plain version of ``gather_gemm_conv``: the exact fp32 product
    (``gemm='exact'``, the ``highest`` kernel's function and the CPU
    path's) or the x3 kernel's (``gemm='x3'``, the operands split as the
    kernel splits them); under ``packed()``, whatever ``gemm``, that of
    ``gather_gemm_conv_bf16``: features and unscaled weights rounded to
    bf16, products and sums in fp32. The epilogue runs on the fp32 sum. It
    sums in row order: ``order`` is taken and not needed."""
    del order
    if packed():
        feats, weights, gemm = bf16_round(feats), bf16_round(weights), \
            'exact'
    return apply_epilogue(_rows_product(feats, rows, weights, gemm),
                          out_valid, scale, shift, relu)


def _check_dtypes(feats, weights) -> torch.dtype:
    """The conv's output dtype, the features': fp32 or bf16 features and
    weights, in any mix."""
    for name, t in (('feats', feats), ('weights', weights)):
        if t.dtype not in MATCH_DTYPES:
            raise TypeError(f'{name}: expected float32 or bfloat16, got '
                            f'{t.dtype}')
    return feats.dtype


def _check_epilogue(dev, k_out, cout, scale, shift, out_valid):
    for name, v in (('scale', scale), ('shift', shift)):
        if v is not None:
            check_tensor(name, v, torch.float32, 1, dev)
            if v.shape[0] != cout:
                raise ValueError(f'{name}: expected [{cout}]')
    if out_valid is not None:
        check_tensor('out_valid', out_valid, torch.bool, 1, dev)
        if out_valid.shape[0] != k_out:
            raise ValueError(f'out_valid: expected [{k_out}]')


def _ptr(t):
    return None if t is None else t.data_ptr()


# output-channel widths the packed conv keeps whole in one block (Cout is
# padded to the next; wider convs take several column blocks of 192)
PACKED_WIDTHS = (16, 32, 64, 80, 96, 128, 192)


def _check_order(name, order: Optional[RowOrder], rows, pairs) -> None:
    """The packed kernel ``name`` needs the plan's order of ``rows`` (with
    the pair lists where ``pairs``): it is built once per plan, never per
    call."""
    if order is None or pairs and order.tap_hits is None:
        raise ValueError(
            f'{name} needs the plan\'s row order of its rows'
            + (' with the pair lists' if pairs else '')
            + ': pass order=row_order(rows) (attach_rows(..., order=True) '
            'builds it with the rows)')
    k, ta = rows.shape
    check_tensor('perm', order.perm, torch.int64, 1, rows.device)
    check_tensor('masks', order.masks, torch.int64, 1, rows.device)
    if (order.perm.shape[0] != k or order.masks.shape[0] != k
            or order.tap_hits is not None and len(order.tap_hits) != ta):
        raise ValueError(f'row order of {order.perm.shape[0]} rows for rows '
                         f'{tuple(rows.shape)}')


def _weights_layout(weights):
    """(wt, np, kc): the weights [Ta, Cin, Cout] as [Ta, Cout padded to np
    (times column blocks), Cin padded to kc] with Cin fastest, fp32; kc,
    the depth of one staged chunk, is 32 where it divides Cin, else 16."""
    _, cin, cout = weights.shape
    np_ = next((w for w in PACKED_WIDTHS if w >= cout), PACKED_WIDTHS[-1])
    kc = 32 if cin % 32 == 0 else 16
    wt = torch.nn.functional.pad(weights.transpose(1, 2),
                                 (0, -cin % kc, 0, -cout % np_))
    return wt, np_, kc


def _as_bf16(x):
    return x.to(torch.bfloat16, memory_format=torch.contiguous_format)


def packed_weights(weights):
    """(wt, np, kc): the weights [Ta, Cin, Cout] rounded to bf16 once, in
    the layout ``gather_gemm_conv_bf16`` stages (``_weights_layout``)."""
    wt, np_, kc = _weights_layout(weights)
    return _as_bf16(wt), np_, kc


def x3_weights(weights):
    """(hi, lo, np, kc): the weights' ``split_hi_lo`` parts as bf16, once
    per call, each in ``packed_weights``' layout: what the one-hot
    tensor-core kernels (``match_conv_x3``, ``match_conv_bf16``) stage
    (the same values in fewer launches: the frame is host-bound)."""
    wt, np_, kc = _weights_layout(weights)
    hi = _as_bf16(wt)
    return hi, _as_bf16(wt - hi.float()), np_, kc


# output-channel widths the x3 conv keeps whole in one block (Cout is
# padded to the next; wider convs take several column blocks of 192)
X3_WIDTHS = (16, 32, 64, 80, 96, 128, 192, 208)
X3_UNIT = 16            # Cin of one unit the x3 conv stages (one k16 step)


def x3_layout(weights):
    """(laid, np, col_blocks): the weights [Ta, Cin, Cout] split once per
    call into their ``split_hi_lo`` parts as bf16, laid out for the bulk
    copies of ``gather_gemm_conv_x3``: Cout padded to np (of
    ``X3_WIDTHS``) times ``col_blocks``, Cin to whole ``X3_UNIT``-deep
    units, zeros in the padding, as [col_blocks][Ta][units][hi, lo][np /
    8][2][8][8]: each unit's columns in groups of 8, each group's two
    8-deep halves of the unit, 8 columns by 8 of Cin each (wgmma's K-major
    core matrices), so that a unit's hi and lo are one contiguous tile."""
    ta, cin, cout = weights.shape
    np_ = next((w for w in X3_WIDTHS if w >= cout), 192)
    col_blocks = math.ceil(cout / np_)
    units = math.ceil(cin / X3_UNIT)
    w = torch.nn.functional.pad(weights, (0, col_blocks * np_ - cout, 0,
                                          units * X3_UNIT - cin))
    hi = w.to(torch.bfloat16)
    parts = torch.stack([hi, (w - hi.float()).to(torch.bfloat16)])
    # [part, Ta, unit, half, k, column block, group, column]
    parts = parts.view(2, ta, units, 2, 8, col_blocks, np_ // 8, 8)
    return (parts.permute(5, 1, 2, 0, 6, 3, 7, 4).contiguous(), np_,
            col_blocks)


def gather_gemm_conv(feats, rows, weights, scale=None, shift=None,
                     relu: bool = False, out_valid=None,
                     order: Optional[RowOrder] = None) -> torch.Tensor:
    """out [K_out, Cout] = epi(sum_t feats[rows[:, t]] @ weights[t]), in
    the features' dtype.

    feats [K_in, Cin] f32 or bf16; rows [K_out, Ta] int32 (-1 = miss);
    weights [Ta, Cin, Cout] f32 or bf16; scale/shift [Cout] f32; out_valid
    [K_out] bool. bf16 operands are widened to fp32 (exactly) and the fp32
    result after the epilogue is rounded once to bf16 where the features
    are bf16, as the JAX kernel's ``acc.astype(o_ref.dtype)``
    (``matchconv.py:1178``): on bf16 features the x3 and exact products
    are exact (their ``lo`` parts are 0) and the packed kernel's rounding
    of its operands changes nothing.
    On the card: the x3 product (kernel ``gather_gemm_conv_x3``, the
    default; the weights laid out once per call by ``x3_layout``), the
    exact fp32 one under ``MSMD_CONV_GEMM=highest`` (kernel
    ``gather_gemm_conv``, at most ``FFMA_MAX_TAPS`` taps; launch from
    ``ffma_launch``), or under ``packed()`` bf16 operands with fp32
    sums (kernel ``gather_gemm_conv_bf16``). The x3 and packed kernels
    walk the rows in ``order``: the plan's ``row_order(rows)``, which the
    sparse conv layers have ``attach_rows`` build where ``needs_order()``;
    a CUDA call without it raises. A CPU tensor takes the plain version's
    exact product (bf16 operands under ``packed()``).
    """
    dev = feats.device
    out_dtype = _check_dtypes(feats, weights)
    feats, weights = feats.float(), weights.float()
    check_tensor('feats', feats, torch.float32, 2, dev)
    check_tensor('rows', rows, torch.int32, 2, dev)
    check_tensor('weights', weights, torch.float32, 3, dev)
    k_out, ta = rows.shape
    cin, cout = weights.shape[1], weights.shape[2]
    if weights.shape[0] != ta or feats.shape[1] != cin:
        raise ValueError(f'shape mismatch: feats {tuple(feats.shape)}, rows '
                         f'{tuple(rows.shape)}, weights {tuple(weights.shape)}')
    _check_epilogue(dev, k_out, cout, scale, shift, out_valid)
    if not kernels.use_kernel(feats):
        return gather_gemm_conv_plain(feats, rows, weights, scale, shift,
                                      relu, out_valid).to(out_dtype)
    out = torch.empty((k_out, cout), dtype=torch.float32, device=dev)
    epilogue = (_ptr(scale), _ptr(shift), int(relu), _ptr(out_valid),
                out.data_ptr())
    if packed() or x3():
        name = 'gather_gemm_conv_bf16' if packed() else 'gather_gemm_conv_x3'
        _check_order(name, order, rows, pairs=False)
        plan_args = (feats.data_ptr(), cin, rows.data_ptr(), k_out, ta,
                     order.perm.data_ptr(), order.masks.data_ptr())
        if packed():
            wt, np_, kc = packed_weights(weights)
            args = (*plan_args, wt.data_ptr(), np_, kc, wt.shape[2], cout,
                    *epilogue)
        else:
            wt, np_, col_blocks = x3_layout(weights)
            args = (*plan_args, wt.data_ptr(), np_, col_blocks, cout,
                    *epilogue)
    else:
        name = 'gather_gemm_conv'
        _check_ffma_taps(ta)
        launch = ffma_launch(cin, cout)
        args = (feats.data_ptr(), cin, rows.data_ptr(), k_out, ta,
                weights.data_ptr(), cout, *launch[:3], *epilogue)
    fn = kernels.entry_point(name)
    with torch.cuda.device(dev):
        kernels.check(name, fn(*args,
                               torch.cuda.current_stream(dev).cuda_stream))
    kernels.launches[name] += 1
    return out.to(out_dtype)


# ---------------------------------------------------------------------------
# kernel C: the one-hot engine's conv (search and product fused)
# ---------------------------------------------------------------------------

def match_conv_plain(feats, in_keys, plan: MatchPlan, weights, scale=None,
                     shift=None, relu: bool = False, out_valid=None,
                     gemm: str = 'exact'):
    """Plain version of ``match_conv``: the plan's rows by searchsorted,
    then the gather-GEMM and the epilogue. fp32 features: the exact product
    (``gemm='exact'``, the ``highest`` kernel's function and the CPU
    path's) or the x3 kernel's (``gemm='x3'``, ``_rows_product``'s split);
    bf16 features, whatever ``gemm``: that of ``match_conv_bf16``, the
    bf16 values against the weights' ``split_hi_lo`` parts (``[f, f] @
    [W_hi; W_lo]``, products exact, sums in fp32), the epilogue in fp32,
    the result rounded once to bf16."""
    rows = plan_rows_plain(in_keys, plan)
    if feats.dtype != torch.bfloat16:
        return apply_epilogue(_rows_product(feats, rows, weights, gemm),
                              out_valid, scale, shift, relu)
    _check_gemm(gemm)
    f = feats.to(torch.float32)
    out = _rows_product(torch.cat([f, f], 1), rows,
                        torch.cat(split_hi_lo(weights), 1))
    return apply_epilogue(out, out_valid, scale, shift,
                          relu).to(torch.bfloat16)


MATCH_DTYPES = (torch.float32, torch.bfloat16)


def match_kernel(dtype=torch.float32) -> str:
    """The kernel ``match_conv`` launches on the card for features of
    ``dtype``: ``match_conv_bf16`` for bf16 (whatever the switches), for
    fp32 by ``gemm_mode()``: ``match_conv_x3`` (x3, the default) or the
    exact FFMA ``match_conv`` (highest)."""
    if dtype not in MATCH_DTYPES:
        raise TypeError(f'match_conv takes float32 or bfloat16 features, '
                        f'not {dtype}')
    if dtype == torch.bfloat16:
        return 'match_conv_bf16'
    return 'match_conv_x3' if gemm_mode() == 'x3' else 'match_conv'


def match_conv(feats, in_keys, plan: MatchPlan, weights, scale=None,
               shift=None, relu: bool = False, out_valid=None) -> torch.Tensor:
    """out [K_out, Cout] = epi(sum_t feats[match(query[r, t])] @ W[t]), in
    the features' dtype (fp32 or bf16).

    The one-hot engine: no rulebook is stored. Each query (``okeys[r] +
    dkey[t]``, or ``queries[r, t]``) where ``inb[r, t]`` holds and the row
    or query is not INT_MAX is searched in ``in_keys`` [K_in] (ascending,
    INT_MAX tail) inside the kernel; a miss adds nothing. feats [K_in,
    Cin] f32 or bf16; weights [Ta, Cin, Cout] f32 or bf16 (widened to
    fp32 exactly, so bf16 weights' ``lo`` part is 0); epilogue as
    ``gather_gemm_conv``, in fp32. On the card (``match_kernel``): fp32
    features on the x3 product (kernel ``match_conv_x3``, the default) or,
    under ``MSMD_CONV_GEMM=highest``, the exact one (kernel
    ``match_conv``, at most ``FFMA_MAX_TAPS`` taps; launch from
    ``ffma_launch``); bf16 features against the weights' hi and lo (kernel
    ``match_conv_bf16``, bf16 out). The tensor-core kernels split the
    weights once per call (``x3_weights``) and order each block's rows by
    tap-hit mask themselves. A CPU tensor takes the plain version: the
    exact product for fp32, the bf16 kernel's for bf16.
    """
    dev = feats.device
    name = match_kernel(feats.dtype)
    _check_dtypes(feats, weights)
    weights = weights.float()
    check_tensor('feats', feats, feats.dtype, 2, dev)
    check_tensor('in_keys', in_keys, torch.int32, 1, dev)
    check_tensor('weights', weights, torch.float32, 3, dev)
    check_tensor('inb', plan.inb, torch.bool, 2, dev)
    k_out, ta = plan.inb.shape
    k_in, cin = feats.shape
    cout = weights.shape[2]
    if plan.queries is not None:
        check_tensor('queries', plan.queries, torch.int32, 2, dev)
        bad = plan.queries.shape != plan.inb.shape
    else:
        check_tensor('okeys', plan.okeys, torch.int32, 1, dev)
        check_tensor('dkey', plan.dkey, torch.int32, 1, dev)
        bad = plan.okeys.shape[0] != k_out or plan.dkey.shape[0] != ta
    if (bad or in_keys.shape[0] != k_in or weights.shape[0] != ta
            or weights.shape[1] != cin):
        raise ValueError(f'shape mismatch: feats {tuple(feats.shape)}, '
                         f'in_keys {tuple(in_keys.shape)}, inb '
                         f'{tuple(plan.inb.shape)}, weights '
                         f'{tuple(weights.shape)}')
    _check_epilogue(dev, k_out, cout, scale, shift, out_valid)
    # the TPU kernel's slab site: a binary search drops nothing
    overflow.record('matchconv.slab', 0)
    if not kernels.use_kernel(feats):
        return match_conv_plain(feats, in_keys, plan, weights, scale, shift,
                                relu, out_valid)
    out = torch.empty((k_out, cout), dtype=feats.dtype, device=dev)
    plan_args = (in_keys.data_ptr(), k_in, _ptr(plan.okeys),
                 _ptr(plan.dkey), _ptr(plan.queries), plan.inb.data_ptr(),
                 k_out, ta)
    epilogue = (_ptr(scale), _ptr(shift), int(relu), _ptr(out_valid))
    if name == 'match_conv':
        _check_ffma_taps(ta)
        args = (feats.data_ptr(), cin, *plan_args, weights.data_ptr(), cout,
                *ffma_launch(cin, cout)[:3], *epilogue, out.data_ptr())
    else:
        hi, lo, np_, kc = x3_weights(weights)
        args = (feats.data_ptr(), cin, *plan_args, hi.data_ptr(),
                lo.data_ptr(), np_, kc, hi.shape[2], cout, *epilogue,
                out.data_ptr())
    fn = kernels.entry_point(name)
    with torch.cuda.device(dev):
        kernels.check(name, fn(*args,
                               torch.cuda.current_stream(dev).cuda_stream))
    kernels.launches[name] += 1
    return out


# ---------------------------------------------------------------------------
# kernel D: the weight gradient
# ---------------------------------------------------------------------------

def conv_dw_plain(feats, rows, g, order=None,
                  gemm: str = 'exact') -> torch.Tensor:
    """Plain version of ``conv_dw``: the exact fp32 product (``gemm=
    'exact'``) or the x3 kernel's (``gemm='x3'``: hi.hi + hi.lo + lo.hi of
    both operands' ``split_hi_lo``, one matmul of the bf16-valued parts
    per tap, products exact, fp32 sums); under ``packed()``, whatever
    ``gemm``, that of ``conv_dw_bf16``: both operands rounded to bf16,
    fp32 sums. Per-tap index_select and product over all rows (``order``
    is not needed)."""
    del order
    _check_gemm(gemm)
    if packed():
        feats, g, gemm = bf16_round(feats), bf16_round(g), 'exact'
    if gemm == 'x3':
        g_hi, g_lo = split_hi_lo(g)
        g = torch.cat([g_hi, g_lo, g_hi], 0)
    k_out, ta = rows.shape
    dw = feats.new_empty((ta, feats.shape[1], g.shape[1]))
    for t in range(ta):
        r = rows[:, t]
        gath = feats.index_select(0, torch.clamp(r, min=0).to(torch.int64))
        x = torch.where((r >= 0)[:, None], gath, 0.0)
        if gemm == 'x3':
            hi, lo = split_hi_lo(x)
            x = torch.cat([hi, hi, lo], 0)
        dw[t] = x.T @ g
    return dw


# SMs of an H100 SXM, which the weight gradients' chunking fills: a
# constant, not the device's count, so that the order of the sums, and so
# the bits of dw, do not depend on the card
H100_SMS = 132
DW_NARROW = 32          # conv_dw's row-streaming design up to this width
DW_STEP = 32            # rows per step of that design
DW_MAX_TAPS = 9         # taps per block of that design, one warp each
DW_SEG = 2048           # rows per compacted segment of the GEMM design
DW_CHUNK = 256          # its chunks are whole multiples of these rows
DW_BK = 16              # hits per stage of the GEMM design
DW_MAX_TILE = 128       # tile edge of the GEMM design


class DwLaunch(NamedTuple):
    """A ``conv_dw`` launch: ``tile_m`` x ``tile_n`` covers (Cin, Cout)
    per block (the row-streaming design: both widths padded to 8, 16 or
    32; the GEMM design: a tile of multiples of 8), ``taps`` per block
    (row streaming: a group, one warp each; GEMM: 1), and the rows cut
    into ``n_chunks`` chunks of ``chunk_rows``, each a whole number of
    the design's steps (32 rows, row streaming; 256, GEMM, whose blocks
    compact a chunk's hits 2048 rows at a time from its first row)."""
    tile_m: int
    tile_n: int
    taps: int
    n_chunks: int
    chunk_rows: int


def dw_narrow(cin: int, cout: int) -> bool:
    """``conv_dw`` streams rows (else: the GEMM design) at these widths."""
    return max(cin, cout) <= DW_NARROW


def dw_tile(width: int) -> int:
    """The GEMM design's tile edge over ``width``: the fewest tiles of at
    most 128, each a multiple of 8 (192 -> 96, 80 -> 80)."""
    n = math.ceil(width / DW_MAX_TILE)
    return 8 * math.ceil(width / n / 8)


def conv_dw_launch(k_out: int, ta: int, cin: int, cout: int) -> DwLaunch:
    """The ``conv_dw`` launch at these shapes: row streaming where both
    widths are at most 32 (taps in the fewest groups of at most 9, each
    width padded to 8, 16 or 32), else the GEMM design's tiles; enough
    chunks of the rows for ~8 blocks per SM of an H100 (row streaming) or
    ~12 (GEMM, whose blocks differ in work by their tap's hits: a subm
    plan's centre tap hits every row, the others a fifth to a third; the
    kernel issues the centre tap's first), each chunk whole steps of 32
    rows or 256-row multiples. A function of the shapes only, so the order
    of the sums is the same on every run."""
    if dw_narrow(cin, cout):
        edge = [8 if w <= 8 else 16 if w <= 16 else 32 for w in (cin, cout)]
        taps = math.ceil(ta / math.ceil(max(ta, 1) / DW_MAX_TAPS))
        blocks, step, deep = math.ceil(ta / max(taps, 1)), DW_STEP, 8
    else:
        edge = [dw_tile(cin), dw_tile(cout)]
        taps = 1
        blocks = ta * math.ceil(cin / edge[0]) * math.ceil(cout / edge[1])
        step, deep = DW_CHUNK, 12
    n_chunks = max(1, min(math.ceil(deep * H100_SMS / max(blocks, 1)),
                          math.ceil(k_out / step)))
    chunk_rows = step * max(1, math.ceil(k_out / n_chunks / step))
    return DwLaunch(edge[0], edge[1], max(taps, 1),
                    max(1, math.ceil(k_out / chunk_rows)), chunk_rows)


FFMA_ROWS = 128         # output rows per block of the exact conv kernels
FFMA_SLICE = 16         # hits a warp multiplies at a time there
FFMA_TILES = (16, 32, 64, 80, 96, 128)  # their register tiles (channels)
FFMA_MAX_TAPS = 64


class FfmaLaunch(NamedTuple):
    """A launch of the exact (FFMA) conv kernels ``gather_gemm_conv`` and
    ``match_conv``: blocks of ``FFMA_ROWS`` output rows by ``col_blocks``
    tiles of ``tile_n`` output channels, held in a register tile of
    ``tile`` channels; the input channels staged ``kc`` at a time."""
    tile: int
    tile_n: int
    kc: int
    col_blocks: int


def ffma_launch(cin: int, cout: int) -> FfmaLaunch:
    """The exact conv kernels' launch at these widths: Cout cut as
    ``dw_tile`` cuts it (the fewest tiles of at most 128, multiples of 8:
    192 as 2 x 96, 80 and 96 whole), each in the narrowest register tile
    that holds it; chunks of 32 input channels where they divide Cin and
    the tile is not 80 or 96 (there two blocks of 16-deep stages share an
    SM), else 16 where those divide Cin, else 8 (Cin 16 stages no padding).
    A function of the shapes only; the order of each output's sums (taps
    ascending, each tap's channels ascending) does not depend on it
    either."""
    tile_n = dw_tile(max(cout, 1))
    tile = next(w for w in FFMA_TILES if w >= tile_n)
    deep = tile not in (80, 96)
    kc = 32 if cin % 32 == 0 and deep else 16 if cin % 16 == 0 else 8
    return FfmaLaunch(tile, tile_n, kc, math.ceil(cout / tile_n))


def _check_ffma_taps(ta: int) -> None:
    if ta > FFMA_MAX_TAPS:
        raise ValueError(f'{ta} taps: the exact conv kernels take at most '
                         f'{FFMA_MAX_TAPS}')


DW_X3_PAIRS = 64        # pairs of one stage of conv_dw_x3
DW_X3_SLAB = 64         # Cin rows of one of its consumer warpgroups
DW_X3_WIDTHS = (16, 32, 48, 64, 80, 96, 128)    # its column blocks
DW_X3_MIN_CHUNK = 256


class DwX3Launch(NamedTuple):
    """A ``conv_dw_x3`` launch: blocks of ``slabs`` ``DW_X3_SLAB``-row
    slabs of Cin (one consumer warpgroup each) by ``nb`` columns of Cout
    (``col_blocks`` of them), each over ``chunk`` pairs of one tap
    (``n_chunks`` chunks in all, tap by tap: ``dw_x3_chunks``)."""
    slabs: int
    nb: int
    col_blocks: int
    chunk: int
    n_chunks: int


def dw_x3_chunk(tap_hits) -> int:
    """Pairs of a ``conv_dw_x3`` chunk: whole ``DW_X3_PAIRS``-pair stages,
    at least ``DW_X3_MIN_CHUNK``, ~4 chunks per SM of an H100 over all
    taps. A function of the plan only."""
    chunk = math.ceil(sum(tap_hits) / (4 * H100_SMS) / DW_X3_PAIRS)
    return max(DW_X3_MIN_CHUNK, chunk * DW_X3_PAIRS)


def conv_dw_x3_launch(tap_hits, cin: int, cout: int) -> DwX3Launch:
    """The ``conv_dw_x3`` launch at these widths and per-tap hit counts:
    all of Cin in one block up to 3 slabs (192 rows), Cout in the fewest
    column blocks of at most 96 columns beside 3 slabs and 128 beside
    fewer (a consumer's running and fresh accumulators must fit its
    registers), each padded to the next of ``DW_X3_WIDTHS``;
    ``dw_x3_chunk`` chunks. A function of the shapes and the plan only, so
    the order of the sums, and the bits of dw, are the same on every
    run."""
    slabs = min(3, math.ceil(cin / DW_X3_SLAB))
    col_blocks = math.ceil(cout / (96 if slabs == 3 else 128))
    nb = next(w for w in DW_X3_WIDTHS if w >= math.ceil(cout / col_blocks))
    chunk = dw_x3_chunk(tap_hits)
    return DwX3Launch(slabs, nb, col_blocks, chunk,
                      sum(math.ceil(n / chunk) for n in tap_hits))


def dw_x3_chunks(tap_hits, chunk: int):
    """[(tap, p0, p1)]: the pairs ``p0 .. p1`` (indices into the order's
    pair lists) of each chunk of a ``conv_dw_x3`` launch, in block order:
    each tap's pairs cut in pieces of ``chunk``, taps ascending (the
    kernel's ``find_chunk``)."""
    out, start = [], 0
    for t, n in enumerate(tap_hits):
        out += [(t, p0, min(p0 + chunk, start + n))
                for p0 in range(start, start + n, chunk)]
        start += n
    return out


DW_CHUNK_STEP = 64      # chunks of conv_dw_bf16 are whole 64-pair stages


def dw_stage_pairs(tile: int) -> int:
    """Pairs of one staged step of ``conv_dw_bf16`` at a tile edge."""
    return 32 if tile == 128 else 64


def conv_dw_bf16_launch(tap_hits, cin: int, cout: int):
    """(tile, chunk_pairs, n_chunks) of a ``conv_dw_bf16`` launch: the
    (Cin, Cout) tile edge, 128 where the narrower width is above 64 (the
    80-128-wide convs in one tile; a 192-wide conv takes 2 x 2 tiles, the
    second half empty), else the widest of 64/32/16 it fills;
    chunks of each tap's pair list, whole 64-pair steps of at least 512
    pairs, sized for ~8 blocks per SM of an H100 over all taps and tiles;
    ``n_chunks`` in all, tap by tap. A function of the shapes and the plan
    only, so the order of the sums is the same on every run."""
    narrow = min(cin, cout)
    tile = next(t for t in (128, 64, 32, 16) if narrow > t // 2 or t == 16)
    tiles = math.ceil(cin / tile) * math.ceil(cout / tile)
    chunk = math.ceil(sum(tap_hits) * tiles / (8 * H100_SMS) / DW_CHUNK_STEP)
    chunk = max(512, chunk * DW_CHUNK_STEP)
    return tile, chunk, sum(math.ceil(n / chunk) for n in tap_hits)


def conv_dw(feats, rows, g, order: Optional[RowOrder] = None) -> torch.Tensor:
    """dw [Ta, Cin, Cout] = sum_o feats[rows[o, t]]^T (x) g[o], fp32, the
    weight gradient of ``gather_gemm_conv(feats, rows, w)`` under the
    output gradient ``g`` [K_out, Cout]. The sum over the rows runs in a
    fixed order (per-chunk partials, then their sum in chunk order), so
    repeated calls give the same bits. On the card: the rulebook engine's
    x3 product by default (kernel ``conv_dw_x3``), bf16 operands under
    ``packed()`` (kernel ``conv_dw_bf16``), both walking each tap's hit
    pairs only: ``order``, the plan's ``row_order(rows)`` with its pair
    lists, which the training layers have ``attach_rows`` build where
    ``needs_order()``; a CUDA call without them raises. The exact fp32
    product (kernel ``conv_dw``) under ``MSMD_CONV_GEMM=highest`` and for
    the one-hot engine, whose rows carry no order. Same fixed-order sums
    throughout. A CPU tensor takes the plain version's exact product
    (bf16 operands under ``packed()``). bf16 features or gradient (the
    bf16-compute train step) are widened to fp32 (exactly) first, as the
    JAX package's ``_pallas_bwd`` widens both for its ``dw``; ``dw`` is
    fp32 either way."""
    dev = feats.device
    for name, t in (('feats', feats), ('g', g)):
        if t.dtype not in MATCH_DTYPES:
            raise TypeError(f'{name}: expected float32 or bfloat16, got '
                            f'{t.dtype}')
    feats, g = feats.float(), g.float()
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
    dw = torch.empty((ta, cin, cout), dtype=torch.float32, device=dev)
    if packed() or x3():
        name = 'conv_dw_bf16' if packed() else 'conv_dw_x3'
        _check_order(name, order, rows, pairs=True)
        launch = (conv_dw_bf16_launch(order.tap_hits, cin, cout) if packed()
                  else conv_dw_x3_launch(order.tap_hits, cin, cout))
        partials = torch.empty((max(launch[-1], 1), cin, cout),
                               dtype=torch.float32, device=dev)
        args = (feats.data_ptr(), cin, g.data_ptr(), cout, ta,
                order.pair_in.data_ptr(), order.pair_out.data_ptr(),
                order.tap_start.data_ptr(), *launch, partials.data_ptr(),
                dw.data_ptr())
    else:
        name = 'conv_dw'
        launch = conv_dw_launch(k_out, ta, cin, cout)
        partials = (torch.empty((launch.n_chunks, ta, cin, cout),
                                dtype=torch.float32, device=dev)
                    if launch.n_chunks > 1 else None)
        args = (feats.data_ptr(), cin, rows.data_ptr(), k_out, ta,
                g.data_ptr(), cout, *launch, _ptr(partials), dw.data_ptr())
    fn = kernels.entry_point(name)
    with torch.cuda.device(dev):
        kernels.check(name, fn(*args,
                               torch.cuda.current_stream(dev).cuda_stream))
    kernels.launches[name] += 1
    return dw


class MatchConv(torch.autograd.Function):
    """The differentiable conv, with the training backward of the JAX
    package's ``match_conv`` custom VJP. Rulebook engine (``in_keys``
    None): ``gather_gemm_conv(feats, plan.rows, weights)``; one-hot engine:
    ``match_conv(feats, in_keys, plan, weights)``. Backward:

    - ``d_feats``: the same conv kernel over the transpose plan with the
      weights tap-flipped and transposed (a submanifold plan is its own
      transpose; a strided plan carries its ``dual``, matched against
      ``dual_keys``), only when the features need a gradient;
    - ``d_weights``: ``conv_dw`` over the forward rows (with the plan's
      order); the one-hot engine builds them here, one
      ``rows_affine``/``rows_queries`` launch per conv, as the JAX
      package's ``_pallas_bwd`` does, and takes the exact product.

    On bf16 features (the bf16-compute train step) the cotangent is bf16
    too: ``d_feats`` is the same conv on it (the one-hot engine's
    ``match_conv_bf16`` over the transpose plan, the rulebook kernels on
    it widened), rounded once to the features' dtype, and ``d_weights``
    the fp32 ``conv_dw`` of the widened operands, returned in the
    weights' dtype (JAX ``_pallas_bwd``, ``matchconv.py:1555-1556``).
    """

    @staticmethod
    def forward(ctx, feats, weights, plan: MatchPlan, in_keys=None):
        ctx.plan, ctx.in_keys = plan, in_keys
        ctx.save_for_backward(feats, weights)
        if in_keys is not None:
            return match_conv(feats, in_keys, plan, weights)
        return gather_gemm_conv(feats, plan.rows, weights, order=plan.order)

    @staticmethod
    def backward(ctx, g):
        feats, weights = ctx.saved_tensors
        plan, in_keys = ctx.plan, ctx.in_keys
        g = g.contiguous()
        d_feats = d_weights = None
        if ctx.needs_input_grad[0]:
            w_t = weights.flip(0).transpose(1, 2).contiguous()
            if in_keys is None:
                d_feats = gather_gemm_conv(g, dual_rows(plan), w_t,
                                           order=dual_order(plan))
            else:
                dual, dual_keys = dual_plan(plan, in_keys)
                d_feats = match_conv(g, dual_keys, dual, w_t)
            d_feats = d_feats.to(feats.dtype)
        if ctx.needs_input_grad[1]:
            rows = plan.rows if in_keys is None else plan_rows(in_keys, plan)
            d_weights = conv_dw(feats, rows, g, order=plan.order).to(
                weights.dtype)
        return d_feats, d_weights, None, None


def dual_plan(plan: MatchPlan, in_keys):
    """(transpose plan, the keys it is matched against): the plan itself
    and ``in_keys`` for a submanifold plan with centre-symmetric taps, else
    the attached ``dual`` and ``dual_keys``."""
    if plan.self_transpose:
        return plan, in_keys
    if plan.dual is None or plan.dual_keys is None:
        raise ValueError('a strided plan has no dual: build the conv in '
                         'training mode')
    return plan.dual, plan.dual_keys


def dual_rows(plan: MatchPlan) -> torch.Tensor:
    """Rows of the plan's transpose: the plan's own for a submanifold plan
    with centre-symmetric taps, else those of its attached ``dual``."""
    if plan.self_transpose:
        return plan.rows
    if plan.dual is None or plan.dual.rows is None:
        raise ValueError('a strided plan has no dual rows: build the conv '
                         'in training mode')
    return plan.dual.rows


def dual_order(plan: MatchPlan) -> Optional[RowOrder]:
    """The ``row_order`` of ``dual_rows(plan)`` (None where the plans
    carry none)."""
    return plan.order if plan.self_transpose else plan.dual.order


def apply_match_conv(st: SparseTensor, plan: MatchPlan, weights, out_coords,
                     out_valid, out_keys, out_spatial_shape, bias=None,
                     scale=None, shift=None, relu: bool = False
                     ) -> SparseTensor:
    """Run a planned conv (weights [Ta, Cin, Cout]) and wrap the result.

    ``scale``/``shift``/``relu`` request the fused inference epilogue (not
    differentiable); a bias under an affine enters the shift pre-scaled:
    (conv + bias) * scale + shift. Without them the conv runs through
    ``MatchConv`` (differentiable) and a bias lands on the ``out_valid``
    rows only. Under ``conv_algo() == 'onehot'`` the conv matches the
    plan's queries against ``st.keys`` itself (``match_conv``); otherwise
    it runs over the plan's rulebook rows.
    """
    onehot = conv_algo() == 'onehot'
    if not onehot and plan.rows is None:
        raise ValueError('plan has no rows: call attach_rows first')
    if scale is not None or shift is not None or relu:
        if bias is not None:
            b_eff = bias * scale if scale is not None else bias
            shift = b_eff if shift is None else shift + b_eff
        epilogue = dict(scale=scale, shift=shift, relu=relu,
                        out_valid=out_valid)
        if onehot:
            out = match_conv(st.features, st.keys, plan, weights, **epilogue)
        else:
            out = gather_gemm_conv(st.features, plan.rows, weights,
                                   order=plan.order, **epilogue)
    else:
        out = MatchConv.apply(st.features, weights, plan,
                              st.keys if onehot else None)
        if bias is not None:
            out = torch.where(out_valid[:, None], out + bias, 0.0)
    return SparseTensor(features=out, coords=out_coords, valid=out_valid,
                        keys=out_keys,
                        spatial_shape=tuple(out_spatial_shape),
                        batch_size=st.batch_size)
